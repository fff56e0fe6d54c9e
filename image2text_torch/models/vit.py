"""ViT-B/16 backbone with torchvision's parameter names (counterpart of
``image2text_tpu/models/vit.py``).

torchvision's ``VisionTransformer`` (``vit_b_16``), the backbone of the
pretrained-ViT encoder: a patch convolution (kernel = stride = 16), the
class token in front, the positional table, pre-LN blocks of
``nn/modules.py::MultiheadAttention`` and an exact-GELU MLP (torchvision's
``MLPBlock``: slots ``mlp.0`` and ``mlp.3``), every LayerNorm at eps 1e-6,
then the final LayerNorm.  The output is the class token's row (the
reference replaces ``heads`` by the identity).  The state-dict keys are
torchvision's, so a ``vit_b_16`` state dict loads through
:func:`import_torchvision_vit_state_dict` (``heads.*`` skipped).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      normal_init, zeros_init)
from image2text_torch.nn.modules import (Conv2d, LayerNorm, Linear,
                                         MultiheadAttention)


class _PatchConv(Conv2d):
    """``conv_proj``: a VALID convolution whose stride is its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.kernel_size)
        return y + self.bias.to(x.dtype)[None, :, None, None]


class _ViTMLPBlock(nn.Module):
    """torchvision's MLPBlock: Linear, exact GELU (not tanh), dropout,
    Linear, dropout; the Linears sit at slots '0' and '3'."""

    def __init__(self, dim: int, hidden: int, dropout_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.add_module("0", Linear(dim, hidden, device=device))
        self.add_module("3", Linear(hidden, dim, device=device))
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        h = F.gelu(self._modules["0"](x))
        h, ctx = dropout(h, self.dropout_rate, ctx)
        h = self._modules["3"](h)
        return dropout(h, self.dropout_rate, ctx)[0]


class _ViTEncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(dim, True, eps=1e-6, device=device)
        self.self_attention = MultiheadAttention(dim, num_heads,
                                                 device=device)
        self.ln_2 = LayerNorm(dim, True, eps=1e-6, device=device)
        self.mlp = _ViTMLPBlock(dim, mlp_dim, dropout_rate, device)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        h = self.ln_1(x)
        h = self.self_attention(h, h, h, ctx=ctx.fold(1))
        x = x + dropout(h, self.dropout_rate, ctx.fold(2))[0]
        return x + self.mlp(self.ln_2(x), ctx=ctx.fold(3))


class _ViTEncoder(nn.Module):
    def __init__(self, seq_length: int, num_layers: int, dim: int,
                 num_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 device=None):
        super().__init__()
        new_param(self, "pos_embedding", (1, seq_length, dim),
                  normal_init(std=0.02), device)
        self.layers = nn.Module()
        for i in range(num_layers):
            self.layers.add_module(f"encoder_layer_{i}", _ViTEncoderBlock(
                dim, num_heads, mlp_dim, dropout_rate, device))
        self.ln = LayerNorm(dim, True, eps=1e-6, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        """The final LayerNorm of the class token's row (a row-wise norm:
        the other rows' are never read)."""
        x = x + self.pos_embedding.to(x.dtype)
        x, ctx = dropout(x, self.dropout_rate, ctx)
        for i, blk in enumerate(self.layers.children()):
            x = blk(x, ctx=ctx.fold(10 + i))
        return self.ln(x[:, 0])


class VisionTransformerB16(nn.Module):
    """ViT-B/16: 12 layers, d 768, 12 heads, MLP 3072, 16² patches.
    ``forward`` takes NCHW images of ``image_size``² and returns the
    class token's feature (b, hidden_dim)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_layers: int = 12, num_heads: int = 12,
                 hidden_dim: int = 768, mlp_dim: int = 3072, device=None):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.n_patches = (image_size // patch_size) ** 2
        self.conv_proj = _PatchConv(3, hidden_dim, (patch_size, patch_size),
                                    device=device)
        new_param(self, "class_token", (1, 1, hidden_dim), zeros_init(),
                  device)
        self.encoder = _ViTEncoder(self.n_patches + 1, num_layers,
                                   hidden_dim, num_heads, mlp_dim,
                                   device=device)

    @property
    def blocks(self):
        return list(self.encoder.layers.children())

    def forward(self, images: torch.Tensor,
                ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        b = images.shape[0]
        x = self.conv_proj(images).reshape(b, self.hidden_dim, -1)
        x = x.transpose(1, 2)
        cls = self.class_token.to(x.dtype).expand(b, 1, self.hidden_dim)
        return self.encoder(torch.cat([cls, x], dim=1), ctx=ctx)


@torch.no_grad()
def import_torchvision_vit_state_dict(model: VisionTransformerB16,
                                      sd: Mapping[str, np.ndarray]) -> None:
    """Fill ``model`` from a torchvision ``vit_b_16`` state dict (numpy or
    torch values by key); the names map one to one, ``heads.*`` is
    skipped.  A key the model lacks raises ``KeyError``, a shape it does
    not take ``ValueError``."""
    tensors = dict(model.named_parameters())
    for key, value in sd.items():
        if key.startswith("heads."):
            continue
        if key not in tensors:
            raise KeyError(f"unexpected torchvision ViT key: {key}")
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        dst = tensors[key]
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(dst.shape)} vs {value.shape}")
        dst.copy_(torch.from_numpy(np.array(value)).to(dst.dtype))


__all__ = ["VisionTransformerB16", "import_torchvision_vit_state_dict"]
