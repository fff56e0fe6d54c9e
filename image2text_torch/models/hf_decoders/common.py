"""Shared pieces of the HF decoders: RMSNorm and the rotary embedding of
the Llama, Qwen and Falcon decoders (counterpart of
``image2text_tpu/models/hf_decoders/common.py``), and the state-dict
import loop every family's importer runs."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from image2text_torch.nn.core import new_param, ones_init


class RMSNorm(nn.Module):
    """Llama/Qwen RMS normalisation: the statistics in f32, the normalised
    value cast back to the input dtype *before* the weight multiply (HF's
    order), the product in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        new_param(self, "weight", (dim,), ones_init(), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return self.weight.to(x.dtype) * y.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """cos/sin tables (t, head_dim) in HF's half-split layout, computed in
    f32 and cast to ``dtype``."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=dev,
                                             dtype=torch.float32) / head_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (b, h, t, d) rotated by HF's ``rotate_half`` convention."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def positions(t: int, pos_offset: int, device) -> torch.Tensor:
    """The chunk's global positions ``pos_offset + arange(t)``."""
    return pos_offset + torch.arange(t, device=device)


@torch.no_grad()
def import_hf_state_dict(decoder: nn.Module, sd: Mapping[str, np.ndarray],
                         rename, table_keys, loose: bool = False,
                         skip=lambda k: False,
                         transform=lambda k, v: v) -> None:
    """Fill ``decoder`` from an HF state dict of numpy arrays, the JAX
    importers' loop: ``skip`` drops a key (buffers), ``transform(k, v)``
    changes a value (GPT-2's Conv1D transposes), ``rename`` maps an HF key
    to the decoder's (a tied ``lm_head.weight``), a float
    weight whose destination is int4 is quantized
    (``models/quantization.py::assign_imported``), and a vocabulary table
    (``table_keys``) may hold more rows than the checkpoint (extra
    tokens), keeping its own.  A key the decoder lacks, or a shape it does
    not take, raises unless ``loose`` (then it is skipped), as the JAX
    importers do."""
    from image2text_torch.models.quantization import assign_imported

    tensors = dict(decoder.named_parameters())
    tensors.update(decoder.named_buffers())
    for k, v in sd.items():
        if skip(k):
            continue
        v = transform(k, np.asarray(v))
        k = rename(k)
        if k not in tensors:
            if not loose:
                raise ValueError(f"{k} is not present in state dict!!!")
            continue
        if assign_imported(tensors, k, v):
            continue
        dst = tensors[k]
        if (k in table_keys and dst.shape[0] >= v.shape[0]
                and dst.dim() == 2 and dst.shape[1] == v.shape[1]):
            dst[:v.shape[0]] = torch.from_numpy(v).to(dst.dtype)
        elif not loose:
            raise ValueError(f"{k} is not the same shape in state dict!!!")


__all__ = ["RMSNorm", "apply_rope", "import_hf_state_dict", "positions",
           "rope_cos_sin"]
