"""From-scratch vision encoder (counterpart of
``image2text_tpu/models/encoder.py::VisionTransformerEncoder``).

ConvMLP features, then the reference's raw row-major reshape of the NCHW
feature map into n_patches² tokens of C·pw·ph (not a patchify), projector
+ LayerNormND over the whole (tokens, d) slab, the positional table,
LayerNormND again, learned CLS tokens in front (at eval one
``ops/fused_frontend.py::fused_frontend`` call: the CUDA kernels on the
card; the module chain where the projector holds its int8 serving form),
and the blocks, sparse ones on the lazy layout path; ``ln_f`` of
the CLS rows is the output.  In training the front is the module chain,
dropped, and, when the config enables gradient checkpointing, each block
is recomputed in the backward.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from image2text_torch.configs.models import VisionTransformerEncoderConfig
from image2text_torch.models.layers import ConvMLP, TransformerBlock, _Cached
from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      normal_init)
from image2text_torch.nn.modules import (Embedding, LayerNorm, LayerNormND,
                                         Linear)
from image2text_torch.ops.fused_frontend import FrontendWeights, fused_frontend
from image2text_torch.ops.static_gather import layout_rows, static_take
from image2text_torch.training.remat import checkpoint_block


class _WpeEmbedding(Embedding):
    """The positional table (JAX ``encoder.py:269 _WpeEmbedding``: its own
    type, so the W8A8 transform, typed on ``Embedding``, leaves it in
    float)."""


class VisionTransformerEncoder(nn.Module):
    def __init__(self, config: VisionTransformerEncoderConfig, device=None):
        super().__init__()
        self.config = config
        n_patches = config.num_patches
        self.n_patches = n_patches
        if config.input.width % n_patches or config.input.height % n_patches:
            raise ValueError("image size must be a multiple of num_patches")
        patch = (config.input.width // n_patches,
                 config.input.height // n_patches)
        self.feature_extractor = ConvMLP(
            config.input.n_channels, config.n_channels,
            config.feature_extractor_kernel_size,
            config.feature_extractor_gate_sizes, device)
        self.input_d = config.n_channels * patch[0] * patch[1]
        acfg = config.transformer_config.attn_config
        self.out_dim = acfg.n_embd
        self.projector = Linear(self.input_d, self.out_dim, acfg.bias, device)
        self.ln_input = LayerNormND((n_patches ** 2, self.out_dim), acfg.bias,
                                    device=device)
        self.transformer = nn.Module()
        self.transformer.wpe = _WpeEmbedding(n_patches ** 2, self.out_dim,
                                             device)
        self.transformer.h = nn.ModuleList([
            TransformerBlock(config.transformer_config, seed=depth,
                             device=device)
            for depth in range(config.n_layer)])
        self.transformer.ln_f = LayerNorm(self.out_dim, acfg.bias,
                                          device=device)
        new_param(self, "cls_token", (1, config.n_cls, self.out_dim),
                  normal_init(std=1.0 / math.sqrt(self.out_dim)), device)
        self.n_cls = config.n_cls
        self.dropout_rate = acfg.dropout
        self.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)
        self._front = _Cached()

    @property
    def blocks(self) -> nn.ModuleList:
        """``transformer.h`` (a property, not a second registration: one
        path per parameter, as ``torch.func.functional_call`` needs)."""
        return self.transformer.h

    @property
    def num_outputs(self) -> int:
        return self.n_cls

    @property
    def output_embed_dim(self) -> int:
        return self.out_dim

    def frontend_weights(self, dtype) -> FrontendWeights:
        """The eval front's operands of ``fused_frontend``."""
        def make():
            proj, ln = self.projector, self.ln_input
            return FrontendWeights(
                w_p=proj.weight.t().to(dtype).contiguous(),
                b_p=None if proj.bias is None else proj.bias.to(dtype),
                ln_w=ln.weight, ln_b=ln.bias,
                wpe=self.transformer.wpe.weight.to(dtype),
                cls=self.cls_token[0].to(dtype))
        params = [self.projector.weight, self.ln_input.weight,
                  self.transformer.wpe.weight, self.cls_token] + [
                      b for b in (self.projector.bias, self.ln_input.bias)
                      if b is not None]
        return self._front.get(params, dtype, make)

    def forward(self, images: torch.Tensor, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True) -> torch.Tensor:
        x = self.feature_extractor(images)
        n = x.shape[0]
        x = x.reshape(n, self.n_patches ** 2, self.input_d)
        if not ctx.train and not self.projector.is_int8:
            x = fused_frontend(x, self.frontend_weights(x.dtype))
        else:   # training, or the projector's int8 serving form
            x = self.ln_input(self.projector(x))
            y = x + self.transformer.wpe.weight.to(x.dtype)[None]
            cls = self.cls_token.to(x.dtype).expand(n, self.n_cls,
                                                    self.out_dim)
            x = torch.cat([cls, self.ln_input(y)], dim=1)
            x, ctx = dropout(x, self.dropout_rate, ctx)
        remat = self.enable_gradient_checkpointing and ctx.train
        layout = None
        for depth, blk in enumerate(self.blocks):
            new_layout = blk.next_layout(layout, x.shape[1])

            def run(x_, blk_=blk, layout_=layout, ctx_=ctx.fold(100 + depth)):
                return blk_(x_, layout=layout_, want_lazy=True, ctx=ctx_,
                            use_flash=use_flash)[0]

            x = checkpoint_block(run, x) if remat else run(x)
            layout = new_layout
        if layout is None:
            cls = x[:, :self.n_cls]
        else:  # only the CLS rows need canonical reassembly
            cls = static_take(x, layout_rows(layout, np.arange(self.n_cls)))
        return self.transformer.ln_f(cls)
