"""Vision encoders (counterpart of ``image2text_tpu/models/encoder.py``),
chosen by the config's type (:func:`encoder_from_config`):

* :class:`PretrainedViT`: the ViT-B/16 backbone (``models/vit.py``,
  frozen unless ``refine_base_model``) and one of three heads on its class
  token: the positional MLP (one residual MLP per output token, the input
  and output unit-normalised), PEER (the ``peer_proj_wt`` product to
  ``n_cls`` queries, then ``PeerLookup``) or LSH (one composite cosine
  embedding per output token; it forces the backbone frozen).
* :class:`VisionTransformerEncoder`, from scratch:

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

from image2text_torch.configs.models import (PretrainedViTConfig,
                                             VisionTransformerEncoderConfig)
from image2text_torch.models.layers import (AdvancedPositionalBiasMLP,
                                            CompositeCosineVectorEmbedding,
                                            ConvMLP, PeerLookup,
                                            TransformerBlock, _Cached)
from image2text_torch.models.vit import VisionTransformerB16
from image2text_torch.nn.core import (EVAL_CTX, Ctx, SequenceParallel,
                                      dropout, new_param, normal_init)
from image2text_torch.nn.modules import (Embedding, LayerNorm, LayerNormND,
                                         Linear)
from image2text_torch.ops.fused_frontend import FrontendWeights, fused_frontend
from image2text_torch.ops.static_gather import layout_rows, static_take
from image2text_torch.training.remat import checkpoint_block


# keyword arguments of the pretrained ViT's backbone (JAX encoder.py's
# VIT_B16_ARGS): a hook for a depth-reduced backbone in tests and tools
VIT_B16_ARGS: dict = {}
# the backbone's width, which every head takes (JAX encoder.py:93, :102, :117)
VIT_WIDTH = 768


def encoder_from_config(config, device=None) -> nn.Module:
    """The encoder a config describes (JAX ``Encoder.from_config``)."""
    if isinstance(config, PretrainedViTConfig):
        model = PretrainedViT(config, device)
        if config.lora_spec is not None:
            from image2text_torch.models.lora import apply_lora

            model = apply_lora(model, config.lora_spec)
        return model
    if isinstance(config, VisionTransformerEncoderConfig):
        # LoRA only on pretrained weights: a scratch encoder's lora_spec
        # is ignored, as in JAX
        return VisionTransformerEncoder(config, device)
    raise ValueError("Unknown config")


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class PretrainedViT(nn.Module):
    """ViT-B/16 backbone + projection head; forward (b, 3, 224, 224) →
    (b, n_cls, n_embd_out_vit).  Without ``refine_base_model`` (or with
    the LSH head) the backbone's output is detached and its parameters
    are frozen (``nn.core.frozen_param_paths`` through ``_freeze_all``), so
    no optimizer step, weight decay included, moves them.  A ``lora_spec``
    wraps its Linears (the backbone's ``self_attention.out_proj``,
    ``mlp.0``, ``mlp.3`` and the heads'; not the packed ``in_proj``) and
    freezes everything but the adapters, as JAX ``encoder.py:54-58``;
    the backbone's adapters stay frozen, and get no gradient through the
    detached output, unless ``refine_base_model`` (JAX
    ``encoder.py:125-139``).  The PEER-less
    heads keep a zero ``(1,)`` ``peer_proj_wt`` buffer, as the reference
    registers one, so checkpoints round-trip."""

    def __init__(self, config: PretrainedViTConfig, device=None):
        super().__init__()
        self.config = config
        self.out_dim = config.n_embd_out_vit
        self.n_cls = config.n_cls
        self.use_peer = config.peer_config is not None
        self.use_lsh = not self.use_peer and config.lsh_config is not None
        self.model = VisionTransformerB16(**VIT_B16_ARGS, device=device)
        self.refine = config.refine_base_model and not self.use_lsh
        self.model._freeze_all = not self.refine
        self.proj = self.peer = self.lsh_emb = None
        if not (self.use_lsh or self.use_peer):
            self.proj = AdvancedPositionalBiasMLP(
                config.n_cls, VIT_WIDTH, config.n_embd_out_vit,
                config.gate_sizes, True, device)
        if self.use_peer:
            pc = config.peer_config
            self.peer = PeerLookup(VIT_WIDTH, config.n_embd_out_vit,
                                   pc.num_units_sqrt ** 2, pc.topk, pc.nhead,
                                   pc.query_dim, device)
            new_param(self, "peer_proj_wt", (VIT_WIDTH, VIT_WIDTH, self.n_cls),
                      normal_init(std=1.0 / math.sqrt(VIT_WIDTH)), device)
        else:
            self.register_buffer("peer_proj_wt",
                                 torch.zeros(1, device=device))
        if self.use_lsh:
            lc = config.lsh_config
            self.lsh_emb = nn.ModuleList([
                CompositeCosineVectorEmbedding(
                    VIT_WIDTH, config.n_embd_out_vit, lc.num_bins,
                    lc.num_proj, lc.learnable, seed=i, device=device)
                for i in range(self.n_cls)])

    @property
    def num_outputs(self) -> int:
        return self.n_cls

    @property
    def output_embed_dim(self) -> int:
        return self.out_dim

    @property
    def blocks(self):
        """The backbone's encoder blocks."""
        return self.model.blocks

    def forward(self, images: torch.Tensor, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True) -> torch.Tensor:
        x = self.model(images, ctx=ctx.fold(1))
        if not self.refine:
            x = x.detach()
        if self.use_peer:
            z = torch.einsum("bd,des->bse", x, self.peer_proj_wt.to(x.dtype))
            return self.peer(z)
        if self.use_lsh:
            return torch.stack([mod(x) for mod in self.lsh_emb], dim=1)
        x = _l2_normalize(x)[:, None, :].expand(-1, self.n_cls, -1)
        return _l2_normalize(self.proj(x))


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
        self._remat_policy = None   # training/remat.py::set_remat_policy
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
        t = x.shape[1]
        sp = SequenceParallel.of(self.blocks, x, ctx)
        if sp is not None:
            x = sp.split(x)
        for depth, blk in enumerate(self.blocks):
            new_layout = blk.next_layout(layout, t)

            def run(x_, blk_=blk, layout_=layout, ctx_=ctx.fold(100 + depth)):
                return blk_(x_, layout=layout_, want_lazy=True, ctx=ctx_,
                            use_flash=use_flash)[0]

            if sp is not None:
                run = sp.wrap(run)
            x = (checkpoint_block(run, x, policy=self._remat_policy) if remat
                 else run(x))
            layout = new_layout
        if sp is not None:
            x = sp.gather(x)
        if layout is None:
            cls = x[:, :self.n_cls]
        else:  # only the CLS rows need canonical reassembly
            cls = static_take(x, layout_rows(layout, np.arange(self.n_cls)))
        return self.transformer.ln_f(cls)
