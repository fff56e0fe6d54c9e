"""Falcon-7B decoder backbone and its HF state-dict import (counterpart of
``image2text_tpu/models/hf_decoders/falcon.py``).

Falcon-7B (HF ``new_decoder_architecture=False``, ``parallel_attn=True``,
``multi_query=True``, no linear biases): one pre-LN feeds both the
attention and the MLP (``x + attn(ln(x)) + mlp(ln(x))``), rotary
positions, one K/V head shared by every query head.  Module and tensor
names follow HF's ``transformer.*``; the lm_head is tied to
``word_embeddings``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch.nn.functional as F
from torch import nn

from image2text_torch.models.hf_decoders.common import (import_hf_state_dict,
                                                        positions)
from image2text_torch.models.hf_decoders.llama import (heads, merge,
                                                       rotary_attention,
                                                       run_blocks)
from image2text_torch.nn.core import EVAL_CTX, Ctx
from image2text_torch.nn.modules import Embedding, LayerNorm, Linear


@dataclass
class FalconArch:
    vocab_size: int
    n_layer: int
    n_embd: int
    n_head: int
    max_positions: int = 2048
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


class _FalconAttention(nn.Module):
    """The fused ``query_key_value`` (q: the first ``n_embd`` columns, then
    one K head, then one V head) and ``dense``."""

    def __init__(self, arch: FalconArch, device=None):
        super().__init__()
        a = self.arch = arch
        self.query_key_value = Linear(a.n_embd, a.n_embd + 2 * a.head_dim,
                                      False, device)
        self.dense = Linear(a.n_embd, a.n_embd, False, device)

    def kv_shape(self, batch: int, max_len: int):
        return (batch, 1, max_len, self.arch.head_dim)

    def forward(self, x, pos, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                kv_cache=None):
        a, hd = self.arch, self.arch.head_dim
        q, k, v = self.query_key_value(x).split([a.n_embd, hd, hd], dim=-1)
        y = rotary_attention(heads(q, a.n_head, hd), heads(k, 1, hd),
                             heads(v, 1, hd), pos, a.rope_theta, ctx,
                             use_flash, kv_cache)
        return self.dense(merge(y))


class _FalconMLP(nn.Module):
    """dense_4h_to_h(gelu(dense_h_to_4h(x))), the exact (erf) GELU."""

    def __init__(self, arch: FalconArch, device=None):
        super().__init__()
        d = arch.n_embd
        self.dense_h_to_4h = Linear(d, 4 * d, False, device)
        self.dense_4h_to_h = Linear(4 * d, d, False, device)

    def forward(self, x):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x)))


class _FalconBlock(nn.Module):
    def __init__(self, arch: FalconArch, device=None):
        super().__init__()
        self.input_layernorm = LayerNorm(arch.n_embd, bias=True,
                                         eps=arch.ln_eps, device=device)
        self.self_attention = _FalconAttention(arch, device)
        self.mlp = _FalconMLP(arch, device)

    def forward(self, x, pos, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                kv_cache=None):
        ln = self.input_layernorm(x)
        attn = self.self_attention(ln, pos, ctx=ctx.fold(1),
                                   use_flash=use_flash, kv_cache=kv_cache)
        return x + attn + self.mlp(ln)   # parallel_attn: one LN for both


class FalconBackbone(nn.Module):
    """The ``transformer.*`` subtree of ``FalconForCausalLM``."""

    def __init__(self, arch: FalconArch, device=None):
        super().__init__()
        self.arch = arch
        self.word_embeddings = Embedding(arch.vocab_size, arch.n_embd, device,
                                         init_std=0.02)
        self.h = nn.ModuleList([_FalconBlock(arch, device)
                                for _ in range(arch.n_layer)])
        self.ln_f = LayerNorm(arch.n_embd, bias=True, eps=arch.ln_eps,
                              device=device)
        self.enable_gradient_checkpointing = False
        self._remat_policy = None   # training/remat.py::set_remat_policy

    def forward(self, inputs_embeds, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, kv_cache=None, pos_offset: int = 0):
        pos = positions(inputs_embeds.shape[-2], pos_offset,
                        inputs_embeds.device)
        x = run_blocks(self.h, inputs_embeds, pos, ctx, use_flash, kv_cache,
                       self.enable_gradient_checkpointing, self._remat_policy)
        return self.ln_f(x)


def import_hf_falcon(decoder: nn.Module, sd: Mapping[str, np.ndarray],
                     loose: bool = False) -> None:
    """Fill a Falcon decoder from an HF ``FalconForCausalLM`` state dict
    (JAX ``falcon.py::import_hf_falcon``): ``lm_head.weight`` into the tied
    ``transformer.word_embeddings.weight``."""
    embed = "transformer.word_embeddings.weight"
    import_hf_state_dict(decoder, sd,
                         lambda k: embed if k == "lm_head.weight" else k,
                         (embed,), loose)


__all__ = ["FalconArch", "FalconBackbone", "import_hf_falcon"]
