"""Llama-2 / Qwen-2 decoder backbone and its HF state-dict import
(counterpart of ``image2text_tpu/models/hf_decoders/llama.py``).

One implementation covers both families: RMSNorm pre-norm blocks, rotary
attention with grouped KV heads, a SwiGLU MLP.  Qwen-2 differs only in
its q/k/v biases, its rope theta and (for the 1.5B distill) its tied word
embeddings.  Module and tensor names follow HF's ``model.*`` and
``lm_head`` names.  Neither family takes cross-attention (the JAX
decoder raises for it); the image conditions through the soft prompt.
Grouped K/V go to ``ops/attention.py::sdpa`` as they are: it folds the
``n_head / n_kv_head`` query heads of a group into the sequence axis (HF
``repeat_kv``'s grouping: query head i reads KV head i // group), so the
cache is read once, never copied per query head.  Training attention on
the flash kernels takes them repeated to full heads (``sdpa`` does it).

Under a model split a rank computes its heads and neurons
(``parallel/sharding_rules.py``); with int4 projections those are two
halves, heads ``[r·n/2m, …) ∪ [n/2 + r·n/2m, …)`` of ``n`` over ``m``
ranks, the order the int4 row split's bytes read them in.  RoPE acts on
each head alone, the K/V cache holds the rank's K/V heads (``kv_shape``)
and beam search gathers it row by row as a whole cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.models.hf_decoders.common import (RMSNorm, apply_rope,
                                                        import_hf_state_dict,
                                                        positions,
                                                        rope_cos_sin)
from image2text_torch.nn.core import EVAL_CTX, Ctx, SequenceParallel
from image2text_torch.nn.modules import (Embedding, Linear, local_heads,
                                         tp_heads)
from image2text_torch.ops.attention import sdpa
from image2text_torch.parallel.collectives import copy_to
from image2text_torch.training.remat import checkpoint_block


@dataclass
class LlamaArch:
    vocab_size: int
    n_layer: int
    n_embd: int
    n_head: int
    n_kv_head: int
    intermediate: int
    max_positions: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False        # True for Qwen-2
    tie_embeddings: bool = False  # True for Qwen-2 1.5B

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def heads(z: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(b, t, n·hd) → (b, n, t, hd); n may be -1 (this rank's heads)."""
    b, t, _ = z.shape
    return z.reshape(b, t, n, hd).transpose(1, 2)


def merge(y: torch.Tensor) -> torch.Tensor:
    """(b, n, t, hd) → (b, t, n·hd)."""
    b, n, t, hd = y.shape
    return y.transpose(1, 2).reshape(b, t, n * hd)


def rotary_attention(q, k, v, pos, theta: float, ctx: Ctx, use_flash: bool,
                     kv_cache):
    """RoPE on q and k at positions ``pos``, the KV cache's write (its
    causal bias over the slots) or the causal mask, then ``sdpa``."""
    cos, sin = rope_cos_sin(pos, q.shape[-1], theta, q.dtype)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if kv_cache is not None:
        k, v, mask = kv_cache.update(k, v, None)
        causal = False
    else:
        mask, causal = None, True
    return sdpa(q, k, v, mask=mask, causal=causal, ctx=ctx,
                use_flash=use_flash)


class _LlamaAttention(nn.Module):
    def __init__(self, arch: LlamaArch, device=None):
        super().__init__()
        a = self.arch = arch
        hd = a.head_dim
        self.q_proj = Linear(a.n_embd, a.n_head * hd, a.qkv_bias, device)
        self.k_proj = Linear(a.n_embd, a.n_kv_head * hd, a.qkv_bias, device)
        self.v_proj = Linear(a.n_embd, a.n_kv_head * hd, a.qkv_bias, device)
        self.o_proj = Linear(a.n_head * hd, a.n_embd, False, device)

    def kv_shape(self, batch: int, max_len: int):
        return (batch, local_heads(self.k_proj, self.arch.n_kv_head),
                max_len, self.arch.head_dim)

    def forward(self, x, pos, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                kv_cache=None):
        a, hd = self.arch, self.arch.head_dim
        q = heads(self.q_proj(x), -1, hd)
        k, v = self.k_proj(x), self.v_proj(x)
        tp = getattr(self.q_proj, "tp", None)
        if tp is not None and getattr(self.k_proj, "tp", None) is None:
            # one K/V head that every query head reads, replicated: its
            # gradient is a partial sum over the model group
            k, v = copy_to(k, tp[1]), copy_to(v, tp[1])
        ctx = ctx.with_heads(*tp_heads(self.q_proj, q.shape[1], a.n_head))
        y = rotary_attention(q, heads(k, -1, hd), heads(v, -1, hd), pos,
                             a.rope_theta, ctx, use_flash, kv_cache)
        return self.o_proj(merge(y))


class _LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) · up(x))."""

    def __init__(self, arch: LlamaArch, device=None):
        super().__init__()
        d, i = arch.n_embd, arch.intermediate
        self.gate_proj = Linear(d, i, False, device)
        self.up_proj = Linear(d, i, False, device)
        self.down_proj = Linear(i, d, False, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _LlamaBlock(nn.Module):
    def __init__(self, arch: LlamaArch, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(arch.n_embd, arch.rms_eps, device)
        self.self_attn = _LlamaAttention(arch, device)
        self.post_attention_layernorm = RMSNorm(arch.n_embd, arch.rms_eps,
                                                device)
        self.mlp = _LlamaMLP(arch, device)

    def forward(self, x, pos, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                kv_cache=None):
        x = x + self.self_attn(self.input_layernorm(x), pos, ctx=ctx.fold(1),
                               use_flash=use_flash, kv_cache=kv_cache)
        return x + self.mlp(self.post_attention_layernorm(x))


def run_blocks(blocks: nn.ModuleList, x, pos, ctx: Ctx, use_flash: bool,
               kv_cache, remat: bool, policy):
    """The blocks in order, each recomputed in the backward under
    ``remat`` (training only: never with a cache), keeping what the remat
    ``policy`` keeps."""
    sp = SequenceParallel.of(blocks, x, ctx, kv_cache)
    if sp is not None:
        x = sp.split(x)
    for depth, blk in enumerate(blocks):
        bctx = ctx.fold(depth)
        remat_this = remat and ctx.train and kv_cache is None
        if remat_this or sp is not None:
            def run(x_, blk_=blk, ctx_=bctx):
                return blk_(x_, pos, ctx=ctx_, use_flash=use_flash)

            if sp is not None:
                run = sp.wrap(run)
            x = checkpoint_block(run, x, policy=policy) if remat_this \
                else run(x)
        else:
            x = blk(x, pos, ctx=bctx, use_flash=use_flash, kv_cache=kv_cache)
    return x if sp is None else sp.gather(x)


class LlamaBackbone(nn.Module):
    """The ``model.*`` subtree of ``LlamaForCausalLM`` /
    ``Qwen2ForCausalLM``."""

    def __init__(self, arch: LlamaArch, device=None):
        super().__init__()
        self.arch = arch
        self.embed_tokens = Embedding(arch.vocab_size, arch.n_embd, device,
                                      init_std=0.02)
        self.layers = nn.ModuleList([_LlamaBlock(arch, device)
                                     for _ in range(arch.n_layer)])
        self.norm = RMSNorm(arch.n_embd, arch.rms_eps, device)
        self.enable_gradient_checkpointing = False
        self._remat_policy = None   # training/remat.py::set_remat_policy

    def forward(self, inputs_embeds, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, kv_cache=None, pos_offset: int = 0):
        pos = positions(inputs_embeds.shape[-2], pos_offset,
                        inputs_embeds.device)
        x = run_blocks(self.layers, inputs_embeds, pos, ctx, use_flash,
                       kv_cache, self.enable_gradient_checkpointing,
                       self._remat_policy)
        return self.norm(x)


def import_hf_llama(decoder: nn.Module, sd: Mapping[str, np.ndarray],
                    loose: bool = False, tie_embeddings: bool = False) -> None:
    """Fill a Llama/Qwen decoder from an HF ``LlamaForCausalLM`` /
    ``Qwen2ForCausalLM`` state dict (JAX ``llama.py::import_hf_llama``):
    ``rotary_emb.inv_freq`` skipped, a tied ``lm_head.weight`` into
    ``model.embed_tokens.weight``."""
    embed = "model.embed_tokens.weight"
    import_hf_state_dict(
        decoder, sd,
        lambda k: embed if k == "lm_head.weight" and tie_embeddings else k,
        (embed, "lm_head.weight"), loose,
        skip=lambda k: k.endswith("rotary_emb.inv_freq"))


__all__ = ["LlamaArch", "LlamaBackbone", "import_hf_llama"]
