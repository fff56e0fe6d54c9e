"""GPT-2 decoder with cross-attention (counterpart of
``image2text_tpu/models/hf_decoders/gpt2.py``).

Module and tensor names follow HF ``GPT2LMHeadModel``'s state dict under
``add_cross_attention=True`` (``crossattention.{q_attn,c_attn,c_proj}``,
``ln_cross_attn``), with Linear layouts (out, in): the importer transposes
HF's Conv1D weights.  Attention goes through ``ops/attention.py::sdpa``:
explicit products at eval (with the KV cache in cached decoding), the
flash kernels in training.  In training each block is recomputed in the
backward when the config enables gradient checkpointing; dropout draws
from the ``Ctx`` seed stream, so the recompute draws the same masks.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from image2text_torch.models.hf_decoders.common import import_hf_state_dict
from image2text_torch.nn.core import (EVAL_CTX, Ctx, SequenceParallel,
                                      dropout)
from image2text_torch.nn.modules import (Embedding, LayerNorm, Linear,
                                         QuantizedKV, gelu_tanh, local_heads,
                                         quantize_kv, tp_heads)
from image2text_torch.ops.attention import sdpa
from image2text_torch.training.remat import checkpoint_block


def _heads(z: torch.Tensor, hd: int) -> torch.Tensor:
    """(b, t, n·hd) → (b, n, t, hd): n is this rank's heads under a model
    split."""
    b, t, _ = z.shape
    return z.reshape(b, t, -1, hd).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    b, h, t, d = y.shape
    return y.transpose(1, 2).reshape(b, t, h * d)


class _GPT2SelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, dropout_rate: float,
                 device=None):
        super().__init__()
        self.n_head, self.n_embd = n_head, n_embd
        self.dropout_rate = dropout_rate
        self.c_attn = Linear(n_embd, 3 * n_embd, device=device)
        self.c_proj = Linear(n_embd, n_embd, device=device)

    def kv_shape(self, batch: int, max_len: int):
        return (batch, local_heads(self.c_attn, self.n_head), max_len,
                self.n_embd // self.n_head)

    def forward(self, x, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                kv_cache=None):
        hd = self.n_embd // self.n_head
        q, k, v = (_heads(z, hd) for z in self.c_attn(x).chunk(3, dim=-1))
        if kv_cache is not None:
            k, v, mask = kv_cache.update(k, v, None)
            causal = False
        else:
            mask, causal = None, True
        y = sdpa(q, k, v, mask=mask, causal=causal,
                 ctx=ctx.with_heads(*tp_heads(self.c_attn, q.shape[1],
                                              self.n_head)),
                 use_flash=use_flash)
        y = self.c_proj(_merge(y))
        return dropout(y, self.dropout_rate, ctx.fold(1))[0]


class _GPT2CrossAttention(nn.Module):
    """HF ``GPT2Attention(is_cross_attention=True)``: q from the hidden
    state (``q_attn``), k/v from the encoder states (``c_attn``, fused
    2x), no mask."""

    def __init__(self, n_embd: int, n_head: int, dropout_rate: float,
                 device=None):
        super().__init__()
        self.n_head, self.n_embd = n_head, n_embd
        self.dropout_rate = dropout_rate
        self.q_attn = Linear(n_embd, n_embd, device=device)
        self.c_attn = Linear(n_embd, 2 * n_embd, device=device)
        self.c_proj = Linear(n_embd, n_embd, device=device)

    def project_kv(self, enc: torch.Tensor, quant=None):
        """Split-head K/V of a fixed encoder output (decode time: once per
        sequence, not once per token); ``quant='int8'`` gives them as a
        ``QuantizedKV``."""
        k, v = (_heads(z, self.n_embd // self.n_head)
                for z in self.c_attn(enc).chunk(2, dim=-1))
        return quantize_kv((k, v), quant)

    def forward(self, x, enc, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                precomputed_kv=None):
        """An int8 memory is dequantised on read, K and V each in f32 then
        in ``x``'s dtype (JAX gpt2.py:107-111)."""
        if isinstance(precomputed_kv, QuantizedKV):
            kq, ks, vq, vs = precomputed_kv
            k = (kq.float() * ks[..., None]).to(x.dtype)
            v = (vq.float() * vs[..., None]).to(x.dtype)
        elif precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            k, v = self.project_kv(enc)
        y = sdpa(_heads(self.q_attn(x), self.n_embd // self.n_head), k, v,
                 ctx=ctx,
                 use_flash=use_flash)
        y = self.c_proj(_merge(y))
        return dropout(y, self.dropout_rate, ctx.fold(1))[0]


class _GPT2MLP(nn.Module):
    def __init__(self, n_embd: int, n_inner: int, dropout_rate: float,
                 device=None):
        super().__init__()
        self.c_fc = Linear(n_embd, n_inner, device=device)
        self.c_proj = Linear(n_inner, n_embd, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x, ctx: Ctx = EVAL_CTX):
        h = self.c_proj(gelu_tanh(self.c_fc(x)))
        return dropout(h, self.dropout_rate, ctx)[0]


class _GPT2Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, dropout_rate: float,
                 cross_attn: bool, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(n_embd, bias=True, device=device)
        self.attn = _GPT2SelfAttention(n_embd, n_head, dropout_rate, device)
        self.has_cross = cross_attn
        if cross_attn:
            self.crossattention = _GPT2CrossAttention(n_embd, n_head,
                                                      dropout_rate, device)
            self.ln_cross_attn = LayerNorm(n_embd, bias=True, device=device)
        self.ln_2 = LayerNorm(n_embd, bias=True, device=device)
        self.mlp = _GPT2MLP(n_embd, 4 * n_embd, dropout_rate, device)

    def forward(self, x, enc=None, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, kv_cache=None, cross_kv=None):
        x = x + self.attn(self.ln_1(x), ctx=ctx.fold(1), use_flash=use_flash,
                          kv_cache=kv_cache)
        if enc is not None or cross_kv is not None:
            if not self.has_cross:
                raise ValueError("cross-attention not configured")
            x = x + self.crossattention(self.ln_cross_attn(x), enc,
                                        ctx=ctx.fold(2), use_flash=use_flash,
                                        precomputed_kv=cross_kv)
        return x + self.mlp(self.ln_2(x), ctx=ctx.fold(3))


class GPT2Backbone(nn.Module):
    """The ``transformer.*`` subtree of ``GPT2LMHeadModel``."""

    def __init__(self, vocab_size: int, n_layer: int, n_embd: int,
                 n_head: int, n_positions: int, dropout_rate: float,
                 cross_attn: bool, device=None):
        super().__init__()
        self.n_positions = n_positions
        self.dropout_rate = dropout_rate
        self.wte = Embedding(vocab_size, n_embd, device, init_std=0.02)
        self.wpe = Embedding(n_positions, n_embd, device, init_std=0.02)
        self.h = nn.ModuleList([
            _GPT2Block(n_embd, n_head, dropout_rate, cross_attn, device)
            for _ in range(n_layer)])
        self.ln_f = LayerNorm(n_embd, bias=True, device=device)
        self.enable_gradient_checkpointing = False
        self._remat_policy = None   # training/remat.py::set_remat_policy

    def forward(self, inputs_embeds, enc=None, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, kv_cache=None, pos_offset: int = 0,
                cross_kv=None):
        t = inputs_embeds.shape[-2]
        if pos_offset + t > self.n_positions:
            raise ValueError(f"Cannot forward positions up to "
                             f"{pos_offset + t}, block size is only "
                             f"{self.n_positions}")
        pos = self.wpe.rows(pos_offset, pos_offset + t)
        x = inputs_embeds + pos.to(inputs_embeds.dtype)
        x, ctx = dropout(x, self.dropout_rate, ctx)
        # per-block recompute in training; cached decode and eval never
        remat = (self.enable_gradient_checkpointing and ctx.train
                 and kv_cache is None)
        sp = SequenceParallel.of(self.h, x, ctx, kv_cache)
        if sp is not None:
            x = sp.split(x)
        for depth, blk in enumerate(self.h):
            bctx = ctx.fold(depth)
            if remat or sp is not None:
                def run(x_, enc_, blk_=blk, ctx_=bctx):
                    return blk_(x_, enc=enc_, ctx=ctx_, use_flash=use_flash)

                if sp is not None:
                    run = sp.wrap(run)
                x = (checkpoint_block(run, x, enc, policy=self._remat_policy)
                     if remat else run(x, enc))
            else:
                ckv = cross_kv.get(depth) if cross_kv is not None else None
                x = blk(x, enc=None if ckv is not None else enc, ctx=bctx,
                        use_flash=use_flash, kv_cache=kv_cache, cross_kv=ckv)
        if sp is not None:
            x = sp.gather(x)
        return self.ln_f(x)


GPT2_HF_TRANSPOSED = (
    "attn.c_attn.weight", "attn.c_proj.weight",
    "crossattention.c_attn.weight", "crossattention.q_attn.weight",
    "crossattention.c_proj.weight",
    "mlp.c_fc.weight", "mlp.c_proj.weight",
)


def import_hf_gpt2(decoder: nn.Module, sd: Mapping[str, np.ndarray],
                   loose: bool = False) -> None:
    """Fill ``decoder`` from an HF ``GPT2LMHeadModel`` state dict (numpy
    arrays by key; JAX ``gpt2.py::import_hf_gpt2``): the causal-mask
    buffers skipped, Conv1D weights transposed, ``lm_head.weight`` into
    the tied ``transformer.wte.weight``, float weights quantized where the
    destination is an int4 weight, and a vocabulary grown by extra tokens
    keeping its new rows.  A key the decoder lacks, or a shape it does not
    take, raises unless ``loose`` (then it is skipped)."""
    wte = "transformer.wte.weight"
    import_hf_state_dict(
        decoder, sd, lambda k: wte if k == "lm_head.weight" else k, (wte,),
        loose,
        skip=lambda k: k.endswith((".attn.masked_bias", ".attn.bias",
                                   ".crossattention.masked_bias",
                                   ".crossattention.bias")),
        transform=lambda k, v: v.T if k.endswith(GPT2_HF_TRANSPOSED) else v)


__all__ = ["GPT2Backbone", "GPT2_HF_TRANSPOSED", "import_hf_gpt2"]
