"""Scaled-dot-product attention as explicit products (counterpart of
``image2text_tpu/ops/attention.py``).

Not ``F.scaled_dot_product_attention``: its rounding differs.  The JAX
chain is kept step for step: scores are products of the storage dtype
accumulated in f32 (``ops/functions.py::dot_f32``: no f32 copy of q or of
the KV cache) and scaled in f32, then (for a low-precision input) rounded
to the storage dtype; the softmax runs in f32 and is safe for fully
masked rows; probabilities drop to the storage dtype before the V
product.  Multi-query K/V are read once
by folding the query heads into the sequence axis.

Training (``ctx.train``) with ``use_flash`` goes through the flash kernels
(``ops/flash_attention.py``) on every device: on the card their CUDA
kernels, on the CPU their plain versions, with the in-kernel hash dropout
on the probabilities.  Grouped K/V (1 < hk < h, Qwen-2's) are repeated to
full heads first, as the JAX package's flash gate does.  The
explicit-product path below is what ``disable_flash`` asks for (the JAX
package's parity mode); in training it drops the probabilities with a
seeded generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from image2text_torch.nn.core import EVAL_CTX, Ctx, dropout
from image2text_torch.ops.flash_attention import flash_sdpa, planes_of
from image2text_torch.ops.functions import dot_f32


def causal_bias(s: int, l: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask (1, 1, s, l): 0 on/below the diagonal, -inf
    above; when s != l the last query row aligns with the last key."""
    row = torch.arange(s, device=device)[:, None] + (l - s)
    col = torch.arange(l, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), float("-inf"), dtype=dtype, device=device)
    return torch.where(col <= row, zero, neg)[None, None]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         causal: bool = False, dropout_rate: float = 0.0,
         ctx: Ctx = EVAL_CTX, use_flash: bool = False) -> torch.Tensor:
    """Attention with an additive mask; q (b, h, s, d), k/v (b, hk, l, d)
    with hk dividing h.  ``dropout_rate`` drops probabilities in training."""
    rate = dropout_rate if ctx.train else 0.0
    if use_flash and ctx.train:
        hk = k.shape[1]
        if hk not in (1, q.shape[1]):
            # grouped K/V: the flash kernels take one K/V head or all of
            # them, so repeat each K/V head over its group (JAX's gate,
            # ops/flash_attention.py:645-655); autograd sums the group's
            # gradients back
            g = q.shape[1] // hk
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        # the seed comes from the ctx stream, as every dropout's does; its
        # low 32 bits are the flash hash's seed word
        seed = ctx.split()[1] if rate > 0.0 else None
        planes = (planes_of(q.shape[0], q.shape[1], ctx.rows, ctx.heads)
                  if rate > 0.0 else None)
        return flash_sdpa(q, k, v, mask, causal, rate, seed, planes)
    if causal:
        cb = causal_bias(q.shape[-2], k.shape[-2], q.device)
        mask = cb if mask is None else mask + cb
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    hk = k.shape[1]
    g = h // hk
    qf = q.reshape(b, hk, g * s, d) if g > 1 else q
    scores = dot_f32(qf, k) * scale
    if g > 1:
        scores = scores.reshape(b, h, s, -1)
    if q.dtype != torch.float32:
        scores = scores.to(q.dtype).float()
    if mask is not None:
        scores = scores + mask.float()
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isneginf(m),
                                       torch.zeros_like(m), m))
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if rate > 0.0:
        probs, ctx = dropout(probs, rate, ctx, head_dim=1)
    pf = probs.to(q.dtype)
    if g > 1:
        pf = pf.reshape(b, hk, g * s, -1)
    out = torch.matmul(pf, v)
    if g > 1:
        out = out.reshape(b, h, s, d)
    return out
