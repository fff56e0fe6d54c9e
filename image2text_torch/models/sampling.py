"""Sampling of the port (the flagship subset of
``image2text_tpu/models/sampling.py``): no-repeat-n-gram bans and the
exact ban → top-k → temperature → categorical pipeline.

The JAX sampler pulls a top-(k + margin) head and falls back to a wider
pull under ``lax.cond``; that split is a TPU optimisation, not semantics.
The port computes the same distribution directly: ban, ``torch.topk``,
temperature, then ``argmax(values / T + gumbel)`` — which is what
``jax.random.categorical`` computes from its own Gumbel noise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _ngram_bans(ids_buf: torch.Tensor, cur_len: int,
                ngram_sizes: Sequence[int]):
    """(candidates, banned): next-token candidates (B, M) and which of them
    the n-gram rules ban (B, M) bool.  For each n, a token x is banned when
    the last n-1 tokens followed by x already occur as a window
    ids[j : j+n] with j + n <= cur_len."""
    b, l = ids_buf.shape
    dev = ids_buf.device
    ar = torch.arange(l, device=dev)
    cand_all, ban_all = [], []
    for n in ngram_sizes:
        if n < 1 or l < n:
            continue
        if n == 1:
            cand_all.append(ids_buf)
            ban_all.append((ar < cur_len)[None].expand(b, l))
            continue
        suf_pos = (cur_len - (n - 1) + torch.arange(n - 1, device=dev)
                   ).clamp(0, l - 1)
        suffix = ids_buf[:, suf_pos]                              # (B, n-1)
        win_pos = (ar[:, None] + torch.arange(n - 1, device=dev)[None]
                   ).clamp(max=l - 1)                             # (L, n-1)
        match = (ids_buf[:, win_pos] == suffix[:, None, :]).all(-1)
        valid = (ar + n) <= cur_len
        match = match & valid[None] & (cur_len >= n)
        cand_all.append(ids_buf[:, (ar + (n - 1)).clamp(max=l - 1)])
        ban_all.append(match)
    if not cand_all:
        return None, None
    return torch.cat(cand_all, dim=-1), torch.cat(ban_all, dim=-1)


def apply_no_repeat_ngram(logits: torch.Tensor, ids_buf: torch.Tensor,
                          cur_len: int,
                          ngram_sizes: Sequence[int]) -> torch.Tensor:
    """Banned tokens' logits set to -inf, by one scatter-min (no host
    synchronisation)."""
    cand, ban = _ngram_bans(ids_buf, cur_len, ngram_sizes)
    if cand is None:
        return logits
    inf = torch.full((), float("inf"), dtype=logits.dtype,
                     device=logits.device)
    src = torch.where(ban, -inf, inf).expand(cand.shape)
    return logits.scatter_reduce(-1, torch.where(ban, cand, 0), src,
                                 reduce="amin", include_self=True)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise (f32) from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_topk_with_ngram(logits: torch.Tensor, ids_buf: torch.Tensor,
                           cur_len: int, ngram_sizes: Sequence[int],
                           generator: Optional[torch.Generator],
                           temperature: Optional[float],
                           top_k: Optional[int],
                           gumbel: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """n-gram ban → top-k → temperature → categorical on last-step logits
    (B, V); ``temperature <= 0`` returns the banned argmax.  ``gumbel``
    (B, k) replaces the noise drawn from ``generator`` (tests feed the
    JAX sampler's noise)."""
    logits = apply_no_repeat_ngram(logits, ids_buf, cur_len, ngram_sizes)
    if temperature is None or temperature <= 0:
        return logits.argmax(dim=-1)
    v = logits.shape[-1]
    k = min(top_k if top_k is not None else v, v)
    tv, ti = torch.topk(logits, k, dim=-1)
    if gumbel is None:
        gumbel = gumbel_noise(tv.shape, generator, logits.device)
    choice = (tv.float() / temperature + gumbel).argmax(dim=-1)
    return ti.gather(-1, choice[:, None])[:, 0]
