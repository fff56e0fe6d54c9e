"""Sampling of the port (``image2text_tpu/models/sampling.py``):
no-repeat-n-gram bans, the exact ban → top-k → temperature → categorical
pipeline, the reference's temperature → top-k →
nucleus → categorical pipeline (:func:`sample_logits`, as the trainer's
qualitative eval samples), and beam search's candidate scoring and
Gumbel-top-k sampling.

The JAX samplers pull a top-(k + margin) head and fall back to a wider
pull under ``lax.cond``; that split is a TPU optimisation, not semantics.
The port computes the same functions directly: ban, top-k, temperature,
then ``argmax(values / T + gumbel)`` — which is what
``jax.random.categorical`` computes from its own Gumbel noise.  Noise can
be passed in (``gumbel=``) so that tests feed the JAX samplers' noise.

The ``approx`` flag of :func:`sample_logits` and
:func:`sample_topk_with_ngram` (the approx-top-k serving mode, JAX
``sampling.py:323-345, :373-425``) is taken as exact: JAX pulls the head
with ``jax.lax.approx_max_k`` (recall target 0.95), which no op on the
card computes, so the port's approximate mode is its exact top-k, on the
card and on the CPU.  On the CPU JAX's ``approx_max_k`` returns exactly
``lax.top_k``, so the two packages draw the same ids there.  Greedy
decoding never reads the flag, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = float("-inf")


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
                           gumbel: Optional[torch.Tensor] = None,
                           approx: bool = False) -> torch.Tensor:
    """n-gram ban → top-k → temperature → categorical on last-step logits
    (B, V); ``temperature <= 0`` returns the banned argmax.  ``gumbel``
    (B, k) replaces the noise drawn from ``generator`` (tests feed the
    JAX sampler's noise).  ``approx`` is taken as exact (module
    docstring)."""
    logits = apply_no_repeat_ngram(logits, ids_buf, cur_len, ngram_sizes)
    if temperature is None or temperature <= 0:
        return logits.argmax(dim=-1)
    v = logits.shape[-1]
    k = min(top_k if top_k is not None else v, v)
    # the f32 torch.topk, not ``topk``: which of equal logits sits where in
    # the head does not change the draw's distribution, and the int64 key
    # cost 0.37 ms a flagship decode step on an H100
    tv, ti = torch.topk(logits, k, dim=-1)
    if gumbel is None:
        gumbel = gumbel_noise(tv.shape, generator, logits.device)
    choice = (tv.float() / temperature + gumbel).argmax(dim=-1)
    return ti.gather(-1, choice[:, None])[:, 0]


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, values
    descending, ties to the lowest index (``jax.lax.top_k``'s rule, which
    ``torch.topk`` does not promise).  One ``torch.topk`` on an int64 key:
    the value's order-preserving int32 image above the reversed index, so
    -0.0 ranks below +0.0 as in ``lax.top_k``'s total order.  The JAX
    package's chunked and threshold-gather forms are TPU formulations of
    the same values."""
    bits = x.float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    v = x.shape[-1]
    rev = torch.arange(v - 1, -1, -1, device=x.device)
    idx = torch.topk(key * (1 << 32) + rev, k, dim=-1).indices
    return x.gather(-1, idx), idx


def apply_top_k(logits: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """Keep the logits at or above the k-th largest, the rest -inf (ties at
    the threshold kept)."""
    if top_k is None:
        return logits
    kth = topk(logits, min(top_k, logits.shape[-1]))[0][..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def nucleus_sample(probs: torch.Tensor, nucleus_p: float,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-p sample ids from probabilities (B, V), the reference's
    semantics: sort descending (ties to the lowest index), keep the prefix
    whose cumulative mass is at most max(p, p₀), renormalise, draw.
    ``gumbel`` (B, V), over the sorted positions, replaces the noise drawn
    from ``generator``.  The JAX package sorts only a top-2048 head where
    that provably holds the prefix, a TPU optimisation of the same
    function."""
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = cum <= torch.maximum(torch.as_tensor(nucleus_p, dtype=cum.dtype),
                                sorted_probs[..., :1])
    trunc = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    logp = torch.log(trunc.clamp_min(1e-30)).masked_fill(~keep, NEG_INF)
    if gumbel is None:
        gumbel = gumbel_noise(logp.shape, generator, logp.device)
    choice = (logp + gumbel).argmax(dim=-1)
    return order.gather(-1, choice[:, None])[:, 0]


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  nucleus_p: Optional[float] = None,
                  gumbel: Optional[torch.Tensor] = None,
                  approx: bool = False) -> torch.Tensor:
    """The reference's sampling pipeline on last-step logits (B, V):
    top-k alone draws among the k largest at ``temperature``; otherwise
    the logits at ``temperature``, :func:`apply_top_k` (ties at the k-th
    kept), then :func:`nucleus_sample` or a draw over the whole row.
    ``gumbel`` replaces the noise of the draw: (B, k), or (B, V) (over the
    sorted positions for nucleus).  ``approx`` is taken as exact (module
    docstring)."""
    if top_k is not None and nucleus_p is None:
        tv, ti = topk(logits, min(top_k, logits.shape[-1]))
        if gumbel is None:
            gumbel = gumbel_noise(tv.shape, generator, logits.device)
        choice = (tv.float() / temperature + gumbel).argmax(dim=-1)
        return ti.gather(-1, choice[:, None])[:, 0]
    logits = apply_top_k(logits.float() / temperature, top_k)
    if nucleus_p is not None:
        return nucleus_sample(torch.softmax(logits, dim=-1), nucleus_p,
                              generator, gumbel)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return (logits + gumbel).argmax(dim=-1)


def gumbel_topk_sample(log_probs: torch.Tensor, k: int,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None):
    """k ids drawn without replacement ∝ exp(log_probs) (Gumbel-top-k):
    (ids, their log_probs), both (..., k).  ``gumbel`` (log_probs' shape)
    replaces the noise drawn from ``generator``."""
    if gumbel is None:
        gumbel = gumbel_noise(log_probs.shape, generator, log_probs.device)
    _, ids = topk(log_probs + gumbel, k)
    return ids, log_probs.gather(-1, ids)


def beam_candidates_with_ngram(logits: torch.Tensor, ids_buf: torch.Tensor,
                               cur_len: int, ngram_sizes: Sequence[int],
                               generator: Optional[torch.Generator],
                               temperature: Optional[float],
                               top_k: Optional[int], bef: int,
                               gumbel: Optional[torch.Tensor] = None):
    """n-gram ban, top-k and the choice of ``bef`` candidates per row for
    beam search: (next_ids (B, bef), log_scores (B, bef) f32), the
    log-softmax values of the banned, top-k-truncated logits (at
    ``temperature`` when stochastic).  Greedy (``temperature <= 0``) takes
    the ``bef`` best; otherwise they are drawn without replacement by
    Gumbel-top-k over the k-wide head (``gumbel`` (B, k) replaces the
    noise).  Returns None where JAX's fused scorer does (stochastic with
    ``top_k`` None, or ``bef`` > ``top_k``): the caller's dense path.

    Two behaviours of the JAX scorer are kept on purpose:

    * the head keeps exactly k values at a tied threshold (lowest indices),
      where ``apply_top_k`` keeps every tie (JAX sampling.py:484-486);
    * greedy with ``top_k`` None normalises over the unbanned ids by
      subtracting the banned mass from the full log-sum-exp, and counts a
      banned id once for every ban entry that names it — once per n-gram
      size (and window) that bans it (JAX sampling.py:507).
    """
    v = logits.shape[-1]
    greedy = temperature is None or temperature <= 0
    k = min(top_k, v) if top_k is not None else None
    if (k is None and not greedy) or (k is not None and bef > k):
        return None
    banned = apply_no_repeat_ngram(logits, ids_buf, cur_len, ngram_sizes)
    if k is None:
        x = logits.float()
        lse = torch.logsumexp(x, dim=-1, keepdim=True)
        cand, ban = _ngram_bans(ids_buf, cur_len, ngram_sizes)
        if cand is not None:
            bv = x.gather(-1, cand)
            mass = torch.where(ban, torch.exp(bv - lse),
                               torch.zeros_like(bv)).sum(-1, keepdim=True)
            lse = lse + torch.log1p(-mass.clamp(max=1.0 - 1e-7))
        tv, ti = topk(banned, bef)
        return ti, tv.float() - lse
    tv, ti = topk(banned, k)
    tv = tv.float()
    logp = torch.log_softmax(tv / (1.0 if greedy else temperature), dim=-1)
    if greedy:
        pos = topk(tv, bef)[1]
    else:
        if gumbel is None:
            gumbel = gumbel_noise(logp.shape, generator, logp.device)
        pos = topk(logp + gumbel, bef)[1]
    return ti.gather(-1, pos), logp.gather(-1, pos)
