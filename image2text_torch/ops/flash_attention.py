"""Flash attention for training: CUDA kernels (``csrc/flash_attention.cu``),
their plain versions, and the autograd function that joins them.

Replaces ``image2text_tpu/ops/flash_attention.py``'s three Pallas kernels:
``_fwd_kernel`` (FlashAttention-2 forward with online softmax, saving the
per-row logsumexp) by :func:`flash_fwd`, a K/V-resident kernel while a
plane fits one block (its plan is :func:`fwd_plan`), and ``_bwd_dkv_kernel`` (dK, dV
over a loop of query tiles) with ``_bwd_dq_kernel`` (dQ over a loop of key
tiles) by one backward, :func:`flash_bwd`, which computes the scores, the
probabilities and dS once per (query, key) pair for all three gradients
while a plane's K/V fit one block (``RESIDENT_MAX_KEYS``; the plan is
:func:`bwd_plan`).  The function is the Pallas one, not its TPU layout:

* scores ``q·kᵀ·scale`` in f32 plus an additive f32 bias clamped at
  ``NEG_BIG``, broadcast over (batch | 1, head | 1, query | 1, key);
  ``causal`` masks ``col > row + skv − sq`` to ``NEG_BIG`` inside the
  kernel; key columns past ``skv`` take no part at all (the TPU kernel's
  padded columns join the average of a fully masked row; here such a row
  gives the uniform average over its real keys);
* softmax statistics in f32; the denominator sums the probabilities
  *before* dropout; the probabilities times ``keep / (1 − rate)`` round to
  the input dtype before the V product;
* ``lse = max(m, NEG_BIG) + log(max(l, 1e-30))`` per row;
* backward from ``lse`` and ``D = rowsum(dO ∘ O)``:
  ``dS = p ∘ (keep·dP/(1 − rate) − D)``, ``dV = p̃ᵀ dO``,
  ``dK = dSᵀ q · scale``, ``dQ = dS k · scale``; multi-query dK/dV sum
  over the query heads; the bias gets no gradient (every bias on the
  path is a constant).

Dropout is a counter hash of (row, col, plane = batch·h + head, seed):
:func:`dropout_keep_mask` is bit for bit the JAX package's, so the kernels,
the plain versions and the JAX kernels all drop the same probabilities,
and the backward regenerates the forward's mask from the seed alone.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises on what the kernel does not take (a head
dim other than 16, 32, 64 or 128, K/V heads other than 1 or h, a bias
whose query axis is neither 1 nor sq, a dtype other than bf16).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from image2text_torch.ops import _build
from image2text_torch.utils.device import sm_count

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_M32 = 0xFFFFFFFF


def _kernel_constants(*names: str) -> Tuple[int, ...]:
    """``constexpr int NAME = <literal>;`` values of
    ``csrc/flash_attention.cu``: the kernels' tiling has one owner, the
    kernel source."""
    return _build.kernel_constants("flash_attention", *names)


# The backward kernel's tiling: query tiles of BWD_TILE_ROWS rows (RB), one
# warp per BWD_KEY_SLICE keys (KW), a whole K/V plane resident in one block
# of at most MAX_KW warps; longer planes take the tiled kernels.
BWD_TILE_ROWS, BWD_KEY_SLICE, _MAX_KW = _kernel_constants("RB", "KW",
                                                          "MAX_KW")
RESIDENT_MAX_KEYS = BWD_KEY_SLICE * _MAX_KW
# The resident forward's: 16-row query tiles, one a warp at a time, four
# warps a block, scores in 32-key slices, two blocks an SM (its launch
# bounds; the kernel source asserts that its shared memory at 160 keys, d
# 128, fits an SM twice).
FWD_TILE_ROWS, FWD_WARPS, FWD_KEY_SLICE, FWD_BLOCKS_PER_SM = (
    _kernel_constants("FWD_ROWS", "FWD_WARPS", "FWD_SLICE",
                      "FWD_BLOCKS_PER_SM"))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _M32


def keep_threshold(rate: float) -> int:
    """uint32 threshold: keep iff hash < threshold (probability 1 − rate
    to within 2^-32)."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_keep_mask(rows, cols, plane, seed: int, rate: float
                      ) -> torch.Tensor:
    """0/1 f32 keep mask over global score coordinates: a murmur3
    finalizer over ``rows·0x9E3779B1 ^ cols·0x85EBCA77 ^ plane·0xC2B2AE3D
    ^ seed`` in uint32 arithmetic, done in int64 (the products wrap, their
    low 32 bits stay right).  ``rows``, ``cols`` and ``plane`` are integer
    tensors that broadcast together; ``seed`` an int32 (reinterpreted as
    uint32)."""
    rows, cols, plane = (torch.as_tensor(t).to(torch.int64)
                         for t in (rows, cols, plane))
    x = (_u32(rows * 0x9E3779B1) ^ _u32(cols * 0x85EBCA77)
         ^ _u32(plane * 0xC2B2AE3D) ^ (int(seed) & _M32))
    x = x ^ (x >> 16)
    x = _u32(x * 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _u32(x * 0x846CA68B)
    x = x ^ (x >> 16)
    return (x < keep_threshold(rate)).float()


def _keep(b, h, sq, skv, seed, rate, device) -> torch.Tensor:
    """(b, h, sq, skv) keep mask of one attention call."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(skv, device=device)[None, :]
    plane = torch.arange(b * h, device=device).reshape(b, h, 1, 1)
    return dropout_keep_mask(rows, cols, plane, seed, rate)


def _scores(q, k, bias, causal: bool) -> torch.Tensor:
    """f32 scores with the bias (clamped) and the causal mask applied."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    if bias is not None:
        s = s + bias.float().clamp_min(NEG_BIG)
    if causal:
        sq, skv = q.shape[-2], k.shape[-2]
        row = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        col = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, NEG_BIG))
    return s


def flash_forward_plain(q, k, v, bias=None, causal: bool = False,
                        rate: float = 0.0, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out in q's dtype, lse (b, h,
    sq) f32).  q (b, h, sq, d); k/v (b, hk, skv, d), hk ∈ {1, h}."""
    b, h, sq, _ = q.shape
    s = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        p = p * _keep(b, h, sq, k.shape[-2], seed, rate, q.device) * (
            1.0 / (1.0 - rate))
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_backward_plain(q, k, v, bias, causal: bool, g, lse, dvec,
                         rate: float = 0.0, seed: int = 0):
    """Plain version of the backward kernels: (dq, dk, dv) in the inputs'
    dtypes, from the forward's ``lse`` and ``dvec = rowsum(g ∘ out)``."""
    b, h, sq, _ = q.shape
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(_scores(q, k, bias, causal) - lse[..., None])
    gf = g.float()
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    if rate > 0.0:
        keep = _keep(b, h, sq, k.shape[-2], seed, rate, q.device) * (
            1.0 / (1.0 - rate))
        ds = p * (keep * dp - dvec[..., None])
        p = p * keep
    else:
        ds = p * (dp - dvec[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(ds, k.float()) * scale
    if k.shape[1] == 1 and h > 1:
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check(kernel: str, q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(kernel, name, t, torch.bfloat16)
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if hk not in (1, h) or k.shape != (b, hk, skv, d) or v.shape != k.shape:
        raise ValueError(f"{kernel} kernel: k/v {tuple(k.shape)} must be "
                         f"(b, 1 or h, skv, d) for q {tuple(q.shape)}")
    if bias is None:
        return None, (0, 0, 0)
    if (bias.dim() != 4 or bias.shape[-1] != skv or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h) or bias.shape[2] not in (1, sq)):
        raise ValueError(f"{kernel} kernel: bias {tuple(bias.shape)} must be "
                         f"(1|b, 1|h, 1|sq, skv) for q {tuple(q.shape)}")
    bias = bias.detach().float().contiguous()
    bb, bh, bs, _ = bias.shape
    strides = (bh * bs * skv if bb > 1 else 0, bs * skv if bh > 1 else 0,
               skv if bs > 1 else 0)
    return bias, strides


def _common_args(q, k, bias, strides, causal, rate, seed):
    """The C entry points' trailing arguments (``I2T_FLASH_ARGS``), as the
    plain Python values their argtypes convert."""
    b, h, sq, d = q.shape
    return [0 if bias is None else bias.data_ptr(), *strides, b, h,
            k.shape[1], sq, k.shape[2], d, int(causal), 1.0 / d ** 0.5,
            int(rate > 0.0), int(seed) & _M32, keep_threshold(rate),
            1.0 / (1.0 - rate), _build.stream(q.device)]


_COMMON_TYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
                 + [ctypes.c_uint] * 2 + [ctypes.c_float, ctypes.c_void_p])
# leading arguments of each entry point: its pointers, then the groups
_LEAD_TYPES = {"flash_fwd_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int],
               "flash_bwd_launch": [ctypes.c_void_p] * 11 + [ctypes.c_int]}


def _launch(name: str, *args):
    fn = _build.entry_point("flash_attention", name,
                            _LEAD_TYPES[name] + _COMMON_TYPES)
    _build.check(fn(*args), name)


@functools.lru_cache(maxsize=256)
def fwd_plan(b: int, h: int, hk: int, sq: int, skv: int,
             n_sms: int) -> Tuple[str, int]:
    """(route, groups) of one forward call, the kernel's launch argument
    G.  ``"resident"`` while a K/V plane fits one block (skv <=
    RESIDENT_MAX_KEYS): ``groups`` blocks share a plane's 16-row tiles (h
    heads' rows folded for multi-query), at least a tile for each of a
    block's warps, and G·b·hk at most FWD_BLOCKS_PER_SM·n_sms, one wave:
    a block's shared memory (the K/V plane and a Q tile a warp: at most
    104,448 bytes, at d 128 and 160 keys) fits that many times in an SM;
    else ``"tiled"`` (groups 0)."""
    if skv > RESIDENT_MAX_KEYS:
        return "tiled", 0
    tiles = -(-(h if hk == 1 else 1) * sq // FWD_TILE_ROWS)
    return "resident", max(1, min(-(-tiles // FWD_WARPS),
                                  FWD_BLOCKS_PER_SM * n_sms // (b * hk)))


def flash_fwd(q, k, v, bias=None, causal: bool = False, rate: float = 0.0,
              seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out, lse).  The CUDA kernels (:func:`fwd_plan`) for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, bias, causal, rate, seed)
    bias, strides = _check("flash_fwd", q, k, v, bias)
    b, h, sq, d = q.shape
    _, groups = fwd_plan(b, h, k.shape[1], sq, k.shape[2], sm_count(q.device))
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), groups,
            *_common_args(q, k, bias, strides, causal, rate, seed))
    flash_fwd.launches += 1
    return out, lse


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, h: int, hk: int, sq: int, skv: int,
             n_sms: int) -> Tuple[str, int]:
    """(route, groups) of one backward call, the kernel's launch argument
    G.  ``"resident"`` while a K/V plane fits one block (skv <=
    RESIDENT_MAX_KEYS): ``groups`` blocks share a plane's query tiles, as
    many as the SMs left over by the b·hk planes allow without a second
    wave (at most one per tile); else ``"tiled"`` (groups 0)."""
    if skv > RESIDENT_MAX_KEYS:
        return "tiled", 0
    tiles = (h if hk == 1 else 1) * -(-sq // BWD_TILE_ROWS)
    return "resident", max(1, min(tiles, n_sms // (b * hk)))


def bwd_pairs(b: int, h: int, sq: int, skv: int, causal: bool) -> int:
    """(query tile, key slice) pairs the resident backward visits when no
    bias leaves a row without keys: under ``causal`` the slices up to the
    band of each tile's last row, but all of them for a tile holding a row
    the causal offset leaves keyless (sq > skv: it averages over every
    key); without ``causal`` all of them."""
    slices = -(-skv // BWD_KEY_SLICE)
    per_plane = 0
    for q0 in range(0, sq, BWD_TILE_ROWS):
        last = min(q0 + BWD_TILE_ROWS, sq) - 1
        keyed = q0 + skv - sq >= 0
        per_plane += (min(slices, (last + skv - sq) // BWD_KEY_SLICE + 1)
                      if causal and keyed else slices)
    return b * h * per_plane


def flash_bwd(q, k, v, bias, causal: bool, g, lse, dvec,
              rate: float = 0.0, seed: int = 0, pairs=None):
    """(dq, dk, dv) from the forward's ``lse`` and ``dvec = rowsum(g ∘
    out)``; multi-query dK/dV summed over the query heads.  The CUDA
    kernels (:func:`bwd_plan`) for CUDA tensors, the plain version for CPU
    tensors.  ``pairs``, an int32 CUDA tensor of one element, gets the
    resident kernel's visited (query tile, key slice) pairs added."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, bias, causal, g, lse, dvec,
                                    rate, seed)
    bias, strides = _check("flash_bwd", q, k, v, bias)
    _build.check_operand("flash_bwd", "g", g, torch.bfloat16)
    _build.check_operand("flash_bwd", "lse", lse, torch.float32)
    _build.check_operand("flash_bwd", "dvec", dvec, torch.float32)
    _build.check_operand("flash_bwd", "pairs", pairs, torch.int32)
    b, h, sq, _ = q.shape
    _, groups = bwd_plan(b, h, k.shape[1], sq, k.shape[2],
                         sm_count(q.device))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty(2 * groups * k.numel(), dtype=torch.float32,
                        device=q.device) if groups > 1 else None)
    P = _build.ptr
    _launch("flash_bwd_launch", P(q), P(k), P(v), P(g), P(lse), P(dvec),
            P(dq), P(dk), P(dv), P(part), P(pairs), ctypes.c_int(groups),
            *_common_args(q, k, bias, strides, causal, rate, seed))
    flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = flash_bwd.launches = 0


def flash_backward(q, k, v, bias, causal, out, lse, g, rate, seed):
    """(dq, dk, dv): ``D = rowsum(g ∘ out)`` in f32, then the backward
    wrapper."""
    g = g.contiguous()
    dvec = (g.float() * out.float()).sum(-1).contiguous()
    return flash_bwd(q, k, v, bias, causal, g, lse, dvec, rate, seed)


class FlashSDPA(torch.autograd.Function):
    """Flash forward and flash backward; the backward regenerates the
    dropout mask from ``seed``.  No gradient for the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, rate: float, seed: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, bias, causal, rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, rate, seed = ctx.args
        dq, dk, dv = flash_backward(q, k, v, bias, causal, out, lse, g, rate,
                                    seed)
        return dq, dk, dv, None, None, None, None


def flash_sdpa(q, k, v, bias: Optional[torch.Tensor] = None,
               causal: bool = False, rate: float = 0.0,
               seed: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention; ``seed`` is required when
    ``rate > 0`` (a fixed seed would drop the same entries every step)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("flash dropout needs a seed")
    if bias is not None:
        bias = bias.detach()
    return FlashSDPA.apply(q, k, v, bias, causal, rate,
                           0 if seed is None else int(seed))


__all__ = ["NEG_BIG", "FlashSDPA", "bwd_pairs", "bwd_plan",
           "dropout_keep_mask", "flash_bwd", "flash_forward_plain",
           "fwd_plan",
           "flash_backward_plain",
           "flash_fwd", "flash_sdpa", "keep_threshold"]

