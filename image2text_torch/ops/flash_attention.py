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
:func:`bwd_plan`).  Past that, and at head dim 256, the tiled route: a
forward and a dQ kernel that stream K/V stages under 64-row tiles of the
folded rows, and a dK/dV kernel that holds a 64-key tile and walks query
tiles, G groups a key tile with f32 partials summed in group order; the
same per-pair work in registers, and the causal band skipped on the
device.  The function is the Pallas one, not its TPU layout:

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
The plane is over *global* coordinates: under a mesh a rank holding rows
[b0, b0 + b) of the batch and heads [h0, h0 + h) of H passes ``planes =
(H, b0·H + h0)`` and hashes (b0 + i)·H + h0 + j for its (i, j), as the
one-device call would (:func:`planes_of`; one integer pair a launch).

Head dims: the kernels take 16, 32, 64, 128 and 256; any other head dim
up to 256 (JAX's flash limit) is padded with zero lanes to the next of
them, with the scale of the true head dim, and the output cut back (zero
lanes add nothing to a score, and give zero output lanes).  Head dim 256
takes the tiled kernels (forward and backward) and the f32 kernels.

The wrappers dispatch on the dtype, as the JAX kernels are generic in it:
bf16 operands take the kernels of ``csrc/flash_attention.cu`` (their
plans :func:`fwd_plan`, :func:`bwd_plan`), f32 operands (the configs with
``precision: 'no'``) the f32 kernels of ``csrc/flash_attention_f32.cu``,
which run every product on the tensor cores as 3xTF32 (each operand split
into two TF32 halves, three products: about f32's accuracy) and round
nothing narrower.  Their tiling is the tiled route's: a forward and a dQ
kernel on 64-row tiles of the folded rows (:func:`f32_groups` blocks a
plane), and a dK/dV kernel with :func:`f32_bwd_plan` groups a key tile
whose f32 partials a second kernel sums in group order; they count no
visited pairs.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises on what the kernel does not take (a head
dim above 256, K/V heads other than 1 or h, a bias whose query axis is
neither 1 nor sq, a dtype other than bf16 or f32).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from image2text_torch.ops import _build
from image2text_torch.ops.functions import kernel_scope
from image2text_torch.utils.device import sm_count

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
# the resident kernels' (bf16; flash's and the chain's attention's)
RESIDENT_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
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
# The tiled route's: the forward and dQ kernels take 64-row tiles of the
# folded rows (TILE_ROWS) and stream K/V in stages of at most TILE_KEYS
# keys; the dK/dV kernel holds DKV_KEYS keys a block and walks DKV_ROWS-row
# query tiles.
TILED_ROWS, TILED_KEYS, DKV_KEYS, DKV_ROWS = _kernel_constants(
    "TILE_ROWS", "TILE_KEYS", "DKV_KEYS", "DKV_ROWS")
# the entry points' ``route`` argument
ROUTES = {"resident": 0, "tiled": 1}
# The f32 kernels' (csrc/flash_attention_f32.cu): the forward and dQ
# kernels take F32_TILE_ROWS-row tiles of the folded rows; the dK/dV kernel
# holds F32_DKV_KEYS keys a block (half past head dim 64) and walks
# F32_DKV_ROWS-row query tiles.
F32_TILE_ROWS, F32_DKV_KEYS, F32_DKV_ROWS = _build.kernel_constants(
    "flash_attention_f32", "F32_TILE_ROWS", "F32_DKV_KEYS", "F32_DKV_ROWS")


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


def planes_of(b: int, h: int, rows=(0, 0), heads=(0, 0)) -> Tuple[int, int]:
    """(plane_h, plane_off) of the dropout hash for a call on ``b`` rows
    and ``h`` heads that are rows ``rows = (first, total)`` of the global
    batch and heads ``heads = (first, total)`` of all (``(0, 0)``: the
    call's own): plane (i, j) = plane_off + i·plane_h + j."""
    if len(heads) != 2:
        raise NotImplementedError("flash dropout over heads split in two "
                                  "halves: their planes are not contiguous")
    h_all = heads[1] or h
    return h_all, rows[0] * h_all + heads[0]


def kernel_head_dim(d: int) -> int:
    """The kernels' head dim a head dim ``d`` is padded to."""
    for k in KERNEL_HEAD_DIMS:
        if d <= k:
            return k
    raise ValueError(f"flash kernels: head dim {d} above "
                     f"{KERNEL_HEAD_DIMS[-1]}")


def _keep(b, h, sq, skv, seed, rate, device, planes=None) -> torch.Tensor:
    """(b, h, sq, skv) keep mask of one attention call."""
    plane_h, plane_off = planes if planes is not None else (h, 0)
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(skv, device=device)[None, :]
    plane = (plane_off + torch.arange(b, device=device)[:, None] * plane_h
             + torch.arange(h, device=device)[None, :]).reshape(b, h, 1, 1)
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
                        rate: float = 0.0, seed: int = 0, planes=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out in q's dtype, lse (b, h,
    sq) f32).  q (b, h, sq, d); k/v (b, hk, skv, d), hk ∈ {1, h}."""
    b, h, sq, _ = q.shape
    s = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        p = p * _keep(b, h, sq, k.shape[-2], seed, rate, q.device,
                      planes) * (1.0 / (1.0 - rate))
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_backward_plain(q, k, v, bias, causal: bool, g, lse, dvec,
                         rate: float = 0.0, seed: int = 0, planes=None):
    """Plain version of the backward kernels: (dq, dk, dv) in the inputs'
    dtypes, from the forward's ``lse`` and ``dvec = rowsum(g ∘ out)``."""
    b, h, sq, _ = q.shape
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(_scores(q, k, bias, causal) - lse[..., None])
    gf = g.float()
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    if rate > 0.0:
        keep = _keep(b, h, sq, k.shape[-2], seed, rate, q.device,
                     planes) * (1.0 / (1.0 - rate))
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
    dtype = q.dtype if q.dtype in KERNEL_DTYPES else torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(kernel, name, t, dtype)
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS} (pad it: kernel_head_dim)")
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


def _common_args(q, k, bias, strides, causal, rate, seed, scale, planes):
    """The C entry points' trailing arguments (``I2T_FLASH_ARGS``), as the
    plain Python values their argtypes convert."""
    b, h, sq, d = q.shape
    plane_h, plane_off = planes if planes is not None else (h, 0)
    return [0 if bias is None else bias.data_ptr(), *strides, b, h,
            k.shape[1], sq, k.shape[2], d, int(causal), scale,
            int(rate > 0.0), int(seed) & _M32, keep_threshold(rate),
            1.0 / (1.0 - rate), plane_h, plane_off, _build.stream(q.device)]


_COMMON_TYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
                 + [ctypes.c_uint] * 2 + [ctypes.c_float]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# leading arguments of each entry point: its pointers, then the route (the
# bf16 kernels) and the groups (the backward: the dK/dV kernel's, then the
# dQ kernel's)
_LEAD_TYPES = {"flash_fwd_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2,
               "flash_bwd_launch": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3,
               "flash_fwd_f32_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int],
               "flash_bwd_f32_launch": [ctypes.c_void_p] * 10
               + [ctypes.c_int] * 2}


def _launch(name: str, *args):
    source = ("flash_attention_f32" if name.endswith("_f32_launch")
              else "flash_attention")
    fn = _build.entry_point(source, name, _LEAD_TYPES[name] + _COMMON_TYPES)
    _build.check(fn(*args), name)


@functools.lru_cache(maxsize=256)
def fwd_plan(b: int, h: int, hk: int, sq: int, skv: int,
             n_sms: int, d: int = 128) -> Tuple[str, int]:
    """(route, groups) of one forward call, the kernel's launch arguments.
    ``"resident"`` while a K/V plane fits one block (skv <=
    RESIDENT_MAX_KEYS and a head dim ``d`` in RESIDENT_HEAD_DIMS):
    ``groups`` blocks share a plane's 16-row tiles (h heads' rows folded
    for multi-query), at least a tile for each of a block's warps, and
    G·b·hk at most FWD_BLOCKS_PER_SM·n_sms, one wave: a block's shared
    memory (the K/V plane and a Q tile a warp: at most 104,448 bytes, at d
    128 and 160 keys) fits that many times in an SM.  Else ``"tiled"``,
    :func:`tiled_groups` blocks a plane."""
    if skv > RESIDENT_MAX_KEYS or d not in RESIDENT_HEAD_DIMS:
        return "tiled", tiled_groups(h, hk, sq)
    tiles = -(-(h if hk == 1 else 1) * sq // FWD_TILE_ROWS)
    return "resident", max(1, min(-(-tiles // FWD_WARPS),
                                  FWD_BLOCKS_PER_SM * n_sms // (b * hk)))


def tiled_groups(h: int, hk: int, sq: int) -> int:
    """Blocks a K/V plane of the tiled forward and of the tiled dQ kernel:
    one for each TILED_ROWS-row tile of its folded rows (h heads' for one
    K/V head).  A block reloads the K/V stages for every tile it takes, so
    fewer blocks save nothing and lose the hardware's balancing of causal
    tiles of unequal length: at the five families' training shapes every
    smaller G measured slower (``probes/flash_groups.py``)."""
    return -(-(h if hk == 1 else 1) * sq // TILED_ROWS)


def f32_groups(h: int, hk: int, sq: int) -> int:
    """Blocks a K/V plane of the f32 forward and of the f32 dQ kernel: one
    for each F32_TILE_ROWS-row tile of its folded rows (h heads' for one
    K/V head)."""
    return -(-(h if hk == 1 else 1) * sq // F32_TILE_ROWS)


def f32_dkv_keys(d: int) -> int:
    """Keys of an f32 dK/dV block at head dim ``d``: past 64 two warps
    share 16 keys, each half of the dims."""
    return F32_DKV_KEYS // (2 if d > 64 else 1)


# blocks an SM the f32 dK/dV kernel's groups aim at
F32_DKV_BLOCKS_AN_SM = 2


@functools.lru_cache(maxsize=256)
def f32_bwd_plan(b: int, h: int, hk: int, sq: int, skv: int,
                 n_sms: int, d: int = 128) -> int:
    """Groups G of the f32 dK/dV kernel: G blocks share each (plane, key
    tile)'s F32_DKV_ROWS-row query tiles (h heads' for one K/V head), as
    many as keep the b·hk·⌈skv/keys⌉ key tiles' G blocks within
    F32_DKV_BLOCKS_AN_SM an SM (at most one per query tile; at least 1):
    a multi-query plane's few key tiles then fill the card (nano-mini's 12
    key tiles: G 22, 264 blocks), and a call with blocks enough already
    (every multi-head family) writes dK/dV with no partial sums."""
    tiles = (h if hk == 1 else 1) * -(-sq // F32_DKV_ROWS)
    key_tiles = b * hk * -(-skv // f32_dkv_keys(d))
    return max(1, min(tiles, F32_DKV_BLOCKS_AN_SM * n_sms // key_tiles))


def _pad(d: int, *ts):
    """The tensors with their last dim zero-padded to ``d``."""
    return tuple(t if t.shape[-1] == d else
                 torch.nn.functional.pad(t, (0, d - t.shape[-1])).contiguous()
                 for t in ts)


def flash_fwd(q, k, v, bias=None, causal: bool = False, rate: float = 0.0,
              seed: int = 0, planes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out, lse).  The CUDA kernels (bf16: :func:`fwd_plan`;
    f32: the f32 kernel) for CUDA tensors, the plain version for CPU
    tensors.  ``planes``: :func:`planes_of`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, bias, causal, rate, seed, planes)
    d_true = q.shape[-1]
    dk = kernel_head_dim(d_true)
    q, k, v = _pad(dk, q, k, v)
    bias, strides = _check("flash_fwd", q, k, v, bias)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    common = _common_args(q, k, bias, strides, causal, rate, seed,
                          1.0 / d_true ** 0.5, planes)
    if q.dtype == torch.float32:
        _launch("flash_fwd_f32_launch", *ptrs,
                f32_groups(h, k.shape[1], sq), *common)
    else:
        route, groups = fwd_plan(b, h, k.shape[1], sq, k.shape[2],
                                 sm_count(q.device), d)
        _launch("flash_fwd_launch", *ptrs, ROUTES[route], groups, *common)
    flash_fwd.launches += 1
    if d != d_true:
        out = out[..., :d_true].contiguous()
    return out, lse


# blocks an SM the tiled dK/dV kernel's groups aim at: G for 1 to 8 blocks
# an SM measured at Falcon-7B's call, the plan's 4 within 5% of the best
# (probes/flash_groups.py)
DKV_BLOCKS_AN_SM = 4


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, h: int, hk: int, sq: int, skv: int,
             n_sms: int, d: int = 128) -> Tuple[str, int]:
    """(route, groups) of one backward call, the kernels' launch argument
    G.  ``"resident"`` while a K/V plane fits one block (skv <=
    RESIDENT_MAX_KEYS and a head dim ``d`` in RESIDENT_HEAD_DIMS):
    ``groups`` blocks share a plane's query tiles, as many as the SMs left
    over by the b·hk planes allow without a second wave (at most one per
    tile).  Else ``"tiled"``: ``groups`` dK/dV blocks share each
    (plane, DKV_KEYS-key tile)'s DKV_ROWS-row query tiles (h heads' for
    one K/V head), as many as keep the b·hk·⌈skv/DKV_KEYS⌉ key tiles' G
    blocks within DKV_BLOCKS_AN_SM an SM (at most one per query tile; at
    least 1): a multi-query plane's few key tiles then fill the card
    (Falcon-7B's 4 planes, 20 key tiles: G 26), and a call with blocks
    enough already (every multi-head family) writes bf16 dK/dV with no
    partial sums.  The dQ kernel takes :func:`tiled_groups`."""
    if skv > RESIDENT_MAX_KEYS or d not in RESIDENT_HEAD_DIMS:
        tiles = (h if hk == 1 else 1) * -(-sq // DKV_ROWS)
        key_tiles = b * hk * -(-skv // DKV_KEYS)
        return "tiled", max(1, min(tiles, DKV_BLOCKS_AN_SM * n_sms
                                   // key_tiles))
    tiles = (h if hk == 1 else 1) * -(-sq // BWD_TILE_ROWS)
    return "resident", max(1, min(tiles, n_sms // (b * hk)))


def part_elems(groups: int, kv_elems: int) -> int:
    """f32 elements of a backward's dK/dV partials for ``groups`` groups
    of K/V with ``kv_elems`` elements (b·hk·skv·d): G partial dK, then G
    partial dV, which the second kernel sums in group order; none for one
    group (its blocks write dK/dV in the operands' dtype)."""
    return 0 if groups == 1 else 2 * groups * kv_elems


def _band_pairs(b: int, h: int, sq: int, skv: int, causal: bool, rows: int,
                keys: int) -> int:
    """(``rows``-row query tile, ``keys``-key tile) pairs of b·h planes a
    backward visits when no bias leaves a row without keys: under
    ``causal`` the key tiles up to the band of each query tile's last row,
    but all of them for a query tile holding a row the causal offset leaves
    keyless (sq > skv: it averages over every key); without ``causal`` all
    of them."""
    key_tiles = -(-skv // keys)
    per_plane = 0
    for q0 in range(0, sq, rows):
        last = min(q0 + rows, sq) - 1
        keyed = q0 + skv - sq >= 0
        per_plane += (min(key_tiles, (last + skv - sq) // keys + 1)
                      if causal and keyed else key_tiles)
    return b * h * per_plane


def bwd_pairs(b: int, h: int, sq: int, skv: int, causal: bool) -> int:
    """(BWD_TILE_ROWS-row query tile, BWD_KEY_SLICE-key slice) pairs the
    resident backward visits (:func:`_band_pairs`)."""
    return _band_pairs(b, h, sq, skv, causal, BWD_TILE_ROWS, BWD_KEY_SLICE)


def tiled_bwd_pairs(b: int, h: int, sq: int, skv: int, causal: bool) -> int:
    """(DKV_ROWS-row query tile, DKV_KEYS-key tile) pairs the tiled dK/dV
    kernel visits (:func:`_band_pairs`)."""
    return _band_pairs(b, h, sq, skv, causal, DKV_ROWS, DKV_KEYS)


def flash_bwd(q, k, v, bias, causal: bool, g, lse, dvec,
              rate: float = 0.0, seed: int = 0, pairs=None, planes=None):
    """(dq, dk, dv) from the forward's ``lse`` and ``dvec = rowsum(g ∘
    out)``; multi-query dK/dV summed over the query heads.  The CUDA
    kernels (:func:`bwd_plan`) for CUDA tensors, the plain version for CPU
    tensors.  ``pairs``, an int32 CUDA tensor of one element, gets the
    visited pairs added: the resident kernel's (query tile, key slice)
    pairs, the tiled dK/dV kernel's (query tile, key tile) pairs (the f32
    kernels add none)."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, bias, causal, g, lse, dvec,
                                    rate, seed, planes)
    d_true = q.shape[-1]
    grads = _flash_bwd(*_pad(kernel_head_dim(d_true), q, k, v, g), bias,
                       causal, lse, dvec, rate, seed, pairs, planes,
                       1.0 / d_true ** 0.5)
    if grads[0].shape[-1] == d_true:
        return grads
    return tuple(t[..., :d_true].contiguous() for t in grads)


def _partials(groups: int, k) -> Optional[torch.Tensor]:
    """The f32 dK/dV partials of a backward with ``groups`` groups on
    K/V like ``k`` (:func:`part_elems`), or None."""
    n = part_elems(groups, k.numel())
    return (torch.empty(n, dtype=torch.float32, device=k.device) if n
            else None)


def _flash_bwd(q, k, v, g, bias, causal, lse, dvec, rate, seed, pairs,
               planes, scale):
    """:func:`flash_bwd` on operands of a kernel head dim."""
    bias, strides = _check("flash_bwd", q, k, v, bias)
    _build.check_operand("flash_bwd", "g", g, q.dtype)
    _build.check_operand("flash_bwd", "lse", lse, torch.float32)
    _build.check_operand("flash_bwd", "dvec", dvec, torch.float32)
    _build.check_operand("flash_bwd", "pairs", pairs, torch.int32)
    b, h, sq, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_sms, hk, skv = sm_count(q.device), k.shape[1], k.shape[2]
    common = _common_args(q, k, bias, strides, causal, rate, seed, scale,
                          planes)
    P = _build.ptr
    if q.dtype == torch.float32:
        groups = f32_bwd_plan(b, h, hk, sq, skv, n_sms, q.shape[-1])
        part = _partials(groups, k)
        _launch("flash_bwd_f32_launch", P(q), P(k), P(v), P(g), P(lse),
                P(dvec), P(dq), P(dk), P(dv), P(part), groups,
                f32_groups(h, hk, sq), *common)
        flash_bwd.launches += 1
        return dq, dk, dv
    route, groups = bwd_plan(b, h, hk, sq, skv, n_sms, q.shape[-1])
    dq_groups = tiled_groups(h, hk, sq) if route == "tiled" else 0
    part = _partials(groups, k)
    _launch("flash_bwd_launch", P(q), P(k), P(v), P(g), P(lse), P(dvec),
            P(dq), P(dk), P(dv), P(part), P(pairs), ROUTES[route], groups,
            dq_groups, *common)
    flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = flash_bwd.launches = 0


def flash_backward(q, k, v, bias, causal, out, lse, g, rate, seed,
                   planes=None):
    """(dq, dk, dv): ``D = rowsum(g ∘ out)`` in f32, then the backward
    wrapper."""
    g = g.contiguous()
    dvec = (g.float() * out.float()).sum(-1).contiguous()
    return flash_bwd(q, k, v, bias, causal, g, lse, dvec, rate, seed,
                     planes=planes)


class FlashSDPA(torch.autograd.Function):
    """Flash forward and flash backward; the backward regenerates the
    dropout mask from ``seed``.  No gradient for the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, rate: float, seed: int,
                planes=None):
        with kernel_scope():
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_fwd(q, k, v, bias, causal, rate, seed, planes)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, rate, seed, planes)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, rate, seed, planes = ctx.args
        dq, dk, dv = flash_backward(q, k, v, bias, causal, out, lse, g, rate,
                                    seed, planes)
        return dq, dk, dv, None, None, None, None, None


def flash_sdpa(q, k, v, bias: Optional[torch.Tensor] = None,
               causal: bool = False, rate: float = 0.0,
               seed: Optional[int] = None, planes=None) -> torch.Tensor:
    """Differentiable flash attention; ``seed`` is required when
    ``rate > 0`` (a fixed seed would drop the same entries every step).
    ``planes`` places the call's dropout planes in the global batch and
    heads (:func:`planes_of`)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("flash dropout needs a seed")
    if bias is not None:
        bias = bias.detach()
    return FlashSDPA.apply(q, k, v, bias, causal, rate,
                           0 if seed is None else int(seed), planes)


__all__ = ["NEG_BIG", "FlashSDPA", "bwd_pairs", "bwd_plan", "part_elems",
           "f32_bwd_plan", "f32_groups",
           "tiled_bwd_pairs", "tiled_groups",
           "dropout_keep_mask", "flash_bwd", "flash_forward_plain",
           "fwd_plan", "kernel_head_dim", "planes_of",
           "flash_backward_plain",
           "flash_fwd", "flash_sdpa", "keep_threshold"]

