"""Eval encoder blocks: CUDA kernels (``csrc/fused_block.cu`` plus the MoE
FFN of ``csrc/fused_moe.cu``) and their plain versions.

Two entry points share one residual chain, ``x1 = x + attn(ln_1(x))`` then
``x1 + ffn(ln_2(x1))``, with multi-query attention (one shared K/V head),
scores rounded to bf16 before an f32 softmax and probabilities in bf16
before the V product:

* :func:`sparse_block` replaces
  ``image2text_tpu/ops/fused_block.py::_sparse_block_kernel`` (the Pallas
  kernel behind ``fused_sparse_block_compatible``): a whole sparse block on
  the (b, t, d) stream under the lazy layout.  The selected rows
  ``x[:, rows_sel]`` go through the chain; the bypass rows
  ``x_b = x[:, rows_byp]`` become ``x_b + x_b·Wn + bn``; the output holds
  ``[sel; byp]`` rows, the ``TransformerBlock.next_layout`` contract.
* :func:`fused_block` replaces ``::_block_kernel`` (behind
  ``fused_block_compatible``): the chain on an already-selected (b, t, d)
  stream, every row, as the eval dense block runs it.

What bounds them on the H100: operations.  At b = 256, t = 320, d = 1024
the sparse block is about 1.35 GFLOP per image (t_sel 160) and the dense
one about 2.2 (t 320), 0.35 and 0.58 ms at the dense bf16 peak, against
about 0.1 ms of stream bytes.  The TPU kernels kept some 7.6 MB of weights
resident in VMEM per image; a Hopper block has 227 KB of shared memory, so
the port is not one megakernel but a short sequence of kernels, each sized
for many thread blocks in flight:

(a) ``ln_gather``: LN1 of the selected rows, gathered through the row list
    (every row for the dense block);
(b) a wgmma GEMM (``csrc/gemm.cuh``: 128x256 tiles fed by TMA through a
    4-stage mbarrier ring, a producer warp and two consumer warpgroups,
    f32 accumulators) whose residual is read through a row-index list and
    whose epilogue adds the bias and residual in bf16 and writes rows at an
    offset: it serves ``[q | kv]``, ``Wo + bo + residual`` and the sparse
    bypass, which lands directly in rows t_sel.. of the output, so the
    [sel; byp] concat costs no pass (the bypass rows themselves are
    gathered contiguous first: TMA loads boxes, not row lists);
(c) a multi-query attention kernel with the heads folded into the rows:
    a block stages one image's K and Vᵀ in shared memory once, its warps
    run 16 folded query rows at a time through mma.sync, an exact softmax
    in registers (``MAX_ATTN_ROWS`` keys at most at head dims up to 128);
    past that, and at head dim 256, the K/V-tiled form of the same kernel
    (:func:`attn_route`), which stages 64 keys at a time and takes any
    row count;
(d) the MoE FFN kernel with the LN2 prologue and residual epilogue,
    writing the chain's rows of the output.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from image2text_torch.nn.modules import layer_norm
from image2text_torch.ops import _build
from image2text_torch.ops.attention import sdpa
from image2text_torch.ops.flash_attention import RESIDENT_HEAD_DIMS
from image2text_torch.ops.fused_moe import (MoELinearWeights, launch_moe_ffn,
                                            moe_ffn_plain)
from image2text_torch.utils.device import sm_count


class BlockWeights(NamedTuple):
    """One block in the kernels' layouts (compute dtype; LayerNorm
    parameters as stored): the residual chain's weights and, for a sparse
    block, the null connector's.  Linear weights are transposed to
    (in, out); a missing bias is None."""

    ln1_w: torch.Tensor
    ln1_b: Optional[torch.Tensor]
    w_qkv: torch.Tensor          # (d, d + 2·hd) = [Wqᵀ | Wkvᵀ]
    b_qkv: Optional[torch.Tensor]
    w_o: torch.Tensor            # (d, d)
    b_o: Optional[torch.Tensor]
    ln2_w: torch.Tensor
    ln2_b: Optional[torch.Tensor]
    fc: MoELinearWeights
    proj: MoELinearWeights
    n_head: int
    w_n: Optional[torch.Tensor] = None   # (d, d) null connector
    b_n: Optional[torch.Tensor] = None


def _bias_add(y, b):
    return y if b is None else y + b


def fused_block_plain(x: torch.Tensor, w: BlockWeights,
                      routes: Optional[torch.Tensor] = None,
                      force_routes: Optional[torch.Tensor] = None,
                      gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the chain on the (b, t, d) stream ``x``,
    step for step as the kernels.  ``routes``, ``force_routes`` and
    ``gates`` are the FFN stage's, on the b·t rows (:func:`moe_ffn_plain`)."""
    b, t, d = x.shape
    hd = d // w.n_head
    xn = layer_norm(x, w.ln1_w, w.ln1_b)
    qkv = _bias_add(torch.matmul(xn, w.w_qkv), w.b_qkv)
    q = qkv[..., :d].reshape(b, t, w.n_head, hd).transpose(1, 2)
    k = qkv[..., None, d:d + hd].transpose(1, 2)
    v = qkv[..., None, d + hd:].transpose(1, 2)
    o = sdpa(q, k, v).transpose(1, 2).reshape(b, t, d)
    x1 = x + _bias_add(torch.matmul(o, w.w_o), w.b_o)
    return moe_ffn_plain(x1, w.fc, w.proj, w.ln2_w, w.ln2_b, residual=x1,
                         routes=routes, force_routes=force_routes,
                         gates=gates)


def sparse_block_plain(x: torch.Tensor, rows_sel: torch.Tensor,
                       rows_byp: torch.Tensor, w: BlockWeights,
                       routes: Optional[torch.Tensor] = None,
                       force_routes: Optional[torch.Tensor] = None,
                       gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the same chain as the kernels, step for step.
    ``routes``, ``force_routes`` and ``gates`` are the FFN stage's, on the
    b·t_sel selected rows (:func:`moe_ffn_plain`)."""
    xs = x.index_select(1, rows_sel.long())
    xb = x.index_select(1, rows_byp.long())
    ys = fused_block_plain(xs, w, routes, force_routes, gates)
    yb = xb + _bias_add(torch.matmul(xb, w.w_n), w.b_n)
    return torch.cat([ys, yb], dim=1)


def _fn(lib, name):
    f = getattr(lib, name)
    f.restype = ctypes.c_int
    return f


def _gemm(lib, stream, A, a_rows, a_T, B, bias, R, r_rows, r_T, C, c_T,
          c_off, n_img, t_g):
    K, N = B.shape
    # a row list on A: the kernel gathers the rows into this scratch first
    scratch = (None if a_rows is None else
               torch.empty(n_img * t_g, K, dtype=A.dtype, device=A.device))
    err = _fn(lib, "gemm_launch")(
        _build.ptr(A), _build.ptr(a_rows), ctypes.c_int(a_T),
        _build.ptr(scratch), _build.ptr(B), _build.ptr(bias), _build.ptr(R),
        _build.ptr(r_rows), ctypes.c_int(r_T), _build.ptr(C),
        ctypes.c_int(c_T), ctypes.c_int(c_off), ctypes.c_int(n_img),
        ctypes.c_int(t_g), ctypes.c_int(N), ctypes.c_int(K), stream)
    _build.check(err, "gemm_launch")


# The resident attention kernel stages one image's K (tp x (hd + 8) bf16)
# and Vᵀ (hd x (tp + 8)) in shared memory, tp = t rounded up to 16; a block
# may take 227 KB (232,448 bytes).  At head dim 128 that is tp <= 432;
# smaller head dims fit more, but one limit holds for all.  Longer rows,
# and head dim 256, take the K/V-tiled kernel.
ATTN_SMEM_LIMIT = 232448
ATTN_HEAD_DIMS = (16, 32, 64, 128, 256)


def _attn_smem(tp: int, hd: int = 128) -> int:
    return (tp * (hd + 8) + hd * (tp + 8)) * 2


MAX_ATTN_ROWS = max(tp for tp in range(16, 4096, 16)
                    if _attn_smem(tp) <= ATTN_SMEM_LIMIT)


def attn_route(t: int, hd: int) -> str:
    """``"resident"`` (K/V of an image in one block's shared memory) for
    head dims up to 128 and at most ``MAX_ATTN_ROWS`` rows, else
    ``"tiled"``."""
    return ("resident" if hd in RESIDENT_HEAD_DIMS and t <= MAX_ATTN_ROWS
            else "tiled")


def chain_takes(d: int, n_head: int) -> bool:
    """Whether the chain's kernels take a block of width ``d`` and
    ``n_head`` heads (any row count from 2)."""
    hd = d // n_head
    return d % 64 == 0 and hd in ATTN_HEAD_DIMS and n_head * hd == d


def _chain_shape_error(b: int, t: int, d: int, n_head: int, ts: int,
                       w_qkv_shape) -> Optional[str]:
    """Why the chain's kernels refuse these shapes (``ts`` rows per image
    through the chain), or None."""
    hd = d // n_head
    if (ts < 2 or not chain_takes(d, n_head)
            or tuple(w_qkv_shape) != (d, d + 2 * hd)):
        return (f"unsupported shape b={b} t={t} rows through the chain {ts} "
                f"d={d} n_head={n_head} (needs d % 64 == 0, a head dim of "
                f"16, 32, 64, 128 or 256, and at least 2 rows)")
    return None


def _check_chain(kernel: str, x: torch.Tensor, w, ts: int) -> None:
    """Raise unless the chain's kernels take ``x`` and ``w`` with ``ts``
    rows per image going through the chain."""
    for f in ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o", "ln2_w",
              "ln2_b"):
        _build.check_operand(kernel, f, getattr(w, f), torch.bfloat16)
    _build.check_operand(kernel, "x", x, torch.bfloat16)
    err = _chain_shape_error(*x.shape, w.n_head, ts, w.w_qkv.shape)
    if err is not None:
        raise ValueError(f"{kernel} kernel: {err}")


def _attn_blocks(b: int, n_head: int, ts: int, n_sms: int) -> int:
    """Blocks per image of the attention kernel (16 warps of 16 folded
    rows each): about two blocks an SM over the batch (``n_sms``: 132 on
    the H100 SXM), at most one per 256 folded rows.  At b 256 that is 2,
    which measured faster than 3 or 5 at t 160 and 320 (PERF.md §6)."""
    return max(1, min(-(-2 * n_sms // b), -(-n_head * ts // 256)))


def _attention(lib, stream, qkv, b: int, t: int, n_head: int,
               hd: int) -> torch.Tensor:
    """The attention kernel on ``qkv`` (b·t, n_head·hd + 2·hd) rows [q | k
    | v]; returns o (b·t, n_head·hd)."""
    o = torch.empty(b * t, n_head * hd, dtype=qkv.dtype, device=qkv.device)
    err = _fn(lib, "mqa_attention_launch")(
        _build.ptr(qkv), _build.ptr(o), ctypes.c_int(b), ctypes.c_int(t),
        ctypes.c_int(n_head), ctypes.c_int(hd),
        ctypes.c_float(1.0 / math.sqrt(hd)),
        ctypes.c_int(_attn_blocks(b, n_head, t, sm_count(qkv.device))),
        ctypes.c_int(attn_route(t, hd) == "tiled"), stream)
    _build.check(err, "mqa_attention_launch")
    return o


def _launch_chain(lib, stream, x, rows, ts, w, out, routes,
                  defines: Tuple[str, ...] = ()) -> None:
    """The chain's kernels on the ``ts`` rows of each image that ``rows``
    (int32, or None for every row) picks from ``x`` (b, t, d); the chain's
    output lands in rows 0..ts of each image of ``out`` (b, t, d)."""
    b, t, d = x.shape
    hd = d // w.n_head
    xn = torch.empty(b * ts, d, dtype=x.dtype, device=x.device)
    err = _fn(lib, "ln_gather_launch")(
        _build.ptr(x), _build.ptr(xn), _build.ptr(rows), ctypes.c_int(b),
        ctypes.c_int(t), ctypes.c_int(ts), ctypes.c_int(d),
        _build.ptr(w.ln1_w), _build.ptr(w.ln1_b), stream)
    _build.check(err, "ln_gather_launch")
    # [q | k | v] rows, ts per image
    qkv = torch.empty(b * ts, d + 2 * hd, dtype=x.dtype, device=x.device)
    _gemm(lib, stream, xn, None, ts, w.w_qkv, w.b_qkv, None, None, ts, qkv,
          ts, 0, b, ts)
    o = _attention(lib, stream, qkv, b, ts, w.n_head, hd)
    x1 = torch.empty(b * ts, d, dtype=x.dtype, device=x.device)
    _gemm(lib, stream, o, None, ts, w.w_o, w.b_o, x, rows, t, x1, ts, 0,
          b, ts)
    launch_moe_ffn(x1, w.fc, w.proj, out, w.ln2_w, w.ln2_b, residual=x1,
                   rows_per_img=ts, out_rows_per_img=t, routes=routes,
                   defines=defines)


def sparse_block(x: torch.Tensor, rows_sel: torch.Tensor,
                 rows_byp: torch.Tensor, w: BlockWeights,
                 routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One lazy sparse block on the (b, t, d) stream; ``rows_sel`` and
    ``rows_byp`` (int32, on x's device) are the stream rows of the selected
    and bypass positions.  Returns the (b, t, d) stream in [sel; byp]
    order.  ``routes`` ((b·t_sel, 2) uint8), when given, receives the FFN's
    expert masks (for comparisons)."""
    if x.device.type == "cpu":
        return sparse_block_plain(x, rows_sel, rows_byp, w, routes)
    b, t, d = x.shape
    ts, tb = rows_sel.shape[0], rows_byp.shape[0]
    if w.w_n is None:
        raise ValueError("sparse_block kernel: w_n (the null connector) is "
                         "missing")
    for name, operand, dt in (("w_n", w.w_n, torch.bfloat16),
                              ("b_n", w.b_n, torch.bfloat16),
                              ("rows_sel", rows_sel, torch.int32),
                              ("rows_byp", rows_byp, torch.int32)):
        _build.check_operand("sparse_block", name, operand, dt)
    _check_chain("sparse_block", x, w, ts)
    if ts + tb != t:
        raise ValueError(f"sparse_block kernel: t_sel {ts} + bypass {tb} "
                         f"rows != t {t}")
    lib = _build.load("fused_block")
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    out = torch.empty_like(x)
    _launch_chain(lib, stream, x, rows_sel, ts, w, out, routes)
    _gemm(lib, stream, x, rows_byp, t, w.w_n, w.b_n, x, rows_byp, t, out, t,
          ts, b, tb)
    sparse_block.launches += 1
    return out


sparse_block.launches = 0


def fused_block(x: torch.Tensor, w: BlockWeights,
                routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain on every row of the (b, t, d) stream ``x``: the eval dense
    block.  ``routes`` ((b·t, 2) uint8), when given, receives the FFN's
    expert masks (for comparisons)."""
    if x.device.type == "cpu":
        return fused_block_plain(x, w, routes)
    out = run_chain(x, w, routes)
    fused_block.launches += 1
    return out


def run_chain(x: torch.Tensor, w: BlockWeights,
              routes: Optional[torch.Tensor] = None,
              defines: Tuple[str, ...] = ()) -> torch.Tensor:
    """The chain's kernels on every row of the CUDA tensor ``x``, built
    with ``defines`` (a probe build, ``image2text_torch/probes/``; none:
    the shipping kernels).  Counts nothing: :func:`fused_block` is the
    counting wrapper."""
    t = x.shape[1]
    _check_chain("fused_block", x, w, t)
    lib = _build.load("fused_block", defines)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    out = torch.empty_like(x)
    _launch_chain(lib, stream, x, None, t, w, out, routes, defines)
    return out


fused_block.launches = 0
