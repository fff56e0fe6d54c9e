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
(b) a tiled bf16 tensor-core GEMM (``csrc/gemm.cuh``: 128x128 tiles,
    cp.async double buffering, f32 accumulators) whose A operand and
    residual are read through row-index lists and whose epilogue adds the
    bias and residual in bf16 and writes rows at an offset: it serves
    ``[q | kv]``, ``Wo + bo + residual`` and the sparse bypass, which lands
    directly in rows t_sel.. of the output, so the [sel; byp] gather costs
    no separate pass;
(c) a multi-query attention kernel, a warp per 16 query rows of one
    (image, head), its Q/K/V fragments read straight from device memory
    and its bf16 scores and probabilities kept in shared memory (32·t + 1
    KB bytes per warp: 45 KB a block at the dense block's t = 320);
(d) the MoE FFN kernel with the LN2 prologue and residual epilogue,
    writing the chain's rows of the output.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from image2text_torch.nn.modules import layer_norm
from image2text_torch.ops import _build
from image2text_torch.ops.attention import sdpa
from image2text_torch.ops.fused_moe import (MoELinearWeights, launch_moe_ffn,
                                            moe_ffn_plain)


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
    err = _fn(lib, "gemm_launch")(
        _build.ptr(A), _build.ptr(a_rows), ctypes.c_int(a_T), _build.ptr(B),
        _build.ptr(bias), _build.ptr(R), _build.ptr(r_rows),
        ctypes.c_int(r_T), _build.ptr(C), ctypes.c_int(c_T),
        ctypes.c_int(c_off), ctypes.c_int(n_img), ctypes.c_int(t_g),
        ctypes.c_int(N), ctypes.c_int(K), stream)
    _build.check(err, "gemm_launch")


def _check_chain(kernel: str, x: torch.Tensor, w, ts: int) -> None:
    """Raise unless the chain's kernels take ``x`` and ``w`` with ``ts``
    rows per image going through the chain."""
    b, t, d = x.shape
    hd = d // w.n_head
    for f in ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o", "ln2_w",
              "ln2_b"):
        _build.check_operand(kernel, f, getattr(w, f), torch.bfloat16)
    _build.check_operand(kernel, "x", x, torch.bfloat16)
    tp = -(-ts // 16) * 16
    if (ts < 2 or d % 64 or hd not in (16, 32, 64, 128)
            or w.n_head * hd != d or w.w_qkv.shape != (d, d + 2 * hd)
            or _attn_smem(tp) > ATTN_SMEM_LIMIT):
        raise ValueError(f"{kernel} kernel: unsupported shape b={b} t={t} "
                         f"rows through the chain {ts} d={d} n_head="
                         f"{w.n_head} (needs d % 64 == 0, a head dim of 16, "
                         f"32, 64 or 128, and at most {MAX_ATTN_ROWS} rows "
                         "for the attention's shared memory)")


# The attention kernel's dynamic shared memory: 4 warps, each 32 bytes per
# (padded) key column for its 16 rows of bf16 scores, plus a 1 KB staging
# tile; a block may take 227 KB.
ATTN_SMEM_LIMIT = 227 * 1024


def _attn_smem(tp: int) -> int:
    return 4 * (32 * tp + 1024)


MAX_ATTN_ROWS = (ATTN_SMEM_LIMIT // 4 - 1024) // 32 // 16 * 16


def _launch_chain(lib, stream, x, rows, ts, w, out, routes) -> None:
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
    # [q | k | v] rows, ts rounded up to 16 per image (pad rows zero)
    tp = -(-ts // 16) * 16
    qkv = (torch.empty if tp == ts else torch.zeros)(
        b * tp, d + 2 * hd, dtype=x.dtype, device=x.device)
    _gemm(lib, stream, xn, None, ts, w.w_qkv, w.b_qkv, None, None, ts, qkv,
          tp, 0, b, ts)
    o = torch.empty(b * ts, d, dtype=x.dtype, device=x.device)
    err = _fn(lib, "mqa_attention_launch")(
        _build.ptr(qkv), _build.ptr(o), ctypes.c_int(b), ctypes.c_int(ts),
        ctypes.c_int(w.n_head), ctypes.c_int(hd),
        ctypes.c_float(1.0 / math.sqrt(hd)), stream)
    _build.check(err, "mqa_attention_launch")
    x1 = torch.empty(b * ts, d, dtype=x.dtype, device=x.device)
    _gemm(lib, stream, o, None, ts, w.w_o, w.b_o, x, rows, t, x1, ts, 0,
          b, ts)
    launch_moe_ffn(x1, w.fc, w.proj, out, w.ln2_w, w.ln2_b, residual=x1,
                   rows_per_img=ts, out_rows_per_img=t, routes=routes)


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
    t = x.shape[1]
    _check_chain("fused_block", x, w, t)
    lib = _build.load("fused_block")
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    out = torch.empty_like(x)
    _launch_chain(lib, stream, x, None, t, w, out, routes)
    fused_block.launches += 1
    return out


fused_block.launches = 0
