"""Lazy sparse encoder block: CUDA kernels (``csrc/fused_block.cu`` plus the
MoE FFN of ``csrc/fused_moe.cu``) and their plain version.

Replaces ``image2text_tpu/ops/fused_block.py::_sparse_block_kernel`` (the
Pallas kernel behind ``fused_sparse_block_compatible``).  One call computes
a whole sparse block on the (b, t, d) stream under the lazy layout: the
selected rows ``x_s = x[:, rows_sel]`` go through
``x1 = x_s + attn(ln_1(x_s))`` and ``x1 + ffn(ln_2(x1))``; the bypass rows
``x_b = x[:, rows_byp]`` become ``x_b + x_b·Wn + bn``; the output holds
``[sel; byp]`` rows, the ``TransformerBlock.next_layout`` contract.
Attention is multi-query (one shared K/V head) with scores rounded to
bf16 before an f32 softmax and probabilities in bf16 before the V product.

What bounds it on the H100: operations.  At b = 256, t = 320, d = 1024 a
block is about 1.35 GFLOP per image, 0.35 ms at the dense bf16 peak,
against about 0.1 ms of stream bytes.  The TPU kernel kept some 7.6 MB of
weights resident in VMEM per image; a Hopper block has 227 KB of shared
memory, so the port is not one megakernel but a short sequence of
kernels, each sized for many thread blocks in flight:

(a) ``ln_gather``: LN1 of the selected rows, gathered through the row list;
(b) a tiled bf16 tensor-core GEMM (128x128 tiles, cp.async double
    buffering, f32 accumulators) whose A operand and residual are read
    through row-index lists and whose epilogue adds the bias and residual
    in bf16 and writes rows at an offset: it serves ``[q | kv]``,
    ``Wo + bo + residual`` and the bypass, which lands directly in rows
    t_sel.. of the output, so the [sel; byp] gather costs no separate pass;
(c) a multi-query attention kernel, a warp per 16 query rows of one
    (image, head), its Q/K/V fragments read straight from device memory
    and its bf16 scores and probabilities kept in shared memory;
(d) the MoE FFN kernel with the LN2 prologue and residual epilogue,
    writing rows 0..t_sel of the output.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernels or raises.
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


class SparseBlockWeights(NamedTuple):
    """One sparse block in the kernels' layouts (compute dtype; LayerNorm
    parameters as stored).  Linear weights are transposed to (in, out);
    a missing bias is None."""

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
    w_n: torch.Tensor            # (d, d) null connector
    b_n: Optional[torch.Tensor]
    n_head: int


def _bias_add(y, b):
    return y if b is None else y + b


def sparse_block_plain(x: torch.Tensor, rows_sel: torch.Tensor,
                       rows_byp: torch.Tensor, w: SparseBlockWeights,
                       routes: Optional[torch.Tensor] = None,
                       force_routes: Optional[torch.Tensor] = None,
                       gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the same chain as the kernels, step for step.
    ``routes``, ``force_routes`` and ``gates`` are the FFN stage's, on the
    b·t_sel selected rows (:func:`moe_ffn_plain`)."""
    b, t, d = x.shape
    ts = rows_sel.shape[0]
    hd = d // w.n_head
    xs = x.index_select(1, rows_sel.long())
    xb = x.index_select(1, rows_byp.long())
    xn = layer_norm(xs, w.ln1_w, w.ln1_b)
    qkv = _bias_add(torch.matmul(xn, w.w_qkv), w.b_qkv)
    q = qkv[..., :d].reshape(b, ts, w.n_head, hd).transpose(1, 2)
    k = qkv[..., None, d:d + hd].transpose(1, 2)
    v = qkv[..., None, d + hd:].transpose(1, 2)
    o = sdpa(q, k, v).transpose(1, 2).reshape(b, ts, d)
    x1 = xs + _bias_add(torch.matmul(o, w.w_o), w.b_o)
    ys = moe_ffn_plain(x1, w.fc, w.proj, w.ln2_w, w.ln2_b, residual=x1,
                       routes=routes, force_routes=force_routes, gates=gates)
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


def sparse_block(x: torch.Tensor, rows_sel: torch.Tensor,
                 rows_byp: torch.Tensor, w: SparseBlockWeights,
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
    hd = d // w.n_head
    for name, operand, dt in [(f, getattr(w, f), torch.bfloat16) for f in (
            "ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o", "ln2_w", "ln2_b",
            "w_n", "b_n")] + [("x", x, torch.bfloat16),
                              ("rows_sel", rows_sel, torch.int32),
                              ("rows_byp", rows_byp, torch.int32)]:
        _build.check_operand("sparse_block", name, operand, dt)
    if (ts + tb != t or ts < 2 or d % 64 or hd not in (16, 32, 64, 128)
            or w.n_head * hd != d or w.w_qkv.shape != (d, d + 2 * hd)):
        raise ValueError(f"sparse_block kernel: unsupported shape b={b} "
                         f"t={t} t_sel={ts} d={d} n_head={w.n_head} (needs "
                         "d % 64 == 0 and a head dim of 16, 32, 64 or 128)")
    lib = _build.load("fused_block")
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    xn = torch.empty(b * ts, d, dtype=x.dtype, device=x.device)
    err = _fn(lib, "ln_gather_launch")(
        _build.ptr(x), _build.ptr(xn), _build.ptr(rows_sel), ctypes.c_int(b),
        ctypes.c_int(t), ctypes.c_int(ts), ctypes.c_int(d),
        _build.ptr(w.ln1_w), _build.ptr(w.ln1_b), stream)
    _build.check(err, "ln_gather_launch")
    # [q | k | v] rows, t_sel rounded up to 16 per image (pad rows zero)
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
    _gemm(lib, stream, o, None, ts, w.w_o, w.b_o, x, rows_sel, t, x1, ts, 0,
          b, ts)
    out = torch.empty_like(x)
    launch_moe_ffn(x1, w.fc, w.proj, out, w.ln2_w, w.ln2_b, residual=x1,
                   rows_per_img=ts, out_rows_per_img=t, routes=routes)
    _gemm(lib, stream, x, rows_byp, t, w.w_n, w.b_n, x, rows_byp, t, out, t,
          ts, b, tb)
    sparse_block.launches += 1
    return out


sparse_block.launches = 0
