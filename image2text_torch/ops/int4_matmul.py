"""Int4 dequant-matmul: the CUDA kernel (``csrc/int4_matmul.cu``), its plain
version, the packing helpers and the autograd function of the quantized
Linear.

Replaces ``image2text_tpu/ops/int4_matmul.py::_int4_matmul_kernel``:
``y = x · dequant(W)ᵀ`` with W stored packed two 4-bit values per byte,
the float weight never in device memory.  The layout is the JAX
package's, so one exported state dict feeds both:

* packed (out, in_pad/2) uint8: byte column c holds input column c in its
  low nibble and input column in_pad/2 + c in its high nibble, each as
  q + 8 with q in [-8, 7];
* scales (out, in_pad/64): one absmax/7 scale per 64-column block, the
  union of the paired 32-column strips [b·32, b·32 + 32) and
  [in_pad/2 + b·32, in_pad/2 + b·32 + 32);
* f32 accumulation, the result in x's dtype.

What bounds it on the H100: at the decoder's widths and the serving batch
(256 rows, in 1024, out 3072) about 2.3 MB and 1.6 GFLOP, so operations
(1.6 µs at the dense bf16 peak) over bytes (0.7 µs).  The kernel unpacks
each weight byte once per block into a bf16 tile in shared memory that
all its warps read as tensor-core operands: q − 8 is exact in bf16, so
the products x·q are exact, each strip's partial sums stay in f32 and are
multiplied by their f32 scale before they join the accumulator.  The
dequantised weight is never rounded to bf16.  Its tiling and its split of
the input over blocks are :func:`int4_plan`'s.

The TPU gates (the ``auto`` width choice, ``_pick_bp``'s 128-multiple
rule, the rows < 8 fallback of the quantized Linear) came from TPU
measurements and Mosaic's tiling rules and do not come across: on a CUDA
tensor the wrapper launches the kernel for any rows ≥ 1, out ≥ 1 and
in_pad a multiple of 64, with bf16 x and f32 or bf16 scales, and raises
on anything else.  On a CPU tensor it runs the plain version.

The backward (``Int4Matmul``) is the JAX custom VJP's: ``dx = g ·
dequant(W)`` in f32, no gradient for the packed weight or the scales
(they are frozen; the JAX package computes it outside Pallas too).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from image2text_torch.ops import _build
from image2text_torch.utils.device import sm_count

QBLOCK = 64          # columns per scale (a 32 + 32 strip pair)
STRIP = QBLOCK // 2  # 32

# The kernel's block tiles (rows x outs): one up to DEC_ROWS rows, one
# above; PAIRS strip pairs (64 input columns each) a pipeline stage.  Read
# from ``csrc/int4_matmul.cu``, their one owner.
DEC_ROWS, DEC_OUTS, TRAIN_ROWS, TRAIN_OUTS, STAGE_PAIRS = (
    _build.kernel_constants("int4_matmul", "DEC_BM", "DEC_BN", "TRAIN_BM",
                            "TRAIN_BN", "PAIRS"))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def quantize_pack_int4(w):
    """(out, in) float → (packed uint8 (out, in_pad/2), f32 scales
    (out, in_pad/QBLOCK)), bit-equal to the JAX package's.  Takes and
    returns numpy arrays, or torch tensors on any device."""
    if isinstance(w, np.ndarray):
        packed, scales = quantize_pack_int4(torch.from_numpy(w))
        return packed.numpy(), scales.numpy()
    out_f, in_f = w.shape
    in_p = _round_up(in_f, QBLOCK)
    wp = torch.nn.functional.pad(w.float(), (0, in_p - in_f))
    half = in_p // 2
    lo = wp[:, :half].reshape(out_f, -1, STRIP)
    hi = wp[:, half:].reshape(out_f, -1, STRIP)
    absmax = torch.maximum(lo.abs().amax(-1), hi.abs().amax(-1))
    scales = absmax / 7.0
    s_exp = scales.clamp_min(1e-12).repeat_interleave(STRIP, dim=1)
    q_lo = torch.round(wp[:, :half] / s_exp).to(torch.int16)
    q_hi = torch.round(wp[:, half:] / s_exp).to(torch.int16)
    packed = ((q_lo + 8) | ((q_hi + 8) << 4)).to(torch.uint8)
    return packed, scales


def unpack_int4(packed):
    """(out, in_pad/2) uint8 → (out, in_pad) int32 q values, half-split
    layout (numpy or torch, as given)."""
    if isinstance(packed, np.ndarray):
        return unpack_int4(torch.from_numpy(packed)).numpy()
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8], dim=-1)


def dequantize_int4(packed, scales, dtype=torch.float32):
    """(out, in_pad) float weight: q · scale in f32, then ``dtype`` (numpy
    or torch, as given)."""
    if isinstance(packed, np.ndarray):
        return dequantize_int4(torch.from_numpy(packed),
                               torch.from_numpy(np.asarray(scales)),
                               dtype).numpy()
    s = scales.float().repeat_interleave(STRIP, dim=1)
    return (unpack_int4(packed).float() * torch.cat([s, s], dim=-1)).to(dtype)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantise in f32, an f32 product, x's dtype.
    x (..., in_pad)."""
    w = dequantize_int4(packed, scales, torch.float32)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def _check(x, packed, scales):
    _build.check_operand("int4_matmul", "x", x, torch.bfloat16)
    _build.check_operand("int4_matmul", "packed", packed, torch.uint8)
    if scales.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul kernel: scales must be f32 or bf16, "
                         f"got {scales.dtype}")
    _build.check_operand("int4_matmul", "scales", scales, scales.dtype)
    out_f, halfw = packed.shape
    in_p = x.shape[-1]
    if in_p % QBLOCK or in_p != 2 * halfw or x.numel() == 0:
        raise ValueError(f"int4_matmul kernel: x (..., {in_p}) needs in_pad "
                         f"a multiple of {QBLOCK} equal to twice the packed "
                         f"width {halfw}, and at least one row")
    if tuple(scales.shape) != (out_f, in_p // QBLOCK):
        raise ValueError(f"int4_matmul kernel: scales {tuple(scales.shape)} "
                         f"must be ({out_f}, {in_p // QBLOCK})")


@functools.lru_cache(maxsize=256)
def int4_plan(rows: int, out: int, in_pad: int,
              n_sms: int) -> tuple:
    """(tile rows, tile outs, splits) of one kernel call.  Up to DEC_ROWS
    rows one block tile covers every row (256 x 64), so each weight byte
    is unpacked once for all of them; above, 128 x 128 tiles.  While the
    output tiles number fewer than the SMs, the input's strip pairs are
    split over ``splits`` blocks a tile, as many as fill the SMs in one
    wave (one block an SM: its shared memory), at least one strip pair
    each: split z takes pairs [z·nb/splits, (z+1)·nb/splits), nb =
    in_pad/64, and the splits' f32 partials are summed in z order."""
    bm, bn = ((DEC_ROWS, DEC_OUTS) if rows <= DEC_ROWS
              else (TRAIN_ROWS, TRAIN_OUTS))
    tiles = -(-rows // bm) * -(-out // bn)
    splits = max(1, min(in_pad // QBLOCK, n_sms // tiles))
    return bm, bn, splits


# int4_matmul_launch(x, w, scales, scale_bf16, y, part, rows, out, in_pad,
# bm, bn, splits, stream)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x (..., in_pad) · dequant(packed, scales)ᵀ → (..., out) in x's
    dtype.  The CUDA kernel (:func:`int4_plan`) for CUDA tensors, the
    plain version for CPU tensors; one launch counted per call (a split's
    summing kernel included)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales)
    _check(x, packed, scales)
    out_f, in_p = packed.shape[0], x.shape[-1]
    rows = x.numel() // in_p
    bm, bn, splits = int4_plan(rows, out_f, in_p, sm_count(x.device))
    y = torch.empty(*x.shape[:-1], out_f, dtype=x.dtype, device=x.device)
    part = (torch.empty(splits * rows * out_f, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn = _build.entry_point("int4_matmul", "int4_matmul_launch", _ARGTYPES)
    _build.check(fn(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        int(scales.dtype == torch.bfloat16), y.data_ptr(),
        0 if part is None else part.data_ptr(), rows, out_f, in_p, bm, bn,
        splits, _build.stream(x.device)),
        "int4_matmul")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0


class Int4Matmul(torch.autograd.Function):
    """The kernel forward; ``dx = g · dequant(W)`` in f32 backward, no
    gradient for the packed weight or the scales."""

    @staticmethod
    def forward(ctx, x, packed, scales):
        ctx.save_for_backward(packed, scales)
        return int4_matmul(x.contiguous(), packed, scales)

    @staticmethod
    def backward(ctx, g):
        packed, scales = ctx.saved_tensors
        w = dequantize_int4(packed, scales, torch.float32)
        return torch.matmul(g.float(), w).to(g.dtype), None, None


__all__ = ["Int4Matmul", "QBLOCK", "STRIP", "dequantize_int4", "int4_matmul",
           "int4_matmul_plain", "int4_plan",
           "quantize_pack_int4", "unpack_int4"]
