"""Eval MoE FFN: the CUDA kernel ``csrc/fused_moe.cu`` and its plain version.

Replaces ``image2text_tpu/ops/fused_moe.py::_ffn_kernel`` (the Pallas
kernel behind ``fused_moe_mlp_compatible``).  The FFN is two low-rank
MoELinears around a GELU.  For each MoELinear: gate MLP
``gelu(x·g0w + g0b)·g1w + g1b``, ``softmax(lg / sqrt(fin))`` in f32, the
top-k gate values kept in place (unnormalised, lowest-index ties),
``z = gelu(x·l1w + l1b)`` over the stacked experts, and
``y = (z ∘ expand(c))·l2w + c·l2b``.  Every product accumulates in f32
and is rounded to bf16 at its output; bias adds run in bf16.

On the TPU the gate refused fewer than 4096 rows, so decode rows ran
through XLA; here the kernel serves every eval MoE FFN on the card, at
any row count (the ragged last tile is masked).

What bounds it on the H100: bytes at decode (256 rows at hidden 4096 read
about 1.7 MB of weights and 1 MB of activations, under a microsecond at
3.35 TB/s, so filling the card and the launches decide); operations at
encoder row counts (about 1 MFLOP a row at hidden 2048), reached only if
each weight byte a block reads from L2 serves many rows.  The kernel keeps
the hidden-wide activation out of device memory: a warp owns 16 rows and
runs both MoELinears with mma.sync bf16 products (f32 accumulators), the
gate, top-k and combine in its registers, the weights staged once per
block in shared memory (cp.async, double-buffered) for all its warps, the
hidden dimension streamed in 64-wide chunks, each chunk of
``gelu(hw·l2w + c·l2b)`` feeding straight into the second MoELinear's
narrow accumulators (gate 32 + experts 64 wide).  Two regimes, picked from
the row count (:func:`moe_regime`, :func:`moe_slices`): many rows run
whole in blocks of 64 rows; few rows split the hidden dimension over
about one block an SM, each writing its part of the second MoELinear's
f32 accumulators to a scratch buffer that a second kernel sums in slice
order before the gate, top-k, combine and output.  The switch point
``FEW_ROWS`` is measured on the card (``chip_smoke.py``'s
``phase_moe_regimes``; the times are in ``csrc/fused_moe.cu``).  The
optional LayerNorm prologue and residual epilogue let the encoder blocks
reuse it for ``x1 + ffn(ln_2(x1))``.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from image2text_torch.nn.modules import gelu_tanh, layer_norm
from image2text_torch.ops import _build
from image2text_torch.utils.device import sm_count


class MoELinearWeights(NamedTuple):
    """One MoELinear in the kernel's layouts (all in the compute dtype).

    wa (fin, g + e·r) = [g0w | l1w]   ba (g + e·r) = [g0b | l1b]
    g1w (g, e)  g1b (e)               l2w (e·r, fout)  l2b (e, fout)
    Missing gate biases are exact zeros (an additive identity)."""

    wa: torch.Tensor
    ba: torch.Tensor
    g1w: torch.Tensor
    g1b: torch.Tensor
    l2w: torch.Tensor
    l2b: torch.Tensor
    g: int
    e: int
    r: int
    k: int


def pack_moe_linear(l1_weight, l1_bias, l2_weight, l2_bias, g0_weight,
                    g0_bias, g1_weight, g1_bias, top_k: int,
                    dtype) -> MoELinearWeights:
    """Kernel layouts from MoELinear's stacked parameters
    (l1 (e, r, fin), l2 (e, fout, r)) and its gate MLP's two Linears."""
    e, r, fin = l1_weight.shape
    fout = l2_weight.shape[1]
    g = g0_weight.shape[0]

    def bias(b, n):
        return (b if b is not None
                else torch.zeros(n, device=l1_weight.device)).to(dtype)

    wa = torch.cat([g0_weight.t(), l1_weight.reshape(e * r, fin).t()], 1)
    return MoELinearWeights(
        wa=wa.to(dtype).contiguous(),
        ba=torch.cat([bias(g0_bias, g).float(),
                      l1_bias.reshape(e * r).float()]).to(dtype).contiguous(),
        g1w=g1_weight.t().to(dtype).contiguous(),
        g1b=bias(g1_bias, e).contiguous(),
        l2w=l2_weight.permute(0, 2, 1).reshape(e * r, fout).to(dtype)
        .contiguous(),
        l2b=l2_bias.to(dtype).contiguous(),
        g=g, e=e, r=r, k=top_k)


def topk_mask(gv: torch.Tensor, k: int) -> torch.Tensor:
    """Which experts survive top-k: expert e does iff
    |{j : gv_j > gv_e or (gv_j == gv_e and j < e)}| < k (lowest-index
    ties, as ``jax.lax.top_k``)."""
    e = gv.shape[-1]
    col = gv[..., :, None]                     # gv_e
    row = gv[..., None, :]                     # gv_j
    lower = torch.ones(e, e, dtype=torch.bool, device=gv.device).tril(-1)
    beats = (row > col) | ((row == col) & lower)   # [e, j]: j beats e
    return beats.sum(dim=-1) < k


def topk_combine(gv: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k gate values in place, zeros elsewhere (:func:`topk_mask`)."""
    return torch.where(topk_mask(gv, k), gv, torch.zeros_like(gv))


def pack_mask(keep: torch.Tensor) -> torch.Tensor:
    """(..., e) bool → (...) uint8 bit mask, expert j in bit j."""
    bits = keep.to(torch.uint8) << torch.arange(
        keep.shape[-1], device=keep.device, dtype=torch.uint8)
    return bits.sum(dim=-1, dtype=torch.uint8)


def unpack_mask(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(...) uint8 bit mask → (..., e) bool."""
    shifts = torch.arange(e, device=bits.device, dtype=torch.uint8)
    return ((bits[..., None] >> shifts) & 1).bool()


def moe_linear_plain(x: torch.Tensor, w: MoELinearWeights,
                     return_gates: bool = False,
                     force_mask: Optional[torch.Tensor] = None):
    """One MoELinear, step for step as the JAX module and kernel.

    ``force_mask`` ((...) uint8 bit masks) replaces the top-k choice with
    the given experts, keeping their gate values (to hold a kernel's
    output against this version on the kernel's own routes).  With
    ``return_gates`` it returns ``(y, mask, gv)``: the chosen experts'
    bit masks and the f32 gate values."""
    fin = x.shape[-1]
    pa = torch.matmul(x, w.wa)
    a = gelu_tanh(pa[..., :w.g] + w.ba[:w.g])
    lg = torch.matmul(a, w.g1w) + w.g1b
    gv = torch.softmax(lg.float() / math.sqrt(fin), dim=-1)
    keep = (topk_mask(gv, w.k) if force_mask is None
            else unpack_mask(force_mask, w.e))
    combine = torch.where(keep, gv, torch.zeros_like(gv))
    z = gelu_tanh(pa[..., w.g:] + w.ba[w.g:])
    c = combine.to(x.dtype)
    hw = z * c.repeat_interleave(w.r, dim=-1)
    y = torch.matmul(hw, w.l2w) + torch.matmul(c, w.l2b)
    return (y, pack_mask(keep), gv) if return_gates else y


def moe_ffn_plain(x: torch.Tensor, fc: MoELinearWeights,
                  proj: MoELinearWeights, ln_w=None, ln_b=None,
                  residual: Optional[torch.Tensor] = None,
                  routes: Optional[torch.Tensor] = None,
                  force_routes: Optional[torch.Tensor] = None,
                  gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [LN →] MoELinear → GELU →
    MoELinear [→ + residual].  Per row and MoELinear: ``routes`` (n, 2)
    uint8, when given, receives the selected-expert bit masks;
    ``force_routes`` (n, 2) uint8 imposes them instead of top-k; ``gates``
    (n, 2, e) f32 receives the gate values."""
    if ln_w is not None:
        x = layer_norm(x, ln_w, ln_b)
    f1 = f2 = None
    if force_routes is not None:
        f1, f2 = force_routes.reshape(*x.shape[:-1], 2).unbind(-1)
    h, m1, g1 = moe_linear_plain(x, fc, True, f1)
    y, m2, g2 = moe_linear_plain(gelu_tanh(h), proj, True, f2)
    if routes is not None:
        routes.copy_(torch.stack([m1, m2], -1).reshape(-1, 2))
    if gates is not None:
        gates.copy_(torch.stack([g1, g2], -2).reshape(-1, 2, fc.e))
    return y if residual is None else residual + y


# Rows at or below which the kernel takes its few-rows regime (the hidden
# dimension split over blocks).  Measured on the card: see the module note.
FEW_ROWS = 4096
ROWS_PER_BLOCK = 64   # 4 warps of 16 rows


def moe_regime(n: int) -> str:
    """The kernel's regime at ``n`` rows: "few" or "many"."""
    return "few" if n <= FEW_ROWS else "many"


def moe_slices(n: int, hidden: int, n_sms: int) -> int:
    """Hidden slices the kernel splits ``n`` rows' FFN into (1: the
    many-rows kernel, no split): about one block an SM of the card's
    ``n_sms`` (``utils/device.py::sm_count``), at least 4 slices,
    each slice at least one 64-wide hidden chunk.  The f32 sum of the second MoELinear's
    accumulators runs slice by slice, so two row counts give bit-equal
    rows only where they give the same count."""
    if moe_regime(n) == "many":
        return 1
    chunks = hidden // 64
    per = -(-chunks // max(4, n_sms // -(-n // ROWS_PER_BLOCK)))
    return -(-chunks // per)


def _moe_shape_error(fin: int, hidden: int, g: int, e: int, r: int,
                     slices: int) -> Optional[str]:
    """Why the kernel refuses these widths, or None."""
    if (fin % 64 or hidden % 64 or g + e * r != 96 or e * r != 64 or e > 8
            or slices < 1):
        return (f"unsupported shape fin={fin} hidden={hidden} g={g} e={e} "
                f"r={r} slices={slices} (needs fin, hidden % 64, g + e*r == "
                "96, e*r == 64, e <= 8, at least one slice)")
    return None


def launch_moe_ffn(x2d: torch.Tensor, fc: MoELinearWeights,
                   proj: MoELinearWeights, out: torch.Tensor,
                   ln_w=None, ln_b=None, residual=None,
                   rows_per_img: Optional[int] = None,
                   out_rows_per_img: Optional[int] = None,
                   routes: Optional[torch.Tensor] = None,
                   defines: Tuple[str, ...] = (),
                   slices: Optional[int] = None) -> None:
    """Launch the kernel on (n, fin) rows.  Output row m goes to
    ``out`` row (m // rows_per_img) * out_rows_per_img + m % rows_per_img
    (identity by default).  ``defines`` picks a probe build of the kernel
    (``image2text_torch/probes/``; none on every serving path); ``slices``
    overrides :func:`moe_slices` (to time both regimes at one row
    count).  Counts
    nothing: the counting wrappers are :func:`moe_ffn` and the blocks'."""
    n, fin = x2d.shape
    hidden = fc.l2w.shape[1]
    for name, t in [("x", x2d), ("out", out), ("ln_w", ln_w), ("ln_b", ln_b),
                    ("residual", residual)] + [
                        (f"fc.{f}", getattr(fc, f)) for f in fc._fields[:6]] + [
                        (f"proj.{f}", getattr(proj, f))
                        for f in proj._fields[:6]]:
        _build.check_operand("moe_ffn", name, t, torch.bfloat16)
    slices = (moe_slices(n, hidden, sm_count(x2d.device)) if slices is None
              else slices)
    err = _moe_shape_error(fin, hidden, fc.g, fc.e, fc.r, slices)
    if err is None and (proj.l2w.shape[1] != fin or (
            proj.g, proj.e, proj.r, proj.k) != (fc.g, fc.e, fc.r, fc.k)):
        err = "the FFN must be square (fin → hidden → fin, one gate shape)"
    if err is not None:
        raise ValueError(f"moe_ffn kernel: {err}")
    if residual is not None and residual.shape != x2d.shape:
        raise ValueError("moe_ffn kernel: residual must match x")
    if routes is not None and (routes.dtype != torch.uint8
                               or routes.shape != (n, 2)):
        raise ValueError("moe_ffn kernel: routes must be (n, 2) uint8")
    rpi = rows_per_img or n
    orpi = out_rows_per_img or rpi
    if out.numel() < ((n - 1) // rpi * orpi + (n - 1) % rpi + 1) * fin:
        raise ValueError("moe_ffn kernel: output too small for the row map")
    part = (None if slices == 1 else
            torch.empty(slices, n, 96, dtype=torch.float32, device=x2d.device))
    lib = _build.load("fused_moe", defines)
    fn = lib.moe_ffn_launch
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(P(x2d), P(out), ctypes.c_int(n), ctypes.c_int(fin),
             ctypes.c_int(hidden), P(ln_w), P(ln_b), P(residual),
             ctypes.c_int(rpi), ctypes.c_int(orpi),
             P(fc.wa), P(fc.ba), P(fc.g1w), P(fc.g1b), P(fc.l2w), P(fc.l2b),
             P(proj.wa), P(proj.ba), P(proj.g1w), P(proj.g1b), P(proj.l2w),
             P(proj.l2b), ctypes.c_int(fc.g), ctypes.c_int(fc.e),
             ctypes.c_int(fc.r), ctypes.c_int(fc.k), P(routes),
             ctypes.c_int(ROWS_PER_BLOCK // 16), ctypes.c_int(slices),
             ctypes.c_int(max(1, fin // 128)), P(part),
             ctypes.c_void_p(torch.cuda.current_stream(x2d.device).cuda_stream))
    _build.check(err, "moe_ffn_launch")


def moe_ffn(x: torch.Tensor, fc: MoELinearWeights, proj: MoELinearWeights,
            ln_w=None, ln_b=None, residual: Optional[torch.Tensor] = None,
            routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eval MoE FFN of ``x`` (..., fin): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return moe_ffn_plain(x, fc, proj, ln_w, ln_b, residual, routes)
    _build.check_operand("moe_ffn", "x", x, torch.bfloat16)
    x2d = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(x2d)
    launch_moe_ffn(x2d, fc, proj, out, ln_w, ln_b,
                   None if residual is None else residual.reshape(x2d.shape),
                   routes=routes)
    moe_ffn.launches += 1
    return out.reshape(x.shape)


moe_ffn.launches = 0
