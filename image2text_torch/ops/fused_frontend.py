"""Eval encoder front: the CUDA kernels of ``csrc/fused_frontend.cu`` and
their plain version.

Replaces ``image2text_tpu/ops/fused_frontend.py::_frontend_kernel`` (the
Pallas kernel behind ``fused_frontend_compatible``).  From the (b, t, din)
raw-reshaped patch stream it builds the (b, n_cls + t, d) block-loop
input: the projector (a product rounded to the storage dtype, then its
bias), LayerNormND over each image's whole (t, d) slab, the positional
table added in the storage dtype, LayerNormND again, and the CLS rows in
front.

The JAX package launches its kernel only under ``GRAFT_FUSED_FRONTEND=1``:
Mosaic took minutes to compile it, which its measured gain on the TPU could
not pay for.  nvcc builds this one in seconds, so every eval encoder
forward on the card launches it.  What bounds it on the H100: operations
(the projector GEMM); see ``csrc/fused_frontend.cu`` for the design.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from image2text_torch.nn.modules import layer_norm
from image2text_torch.ops import _build


class FrontendWeights(NamedTuple):
    """The front's operands: the projector transposed to (din, d) and its
    bias in the compute dtype, LayerNormND's (t, d) weight and bias as
    stored, the (t, d) positional table and the (n_cls, d) CLS rows in the
    compute dtype.  A missing bias is None."""

    w_p: torch.Tensor
    b_p: Optional[torch.Tensor]
    ln_w: torch.Tensor
    ln_b: Optional[torch.Tensor]
    wpe: torch.Tensor
    cls: torch.Tensor


def fused_frontend_plain(x: torch.Tensor, w: FrontendWeights) -> torch.Tensor:
    """Plain PyTorch version: the encoder's module chain
    ``ln_input(projector(x))``, ``+ wpe``, ``ln_input`` again, CLS in
    front."""
    z = torch.matmul(x, w.w_p)
    if w.b_p is not None:
        z = z + w.b_p
    y = layer_norm(z, w.ln_w, w.ln_b, n_dims=2) + w.wpe
    cls = w.cls.expand(x.shape[0], *w.cls.shape)
    return torch.cat([cls, layer_norm(y, w.ln_w, w.ln_b, n_dims=2)], dim=1)


def fused_frontend(x: torch.Tensor, w: FrontendWeights) -> torch.Tensor:
    """The (b, n_cls + t, d) block-loop input from the (b, t, din) patch
    stream ``x``: the CUDA kernels for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.device.type == "cpu":
        return fused_frontend_plain(x, w)
    for name, t in [("x", x)] + list(zip(w._fields, w)):
        _build.check_operand("fused_frontend", name, t, torch.bfloat16)
    b, t, din = x.shape
    d = w.w_p.shape[1]
    n_cls = w.cls.shape[0]
    if (din % 32 or d % 16 or w.w_p.shape != (din, d)
            or w.ln_w.shape != (t, d) or w.wpe.shape != (t, d)
            or w.cls.shape != (n_cls, d)
            or (w.ln_b is not None and w.ln_b.shape != (t, d))
            or (w.b_p is not None and w.b_p.shape != (d,))):
        raise ValueError(f"fused_frontend kernel: unsupported shape b={b} "
                         f"t={t} din={din} d={d} n_cls={n_cls} (needs din "
                         "% 32 == 0, d % 16 == 0 and (t, d) tables)")
    out = torch.empty(b, n_cls + t, d, dtype=x.dtype, device=x.device)
    lib = _build.load("fused_frontend")
    fn = lib.frontend_launch
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(P(x), P(w.w_p), P(w.b_p), P(w.ln_w), P(w.ln_b), P(w.wpe),
             P(w.cls), P(out), ctypes.c_int(b), ctypes.c_int(t),
             ctypes.c_int(din), ctypes.c_int(d), ctypes.c_int(n_cls),
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "frontend_launch")
    fused_frontend.launches += 1
    return out


fused_frontend.launches = 0
