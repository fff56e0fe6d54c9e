"""Custom-gradient ops (counterpart of ``image2text_tpu/ops/functions.py``).

``normalize_gradients``: identity forward; the backward rescales the
incoming gradient by its global L2 norm (+ 1e-6).  Applied at every
TransformerBlock output, where it is the identity at eval time.

``dot_f32``: ``a·bᵀ`` as the JAX package's dots with
``preferred_element_type=f32`` compute it: operands in ``a``'s dtype, f32
sums, an f32 result, and no f32 copy of either operand in the forward (the
tied lm_head's (vocab, d) weight, the eval attention's K/V).  Its backward
is JAX's: the f32 cotangent against the other operand in f32, rounded to
the operand's dtype.
"""
from __future__ import annotations

import torch


class _NormalizeGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float()
        return (g32 / (torch.linalg.vector_norm(g32) + 1e-6)).to(g.dtype)


def normalize_gradients(x: torch.Tensor) -> torch.Tensor:
    return _NormalizeGradients.apply(x)


def _abt_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., m, k) · bᵀ, b (n, k) or (..., n, k) with a's batch dims."""
    if not a.is_cuda:   # the CPU has no mm.dtype; bf16 values are exact in f32
        return torch.matmul(a.float(), b.float().transpose(-1, -2))
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-2]
    if b.dim() == 2:    # aten::mm.dtype: low-precision products, f32 sums
        a2 = a.reshape(-1, k)
        if n % 2:
            # f32 rows of odd length (GPT-2's vocab, 50259) leave cuBLAS
            # its unaligned kernels: the transposed product and a copy back
            # are faster there, and slower for an even width (chip_smoke.py
            # [lm_head] times both; PERF.md §6)
            out = torch.mm(b, a2.t(), out_dtype=torch.float32).t()
            out = out.contiguous()
        else:
            out = torch.mm(a2, b.t(), out_dtype=torch.float32)
    else:               # aten::bmm.dtype
        out = torch.bmm(a.reshape(-1, m, k),
                        b.reshape(-1, n, k).transpose(1, 2),
                        out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], n)


class _DotF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _abt_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                db = torch.mm(g.reshape(-1, g.shape[-1]).t(),
                              a.reshape(-1, a.shape[-1]).float())
            else:
                db = torch.matmul(g.transpose(-1, -2), a.float())
            db = db.to(b.dtype)
        return da, db


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.transpose(-1, -2)`` in f32: ``b`` cast to ``a``'s dtype (as
    JAX's ``wte.astype(x.dtype)``), low-precision products summed in f32;
    an f32 ``a`` multiplies in f32."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.matmul(a, b.transpose(-1, -2))
    return _DotF32.apply(a, b)
