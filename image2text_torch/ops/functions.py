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

``int8_mm``: the s8 x s8 -> s32 product of the W8A8 serving forms
(``nn/modules.py::int8_dot_rows``), which JAX computes as an XLA dot with
``preferred_element_type=int32`` outside any Pallas kernel.  On the card
it is ``torch._int_mm``, whose shape rules the operands are zero-padded
to here (zero rows and columns add nothing to an integer sum, so the
product stays exact); a CPU tensor takes the plain version, an exact f64
product.

``kernel_scope``: marks the forward of an autograd Function around a
hand-written kernel (flash attention, ``int4_matmul``), so that the remat
policies (``training/remat.py``) keep nothing from inside it.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_SCOPE = threading.local()


@contextlib.contextmanager
def kernel_scope():
    """The body of a kernel Function's forward."""
    _SCOPE.depth = getattr(_SCOPE, "depth", 0) + 1
    try:
        yield
    finally:
        _SCOPE.depth -= 1


def in_kernel_scope() -> bool:
    return getattr(_SCOPE, "depth", 0) > 0


class _NormalizeGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data_axis):
        ctx.data_axis = data_axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float()
        axis = ctx.data_axis
        if axis is None or axis.size == 1:
            norm = torch.linalg.vector_norm(g32)
        else:   # the norm of the global batch's gradient
            import torch.distributed as dist

            sq = g32.square().sum()
            dist.all_reduce(sq, group=axis.group)
            norm = sq.sqrt()
        return (g32 / (norm + 1e-6)).to(g.dtype), None


def normalize_gradients(x: torch.Tensor, data_axis=None) -> torch.Tensor:
    """Identity forward; the backward divides the gradient by its norm
    over the whole batch: under a mesh (``data_axis``, this rank's rows
    of the global batch) the norm of every data rank's rows, as the JAX
    step's global array has it."""
    return _NormalizeGradients.apply(x, data_axis)


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


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 · bᵀ, b (n, k) int8 → int32 (m, n): f64 products and
    sums, exact while |sum| < 2^53 (127² · k for any k a model has)."""
    return torch.matmul(a.double(), b.double().t()).to(torch.int32)


def int8_mm_shapes(m: int, k: int, n: int):
    """The (rows, inner, outer) ``torch._int_mm`` takes on the card for an
    (m, k) · (k, n) product: more than 16 rows, the inner and outer sizes
    multiples of 8 and at least 16.  Rows are padded to a multiple of 8
    as well."""
    return max(_ceil(m, 8), 24), max(_ceil(k, 8), 16), max(_ceil(n, 8), 16)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(t.shape) == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_mm_weight(b: torch.Tensor) -> torch.Tensor:
    """The weight operand b (n, k) of :func:`int8_mm` zero-padded to the
    card's shapes, made once and passed in its place (a serving form keeps
    it: ``nn/modules.py::_Int8Form.int8_operand``); b itself where no
    padding is needed."""
    _, kp, np_ = int8_mm_shapes(1, b.shape[1], b.shape[0])
    return _pad_to(b, np_, kp).contiguous()


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 · bᵀ, b (n, k) int8 → int32 (m, n), exact.  On a CUDA
    tensor ``torch._int_mm`` on the operands zero-padded to
    :func:`int8_mm_shapes` (the flagship's vocabulary of 50,258 and a
    decode row count of 1 need it), the result sliced back; b may come
    padded already (:func:`int8_mm_weight`, its zero columns past k
    included), and then only ``a`` is padded.  On a CPU tensor
    :func:`int8_mm_plain`."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("int8_mm takes int8 operands")
    if a.device.type == "cpu":
        return int8_mm_plain(a, b)
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"int8_mm: the operands must be CUDA tensors, got "
                         f"{a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = int8_mm_shapes(m, max(k, b.shape[1]), n)
    a, b = _pad_to(a, mp, kp), int8_mm_weight(b)
    int8_mm.launches += 1
    out = torch._int_mm(a.contiguous(), b.t())
    return out[:m, :n]


int8_mm.launches = 0
