"""Primitive modules of the port (counterparts of ``image2text_tpu/nn/modules.py``).

Same parameter names and torch layouts as the JAX package, and the same
dtype chain: a product accumulates in f32 and is rounded once to the
activation (storage) dtype, a bias is added in that dtype afterwards, and
normalisation statistics run in f32.  ``F.linear``'s fused bias would add
the bias before the rounding, so products and bias adds stay separate.
Training dropout takes a ``Ctx`` (``nn/core.py``).

The int8 serving forms (JAX ``nn/modules.py:166-214``): a ``Linear`` or
``Embedding`` turned by :meth:`Linear.to_int8` (through
``models/quantization.py::int8_serving_params``) holds ``qweight`` (int8
rows), ``qscale`` (f32, one a row) and ``qdtype`` (a zero-length tensor of
the original storage dtype) as buffers instead of its ``weight``.  A Linear
then runs W8A8 (:func:`int8_dot_rows`), an Embedding dequantises only the
rows it gathers (:func:`embedding_rows`).  :class:`QuantizedKV` is the int8
cross-attention memory of ``generate(cross_kv_quant='int8')``.

Under a mesh (``parallel/sharding_rules.py::place_params``) a ``Linear``
may hold a column shard (``tp = ('col', axis, sections)``: its input
enters through ``collectives.copy_to``) or a row shard (``tp = ('row',
axis, sections)``: a whole input is first cut to its slice of each of
``sections`` sections, the partial products are summed over the axis and
the bias added once; :func:`tp_enter`, :func:`tp_exit`); the cross-attention's
packed ``in_proj`` may hold its heads' rows of q, k and v.  A module's
record ``_tp_place`` ({name: (dim, sections)}) lets :func:`whole_param`
gather a split tensor for the eval kernels, which read whole operands.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      normal_init, ones_init,
                                      torch_linear_weight_init,
                                      xavier_uniform_init, zeros_init)
from image2text_torch.ops.functions import dot_f32, int8_mm, int8_mm_weight
from image2text_torch.parallel.collectives import (copy_to, gather_whole,
                                                   reduce_from, scatter_to)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], n_dims: int = 1,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``n_dims`` dims: f32 statistics
    (two-pass variance), f32 scale and shift, result in ``x``'s dtype."""
    x32 = x.float()
    dims = tuple(range(x.dim() - n_dims, x.dim()))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def divide(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as a true division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's f32 reciprocal,
    which can land one ulp from the quotient that the CPU and JAX compute;
    a divisor held as a 0-d tensor on ``t``'s device (made once per
    device, dtype and value) is divided elementwise."""
    key = (t.device, t.dtype, d)
    c = _CONSTANTS.get(key)
    if c is None:
        c = _CONSTANTS[key] = torch.full((), d, dtype=t.dtype,
                                         device=t.device)
    return t / c


def quantize_rows_int8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row of the last axis: (..., s, d) → (int8
    values, f32 (..., s) scales) with t ≈ values · scales[..., None]; the
    scale is max |t| / 127 (a true division, :func:`divide`) floored at
    1e-12, the values rounded half to even and clipped to ±127, all in
    f32 as the JAX function, bit for bit on the card as on the CPU."""
    t32 = t.float()
    scale = divide(t32.abs().amax(dim=-1), 127.0).clamp_min(1e-12)
    q = torch.round(t32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


class QuantizedKV(NamedTuple):
    """Per-position symmetric-int8 cross-attention K/V: ``k_q``/``v_q``
    int8 (..., h, s, d), scales f32 (..., h, s)."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor

    @classmethod
    def of(cls, k: torch.Tensor, v: torch.Tensor) -> "QuantizedKV":
        return cls(*quantize_rows_int8(k), *quantize_rows_int8(v))


def quantize_kv(kv, quant: Optional[str]):
    """Cross K/V ``(k, v)`` in the form the cross-KV quant mode ``quant``
    stores: as they are for None, a :class:`QuantizedKV` for 'int8'.  The
    one place where the mode is read."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown cross-KV quant mode {quant!r}")
    return kv if quant is None else QuantizedKV.of(*kv)


def embedding_rows(qweight: torch.Tensor, qscale: torch.Tensor,
                   qdtype: torch.dtype, idx) -> torch.Tensor:
    """Rows ``idx`` (an index tensor or a slice) of an int8 table,
    dequantised in f32 and returned in the recorded storage dtype."""
    rows = qweight[idx].float() * qscale[idx][..., None]
    return rows.to(qdtype)


def int8_dot_rows(x: torch.Tensor, qw: torch.Tensor,
                  qs: torch.Tensor) -> torch.Tensor:
    """W8A8 product: x (..., in) float against int8 rows qw (out, in) with
    f32 scales qs (out,).  x is quantized per row, the s8 x s8 → s32
    product is exact (``ops/functions.py::int8_mm``), then both row scales
    apply in f32 as ``y · xs · qs``.  ``qw`` may carry zero rows past
    ``out`` (the padded operand of :meth:`_Int8Form.int8_operand`); they
    are cut.  Returns f32 (..., out)."""
    xq, xs = quantize_rows_int8(x)
    y = int8_mm(xq.reshape(-1, xq.shape[-1]), qw)[:, :qs.shape[0]]
    y = y.reshape(*x.shape[:-1], qs.shape[0])
    return y.float() * xs[..., None] * qs


class _Int8Form:
    """The int8 serving form of a module with a 2-D ``weight``."""

    @property
    def is_int8(self) -> bool:
        return "qweight" in self._buffers

    @property
    def stored_dtype(self) -> torch.dtype:
        """The dtype of the (float or recorded) weight."""
        return self.qdtype.dtype if self.is_int8 else self.weight.dtype

    @property
    def stored_shape(self) -> Tuple[int, int]:
        return tuple((self.qweight if self.is_int8 else self.weight).shape)

    @torch.no_grad()
    def to_int8(self) -> None:
        """Replace ``weight`` by ``qweight``/``qscale``/``qdtype`` (in
        place), recording the weight's dtype."""
        w = self.weight.detach()
        q, s = quantize_rows_int8(w)
        del self.weight
        getattr(self, "_init_fns", {}).pop("weight", None)
        self.register_buffer("qweight", q)
        self.register_buffer("qscale", s)
        self.register_buffer("qdtype", torch.zeros(0, dtype=w.dtype,
                                                   device=w.device))

    def int8_operand(self) -> torch.Tensor:
        """``qweight`` as :func:`int8_mm` takes it: on the card zero-padded
        to its shapes once (``ops/functions.py::int8_mm_weight``) and kept
        until ``qweight`` is replaced or written, on the CPU as it is."""
        q = self.qweight
        if q.device.type == "cpu":
            self._padded = None
            return q
        key = (q._version, q.data_ptr())
        held = getattr(self, "_padded", None)
        if held is None or held[0] is not q or held[1] != key:
            self._padded = (q, key, int8_mm_weight(q))
        return self._padded[2]


def whole_param(module: nn.Module, name: str):
    """``module.<name>`` whole: gathered over the model axis when the
    placement split it (no gradient: for the eval kernels)."""
    t = getattr(module, name)
    place = getattr(module, "_tp_place", {}).get(name)
    if place is None or t is None:
        return t
    return gather_whole(t, module._tp_axis, *place)


def tp_enter(lin: nn.Module, x: torch.Tensor, width: int) -> torch.Tensor:
    """A split Linear's input as its shard reads it: the entry of a
    column split (``copy_to``), or a whole input cut to a row split's
    sections (``width``: the shard's input width)."""
    tp = lin.tp
    if tp is None:
        return x
    if tp[0] == "col":
        return copy_to(x, tp[1])
    if x.shape[-1] != width:
        return scatter_to(x, tp[1], -1, tp[2])
    return x


def tp_exit(lin: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """A row split's partial products summed over the model group."""
    tp = lin.tp
    return y if tp is None or tp[0] != "row" else reduce_from(y, tp[1])


def model_axis(module: nn.Module):
    """The model Axis ``module``'s parameters are split over (None when
    the placement split none of them)."""
    for m in module.modules():
        axis = getattr(m, "_tp_axis", None)
        if axis is not None and axis.size > 1:
            return axis
    return None


def local_heads(lin: nn.Module, n: int) -> int:
    """This rank's share of the ``n`` heads a Linear projects (all of
    them unless the placement split its out dim)."""
    tp = getattr(lin, "tp", None)
    return n // tp[1].size if tp is not None and tp[0] == "col" else n


def tp_heads(module: nn.Module, local: int, total: int) -> Tuple[int, ...]:
    """(first, total) heads of this rank when ``local`` of ``total`` heads
    are here (the model axis's split of ``module``; (0, 0) whole).  Heads
    split in two halves (the column split before an int4 row split) give
    (first, total, first of the second half): a dropout over such heads
    has no contiguous planes (``nn/core.py::dropout`` and
    ``ops/flash_attention.py::planes_of`` raise for one)."""
    axis = getattr(module, "_tp_axis", None)
    if axis is None or local == total:
        return (0, 0)
    if getattr(module, "_tp_halves", False):
        half = local // 2
        return (axis.rank * half, total, total // 2 + axis.rank * half)
    return (axis.rank * local, total)


class Linear(_Int8Form, nn.Module):
    """y = x @ W.T + b with torch layout W:(out, in); f32 accumulation,
    output and bias add in ``x``'s dtype.  The int8 form computes
    :func:`int8_dot_rows`, rounded to ``x``'s dtype."""

    tp = None   # ('col' | 'row', Axis, sections) once the placement split it

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        init = torch_linear_weight_init(in_features)
        new_param(self, "weight", (out_features, in_features), init, device)
        if bias:
            new_param(self, "bias", (out_features,), init, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        """``ctx`` is taken and unused, as the JAX Linear's: the callers
        that pass one reach a LoRA adapter's dropout through it."""
        x = tp_enter(self, x, self.stored_shape[1])
        if self.is_int8:
            y = int8_dot_rows(x, self.int8_operand(),
                              self.qscale).to(x.dtype)
        else:
            y = torch.matmul(x, self.weight.to(x.dtype).t())
        y = tp_exit(self, y)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Embedding(_Int8Form, nn.Module):
    """Token embedding, torch layout (num_embeddings, dim), init
    N(0, init_std²).  The int8 form dequantises the gathered rows only."""

    def __init__(self, num_embeddings: int, dim: int, device=None,
                 init_std: float = 1.0):
        super().__init__()
        new_param(self, "weight", (num_embeddings, dim),
                  normal_init(std=init_std), device)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        if self.is_int8:
            return embedding_rows(self.qweight, self.qscale,
                                  self.qdtype.dtype, idx)
        return F.embedding(idx, self.weight)

    def rows(self, start: int, stop: int) -> torch.Tensor:
        """Rows start..stop-1 (the positional tables' contiguous slice)."""
        if self.is_int8:
            return embedding_rows(self.qweight, self.qscale,
                                  self.qdtype.dtype, slice(start, stop))
        return self.weight[start:stop]

    def lm_head(self, x: torch.Tensor) -> torch.Tensor:
        """x · tableᵀ in f32, the tied lm_head: ``dot_f32`` on the float
        table, :func:`int8_dot_rows` on the int8 form."""
        if self.is_int8:
            return int8_dot_rows(x, self.int8_operand(), self.qscale)
        return dot_f32(x, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with optional bias."""

    def __init__(self, ndim: int, bias: bool, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        new_param(self, "weight", (ndim,), ones_init(), device)
        if bias:
            new_param(self, "bias", (ndim,), zeros_init(), device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, 1, self.eps)


class LayerNormND(nn.Module):
    """LayerNorm over the trailing ``len(shape)`` dims: the statistics run
    over the whole (tokens, features) slab, not per row."""

    def __init__(self, shape: Tuple[int, ...], bias: bool, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.shape = tuple(shape)
        self.eps = eps
        new_param(self, "weight", self.shape, ones_init(), device)
        if bias:
            new_param(self, "bias", self.shape, zeros_init(), device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, len(self.shape), self.eps)


class Conv2d(nn.Module):
    """NCHW conv, torch layout W:(out, in, kh, kw), XLA 'SAME' padding: an
    even kernel pads (k - 1) // 2 before and the rest after (6x6: 2 and 3),
    which torch's own ``padding='same'`` does the other way round."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], bias: bool = True,
                 device=None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        fan_in = in_channels * kh * kw
        init = torch_linear_weight_init(fan_in)
        new_param(self, "weight", (out_channels, in_channels, kh, kw), init,
                  device)
        if bias:
            new_param(self, "bias", (out_channels,), init, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        y = F.conv2d(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None, :, None, None]
        return y


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible attention (batch_first),
    used for the decoder's cross-attention: packed ``in_proj`` for q/k/v
    plus ``out_proj``.  Scores stay in f32 (no storage-dtype rounding, as
    in the JAX module) and probabilities drop to the storage dtype before
    the V product; in training they are dropped (plain PyTorch, as the JAX
    module leaves them to XLA)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        new_param(self, "in_proj_weight", (3 * embed_dim, embed_dim),
                  xavier_uniform_init(), device)
        new_param(self, "in_proj_bias", (3 * embed_dim,), zeros_init(), device)
        self.out_proj = Linear(embed_dim, embed_dim, bias=True, device=device)
        # torch._reset_parameters zeroes the out_proj bias
        self.out_proj._init_fns["bias"] = zeros_init()

    tp = None   # the model Axis once the placement split its heads

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], -1,
                         self.head_dim).transpose(-3, -2)

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """Section ``part`` of the packed projection (this rank's heads'
        rows of it under a model split)."""
        e = self.in_proj_weight.shape[0] // 3
        w = self.in_proj_weight[part * e:(part + 1) * e].to(x.dtype)
        b = self.in_proj_bias[part * e:(part + 1) * e].to(x.dtype)
        if self.tp is not None:
            x = copy_to(x, self.tp)
        return torch.matmul(x, w.t()) + b

    def project_kv(self, key: torch.Tensor, value: torch.Tensor,
                   quant: Optional[str] = None):
        """Split-head K/V of a fixed memory (decode-time cross-attention:
        computed once per sequence instead of once per token);
        ``quant='int8'`` gives them as a :class:`QuantizedKV`."""
        k = self._split_heads(self._proj(key, 1))
        v = self._split_heads(self._proj(value, 2))
        return quantize_kv((k, v), quant)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                precomputed_kv=None, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        q = self._split_heads(self._proj(query, 0))
        if isinstance(precomputed_kv, QuantizedKV):
            return self.out_proj(self._int8_kv_attention(q, precomputed_kv,
                                                         query, ctx))
        if precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            k, v = self.project_kv(key, value)
        scores = divide(dot_f32(q, k), math.sqrt(self.head_dim))
        probs = torch.softmax(scores, dim=-1).to(query.dtype)
        hctx = ctx.with_heads(*tp_heads(self, q.shape[-3], self.num_heads))
        probs, _ = dropout(probs, self.dropout_rate, hctx,
                           head_dim=probs.dim() - 3)
        y = torch.matmul(probs, v)
        y = y.transpose(-3, -2).reshape(*query.shape[:-1], -1)
        return self.out_proj(y)

    def _int8_kv_attention(self, q, kv: QuantizedKV, query, ctx: Ctx):
        """The mixed-precision read of an int8 memory (JAX
        ``nn/modules.py:277-299``): q and the probabilities stay in float,
        K/V are converted to q's dtype on read; the per-position K scale
        multiplies the f32 scores, the V scale is folded into the
        probabilities before their cast."""
        if ctx.train:
            raise ValueError("quantized cross-KV is decode-only")
        kq, ks, vq, vs = kv
        scores = dot_f32(q, kq.to(q.dtype))
        scores = divide(scores * ks[..., None, :], math.sqrt(self.head_dim))
        probs = torch.softmax(scores, dim=-1)
        pv = (probs * vs[..., None, :]).to(q.dtype)
        y = torch.matmul(pv, vq.to(q.dtype)).to(query.dtype)
        return y.transpose(-3, -2).reshape(*query.shape[:-1], -1)
