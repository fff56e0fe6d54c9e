"""Blockwise int4 quantization of frozen decoder weights (counterpart of
``image2text_tpu/models/quantization.py``; the JAX package's replacement
for the reference's bitsandbytes NF4 ``load_in_4bit`` path).

:class:`QuantizedLinear` stores its weight packed two 4-bit values per
byte with one scale per 64-column block (``ops/int4_matmul.py`` gives the
layout) and an f32 bias; its product is the int4 dequant-matmul kernel on
the card, for every row count (the JAX module's rows < 8 fallback is a TPU
tiling gate and does not come across).  The packed weight is a uint8
buffer (torch holds no integer parameters) that counts as a frozen
parameter (``nn.core.frozen_param_paths``); the scales are a frozen f32
parameter, so a cast of the model to bf16 turns them into bf16 as the
JAX bf16 cast does, and the kernel reads them in that dtype.

:func:`int8_serving_params` is the W8A8 serving transform: the sizeable
``Linear`` and ``Embedding`` weights of a subtree become their int8 forms
(``nn/modules.py``).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.nn.core import EVAL_CTX, Ctx, new_param, zeros_init
from image2text_torch.nn.modules import Embedding, Linear, tp_enter, tp_exit
from image2text_torch.ops import int4_matmul as int4_ops
from image2text_torch.ops.int4_matmul import (QBLOCK, Int4Matmul,
                                              dequantize_int4,
                                              quantize_pack_int4)


# (out, in) float → (packed uint8 (out, in_pad/2), f32 scales): the JAX
# module's name for the packing of ``ops/int4_matmul.py``
quantize_blockwise = quantize_pack_int4


def dequantize_blockwise(packed, scales, in_features: int,
                         dtype=torch.float32):
    """Unpack and scale back to the (out, in_features) float weight."""
    return dequantize_int4(packed, scales, dtype)[:, :in_features]


class QuantizedLinear(nn.Module):
    """Linear with a packed blockwise-int4 frozen weight and an f32 bias.

    Under a model split (``parallel/sharding_rules.py`` module docstring,
    3) ``tp`` is set as a ``Linear``'s: a column shard holds its rows of
    the bytes, the scales and the bias; a row shard holds byte columns
    ``[r·P/m, (r+1)·P/m)`` with their scales, so it reads this rank's
    chunk of each half of the input, and the kernel runs on the shard as
    on any (rows, in_pad/2) weight."""

    tp = None   # ('col' | 'row', Axis, sections) once the placement split it

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.in_pad = (in_features + QBLOCK - 1) // QBLOCK * QBLOCK
        self.register_buffer("weight", torch.zeros(
            out_features, self.in_pad // 2, dtype=torch.uint8, device=device))
        self._param_buffers = ("weight",)
        new_param(self, "weight_scales", (out_features, self.in_pad // QBLOCK),
                  zeros_init(), device)
        if bias:
            new_param(self, "bias", (out_features,), zeros_init(), device)
        else:
            self.bias = None
        self._frozen = {"weight", "weight_scales"}

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        """Under a split the shard computes the unsplit product up to
        summation order: a row shard's partial product stays f32 until the
        model group has summed it, and in training a column shard's input
        enters in f32, so that the group sums the shards' dx unrounded;
        each is rounded once, as the unsplit product and dx are."""
        width = 2 * self.weight.shape[1]   # the (shard's) in_pad
        dtype, grad = x.dtype, torch.is_grad_enabled()
        kind = None if self.tp is None else self.tp[0]
        x = tp_enter(self, x.float() if kind == "col" and grad else x, width)
        if x.shape[-1] != width:
            x = F.pad(x, (0, width - x.shape[-1]))
        f32_out = {"out_dtype": torch.float32} if kind == "row" else {}
        if grad:
            y = Int4Matmul.apply(x, self.weight, self.weight_scales, dtype,
                                 f32_out.get("out_dtype"))
        else:   # serving: the kernel without an autograd node
            y = int4_ops.int4_matmul(x.contiguous(), self.weight,
                                     self.weight_scales, **f32_out)
        y = tp_exit(self, y).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def quantize_module_structure(module: nn.Module,
                              skip_paths: Iterable[str] = (),
                              device=None) -> None:
    """Swap every plain ``Linear`` under ``module`` whose path contains none
    of ``skip_paths`` for a :class:`QuantizedLinear` on ``device`` (default:
    the Linear's own) (structure only, before the weights are set; run
    before ``apply_lora`` so adapters wrap the quantized base)."""
    skip = tuple(skip_paths)

    def walk(parent: nn.Module, prefix: str):
        for name, child in list(parent.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            if any(s in path for s in skip):
                continue
            if type(child) is Linear:
                out_f, in_f = child.weight.shape
                setattr(parent, name, QuantizedLinear(
                    in_f, out_f, bias=child.bias is not None,
                    device=child.weight.device if device is None
                    else device))
            else:
                walk(child, path)

    walk(module, "")


def build_int4(build, device=None,
               skip_paths: Iterable[str] = ()) -> nn.Module:
    """``build(dev)`` (a module constructor taking its device) with its
    frozen Linears int4 from the start: the module is built on the meta
    device (no memory), every plain ``Linear`` outside ``skip_paths``
    becomes a :class:`QuantizedLinear` on ``device``, and every other
    tensor is then allocated there, uninitialised as a new module's
    tensors are until ``init_parameters``.  So a model's float copy of its
    int4 weights (51 GB for Llama-2-13B in f32) never exists."""
    device = torch.device("cpu" if device is None else device)
    module = build("meta")
    quantize_module_structure(module, skip_paths, device)
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.is_meta:
                mod._parameters[name] = nn.Parameter(
                    torch.empty_like(p, device=device),
                    requires_grad=p.requires_grad)
        for name, b in list(mod._buffers.items()):
            if b is not None and b.is_meta:
                mod._buffers[name] = torch.empty_like(b, device=device)
    return module


@torch.no_grad()
def int8_serving_params(module: nn.Module,
                        min_elems: int = 1 << 18) -> nn.Module:
    """The W8A8 serving transform, in place (JAX
    ``models/quantization.py::int8_serving_params``): every module of the
    subtree whose type is exactly ``Linear`` or ``Embedding`` and whose
    weight is a 2-D float tensor of at least ``min_elems`` elements takes
    its int8 form (``qweight`` int8 rows, ``qscale`` f32 per row, the
    storage dtype recorded in ``qdtype``).  Typed on the module tree, as
    JAX's walk: ``MoELinear``'s stacked experts, LoRA wrappers and their
    adapters, int4 ``QuantizedLinear``s and ``MultiheadAttention``'s
    ``in_proj_weight`` are never rewritten, nor is a subclass such as the
    encoder's positional table.  Apply it after any dtype cast of the
    model (the scales stay f32), to the decoder subtree as serving does.
    The eval kernels' cached operands in the subtree are dropped: the
    kernels take float weights only, and their callers check the form."""
    from image2text_torch.models.layers import _Cached

    def walk(parent: nn.Module):
        for child in parent.children():
            if type(child) in (Linear, Embedding):
                w = getattr(child, "weight", None)
                if (w is not None and w.dim() == 2 and w.is_floating_point()
                        and w.numel() >= min_elems):
                    child.to_int8()
            else:
                walk(child)

    walk(module)
    for mod in module.modules():
        for value in vars(mod).values():
            if isinstance(value, _Cached):
                value.clear()
    return module


@torch.no_grad()
def assign_imported(tensors: Dict[str, torch.Tensor], key: str,
                    value: np.ndarray) -> bool:
    """Copy an imported float tensor into ``tensors[key]`` (a module's
    parameters and buffers by path), quantizing it when the destination is
    an int4 weight (the checkpoint stores floats).  False on a shape
    mismatch."""
    dst = tensors[key]
    value = torch.as_tensor(np.asarray(value))
    if dst.dtype == torch.uint8 and key.endswith("weight"):
        q, s = quantize_blockwise(value)
        if tuple(q.shape) != tuple(dst.shape):
            return False
        dst.copy_(q)
        scales = tensors[key[: -len("weight")] + "weight_scales"]
        scales.copy_(s.to(scales.dtype))
        return True
    if tuple(dst.shape) == tuple(value.shape):
        dst.copy_(value.to(dst.dtype))
        return True
    return False


@torch.no_grad()
def fill_random_int4(module: nn.Module, generator: torch.Generator) -> None:
    """Give every :class:`QuantizedLinear` under ``module`` the quantized
    image of an N(0, 0.02²) float matrix — the import path's own step — so
    that random weights make the int4 product do real work (the JAX
    initialiser, like this port's, leaves packed weights and scales zero)."""
    for mod in module.modules():
        if isinstance(mod, QuantizedLinear):
            w = torch.empty(mod.out_features, mod.in_features,
                            device=mod.weight.device)
            w.normal_(0.0, 0.02, generator=generator)
            q, s = quantize_blockwise(w)
            mod.weight.copy_(q)
            mod.weight_scales.copy_(s.to(mod.weight_scales.dtype))


__all__ = ["QuantizedLinear", "assign_imported", "build_int4",
           "dequantize_blockwise",
           "fill_random_int4", "int8_serving_params", "quantize_blockwise",
           "quantize_module_structure"]
