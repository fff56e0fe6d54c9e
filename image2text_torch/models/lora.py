"""Low-rank adapters (counterpart of ``image2text_tpu/models/lora.py``).

Matched ``Linear`` and ``QuantizedLinear`` children become LoRA-wrapped
versions of themselves: the base tensors keep their paths
(``...c_attn.weight``, ``...c_attn.weight_scales``) and the adapters
appear as ``...c_attn.lora_A.weight`` / ``...c_attn.lora_B.weight``, with
no extra nesting.  As under peft, the wrapped module freezes its whole
subtree but the adapters, and ``force_enable_update_modules`` patterns
re-enable paths (``nn.core.frozen_param_paths``).

``y = base(x) + (alpha/r) · B(A · dropout(x))``, the adapter product in
x's dtype.  The HF decoders and the ViT call their Linears without a
context, as the JAX ones do, so the adapter dropout is never active on
those paths; the scratch blocks pass theirs (JAX ``layers.py``).

Under a model split the adapters follow their base
(``parallel/sharding_rules.py`` module docstring, 3): on a column split
A is whole and ``A·x`` enters the split through ``copy_to`` (A's
gradient is then the one-device gradient on every rank), B keeps the
base's rows; on a row split A keeps the base's input columns, ``A·x`` is
summed over the model group in f32 and ``B(A·x)``, B whole, is added once
to the summed output.  The dropout mask of a row shard's input is the
rank's slice of the whole input's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from image2text_torch.configs.models import LoraSpec
from image2text_torch.models.quantization import QuantizedLinear
from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      uniform_init, zeros_init)
from image2text_torch.nn.modules import Linear, tp_enter
from image2text_torch.parallel.collectives import copy_to, reduce_from
from image2text_torch.utils.patterns import PatternMatcher


class _LoRAMixin:
    """Adapters on top of a Linear-like base class."""

    def _init_lora(self, r: int, lora_alpha: int, lora_dropout: float,
                   in_features: int, out_features: int, device) -> None:
        self.r = r
        self.scaling = lora_alpha / r
        self.lora_dropout = lora_dropout
        self.lora_A = nn.Module()
        new_param(self.lora_A, "weight", (r, in_features),
                  uniform_init(1.0 / math.sqrt(in_features)), device)
        self.lora_B = nn.Module()
        new_param(self.lora_B, "weight", (out_features, r), zeros_init(),
                  device)

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        y = super().forward(x)
        a = self.lora_A.weight.to(x.dtype)
        b = self.lora_B.weight.to(x.dtype)
        tp = self.tp
        if tp is not None and tp[0] == "row":
            width = a.shape[1]
            if x.shape[-1] != width:    # whole: dropped, then cut
                x = tp_enter(self, dropout(x, self.lora_dropout, ctx)[0],
                             width)
            else:
                x = dropout(x, self.lora_dropout, ctx,
                            last=(tp[2], tp[1]))[0]
            # the partials summed in f32, rounded once as the unsplit A·x
            h = reduce_from(torch.matmul(x.float(), a.float().t()),
                            tp[1]).to(x.dtype)
        else:
            xd, _ = dropout(x, self.lora_dropout, ctx)
            h = torch.matmul(xd, a.t())
            if tp is not None:
                h = copy_to(h, tp[1])
        return y + torch.matmul(h, b.t()) * self.scaling


class LoRALinear(_LoRAMixin, Linear):
    pass


class LoRAQuantizedLinear(_LoRAMixin, QuantizedLinear):
    pass


def make_lora_wrapper(base: nn.Module, r: int, lora_alpha: int,
                      lora_dropout: float) -> nn.Module:
    """A LoRA-wrapped module of ``base``'s class and shape (structure only:
    the tensors are set later, as the base's would be)."""
    if type(base) is QuantizedLinear:
        in_f, out_f = base.in_features, base.out_features
        wrapped = LoRAQuantizedLinear(in_f, out_f, bias=base.bias is not None,
                                      device=base.weight.device)
    elif type(base) is Linear:
        out_f, in_f = base.weight.shape
        wrapped = LoRALinear(in_f, out_f, bias=base.bias is not None,
                             device=base.weight.device)
    else:
        raise TypeError(f"Don't know how to LoRA-wrap {type(base).__name__} "
                        "without losing its class-specific params")
    wrapped._init_lora(r, lora_alpha, lora_dropout, in_f, out_f,
                       base.weight.device)
    return wrapped


def _matches_target(path: str, targets: Sequence[str]) -> bool:
    """peft semantics: a plain target matches the module name at a segment
    boundary (``path == t`` or ends with ``'.' + t``); a glob target
    fnmatches the path or its tail."""
    import fnmatch

    for t in targets:
        if any(ch in t for ch in "*?["):
            if fnmatch.fnmatch(path, t) or fnmatch.fnmatch(path, f"*.{t}"):
                return True
        elif path == t or path.endswith("." + t):
            return True
    return False


def apply_lora(module: nn.Module, lora_spec: Optional[LoraSpec]) -> nn.Module:
    """Wrap the matched Linear children with adapters and freeze the rest of
    ``module``'s subtree."""
    if lora_spec is None:
        return module
    n_wrapped = 0

    def walk(parent: nn.Module, prefix: str):
        nonlocal n_wrapped
        for name, child in list(parent.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            if (isinstance(child, (Linear, QuantizedLinear))
                    and not isinstance(child, _LoRAMixin)
                    and (lora_spec.target_modules is None
                         or _matches_target(path, lora_spec.target_modules))):
                setattr(parent, name, make_lora_wrapper(
                    child, lora_spec.r, lora_spec.lora_alpha,
                    lora_spec.lora_dropout))
                n_wrapped += 1
            else:
                walk(child, path)

    walk(module, "")
    if n_wrapped == 0:
        # peft raises here too: the freeze below would train nothing
        raise ValueError(f"Target modules {lora_spec.target_modules} not "
                         "found in the model; nothing was LoRA-wrapped")
    module._lora_freeze_all = True
    if lora_spec.force_enable_update_modules is not None:
        module._force_enable = PatternMatcher(
            lora_spec.force_enable_update_modules)
    return module


__all__ = ["LoRALinear", "LoRAQuantizedLinear", "apply_lora",
           "make_lora_wrapper"]
