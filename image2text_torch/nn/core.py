"""Parameter initialisers of the port (counterparts of
``image2text_tpu/nn/core.py``'s ``normal_init`` … ``xavier_uniform_init``).

Each initialiser returns ``fn(tensor, generator)`` that fills ``tensor`` in
place from an explicit ``torch.Generator`` (on the tensor's device), with
the same distribution as the JAX initialiser of the same name.  The two
frameworks draw different numbers from the same seed: parity tests carry
weights across with ``utils.checkpoint.load_jax_state_dict`` instead.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

InitFn = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def normal_init(std: float = 0.02, mean: float = 0.0) -> InitFn:
    def fn(t, gen):
        t.normal_(mean, std, generator=gen)
    return fn


def zeros_init() -> InitFn:
    return lambda t, gen: t.zero_()


def ones_init() -> InitFn:
    return lambda t, gen: t.fill_(1.0)


def uniform_init(bound: float) -> InitFn:
    def fn(t, gen):
        t.uniform_(-bound, bound, generator=gen)
    return fn


def torch_linear_weight_init(fan_in: int) -> InitFn:
    """torch.nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(±1/sqrt(fan_in))."""
    return uniform_init(1.0 / math.sqrt(fan_in)) if fan_in > 0 else zeros_init()


def xavier_uniform_init() -> InitFn:
    def fn(t, gen):
        fan_out, fan_in = t.shape[0], t.shape[1] if t.dim() > 1 else t.shape[0]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        t.uniform_(-bound, bound, generator=gen)
    return fn


def new_param(module: nn.Module, name: str, shape, init: InitFn,
              device=None) -> nn.Parameter:
    """Register an (uninitialised) f32 parameter with its initialiser."""
    p = nn.Parameter(torch.empty(tuple(shape), device=device),
                     requires_grad=False)
    module.register_parameter(name, p)
    if not hasattr(module, "_init_fns"):
        module._init_fns = {}
    module._init_fns[name] = init
    return p


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every registered parameter from ``generator``, in
    ``named_modules`` order (deterministic for a given seed and device)."""
    for mod in module.modules():
        for name, fn in getattr(mod, "_init_fns", {}).items():
            fn(getattr(mod, name), generator)
