"""Parameter initialisers, the forward context and dropout of the port
(counterparts of ``image2text_tpu/nn/core.py``'s ``normal_init`` …
``xavier_uniform_init``, ``Ctx`` and ``dropout``).

Each initialiser returns ``fn(tensor, generator)`` that fills ``tensor`` in
place from an explicit ``torch.Generator`` (on the tensor's device), with
the same distribution as the JAX initialiser of the same name.  The two
frameworks draw different numbers from the same seed: parity tests carry
weights across with ``utils.checkpoint.load_jax_state_dict`` instead.

Parameters are created with ``requires_grad=False``: serving builds no
autograd graphs.  Training turns gradients on for the model it trains
(``training/wrapper.py``).

:class:`Ctx` carries the train flag and an integer seed instead of a
``torch.Generator``: ``fold(i)`` and ``split()`` derive child seeds by a
fixed integer hash on the host, and every dropout seeds its own generator
from its derived seed.  A forward recomputed under
``torch.utils.checkpoint`` (which restores only the global RNG state, not
an explicit generator) therefore draws exactly the masks it drew the
first time.

Under a mesh (``parallel/``) a ``Ctx`` also carries this rank's rows of
the global batch (``rows = (first, global batch)``) and, for one
attention call, its heads (``heads = (first, all heads)``): a dropout
draws the mask of the global shape from its seed and keeps its slice, so
every mask equals the one-device run's; and the data axis, over which a
batch-wide reduction (``ops.functions.normalize_gradients``) sums.  :class:`SequenceParallel` is the
counterpart of JAX's ``sp_constrain``: a tagged model's block loop keeps
the stream as this rank's chunk of the sequence between blocks.

:func:`frozen_param_paths` is the trainable/frozen state of the JAX
``Module``: a module may name frozen tensors of its own (``_frozen``),
freeze its whole subtree but the LoRA adapters (``_lora_freeze_all``) and
re-enable paths by pattern (``_force_enable``), and a whole subtree may
be frozen (``_freeze_all``).  The packed int4 weights
are integer tensors, which torch cannot hold as parameters; their module
registers them as buffers and lists them in ``_param_buffers``, so they
count among the parameter paths as they do in the JAX tree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

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


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _own_param_names(module: nn.Module) -> List[str]:
    return ([n for n, _ in module.named_parameters(recurse=False)]
            + list(getattr(module, "_param_buffers", ())))


def _param_paths(module: nn.Module, path: str = "") -> List[str]:
    """Paths of the JAX parameter tree's leaves under ``module``: its
    parameters and the buffers its modules declare as parameters."""
    out = [_join(path, n) for n in _own_param_names(module)]
    for name, child in module.named_children():
        out += _param_paths(child, _join(path, name))
    return out


def frozen_param_paths(module: nn.Module, path: str = "") -> List[str]:
    """Paths of the parameters excluded from training, the JAX
    ``Module.frozen_param_paths``: a ``_freeze_all`` module (the pretrained
    ViT's backbone when it is not refined) freezes every path under it, a
    ``_lora_freeze_all`` one every path but the ``lora_A``/``lora_B``
    adapters, others their ``_frozen`` names; a ``_force_enable`` pattern matcher re-enables
    the paths it matches, whole or relative to its module."""
    if getattr(module, "_freeze_all", False):
        out = _param_paths(module, path)
    elif getattr(module, "_lora_freeze_all", False):
        # every path but the adapters, and the adapters too under a
        # _freeze_all module (JAX PretrainedViT.frozen_param_paths)
        held = [_join(path, n) + "." for n, m in module.named_modules()
                if n and getattr(m, "_freeze_all", False)]
        out = [p for p in _param_paths(module, path)
               if (".lora_A." not in p and ".lora_B." not in p)
               or any(p.startswith(h) for h in held)]
    else:
        frozen = getattr(module, "_frozen", ())
        out = [_join(path, n) for n in _own_param_names(module)
               if n in frozen]
        for name, child in module.named_children():
            out += frozen_param_paths(child, _join(path, name))
    enable = getattr(module, "_force_enable", None)
    if enable is not None:
        def enabled(p: str) -> bool:
            rel = p[len(path) + 1:] if path and p.startswith(path + ".") else p
            return enable.match(p) or enable.match(rel)
        out = [p for p in out if not enabled(p)]
    return out


_M64 = (1 << 64) - 1


def _mix(seed: int, data: int) -> int:
    """A 63-bit child seed of (seed, data): a splitmix64 finalizer."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


@dataclass(frozen=True)
class Ctx:
    """Immutable forward-pass context: a seed stream, the train flag and,
    under a mesh, this rank's slice of the global batch rows and of an
    attention's heads (``(0, 0)``: the tensor's own)."""

    seed: Optional[int] = None
    train: bool = False
    rows: Tuple[int, int] = (0, 0)
    heads: Tuple[int, int] = (0, 0)
    data_axis: Optional[object] = None   # the mesh's data Axis

    def split(self) -> Tuple["Ctx", int]:
        """(the advanced context, a seed to use now)."""
        if self.seed is None:
            raise ValueError("Ctx has no seed but randomness was requested")
        return (replace(self, seed=_mix(self.seed, 1)), _mix(self.seed, 3))

    def fold(self, data: int) -> "Ctx":
        if self.seed is None:
            return self
        return replace(self, seed=_mix(self.seed, 2 * data))

    def with_heads(self, *heads: int) -> "Ctx":
        """``heads``: (first, total), or (first, total, first of the
        second half) for heads split in two halves
        (``nn/modules.py::tp_heads``)."""
        return replace(self, heads=tuple(heads))


EVAL_CTX = Ctx()


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, ctx: Ctx,
            head_dim: Optional[int] = None,
            last=None) -> Tuple[torch.Tensor, Ctx]:
    """Inverted dropout, the identity at eval or rate 0; returns
    (y, advanced ctx).  Dim 0 is the batch: under ``ctx.rows`` the mask
    is drawn for the global batch and this rank's rows kept; likewise dim
    ``head_dim`` under ``ctx.heads``.  ``last = (sections, axis)``: the
    last dim is this rank's shard of a whole dim (its chunk of each of
    ``sections`` sections over the model ``axis``), and the mask is the
    whole dim's, cut alike."""
    if not ctx.train or rate <= 0.0:
        return x, ctx
    ctx, seed = ctx.split()
    keep = 1.0 - rate
    shape, index = list(x.shape), [slice(None)] * x.dim()
    first, total = ctx.rows
    if total:
        shape[0], index[0] = total, slice(first, first + x.shape[0])
    if head_dim is not None and ctx.heads[1]:
        if len(ctx.heads) != 2:
            raise NotImplementedError("dropout over heads split in two "
                                      "halves")
        first, total = ctx.heads
        shape[head_dim] = total
        index[head_dim] = slice(first, first + x.shape[head_dim])
    if last is not None:
        shape[-1] = x.shape[-1] * last[1].size
    u = torch.rand(shape, generator=generator(seed, x.device),
                   device=x.device)
    if last is not None:
        from image2text_torch.parallel.collectives import shard_of

        u = shard_of(u, last[1], u.dim() - 1, last[0])
    if list(u.shape) != list(x.shape):
        u = u[tuple(index)]
    return torch.where(u < keep, x / keep, torch.zeros_like(x)), ctx


class SequenceParallel:
    """A block loop's sequence parallelism (JAX ``nn/core.py::
    sp_constrain`` at the blocks' boundaries): between blocks the (b, t,
    d) stream is this rank's chunk of the t axis over the model group, so
    a remat-saved block input is 1/model the size; a block gathers the
    whole sequence on entry and keeps its chunk on exit (the stream is
    the same on every model rank, so the backward of each is the other).
    Off (:meth:`of` returns None) outside training, in cached decode,
    without a tagged block, and where t does not divide the model size."""

    def __init__(self, axis):
        self.axis = axis

    @classmethod
    def of(cls, blocks, x: torch.Tensor, ctx: Ctx, kv_cache=None
           ) -> Optional["SequenceParallel"]:
        blocks = list(blocks)
        axis = getattr(blocks[0], "_sp_axis", None) if blocks else None
        if (axis is None or axis.size == 1 or not ctx.train
                or kv_cache is not None or x.dim() != 3
                or x.shape[1] % axis.size):
            return None
        return cls(axis)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        from image2text_torch.parallel.collectives import scatter_to

        return scatter_to(x, self.axis, 1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        from image2text_torch.parallel.collectives import gather_from

        return gather_from(x, self.axis, 1)

    def wrap(self, run: Callable) -> Callable:
        """``run`` (stream first) on the gathered stream, its output
        chunked."""
        def chunked(x, *rest):
            return self.split(run(self.gather(x), *rest))
        return chunked
