"""Per-block gradient checkpointing and its policies (counterpart of
``image2text_tpu/training/remat.py``).

The encoder and decoder wrap each block of a training forward in
:func:`checkpoint_block` when their config enables gradient
checkpointing.  The policy says what the block keeps from its first run;
the rest is run again in the backward:

* ``None`` / ``"full"`` and ``"nothing"`` — only the block inputs (the
  JAX package's default ``jax.checkpoint`` policy and
  ``nothing_saveable``, the same rule);
* ``"dots"`` — also the outputs of matrix products without a batch
  dimension (``dots_with_no_batch_dims_saveable``): the aten product ops
  that the port's Linears and ``ops/functions.py::dot_f32`` emit
  (``mm``, ``addmm`` and their f32-output forms), not ``bmm``;
* ``"everything"`` — every aten op's output (``everything_saveable``),
  through the same code path.

The policies go through ``torch.utils.checkpoint``'s selective
checkpointing.  A hand-written kernel's launch is not an aten op, so no
policy can keep it: the kernel autograd Functions (flash attention,
``int4_matmul``) mark their forwards (``ops/functions.py::kernel_scope``)
and everything inside them is run again under every policy, on the card
(ctypes launches) as on the CPU (their plain versions).  Policies change
what is kept, never a value.

:func:`set_remat_policy` tags every module that has
``enable_gradient_checkpointing`` with the policy's name, as the JAX
package's does; the modules hand their tag to :func:`checkpoint_block`.

The recompute draws the same dropout masks as the first run because the
port's ``Ctx`` carries integer seeds (``nn/core.py``), not generator
state; so the global RNG state is not saved and restored around each
block (``preserve_rng_state=False``): nothing in a block draws from it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from image2text_torch.ops.functions import in_kernel_scope

POLICIES = ("full", "dots", "nothing", "everything")


# The aten products without a batch dimension (with the f32-output
# ``.dtype`` overloads where this torch has them: ``dot_f32`` on the card)
DOT_OPS = frozenset(
    getattr(packet, overload) for packet in (torch.ops.aten.mm,
                                             torch.ops.aten.addmm)
    for overload in ("default", "dtype") if overload in packet.overloads())


def _save_dots(ctx, op, *args, **kwargs):
    if op in DOT_OPS and not in_kernel_scope():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_everything(ctx, op, *args, **kwargs):
    if in_kernel_scope():
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


_SELECTIVE = {"dots": _save_dots, "everything": _save_everything}


def resolve_remat_policy(name: Optional[str]) -> Optional[str]:
    """The policy's canonical name (None for the default), or a raise."""
    if name in (None, "full", "nothing"):
        return None
    if name in _SELECTIVE:
        return name
    raise ValueError(f"unknown remat_policy {name!r}; "
                     "expected full|dots|nothing|everything")


def set_remat_policy(model: torch.nn.Module, name: Optional[str]) -> int:
    """Tag every checkpointing-capable module (the scratch encoder and
    decoder, the HF backbones: anything carrying
    ``enable_gradient_checkpointing``) with the policy; their per-block
    :func:`checkpoint_block` calls read it.  Returns the number of modules
    tagged."""
    policy = resolve_remat_policy(name)
    n = 0
    for m in model.modules():
        if hasattr(m, "enable_gradient_checkpointing"):
            m._remat_policy = policy
            n += 1
    return n


def checkpoint_block(fn, *args, policy: Optional[str] = None):
    """``fn(*args)`` with its activations recomputed in the backward, but
    what ``policy`` (a :func:`resolve_remat_policy` name) keeps."""
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _SELECTIVE[policy])
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
