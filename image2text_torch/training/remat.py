"""Per-block gradient checkpointing (counterpart of
``image2text_tpu/training/remat.py``).

The encoder and decoder wrap each block of a training forward in
:func:`checkpoint_block` when their config enables gradient
checkpointing: only the block inputs are saved and the block is run again
in the backward (the JAX package's default ``jax.checkpoint`` policy,
``None``/``"full"``).  The JAX package's other policies (``dots``,
``nothing``, ``everything``) are not ported yet; naming one raises.

The recompute draws the same dropout masks as the first run because the
port's ``Ctx`` carries integer seeds (``nn/core.py``), not generator
state; so the global RNG state is not saved and restored around each
block (``preserve_rng_state=False``): nothing in a block draws from it.
"""
from __future__ import annotations

from typing import Optional

from torch.utils.checkpoint import checkpoint


def check_remat_policy(name: Optional[str]) -> None:
    if name not in (None, "full"):
        raise ValueError(f"remat_policy {name!r} is not ported; expected "
                         "None or 'full'")


def checkpoint_block(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)
