"""The device mesh over ``torch.distributed`` (counterpart of
``image2text_tpu/parallel/mesh.py``).

A run of N processes (``torchrun --nproc_per_node N``) is a mesh of N
ranks laid out ``(data, model)`` as the JAX mesh lays out its devices:
rank ``r`` sits at data index ``r // model`` and model index
``r % model``, so a model group is ``model`` consecutive ranks.  Its
groups come from a ``torch.distributed.device_mesh.DeviceMesh`` with the
dims ``("data", "model")``.  NCCL on the card (device ``cuda:LOCAL_RANK``),
gloo when the caller asks for the CPU.

* :func:`maybe_initialize_distributed` starts the default process group
  from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``); without it, a no-op.
* :func:`make_mesh` keeps JAX's arithmetic: ``data = -1`` takes every
  remaining rank, and a layout that does not cover the world fails with
  JAX's message.  Without a process group the mesh is one rank.
* :func:`shard_batch` gives this rank its rows of the global batch:
  contiguous blocks by data index, the same rows for the model peers
  (``split_batches=True`` parity, as the JAX mesh's ``P('data')``).
  ``batch_size`` stays the global batch.

``honor_platform_env`` is JAX plumbing (a PJRT plugin overriding
``JAX_PLATFORMS``) and has no counterpart here; nor have JAX's
``data_sharding`` and ``replicated``: they name GSPMD placements, and the
port places nothing implicitly (``shard_batch`` keeps a rank's rows, and
a replicated tensor is a whole tensor on every rank).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from image2text_torch.configs.trainer import MeshConfig
from image2text_torch.parallel.collectives import Axis


def maybe_initialize_distributed(device: Optional[str] = None) -> bool:
    """``init_process_group`` from torchrun's environment (no-op without
    ``RANK``/``WORLD_SIZE``, or when a group exists); NCCL on the card
    (and ``torch.cuda.set_device(LOCAL_RANK)``), gloo for
    ``device='cpu'``.  True when a process group is up afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            init_method="env://")
    return True


class Mesh:
    """A ``(data, model)`` mesh of ranks seen from this rank: ``shape``
    as JAX's ``Mesh.shape`` and one :class:`Axis` per dim (its group
    None outside a process group: a layout to reason about, as the tests
    do, with no collective to run)."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 device_type: str = "cpu", ranks=None):
        """``ranks``: the world ranks the mesh spans in order (default all
        of them); every rank of the world constructs it, only its
        members use it, at their index in ``ranks``."""
        self.shape = {"data": data, "model": model}
        self.device_type = device_type
        self.device_mesh = None
        data_group = model_group = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import (DeviceMesh,
                                                       init_device_mesh)

            if ranks is None:
                self.device_mesh = init_device_mesh(
                    device_type, (data, model),
                    mesh_dim_names=("data", "model"))
            else:
                self.device_mesh = DeviceMesh(
                    device_type, torch.tensor(ranks).reshape(data, model),
                    mesh_dim_names=("data", "model"))
                rank = ranks.index(rank) if rank in ranks else 0
            data_group = self.device_mesh.get_group("data")
            model_group = self.device_mesh.get_group("model")
        self.rank = rank
        self.data = Axis(data_group, data, rank // model)
        self.model = Axis(model_group, model, rank % model)

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank})")


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: str = "cpu") -> Mesh:
    """The mesh of the current process group (one rank without one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = config.model if config is not None else 1
    data = config.data if config is not None else -1
    if data == -1:
        assert world % model == 0
        data = world // model
    assert data * model == world, (
        f"mesh {data}x{model} does not cover {world} devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(data, model, rank, device_type)


def batch_rows(mesh: Mesh, batch: int, micro: int = 1) -> list:
    """The global rows of this rank's share of a ``batch``-row global
    batch cut into ``micro`` consecutive micro-batches (gradient
    accumulation): of each micro-batch, the data index's contiguous
    block, so a rank's i-th micro-batch is its share of the global i-th."""
    data = mesh.shape["data"]
    assert batch % (data * micro) == 0, (
        f"global batch {batch} does not divide over {data} data ranks "
        f"and {micro} micro-batches")
    m = batch // micro
    local = m // data
    return [r for i in range(micro)
            for r in range(i * m + mesh.data.rank * local,
                           i * m + (mesh.data.rank + 1) * local)]


def shard_batch(mesh: Mesh, *arrays, micro: int = 1):
    """This rank's rows of each global-batch array (numpy or torch),
    :func:`batch_rows`; the same rows for the model peers."""
    out = []
    for a in arrays:
        rows = batch_rows(mesh, a.shape[0], micro)
        if mesh.shape["data"] == 1:
            out.append(a)
        elif micro == 1:
            out.append(a[rows[0]:rows[-1] + 1])
        else:
            out.append(a[rows] if isinstance(a, np.ndarray)
                       else a[torch.as_tensor(rows)])
    return tuple(out) if len(out) > 1 else out[0]


__all__ = ["Mesh", "batch_rows", "make_mesh", "maybe_initialize_distributed",
           "shard_batch"]
