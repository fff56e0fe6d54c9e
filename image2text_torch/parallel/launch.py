"""Start N ranks of a function joined by a process group: gloo on the
CPU (the mesh's tests and ``graft_entry.dryrun_multichip``), or NCCL with
rank ``r`` on card ``r`` (``backend='nccl'``).

The ranks are spawned processes (``torch.multiprocessing``, start method
'spawn'): each imports only the module of the function it runs, so that
module must be a port module (never a test file, whose conftest imports
JAX).  The rendezvous is a ``file://`` in a temporary directory, so runs
side by side never share a port; each rank runs one torch thread.  A
collective that waits past ``COLLECTIVE_TIMEOUT`` raises, so ranks that
fall out of step fail instead of hanging.  What a rank returns is saved
with ``torch.save`` in that directory and read back by the caller.
"""
from __future__ import annotations

import os
import tempfile
from datetime import timedelta
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = timedelta(seconds=300)


def _rank_main(rank: int, world: int, workdir: str, fn: Callable,
               args: tuple, backend: str = "gloo") -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        result = fn(rank, world, workdir, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


class Ranks:
    """``world`` ranks of ``fn(rank, world, workdir, *args)`` running in
    the background; :meth:`join` waits and returns their results."""

    def __init__(self, fn: Callable, world: int, *args: Any,
                 backend: str = "gloo"):
        self._dir = tempfile.TemporaryDirectory(prefix="i2t-ranks-")
        self.workdir = self._dir.name
        self.world = world
        self._ctx = mp.start_processes(
            _rank_main, args=(world, self.workdir, fn, args, backend),
            nprocs=world, join=False, start_method="spawn")

    def join(self) -> List[Any]:
        try:
            while not self._ctx.join():
                pass
            return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            self._dir.cleanup()


def run_ranks(fn: Callable, world: int, *args: Any,
              backend: str = "gloo") -> List[Any]:
    """``fn(rank, world, workdir, *args)`` on ``world`` ranks; the list of
    what each returned."""
    return Ranks(fn, world, *args, backend=backend).join()


__all__ = ["Ranks", "run_ranks"]
