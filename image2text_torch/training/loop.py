"""Training runtime (counterpart of ``image2text_tpu/training/loop.py``):
the train and val steps and a ``Trainer`` with its epoch loops, on one
device or over a mesh of ranks (``parallel/``).

* Mixed precision as in the JAX package: the f32 master parameters are
  cast to the compute dtype inside the step (bf16 for 'bf16'/'fp16') and
  the model runs on those copies through ``torch.func.functional_call``,
  so the casts are part of the graph and the gradients land on the f32
  masters.  Not ``torch.autocast``: its per-op policy is not the JAX
  package's.  Images are cast too; logits and the loss are f32.
* Gradient accumulation: micro-batches' gradients add up in ``.grad`` and
  are divided by their count (the mean of the micro-gradients).
* The EMA teacher is updated after the optimizer step.
* Randomness: the step's seed is ``fold(seed, step)`` and a micro-batch's
  ``fold(step seed, i)`` (``nn.core.Ctx``), as the JAX step folds its key.

PyTorch updates in place: the parameters and the optimizer's moments are
the train state, and the step function returns only the metrics.
``Trainer.save_state``/``restore_state`` write and read that state with
the step (``training/checkpoint.py``); ``train_loop`` writes the weights
to ``chkpt_fname`` after its steps (``utils/checkpoint.py``, only the
optimizer's ``target_modules`` where they are given), traces the first
epoch's steps 10–12 into ``profile_dir`` and reports steps/s and tokens/s
(``utils/profiling.py``).

Under a mesh (``Trainer(config, wrapper, mesh)``, ``parallel/mesh.py``)
the step is the one-device step on the global batch, whatever the mesh:

* ``train_step`` and ``val_step`` take the global batch, and each rank
  keeps its rows (``shard_batch``; with gradient accumulation its share
  of every micro-batch, so the micro-batches are the one-device run's);
  ``train_loop`` and ``val_loop`` take batches of the rank's rows (the
  CLI's loaders read its data shard).  A rank's dropout and corruption
  draws are its slices of the global draws;
* tensor and expert parallelism split the weights over the model axis in
  place (``sharding_rules.place_params``, JAX ``loop.py:174-200``), and
  ``sequence_parallel`` tags the blocks;
* the backward runs on the rank's share of the global loss (its mean
  loss over the data size: block outputs normalise their gradient over
  the whole batch, ``ops.functions.normalize_gradients``, so a rank's
  gradient must be its part of the global one) and after accumulation
  the gradients are summed over the data group by bucketed all-reduces;
  the metrics are averaged;
* ``zero_sharded_optimizer`` with a data size above 1 keeps the
  optimizer's moments as 1/data slices (``sharding_rules.ZeroOptimizer``);
* ``save_state`` gathers the shards (weights over the model axis, moments
  over both) into the one-device state, which rank 0 writes; every rank
  restores it and keeps its shards.  The weights' checkpoint is gathered
  by every rank and written by rank 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from image2text_torch.configs.trainer import TrainingConfig
from image2text_torch.nn.core import Ctx
from image2text_torch.parallel.collectives import chunk_of
from image2text_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from image2text_torch.training.optimizer import build_optimizer
from image2text_torch.training.remat import set_remat_policy
from image2text_torch.training.wrapper import ModelTrainerWrapper
from image2text_torch.utils.patterns import PatternMatcher


def compute_dtype(precision: str) -> torch.dtype:
    """'no' → f32; 'bf16' or 'fp16' → bf16 (as the JAX package)."""
    return torch.float32 if precision == "no" else torch.bfloat16


def cast_for_compute(module: torch.nn.Module, dtype: torch.dtype):
    """{name: parameter in ``dtype``}, differentiable casts of the f32
    masters (the masters themselves for f32)."""
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in module.named_parameters()}


GRAD_BUCKET = 1 << 24   # elements of one gradient all-reduce


@torch.no_grad()
def sum_over(tensors: List[torch.Tensor], mesh: Mesh,
             mean: bool = False) -> None:
    """Each tensor ← its sum (or ``mean``) over the mesh's data group, in
    place, by all-reduces of buckets of about ``GRAD_BUCKET`` elements
    (one a dtype and bucket).  Runs whenever the mesh has a process group
    (at one rank the sum is the tensor itself)."""
    if not mesh.distributed:
        return
    n = mesh.shape["data"] if mean else 1
    group = mesh.data.group
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or sum(
                b.numel() for b in bucket) + t.numel() > GRAD_BUCKET):
            flush()
        bucket.append(t)
    if bucket:
        flush()


def make_train_step(wrapper: ModelTrainerWrapper, optimizer,
                    accum_steps: int = 1, precision: str = "no",
                    use_flash: bool = True,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step_fn(images, labels, seed, step) -> metrics``: one optimizer
    step on the batch, in place.  Under a ``mesh`` the batch is this
    rank's rows (``shard_batch`` with ``micro=accum_steps``), the
    backward runs on its share of the global loss, the gradients are
    summed and the metrics averaged over the data group."""
    dtype = compute_dtype(precision)
    params = [p for p in wrapper.parameters() if p.requires_grad]
    data = 1 if mesh is None else mesh.shape["data"]
    data_rank = 0 if mesh is None else mesh.data.rank

    def grads_of(images, labels, seed):
        b = images.shape[0]
        rows = (data_rank * b, data * b) if data > 1 else (0, 0)
        return functional_call(
            wrapper, cast_for_compute(wrapper, dtype),
            (images.to(dtype), labels),
            dict(seed=seed, use_flash=use_flash, backward=True, rows=rows,
                 loss_scale=1.0 / data))

    def step_fn(images, labels, seed: int, step: int) -> Dict[str, float]:
        step_seed = Ctx(seed).fold(step).seed
        for p in params:
            p.grad = None
        if accum_steps > 1:
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch_size {b * data} must be divisible "
                                 f"by gradient_accumulation_steps "
                                 f"{accum_steps}" + (
                                     f" on each of {data} data ranks"
                                     if data > 1 else ""))
            micro = b // accum_steps
            sums: Dict[str, torch.Tensor] = {}
            for i in range(accum_steps):
                sl = slice(i * micro, (i + 1) * micro)
                _, m = grads_of(images[sl], labels[sl],
                                Ctx(step_seed).fold(i).seed)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + v
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            metrics = {k: v / accum_steps for k, v in sums.items()}
        else:
            _, metrics = grads_of(images, labels, step_seed)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:   # each rank's share of the global loss
            sum_over([p.grad for p in params], mesh)
            metrics = _mean_metrics(metrics, mesh)
        optimizer.step()
        if wrapper.is_momentum:
            wrapper.momentum_update()
        return metrics

    return step_fn


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh):
    """The metrics averaged over the data group (one all-reduce)."""
    if not mesh.distributed or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k]).float() for k in keys])
    sum_over([flat], mesh, mean=True)
    return dict(zip(keys, flat.unbind()))


def make_val_step(wrapper: ModelTrainerWrapper, precision: str = "no",
                  use_flash: bool = True,
                  mesh: Optional[Mesh] = None) -> Callable:
    dtype = compute_dtype(precision)

    @torch.no_grad()
    def val_fn(images, labels):
        loss, metrics = functional_call(
            wrapper, cast_for_compute(wrapper, dtype),
            (images.to(dtype), labels),
            dict(is_train=False, use_flash=use_flash))
        if mesh is not None and mesh.distributed:
            metrics = _mean_metrics({**metrics, "__loss": loss}, mesh)
            loss = metrics.pop("__loss")
        return loss, metrics

    return val_fn


class Trainer:
    """The optimizer, the steps and the epoch loops, on one device or over
    ``mesh`` (default: ``make_mesh(config.mesh)`` of the current process
    group, one rank without one)."""

    def __init__(self, config: TrainingConfig, wrapper: ModelTrainerWrapper,
                 mesh: Optional[Mesh] = None, logging_callback=None):
        self.config = config
        self.wrapper = wrapper
        self.logging_callback = logging_callback
        self.device = wrapper.model.device
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh, self.device.type)
        self.rank0 = self.mesh.rank == 0
        set_remat_policy(wrapper.model, config.remat_policy)
        self.optimizer, self.labels = build_optimizer(
            wrapper, config.optimizers, use_snr=config.use_snr_optim)
        if self.mesh.shape["model"] > 1:
            from image2text_torch.parallel.sharding_rules import place_params

            place_params(wrapper, self.mesh)
        if config.sequence_parallel:
            from image2text_torch.parallel.sharding_rules import (
                set_sequence_parallel)

            n = set_sequence_parallel(wrapper, self.mesh)
            if n == 0 and self.rank0:
                print("WARNING: sequence_parallel requested but no blocks "
                      "tagged (mesh.model == 1 or unrecognised decoder)",
                      flush=True)
        wrapper.data_axis = self.mesh.data
        self.zero = None
        if config.zero_sharded_optimizer and self.mesh.shape["data"] > 1:
            from image2text_torch.parallel.sharding_rules import ZeroOptimizer

            self.zero = self.optimizer = ZeroOptimizer(self.optimizer,
                                                       self.mesh)
        use_flash = not config.disable_flash
        mesh_arg = self.mesh if self.mesh.distributed else None
        self._train_step = make_train_step(
            wrapper, self.optimizer, config.gradient_accumulation_steps,
            config.precision, use_flash, mesh_arg)
        self._val_step = make_val_step(wrapper, config.precision, use_flash,
                                       mesh_arg)
        self.matchers = [PatternMatcher(oc.target_modules)
                         for oc in config.optimizers
                         if oc.target_modules is not None]
        self.step = 0
        self.seed = config.seed
        # every step's metrics, left on the device (no synchronisation)
        self.history: List[Dict[str, torch.Tensor]] = []

    def _on_device(self, *arrays):
        return tuple(t.to(self.device) if torch.is_tensor(t) else
                     torch.as_tensor(np.asarray(t), device=self.device)
                     for t in arrays)

    def _step(self, images, labels) -> Dict[str, torch.Tensor]:
        """One step on this rank's rows, on the device."""
        metrics = self._train_step(images, labels, self.seed, self.step)
        self.history.append(metrics)
        self.step += 1
        return metrics

    def train_step(self, images, labels) -> Dict[str, torch.Tensor]:
        """One step on the global batch (every rank passes all of it and
        keeps its rows: ``shard_batch``)."""
        return self._step(*self._on_device(*shard_batch(
            self.mesh, images, labels,
            micro=self.config.gradient_accumulation_steps)))

    def val_step(self, images, labels):
        """The val losses of the global batch (as :meth:`train_step`)."""
        return self._val_step(*self._on_device(
            *shard_batch(self.mesh, images, labels)))

    def train_loop(self, train_iter: Iterator, epoch: int,
                   chkpt_fname: Optional[str] = None,
                   log_every: int = 20) -> bool:
        """Up to ``num_steps`` steps (100 by default) on the batches of
        ``train_iter``, each this rank's rows (a loader of its data shard,
        as JAX's loop takes the process-local rows), then the weights to
        ``chkpt_fname``; True when the iterator ran out."""
        from image2text_torch.utils.profiling import Throughput, TraceWindow

        cfg = self.config
        num_steps = 100 if cfg.num_steps is None else cfg.num_steps
        stop = False
        meter = Throughput()
        trace = TraceWindow(cfg.profile_dir if epoch == 0 and self.rank0
                            else None)
        for step in range(num_steps):
            trace.step(step)
            try:
                images, labels = next(train_iter)
            except StopIteration:
                stop = True
                break
            metrics = self._step(*self._on_device(images, labels))
            meter.update(items=int(np.prod(np.shape(labels))))
            if (step + 1) % log_every == 0 or step == num_steps - 1:
                values = {k: float(v) for k, v in metrics.items()}
                if self.rank0:
                    print(f"epoch {epoch} step {step + 1}/{num_steps} "
                          f"{values} ({meter.steps_per_sec:.2f} steps/s, "
                          f"{meter.items_per_sec:.0f} tok/s)", flush=True)
                if self.logging_callback is not None and self.rank0:
                    self.logging_callback(values, batch=step, epoch=epoch)
        trace.close()
        if (cfg.reset_moco_after_k_epochs is not None
                and (epoch + 1) in cfg.reset_moco_after_k_epochs
                and self.wrapper.is_momentum):
            self.wrapper.copy_momentum_params()
        if chkpt_fname is not None:
            from image2text_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(self.wrapper.model, chkpt_fname,
                            matchers=self.matchers or None)
        return stop

    # -- full-state resume ---------------------------------------------------
    def _optimizer_state(self):
        """The optimizer's state dict in the one-device form: moments
        gathered over the data group (ZeRO-1) and the model group."""
        from image2text_torch.parallel.collectives import gather_whole
        from image2text_torch.parallel.sharding_rules import whole

        inner = self.zero.inner if self.zero is not None else self.optimizer
        sd = inner.state_dict()
        params = [p for g in inner.param_groups for p in g["params"]]
        zero_of = {id(s): p for s, p in (self.zero.slices if self.zero
                                         else [])}
        for i, st in sd["state"].items():
            p = params[i]
            owner = zero_of.get(id(p), p)
            for k, v in list(st.items()):
                if not torch.is_tensor(v) or v.dim() == 0:
                    continue
                if id(p) in zero_of:
                    v = gather_whole(v, self.mesh.data, 0)
                st[k] = whole(v, getattr(owner, "_tp", None), self.mesh.model)
        return sd

    def _load_optimizer_state(self, sd) -> None:
        from image2text_torch.parallel.sharding_rules import shard

        inner = self.zero.inner if self.zero is not None else self.optimizer
        params = [p for g in inner.param_groups for p in g["params"]]
        zero_of = {id(s): p for s, p in (self.zero.slices if self.zero
                                         else [])}
        m = self.mesh.model
        for i, st in sd["state"].items():
            p = params[i]
            owner = zero_of.get(id(p), p)
            tp = getattr(owner, "_tp", None)
            for k, v in list(st.items()):
                if not torch.is_tensor(v) or v.dim() == 0:
                    continue
                if tp is not None:
                    v = shard(v, tp[0], tp[1], m.rank, m.size)
                if id(p) in zero_of:
                    v = chunk_of(v, self.mesh.data, 0)
                st[k] = v
        inner.load_state_dict(sd)

    def save_state(self, path: str) -> None:
        """The train state (weights, optimizer, step, seed) into ``path``:
        the one-device state whatever the mesh (every rank calls; rank 0
        writes)."""
        from image2text_torch.parallel.sharding_rules import whole_state
        from image2text_torch.training.checkpoint import save_train_state

        state = dict(
            wrapper=whole_state(self.wrapper, self.mesh,
                                self.wrapper.state_dict()),
            optimizer=self._optimizer_state(), step=self.step,
            seed=self.seed)
        if self.rank0:
            save_train_state(path, state)
        if self.mesh.distributed:
            dist.barrier()

    def restore_state(self, path: str) -> None:
        """The train state :meth:`save_state` wrote into ``path``, each
        rank keeping its shards."""
        from image2text_torch.parallel.sharding_rules import local_state
        from image2text_torch.training.checkpoint import restore_train_state

        state = restore_train_state(path, self.device)
        if state["seed"] != self.seed:
            raise ValueError(f"{path} holds a run of seed {state['seed']}, "
                             f"not {self.seed}")
        self.wrapper.load_state_dict(local_state(self.wrapper, self.mesh,
                                                 state["wrapper"]))
        with torch.no_grad():
            for s, p in (self.zero.slices if self.zero else []):
                s.copy_(chunk_of(p.detach(), self.mesh.data, 0))
        self._load_optimizer_state(state["optimizer"])
        self.step = state["step"]

    def val_loop(self, val_iter: Iterator, epoch: int):
        """(mean loss, mean metrics) over ``num_val_steps`` batches of this
        rank's rows (as :meth:`train_loop`); the values stay on the device
        until the end."""
        cfg = self.config
        num_steps = 100 if cfg.num_val_steps is None else cfg.num_val_steps
        losses: List[torch.Tensor] = []
        metrics: Dict[str, List[torch.Tensor]] = {}
        for _ in range(num_steps):
            loss, m = self._val_step(*self._on_device(*next(val_iter)))
            losses.append(loss)
            for k, v in m.items():
                metrics.setdefault(k, []).append(v)
        return (float(torch.stack(losses).mean()),
                {k: float(torch.stack(v).mean()) for k, v in metrics.items()})


__all__ = ["Trainer", "cast_for_compute", "compute_dtype", "make_train_step",
           "make_val_step"]
