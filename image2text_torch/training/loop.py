"""Training runtime on one device (counterpart of
``image2text_tpu/training/loop.py``): the train and val steps and a
``Trainer`` with its epoch loops.

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
(``utils/profiling.py``).  Data parallelism is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from image2text_torch.configs.trainer import TrainingConfig
from image2text_torch.nn.core import Ctx
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


def make_train_step(wrapper: ModelTrainerWrapper, optimizer,
                    accum_steps: int = 1, precision: str = "no",
                    use_flash: bool = True) -> Callable:
    """``step_fn(images, labels, seed, step) -> metrics``: one optimizer
    step on the batch, in place."""
    dtype = compute_dtype(precision)
    params = [p for p in wrapper.parameters() if p.requires_grad]

    def grads_of(images, labels, seed):
        return functional_call(
            wrapper, cast_for_compute(wrapper, dtype),
            (images.to(dtype), labels),
            dict(seed=seed, use_flash=use_flash, backward=True))

    def step_fn(images, labels, seed: int, step: int) -> Dict[str, float]:
        step_seed = Ctx(seed).fold(step).seed
        for p in params:
            p.grad = None
        if accum_steps > 1:
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch_size {b} must be divisible by "
                                 f"gradient_accumulation_steps {accum_steps}")
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
        optimizer.step()
        if wrapper.is_momentum:
            wrapper.momentum_update()
        return metrics

    return step_fn


def make_val_step(wrapper: ModelTrainerWrapper, precision: str = "no",
                  use_flash: bool = True) -> Callable:
    dtype = compute_dtype(precision)

    @torch.no_grad()
    def val_fn(images, labels):
        return functional_call(wrapper, cast_for_compute(wrapper, dtype),
                               (images.to(dtype), labels),
                               dict(is_train=False, use_flash=use_flash))

    return val_fn


class Trainer:
    """One device: the optimizer, the steps and the epoch loops."""

    def __init__(self, config: TrainingConfig, wrapper: ModelTrainerWrapper,
                 logging_callback=None):
        self.config = config
        self.wrapper = wrapper
        self.logging_callback = logging_callback
        self.device = wrapper.model.device
        set_remat_policy(wrapper.model, config.remat_policy)
        self.optimizer, self.labels = build_optimizer(
            wrapper, config.optimizers, use_snr=config.use_snr_optim)
        use_flash = not config.disable_flash
        self._train_step = make_train_step(
            wrapper, self.optimizer, config.gradient_accumulation_steps,
            config.precision, use_flash)
        self._val_step = make_val_step(wrapper, config.precision, use_flash)
        self.matchers = [PatternMatcher(oc.target_modules)
                         for oc in config.optimizers
                         if oc.target_modules is not None]
        self.step = 0
        self.seed = config.seed
        # every step's metrics, left on the device (no synchronisation)
        self.history: List[Dict[str, torch.Tensor]] = []

    def _batch(self, images, labels):
        return (torch.as_tensor(np.asarray(images), device=self.device),
                torch.as_tensor(np.asarray(labels), device=self.device))

    def train_loop(self, train_iter: Iterator, epoch: int,
                   chkpt_fname: Optional[str] = None,
                   log_every: int = 20) -> bool:
        """Up to ``num_steps`` steps (100 by default), then the weights to
        ``chkpt_fname``; True when the iterator ran out."""
        from image2text_torch.utils.profiling import Throughput, TraceWindow

        cfg = self.config
        num_steps = 100 if cfg.num_steps is None else cfg.num_steps
        stop = False
        meter = Throughput()
        trace = TraceWindow(cfg.profile_dir if epoch == 0 else None)
        for step in range(num_steps):
            trace.step(step)
            try:
                images, labels = next(train_iter)
            except StopIteration:
                stop = True
                break
            metrics = self._train_step(*self._batch(images, labels),
                                       self.seed, self.step)
            self.history.append(metrics)
            self.step += 1
            meter.update(items=int(np.prod(np.shape(labels))))
            if (step + 1) % log_every == 0 or step == num_steps - 1:
                values = {k: float(v) for k, v in metrics.items()}
                print(f"epoch {epoch} step {step + 1}/{num_steps} {values} "
                      f"({meter.steps_per_sec:.2f} steps/s, "
                      f"{meter.items_per_sec:.0f} tok/s)", flush=True)
                if self.logging_callback is not None:
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
    def save_state(self, path: str) -> None:
        """The train state (weights, optimizer, step, seed) into ``path``."""
        from image2text_torch.training.checkpoint import save_train_state

        save_train_state(path, dict(
            wrapper=self.wrapper.state_dict(),
            optimizer=self.optimizer.state_dict(), step=self.step,
            seed=self.seed))

    def restore_state(self, path: str) -> None:
        """The train state :meth:`save_state` wrote into ``path``."""
        from image2text_torch.training.checkpoint import restore_train_state

        state = restore_train_state(path, self.device)
        if state["seed"] != self.seed:
            raise ValueError(f"{path} holds a run of seed {state['seed']}, "
                             f"not {self.seed}")
        self.wrapper.load_state_dict(state["wrapper"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]

    def val_loop(self, val_iter: Iterator, epoch: int):
        """(mean loss, mean metrics) over ``num_val_steps`` batches; the
        values stay on the device until the end."""
        cfg = self.config
        num_steps = 100 if cfg.num_val_steps is None else cfg.num_val_steps
        losses: List[torch.Tensor] = []
        metrics: Dict[str, List[torch.Tensor]] = {}
        for _ in range(num_steps):
            loss, m = self._val_step(*self._batch(*next(val_iter)))
            losses.append(loss)
            for k, v in m.items():
                metrics.setdefault(k, []).append(v)
        return (float(torch.stack(losses).mean()),
                {k: float(torch.stack(v).mean()) for k, v in metrics.items()})


__all__ = ["Trainer", "cast_for_compute", "compute_dtype", "make_train_step",
           "make_val_step"]
