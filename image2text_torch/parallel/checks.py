"""The mesh's checks on the tiny flagship: what a one-process run and the
ranks of a mesh compute on the same batches, for the tests
(``tests/test_torch_parallel.py``) to hold against each other: the
losses of each step, the first step's gradients (summed over the data
group, a model shard joined whole), the parameters after the steps and a
val step's losses after them.

:func:`mesh_checks` runs on every rank of a 4-rank gloo group
(``launch.run_ranks``) and returns, from rank 0, each scenario's losses,
whole parameters (gathered: a tensor-parallel shard is joined to the
one-device tensor) and what else it measured:

* ``dp4``, ``dp2tp2``, ``dp2tp2_sp``, ``dp2tp2_sp_zero``: two steps with
  dropout 0.1, masked LM, MoCo and the contrastive loss on, gradient
  accumulation 2, f32, AdamW;
* ``resume``: one step on dp2×tp2 with SP and ZeRO-1, ``save_state``, a
  new model and trainer, ``restore_state``, the second step;
* ``generate``: greedy tokens of a tp2 model (every rank the whole batch);
* ``jax``: dp2×tp2 on weights given in JAX's export (dropout and masked
  LM off, so JAX's mesh Trainer computes the same losses).

On the card (``chip_smoke.py``'s ``[dist]``), :func:`card_tp_check` runs
the flagship at full width and depth 2 on dp1 × tp2 over gloo, both
ranks on one card, and :func:`card_reference` the same run on one
device; :func:`card_mesh_step` is the step on an NCCL mesh of two or more
cards.

:func:`one_process` is the same run without a process group.  The
optimizer is AdamW at JAX's learning rate of 1e-3.  Every run records
the parameters before its steps (``init``), so the tests hold each
parameter's update, not only its value, against the one-process run's.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from image2text_torch.configs.trainer import (MeshConfig, OptimizerConfig,
                                              TrainingConfig,
                                              flagship_training_config)

VOCAB = 512
BATCH = 8
SEQ = 24
STEPS = 2
LR = 1e-3


def tiny_config(dropout: float = 0.1, mask: float = 0.15,
                data: int = 1, model: int = 1, sp: bool = False,
                zero: bool = False, accum: int = 2) -> TrainingConfig:
    """The tiny flagship with every training feature the mesh touches."""
    cfg = flagship_training_config(tiny=True)
    for sub in (cfg.model.vision_encoder_config, cfg.model.decoder_config):
        a = sub.transformer_config.attn_config
        a.dropout = a.attn_dropout = dropout
    t = cfg.trainer
    t.mask_fraction, t.random_mask_fraction = mask, 0.2 if mask else 0.0
    t.moco_momentum, t.moco_alpha = 0.99, 0.4
    t.add_contrastive_loss = True
    cfg.optimizers = [OptimizerConfig(lr=LR)]
    cfg.use_snr_optim = False
    cfg.precision = "no"
    cfg.batch_size = BATCH
    cfg.gradient_accumulation_steps = accum
    cfg.mesh = MeshConfig(data=data, model=model)
    cfg.sequence_parallel = sp
    cfg.zero_sharded_optimizer = zero
    return cfg


def tokenizer(vocab: int = VOCAB):
    from image2text_torch.training.wrapper import TokenizerInfo

    return TokenizerInfo(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                         vocab_size=vocab)


def batches(steps: int = STEPS, b: int = BATCH, seed: int = 0,
            image: int = 64, vocab: int = VOCAB) -> List[Tuple]:
    """(images, labels) numpy global batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        images = rng.standard_normal((b, 3, image, image)).astype(np.float32)
        labels = np.full((b, SEQ), -100, np.int64)
        for i, n in enumerate(rng.integers(4, SEQ - 2, b)):
            labels[i, :n] = rng.integers(3, vocab - 1, n)
        out.append((images, labels))
    return out


def build(cfg: TrainingConfig, weights: Optional[Dict[str, np.ndarray]]
          = None, device="cpu"):
    """The wrapper, initialised from seed 0 or from ``weights`` (the JAX
    export's keys)."""
    from image2text_torch.training.wrapper import ModelTrainerWrapper
    from image2text_torch.utils.checkpoint import load_jax_state_dict

    w = ModelTrainerWrapper(cfg.model, tokenizer(
        cfg.model.decoder_config.vocab_size), cfg.trainer, device=device)
    if weights is None:
        return w.init_weights(0)
    load_jax_state_dict(w.model, weights)
    w.copy_momentum_params()
    return w


def _run(cfg, mesh, data, weights=None) -> Dict[str, Any]:
    from image2text_torch.training.loop import Trainer
    from image2text_torch.utils.checkpoint import state_dict_numpy

    w = build(cfg, weights)
    init = state_dict_numpy(w.model)
    tr = Trainer(cfg, w, mesh=mesh)
    metrics, grads = [], None
    for b in data:
        metrics.append({k: float(v) for k, v in tr.train_step(*b).items()})
        if grads is None:   # the first step's averaged, whole gradients
            grads = state_dict_numpy(w.model, grads=True)
    loss, val = tr.val_step(*data[0])   # eval: the serving kernels' path
    out = dict(metrics=metrics, init=init, params=state_dict_numpy(w.model),
               grads=grads, val={"loss": float(loss),
                                 **{k: float(v) for k, v in val.items()}})
    if tr.zero is not None:
        out["zero_bytes"] = tr.zero.moment_bytes()
        out["zero_whole_bytes"] = sum(
            2 * p.numel() * 4 for _, p in tr.zero.slices)
        out["zero_slice_bytes"] = sum(
            t.numel() * t.element_size() for s, _ in tr.zero.slices
            for t in tr.zero.state[s].values() if torch.is_tensor(t)
            and t.dim() > 0)
    return out


def one_process(cfg: TrainingConfig, data, weights=None) -> Dict[str, Any]:
    """The run without a process group (one device)."""
    from image2text_torch.parallel.mesh import make_mesh

    cfg.mesh = MeshConfig()
    return _run(cfg, make_mesh(cfg.mesh), data, weights)


def greedy_tokens(model, images: np.ndarray, n: int = 4) -> np.ndarray:
    """Greedy ids of ``n`` new tokens after a BOS, on the model's device."""
    dev = model.device
    prompt = torch.ones(images.shape[0], 1, dtype=torch.long, device=dev)
    with torch.no_grad():
        ids = model.generate(torch.from_numpy(images).to(dev), prompt,
                             max_new_tokens=n, temperature=0.0)
    return ids.cpu().numpy()


SCENARIOS = (("dp4", 4, 1, False, False), ("dp2tp2", 2, 2, False, False),
             ("dp2tp2_sp", 2, 2, True, False),
             ("dp2tp2_sp_zero", 2, 2, True, True))


def mesh_checks(rank: int, world: int, workdir: str,
                jax_weights: Optional[Dict[str, np.ndarray]] = None
                ) -> Dict[str, Any]:
    """Every scenario of the module docstring on this rank of a 4-rank
    group; rank 0's results (the others return nothing)."""
    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.parallel.sharding_rules import place_params
    from image2text_torch.training.loop import Trainer

    assert world == 4
    data = batches()
    out: Dict[str, Any] = {}
    for name, dp, tp, sp, zero in SCENARIOS:
        cfg = tiny_config(data=dp, model=tp, sp=sp, zero=zero)
        out[name] = _run(cfg, make_mesh(cfg.mesh), data)
    # resume under dp2 x tp2 + SP + ZeRO-1: step, save, a fresh trainer,
    # restore, step
    cfg = tiny_config(data=2, model=2, sp=True, zero=True)
    state_dir = os.path.join(workdir, "state")
    tr = Trainer(cfg, build(cfg), mesh=make_mesh(cfg.mesh))
    first = tr.train_step(*data[0])
    tr.save_state(state_dir)
    w2 = build(cfg)
    with torch.no_grad():
        for p in w2.parameters():
            p.zero_()
    tr2 = Trainer(cfg, w2, mesh=make_mesh(cfg.mesh))
    tr2.restore_state(state_dir)
    second = tr2.train_step(*data[1])
    from image2text_torch.utils.checkpoint import state_dict_numpy

    split = [n for n, p in w2.named_parameters() if hasattr(p, "_tp")]
    out["resume"] = dict(
        metrics=[{k: float(v) for k, v in m.items()}
                 for m in (first, second)],
        params=state_dict_numpy(w2.model), split_after_restore=len(split),
        zero=tr2.zero is not None)
    # greedy generate under tp2 (every rank the whole batch)
    cfg = tiny_config(dropout=0.0, mask=0.0, data=2, model=2)
    w = build(cfg)
    place_params(w, make_mesh(cfg.mesh))
    out["generate"] = greedy_tokens(w.model, data[0][0])
    # against JAX's mesh Trainer: its weights, dropout and masked LM off
    if jax_weights is not None:
        cfg = tiny_config(dropout=0.0, mask=0.0, data=2, model=2)
        out["jax"] = _run(cfg, make_mesh(cfg.mesh), data, jax_weights)
    return out if rank == 0 else {}


def card_mesh_step(rank: int, world: int, workdir: str,
                   depth: int = 2, batch: int = 8) -> Dict[str, Any]:
    """One rank of the flagship step (full width, ``depth`` layers, bf16,
    SNRAdam, dropout on) on the NCCL mesh of every card, laid out as
    ``graft_entry.dryrun_multichip`` lays out its ranks; the step's
    metrics from rank 0."""
    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.training.loop import Trainer

    cfg = card_flagship_config(depth, batch)
    tp = 2 if world % 2 == 0 and world >= 4 else 1
    cfg.mesh = MeshConfig(data=world // tp, model=tp)
    cfg.zero_sharded_optimizer = world // tp > 1
    cfg.sequence_parallel = tp > 1
    w = build(cfg, device=f"cuda:{rank}")
    tr = Trainer(cfg, w, mesh=make_mesh(cfg.mesh, "cuda"))
    images, labels = batches(1, batch, seed=5, image=128,
                             vocab=cfg.model.decoder_config.vocab_size)[0]
    m = {k: float(v) for k, v in tr.train_step(images, labels).items()}
    return dict(metrics=m, mesh=(world // tp, tp)) if rank == 0 else {}


def _launches(run):
    """({kernel wrapper: launches} over ``run()``, its result) for the
    wrappers of the flagship's training and eval paths."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.fused_block import fused_block, sparse_block
    from image2text_torch.ops.fused_moe import moe_ffn

    kernels = (sparse_block, fused_block, moe_ffn, fa.flash_fwd, fa.flash_bwd)
    for k in kernels:
        k.launches = 0
    out = run()
    return {k.__name__: k.launches for k in kernels}, out


def _card_run(cfg: TrainingConfig, mesh, device: str,
              n_gen: int) -> Dict[str, Any]:
    """A train step and a val step on one global batch, then greedy
    generate on ``n_gen`` of its images, each with its kernel launches."""
    from image2text_torch.training.loop import Trainer

    w = build(cfg, device=device)
    tr = Trainer(cfg, w, mesh=mesh)
    images, labels = batches(
        1, cfg.batch_size, seed=5,
        image=cfg.model.vision_encoder_config.input.width,
        vocab=cfg.model.decoder_config.vocab_size)[0]
    train_n, m = _launches(lambda: tr.train_step(images, labels))
    val_n, (loss, val) = _launches(lambda: tr.val_step(images, labels))
    gen_n, tokens = _launches(lambda: greedy_tokens(w.model,
                                                    images[:n_gen]))
    return dict(train={k: float(v) for k, v in m.items()},
                val={"loss": float(loss),
                     **{k: float(v) for k, v in val.items()}},
                tokens=tokens, mesh=repr(tr.mesh),
                launches=dict(train=train_n, val=val_n, generate=gen_n))


def card_tp_check(rank: int, world: int, workdir: str, depth: int = 2,
                  batch: int = 8, n_gen: int = 4) -> Dict[str, Any]:
    """One rank of a dp1 × tp``world`` mesh with sequence parallelism on
    the card over gloo (ranks share a card where there are fewer cards
    than ranks): the flagship at full width and ``depth`` layers (bf16,
    SNRAdam, dropout 0.1, masked LM) through :func:`_card_run`.  The
    weights are split over the model axis, so the step runs the
    collectives between ranks, flash on each rank's heads (its dropout
    planes offset) and, at eval, the serving kernels on the gathered
    weights.  Rank 0's results; :func:`card_reference` is the one-device
    run."""
    from image2text_torch.parallel.mesh import make_mesh

    device = f"cuda:{rank % torch.cuda.device_count()}"
    torch.cuda.set_device(device)
    cfg = card_flagship_config(depth, batch)
    cfg.mesh = MeshConfig(data=1, model=world)
    cfg.sequence_parallel = True
    out = _card_run(cfg, make_mesh(cfg.mesh, "cpu"), device, n_gen)
    return out if rank == 0 else {}


def card_reference(depth: int = 2, batch: int = 8,
                   n_gen: int = 4) -> Dict[str, Any]:
    """:func:`card_tp_check`'s run on one card without a process group."""
    return _card_run(card_flagship_config(depth, batch), None, "cuda", n_gen)


def card_flagship_config(depth: int, batch: int) -> TrainingConfig:
    """The flagship's training config (bf16, SNRAdam, masked LM) at
    ``depth`` layers and ``batch`` rows."""
    cfg = flagship_training_config()
    cfg.model.vision_encoder_config.n_layer = depth
    cfg.model.decoder_config.n_layer = depth
    cfg.use_snr_optim = True
    cfg.trainer.mask_fraction, cfg.trainer.random_mask_fraction = 0.15, 0.2
    cfg.batch_size = batch
    return cfg


__all__ = ["BATCH", "LR", "SCENARIOS", "batches", "build",
           "card_flagship_config", "card_mesh_step", "card_reference",
           "card_tp_check", "greedy_tokens", "mesh_checks", "one_process",
           "tiny_config", "tokenizer"]
