"""Entry points of the port (counterpart of ``__graft_entry__.py``).

* :func:`entry` — the flagship forward (the
  ``training_configs/tpu/nano-mini.yaml`` architecture) with example
  inputs, on the card unless the caller asks for the CPU.
* :func:`dryrun_multichip` — ``n`` ranks of a gloo group on the CPU,
  spawned by the port itself (``parallel/launch.py``), running the two
  phases of JAX's dry run: the tiny flagship on a dp×tp mesh (MoCo,
  masked LM, SNRAdam, gradient accumulation 2, bf16), then the flagship's
  widths (1024d, 8 heads, MoE, sparse, 50,258 tokens) at depth 2 on
  dp2×tp2 with ZeRO-1 and sequence parallelism: a train step, a val step,
  a 4-token generate and a checkpoint save.  The lines it prints are
  JAX's.  It is a CPU run: it holds the mesh's multi-rank code to the
  same steps where one card is all there is.  ``GRAFT_DRYRUN_FULL_DEPTH``
  restores the flagship's depth, as in JAX.

Run: ``python -m image2text_torch.graft_entry [n]`` (default 4).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def _flagship_training_config(tiny: bool = False):
    from image2text_torch.configs.trainer import flagship_training_config

    cfg = flagship_training_config(tiny=tiny)
    if tiny:
        cfg.model.vision_encoder_config.enable_gradient_checkpointing = False
        cfg.model.decoder_config.enable_gradient_checkpointing = False
    return cfg


def entry(device=None):
    """(forward, example args): ``forward(images, ids)`` is the flagship's
    logits, random weights from seed 0, on ``device`` (the card by
    default)."""
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = _flagship_training_config(tiny=False)
    model = VisionEncoderDecoder(cfg.model, device=dev).init_weights(0)

    @torch.no_grad()
    def forward(images, ids):
        return model(images, ids).logits

    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.standard_normal((2, 3, 128, 128)),
                             dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.integers(
        0, cfg.model.decoder_config.vocab_size, (2, 32)), device=dev)
    return forward, (images, ids)


def _dryrun_rank(rank: int, world: int, workdir: str, t0: float) -> dict:
    """One rank of :func:`dryrun_multichip`; rank 0 prints."""
    from image2text_torch.configs.trainer import MeshConfig
    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    def el() -> str:
        return f"[t+{time.perf_counter() - t0:.0f}s]"

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    n = world
    cfg = _flagship_training_config(tiny=True)
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    cfg.mesh = MeshConfig(data=n // tp, model=tp)
    cfg.batch_size = 2 * (n // tp)
    cfg.gradient_accumulation_steps = 2
    cfg.trainer.moco_momentum = 0.99
    cfg.trainer.moco_alpha = 0.4
    cfg.trainer.mask_fraction = 0.15
    cfg.trainer.random_mask_fraction = 0.2
    cfg.use_snr_optim = True
    cfg.precision = "bf16"
    tok = TokenizerInfo(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                        vocab_size=cfg.model.decoder_config.vocab_size)
    wrapper = ModelTrainerWrapper(cfg.model, tok, cfg.trainer,
                                  device="cpu").init_weights(0)
    trainer = Trainer(cfg, wrapper, mesh=make_mesh(cfg.mesh))
    rng = np.random.default_rng(0)
    b = cfg.batch_size
    images = rng.standard_normal((b, 3, 64, 64)).astype(np.float32)
    labels = np.full((b, 24), -100, np.int64)
    for i, k in enumerate(rng.integers(4, 20, b)):
        labels[i, :k] = rng.integers(3, 500, k)
    metrics = trainer.train_step(images, labels)
    loss = float(metrics["train_loss_lm"])
    assert np.isfinite(loss), metrics
    say(f"dryrun_multichip({n}) tiny OK {el()}: "
        f"mesh=dp{n // tp}xtp{tp} train_loss_lm={loss:.4f}")

    # flagship widths at depth 2: dp2 x tp2 with ZeRO-1 and SP
    fcfg = _flagship_training_config(tiny=False)
    if not os.environ.get("GRAFT_DRYRUN_FULL_DEPTH"):
        fcfg.model.vision_encoder_config.n_layer = 2
        fcfg.model.decoder_config.n_layer = 2
    fdp = 2 if n >= 2 * tp else 1
    group = fdp * tp
    fcfg.mesh = MeshConfig(data=fdp, model=tp)
    fcfg.zero_sharded_optimizer = fdp > 1
    fcfg.sequence_parallel = tp > 1
    fcfg.batch_size = fdp
    fcfg.gradient_accumulation_steps = 1
    fcfg.precision = "bf16"
    # the flagship phase on the first fdp·tp ranks (every rank builds
    # their mesh; only they use it)
    from image2text_torch.parallel.mesh import Mesh

    fmesh = Mesh(fdp, tp, rank, "cpu", ranks=list(range(group)))
    out = (_flagship_phase(rank, n, fcfg, fmesh, say, el, rng)
           if rank < group else {})
    torch.distributed.barrier()
    say(f"dryrun_multichip({n}) OK {el()}: tiny=dp{n // tp}xtp{tp} "
        f"flagship-dims=dp{fdp}xtp{tp}+zero1+sp "
        "train/val/generate/checkpoint all pass")
    return out


def _flagship_phase(rank, n, fcfg, mesh, say, el, rng) -> dict:
    import tempfile

    from image2text_torch.parallel.mesh import shard_batch
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)
    from image2text_torch.utils.checkpoint import load_state_dict

    fwrapper = ModelTrainerWrapper(fcfg.model, TokenizerInfo(
        eos_token_id=0, bos_token_id=1, mask_token_id=2,
        vocab_size=fcfg.model.decoder_config.vocab_size), fcfg.trainer,
        device="cpu").init_weights(1)
    say(f"dryrun_multichip({n}) flagship init {el()}")
    ftrainer = Trainer(fcfg, fwrapper, mesh=mesh)
    say(f"dryrun_multichip({n}) flagship setup {el()}")
    b, seq = fcfg.batch_size, 24
    images = rng.standard_normal((b, 3, 128, 128)).astype(np.float32)
    labels = np.full((b, seq), -100, np.int64)
    for i, k in enumerate(rng.integers(6, seq - 2, b)):
        labels[i, :k] = rng.integers(3, 50000, k)
    fmetrics = ftrainer.train_step(images, labels)
    floss = float(fmetrics["train_loss_lm"])
    assert np.isfinite(floss), fmetrics
    depth = fcfg.model.decoder_config.n_layer
    say(f"dryrun_multichip({n}) flagship-dims train OK {el()}: "
        f"{depth}L/1024d/8h/MoE/sparse/50258v train_loss_lm={floss:.4f}")
    vloss, vmetrics = ftrainer.val_step(images, labels)
    assert np.isfinite(float(vloss)), vmetrics
    say(f"dryrun_multichip({n}) flagship val OK {el()}: "
        f"val_loss={float(vloss):.4f}")
    mine = torch.from_numpy(shard_batch(ftrainer.mesh, images))
    model = fwrapper.model
    with torch.no_grad():
        gen = model.generate(mine, torch.ones(mine.shape[0], 1, dtype=torch.long),
                             max_new_tokens=4, temperature=0.7, top_k=8,
                             generator=torch.Generator().manual_seed(0))
    assert tuple(gen.shape) == (mine.shape[0], 5), gen.shape
    say(f"dryrun_multichip({n}) flagship generate OK {el()}: "
        f"{tuple(gen.shape)}")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "flagship.npz")
        # every rank gathers its shards; rank 0 writes
        from image2text_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(model, path)
        keys = len(load_state_dict(path)) if rank == 0 else 0
    assert rank != 0 or keys > 100, keys
    return dict(train_loss_lm=floss, val_loss=float(vloss))


def dryrun_multichip(n_devices: int = 4) -> list:
    """Both phases on ``n_devices`` gloo ranks on the CPU; what each rank
    returned."""
    from image2text_torch.parallel.launch import run_ranks

    return run_ranks(_dryrun_rank, n_devices, time.perf_counter())


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
