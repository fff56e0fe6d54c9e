"""The mesh's checks: what a one-process run and the ranks of a mesh
compute on the same weights and batches, for the tests and the card to
hold against each other: the losses of each step, the first step's
gradients (summed over the data group, a model shard joined whole), the
parameters after the steps, a val step's losses after them, captions.

Two models share the harness, each a :class:`Form`:

* ``flagship``: the tiny flagship (:func:`tiny_config`) with every
  training feature the mesh touches: dropout 0.1, masked LM, MoCo and the
  contrastive loss (``tests/test_torch_parallel.py``); on the card, full
  width and depth 2 (``chip_smoke.py``'s ``[dist-tp]``).
* ``llama``: ``training_configs/tpu/llama2-13b.yaml``'s captioner
  (:func:`llama_config`).  Every projection of its decoder is int4 with
  LoRA on six of its seven (``gate_proj`` has none), so a model split runs
  each of the placement's int4 cases (``sharding_rules`` module
  docstring, 3): q/k/v and gate/up column splits with their rows in two
  halves, o_proj and down_proj row splits on whole byte columns, LoRA A
  whole or cut, LoRA B cut or whole.  The decoder is built from a local
  ``config.json`` of Llama-2-13B's architecture (:func:`llama_arch_file`):
  at full width and a given depth on the card (``[dist-tp-int4]``), or in
  the tiny form of ``tests/test_torch_parallel_int4.py`` (d 128 = 4 heads
  of 32, FFN 256, 2 layers: its int4 row splits exist at tp2), whose ViT
  is the depth-2 backbone on 32² images (``encoder.VIT_B16_ARGS``, the
  hook for a depth-reduced backbone: set by the test, and by each rank).
  Its initialisers leave the int4 weights and LoRA B zero, so
  :func:`build` gives them random values.

:func:`mesh_checks` runs on every rank of a 4-rank gloo group
(``launch.run_ranks``) and returns, from rank 0, each scenario's losses,
whole parameters (gathered: a tensor-parallel shard is joined to the
one-device tensor) and what else it measured:

* the form's ``scenarios``: two steps of gradient accumulation 2 in f32,
  AdamW at JAX's learning rate of 1e-3 (the flagship: ``dp4``,
  ``dp2tp2``, ``dp2tp2_sp``, ``dp2tp2_sp_zero``; Llama: the last two);
* ``resume``: one step on dp2×tp2 with SP and ZeRO-1, ``save_state``
  (the int4 bytes saved whole), a new model and trainer with its
  parameters zeroed, ``restore_state`` (the bytes loaded into shards),
  the second step;
* ``generate``: greedy tokens of a tp2 model (every rank the whole
  batch); Llama also its greedy and sampled beams, checked alike over the
  model group every round, and each rank's int4 bytes;
* ``jax`` (the flagship, given JAX's export): dp2×tp2 on those weights,
  dropout and masked LM off, so JAX's mesh Trainer computes the same
  losses.

On the card, :func:`card_tp_check` runs a list of runs (depth, rows,
precision, the int4 route) on dp1 × tp``world`` with sequence
parallelism over gloo, both ranks on one card, and :func:`card_reference`
the same runs on one device; :func:`card_mesh_step` is the flagship's
step on an NCCL mesh of two or more cards.

:func:`one_process` is the run without a process group.  Every run
records the parameters before its steps (``init``), so the tests hold
each parameter's update, not only its value, against the one-process
run's.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
LLAMA_YAML = str(Path(__file__).resolve().parents[2]
                 / "training_configs/tpu/llama2-13b.yaml")
LLAMA_KEY = "meta-llama/Llama-2-13b-hf"
LLAMA_TINY = dict(n_layer=2, n_embd=128, n_head=4, n_kv_head=4,
                  intermediate=256)
VIT_TINY = dict(image_size=32, num_layers=2)
BEAM = dict(beam_width=3, beam_expansion_factor=4)


@dataclasses.dataclass(frozen=True)
class Form:
    """What differs between the two models the harness runs: their
    tokens, the tiny form's image side, the mesh scenarios, the card's
    caption length and parts, and whether captions run on a bf16 cast
    (the int4 kernel takes bf16 only)."""

    eos: int
    bos: int
    mask: Optional[int]
    image: int
    scenarios: Tuple[Tuple[str, int, int, bool, bool], ...]
    card_seq: int
    card_parts: Tuple[str, ...]
    bf16_captions: bool


SCENARIOS = (("dp4", 4, 1, False, False), ("dp2tp2", 2, 2, False, False),
             ("dp2tp2_sp", 2, 2, True, False),
             ("dp2tp2_sp_zero", 2, 2, True, True))
FORMS = {
    "flagship": Form(0, 1, 2, 64, SCENARIOS, SEQ,
                     ("greedy", "train", "val"), False),
    "llama": Form(2, 1, None, VIT_TINY["image_size"], SCENARIOS[2:], 32,
                  ("greedy", "logits", "beam", "train"), True),
}


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


def llama_arch_file(workdir: str, **arch) -> str:
    """A local HF ``config.json`` (the decoder factory's ``model_str``
    dispatch) of Llama-2-13B's architecture with ``arch``'s fields
    replaced, written once in ``workdir`` (atomically: ranks share it)."""
    from image2text_torch.models.hf_decoders.factory import LLAMA_TABLE

    a = dataclasses.replace(LLAMA_TABLE[LLAMA_KEY], **arch)
    hf = dict(model_type="llama", vocab_size=a.vocab_size,
              num_hidden_layers=a.n_layer, hidden_size=a.n_embd,
              num_attention_heads=a.n_head, num_key_value_heads=a.n_kv_head,
              intermediate_size=a.intermediate,
              max_position_embeddings=a.max_positions,
              rope_theta=a.rope_theta, rms_norm_eps=a.rms_eps,
              tie_word_embeddings=a.tie_embeddings)
    path = os.path.join(workdir, f"llama-{a.n_layer}x{a.n_embd}.json")
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(hf, f)
    os.replace(tmp, path)
    return path


def llama_config(workdir: str, data: int = 1, model: int = 1,
                 sp: bool = False, zero: bool = False,
                 depth: Optional[int] = None, batch: int = BATCH,
                 accum: int = 2, precision: str = "no") -> TrainingConfig:
    """The YAML's captioner (its optimizer groups, its accumulation,
    gradient checkpointing) with AdamW at ``LR`` on every group: the tiny
    form (its ViT head cut to the tiny decoder's width), or with ``depth``
    the full width at ``depth`` layers."""
    from image2text_torch.configs.reader import load_training_config

    cfg = load_training_config(LLAMA_YAML)
    arch = LLAMA_TINY if depth is None else dict(n_layer=depth)
    cfg.model.decoder_config.model_str = llama_arch_file(workdir, **arch)
    if depth is None:
        enc = cfg.model.vision_encoder_config
        enc.n_cls, enc.gate_sizes = 4, (32,)
        enc.n_embd_out_vit = LLAMA_TINY["n_embd"]
    for g in cfg.optimizers:
        g.lr = LR
    cfg.use_snr_optim = False
    cfg.precision = precision
    cfg.batch_size = batch
    cfg.gradient_accumulation_steps = accum
    cfg.mesh = MeshConfig(data=data, model=model)
    cfg.sequence_parallel = sp
    cfg.zero_sharded_optimizer = zero
    return cfg


def tokenizer(vocab: int = VOCAB, form: str = "flagship"):
    from image2text_torch.training.wrapper import TokenizerInfo

    f = FORMS[form]
    return TokenizerInfo(eos_token_id=f.eos, bos_token_id=f.bos,
                         mask_token_id=f.mask, vocab_size=vocab)


def batches(steps: int = STEPS, b: int = BATCH, seed: int = 0,
            image: int = 64, vocab: int = VOCAB,
            seq: int = SEQ) -> List[Tuple]:
    """(images, labels) numpy global batches: labels 4 to seq − 2 tokens
    of ids 3 to vocab − 2, then -100."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        images = rng.standard_normal((b, 3, image, image)).astype(np.float32)
        labels = np.full((b, seq), -100, np.int64)
        for i, n in enumerate(rng.integers(4, seq - 2, b)):
            labels[i, :n] = rng.integers(3, vocab - 1, n)
        out.append((images, labels))
    return out


@torch.no_grad()
def randomize(model, seed: int) -> None:
    """The int4 weights the quantized image of N(0, 0.02) matrices and
    LoRA B N(0, 0.02), so every stage works (a model with neither is left
    as it is)."""
    from image2text_torch.models.quantization import fill_random_int4

    gen = torch.Generator(device=model.device).manual_seed(seed + 100)
    fill_random_int4(model, gen)
    for name, p in model.named_parameters():
        if ".lora_B." in name:
            p.normal_(0.0, 0.02, generator=gen)


def build(cfg: TrainingConfig, weights: Optional[Dict[str, np.ndarray]]
          = None, device="cpu", form: str = "flagship", seed: int = 0):
    """The wrapper on ``device``: ``weights`` (the JAX export's keys), or
    random ones from ``seed`` (:func:`randomize`)."""
    from image2text_torch.training.wrapper import ModelTrainerWrapper
    from image2text_torch.utils.checkpoint import load_jax_state_dict

    w = ModelTrainerWrapper(cfg.model, tokenizer(
        cfg.model.decoder_config.vocab_size, form), cfg.trainer,
        device=device)
    if weights is None:
        w.model.init_weights(seed)
        randomize(w.model, seed)
    else:
        load_jax_state_dict(w.model, weights)
    if w.is_momentum:
        w.copy_momentum_params()
    return w


def snapshot(model, grads: bool = False) -> Dict[str, np.ndarray]:
    """``state_dict_numpy`` copied (its arrays may share the tensors'
    memory, which later steps write)."""
    from image2text_torch.utils.checkpoint import state_dict_numpy

    return {k: v.copy() for k, v in state_dict_numpy(model, grads).items()}


def int4_bytes(model) -> int:
    """Bytes of the int4 packed weights and scales this process holds."""
    from image2text_torch.models.quantization import QuantizedLinear

    return sum(m.weight.numel() * m.weight.element_size()
               + m.weight_scales.numel() * m.weight_scales.element_size()
               for m in model.modules() if isinstance(m, QuantizedLinear))


def _run(cfg, mesh, data, weights=None, form="flagship") -> Dict[str, Any]:
    from image2text_torch.training.loop import Trainer

    w = build(cfg, weights, form=form)
    init = snapshot(w.model)
    tr = Trainer(cfg, w, mesh=mesh)
    metrics, grads = [], None
    for b in data:
        metrics.append({k: float(v) for k, v in tr.train_step(*b).items()})
        if grads is None:   # the first step's averaged, whole gradients
            grads = snapshot(w.model, grads=True)
    loss, val = tr.val_step(*data[0])   # eval: the serving kernels' path
    out = dict(metrics=metrics, init=init, params=snapshot(w.model),
               grads=grads, int4_bytes=int4_bytes(w.model),
               val={"loss": float(loss),
                    **{k: float(v) for k, v in val.items()}})
    if tr.zero is not None:
        out["zero_bytes"] = tr.zero.moment_bytes()
        out["zero_whole_bytes"] = sum(
            2 * p.numel() * 4 for _, p in tr.zero.slices)
        out["zero_slice_bytes"] = sum(
            t.numel() * t.element_size() for s, _ in tr.zero.slices
            for t in tr.zero.state[s].values() if torch.is_tensor(t)
            and t.dim() > 0)
        out["zero_params"] = sorted(
            n for n, p in w.named_parameters()
            if any(p is q for _, q in tr.zero.slices))
    return out


def one_process(cfg: TrainingConfig, data, weights=None,
                form: str = "flagship") -> Dict[str, Any]:
    """The run without a process group (one device)."""
    from image2text_torch.parallel.mesh import make_mesh

    cfg.mesh = MeshConfig()
    return _run(cfg, make_mesh(cfg.mesh), data, weights, form)


def _prompt(model, images: np.ndarray, bos: int):
    dev = model.device
    x = torch.from_numpy(images).to(dev, model.decoder.dtype)
    return x, torch.full((images.shape[0], 1), bos, dtype=torch.long,
                         device=dev)


def greedy_tokens(model, images: np.ndarray, n: int = 4,
                  bos: int = 1) -> np.ndarray:
    """Greedy ids of ``n`` new tokens after a BOS, on the model's device."""
    x, prompt = _prompt(model, images, bos)
    with torch.no_grad():
        ids = model.generate(x, prompt, max_new_tokens=n, temperature=0.0)
    return ids.cpu().numpy()


def first_logits(model, images: np.ndarray, bos: int = 1) -> np.ndarray:
    """The logits of the first new token after a BOS (f32, host)."""
    from image2text_torch.models.generation import prefill

    x, prompt = _prompt(model, images, bos)
    with torch.no_grad():
        logits = prefill(model, model.encoder(x), prompt, 2)[0][:, -1]
    return logits.float().cpu().numpy()


def beam(model, images: np.ndarray, n: int = 5, temperature: float = 0.0,
         form: str = "llama", generator=None) -> Dict[str, Any]:
    """A beam call (width 3, expansion 4; greedy at temperature 0, its
    consolidation greedy too): ids, scores, the rounds and the rounds
    checked alike over the model group."""
    from image2text_torch.models.generation_utils import (
        BeamSearchTokenGenerator)

    f = FORMS[form]
    gen = BeamSearchTokenGenerator(
        model, temperature=temperature, max_new_tokens=n,
        consolidation_temperature=temperature, eos_token_id=f.eos,
        no_repeat_n_grams=model.no_repeat_n_grams, **BEAM)
    x, prompt = _prompt(model, images, f.bos)
    ids, scores = gen(x, prompt, generator=generator)
    return dict(ids=ids.cpu().numpy(), scores=scores.cpu().numpy(),
                rounds=gen.rounds, agreed=gen.agreed)


def mesh_checks(rank: int, world: int, workdir: str,
                weights: Optional[Dict[str, np.ndarray]] = None,
                form: str = "flagship") -> Dict[str, Any]:
    """Every scenario of the module docstring on this rank of a 4-rank
    group: rank 0's results, and every rank's int4 bytes."""
    from image2text_torch.models import encoder
    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.parallel.sharding_rules import place_params
    from image2text_torch.training.checkpoint import restore_train_state
    from image2text_torch.training.loop import Trainer

    assert world == 4
    f = FORMS[form]
    llama = form == "llama"
    if llama:
        encoder.VIT_B16_ARGS = VIT_TINY   # this rank's process only

    def config(dp=1, tp=1, sp=False, zero=False, **kw):
        if llama:
            return llama_config(workdir, dp, tp, sp, zero)
        return tiny_config(data=dp, model=tp, sp=sp, zero=zero, **kw)

    data = batches(image=f.image, vocab=32000 if llama else VOCAB)
    run_weights = weights if llama else None
    out: Dict[str, Any] = {}
    for name, dp, tp, sp, zero in f.scenarios:
        cfg = config(dp, tp, sp, zero)
        out[name] = _run(cfg, make_mesh(cfg.mesh), data, run_weights, form)
    # resume under dp2 x tp2 + SP + ZeRO-1: step, save, a fresh trainer
    # (its parameters zeroed; Llama's int4 bytes seed 0's), restore, step
    cfg = config(2, 2, True, True)
    state_dir = os.path.join(workdir, "state")
    tr = Trainer(cfg, build(cfg, run_weights, form=form),
                 mesh=make_mesh(cfg.mesh))
    first = tr.train_step(*data[0])
    saved = snapshot(tr.wrapper.model)
    tr.save_state(state_dir)
    w2 = build(cfg, form=form)
    with torch.no_grad():
        for p in w2.parameters():
            p.zero_()
    tr2 = Trainer(cfg, w2, mesh=make_mesh(cfg.mesh))
    tr2.restore_state(state_dir)
    restored = snapshot(w2.model)
    second = tr2.train_step(*data[1])
    file_state = restore_train_state(state_dir)["wrapper"]
    split = [n for n, p in w2.named_parameters() if hasattr(p, "_tp")]
    out["resume"] = dict(
        metrics=[{k: float(v) for k, v in m.items()}
                 for m in (first, second)],
        saved=saved, restored=restored, params=snapshot(w2.model),
        split_after_restore=len(split), zero=tr2.zero is not None,
        file_shapes={k: tuple(v.shape) for k, v in file_state.items()
                     if v.dtype == torch.uint8})
    # captions under tp2 (every rank the whole batch)
    cfg = config(2, 2, dropout=0.0, mask=0.0) if not llama else config(2, 2)
    w = build(cfg, run_weights, form=form)
    place_params(w, make_mesh(cfg.mesh))
    images = data[0][0]
    out["generate"] = greedy_tokens(w.model, images, bos=f.bos)
    out["bytes"] = int4_bytes(w.model)
    if llama:
        out["beam"] = beam(w.model, images)
        out["beam_sampled"] = beam(w.model, images, temperature=1.0)
    # against JAX's mesh Trainer: its weights, dropout and masked LM off
    if weights is not None and not llama:
        cfg = tiny_config(dropout=0.0, mask=0.0, data=2, model=2)
        out["jax"] = _run(cfg, make_mesh(cfg.mesh), data, weights)
    return out if rank == 0 else {"bytes": out["bytes"]}


# -- the card ---------------------------------------------------------------

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


def card_config(form: str, workdir: str, depth: int = 2, batch: int = 8,
                precision: str = "bf16") -> TrainingConfig:
    """The card's config: the flagship's (its own bf16), or the Llama
    YAML at full width and ``depth`` layers in ``precision`` with its
    SNRAdam and optimizer groups, ``batch`` rows in one micro-batch."""
    if form == "flagship":
        return card_flagship_config(depth, batch)
    cfg = llama_config(workdir, depth=depth, batch=batch, accum=1,
                       precision=precision)
    cfg.use_snr_optim = True
    return cfg


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


def _adapter_grads(w) -> Dict[str, np.ndarray]:
    """Each LoRA adapter's gradient after the step, whole."""
    from image2text_torch.parallel.collectives import gather_whole

    out = {}
    for n, p in w.model.named_parameters():
        if (".lora_A." in n or ".lora_B." in n) and p.grad is not None:
            g = p.grad.detach()
            if getattr(p, "_tp", None) is not None:
                g = gather_whole(g, p._tp_axis, *p._tp)
            out[n] = g.float().cpu().numpy()
    return out


def _card_run(cfg: TrainingConfig, mesh, device: str, form: str,
              n_gen: int, n_new: int, plain: bool = False) -> Dict[str, Any]:
    """The form's card parts on one global batch (seed 5), each with its
    ms and kernel launches.  First the captions of the initial weights on
    ``n_gen`` images of distinct means (so that their captions differ):
    ``greedy`` (``n_new`` greedy tokens), ``logits`` (the first new
    token's) and ``beam`` (a greedy beam call); where the form captions in
    bf16 and the config trains in it, on the model cast to bf16 (and back
    to f32 after).  Then ``train`` (a step; then the adapters' whole
    gradients) and ``val`` (a val step).  The captions come first because
    Adam moves an element whose gradient is rounding noise by about the
    learning rate either way: after a step, captions would show the step's
    rounding, not the forward's.  ``plain``: the int4 product's plain
    version in place of the kernel (the f32 form, which the kernel does
    not take, or a calibration)."""
    from image2text_torch.models.quantization import QuantizedLinear
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops import int4_matmul as int4_ops
    from image2text_torch.ops.fused_block import fused_block, sparse_block
    from image2text_torch.ops.fused_moe import moe_ffn
    from image2text_torch.training.loop import Trainer

    f = FORMS[form]
    w = build(cfg, device=device, form=form)
    tr = Trainer(cfg, w, mesh=mesh)
    enc = cfg.model.vision_encoder_config
    images, labels = batches(
        1, cfg.batch_size, seed=5,
        image=enc.input.width if hasattr(enc, "input") else 224,
        vocab=cfg.model.decoder_config.vocab_size, seq=f.card_seq)[0]
    gen = images[:n_gen] + np.arange(n_gen, dtype=np.float32)[
        :, None, None, None]
    parts = {"train": lambda: tr.train_step(images, labels),
             "val": lambda: tr.val_step(images, labels),
             "greedy": lambda: greedy_tokens(w.model, gen, n_new, f.bos),
             "logits": lambda: first_logits(w.model, gen, f.bos),
             "beam": lambda: beam(w.model, gen, n_new, form=form)}
    captions = [p for p in ("greedy", "logits", "beam") if p in f.card_parts]
    order = captions + [p for p in ("train", "val") if p in f.card_parts]
    cast = f.bf16_captions and cfg.precision == "bf16"
    kernel = int4_ops.int4_matmul
    kernels = (sparse_block, fused_block, moe_ffn, fa.flash_fwd, fa.flash_bwd,
               kernel)
    cuda = torch.device(device).type == "cuda"
    out: Dict[str, Any] = {}
    if plain:
        int4_ops.int4_matmul = int4_ops.int4_matmul_plain
    try:
        for part in order:
            if cast and part in ("greedy", "train"):
                w.model.to(torch.bfloat16 if part == "greedy"
                           else torch.float32)
            for k in kernels:
                k.launches = 0
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = parts[part]()
            if cuda:
                torch.cuda.synchronize(device)
            out[part] = dict(ms=(time.perf_counter() - t0) * 1e3,
                             launches={k.__name__: k.launches
                                       for k in kernels})
            if part == "train":
                out[part]["result"] = {k: float(v) for k, v in res.items()}
                out["adapter_grads"] = _adapter_grads(w)
            elif part == "val":
                out[part]["result"] = {"loss": float(res[0]), **{
                    k: float(v) for k, v in res[1].items()}}
            else:
                out[part]["result"] = res
    finally:
        int4_ops.int4_matmul = kernel
    out["int4_shapes"] = sorted(   # (in_pad, out) of this rank's weights
        {(2 * m.weight.shape[1], m.weight.shape[0])
         for m in w.model.modules() if isinstance(m, QuantizedLinear)})
    out["int4_bytes"] = int4_bytes(w.model)
    out["resident"] = torch.cuda.memory_allocated(device) if cuda else 0
    out["mesh"] = repr(tr.mesh)
    return out


def exact_products() -> None:
    """TF32 off and no reduced-precision bf16 reductions, as
    ``chip_smoke.py`` sets them in its own process: a spawned rank starts
    with PyTorch's defaults (cuDNN's TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


CARD_RUN = dict(depth=2, batch=8, n_gen=4, n_new=4, precision="bf16",
                plain=False)


def _card_runs(workdir, form, runs, device, mesh_of) -> List[Dict]:
    out = []
    for run in runs:
        r = {**CARD_RUN, **run}
        cfg = card_config(form, workdir, r["depth"], r["batch"],
                          r["precision"])
        out.append(_card_run(cfg, mesh_of(cfg), device, form, r["n_gen"],
                             r["n_new"], r["plain"]))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def card_tp_check(rank: int, world: int, workdir: str,
                  form: str = "flagship",
                  runs: Sequence[dict] = ({},)) -> List[Dict[str, Any]]:
    """One rank of dp1 × tp``world`` with sequence parallelism on the card
    over gloo (ranks share a card where there are fewer cards than
    ranks): each of ``runs`` (``CARD_RUN``'s fields: depth, rows, caption
    images and tokens, precision, the int4 route) through
    :func:`_card_run`, one after the other.  The weights are split over
    the model axis, so the step runs the collectives between ranks, flash
    on each rank's heads (its dropout planes offset), the int4 product on
    each rank's shards and, at eval, the serving kernels on gathered
    weights.  Rank 0's results; the other ranks' int4 and resident
    bytes."""
    from image2text_torch.parallel.mesh import make_mesh

    device = f"cuda:{rank % torch.cuda.device_count()}"
    torch.cuda.set_device(device)
    exact_products()

    def mesh_of(cfg):
        cfg.mesh = MeshConfig(data=1, model=world)
        cfg.sequence_parallel = True
        return make_mesh(cfg.mesh, "cpu")

    out = _card_runs(workdir, form, runs, device, mesh_of)
    return out if rank == 0 else [
        {k: o[k] for k in ("int4_bytes", "resident")} for o in out]


def card_reference(form: str = "flagship",
                   runs: Sequence[dict] = ({},)) -> List[Dict[str, Any]]:
    """:func:`card_tp_check`'s runs on one card without a process group."""
    exact_products()
    with tempfile.TemporaryDirectory(prefix="i2t-card-") as workdir:
        return _card_runs(workdir, form, runs, "cuda", lambda cfg: None)


__all__ = ["BATCH", "BEAM", "CARD_RUN", "FORMS", "Form", "LLAMA_KEY",
           "LLAMA_TINY", "LLAMA_YAML", "LR", "SCENARIOS", "VIT_TINY",
           "batches", "beam", "build", "card_config", "card_flagship_config",
           "card_mesh_step", "card_reference", "card_tp_check",
           "first_logits", "greedy_tokens", "int4_bytes", "llama_arch_file",
           "llama_config", "mesh_checks", "one_process", "randomize",
           "snapshot", "tiny_config", "tokenizer"]
