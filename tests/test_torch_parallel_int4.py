"""The model split of int4 + LoRA Linears on 4 CPU gloo ranks against the
one-process run and against the JAX package: ``training_configs/tpu/
llama2-13b.yaml``'s captioner in its tiny form
(``parallel/checks.py``'s Llama form: Llama-2's multi-head attention at d 128,
4 heads of 32, FFN 256, 2 layers; the ViT at depth 2 on 32² images), f32,
AdamW at 1e-3 on the YAML's optimizer groups, gradient accumulation 2,
two steps.

One module fixture builds the JAX pair's weights (its int4 weights the
quantized image of N(0, 0.02) matrices, LoRA B N(0, 0.02)), starts the 4
ranks of ``checks.mesh_checks`` on the Llama form and meanwhile runs here the
one-process port run, JAX's dp2 × tp2 mesh Trainer on the conftest's
virtual CPU devices (its losses) and JAX's ``make_train_step`` on that
mesh (its first step's gradients).

Limits: losses at rtol 1e-4 and gradients within 1e-4 of each tensor's
largest value, parameters at rtol 1e-3 / atol 5e-4 and updates within
1e-2 of the learning rate where the gradient is sure
(``tests/test_torch_parallel.py``'s); JAX at its mesh test's limits.
"""
import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.trainer import MeshConfig as JMeshConfig
from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models import encoder as jenc
from image2text_tpu.models.hf_decoders import factory as jfactory
from image2text_tpu.parallel import sharding_rules as jrules
from image2text_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image2text_tpu.parallel.mesh import shard_batch as jax_shard_batch
from image2text_tpu.training.loop import TrainState
from image2text_tpu.training.loop import Trainer as JaxTrainer
from image2text_tpu.training.loop import make_train_step as jax_make_train_step
from image2text_tpu.training.wrapper import ModelTrainerWrapper as JaxWrapper
from image2text_tpu.training.wrapper import TokenizerInfo as JaxTok
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.models import encoder as tenc
from image2text_torch.parallel import checks
from image2text_torch.parallel.launch import Ranks

import torch_hf_pairs as hp
from test_torch_parallel import (SURE_GRAD, UPDATE_TOL, _assert_grads,
                                 _assert_metrics, _assert_params)

torch.set_num_threads(2)


LLAMA = checks.FORMS["llama"]


def _jax_config():
    """JAX's twin of ``checks.llama_config(workdir, 2, 2)``."""
    with open(checks.LLAMA_YAML) as f:
        cfg = JTrainingConfig.model_validate(yaml.safe_load(f))
    enc = cfg.model.vision_encoder_config
    enc.n_cls, enc.gate_sizes = 4, (32,)
    enc.n_embd_out_vit = checks.LLAMA_TINY["n_embd"]
    for g in cfg.optimizers:
        g.lr = checks.LR
    cfg.use_snr_optim = False
    cfg.precision = "no"
    cfg.batch_size = checks.BATCH
    cfg.gradient_accumulation_steps = 2
    cfg.mesh = JMeshConfig(data=2, model=2)
    return cfg


def _keep_grads():
    """An optax transform whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_runs(data):
    """(the exported weights, JAX's mesh Trainer losses, JAX's first-step
    gradients on the mesh)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "VIT_B16_ARGS", checks.VIT_TINY)
        t = jfactory.LLAMA_TABLE
        mp.setitem(t, checks.LLAMA_KEY,
                   hp._tiny_entry(t[checks.LLAMA_KEY], checks.LLAMA_TINY))
        mp.setattr(jfactory, "load_hf_weights", lambda dec, params: params)
        cfg = _jax_config()
        jw = JaxWrapper(cfg.model, JaxTok(eos_token_id=LLAMA.eos,
                                          bos_token_id=LLAMA.bos,
                                          vocab_size=32000), cfg.trainer)
        jw.model.decoder._load_weights = False
        params = jw.init(jax.random.PRNGKey(0))
        params = dict(params, model=hp.randomize(params["model"], 1))
    weights = {k: np.asarray(v) for k, v in
               export_state_dict(jw.model, params["model"]).items()}
    mesh = jax_make_mesh(cfg.mesh, jax.devices()[:4])
    tx = _keep_grads()
    step = jax.jit(jax_make_train_step(jw, tx, 2, "no"))
    placed = jrules.place_params(params, mesh)
    with jax.default_matmul_precision("highest"):
        ims, lbs = jax_shard_batch(mesh, jnp.asarray(data[0][0]),
                                   jnp.asarray(data[0][1]))
        state, _ = step(TrainState(placed, tx.init(placed),
                                   jnp.zeros((), jnp.int32)),
                        ims, lbs, jax.random.PRNGKey(0))
        grads = {k: np.asarray(v) for k, v in export_state_dict(
            jw.model, state.opt_state["model"]).items()}
        trainer = JaxTrainer(cfg, jw, params, mesh=mesh)
        metrics = []
        for im, lb in data:
            ims, lbs = jax_shard_batch(mesh, jnp.asarray(im), jnp.asarray(lb))
            trainer.state, m = trainer._train_step(trainer.state, ims, lbs,
                                                   trainer.rng)
            metrics.append({k: float(v) for k, v in m.items()})
    return weights, metrics, grads


def _assert_updates(got, ref):
    """``got``'s updates against the one-process run's on the trainable
    tensors (those with a gradient), where the gradient is sure."""
    init, grads = ref["init"], ref["grads"]
    sure = total = 0
    for k, g in grads.items():
        g = np.abs(g)
        if g.max() == 0:
            np.testing.assert_array_equal(got[k], init[k], err_msg=k)
            continue
        mask = g > SURE_GRAD * g.max()
        sure, total = sure + int(mask.sum()), total + g.size
        np.testing.assert_allclose((got[k] - init[k])[mask],
                                   (ref["params"][k] - init[k])[mask],
                                   rtol=0, atol=UPDATE_TOL * checks.LR,
                                   err_msg=k)
    assert sure > 0.9 * total, (sure, total)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = checks.batches(image=LLAMA.image, vocab=32000)
    weights, jax_metrics, jax_grads = _jax_runs(data)
    ranks = Ranks(checks.mesh_checks, 4, weights, "llama")
    workdir = str(tmp_path_factory.mktemp("llama"))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tenc, "VIT_B16_ARGS", checks.VIT_TINY)
            ref = checks.one_process(checks.llama_config(workdir), data,
                                     weights, "llama")
            w = checks.build(checks.llama_config(workdir), weights,
                             form="llama")
            images = data[0][0]
            ref_greedy = checks.greedy_tokens(w.model, images, bos=LLAMA.bos)
            ref_beam = checks.beam(w.model, images)
    finally:
        got = ranks.join()
    return dict(ref=ref, greedy=ref_greedy, beam=ref_beam, mesh=got[0],
                ranks=got, jax=jax_metrics, jax_grads=jax_grads)


@pytest.mark.parametrize("name", [s[0] for s in LLAMA.scenarios])
def test_int4_mesh_steps_equal_the_one_process_steps(runs, name):
    """dp2 × tp2 with SP (and ZeRO-1): both steps' losses, the first
    step's adapter and head gradients, the parameters after the steps
    (the int4 bytes bit for bit: frozen) and their updates are the
    one-process run's."""
    got, ref = runs["mesh"][name], runs["ref"]
    _assert_metrics(got["metrics"], ref["metrics"])
    _assert_grads(got["grads"], ref["grads"])
    _assert_params(got["params"], ref["params"])
    _assert_updates(got["params"], ref)


def test_int4_mesh_matches_the_jax_mesh(runs):
    """The port's dp2 × tp2 + SP steps against JAX on a dp2 × tp2 mesh of
    virtual CPU devices: the mesh Trainer's losses of both steps, and the
    first step's gradient of every trainable tensor (JAX's
    ``make_train_step`` on the mesh), within 1e-4 of its largest."""
    got = runs["mesh"]["dp2tp2_sp"]
    _assert_metrics([{k: m[k] for k in w} for m, w in
                     zip(got["metrics"], runs["jax"])], runs["jax"])
    trainable = [k for k, g in runs["ref"]["grads"].items()
                 if np.abs(g).max() > 0]
    assert any(".lora_A." in k for k in trainable)
    for k in trainable:
        ref = runs["jax_grads"][k]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got["grads"][k], ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_zero1_leaves_the_int4_tensors_alone(runs):
    """ZeRO-1 slices no int4 byte buffer, no frozen scale and no split
    adapter: only whole float tensors it may cut."""
    zero = runs["mesh"]["dp2tp2_sp_zero"]["zero_params"]
    assert zero
    assert not any(k.endswith(("weight_scales", "lora_A.weight",
                               "lora_B.weight")) and ".layers." in k
                   for k in zero)


def test_each_rank_holds_half_the_int4_bytes(runs):
    """Every rank of the tp2 split holds half of the packed bytes and
    scales of one device."""
    whole = runs["ref"]["int4_bytes"]
    assert [r["bytes"] for r in runs["ranks"]] == [whole // 2] * 4
    assert runs["mesh"]["dp2tp2_sp"]["int4_bytes"] * 2 == whole


def test_int4_train_state_round_trips_whole(runs):
    """save_state writes the int4 bytes whole (one device's shapes);
    restore_state loads them back into shards: the restored weights are
    the saved ones bit for bit, and the next step is the uninterrupted
    run's."""
    r = runs["mesh"]["resume"]
    assert r["file_shapes"]
    for k, shape in r["file_shapes"].items():
        assert shape == runs["ref"]["params"][k[len("model."):]].shape, k
    for k, v in r["saved"].items():
        np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)
    _assert_metrics(r["metrics"], runs["mesh"]["dp2tp2_sp_zero"]["metrics"])


def test_captions_under_tp2_are_one_devices(runs):
    """Greedy tokens and greedy beam ids with the int4 + LoRA weights split
    over tp2 equal one device's; the beams were checked alike over the
    model group every round, the sampled beams too (one seed for the
    group)."""
    m = runs["mesh"]
    np.testing.assert_array_equal(m["generate"], runs["greedy"])
    assert len({tuple(row) for row in runs["greedy"][:, 1:]}) > 1
    np.testing.assert_array_equal(m["beam"]["ids"], runs["beam"]["ids"])
    np.testing.assert_allclose(m["beam"]["scores"], runs["beam"]["scores"],
                               rtol=1e-4)
    for b in (m["beam"], m["beam_sampled"]):
        assert b["rounds"] > 0 and b["agreed"] == b["rounds"]
