"""The port's mesh (``image2text_torch/parallel/``) on 4 CPU ranks of a
gloo group against the one-process run and against the JAX package's mesh
Trainer.

One module fixture starts the 4 ranks once (``parallel/launch.py``: spawned
processes that import only the port; ``file://`` rendezvous in a temporary
directory; one torch thread a rank) running ``parallel/checks.py::
mesh_checks``, and meanwhile computes here the one-process run and JAX's
dp2×tp2 run on the conftest's virtual CPU devices.  The tiny flagship,
f32, dropout 0.1, masked LM, MoCo and the contrastive loss on, gradient
accumulation 2, AdamW at JAX's 1e-3 (``tests/test_training.py:485``), two
steps:

* losses at rtol 1e-4 (JAX ``tests/test_training.py:273``);
* the first step's gradients within 1e-4 of each tensor's largest value
  (a dropout or corruption slice at a wrong offset, or a wrong reduction,
  shows here);
* whole parameters at rtol 1e-3 / atol 5e-4 (JAX ``:462``: a split sum
  reorders additions), each tensor-parallel shard joined to the
  one-device tensor;
* each parameter's update (after the steps less before them) within
  ``UPDATE_TOL`` of the learning rate of the one-process update, on every
  element whose first-step gradient exceeds ``SURE_GRAD`` of its tensor's
  largest (95% of the elements).  Adam moves an element by about the
  learning rate whatever its gradient's size, so an element whose
  gradient is rounding noise may move either way and is left out; an
  optimizer step that is skipped or a ZeRO-1 slice that is not gathered
  moves the rest by 0 instead of about the learning rate.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.configs.trainer import MeshConfig as JMeshConfig
from image2text_tpu.configs.trainer import OptimizerConfig as JOptimizerConfig
from image2text_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image2text_tpu.parallel.mesh import shard_batch as jax_shard_batch
from image2text_tpu.training.loop import Trainer as JaxTrainer
from image2text_tpu.training.wrapper import ModelTrainerWrapper as JaxWrapper
from image2text_tpu.training.wrapper import TokenizerInfo as JaxTok
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.parallel import checks
from image2text_torch.parallel.launch import Ranks


def _jax_config():
    """JAX's twin of ``checks.tiny_config(dropout=0, mask=0, data=2,
    model=2)``."""
    cfg = _flagship_config(tiny=True)
    for sub in (cfg.model.vision_encoder_config, cfg.model.decoder_config):
        a = sub.transformer_config.attn_config
        a.dropout = a.attn_dropout = 0.0
    t = cfg.trainer
    t.mask_fraction = t.random_mask_fraction = 0.0
    t.moco_momentum, t.moco_alpha = 0.99, 0.4
    t.add_contrastive_loss = True
    cfg.optimizers = [JOptimizerConfig(lr=checks.LR)]
    cfg.use_snr_optim = False
    cfg.precision = "no"
    cfg.batch_size = checks.BATCH
    cfg.gradient_accumulation_steps = 2
    cfg.mesh = JMeshConfig(data=2, model=2)
    return cfg


@pytest.fixture(scope="module")
def runs():
    cfg = _jax_config()
    tok = JaxTok(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                 vocab_size=checks.VOCAB)
    jw = JaxWrapper(cfg.model, tok, cfg.trainer)
    params = jw.init(jax.random.PRNGKey(0))
    weights = {k: np.asarray(v) for k, v in
               export_state_dict(jw.model, params["model"]).items()}
    ranks = Ranks(checks.mesh_checks, 4, weights)
    try:
        data = checks.batches()
        ref = checks.one_process(checks.tiny_config(), data)
        gcfg = checks.tiny_config(dropout=0.0, mask=0.0)
        ref_tokens = checks.greedy_tokens(checks.build(gcfg).model,
                                          data[0][0])
        mesh = jax_make_mesh(cfg.mesh, jax.devices()[:4])
        trainer = JaxTrainer(cfg, jw, params, mesh=mesh)
        jax_metrics = []
        for im, lb in data:
            ims, lbs = jax_shard_batch(mesh, jnp.asarray(im), jnp.asarray(lb))
            trainer.state, m = trainer._train_step(trainer.state, ims, lbs,
                                                   trainer.rng)
            jax_metrics.append({k: float(v) for k, v in m.items()})
    finally:
        mesh_out = ranks.join()[0]
    return dict(ref=ref, ref_tokens=ref_tokens, jax=jax_metrics,
                mesh=mesh_out)


def _assert_metrics(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, ref in want.items():
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


UPDATE_TOL = 1e-2   # of the learning rate; measured worst 2.6e-4
SURE_GRAD = 1e-3    # of a tensor's largest first-step gradient


def _assert_updates(got, want, ref):
    """``got``'s parameter updates against ``want``'s (both from
    ``ref["init"]``) where ``ref``'s first-step gradient is sure."""
    init, grads = ref["init"], ref["grads"]
    sure = total = 0
    for k, g in grads.items():
        g = np.abs(g)
        mask = g > SURE_GRAD * g.max()
        sure, total = sure + int(mask.sum()), total + g.size
        np.testing.assert_allclose((got[k] - init[k])[mask],
                                   (want[k] - init[k])[mask], rtol=0,
                                   atol=UPDATE_TOL * checks.LR, err_msg=k)
    assert sure > 0.9 * total, (sure, total)


def _assert_params(got, want):
    assert set(got) == set(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        if ref.dtype.kind != "f":
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref, rtol=1e-3, atol=5e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["dp4", "dp2tp2", "dp2tp2_sp"])
def test_mesh_steps_equal_the_one_process_steps(runs, name):
    """dp4, dp2×tp2 and dp2×tp2 with sequence parallelism: the losses of
    both steps, the first step's gradients, the parameters after them and
    their updates are the one-process run's."""
    got, ref = runs["mesh"][name], runs["ref"]
    _assert_metrics(got["metrics"], ref["metrics"])
    _assert_grads(got["grads"], ref["grads"])
    _assert_params(got["params"], ref["params"])
    _assert_updates(got["params"], ref["params"], ref)


@pytest.mark.parametrize("name", ["dp4", "dp2tp2"])
def test_mesh_val_step_equals_the_one_process_val_step(runs, name):
    """The val step after the two steps (eval: the blocks' serving path,
    its kernels' operands gathered whole under a model split), averaged
    over the data group: the one-process val losses at rtol 1e-4."""
    _assert_metrics([runs["mesh"][name]["val"]], [runs["ref"]["val"]])


def test_zero1_equals_replicated_and_splits_the_moments(runs):
    """ZeRO-1 on dp2×tp2+SP: the same steps as without it, and each data
    rank holds half of the moments of every tensor ZeRO splits."""
    zero, plain = runs["mesh"]["dp2tp2_sp_zero"], runs["mesh"]["dp2tp2_sp"]
    ref = runs["ref"]
    _assert_metrics(zero["metrics"], plain["metrics"])
    _assert_params(zero["params"], plain["params"])
    _assert_params(zero["params"], ref["params"])
    _assert_updates(zero["params"], plain["params"], ref)
    _assert_updates(zero["params"], ref["params"], ref)
    assert zero["zero_whole_bytes"] > 0
    assert zero["zero_slice_bytes"] * 2 == zero["zero_whole_bytes"]


def test_resume_under_the_mesh_continues_identically(runs):
    """Step, save_state, a fresh model and trainer, restore_state, step on
    dp2×tp2 with SP and ZeRO-1: bit for bit the uninterrupted run (the
    moments, split over the data ranks, restored whole), the restored
    tensor-parallel weights still split."""
    resumed, straight = runs["mesh"]["resume"], runs["mesh"]["dp2tp2_sp_zero"]
    assert resumed["metrics"] == straight["metrics"]
    for k, v in straight["params"].items():
        np.testing.assert_array_equal(resumed["params"][k], v, err_msg=k)
    assert resumed["split_after_restore"] > 0 and resumed["zero"]


def test_generate_under_tp2_gives_the_one_device_tokens(runs):
    """Greedy generate with the weights split over a model axis of 2
    (every eval kernel on its gathered weights): the one-device tokens
    (JAX ``tests/test_generation.py:543``)."""
    np.testing.assert_array_equal(runs["mesh"]["generate"],
                                  runs["ref_tokens"])


def test_mesh_losses_match_the_jax_mesh_trainer(runs):
    """The port's dp2×tp2 steps on JAX's initial weights (dropout and
    masked LM off) against JAX's Trainer on a dp2×tp2 mesh of virtual CPU
    devices: both losses of both steps at rtol 1e-4."""
    got = runs["mesh"]["jax"]["metrics"]
    _assert_metrics([{k: m[k] for k in w} for m, w in zip(got, runs["jax"])],
                    runs["jax"])
