"""The port's training slice (``image2text_torch/training/``) against the
JAX package's on the tiny flagship config: inputs, loss weights, losses,
the optimizers, and whole training steps.

Randomness that the two packages draw differently (mask corruption,
dropout) is either fed to both as the same numpy noise or switched off;
the flash dropout mask itself is bit-equal (``tests/test_torch_flash.py``).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.configs.trainer import OptimizerConfig as JOptimizerConfig
from image2text_tpu.training.loop import TrainState, _value_and_grad_float
from image2text_tpu.training.loop import make_train_step as jax_make_train_step
from image2text_tpu.training.loop import make_val_step as jax_make_val_step
from image2text_tpu.training.optimizer import build_optimizer as jax_build_opt
from image2text_tpu.training.optimizer import (
    assign_param_labels as jax_assign_param_labels, snr_adam)
from image2text_tpu.training.wrapper import (
    ModelTrainerWrapper as JaxWrapper, TokenizerInfo as JaxTok)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.trainer import (OptimizerConfig,
                                              TrainerWrapperConfig,
                                              flagship_training_config)
from image2text_torch.nn.core import Ctx
from image2text_torch.ops import flash_attention as fa
from image2text_torch.ops.fused_block import sparse_block
from image2text_torch.ops.fused_moe import moe_ffn
from image2text_torch.training import optimizer as topt
from image2text_torch.training.loop import (Trainer, make_train_step,
                                            make_val_step)
from image2text_torch.training.wrapper import ModelTrainerWrapper, TokenizerInfo
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)

torch.set_num_threads(2)
VOCAB = 512


def _tok(cls):
    return cls(eos_token_id=0, bos_token_id=1, mask_token_id=2,
               vocab_size=VOCAB)


def _labels(b=3, seq=20, seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    labels = np.full((b, seq), -100 if ignore else 0, np.int64)
    for i, n in enumerate(rng.integers(4, seq - 2, b)):
        labels[i, :n] = rng.integers(3, VOCAB - 1, n)
    labels[0, 2] = 0  # an EOS inside a caption
    return labels


def _pair(trainer_kwargs=None, dropout=0.0, remat=False):
    """A JAX wrapper with initialised params and the port's wrapper on the
    same weights (f32, CPU)."""
    jcfg = _flagship_config(tiny=True)
    tcfg = flagship_training_config(tiny=True)
    for cfg in (jcfg, tcfg):
        for sub in (cfg.model.vision_encoder_config,
                    cfg.model.decoder_config):
            a = sub.transformer_config.attn_config
            a.dropout = a.attn_dropout = dropout
            sub.enable_gradient_checkpointing = remat
        for k, v in (trainer_kwargs or {}).items():
            setattr(cfg.trainer, k, v)
    jw = JaxWrapper(jcfg.model, _tok(JaxTok), jcfg.trainer)
    params = jw.init(jax.random.PRNGKey(0))
    tw = ModelTrainerWrapper(tcfg.model, _tok(TokenizerInfo), tcfg.trainer,
                             device="cpu")
    load_jax_state_dict(tw.model, export_state_dict(jw.model, params["model"]))
    if tw.is_momentum:
        tw.copy_momentum_params()
    return jw, params, tw


def _images(b=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


# -- inputs, weights, losses ---------------------------------------------------

def test_build_inputs_with_the_same_noise():
    kw = dict(mask_fraction=0.5, random_mask_fraction=0.3)
    jw = JaxWrapper(_flagship_config(tiny=True).model, _tok(JaxTok),
                    _flagship_config(tiny=True).trainer.model_copy(update=kw))
    tw = ModelTrainerWrapper(flagship_training_config(tiny=True).model,
                             _tok(TokenizerInfo), TrainerWrapperConfig(**kw),
                             device="cpu")
    labels = _labels()
    rng = jax.random.PRNGKey(3)
    want, want_mask = jw.build_inputs(jnp.asarray(labels), True, rng)
    # the JAX draws, handed to the port
    k1, k2, k3 = jax.random.split(jax.random.fold_in(rng, 17), 3)
    noise = (np.array(jax.random.uniform(k1, labels.shape)),
             np.array(jax.random.uniform(k2, labels.shape)),
             np.array(jax.random.randint(k3, labels.shape, 0, VOCAB,
                                         jnp.int64)))
    got, got_mask = tw.build_inputs(torch.from_numpy(labels), True,
                                    noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert (got.numpy() == 2).any() and (got.numpy() != labels).any()
    # drawn from a seed: same mask token share, EOS fill, BOS in front
    drawn, _ = tw.build_inputs(torch.from_numpy(labels), True, seed=11)
    assert (drawn[:, 0] == 1).all() and (drawn[:, 1:][labels[:, :-1] == -100]
                                         == 0).all()


@pytest.mark.parametrize("weight_fn", ["constant", "inverse_sqrt_position"])
@pytest.mark.parametrize("eos_weight", [None, 0.25])
def test_get_weights_matches_jax(weight_fn, eos_weight):
    kw = dict(weight_fn=weight_fn, eos_token_weight=eos_weight)
    jw = JaxWrapper(_flagship_config(tiny=True).model, _tok(JaxTok),
                    _flagship_config(tiny=True).trainer.model_copy(update=kw))
    tw = ModelTrainerWrapper(flagship_training_config(tiny=True).model,
                             _tok(TokenizerInfo), TrainerWrapperConfig(**kw),
                             device="cpu")
    labels = _labels()
    np.testing.assert_allclose(
        tw.get_weights(torch.from_numpy(labels)).numpy(),
        np.asarray(jw.get_weights(jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["lm", "moco", "contrastive"])
def test_losses_match_jax(kind):
    kw = {"lm": dict(training_temperature=0.7),
          "moco": dict(moco_momentum=0.99, moco_alpha=0.4),
          "contrastive": dict(add_contrastive_loss=True,
                              training_contrastive_temperature=0.5)}[kind]
    jw, params, tw = _pair(kw)
    rng = np.random.default_rng(4)
    labels = _labels(seq=12)
    logits = rng.standard_normal((3, 12, VOCAB)).astype(np.float32)
    if kind == "contrastive":
        hidden = rng.standard_normal((3, 12, 64)).astype(np.float32)
        want = jw.compute_contrastive_loss(params, jnp.asarray(hidden),
                                           jnp.asarray(labels))
        with torch.no_grad():
            got = tw.compute_contrastive_loss(torch.from_numpy(hidden),
                                              torch.from_numpy(labels))
    else:
        moco = (rng.standard_normal((3, 12, VOCAB)).astype(np.float32)
                if kind == "moco" else None)
        want = jw.compute_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  None if moco is None else jnp.asarray(moco))
        got = tw.compute_lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if moco is None
                                 else torch.from_numpy(moco))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- optimizers ----------------------------------------------------------------

def test_param_labels_match_jax_with_groups_and_frozen_paths():
    jw, params, tw = _pair()
    from image2text_tpu.utils.tree import flatten

    groups = [dict(lr=1e-3, target_modules=["*.attn.*", "*experts.1.l1*"]),
              dict(lr=2e-3, target_modules=["decoder.*"])]
    frozen = ["model.decoder.transformer.h.0.ln_1.weight"]
    jpaths = [p for p in flatten(params)
              if p in set(jw.param_specs())]
    want = jax_assign_param_labels(
        jpaths, [JOptimizerConfig(**g) for g in groups], frozen,
        split_specs=jw.split_specs())
    params_t = dict(tw.named_parameters())
    specs = {p: (t, params_t[p].shape[0])
             for p, t in topt.split_specs(tw).items()}
    got = topt.assign_param_labels(list(params_t),
                                   [OptimizerConfig(**g) for g in groups],
                                   frozen, specs)
    assert got == want
    assert {"group_0", "group_1", "frozen"} <= set(got.values())


@pytest.mark.parametrize("use_snr", [True, False])
def test_two_optimizer_steps_match_optax(use_snr):
    """Two steps on fixed gradients, two pattern groups (one with weight
    decay), a frozen path and an unmatched parameter."""
    rng = np.random.default_rng(5)
    shapes = {"model.a.weight": (4, 3), "model.b.bias": (5,),
              "model.c.weight": (2, 2), "model.d.weight": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    grads[1]["model.a.weight"][0] = 0.0
    cfgs = [dict(lr=1e-2, weight_decay=0.1, betas=(0.8, 0.95),
                 target_modules=["a.*", "c.*"]),
            dict(lr=3e-3, target_modules=["b.*"])]
    frozen = ["model.c.weight"]
    labels = jax_assign_param_labels(
        list(shapes), [JOptimizerConfig(**c) for c in cfgs], frozen)
    tx = {"frozen": optax.set_to_zero()}
    for i, c in enumerate(cfgs):
        oc = JOptimizerConfig(**c)
        tx[f"group_{i}"] = (snr_adam(oc.lr, oc.betas, oc.weight_decay)
                            if use_snr else optax.adamw(
                                oc.lr, oc.betas[0], oc.betas[1],
                                weight_decay=oc.weight_decay))
    tx = optax.multi_transform(tx, labels)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.Module()
            for k, v in init.items():
                _, mod, name = k.split(".")
                if not hasattr(self.model, mod):
                    self.model.add_module(mod, torch.nn.Module())
                getattr(self.model, mod).register_parameter(
                    name, torch.nn.Parameter(torch.from_numpy(v.copy())))

    m = M()
    opt, got_labels = topt.build_optimizer(
        m, [OptimizerConfig(**c) for c in cfgs], use_snr=use_snr,
        extra_frozen=frozen)
    assert got_labels == labels
    params = dict(m.named_parameters())
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)


# -- whole training steps --------------------------------------------------------

def _train_batch():
    rng = np.random.default_rng(6)
    labels = np.full((2, 40), -100, np.int64)
    for i, n in enumerate((30, 18)):
        labels[i, :n] = rng.integers(3, VOCAB - 1, n)
    return _images(2, seed=7), labels


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two JAX ``make_train_step`` steps (SNRAdam, f32, dropout and mask
    fractions 0) and the first step's gradients, exported to torch keys."""
    jw, params, tw = _pair()
    images, labels = _train_batch()
    tx, _, _ = jax_build_opt(jw, params, [JOptimizerConfig(lr=6e-4)],
                             use_snr=True)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(jax_make_train_step(jw, tx, precision="no",
                                       use_flash=True))
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        grads = jax.jit(_value_and_grad_float(
            lambda p: jw.train_step(p, jnp.asarray(images),
                                    jnp.asarray(labels), key)))(params)[1]
        out = []
        for _ in range(2):
            state, metrics = step(state, jnp.asarray(images),
                                  jnp.asarray(labels), key)
            out.append((float(metrics["train_loss_lm"]),
                        export_state_dict(jw.model, state.params["model"])))
    return tw, images, labels, export_state_dict(jw.model, grads["model"]), out


def test_two_train_steps_match_jax(jax_two_steps):
    """Loss, every gradient and every parameter after each update.

    Limits: the loss within 1e-4 relative and each gradient within 1e-4
    of its tensor's largest value (f32 with both sides summing in their
    own order; the port's attention is the flash plain version, JAX's the
    XLA path: the same function with dropout off).  Parameters within
    1e-4 relative plus 2e-6 absolute, but for a few elements: SNRAdam
    moves each parameter by about lr·g/(|g| + eps) at its first step, so
    an element whose gradient is zero up to rounding (a key bias, whose
    gradient vanishes exactly, reads ±1e-10 on both sides) moves by up to
    lr either way.  At most 0.1% of all elements may differ so, each by at
    most 2·lr per step taken, and at the first step only where the JAX
    gradient is below 1e-3 of its tensor's largest."""
    tw, images, labels, jgrads, jsteps = jax_two_steps
    lr = 6e-4
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=lr)],
                                  use_snr=True)
    step = make_train_step(tw, opt, precision="no")
    img, lab = torch.from_numpy(images), torch.from_numpy(labels)
    for i, (jloss, jparams) in enumerate(jsteps):
        metrics = step(img, lab, 0, i)
        np.testing.assert_allclose(float(metrics["train_loss_lm"]), jloss,
                                   rtol=1e-4)
        if i == 0:
            _assert_grads_match(state_dict_numpy(tw.model, grads=True),
                                jgrads)
        _assert_params_match(state_dict_numpy(tw.model), jparams,
                             jgrads if i == 0 else None, 2 * lr * (i + 1))


def _assert_grads_match(mine, jgrads):
    """Each gradient within 1e-4 of its JAX tensor's largest value."""
    assert set(mine) <= set(jgrads)
    for k, g in mine.items():
        ref = jgrads[k]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g, ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


def _assert_params_match(got, jparams, jgrads, max_move):
    """Parameters within 1e-4 relative plus 2e-6 absolute but for at most
    0.1% of the elements, each within ``max_move``, and (given the first
    step's ``jgrads``) only where the JAX gradient is below 1e-3 of its
    tensor's largest: see :func:`test_two_train_steps_match_jax`."""
    n_bad = n_all = 0
    for k, ref in jparams.items():
        if got[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
            continue
        bad = ~np.isclose(got[k], ref, rtol=1e-4, atol=2e-6)
        n_bad, n_all = n_bad + int(bad.sum()), n_all + bad.size
        assert np.abs(got[k] - ref).max() <= max_move, k
        if jgrads is not None and bad.any():
            g = np.abs(jgrads[k])
            assert g[bad].max() <= 1e-3 * g.max(), k
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def test_accumulated_step_with_ema_teacher_matches_jax():
    """One step with the gradients of 2 micro-batches averaged and the
    MoCo EMA teacher (momentum 0.9, soft targets at alpha 0.4) against
    JAX ``make_train_step``: the loss, the mean micro-gradient, the
    student after the update and the teacher after its EMA update, with
    the limits of :func:`test_two_train_steps_match_jax` (the teacher
    moves by 1 − momentum of the student's move)."""
    lr = 6e-4
    jw, params, tw = _pair(dict(moco_momentum=0.9, moco_alpha=0.4))
    images, labels = _train_batch()
    tx, _, _ = jax_build_opt(jw, params, [JOptimizerConfig(lr=lr)],
                             use_snr=True)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        state, jm = jax.jit(jax_make_train_step(jw, tx, accum_steps=2))(
            state, jnp.asarray(images), jnp.asarray(labels), key)
        grad_fn = jax.jit(_value_and_grad_float(jw.train_step))
        micro = [grad_fn(params, jnp.asarray(images[i:i + 1]),
                         jnp.asarray(labels[i:i + 1]),
                         jax.random.fold_in(key, i))[1]["model"]
                 for i in range(2)]
    jgrads = export_state_dict(jw.model, jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, *micro))
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=lr)],
                                  use_snr=True)
    metrics = make_train_step(tw, opt, accum_steps=2)(
        torch.from_numpy(images), torch.from_numpy(labels), 0, 0)
    np.testing.assert_allclose(float(metrics["train_loss_lm"]),
                               float(jm["train_loss_lm"]), rtol=1e-4)
    _assert_grads_match(state_dict_numpy(tw.model, grads=True), jgrads)
    for mine, theirs in ((tw.model, "model"), (tw.model_m, "model_m")):
        _assert_params_match(state_dict_numpy(mine), export_state_dict(
            jw.model, state.params[theirs]), jgrads, 2 * lr)


def test_val_step_matches_jax():
    jw, params, tw = _pair()
    images, labels = _train_batch()
    with jax.default_matmul_precision("highest"):
        jloss, jm = jax.jit(jax_make_val_step(jw))(
            params, jnp.asarray(images), jnp.asarray(labels))
    loss, m = make_val_step(tw)(torch.from_numpy(images),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert set(m) == set(jm) == {"val_loss_lm"}


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_val_step_after_train_steps_reads_the_updated_masters(precision):
    """The eval path's packed serving weights follow the masters: after val
    steps have packed them, a train step and another val step give exactly
    the loss of a fresh model loaded with the updated masters.  In bf16 the
    val step runs on transient casts of the masters, which must never be
    served from a cache keyed on their addresses."""
    _, _, tw = _pair()
    images, labels = (torch.from_numpy(a) for a in _train_batch())
    val = make_val_step(tw, precision=precision)
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=6e-4)],
                                  use_snr=True)
    step = make_train_step(tw, opt, precision=precision)
    cfg = flagship_training_config(tiny=True)
    losses = [float(val(images, labels)[0])]
    for i in range(2):
        step(images, labels, 0, i)
        losses.append(float(val(images, labels)[0]))
        fresh = ModelTrainerWrapper(cfg.model, _tok(TokenizerInfo),
                                    cfg.trainer, device="cpu")
        fresh.load_state_dict(tw.state_dict())
        want = make_val_step(fresh, precision=precision)(images, labels)[0]
        assert losses[-1] == float(want), (i, losses, float(want))
    assert len(set(losses)) == 3, losses


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_val_step_packs_serving_weights_only_from_the_masters(
        precision, monkeypatch):
    """The MoE packs of the eval kernels are cached on the module's own f32
    parameters and rebuilt after the optimizer updates them in place; a
    bf16 val step, which runs on fresh casts of the masters, packs anew at
    every call instead of trusting their addresses."""
    from image2text_torch.models import layers

    packs = []
    real = layers.pack_moe_linear
    monkeypatch.setattr(layers, "pack_moe_linear",
                        lambda *a: packs.append(1) or real(*a))
    _, _, tw = _pair()
    images, labels = (torch.from_numpy(a) for a in _train_batch())
    val = make_val_step(tw, precision=precision)
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=6e-4)],
                                  use_snr=True)

    def packs_in(fn):
        packs.clear()
        fn()
        return len(packs)

    n = packs_in(lambda: val(images, labels))
    assert n > 0
    assert packs_in(lambda: val(images, labels)) == (
        0 if precision == "no" else n)
    make_train_step(tw, opt, precision=precision)(images, labels, 0, 0)
    assert packs_in(lambda: val(images, labels)) == n


def test_eval_forward_on_swapped_weights_ignores_reused_addresses():
    """An eval forward through ``functional_call`` on tensors that sit at
    the addresses of an earlier call's, with fresh version counters and
    other values — what the caching allocator hands a val step after a
    train step — computes from the new values: the logits equal those of
    a fresh model loaded with them."""
    from torch.func import functional_call

    from image2text_torch.configs.models import flagship_config
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    def model():
        return VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")

    m = model().init_weights(0)
    arrays = {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
    images = torch.from_numpy(_images(2))
    ids = torch.from_numpy(_train_batch()[1]).clamp(min=0)

    def logits_on(arrays_):
        # torch.from_numpy: a new tensor (version 0) over the same memory
        with torch.no_grad():
            return functional_call(m, {n: torch.from_numpy(a)
                                       for n, a in arrays_.items()},
                                   (images, ids)).logits

    first = logits_on(arrays)
    rng = np.random.default_rng(1)
    for a in arrays.values():
        a += 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
    got = logits_on(arrays)
    ref = model()
    ref.load_state_dict({n: torch.from_numpy(a) for n, a in arrays.items()},
                        strict=False)
    with torch.no_grad():
        want = ref(images, ids).logits
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seq", [8, 40])
def test_self_attention_calls_count_the_training_forward(seq, monkeypatch):
    """``sdpa_calls`` (what the card's launch counts are held to) equals
    the attention calls a training forward makes."""
    from image2text_torch.models import layers

    calls = []
    real = layers.sdpa
    monkeypatch.setattr(layers, "sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, tw = _pair(dropout=0.1)
    images, labels = _train_batch()
    tw(torch.from_numpy(images), torch.from_numpy(labels[:, :seq]), seed=5)
    assert len(calls) == tw.model.sdpa_calls(seq) > 0


def test_trainer_loops_count_steps_and_refuse_unported_remat():
    """``train_loop`` stops when the iterator runs out, ``val_loop``
    averages its batches (bf16 compute, dropout on); a ported remat policy
    tags the model, an unknown one raises."""
    _, _, tw = _pair(dropout=0.1, remat=True)
    cfg = flagship_training_config(tiny=True)
    cfg.num_steps, cfg.num_val_steps, cfg.use_snr_optim = 3, 2, True
    trainer = Trainer(cfg, tw)
    batch = _train_batch()
    assert trainer.train_loop(iter([batch] * 2), epoch=0, log_every=1)
    assert trainer.step == 2
    loss, metrics = trainer.val_loop(iter([batch] * 2), epoch=0)
    assert np.isfinite(loss) and set(metrics) == {"val_loss_lm"}
    cfg.remat_policy = "dots"
    Trainer(cfg, tw)
    assert tw.model.decoder._remat_policy == "dots"
    cfg.remat_policy = "selective"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        Trainer(cfg, tw)


def test_training_forward_runs_no_serving_kernel_wrapper(monkeypatch):
    """Training never calls the eval-only kernels' wrappers (they have no
    backward): the JAX training path runs neither."""
    from image2text_torch.models import layers

    def refuse(*a, **k):
        raise AssertionError("a serving kernel wrapper ran in training")

    monkeypatch.setattr(layers, "sparse_block", refuse)
    monkeypatch.setattr(layers, "moe_ffn", refuse)
    _, _, tw = _pair(dropout=0.1, remat=True)
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=6e-4)],
                                  use_snr=True)
    images, labels = _train_batch()
    counts = (sparse_block.launches, moe_ffn.launches, fa.flash_fwd.launches)
    before = {n: p.detach().clone() for n, p in tw.named_parameters()}
    step = make_train_step(tw, opt, precision="bf16")
    for i in range(2):
        metrics = step(torch.from_numpy(images), torch.from_numpy(labels), 0,
                       i)
        assert np.isfinite(float(metrics["train_loss_lm"]))
        # the bf16 copies never stay in the module: every parameter is
        # still its f32 leaf, and every one the loss reaches was updated
        assert all(isinstance(p, torch.nn.Parameter) and p.is_leaf
                   and p.dtype == torch.float32 for p in tw.parameters())
        assert all(not torch.equal(p, before[n])
                   for n, p in tw.named_parameters()), i
        before = {n: p.detach().clone() for n, p in tw.named_parameters()}
    # CPU tensors: the flash wrappers ran their plain versions
    assert counts == (sparse_block.launches, moe_ffn.launches,
                      fa.flash_fwd.launches)


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_checkpointing_keeps_gradients_with_dropout_on(precision):
    """Per-block recompute draws the same dropout masks: the gradients with
    gradient checkpointing equal those without (bitwise in f32; bf16 within
    its rounding), dropout 0.1 everywhere."""
    images, labels = _train_batch()
    grads = []
    for remat in (False, True):
        _, _, tw = _pair(dropout=0.1, remat=remat)
        from torch.func import functional_call

        from image2text_torch.training.loop import cast_for_compute

        dt = torch.float32 if precision == "no" else torch.bfloat16
        loss, _ = functional_call(tw, cast_for_compute(tw, dt),
                                  (torch.from_numpy(images).to(dt),
                                   torch.from_numpy(labels)),
                                  dict(seed=Ctx(3).fold(1).seed,
                                       backward=True))
        grads.append((float(loss), state_dict_numpy(tw.model, grads=True)))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for k in g0:
        if precision == "no":
            np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
        else:
            np.testing.assert_allclose(g0[k], g1[k], rtol=0, atol=1e-2 * (
                np.abs(g0[k]).max() + 1e-12), err_msg=k)
    assert any(np.abs(g).max() > 0 for g in g0.values())
