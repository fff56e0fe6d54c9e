"""LoRA on the pretrained ViT and on the GPT-2-initialised scratch decoder
against the JAX package (``encoder_from_config`` / ``decoder_from_config``
vs JAX's ``Encoder.from_config`` / ``Decoder.from_config``), on the tiny
pairs of ``tests/torch_nano_pairs.py`` with a ``lora_spec`` set in both
configs (r 4, alpha 8, adapter dropout 0):

* ``vit``: ``local/gpt2.yaml``'s PretrainedViT (``refine_base_model``
  True), LoRA on the backbone's ``self_attention.out_proj``, ``mlp.0`` and
  ``mlp.3``; ``vit-frozen``: the same with ``refine_base_model`` False;
* ``decoder``: ``tpu/nano.yaml``'s GPT-2-initialised decoder, LoRA on its
  blocks' ``c_attn``, ``c_proj`` and ``c_fc``;
* ``scratch``: ``local/nano-mini.yaml``'s from-scratch decoder with a
  ``lora_spec``, which both packages ignore.

Limits: the state-dict keys equal; eval logits at ``tests/
test_torch_model.py``'s limits (atol 2e-4, rtol 1e-4) and greedy ids
equal; one training step (an optimizer group on ``*lora*``, everything
else frozen) in f32, JAX at ``highest`` precision: the loss within 1e-5
relative and each trainable gradient within 1e-5 of its tensor's largest
value.  ``vit-frozen`` shows JAX's quirk, kept: the backbone's output is
stop-gradiented, so its adapters get no gradient (and are frozen).
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.models import LoraSpec as JLoraSpec
from image2text_tpu.configs.trainer import OptimizerConfig as JOptimizer
from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.training.loop import TrainState
from image2text_tpu.training.loop import make_train_step as jax_make_train_step
from image2text_tpu.training.wrapper import ModelTrainerWrapper as JaxWrapper
from image2text_tpu.training.wrapper import TokenizerInfo as JaxTok
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import LoraSpec
from image2text_torch.configs.reader import load_training_config
from image2text_torch.configs.trainer import OptimizerConfig
from image2text_torch.models.lora import LoRALinear
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.training.loop import Trainer
from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                               TokenizerInfo)
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)

import torch_nano_pairs as npairs
from test_torch_family_training import (_keep_grads, _no_dropout,
                                        _zero_dropout_rates)

torch.set_num_threads(2)
TOL = 1e-5
SEQ = 16
# case → (the pairs' config name, where the spec goes, its targets,
# refine_base_model)
CASES = {
    "vit": ("gpt2", "encoder", ["out_proj", "mlp.0", "mlp.3"], True),
    "vit-frozen": ("gpt2", "encoder", ["out_proj", "mlp.0", "mlp.3"], False),
    "decoder": ("nano", "decoder", ["c_attn", "c_proj", "c_fc"], None),
    "scratch": ("nano-mini", "decoder", ["c_attn"], None),
}
EOS_BOS = {"gpt2": (50256, 50256), "nano": (50256, 50256),
           "nano-mini": (0, 1)}


def _configs(case):
    """(JAX config, port config) of a case, cut and without dropout."""
    name, where, targets, refine = CASES[case]
    with open(npairs.CONFIGS[name]) as f:
        jcfg = JTrainingConfig.model_validate(yaml.safe_load(f))
    tcfg = load_training_config(npairs.CONFIGS[name])
    for cfg, spec in ((jcfg, JLoraSpec), (tcfg, LoraSpec)):
        npairs.cut(cfg, name)
        _no_dropout(cfg.model)
        sub = (cfg.model.vision_encoder_config if where == "encoder"
               else cfg.model.decoder_config)
        sub.lora_spec = spec(r=4, lora_alpha=8, lora_dropout=0.0,
                             target_modules=targets)
        if refine is not None:
            cfg.model.vision_encoder_config.refine_base_model = refine
        cfg.precision = "no"
        cfg.use_snr_optim = False
        cfg.gradient_accumulation_steps = 1
        cfg.batch_size = 2
    jcfg.optimizers = [JOptimizer(lr=1e-3, target_modules=["*lora*"])]
    tcfg.optimizers = [OptimizerConfig(lr=1e-3, target_modules=["*lora*"])]
    return jcfg, tcfg


def _lora_b(params, seed=3):
    return npairs._lora_b(params, seed)


@pytest.fixture(scope="module")
def pair(request):
    """(case, JAX wrapper, its params, port wrapper, port config, JAX
    config) on the same weights."""
    case = request.param
    name = CASES[case][0]
    eos, bos = EOS_BOS[name]
    with npairs.patched():
        jcfg, tcfg = _configs(case)
        vocab = jcfg.model.decoder_config.vocab_size
        jw = JaxWrapper(jcfg.model, JaxTok(eos_token_id=eos, bos_token_id=bos,
                                           vocab_size=vocab), jcfg.trainer)
        if name == "gpt2":
            jw.model.decoder._load_weights = False
        params = jw.init(jax.random.PRNGKey(0))
        params = dict(params, model=_lora_b(params["model"]))
        tw = ModelTrainerWrapper(tcfg.model, TokenizerInfo(
            eos_token_id=eos, bos_token_id=bos, vocab_size=vocab),
            tcfg.trainer, device="cpu")
    _zero_dropout_rates(jw.model.walk())
    _zero_dropout_rates(tw.modules())
    load_jax_state_dict(tw.model, export_state_dict(jw.model, params["model"]))
    return case, jw, params, tw, tcfg, jcfg


ADAPTED = ["vit", "vit-frozen", "decoder"]


@pytest.mark.parametrize("pair", list(CASES), indirect=True)
def test_lora_state_dict_keys_are_jaxs(pair):
    """The adapters sit where JAX puts them (``...lora_A.weight``); a
    from-scratch decoder's ``lora_spec`` is ignored by both."""
    case, jw, params, tw, _, _ = pair
    want = set(export_state_dict(jw.model, params["model"]))
    got = set(state_dict_numpy(tw.model))
    assert got == want
    adapters = [k for k in got if ".lora_A." in k]
    if case == "scratch":
        assert not adapters
    else:
        part = "encoder." if case.startswith("vit") else "decoder."
        assert any(k.startswith(part) for k in adapters)


def _images(n=2):
    return npairs.images(b=n, seed=5)


@pytest.mark.parametrize("pair", ADAPTED, indirect=True)
def test_lora_logits_and_greedy_ids_are_jaxs(pair):
    case, jw, params, tw, _, _ = pair
    jm, tm = jw.model, tw.model
    img = _images()
    ids = np.random.default_rng(1).integers(3, 500, (2, 8))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(params["model"], jnp.asarray(img),
                             jnp.asarray(ids)).logits)
        jids = np.asarray(jm.generate(
            params["model"], jnp.asarray(img), jnp.ones((2, 1), jnp.int32)
            * EOS_BOS[CASES[case][0]][1], max_new_tokens=4,
            temperature=0.0))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(ids)).logits
        tids = tm.generate(torch.from_numpy(img), torch.full(
            (2, 1), EOS_BOS[CASES[case][0]][1]), max_new_tokens=4,
            temperature=0.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(tids.numpy(), jids)


@pytest.mark.parametrize("pair", ADAPTED, indirect=True)
def test_lora_training_step_gradients_are_jaxs(pair):
    """One step, the ``*lora*`` group trained and the rest frozen: loss
    and gradients as JAX's; with ``refine_base_model`` False the
    backbone's adapters get no gradient in either package."""
    case, jw, params, tw, tcfg, jcfg = pair
    vocab = npairs.vocab(tw.model) if case == "decoder" else \
        tw.model.decoder._embed().weight.shape[0]
    rng = np.random.default_rng(4)
    images = _images()
    labels = np.full((2, SEQ), -100, np.int64)
    for i, k in enumerate(rng.integers(6, SEQ - 2, 2)):
        labels[i, :k] = rng.integers(3, vocab - 1, k)
    tx = _keep_grads()
    step = jax.jit(jax_make_train_step(jw, tx, 1, "no"))
    with jax.default_matmul_precision("highest"):
        state, metrics = step(
            TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)),
            jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(0))
    jgrads = export_state_dict(jw.model, state.opt_state["model"])
    trainer = Trainer(tcfg, tw)
    m = trainer._train_step(torch.from_numpy(images),
                            torch.from_numpy(labels), 0, 0)
    np.testing.assert_allclose(float(m["train_loss_lm"]),
                               float(metrics["train_loss_lm"]), rtol=TOL)
    named = dict(tw.model.named_parameters())
    trainable = {k for k, p in named.items() if p.requires_grad}
    assert trainable and all("lora_" in k for k in trainable)
    grads = state_dict_numpy(tw.model, grads=True)
    for k in trainable:
        ref = np.asarray(jgrads[k])
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(grads[k], ref, rtol=0, atol=TOL * scale,
                                   err_msg=k)
    backbone = [k for k in named if k.startswith("encoder.model.")
                and ".lora_" in k]
    if case.startswith("vit"):
        assert backbone
    if case == "vit-frozen":
        frozen = set(frozen_param_paths(tw.model))
        assert set(backbone) <= frozen
        for k in backbone:
            assert not np.asarray(jgrads[k]).any(), k
            assert named[k].grad is None, k
    elif case == "vit":
        assert any(np.abs(grads[k]).max() > 0 for k in backbone)


def test_standalone_decoder_lora_init_draws_jaxs_distributions():
    """The port's GPT-2-initialised decoder with LoRA, initialised alone:
    the wrapped bases keep the GPT-2 policy (weights N(0, 0.02), a
    ``c_proj`` weight N(0, 0.02/sqrt(2 n_layer)), zero biases), the
    adapters A U(±1/sqrt(in)) and B zero — as JAX's wrapper, which keeps
    its bases' owner class for that policy."""
    with npairs.patched():
        _, tcfg = _configs("decoder")
    tcfg.model.decoder_config.n_layer = 8
    tcfg.model.decoder_config.transformer_config.attn_config.n_embd = 256
    tm = VisionEncoderDecoder(tcfg.model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    from image2text_torch.nn.core import init_parameters

    init_parameters(tm.decoder, gen)
    lins = {p: m for p, m in tm.decoder.named_modules()
            if isinstance(m, LoRALinear)}
    assert lins
    proj_std = 0.02 / np.sqrt(2 * 8)
    for path, m in lins.items():
        std = proj_std if path.endswith("c_proj") else 0.02
        w = m.weight.detach()
        assert abs(float(w.std()) / std - 1) < 0.05, path
        assert not m.bias.any(), path
        a, b = m.lora_A.weight.detach(), m.lora_B.weight.detach()
        assert float(a.abs().max()) <= 1 / np.sqrt(a.shape[1]), path
        assert float(a.std()) > 0.5 / np.sqrt(3 * a.shape[1]), path
        assert not b.any(), path
