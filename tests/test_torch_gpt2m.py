"""The port's int4 + LoRA GPT-2 captioner (``gpt2-medium.yaml``) against
the JAX package's, at a tiny size: the encoder cut as the tiny flagship's,
the GPT-2 table entry patched (in this test, in both packages) to 2
layers of width 128 with 4 heads.

JAX initialises packed int4 weights and scales, and LoRA B, to zero, which
would make the int4 products and the adapters vanish; so the JAX weights
get the quantized image of N(0, 0.02) float matrices (the import path's
own step) and random LoRA B, and cross to the port by ``export_state_dict``
→ ``load_jax_state_dict``.  f32 on the CPU, JAX at full matmul precision.
GPT-2's dropout (fixed at 0.1 in both packages) is switched off where the
two would draw different masks.
"""
import dataclasses
import enum

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.trainer import (OptimizerConfig as JOptimizerConfig,
                                            TrainingConfig as JTrainingConfig)
from image2text_tpu.models.generation import decoder_step as jax_decoder_step
from image2text_tpu.models.hf_decoders import factory as jfactory
from image2text_tpu.ops.int4_matmul import quantize_pack_int4
from image2text_tpu.training.loop import (TrainState, _value_and_grad_float,
                                          make_train_step as jax_make_train_step)
from image2text_tpu.training.optimizer import build_optimizer as jax_build_opt
from image2text_tpu.training.wrapper import (ModelTrainerWrapper as JaxWrapper,
                                             TokenizerInfo as JaxTok)
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten, unflatten

from image2text_torch.configs.trainer import (OptimizerConfig,
                                              gpt2_medium_training_config)
from image2text_torch.models.generation import decoder_step, prefill
from image2text_torch.models.hf_decoders import factory
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.ops.int4_matmul import int4_matmul
from image2text_torch.training import optimizer as topt
from image2text_torch.training.loop import make_train_step
from image2text_torch.training.wrapper import ModelTrainerWrapper, TokenizerInfo
from image2text_torch.utils.checkpoint import (SELECTION_BUFFERS,
                                               load_jax_state_dict,
                                               state_dict_numpy)

torch.set_num_threads(2)
TINY_GPT2 = dict(n_layer=2, n_embd=128, n_head=4)
VOCAB = 50257
LR = 6e-4


def _jax_config():
    """``gpt2-medium.yaml`` read by the JAX package, cut as the port's
    ``gpt2_medium_training_config(tiny=True)``, dropout off."""
    with open("training_configs/tpu/gpt2-medium.yaml") as f:
        cfg = JTrainingConfig.model_validate(yaml.safe_load(f))
    enc = cfg.model.vision_encoder_config
    enc.n_layer, enc.n_cls = 2, 8
    enc.input.width = enc.input.height = 64
    enc.num_patches = 8
    enc.transformer_config.attn_config.n_embd = 64
    enc.transformer_config.attn_config.n_head = 4
    enc.transformer_config.max_block_size = 80
    enc.enable_gradient_checkpointing = False
    cfg.model.decoder_config.enable_gradient_checkpointing = False
    return cfg


def _no_dropout(cfg):
    a = cfg.model.vision_encoder_config.transformer_config.attn_config
    a.dropout = a.attn_dropout = 0.0
    cfg.model.decoder_config.lora_spec.lora_dropout = 0.0
    return cfg


def _randomize(params, seed=0):
    """Int4 weights quantized from N(0, 0.02) matrices, LoRA B N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    flat = flatten(params)
    for k, v in list(flat.items()):
        if v.dtype == jnp.uint8:
            w = rng.standard_normal((v.shape[0], 2 * v.shape[1])) * 0.02
            q, s = quantize_pack_int4(w.astype(np.float32))
            flat[k], flat[k + "_scales"] = jnp.asarray(q), jnp.asarray(s)
        elif ".lora_B." in k:
            flat[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.02,
                                  jnp.float32)
    return unflatten(flat)


def _tok(cls):
    return cls(eos_token_id=50256, bos_token_id=50256, mask_token_id=None,
               vocab_size=VOCAB)


@pytest.fixture(scope="module")
def pair():
    """(JAX wrapper, its params, the port's wrapper on the same weights)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jfactory.GPT2_TABLE, "gpt2-medium", TINY_GPT2)
        mp.setitem(factory.GPT2_TABLE, "gpt2-medium", TINY_GPT2)
        # random weights: never fetch pretrained ones
        mp.setattr(jfactory, "load_hf_weights", lambda dec, params: params)
        jcfg = _no_dropout(_jax_config())
        tcfg = _no_dropout(gpt2_medium_training_config(tiny=True))
        jw = JaxWrapper(jcfg.model, _tok(JaxTok), jcfg.trainer)
        jw.model.decoder._load_weights = False
        tw = ModelTrainerWrapper(tcfg.model, _tok(TokenizerInfo),
                                 tcfg.trainer, device="cpu")
        params = jw.init(jax.random.PRNGKey(0))
    for mod in jw.model.walk():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    for mod in tw.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    params = {"model": _randomize(params["model"])}
    sd = export_state_dict(jw.model, params["model"])
    load_jax_state_dict(tw.model, sd)
    return jw, params, tw, sd


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def _ids(b=2, t=10, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


def test_state_dict_keys_shapes_and_dtypes_match_jax(pair):
    """Same keys, shapes, dtypes and values both ways: the packed uint8
    weights, their scales, the adapters, the float cross-attention and
    the tied ``lm_head.weight`` alias."""
    _, _, tw, sd = pair
    mine = state_dict_numpy(tw.model)
    assert set(mine) == set(sd)
    key = "decoder.transformer.h.0.attn.c_attn"
    assert sd[key + ".weight"].dtype == np.uint8
    assert sd[key + ".weight"].shape == (384, 64)
    assert sd[key + ".weight_scales"].shape == (384, 2)
    assert "decoder.lm_head.weight" in sd
    assert "decoder.transformer.h.1.crossattention.c_attn.lora_A.weight" in sd
    for k, v in sd.items():
        # the selection index buffers are the port's own (int64 there)
        assert mine[k].shape == v.shape and (
            mine[k].dtype == v.dtype
            or k.rsplit(".", 1)[-1] in SELECTION_BUFFERS), k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


def test_frozen_param_paths_match_jax(pair):
    jw, _, tw, _ = pair
    want = set(jw.frozen_param_paths())
    got = set(frozen_param_paths(tw))
    assert got == want
    assert "model.decoder.transformer.h.0.mlp.c_fc.weight" in got
    assert not any("lora_" in p or "crossattention" in p or ".wte." in p
                   for p in got)
    # the trainable/frozen split is the wrapper's requires_grad
    for name, p in tw.named_parameters():
        assert p.requires_grad == (name not in got), name


def test_full_forward_logits_match_jax(pair):
    jw, params, tw, _ = pair
    img, ids = _images(), _ids()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, d: jw.model(p, i, d).logits)(
            params["model"], jnp.asarray(img), jnp.asarray(ids)))
    before = int4_matmul.launches
    with torch.no_grad():
        out = tw.model(torch.from_numpy(img), torch.from_numpy(ids)).logits
    assert int4_matmul.launches == before   # CPU: the plain version
    assert out.shape == (2, 10, VOCAB + 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_cached_decode_logits_match_jax(pair):
    """Prefix-in-decode prefill of [encoder output; 6 prompt ids] at
    position 0 against JAX's cached prefill; then 4 single-token steps
    against the full forward (held against JAX's above: the HF decoder is
    plain-causal, so cached and full agree)."""
    jw, params, tw, _ = pair
    jm, jp = jw.model, params["model"]
    img, ids = _images(), _ids()
    off = tw.model.space_for_prompt
    def jax_prefill(jp, img, prompt):
        enc = jm.encoder(jp["encoder"], img)
        cache = jm.decoder.init_cache(2, off + 10, jnp.float32)
        embeds = jnp.concatenate([enc, jm.decoder.get_inputs_embeds(
            jp["decoder"], prompt)], axis=-2)
        return jax_decoder_step(jm, jp, None, cache, 0, enc,
                                inputs_embeds=embeds)[0]

    with jax.default_matmul_precision("highest"):
        jpre = jax.jit(jax_prefill)(jp, jnp.asarray(img),
                                    jnp.asarray(ids[:, :6]))
    with torch.no_grad():
        tids = torch.from_numpy(ids)
        full = tw.model(torch.from_numpy(img), tids).logits.numpy()
        tenc = tw.model.encoder(torch.from_numpy(img))
        pre, cache = prefill(tw.model, tenc, tids[:, :6], 10)
        kv = tw.model.decoder.precompute_cross_kv(tenc)
        steps = [decoder_step(tw.model, tids[:, i:i + 1], cache, off + i,
                              tenc, kv)[0] for i in range(6, 10)]
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), atol=2e-4,
                               rtol=1e-4)
    cached = torch.cat([pre[:, off:]] + steps, 1).numpy()
    np.testing.assert_allclose(cached, full, atol=2e-4, rtol=1e-4)


def test_greedy_generate_token_for_token(pair):
    """Greedy, n-grams 2–5, 8 new tokens, 2 images: JAX ``generate``'s
    ids exactly."""
    jw, params, tw, _ = pair
    img = _images(seed=10)
    prompt = np.full((2, 1), 50256, np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jw.model.generate(
            params["model"], jnp.asarray(img), jnp.asarray(prompt),
            max_new_tokens=8, temperature=0.0, rng=jax.random.PRNGKey(0)))
    out = tw.model.generate(torch.from_numpy(img),
                            torch.from_numpy(prompt).long(),
                            max_new_tokens=8, temperature=0.0).numpy()
    assert out.shape == (2, 9)
    np.testing.assert_array_equal(out, ref)


def test_soft_prompt_bias_is_ignored_by_the_gpt2_decoder(pair):
    """A quirk both packages keep: the HF decoder ignores ``attn_msk``, so
    under soft prompting the composite model's -inf text→prefix bias is
    dropped and text rows attend the image prefix through the causal
    mask."""
    jw, params, tw, _ = pair
    rng = np.random.default_rng(5)
    e = rng.standard_normal((2, 14, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 8, 128)).astype(np.float32)
    bias = np.zeros((1, 1, 14, 14), np.float32)
    bias[..., 8:, :8] = -np.inf
    jdec, jp = jw.model.decoder, params["model"]["decoder"]
    with jax.default_matmul_precision("highest"):
        j = [np.asarray(jdec(jp, inputs_embeds=jnp.asarray(e),
                             cross_attn_embeds=jnp.asarray(enc),
                             attn_msk=m, use_flash=False)[0])
             for m in (jnp.asarray(bias), None)]
    with torch.no_grad():
        t = [tw.model.decoder(inputs_embeds=torch.from_numpy(e),
                              cross_attn_embeds=torch.from_numpy(enc),
                              attn_msk=m)[0].numpy()
             for m in (torch.from_numpy(bias), None)]
    np.testing.assert_array_equal(j[0], j[1])
    np.testing.assert_array_equal(t[0], t[1])
    np.testing.assert_allclose(t[0], j[0], atol=2e-4, rtol=1e-4)


def _train_batch():
    rng = np.random.default_rng(6)
    labels = np.full((2, 16), -100, np.int64)
    for i, n in enumerate((12, 7)):
        labels[i, :n] = rng.integers(3, VOCAB - 1, n)
    return _images(2, seed=7), labels


def test_train_step_matches_jax(pair):
    """One ``make_train_step`` step (SNRAdam lr 6e-4, f32): the loss
    within 1e-4 relative, every trainable gradient within 1e-4 of its JAX
    tensor's largest value, trainable parameters after the update within
    1e-4 relative plus 2e-6 absolute but for at most 0.1% of the elements
    (SNRAdam's first step moves a parameter by about lr either way where
    its gradient is zero up to rounding; such elements must have a JAX
    gradient below 1e-3 of the tensor's largest and move by at most
    2·lr), and every frozen parameter — the int4 weights, their scales,
    the LoRA-wrapped bases — bitwise unchanged."""
    jw, params, tw, sd = pair
    images, labels = _train_batch()
    key = jax.random.PRNGKey(0)
    tx, _, _ = jax_build_opt(jw, params, [JOptimizerConfig(lr=LR)],
                             use_snr=True)
    with jax.default_matmul_precision("highest"):
        (jloss, _), jgrads = jax.jit(_value_and_grad_float(
            lambda p: jw.train_step(p, jnp.asarray(images),
                                    jnp.asarray(labels), key)))(params)
        state, _ = jax.jit(jax_make_train_step(jw, tx))(
            TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)),
            jnp.asarray(images), jnp.asarray(labels), key)
    jgrads = export_state_dict(jw.model, jgrads["model"])
    jafter = export_state_dict(jw.model, state.params["model"])

    frozen = {p[len("model."):] for p in frozen_param_paths(tw)}
    assert "decoder.transformer.h.0.attn.c_attn.weight_scales" in frozen
    opt, _ = topt.build_optimizer(tw, [OptimizerConfig(lr=LR)], use_snr=True)
    step = make_train_step(tw, opt, precision="no")
    metrics = step(torch.from_numpy(images), torch.from_numpy(labels), 0, 0)
    np.testing.assert_allclose(float(metrics["train_loss_lm"]), float(jloss),
                               rtol=1e-4)
    grads = state_dict_numpy(tw.model, grads=True)
    after = state_dict_numpy(tw.model)
    n_bad = n_all = 0
    for k, ref in jafter.items():
        if k in frozen or ref.dtype != np.float32:
            continue
        g = jgrads[k]
        scale = float(np.abs(g).max()) or 1.0
        np.testing.assert_allclose(grads[k], g, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
        bad = ~np.isclose(after[k], ref, rtol=1e-4, atol=2e-6)
        n_bad, n_all = n_bad + int(bad.sum()), n_all + bad.size
        assert np.abs(after[k] - ref).max() <= 2 * LR, k
        if bad.any():
            assert np.abs(g)[bad].max() <= 1e-3 * np.abs(g).max(), k
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    for k in frozen:
        np.testing.assert_array_equal(after[k], sd[k], err_msg=k)
        np.testing.assert_array_equal(jafter[k], sd[k], err_msg=k)
    moved = [k for k in after if k not in frozen
             and not np.array_equal(after[k], sd[k])]
    assert any(".lora_B." in k for k in moved)
    assert any("crossattention.c_attn.weight" in k for k in moved)


def _assert_same(mine, ref, path):
    if dataclasses.is_dataclass(mine):
        for f in dataclasses.fields(mine):
            _assert_same(getattr(mine, f.name), getattr(ref, f.name),
                         f"{path}.{f.name}")
    elif isinstance(mine, enum.Enum):
        assert mine.value == ref.value, path
    elif isinstance(mine, (tuple, list)):
        assert len(mine) == len(ref), path
        for a, b in zip(mine, ref):
            _assert_same(a, b, path)
    else:
        assert mine == ref, path


def test_gpt2_medium_configs_match_the_yaml():
    """Every field of the port's transcription equals the JAX package's
    reading of ``training_configs/tpu/gpt2-medium.yaml`` (the tiny model
    equals the test's own cut); the runnable form differs from it only in
    accumulation 1, which divides the batch, and SNRAdam."""
    from image2text_torch.configs.models import gpt2_medium_config
    from image2text_torch.configs.trainer import GPT2_MEDIUM_TRAINING

    with open("training_configs/tpu/gpt2-medium.yaml") as f:
        ref = JTrainingConfig.model_validate(yaml.safe_load(f))
    for f in dataclasses.fields(GPT2_MEDIUM_TRAINING):
        _assert_same(getattr(GPT2_MEDIUM_TRAINING, f.name),
                     getattr(ref, f.name), f.name)
    _assert_same(gpt2_medium_config(tiny=True), _jax_config().model, "tiny")
    run = gpt2_medium_training_config()
    assert run.batch_size % run.gradient_accumulation_steps == 0
    assert GPT2_MEDIUM_TRAINING.batch_size % (
        GPT2_MEDIUM_TRAINING.gradient_accumulation_steps) != 0
    differ = {f.name for f in dataclasses.fields(run)
              if getattr(run, f.name) != getattr(GPT2_MEDIUM_TRAINING, f.name)}
    assert differ == {"gradient_accumulation_steps", "use_snr_optim"}


def test_sdpa_calls_count_the_gpt2_training_forward(pair, monkeypatch):
    """``sdpa_calls`` (what the card's flash launch counts are held to)
    equals the attention calls a training forward of the captioner makes:
    the encoder's self-attention and each GPT-2 block's self- and
    cross-attention."""
    from image2text_torch.models import layers
    from image2text_torch.models.hf_decoders import gpt2

    _, _, tw, _ = pair
    calls = []
    for mod in (layers, gpt2):
        real = mod.sdpa
        monkeypatch.setattr(mod, "sdpa", lambda *a, real=real, **k: (
            calls.append(1), real(*a, **k))[1])
    images, labels = _train_batch()
    tw(torch.from_numpy(images), torch.from_numpy(labels), seed=5)
    assert len(calls) == tw.model.sdpa_calls(16) == 2 + 2 * 2
