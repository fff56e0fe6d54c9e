"""The pretrained-ViT family end to end, the port against the JAX package
on the CPU: tiny forms (``tests/torch_nano_pairs.py``) of
``local/nano-mini.yaml`` (positional-MLP head, bridge, sparse MQA/MoE
decoder with the positional-MLP embedding, soft prompt + cross-attention),
``tpu/nano.yaml`` (PEER head, bridge, GPT-2-initialised MHA decoder
imported loose, cross-attention alone), ``local/nano.yaml`` (LSH head,
GPT-2-initialised MHA decoder, soft prompt + cross-attention) and
``local/gpt2.yaml`` (ViT + the HF GPT-2 with LoRA), on shared weights.
f32, JAX at full matmul precision; logits within 2e-4 abs + 1e-4 rel,
greedy tokens equal.  Also: every configuration builds at full size from
the YAML (on the meta device) with the JAX model's parameter count, a
checkpoint round trip, the GPT-2 import of the port's own ``init_weights``
and ``caption``'s ImageNet preprocessing.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import yaml

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.ops.preprocess import (
    resize_normalize_on_device as jax_preprocess)
from image2text_tpu.training.data import IMAGENET_MEAN, IMAGENET_STD
from image2text_tpu.utils.checkpoint import (
    load_state_dict as jax_load_state_dict,
    update_params_from_partial_checkpoint as jax_partial_restore)
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs.reader import load_training_config
from image2text_torch.models.generation import (decoder_step, prefill,
                                                preprocess_frames)
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.utils.checkpoint import (save_checkpoint,
                                               state_dict_numpy)
from torch_nano_pairs import CONFIGS, build_pair, images, patched, vocab

torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 1e-4
NAMES = list(CONFIGS)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = build_pair(name)
        return cache[name]
    return get


def _ids(tm, b=2, t=6, seed=1):
    return np.random.default_rng(seed).integers(0, vocab(tm), (b, t))


@pytest.mark.parametrize("name", NAMES)
def test_builds_at_full_size_from_the_yaml(name):
    """The YAML as the port's reader gives it builds (no
    NotImplementedError) with as many parameters as the JAX model's tree
    declares: parameters and parameter-like buffers, at full width and
    depth, on the meta device (no memory)."""
    cfg = load_training_config(CONFIGS[name]).model
    tm = VisionEncoderDecoder(cfg, device="meta")
    with open(CONFIGS[name]) as f:
        jm = JaxModel(JTrainingConfig.model_validate(yaml.safe_load(f)).model)
    want = sum(math.prod(s.shape) for s in jm.param_specs().values())
    assert sum(p.numel() for p in tm.parameters()) == want


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_and_values_match_jax(pairs, name):
    """Same keys and values both ways: the torchvision names under
    ``encoder.model.`` or ``encoder.0.model.``, the heads' parameters and
    buffers, the split positional-MLP keys, the bridge ``encoder.1``."""
    _, _, sd, tm, _ = pairs(name)
    mine = state_dict_numpy(tm)
    assert set(mine) == set(sd)
    for k, v in sd.items():
        assert mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    prefix = "encoder.0." if name in ("nano-mini", "nano") else "encoder."
    assert prefix + "model.encoder.layers.encoder_layer_1.mlp.3.weight" in sd
    assert ("encoder.1.weight" in sd) == (name in ("nano-mini", "nano"))


@pytest.mark.parametrize("name", NAMES)
def test_full_forward_logits_match_jax(pairs, name):
    jm, params, _, tm, _ = pairs(name)
    img, ids = images(), _ids(tm)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm(params, jnp.asarray(img), jnp.asarray(ids)).logits)
    out = tm(torch.from_numpy(img), torch.from_numpy(ids)).logits.numpy()
    assert out.shape == (2, 6, vocab(tm))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_first_step_logits_match_jax(pairs, name):
    """The port's cached prefill of a one-token prompt (its first-step
    logits) against the last row of JAX's full forward, and the encoder
    outputs."""
    jm, params, _, tm, _ = pairs(name)
    img, ids = images(seed=2), _ids(tm, t=1, seed=3)
    with torch.no_grad():
        enc = tm.encoder(torch.from_numpy(img))
        out = prefill(tm, enc, torch.from_numpy(ids), 4)[0][:, -1].numpy()
    with jax.default_matmul_precision("highest"):
        jenc = jm.encoder(params["encoder"], jnp.asarray(img))
        ref = np.asarray(jm(params, None, jnp.asarray(ids),
                            encoder_output=jenc).logits[:, -1])
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_token_for_token(pairs, name):
    """Greedy, no-repeat n-grams 2–5, 6 new tokens: the ids of JAX's
    ``generate``."""
    jm, params, _, tm, _ = pairs(name)
    img = images(seed=4)
    prompt = np.full((2, 1), 50256 % vocab(tm), np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm.generate(params, jnp.asarray(img),
                                     jnp.asarray(prompt), max_new_tokens=6,
                                     temperature=0.0,
                                     rng=jax.random.PRNGKey(0)))
    out = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=6, temperature=0.0).numpy()
    assert out.shape == (2, 7)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["nano-mini", "nano", "nano-lsh"])
def test_cached_decode_matches_full_forward(pairs, name):
    """The scratch decoders' cached decode (prefill 3, then single tokens:
    the positional MLP's ``forward_at``, full-head or multi-query caches)
    equals their full forward."""
    _, _, _, tm, _ = pairs(name)
    img, ids = torch.from_numpy(images()), torch.from_numpy(_ids(tm))
    full = tm(img, ids)
    off = tm.space_for_prompt
    cross = full.encoder_output
    cache = tm.decoder.init_cache(2, 6, torch.float32, "cpu")
    with torch.no_grad():
        chunks = [decoder_step(tm, ids[:, :3], cache, off, cross)[0]]
        chunks += [decoder_step(tm, ids[:, i:i + 1], cache, off + i,
                                cross)[0] for i in range(3, 6)]
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(),
                               full.logits.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_round_trip_through_jax(pairs, name, tmp_path):
    """The port's ``save_checkpoint`` restores into the JAX tree exactly
    (LSH buffers, split keys, the bridge), and JAX's frozen set is the
    port's."""
    jm, params, _, tm, _ = pairs(name)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(tm, path)
    assert set(jax_load_state_dict(path)) == set(state_dict_numpy(tm))
    restored = flatten(jax_partial_restore(jm, params, path))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(np.asarray(restored[k]), np.asarray(v),
                                      err_msg=k)
    assert sorted(frozen_param_paths(tm)) == sorted(jm.frozen_param_paths())


@pytest.mark.parametrize("name", ["nano", "nano-lsh"])
def test_init_weights_imports_gpt2_loose(pairs, name):
    """The port's ``init_weights`` imports the GPT-2 state dict as JAX's
    init did: every GPT-2 tensor of the decoder's shape, ``wpe`` (256
    rows in the configuration, 128 in the state dict here) kept; without
    a state dict it raises rather than download."""
    jm, params, _, tm, gpt2_sd = pairs(name)
    with patched():
        fresh = VisionEncoderDecoder(tm.config, device="cpu")
        with pytest.raises(RuntimeError, match="import_gpt2_state_dict"):
            fresh.init_weights(0)
        fresh.init_weights(0, gpt2_state_dict=gpt2_sd)
    mine = state_dict_numpy(fresh.decoder)
    flat = flatten(params["decoder"])
    for k, v in gpt2_sd.items():
        k = "transformer.wte.weight" if k == "lm_head.weight" else k
        if k in mine and ".attn.bias" not in k and k != "transformer.wpe.weight":
            np.testing.assert_array_equal(mine[k], np.asarray(flat[k]),
                                          err_msg=k)
    assert not np.array_equal(mine["transformer.wpe.weight"][:64],
                              gpt2_sd["transformer.wpe.weight"][:64])


def test_caption_preprocessing_is_jax_imagenet_resize(pairs):
    """``caption`` resizes raw frames to the backbone's ``image_size``
    with ImageNet's statistics: JAX's
    ``resize_normalize_on_device(raw, size, IMAGENET_MEAN, IMAGENET_STD)``."""
    _, _, _, tm, _ = pairs("nano-mini")
    raw = np.random.default_rng(5).integers(0, 256, (2, 48, 40, 3),
                                            dtype=np.uint8)
    out = preprocess_frames(tm, torch.from_numpy(raw)).numpy()
    ref = np.asarray(jax_preprocess(jnp.asarray(raw), 32, IMAGENET_MEAN,
                                    IMAGENET_STD))
    assert out.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_scratch_decoder_gpt2_checks(pairs):
    """Strict GPT-2 shape checks unless loose (JAX decoder.py:58-71), the
    vocabulary never shrinks, and LoRA on the GPT-2-initialised scratch
    decoder wraps its Linears (JAX decoder.py:56-80)."""
    import copy

    from image2text_torch.configs.models import LoraSpec

    _, _, _, tm, _ = pairs("nano-lsh")
    cfg = copy.deepcopy(tm.config)
    cfg.loose_match_decoder_state_dict = False
    with pytest.raises(ValueError, match="do not match"):
        VisionEncoderDecoder(cfg, device="meta")
    cfg = load_training_config(CONFIGS["nano-lsh"]).model
    cfg.loose_match_decoder_state_dict = False
    cfg.decoder_config.block_size = 1024
    VisionEncoderDecoder(cfg, device="meta")      # GPT-2 small exactly
    cfg.decoder_config.vocab_size = 50000
    with pytest.raises(ValueError, match="shrink"):
        VisionEncoderDecoder(cfg, device="meta")
    cfg = copy.deepcopy(tm.config)
    cfg.decoder_config.lora_spec = LoraSpec(target_modules=["c_attn"])
    dec = VisionEncoderDecoder(cfg, device="meta").decoder
    assert any(n.endswith("attn.c_attn.lora_A.weight")
               for n, _ in dec.named_parameters())
