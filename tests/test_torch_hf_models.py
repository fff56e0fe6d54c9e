"""The HF-family configurations end to end, the port against the JAX
package on the CPU, on tiny forms (``tests/torch_hf_pairs.py``) with
shared weights.  Here the pretrained-ViT ones: ``tpu/llama2-13b.yaml``
(int4 + LoRA Llama-2 with its untied lm_head), ``local/llama2-7b.yaml``
(float Llama-2) and ``local/qwen-1.5b-deepseek-distill.yaml`` (a bridge,
Qwen-2's grouped query heads and biases, its tied lm_head); the
scratch-encoder ones, ``tpu/falcon-7b.yaml`` (int4 + LoRA Falcon) and
``tpu/gpt2-xl.yaml`` (int4 + LoRA GPT-2 with cross-attention), run the
same tests in ``test_torch_hf_scratch_models.py``.  f32, JAX at full
matmul precision: the first-step logits within 2e-4 (relative L2, and
2e-4 abs + 1e-4 rel per element), greedy ids equal over 32 new tokens,
greedy beam search equal for a Llama-family model.  Also: each
configuration builds at full size from its YAML (on the meta device) with
the JAX model's parameter count, the cached decode equals the full
forward, and a checkpoint round trip.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import yaml

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models.generation_utils import (
    BeamSearchTokenGenerator as JaxBeam)
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import (
    load_state_dict as jax_load_state_dict,
    update_params_from_partial_checkpoint as jax_partial_restore)
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs.reader import load_training_config
from image2text_torch.models.generation import decoder_step, prefill
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.utils.checkpoint import (save_checkpoint,
                                               state_dict_numpy)
from torch_hf_pairs import BOS, CONFIGS, build_pair, images, vocab

torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 1e-4
NAMES = ["llama13b", "llama7b", "qwen"]


def pytest_generate_tests(metafunc):
    """Each test taking ``name`` runs on this module's configurations."""
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", metafunc.module.NAMES)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = build_pair(name)
        return cache[name]
    return get


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _param_elements(tm) -> int:
    """Parameters and parameter-like buffers (the packed int4 weights), as
    the JAX tree counts them."""
    return (sum(p.numel() for p in tm.parameters())
            + sum(getattr(m, name).numel() for m in tm.modules()
                  for name in getattr(m, "_param_buffers", ())))


def test_builds_at_full_size_from_the_yaml(name):
    """The YAML as the port's reader gives it builds at full width and
    depth (on the meta device: no memory) with as many parameter elements
    as the JAX model's tree declares."""
    tm = VisionEncoderDecoder(load_training_config(CONFIGS[name]).model,
                              device="meta")
    with open(CONFIGS[name]) as f:
        jm = JaxModel(JTrainingConfig.model_validate(yaml.safe_load(f)).model)
    want = sum(math.prod(s.shape) for s in jm.param_specs().values())
    assert _param_elements(tm) == want


def test_state_dict_keys_and_values_match_jax(pairs, name):
    """Same keys and values both ways: the tied ``lm_head.weight`` alias of
    Qwen, Falcon and GPT-2, Llama-2's own ``lm_head``, the int4 weight and
    scale pairs under ``model.layers.*`` and ``transformer.h.*``."""
    _, _, sd, tm = pairs(name)
    mine = state_dict_numpy(tm)
    assert set(mine) == set(sd)
    for k, v in sd.items():
        assert mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    assert "decoder.lm_head.weight" in sd
    tied = getattr(tm.decoder, "tied_aliases", {})
    assert bool(tied) == (name not in ("llama13b", "llama7b"))
    blk = {"llama13b": "decoder.model.layers.1.mlp.gate_proj",
           "falcon7b": "decoder.transformer.h.1.mlp.dense_4h_to_h",
           "gpt2xl": "decoder.transformer.h.1.mlp.c_fc"}.get(name)
    if blk is not None:
        assert sd[blk + ".weight"].dtype == np.uint8
        assert sd[blk + ".weight_scales"].dtype == np.float32


def test_first_step_logits_match_jax(pairs, name):
    """The port's cached prefill of a one-token prompt (soft prompt in the
    cache at position 0) against the last row of JAX's full forward, and
    the encoder outputs."""
    jm, params, _, tm = pairs(name)
    img = images(name, seed=2)
    ids = np.random.default_rng(3).integers(0, vocab(tm), (2, 1))
    with torch.no_grad():
        enc = tm.encoder(torch.from_numpy(img))
        out = prefill(tm, enc, torch.from_numpy(ids), 4)[0][:, -1].numpy()
    with jax.default_matmul_precision("highest"):
        jenc = jm.encoder(params["encoder"], jnp.asarray(img))
        ref = np.asarray(jm(params, None, jnp.asarray(ids),
                            encoder_output=jenc).logits[:, -1])
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL,
                               rtol=RTOL)
    assert out.shape == (2, vocab(tm))
    assert _rel_l2(out, ref) <= 2e-4
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_greedy_generate_32_tokens_token_for_token(pairs, name):
    """Greedy, no-repeat n-grams 2–5, the tokenizer's BOS as the prompt, 32
    new tokens: the ids of JAX's ``generate``."""
    jm, params, _, tm = pairs(name)
    img = images(name, seed=4)
    prompt = np.full((2, 1), BOS[name], np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=32, temperature=0.0,
            rng=jax.random.PRNGKey(0)))(params, jnp.asarray(img),
                                        jnp.asarray(prompt)))
    out = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=32, temperature=0.0).numpy()
    assert out.shape == (2, 33)
    np.testing.assert_array_equal(out, ref)


def test_cached_decode_matches_full_forward(pairs, name):
    """Prefix in the cache, then a 3-token chunk and single tokens at their
    RoPE (or wpe) positions: the logits of the full forward over
    [encoder output; ids]."""
    _, _, _, tm = pairs(name)
    img = torch.from_numpy(images(name))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, vocab(tm), (2, 6)))
    with torch.no_grad():
        full = tm(img, ids)
        enc = full.encoder_output
        off = tm.space_for_prompt
        cross = enc if tm.use_cross_attn else None
        kv = (tm.decoder.precompute_cross_kv(enc) if tm.use_cross_attn
              else None)
        cache = tm.decoder.init_cache(2, off + 6, torch.float32, "cpu")
        embeds = torch.cat([enc, tm.decoder.get_inputs_embeds(ids[:, :3])], 1)
        chunks = [decoder_step(tm, None, cache, 0, cross, kv,
                               inputs_embeds=embeds)[0][:, off:]]
        chunks += [decoder_step(tm, ids[:, i:i + 1], cache, off + i, cross,
                                kv)[0] for i in range(3, 6)]
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(),
                               full.logits.numpy(), atol=ATOL, rtol=RTOL)


def test_checkpoint_round_trip_through_jax(pairs, name, tmp_path):
    """The port's ``save_checkpoint`` restores into the JAX tree exactly
    (the int4 pairs, the adapters, the tied alias resolved), and JAX's
    frozen set is the port's."""
    jm, params, _, tm = pairs(name)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(tm, path)
    assert set(jax_load_state_dict(path)) == set(state_dict_numpy(tm))
    restored = flatten(jax_partial_restore(jm, params, path))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(np.asarray(restored[k]), np.asarray(v),
                                      err_msg=k)
    assert sorted(frozen_param_paths(tm)) == sorted(jm.frozen_param_paths())


def test_greedy_beam_search_matches_jax_qwen(pairs):
    """Greedy beam search (width 3, expansion 4, top-k 16, n-grams 2–5,
    consolidation 0) on the Qwen form: grouped-query caches of (b·beams,
    2, len, hd) gathered by the beam scorer each round; ids equal to JAX's,
    scores within 1e-4."""
    jm, params, _, tm = pairs("qwen")
    img = images("qwen", seed=21)
    prompt = np.full((2, 1), BOS["qwen"], np.int32)
    kw = dict(beam_width=3, beam_expansion_factor=4, temperature=0.0,
              top_k=16, no_repeat_n_grams=(2, 3, 4, 5),
              consolidation_temperature=0.0, max_new_tokens=8)
    gen = JaxBeam(jm, **kw)
    with jax.default_matmul_precision("highest"):
        jids, jsc = jax.jit(lambda p, i, d: gen(
            p, i, d, rng=jax.random.PRNGKey(0)))(params, jnp.asarray(img),
                                                 jnp.asarray(prompt))
    ids, sc = BeamSearchTokenGenerator(tm, **kw)(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    assert tuple(ids.shape) == (2, 3, 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), atol=1e-4, rtol=0)
