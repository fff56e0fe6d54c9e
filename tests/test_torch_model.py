"""The PyTorch port's serving slice against the JAX package, end to end, on
the tiny flagship config: JAX weights carried across by
``export_state_dict`` → ``load_jax_state_dict``; f32 on the CPU with JAX
at full matmul precision."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.models.generation import decoder_step as jax_decoder_step
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import flagship_config
from image2text_torch.models.generation import decoder_step
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)

torch.set_num_threads(2)


def _pair(seed):
    cfg = _flagship_config(tiny=True).model
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    sd = export_state_dict(jm, params)
    tm = VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")
    load_jax_state_dict(tm, sd)
    return jm, params, sd, tm


@pytest.fixture(scope="module")
def pairs():
    return {seed: _pair(seed) for seed in (0, 1)}


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def test_state_dict_keys_and_shapes_match(pairs):
    _, _, sd, tm = pairs[0]
    mine = state_dict_numpy(tm)
    assert len(sd) == 218
    assert set(mine) == set(sd)
    for k, v in sd.items():
        assert mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


def test_encoder_output_matches(pairs):
    jm, params, _, tm = pairs[0]
    img = _images()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm.encoder(params["encoder"], jnp.asarray(img)))
    with torch.no_grad():
        out = tm.encoder(torch.from_numpy(img)).numpy()
    assert out.shape == (2, 8, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_full_forward_logits_match(pairs):
    """Soft prompt (with its additive bias, whose text→prefix block is
    -inf: a quirk of the reference's mask conversion that both packages
    keep) + cross-attention + the lazy sparse decoder."""
    jm, params, _, tm = pairs[0]
    img = _images()
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm(params, jnp.asarray(img), jnp.asarray(ids)).logits)
    out = tm(torch.from_numpy(img), torch.from_numpy(ids)).logits.numpy()
    assert out.shape == (2, 12, 512)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


def test_cached_decode_matches_full_forward(pairs):
    """The port's cached decode (prefill 8, then 4 single tokens) equals
    its own full forward, as the JAX package's test of the same name."""
    _, _, _, tm = pairs[0]
    img = torch.from_numpy(_images())
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 12)))
    full = tm(img, ids)
    cross = full.encoder_output
    cache = tm.decoder.init_cache(2, 12, torch.float32, "cpu")
    off = tm.space_for_prompt
    with torch.no_grad():
        la, cache = decoder_step(tm, ids[:, :8], cache, off, cross)
        chunks = [la]
        for i in range(8, 12):
            li, cache = decoder_step(tm, ids[:, i:i + 1], cache, off + i,
                                     cross)
            chunks.append(li)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(),
                               full.logits.numpy(), atol=2e-4, rtol=1e-4)


def test_cached_prefill_matches_jax(pairs):
    jm, params, _, tm = pairs[0]
    img = _images()
    ids = np.random.default_rng(2).integers(0, 512, (2, 5))
    with jax.default_matmul_precision("highest"):
        enc = jm.encoder(params["encoder"], jnp.asarray(img))
        cache = jm.decoder.init_cache(2, 8, jnp.float32)
        ref, _ = jax_decoder_step(jm, params, jnp.asarray(ids), cache,
                                  jm.space_for_prompt, enc)
    with torch.no_grad():
        tenc = tm.encoder(torch.from_numpy(img))
        tcache = tm.decoder.init_cache(2, 8, torch.float32, "cpu")
        out, _ = decoder_step(tm, torch.from_numpy(ids), tcache,
                              tm.space_for_prompt, tenc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_token_for_token(pairs, seed):
    """Greedy (temperature 0) with no-repeat n-grams 2–5, 8 new tokens,
    2 images: identical ids to JAX ``generate``."""
    jm, params, _, tm = pairs[seed]
    img = _images(seed=10 + seed)
    prompt = np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm.generate(params, jnp.asarray(img),
                                     jnp.asarray(prompt), max_new_tokens=8,
                                     temperature=0.0,
                                     rng=jax.random.PRNGKey(0)))
    out = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=8, temperature=0.0).numpy()
    assert out.shape == (2, 9)
    np.testing.assert_array_equal(out, ref)


def test_generate_counts_ffn_evaluations(pairs):
    """The decoder's bookkeeping of body (FFN) runs matches the number of
    FFN calls a cached generate makes."""
    _, _, _, tm = pairs[0]
    calls = []
    hooks = [blk.mlp.register_forward_hook(lambda *a: calls.append(1))
             for blk in tm.decoder.blocks]
    try:
        tm.generate(torch.from_numpy(_images()), torch.ones(1, 1).long(),
                    max_new_tokens=8, temperature=0.0)
    finally:
        for h in hooks:
            h.remove()
    off = tm.space_for_prompt
    want = tm.decoder.ffn_evaluations(off, 1) + sum(
        tm.decoder.ffn_evaluations(off + cur, 1) for cur in range(1, 9))
    assert len(calls) == want > 0
