"""The rest of ``generate`` and beam search in the port against the JAX
package: the full-reforward fallback (a sparse decoder whose window crosses
the "< 2 selected" count, where the cache cannot serve, and
``force_no_cache``), the bidirectional-decoder branch, and the port's
cached path against its own fallback wherever JAX's are equal
(``tests/test_generation.py:117``).  The tiny flagship, its form without
soft prompting (cross-attention only: no always-selected prefix, so the
bypass rule is reachable) and its form with a bidirectional decoder; f32 on
the CPU, JAX at full matmul precision, greedy (the two packages' RNGs
differ), inputs from numpy seeds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.models.generation_utils import (
    BeamSearchTokenGenerator as JaxBeam)
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import flagship_config
from image2text_torch.models.decoder import TransformerDecoder
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.utils.checkpoint import load_jax_state_dict

torch.set_num_threads(2)
NGRAMS = (2, 3, 4, 5)


def _no_prefix(cfg):
    cfg.use_soft_prompting = False


def _bidirectional(cfg):
    cfg.decoder_config.transformer_config.is_causal = False


def _pair(edit=None, seed=0):
    """(JAX model, params, the port's model on the same weights) of the
    tiny flagship with ``edit`` applied to both packages' configs."""
    jcfg, tcfg = _flagship_config(tiny=True).model, flagship_config(tiny=True)
    if edit is not None:
        edit(jcfg)
        edit(tcfg)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = VisionEncoderDecoder(tcfg, device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def flagship():
    return _pair()


@pytest.fixture(scope="module")
def no_prefix():
    return _pair(_no_prefix)


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def _jax_generate(jm, params, img, prompt, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, **kw))(params, jnp.asarray(img), jnp.asarray(prompt)))


def test_the_window_crosses_the_bypass_count(no_prefix):
    """Without the soft prompt a sparse layer's selected count crosses 2
    inside a short prompt's window, so neither package may use its cache
    there; with it, the 8 always-selected CLS slots keep every window
    exact."""
    _, _, tm = no_prefix
    assert not tm.decoder.cache_exact_for_window(1, 9)
    assert not tm.decoder.cache_exact_for_window(2, 10)
    flag = VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")
    off = flag.space_for_prompt
    assert off == 8 and flag.decoder.cache_exact_for_window(off + 1, off + 9)


@pytest.mark.parametrize("t0", [1, 2])
def test_fallback_generate_equals_jax_where_the_count_crosses(no_prefix, t0):
    """The window forces the fallback in both packages (the port no longer
    raises): greedy ids equal, and ``force_no_cache`` takes the same
    path."""
    jm, params, tm = no_prefix
    img = _images(seed=30 + t0)
    prompt = np.arange(1, 1 + t0)[None].repeat(2, 0).astype(np.int32)
    want = _jax_generate(jm, params, img, prompt, max_new_tokens=8,
                         temperature=0.0)
    timg, tp = torch.from_numpy(img), torch.from_numpy(prompt).long()
    for force in (False, True):
        got = tm.generate(timg, tp, max_new_tokens=8, temperature=0.0,
                          force_no_cache=force).numpy()
        np.testing.assert_array_equal(got, want)


def test_force_no_cache_equals_jax_fallback(flagship):
    """The soft-prompt flagship under ``force_no_cache``: JAX's fallback
    and the port's, greedy, ids equal."""
    jm, params, tm = flagship
    img, prompt = _images(seed=33), np.ones((2, 1), np.int32)
    want = _jax_generate(jm, params, img, prompt, max_new_tokens=8,
                         temperature=0.0, force_no_cache=True)
    got = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=8, temperature=0.0,
                      force_no_cache=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t0", [1, 4])
def test_cached_equals_fallback_in_the_port(flagship, t0):
    """The port's cached path and its fallback give the same ids, greedy
    and sampled (top-k 8 at 0.8, the same generator seed: both draw once
    a step), as JAX's test of the same on the sparse soft-prompt model."""
    _, _, tm = flagship
    img = torch.from_numpy(_images(seed=34))
    prompt = torch.arange(1, 1 + t0)[None].repeat(2, 1)
    for kw in (dict(temperature=0.0), dict(temperature=0.8, top_k=8)):
        fast, slow = (tm.generate(img, prompt, max_new_tokens=8,
                                  generator=torch.Generator().manual_seed(3),
                                  force_no_cache=force, **kw)
                      for force in (False, True))
        assert torch.equal(fast, slow), (t0, kw)


def test_fallback_runs_the_ffn_of_the_blocks_the_rule_keeps(no_prefix):
    """The decoder's bookkeeping of the fallback's FFN runs
    (``reforward_ffn_evaluations``: a sparse block whose count at the
    current length is below 2 skips its body, whose output JAX computes
    and discards) matches the FFN calls a fallback generate makes."""
    _, _, tm = no_prefix
    calls = []
    hooks = [blk.mlp.register_forward_hook(lambda *a: calls.append(1))
             for blk in tm.decoder.blocks]
    try:
        tm.generate(torch.from_numpy(_images()), torch.ones(1, 1).long(),
                    max_new_tokens=8, temperature=0.0)
    finally:
        for h in hooks:
            h.remove()
    want = sum(tm.decoder.reforward_ffn_evaluations(9, cur)
               for cur in range(1, 9))
    assert len(calls) == want > 0
    assert want < 8 * len(tm.decoder.blocks)   # the rule skipped some


def _beam(model, **kw):
    return dict(beam_width=2, beam_expansion_factor=2, temperature=0.0,
                top_k=8, max_new_tokens=6, no_repeat_n_grams=NGRAMS,
                consolidation_temperature=0.0) | kw


def test_fallback_beam_search_equals_jax(no_prefix):
    """Greedy beam search where the window crosses the count: both
    packages re-forward the buffer every round; ids equal, scores within
    1e-4."""
    jm, params, tm = no_prefix
    img, prompt = _images(seed=35), np.array([[1], [2]], np.int32)
    gen = JaxBeam(jm, **_beam(jm))
    with jax.default_matmul_precision("highest"):
        jids, jsc = jax.jit(lambda p, i, d: gen(p, i, d))(
            params, jnp.asarray(img), jnp.asarray(prompt))
    ids, sc = BeamSearchTokenGenerator(tm, **_beam(tm))(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), atol=1e-4,
                               rtol=0)


def test_beam_search_cached_equals_fallback_in_the_port(flagship,
                                                        monkeypatch):
    """A decoder without a KV cache takes the fallback (JAX's test of the
    same patches ``supports_kv_cache`` likewise): the same beams as the
    cached path, scores within 1e-4."""
    _, _, tm = flagship
    img = torch.from_numpy(_images(seed=36))
    prompt = torch.tensor([[1, 2], [3, 4]])
    gen = BeamSearchTokenGenerator(tm, **_beam(tm))
    fast = gen(img, prompt)
    monkeypatch.setattr(TransformerDecoder, "supports_kv_cache", False)
    slow = gen(img, prompt)
    assert torch.equal(fast[0], slow[0])
    np.testing.assert_allclose(fast[1].numpy(), slow[1].numpy(), atol=1e-4)


def test_bidirectional_generate_equals_jax_and_beam_refuses():
    """A decoder with ``is_causal`` False: ``generate`` re-forwards the
    growing sequence in both packages (greedy ids equal); beam search
    raises JAX's ``ValueError``."""
    jm, params, tm = _pair(_bidirectional)
    img, prompt = _images(seed=37), np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.generate(params, jnp.asarray(img),
                                      jnp.asarray(prompt), max_new_tokens=4,
                                      temperature=0.0))
    got = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=4, temperature=0.0).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="causal decoder"):
        BeamSearchTokenGenerator(tm, **_beam(tm))(
            torch.from_numpy(img), torch.from_numpy(prompt).long())
    with pytest.raises(ValueError, match="causal decoder"):
        JaxBeam(jm, **_beam(jm))(params, jnp.asarray(img),
                                 jnp.asarray(prompt))
