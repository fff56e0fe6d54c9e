"""The port's beam search against the JAX package's: the KV cache's batch
gather, the per-round candidate scorer with the same Gumbel noise fed to
both, and greedy deterministic beam search (temperature 0, consolidation
0) on the tiny flagship and on the tiny int4 + LoRA GPT-2 captioner of
``tests/test_torch_gpt2m.py``.  f32 on the CPU, JAX at full matmul
precision; inputs from numpy seeds."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.models import sampling as js
from image2text_tpu.models.generation_utils import (
    BeamSearchTokenGenerator as JaxBeam)
from image2text_tpu.models.kv_cache import KVCache as JaxKVCache
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import flagship_config
from image2text_torch.models import sampling as ts
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.kv_cache import KVCache
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.utils.checkpoint import load_jax_state_dict

from test_torch_gpt2m import pair  # noqa: F401  (the tiny GPT-2 fixture)

torch.set_num_threads(2)
NGRAMS = (2, 3, 4, 5)


def _jax_candidates(logits, ids, cur, key, temperature, top_k, bef,
                    ngrams=NGRAMS):
    """JAX's fused scorer, jitted (one compile instead of many eager
    ones)."""
    f = jax.jit(functools.partial(
        js.beam_candidates_with_ngram, ngram_sizes=ngrams,
        temperature=temperature, top_k=top_k, bef=bef))
    return f(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(cur),
             rng=key)


BEAM = dict(beam_width=3, beam_expansion_factor=4, temperature=0.0,
            top_k=16, no_repeat_n_grams=NGRAMS, consolidation_temperature=0.0)


def test_kv_cache_gather_batch_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(6, 1, 5, 4), (6, 1, 3, 4)]
    bufs = [(rng.standard_normal(s).astype(np.float32),
             rng.standard_normal(s).astype(np.float32)) for s in shapes]
    order = np.array([2, 0, 1, 5, 3, 3])
    jc = JaxKVCache(tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in bufs),
                    jnp.asarray([4, 2], jnp.int32))
    want = jc.gather_batch(jnp.asarray(order))
    tc = KVCache([(torch.from_numpy(k), torch.from_numpy(v)) for k, v in bufs])
    tc.index = [4, 2]
    got = tc.gather_batch(torch.from_numpy(order))
    assert got.index == [4, 2]
    for (gk, gv), (wk, wv) in zip(got.layers, want.layers):
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _ids(b=6, l=24, cur=20, vocab=12, seed=0):
    """Short-vocab ids so that n-grams repeat (bans fire); zeros past cur."""
    ids = np.random.default_rng(seed).integers(0, vocab, (b, l))
    ids[:, cur:] = 0
    return ids.astype(np.int32)


def _logits(b=6, v=300, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32)
    x[:, :12] += 3.0          # the short-vocab ids lead the head
    return x


@pytest.mark.parametrize("temperature,top_k", [
    (0.0, 16), (0.7, 16), (0.0, None), (0.7, None), (0.7, 3)])
def test_beam_candidates_match_jax(temperature, top_k):
    """Greedy and stochastic, with and without top_k, bans present in the
    head; the stochastic draws take JAX's own Gumbel noise.  Stochastic
    without top_k, and bef > top_k, both scorers decline (the dense path's
    turn)."""
    ids, logits, cur, bef = _ids(), _logits(), 20, 4
    cand, ban = js._ngram_bans(jnp.asarray(ids), jnp.asarray(cur), NGRAMS)
    assert bool(jnp.any(ban))
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        ref = (_jax_candidates(logits, ids, cur, key, temperature, top_k,
                               bef)
               if temperature <= 0 or top_k is not None and bef <= top_k
               else js.beam_candidates_with_ngram(
                   jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(cur),
                   NGRAMS, key, temperature, top_k, bef))
    noise = None
    if temperature > 0 and top_k is not None and bef <= top_k:
        noise = torch.from_numpy(np.array(
            jax.random.gumbel(key, (6, top_k), jnp.float32)))
    out = ts.beam_candidates_with_ngram(
        torch.from_numpy(logits), torch.from_numpy(ids).long(), cur, NGRAMS,
        None, temperature, top_k, bef, gumbel=noise)
    if ref is None:
        assert out is None
        return
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                               atol=1e-5, rtol=0)


def test_beam_candidates_keep_exactly_k_at_a_tied_threshold():
    """JAX sampling.py:484-486: the fused scorer keeps exactly k values at
    a tied k-th value (the lowest indices), so the log-softmax normalises
    over k values, not over every tie as ``apply_top_k`` would."""
    logits = np.linspace(3.0, -3.0, 40, dtype=np.float32)[None].repeat(2, 0)
    logits[:, 10:20] = logits[:, 9:10]       # ranks 9..19 tie
    ids = np.full((2, 4), 39, np.int32)      # bans only id 39
    ref = _jax_candidates(logits, ids, 2, jax.random.PRNGKey(0), 0.0, 12, 4,
                          ngrams=(2,))
    out = ts.beam_candidates_with_ngram(torch.from_numpy(logits),
                                        torch.from_numpy(ids).long(), 2, (2,),
                                        None, 0.0, 12, 4)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    kept = torch.log_softmax(torch.from_numpy(logits[:, :12]), -1)[:, :4]
    np.testing.assert_allclose(out[1].numpy(), kept.numpy(), atol=1e-6)


def test_greedy_untruncated_scores_count_a_ban_once_per_ngram_size():
    """JAX sampling.py:507 (ROADMAP §3): with top_k None the greedy scorer
    subtracts the banned ids' mass from the full log-sum-exp, counting an
    id once for every n-gram size (and window) that bans it.  The port
    copies this; the scores then differ from a log-softmax over the
    unbanned ids."""
    ids = np.array([[5, 6, 7, 5, 6, 7, 5, 6, 0, 0]], np.int32)
    cur = 8                                  # next after "5 6" (and 7 5 6…)
    logits = np.random.default_rng(4).standard_normal((1, 20)).astype(
        np.float32)
    logits[0, 7] = 4.0                       # the id every n-gram size bans
    cand, ban = js._ngram_bans(jnp.asarray(ids), jnp.asarray(cur), NGRAMS)
    banned7 = int(np.sum(np.asarray(ban) & (np.asarray(cand) == 7)))
    assert banned7 >= 3
    ref = _jax_candidates(logits, ids, cur, jax.random.PRNGKey(0), 0.0,
                          None, 4)
    out = ts.beam_candidates_with_ngram(
        torch.from_numpy(logits), torch.from_numpy(ids).long(), cur, NGRAMS,
        None, 0.0, None, 4)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    masked = torch.from_numpy(logits).clone()
    masked[0, 7] = float("-inf")
    once = torch.log_softmax(masked, -1).gather(-1, out[0])
    assert not torch.allclose(out[1], once, atol=1e-3)


@pytest.mark.parametrize("temperature,top_k", [(0.8, None), (0.8, 3),
                                               (0.0, 3)])
def test_dense_fallback_candidates_match_jax(temperature, top_k):
    """Where the fused scorer declines (stochastic without top_k, or bef >
    top_k) the generator's dense path runs: ban, top-k mask with ties
    kept, log-softmax at the temperature, the bef best or Gumbel-top-bef
    over the vocabulary on JAX's noise; sticky EOS and length_boost on
    top."""
    ids, logits, cur = _ids(), _logits(), 20
    key = jax.random.PRNGKey(7)
    jgen = JaxBeam(None, temperature=temperature, top_k=top_k,
                   no_repeat_n_grams=NGRAMS, beam_expansion_factor=4,
                   eos_token_id=3, length_boost=1.3)
    ref = jax.jit(jgen._candidates)(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(cur), key)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape,
                                                        jnp.float32)))
    tgen = BeamSearchTokenGenerator(None, temperature=temperature,
                                    top_k=top_k,
                                    no_repeat_n_grams=NGRAMS,
                                    beam_expansion_factor=4, eos_token_id=3,
                                    length_boost=1.3)
    out = tgen._candidates(torch.from_numpy(logits),
                           torch.from_numpy(ids).long(), cur, None,
                           gumbel=noise)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-5)


@pytest.fixture(scope="module")
def flagship():
    cfg = _flagship_config(tiny=True).model
    jm = JaxModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    return jm, params, tm


def _images(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def _beam_pair(jm, params, tm, img, prompt, **kw):
    gen = JaxBeam(jm, **kw)
    with jax.default_matmul_precision("highest"):
        jids, jsc = jax.jit(lambda p, i, d: gen(p, i, d, rng=jax.random.PRNGKey(
            0)))(params, jnp.asarray(img), jnp.asarray(prompt))
    ids, sc = BeamSearchTokenGenerator(tm, **kw)(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    return (ids.numpy(), sc.numpy()), (np.asarray(jids), np.asarray(jsc))


@pytest.mark.parametrize("case", ["no_eos", "eos_stop_length_boost"])
def test_greedy_beam_search_matches_jax_flagship(flagship, case):
    """Beam width 3, expansion 4, top-k 16, n-grams 2–5, 7 rounds.  The
    EOS case takes as EOS the first generated id of the no-EOS run that
    differs from the prompt, with length_boost 1.5: the beams stop early
    and the tail is filled with EOS."""
    jm, params, tm = flagship
    bs = 2 if case == "no_eos" else 1
    img, prompt = _images(bs, 20), np.ones((bs, 1), np.int32)
    kw = dict(BEAM, max_new_tokens=8)
    if case != "no_eos":
        ids, _ = BeamSearchTokenGenerator(tm, **kw)(
            torch.from_numpy(img), torch.from_numpy(prompt).long())
        eos = next(int(i) for i in ids[0, 0, 1:] if int(i) != 1)
        kw.update(eos_token_id=eos, length_boost=1.5)
    (ids, sc), (jids, jsc) = _beam_pair(jm, params, tm, img, prompt, **kw)
    assert ids.shape == (bs, 3, 8) and sc.shape == (bs, 3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, atol=1e-4, rtol=0)
    if case != "no_eos":
        first = int(np.argmax(ids[0, 0] == kw["eos_token_id"]))
        assert first < 7 and (ids[:, :, first:] == kw["eos_token_id"]).all()


def test_greedy_beam_search_matches_jax_gpt2(pair):  # noqa: F811
    """The prefix-in-decode branch: the tiny int4 + LoRA GPT-2 captioner,
    prompt <|endoftext|>, no EOS stop, 5 rounds."""
    jw, params, tw, _ = pair
    img, prompt = _images(2, 21), np.full((2, 1), 50256, np.int32)
    (ids, sc), (jids, jsc) = _beam_pair(jw.model, params["model"], tw.model,
                                        img, prompt,
                                        **dict(BEAM, max_new_tokens=6))
    assert ids.shape == (2, 3, 6)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, atol=1e-4, rtol=0)
