"""The port's sampler against the JAX package's: n-gram bans, and the
top-k sampler with the same Gumbel noise fed to both
(``jax.random.categorical(key, x)`` is ``argmax(x + gumbel(key, x.shape))``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.models import sampling as js

from image2text_torch.models import sampling as ts

torch.set_num_threads(2)
NGRAMS = (2, 3, 4, 5)


def _ids(b=4, l=24, cur=20, vocab=12, seed=0):
    """Short-vocab ids so that n-grams repeat (bans fire); zeros past cur."""
    ids = np.random.default_rng(seed).integers(0, vocab, (b, l))
    ids[:, cur:] = 0
    return ids.astype(np.int32)


@pytest.mark.parametrize("cur", [1, 2, 5, 13, 20, 24])
def test_ngram_bans_identical(cur):
    ids = _ids(cur=min(cur, 24))
    jc, jb = js._ngram_bans(jnp.asarray(ids), jnp.asarray(cur), NGRAMS)
    tc, tb = ts._ngram_bans(torch.from_numpy(ids).long(), cur, NGRAMS)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_apply_no_repeat_ngram_identical():
    ids = _ids()
    logits = np.random.default_rng(1).standard_normal((4, 50)).astype(
        np.float32)
    ref = js.apply_no_repeat_ngram(jnp.asarray(logits), jnp.asarray(ids),
                                   jnp.asarray(20), NGRAMS)
    out = ts.apply_no_repeat_ngram(torch.from_numpy(logits),
                                   torch.from_numpy(ids).long(), 20, NGRAMS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_topk_with_ngram_same_noise_same_ids(seed):
    """Temperature 0.7, top-k 16, with banned ids inside the head."""
    b, v, k, cur = 4, 300, 16, 20
    ids = _ids(cur=cur, seed=seed)
    rng = np.random.default_rng(10 + seed)
    logits = rng.standard_normal((b, v)).astype(np.float32)
    logits[:, :12] += 3.0          # the short-vocab ids lead the head
    cand, ban = js._ngram_bans(jnp.asarray(ids), jnp.asarray(cur), NGRAMS)
    assert bool(jnp.any(ban))
    key = jax.random.PRNGKey(seed)
    ref = js.sample_topk_with_ngram(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(cur), NGRAMS, key, 0.7, k)
    noise = torch.from_numpy(np.array(
        jax.random.gumbel(key, (b, k), jnp.float32)))
    out = ts.sample_topk_with_ngram(torch.from_numpy(logits),
                                    torch.from_numpy(ids).long(), cur,
                                    NGRAMS, None, 0.7, k, gumbel=noise)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_greedy_is_banned_argmax():
    ids = _ids()
    logits = np.random.default_rng(3).standard_normal((4, 40)).astype(
        np.float32)
    logits[:, :12] += 3.0
    ref = js.sample_topk_with_ngram(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(20), NGRAMS,
                                    jax.random.PRNGKey(0), 0.0, None)
    out = ts.sample_topk_with_ngram(torch.from_numpy(logits),
                                    torch.from_numpy(ids).long(), 20, NGRAMS,
                                    None, 0.0, None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampler_draws_from_generator():
    logits = torch.randn(3, 100, generator=torch.Generator().manual_seed(0))
    ids = torch.zeros(3, 8, dtype=torch.long)

    def draw(seed):
        return ts.sample_topk_with_ngram(
            logits, ids, 1, NGRAMS, torch.Generator().manual_seed(seed), 0.7,
            16)

    assert torch.equal(draw(5), draw(5))
    top16 = torch.topk(logits, 16).indices
    for seed in range(5):
        out = draw(seed)
        assert all(int(o) in top16[i].tolist() for i, o in enumerate(out))


@pytest.mark.parametrize("k", [1, 4, 16, 40])
def test_topk_equals_lax_top_k_with_ties(k):
    """Values and indices of ``jax.lax.top_k``: ties (at the threshold and
    above it) to the lowest index, -0.0 below +0.0, -inf entries last."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, (5, 40)).astype(np.float32)      # many ties
    x[1] = rng.standard_normal(40).astype(np.float32)
    x[2, :6] = [0.0, -0.0, -0.0, 0.0, -0.0, 0.0]
    x[2, 6:] = -1.0
    x[3, 5:] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = ts.topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
