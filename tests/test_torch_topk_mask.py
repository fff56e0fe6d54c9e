"""The port's ban + top-k threshold mask against the JAX package's, bit for
bit: ``topk_ban_mask_reference`` (the plain version the CPU runs, and what
the CUDA kernel is held to on the card) against JAX's reference and JAX's
Pallas kernel in interpret mode, on the cases of ``tests/test_topk_mask.py``
plus signed zeros and -inf inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image2text_tpu.ops import topk_mask as jt

from image2text_torch.ops import topk_mask as tt

torch.set_num_threads(2)


def _random_banned(rng, b, v, m):
    """(b, m) int32 banned ids with a sprinkle of -1 empty slots."""
    ids = rng.integers(0, v, (b, m)).astype(np.int32)
    ids[rng.random((b, m)) < 0.3] = -1
    return ids


def _check(logits, banned, k):
    """The port's reference, and its wrapper (on a CPU tensor: the
    reference again, no launch), bit for bit against JAX's reference
    and JAX's kernel in interpret mode."""
    jb = None if banned is None else jnp.asarray(banned)
    want = np.asarray(jt.topk_ban_mask_reference(jnp.asarray(logits), jb, k))
    tb = None if banned is None else torch.from_numpy(banned)
    got = tt.topk_ban_mask_reference(torch.from_numpy(logits), tb, k).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    before = tt.topk_ban_mask.launches
    wrapped = tt.topk_ban_mask(torch.from_numpy(logits), tb, k).numpy()
    assert tt.topk_ban_mask.launches == before
    np.testing.assert_array_equal(wrapped.view(np.int32), want.view(np.int32))
    pallas = np.asarray(jt.topk_ban_mask(jnp.asarray(logits), jb, k,
                                         use_kernel=True))
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    return got


@pytest.mark.parametrize("k", [1, 5, 16, 64])
def test_reference_matches_jax_random(k):
    rng = np.random.default_rng(k)
    b, v, m = 5, 333, 17
    logits = rng.standard_normal((b, v)).astype(np.float32)
    _check(logits, _random_banned(rng, b, v, m), k)


def test_ties_at_threshold_kept():
    rng = np.random.default_rng(0)
    b, v, k = 4, 260, 8
    base = rng.standard_normal((b, v)).astype(np.float32)
    for r in range(b):
        kth = np.sort(base[r])[-k]
        base[r, rng.permutation(v)[:5]] = kth
    got = _check(base, None, k)
    assert (np.isfinite(got).sum(-1) > k).any(), "case must exercise ties"


def test_saturated_bans_and_small_rows():
    rng = np.random.default_rng(3)
    b, v, k = 3, 140, 16
    logits = rng.standard_normal((b, v)).astype(np.float32)
    top = np.argsort(logits, axis=-1)[:, -40:]
    _check(logits, top.astype(np.int32), k)
    wide = np.arange(v)[None, :v - 3].astype(np.int32)
    got = _check(logits[:1], wide, k)     # 137 live bans: past the JAX cap
    assert np.isfinite(got).sum() == 3


def test_k_covers_row_and_negative_rows():
    rng = np.random.default_rng(9)
    logits = (-np.abs(rng.standard_normal((2, 150))) - 1.0).astype(np.float32)
    np.testing.assert_array_equal(_check(logits, None, 150), logits)
    _check(logits, None, 7)


def test_more_live_bans_than_the_jax_cap():
    """M wider than JAX's BAN_CAP (32): few live bans, then one row with
    more live bans than the cap (the JAX wrapper's exact fallback)."""
    rng = np.random.default_rng(21)
    b, v, k = 4, 300, 8
    logits = rng.standard_normal((b, v)).astype(np.float32)
    m = jt.BAN_CAP + 40
    ids = np.full((b, m), -1, np.int32)
    for r in range(b):
        ids[r, :10] = rng.permutation(v)[:10]
    _check(logits, ids, k)
    ids[1, :] = rng.permutation(v)[:m]
    _check(logits, ids, k)


def test_signed_zeros_infinities_and_fully_banned_rows():
    """±0.0 share a key (both stay, each with its sign), -inf inputs, a row
    whose threshold is -inf, a fully banned row, and ids outside [0, V)
    that are dropped."""
    v, k = 40, 6
    logits = np.random.default_rng(5).standard_normal((4, v)).astype(
        np.float32)
    logits[0, :8] = [0.0, -0.0, 0.0, -0.0, -0.0, 0.0, -0.0, 0.0]
    logits[0, 8:] = -1.0
    logits[1, 3:] = -np.inf
    logits[2, ::2] = -np.inf
    banned = np.full((4, v + 2), -1, np.int32)
    banned[2, 1:12:2] = np.arange(1, 12, 2)
    banned[3, :v] = np.arange(v)
    banned[3, v:] = [v, v + 7]
    got = _check(logits, banned, k)
    np.testing.assert_array_equal(np.signbit(got[0, :8]),
                                  np.signbit(logits[0, :8]))
    assert np.isneginf(got[3]).all()
    assert np.isfinite(got[1]).sum() == 3
