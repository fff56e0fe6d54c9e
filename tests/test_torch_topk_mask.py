"""The port's ban + top-k threshold mask against the JAX package's, bit for
bit: ``topk_ban_mask_reference`` (the plain version the CPU runs, and what
the CUDA kernel is held to on the card) against JAX's reference and JAX's
Pallas kernel in interpret mode, on the cases of ``tests/test_topk_mask.py``
plus signed zeros and -inf inputs.  The CUDA kernel's radix select, in its
plain emulation ``tests/torch_radix_select.py::kth_key_radix``, against
the reference's k-th value on engineered rows."""
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


def _kth_key(logits, banned, k):
    """The reference's k-th value after the bans, as the monotone int32 key."""
    x = torch.from_numpy(logits).clone()
    if banned is not None:
        for r, ids in enumerate(banned):
            live = [int(i) for i in ids if 0 <= i < x.shape[1]]
            x[r, live] = float("-inf")
    kth = torch.topk(x, min(k, x.shape[1])).values[:, -1].contiguous()
    i = kth.view(torch.int32).long()
    return torch.where(i >= 0, i, -(2 ** 31) - i).to(torch.int32)


def _digit_boundary_row(v):
    """Keys straddling the first digit's (2**21) and the second's (2**10)
    boundaries around 1.0 (bits 0x3F800000, a multiple of 2**21), with
    repeats, among N(0, 1) values."""
    x = np.random.default_rng(2).standard_normal(v).astype(np.float32) * 0.1
    bits = np.array([0x3F800000 + o for o in (-2 ** 10, -1, -1, 0, 0, 1,
                                               2 ** 10 - 1, 2 ** 10, 2 ** 10,
                                               2 ** 21, 2 ** 21 + 5)],
                    np.uint32)
    x[:bits.size] = bits.view(np.float32)
    return x


@pytest.mark.parametrize("case", ["random", "signed_zeros", "neg_inf",
                                  "ties", "saturated_bans", "k_covers_row",
                                  "equal_values", "digit_boundaries",
                                  "bans_past_the_guess"])
@pytest.mark.parametrize("k", [1, 3, 6, 16])
def test_kth_key_radix_matches_the_reference_kth(case, k):
    """The kernel's three-digit radix select, emulated step for step (the
    sampled guess, ban corrections, the candidate list and its routes),
    finds the reference's exact k-th key: signed zeros (one key), -inf
    inputs and thresholds, ties, saturated and repeated bans, k at or past
    the unbanned count, a row of one value (its first digit's bin
    overflows a small list), ties across the digit boundaries, bans of
    the row's top 200 values (the k-th key's digit lies below the guess:
    the second read of the row)."""
    from torch_radix_select import CAND_CAP, kth_key_radix

    rng = np.random.default_rng(k)
    v = 300
    logits = rng.standard_normal((3, v)).astype(np.float32)
    banned = _random_banned(rng, 3, v, 17)
    cand_cap = 64
    if case == "signed_zeros":
        logits[:, :40] = np.where(np.arange(40) % 2, -0.0, 0.0)
        logits[:, 40:] = -np.abs(logits[:, 40:]) - 1
    elif case == "neg_inf":
        logits[0, 2:] = -np.inf
        logits[1, ::2] = -np.inf
    elif case == "ties":
        for r in range(3):
            logits[r, rng.permutation(v)[:7]] = np.sort(logits[r])[-k]
    elif case == "saturated_bans":
        banned = np.argsort(logits, axis=-1)[:, -40:].astype(np.int32)
        banned[:, :5] = banned[:, 5:6]                  # repeated ids
    elif case == "k_covers_row":
        banned = np.tile(np.arange(v - 2, dtype=np.int32), (3, 1))
    elif case == "equal_values":
        logits[:] = 0.25
    elif case == "digit_boundaries":
        logits = np.stack([_digit_boundary_row(v)] * 3)
        banned[2] = -1
        banned[2, :3] = [3, 4, 9]     # two of the repeated keys, and one more
    elif case == "bans_past_the_guess":
        banned = np.argsort(logits, axis=-1)[:, -200:].astype(np.int32)
        cand_cap = CAND_CAP
    for ban in (None, banned):
        got, routes = kth_key_radix(torch.from_numpy(logits),
                                    None if ban is None
                                    else torch.from_numpy(ban), k,
                                    cand_cap=cand_cap)
        np.testing.assert_array_equal(got.numpy(),
                                      _kth_key(logits, ban, k).numpy())
        if case == "equal_values":
            assert routes == ["overflow"] * 3
        if case == "bans_past_the_guess":
            assert routes == ["list" if ban is None else "guess_high"] * 3
