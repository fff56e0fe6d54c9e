"""The port's flash attention (``image2text_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as ``tests/test_flash_attention.py`` runs them.

The keep mask of the in-kernel dropout is a counter hash, so the two
packages must agree on it bit for bit; with the same seed they then drop
the same probabilities, and the forward and the gradients agree to f32
rounding.  Tolerance: 1e-5 absolute and relative, in f32 with JAX at full
matmul precision (the two sum in different orders; values are O(1)).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.ops.flash_attention import (
    dropout_keep_mask as jax_keep_mask, flash_sdpa as jax_flash_sdpa)

from image2text_torch.ops import flash_attention as fa

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1234567, -1, -2 ** 31, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bit_equal_to_jax(seed, rate):
    """Rows, columns and planes past 2^16, negative seeds."""
    rng = np.random.default_rng(abs(seed) % 1000)
    rows = np.concatenate([np.arange(70), rng.integers(0, 1 << 20, 60)])
    cols = np.concatenate([np.arange(50), rng.integers(0, 1 << 20, 40)])
    planes = np.array([0, 1, 7, 383, 65535, 65536, 1 << 20])
    r, c, p = rows[None, :, None], cols[None, None, :], planes[:, None, None]
    want = np.asarray(jax_keep_mask(jnp.asarray(r, jnp.int32),
                                    jnp.asarray(c, jnp.int32),
                                    jnp.asarray(p, jnp.int32),
                                    jnp.asarray(seed, jnp.int32), rate))
    got = fa.dropout_keep_mask(torch.from_numpy(r), torch.from_numpy(c),
                               torch.from_numpy(p), seed, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.01


def _soft_prompt_bias(s, n_prefix):
    bias = np.zeros((1, 1, s, s), np.float32)
    bias[..., n_prefix:, :n_prefix] = -np.inf
    return bias


def _case(name):
    """(b, h, hk, sq, skv, d, bias, causal, rate) of each case."""
    rng = np.random.default_rng(7)
    if name == "mqa_s40":
        return 2, 4, 1, 40, 40, 16, None, False, 0.0
    if name == "mha_s137_causal_soft_prompt":
        return 2, 2, 2, 137, 137, 32, _soft_prompt_bias(137, 9), True, 0.1
    if name == "mqa_causal_sq_below_skv":
        return 1, 4, 1, 40, 137, 16, None, True, 0.1
    if name == "mqa_causal_sq_above_skv_bias":
        # the first 72 rows see no key: with skv a multiple of the TPU
        # kernel's 128-column tile, both give them the uniform average
        bias = np.zeros((1, 1, 1, 128), np.float32)
        bias[..., 3] = -np.inf
        return 1, 2, 1, 200, 128, 16, bias, True, 0.0
    if name == "per_batch_bias":
        bias = np.zeros((2, 1, 40, 40), np.float32)
        bias[:, :, 8:, :8] = -np.inf
        bias[0, :, :, 30:] = -np.inf
        return 2, 2, 1, 40, 40, 16, bias, False, 0.1
    if name == "per_head_bias":
        bias = rng.standard_normal((1, 2, 137, 137)).astype(np.float32)
        bias[0, 1, :, 100:] = -np.inf
        return 2, 2, 2, 137, 137, 16, bias, False, 0.0
    if name == "fully_masked_rows":
        # skv a multiple of the TPU kernel's 128-column tile: there its
        # padded columns would join a fully masked row's average
        bias = np.zeros((1, 1, 128, 128), np.float32)
        bias[..., 100:, :] = -np.inf
        return 1, 2, 1, 128, 128, 16, bias, False, 0.1
    raise KeyError(name)


CASES = ["mqa_s40", "mha_s137_causal_soft_prompt", "mqa_causal_sq_below_skv",
         "mqa_causal_sq_above_skv_bias", "per_batch_bias", "per_head_bias",
         "fully_masked_rows"]


@pytest.mark.parametrize("name", CASES)
def test_flash_forward_and_gradients_match_jax(name):
    b, h, hk, sq, skv, d, bias, causal, rate = _case(name)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, skv, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    seed = -123456789
    jb = None if bias is None else jnp.asarray(bias)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_sdpa(q_, k_, v_, jb, causal, rate,
                                              jnp.int32(seed)),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    before = fa.flash_fwd.launches
    got = fa.flash_sdpa(tq, tk, tv, tb, causal, rate, seed)
    got.backward(torch.from_numpy(g))
    assert fa.flash_fwd.launches == before  # CPU: plain versions only
    for name_, mine, ref in zip(("out", "dq", "dk", "dv"),
                                (got, tq.grad, tk.grad, tv.grad), want):
        tol = dict(TOL)
        if name == "fully_masked_rows":
            # the 28 keyless rows average all 128 keys, and their terms
            # join every key's dK/dV sum at the tensor's largest values:
            # f32 sums taken in another order differ at 1e-5 of the
            # tensor's scale, not of each element (kernel_check's rule)
            tol["atol"] = TOL["atol"] * float(np.abs(ref).max())
        np.testing.assert_allclose(mine.detach().numpy(), ref, err_msg=name_,
                                   **tol)
    if name == "fully_masked_rows":   # the uniform average, not zeros
        keep = fa._keep(b, h, sq, skv, seed, rate, "cpu")[0, 0, 100]
        uniform = (keep[:, None] / (1 - rate) * torch.from_numpy(v[0, 0])
                   ).mean(0)
        np.testing.assert_allclose(got[0, 0, 100].detach().numpy(),
                                   uniform.numpy(), **TOL)


def test_dropout_rate_changes_the_result_and_seed_matters():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16))
                                .astype(np.float32)) for _ in range(3))
    base = fa.flash_sdpa(q, k, v)
    a = fa.flash_sdpa(q, k, v, rate=0.1, seed=5)
    assert not torch.allclose(a, base)
    assert torch.equal(a, fa.flash_sdpa(q, k, v, rate=0.1, seed=5))
    assert not torch.equal(a, fa.flash_sdpa(q, k, v, rate=0.1, seed=6))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_sdpa(q, k, v, rate=0.1)


# -- the single backward (flash_bwd) ------------------------------------------

# The training attention shapes (chip_smoke.py's FLASH_FLAGSHIP and
# FLASH_GPT2M) at batch 2: (h, hk, sq, skv, d, causal, soft-prompt prefix,
# dropout rate).
TRAIN_SHAPES = {
    "flagship_encoder": (8, 1, 160, 160, 128, False, None, 0.1),
    "flagship_decoder": (8, 1, 136, 136, 128, True, 32, 0.1),
    "gpt2m_encoder": (8, 1, 80, 80, 64, False, None, 0.1),
    "gpt2m_self": (16, 16, 112, 112, 64, True, None, 0.0),
    "gpt2m_cross": (16, 16, 112, 64, 64, False, None, 0.0),
}


@pytest.mark.parametrize("label", list(TRAIN_SHAPES))
def test_flash_bwd_cpu_route_matches_jax_at_training_shapes(label):
    """flash_bwd on CPU tensors (its plain route) from the port's forward
    statistics: dQ, dK and dV against the gradients of JAX's flash_sdpa
    (its Pallas backward kernels in interpret mode), same dropout seed.
    Tolerance as above, at each tensor's scale (sums of up to 8·160 terms
    in another order)."""
    h, hk, sq, skv, d, causal, n_prefix, rate = TRAIN_SHAPES[label]
    b, seed = 2, -55555
    rng = np.random.default_rng(3)
    q, g = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, hk, skv, d)).astype(np.float32)
            for _ in range(2))
    bias = None if n_prefix is None else _soft_prompt_bias(sq, n_prefix)
    jb = None if bias is None else jnp.asarray(bias)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_sdpa(q_, k_, v_, jb, causal, rate,
                                              jnp.int32(seed)),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = fa.flash_fwd(tq, tk, tv, tb, causal, rate, seed)
    dvec = (tg * out).sum(-1)
    before = fa.flash_bwd.launches
    got = fa.flash_bwd(tq, tk, tv, tb, causal, tg, lse, dvec, rate, seed)
    assert fa.flash_bwd.launches == before   # CPU: the plain version
    for name, mine, ref in zip(("dq", "dk", "dv"), got, want):
        assert mine.shape == ref.shape, name
        np.testing.assert_allclose(
            mine.numpy(), ref, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(ref).max())),
            err_msg=name)


@pytest.mark.parametrize("args,want", [
    ((48, 8, 1, 160, 160, 132), ("resident", 2)),    # flagship encoder
    ((48, 8, 1, 136, 136, 132), ("resident", 2)),    # flagship decoder
    ((12, 8, 1, 80, 80, 132), ("resident", 11)),     # GPT-2-medium encoder
    ((12, 16, 16, 112, 112, 132), ("resident", 1)),  # GPT-2 self, 192 planes
    ((1, 2, 1, 40, 40, 132), ("resident", 4)),       # at most one per tile
    ((2, 4, 1, 256, 1024, 132), ("tiled", 0)),       # long keys
])
def test_bwd_plan(args, want):
    assert fa.bwd_plan(*args) == want


def test_bwd_plan_resident_up_to_the_threshold():
    """The route switches past RESIDENT_MAX_KEYS (the kernel's SKV_MAX:
    ten warps of 16 keys, as read from the kernel source), whatever the
    other sizes; the tiled route is the kernel's groups 0."""
    assert (fa.BWD_TILE_ROWS, fa.BWD_KEY_SLICE) == (32, 16)
    assert fa.RESIDENT_MAX_KEYS == 10 * fa.BWD_KEY_SLICE == 160
    for b, h, hk in ((1, 1, 1), (48, 8, 1), (12, 16, 16)):
        assert fa.bwd_plan(b, h, hk, 64, 160, 132)[0] == "resident"
        assert fa.bwd_plan(b, h, hk, 64, 161, 132) == ("tiled", 0)


@pytest.mark.parametrize("args,want", [
    ((48, 8, 1, 160, 160, 132), ("resident", 5)),    # flagship encoder
    ((48, 8, 1, 136, 136, 132), ("resident", 5)),    # flagship decoder
    ((12, 8, 1, 80, 80, 132), ("resident", 10)),     # GPT-2-medium encoder
    ((12, 16, 16, 112, 112, 132), ("resident", 1)),  # GPT-2 self, 192 planes
    ((12, 16, 16, 112, 64, 132), ("resident", 1)),   # GPT-2 cross
    ((1, 2, 1, 40, 40, 132), ("resident", 2)),       # at least 4 tiles a block
    ((4, 8, 1, 256, 1024, 132), ("tiled", 0)),       # long keys (FLASH_LONG)
])
def test_fwd_plan(args, want):
    """The forward's route and groups at chip_smoke.py's flash shapes
    (FLASH_FLAGSHIP, FLASH_GPT2M, FLASH_LONG) on the H100's 132 SMs."""
    assert fa.fwd_plan(*args) == want


def test_fwd_plan_reads_the_kernel_tiling_and_fills_one_wave():
    """The route switches past RESIDENT_MAX_KEYS (160, the backward's too);
    the tiling comes from the kernel source (which asserts that two blocks
    of the largest resident shape, d 128 and 160 keys, fit an SM), so
    G·planes within FWD_BLOCKS_PER_SM·n_sms is one wave."""
    src = (fa._build.CSRC / "flash_attention.cu").read_text()
    for name, value in (("FWD_ROWS", fa.FWD_TILE_ROWS),
                        ("FWD_WARPS", fa.FWD_WARPS),
                        ("FWD_SLICE", fa.FWD_KEY_SLICE),
                        ("FWD_BLOCKS_PER_SM", fa.FWD_BLOCKS_PER_SM)):
        assert f"constexpr int {name} = {value};" in src
    assert (fa.FWD_TILE_ROWS, fa.FWD_WARPS, fa.FWD_KEY_SLICE,
            fa.FWD_BLOCKS_PER_SM) == (16, 4, 32, 2)
    for b, h, hk in ((1, 1, 1), (48, 8, 1), (12, 16, 16), (200, 16, 16)):
        assert fa.fwd_plan(b, h, hk, 64, 160, 132)[0] == "resident"
        assert fa.fwd_plan(b, h, hk, 64, 161, 132) == ("tiled", 0)
        for n_sms in (1, 66, 132, 144):
            _, g = fa.fwd_plan(b, h, hk, 160, 160, n_sms)
            assert g >= 1
            if b * hk <= fa.FWD_BLOCKS_PER_SM * n_sms:
                assert g * b * hk <= fa.FWD_BLOCKS_PER_SM * n_sms


@pytest.mark.parametrize("sq,skv,causal", [
    (136, 136, True), (160, 160, False), (112, 112, True), (112, 64, False),
    (40, 137, True), (1, 1, True), (33, 160, True), (200, 128, True),
    (112, 64, True)])
def test_bwd_pairs_equal_the_slices_the_causal_mask_reaches(sq, skv, causal):
    """bwd_pairs against a count from the mask itself: a (32-row query
    tile, 16-key slice) pair is visited iff some row of the tile sees some
    key of the slice, or some row of the tile sees no key at all (causal
    with sq > skv: such a row averages over every key)."""
    row = np.arange(sq)[:, None] + (skv - sq)
    col = np.arange(skv)[None, :]
    sees = (col <= row) if causal else np.ones((sq, skv), bool)
    want = sum(bool(sees[r:r + 32, c:c + 16].any()
                    or not sees[r:r + 32].any(-1).all())
               for r in range(0, sq, 32) for c in range(0, skv, 16))
    assert fa.bwd_pairs(3, 2, sq, skv, causal) == 3 * 2 * want
    if (sq, skv) == (136, 136):   # the flagship decoder: 29 of 45 a head
        assert want == 29 and fa.bwd_pairs(1, 1, sq, skv, False) == 45
    if (sq, skv) == (200, 128):   # 3 keyless tiles × 8 slices, then the band
        assert want == 3 * 8 + 4 + 6 + 8 + 8
