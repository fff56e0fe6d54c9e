"""The port's flash attention (``image2text_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as ``tests/test_flash_attention.py`` runs them.

The keep mask of the in-kernel dropout is a counter hash, so the two
packages must agree on it bit for bit; with the same seed they then drop
the same probabilities, and the forward and the gradients agree to f32
rounding.  Tolerance: 1e-5 absolute and relative, in f32 with JAX at full
matmul precision (the two sum in different orders; values are O(1)).

The port's side runs on one torch thread (``one_thread``): in a process
that has just run JAX's interpret-mode kernels, torch's first two-thread
``exp`` returned its second thread's half at ~1e-4 relative error in 3 of
20 processes (``gpt2m_encoder``'s dQ, dK, dV then 1–3e-5 from a float64
truth, JAX's 5e-7); on one thread 0 of 48.
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


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU route on one torch thread for each test (restored
    after): see the module docstring."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    # the f32 kernels' family calls at h 2 (kernel_times.FLASH_F32_FAMILIES):
    # nano-mini's multi-query decoder (92 keys, its 16-row soft prompt,
    # dropout 0.1) and Llama-2-7B's (272 keys, causal, head dim 128)
    "f32_nano_mini": (2, 1, 92, 92, 128, True, 16, 0.1),
    "f32_llama7b": (2, 2, 272, 272, 128, True, None, 0.0),
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
    # long keys: 4 heads' 8 query tiles, 2 planes × 16 key tiles, 4 blocks
    # an SM: 528 // 32
    ((2, 4, 1, 256, 1024, 132), ("tiled", 16)),
])
def test_bwd_plan(args, want):
    assert fa.bwd_plan(*args) == want


def test_bwd_plan_resident_up_to_the_threshold():
    """The route switches past RESIDENT_MAX_KEYS (the kernel's SKV_MAX:
    ten warps of 16 keys, as read from the kernel source), whatever the
    other sizes; the tiled route's dK/dV groups are at least 1 and at
    most one a query tile."""
    assert (fa.BWD_TILE_ROWS, fa.BWD_KEY_SLICE) == (32, 16)
    assert fa.RESIDENT_MAX_KEYS == 10 * fa.BWD_KEY_SLICE == 160
    for b, h, hk in ((1, 1, 1), (48, 8, 1), (12, 16, 16)):
        assert fa.bwd_plan(b, h, hk, 64, 160, 132)[0] == "resident"
        route, groups = fa.bwd_plan(b, h, hk, 64, 161, 132)
        assert route == "tiled"
        assert 1 <= groups <= (h if hk == 1 else 1) * 2


@pytest.mark.parametrize("args,want", [
    ((48, 8, 1, 160, 160, 132), ("resident", 5)),    # flagship encoder
    ((48, 8, 1, 136, 136, 132), ("resident", 5)),    # flagship decoder
    ((12, 8, 1, 80, 80, 132), ("resident", 10)),     # GPT-2-medium encoder
    ((12, 16, 16, 112, 112, 132), ("resident", 1)),  # GPT-2 self, 192 planes
    ((12, 16, 16, 112, 64, 132), ("resident", 1)),   # GPT-2 cross
    ((1, 2, 1, 40, 40, 132), ("resident", 2)),       # at least 4 tiles a block
    ((4, 8, 1, 256, 1024, 132), ("tiled", 32)),      # long keys (FLASH_LONG)
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
        assert fa.fwd_plan(b, h, hk, 64, 161, 132) == (
            "tiled", fa.tiled_groups(h, hk, 64))
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


# The tiled route at chip_smoke.py's shapes past 160 keys or at head dim
# 256 on the H100's 132 SMs: the families' largest bf16 training calls
# (probes/kernel_times.py::FLASH_FAMILIES), FLASH_LONG and the head-dim-256
# call of FLASH_HEAD_DIMS.  (b, h, hk, sq, skv, d): the forward's and dQ's
# G (a block each 64-row tile of the folded rows), the dK/dV kernel's G and
# the f32 partials' elements.
TILED_CASES = {
    "nano": ((24, 20, 20, 256, 256, 64), 4, 1, 0),
    "llama13b": ((4, 40, 40, 272, 272, 128), 5, 1, 0),
    # 71·320 rows: 355 tiles; 4 planes × 5 key tiles: G 528 // 20
    "falcon7b": ((4, 71, 1, 320, 320, 64), 355, 26, 2 * 26 * 4 * 320 * 64),
    "qwen": ((1, 12, 12, 272, 272, 128), 5, 8, 2 * 8 * 12 * 272 * 128),
    "gpt2xl": ((12, 25, 25, 320, 320, 64), 5, 1, 0),
    "long_keys": ((4, 8, 1, 256, 1024, 128), 32, 8, 2 * 8 * 4 * 1024 * 128),
    # 40 query tiles (8 heads × 5) cap 528 // 12
    "head_dim_256": ((4, 8, 1, 160, 160, 256), 20, 40,
                     2 * 40 * 4 * 160 * 256),
}


@pytest.mark.parametrize("label", list(TILED_CASES))
def test_tiled_plans_at_the_training_shapes(label):
    """Both plans take the tiled route with G > 0; the dK/dV kernel's G
    stays within DKV_BLOCKS_AN_SM blocks an SM over its key tiles (at
    least 1, at most one a query tile), and the partial buffer holds G
    dK and G dV planes when G > 1, none for G = 1."""
    (b, h, hk, sq, skv, d), fwd_g, dkv_g, part = TILED_CASES[label]
    assert fa.fwd_plan(b, h, hk, sq, skv, 132, d) == ("tiled", fwd_g)
    assert fa.tiled_groups(h, hk, sq) == fwd_g
    assert fa.bwd_plan(b, h, hk, sq, skv, 132, d) == ("tiled", dkv_g)
    key_tiles = b * hk * -(-skv // fa.DKV_KEYS)
    query_tiles = (h if hk == 1 else 1) * -(-sq // fa.DKV_ROWS)
    assert 1 <= dkv_g <= query_tiles
    assert dkv_g == 1 or dkv_g * key_tiles <= fa.DKV_BLOCKS_AN_SM * 132
    assert fa.part_elems(dkv_g, b * hk * skv * d) == part


def test_tiled_tiling_is_read_from_the_kernel_source():
    """TILE_ROWS, TILE_KEYS, DKV_KEYS and DKV_ROWS have one owner, the
    kernel source, which the plans and the pair counts read."""
    src = (fa._build.CSRC / "flash_attention.cu").read_text()
    for name, value in (("TILE_ROWS", fa.TILED_ROWS),
                        ("TILE_KEYS", fa.TILED_KEYS),
                        ("DKV_KEYS", fa.DKV_KEYS),
                        ("DKV_ROWS", fa.DKV_ROWS)):
        assert f"constexpr int {name} = {value};" in src
    assert (fa.TILED_ROWS, fa.TILED_KEYS, fa.DKV_KEYS, fa.DKV_ROWS) == (
        64, 64, 64, 32)
    assert fa.ROUTES == {"resident": 0, "tiled": 1}


@pytest.mark.parametrize("sq,skv,causal", [
    (256, 256, True), (272, 272, True), (320, 320, True), (256, 1024, True),
    (160, 160, True), (160, 160, False), (161, 161, True), (400, 300, True),
    (40, 300, True), (300, 200, False), (1, 161, True)])
def test_tiled_bwd_pairs_equal_the_tiles_the_causal_mask_reaches(sq, skv,
                                                                causal):
    """tiled_bwd_pairs against a count from the mask itself: a (32-row
    query tile, 64-key tile) pair is visited iff some row of the query
    tile sees some key of the key tile, or some row of it sees no key at
    all (causal with sq > skv: it averages over every key)."""
    row = np.arange(sq)[:, None] + (skv - sq)
    col = np.arange(skv)[None, :]
    sees = (col <= row) if causal else np.ones((sq, skv), bool)
    want = sum(bool(sees[r:r + 32, c:c + 64].any()
                    or not sees[r:r + 32].any(-1).all())
               for r in range(0, sq, 32) for c in range(0, skv, 64))
    assert fa.tiled_bwd_pairs(3, 2, sq, skv, causal) == 3 * 2 * want
    if (sq, skv, causal) == (320, 320, True):   # 10 query tiles: 30 of 50
        assert want == 1 + 1 + 2 + 2 + 3 + 3 + 4 + 4 + 5 + 5
    if (sq, skv) == (400, 300):   # rows 0–99 keyless: 4 tiles × 5, then
        assert want == 4 * 5 + 1 + 2 + 2 + 3 + 3 + 4 + 4 + 5 + 5


def test_tiled_cases_are_the_probe_families():
    """TILED_CASES' family shapes are the probe's FLASH_FAMILIES (the
    calls ``[train-kernels]`` records), and every one of those takes the
    tiled route on both plans."""
    from image2text_torch.probes.kernel_times import FLASH_FAMILIES

    for label, b, h, hk, sq, skv, d, causal, n_prefix, rate in FLASH_FAMILIES:
        assert TILED_CASES[label[len("train_"):]][0] == (b, h, hk, sq, skv, d)
        assert fa.fwd_plan(b, h, hk, sq, skv, 132, d)[0] == "tiled"
        assert fa.bwd_plan(b, h, hk, sq, skv, 132, d)[0] == "tiled"
        assert causal and n_prefix is None and rate in (0.0, 0.1)


# The f32 kernels' plans at the families' and the offline configs' f32
# calls (kernel_times.FLASH_F32_FAMILIES) on the H100's 132 SMs: the
# forward's and dQ's G (a block each 64-row tile of the folded rows), the
# dK/dV kernel's G and the f32 partials' elements.
F32_CASES = {
    "f32_llama7b": ((1, 32, 32, 272, 272, 128), 5, 1, 0),
    # 8 query tiles a plane; 24 planes × 4 key tiles: G 264 // 96
    "f32_nano_lsh": ((2, 12, 12, 256, 256, 64), 4, 2, 2 * 2 * 24 * 256 * 64),
    "f32_gpt2": ((4, 12, 12, 272, 272, 64), 5, 1, 0),
    # 16 keys: 48 planes × 1 key tile, 9 query tiles: G 264 // 48
    "f32_gpt2_cross": ((4, 12, 12, 272, 16, 64), 5, 5, 2 * 5 * 48 * 16 * 64),
    # 8 heads × 3 query tiles, 4 planes × 3 key tiles of 32 (d 128): G
    # 264 // 12, 264 blocks
    "f32_nano_mini": ((4, 8, 1, 92, 92, 128), 12, 22, 2 * 22 * 4 * 92 * 128),
    # 36 query tiles, 8 planes × 5 key tiles: G 264 // 40
    "f32_offline_encoder": ((8, 4, 1, 264, 264, 16), 17, 6,
                            2 * 6 * 8 * 264 * 16),
    "f32_offline_decoder": ((8, 4, 1, 128, 128, 16), 8, 16,
                            2 * 16 * 8 * 128 * 16),
}


@pytest.mark.parametrize("label", list(F32_CASES))
def test_f32_plans_at_the_family_shapes(label):
    """f32_groups is one block a 64-row tile of the folded rows; the
    dK/dV G stays within F32_DKV_BLOCKS_AN_SM blocks an SM over its key
    tiles (at least 1, at most one a query tile), and the partial buffer
    holds G dK and G dV planes when G > 1, none for G = 1."""
    from image2text_torch.probes.kernel_times import FLASH_F32_FAMILIES

    (b, h, hk, sq, skv, d), groups, dkv_g, part = F32_CASES[label]
    assert (label, b, h, hk, sq, skv, d) in {c[:7] for c in FLASH_F32_FAMILIES}
    assert fa.f32_groups(h, hk, sq) == groups
    assert fa.f32_bwd_plan(b, h, hk, sq, skv, 132, d) == dkv_g
    key_tiles = b * hk * -(-skv // fa.f32_dkv_keys(d))
    query_tiles = (h if hk == 1 else 1) * -(-sq // fa.F32_DKV_ROWS)
    assert 1 <= dkv_g <= query_tiles
    assert dkv_g == 1 or dkv_g * key_tiles <= fa.F32_DKV_BLOCKS_AN_SM * 132
    assert fa.part_elems(dkv_g, b * hk * skv * d) == part


F32_CONSTANTS = ("F32_TILE_ROWS", "F32_TILE_KEYS", "F32_STAGE_FLOATS",
                 "F32_STAGES", "F32_DKV_KEYS", "F32_DKV_ROWS")


def _f32_constants():
    return dict(zip(F32_CONSTANTS, fa._build.kernel_constants(
        "flash_attention_f32", *F32_CONSTANTS)))


def test_f32_tiling_is_read_from_the_kernel_source():
    """The f32 kernels' tiling has one owner, flash_attention_f32.cu,
    whose constants the plans read; its per-head-dim rules (the stage keys
    of the forward and of dQ, the dK/dV split) are the ones the shared
    memory test below mirrors."""
    c = _f32_constants()
    assert c == dict(F32_TILE_ROWS=64, F32_TILE_KEYS=64,
                     F32_STAGE_FLOATS=4096, F32_STAGES=2, F32_DKV_KEYS=64,
                     F32_DKV_ROWS=32)
    assert (fa.F32_TILE_ROWS, fa.F32_DKV_KEYS, fa.F32_DKV_ROWS) == (
        c["F32_TILE_ROWS"], c["F32_DKV_KEYS"], c["F32_DKV_ROWS"])
    src = (fa._build.CSRC / "flash_attention_f32.cu").read_text()
    for rule in ("return F32_STAGE_FLOATS / d < F32_TILE_KEYS ? "
                 "F32_STAGE_FLOATS / d : F32_TILE_KEYS;",
                 "return d > 64 ? stage_keys(d) / 2 : stage_keys(d);",
                 "return d > 64 ? 2 : 1; }",
                 "return F32_DKV_KEYS / dkv_split(d); }"):
        assert rule in src, rule
    assert [fa.f32_dkv_keys(d) for d in fa.KERNEL_HEAD_DIMS] == [
        64, 64, 64, 32, 32]


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_shared_memory_fits_an_sm(d):
    """Each f32 kernel's block fits the 232,448 bytes a block may take at
    every head dim (rows of d + 4 floats: Q; K and V stages; dO; lse and
    D), from the source's constants and rules, and two forward blocks (as
    the source's launch bounds ask) and two dQ blocks fit an SM (228 KB,
    1 KB a block reserved) up to head dim 128."""
    c = _f32_constants()
    row = (d + 4) * 4
    keys = min(c["F32_TILE_KEYS"], c["F32_STAGE_FLOATS"] // d)
    dq_keys = keys // 2 if d > 64 else keys
    stages, rows = c["F32_STAGES"], c["F32_DKV_ROWS"]
    smem = {"fwd": (c["F32_TILE_ROWS"] + 2 * stages * keys) * row,
            "dq": (2 * c["F32_TILE_ROWS"] + 2 * stages * dq_keys) * row,
            "dkv": (2 * fa.f32_dkv_keys(d) + 2 * stages * rows) * row
            + 2 * stages * rows * 4}
    assert max(smem.values()) <= 232448
    if d <= 128:
        assert 2 * (max(smem["fwd"], smem["dq"]) + 1024) <= 233472
    if d == 128:   # the launch bound's comment
        assert smem["fwd"] == 101376


def test_flash_variants_edit_the_shipped_source():
    """Every text edit of ``probes/flash_variants.py`` finds its line in
    the shipped kernel source, so each variant differs from it only by
    what its name says."""
    from image2text_torch.probes.flash_variants import VARIANTS

    src = (fa._build.CSRC / "flash_attention.cu").read_text()
    assert VARIANTS["shipped"] == ()
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert old in src and old != new, (name, old)


def test_f32_flash_variants_edit_the_shipped_source():
    """Every text edit of ``probes/flash_variants.py``'s f32 variants finds
    its text in the shipped f32 kernel source or the headers it includes
    (the 3xTF32 helpers, shared with the MoE FFN's and the front's f32
    forms, live in ``flash_common.cuh``)."""
    from image2text_torch.probes.flash_variants import F32_VARIANTS

    src = "".join((fa._build.CSRC / f).read_text() for f in (
        "flash_attention_f32.cu", "flash_common.cuh", "common.cuh"))
    assert F32_VARIANTS["shipped"] == ()
    for name, edits in F32_VARIANTS.items():
        for old, new in edits:
            assert old in src and old != new, (name, old)
