"""The port's dense TransformerBlock and the flagship's dense-encoder twin
against the JAX package: the eval block (``ops/fused_block.py``'s plain
``fused_block_plain``, which the block calls on a CPU tensor) against
JAX's ``fused_block_compatible`` in interpret mode and its XLA block, f32
(3e-5) and bf16 (0.06), the tolerances of ``tests/test_fused_block.py``;
then the tiny twin (``configs/models.py::flagship_dense_config``, derived
as ``tools/encoder_phase_probe.py`` derives it): its config, weight keys
and shapes, logits and greedy tokens.  f32 on the CPU, JAX at full matmul
precision; inputs from numpy seeds."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.configs import models as jcm
from image2text_tpu.models.layers import TransformerBlock as JaxBlock
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.nn.core import Ctx as JaxCtx
from image2text_tpu.ops.fused_block import fused_block_compatible
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs import models as tcm
from image2text_torch.models.layers import TransformerBlock
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.ops.fused_block import (fused_block, fused_block_plain,
                                              sparse_block)
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)

torch.set_num_threads(2)


def _block_config(cm, bias):
    """``tests/test_fused_block.py``'s dense block: d 256, 2 heads (hd 128),
    MoE 4 experts top-2."""
    return cm.TransformerConfig(
        is_causal=False, is_cross_attn=False, is_sparse_attn=False,
        attn_config=cm.SelfAttentionConfig(
            attn_dropout=0.1, bias=bias, dropout=0.1, n_head=2, n_embd=256,
            attn_type=cm.SelfAttentionType.MULTI_QUERY),
        rotator_config=cm.MoEConfig(num_experts=4, proj_features=16,
                                    gate_sizes=(32,), ff_mult_factor=2.0,
                                    top_k=2))


@pytest.fixture(scope="module", params=[True, False], ids=["bias", "no_bias"])
def blocks(request):
    jblk = JaxBlock(_block_config(jcm, request.param), seed=None, n_cls=0)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0))
    tblk = TransformerBlock(_block_config(tcm, request.param), device="cpu")
    load_jax_state_dict(tblk, export_state_dict(jblk, params))
    return jblk, params, tblk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block_matches_jax_kernel_and_xla_block(blocks, dtype):
    jblk, params, tblk = blocks
    dt = jnp.dtype(dtype)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, params)
    x = (0.3 * np.random.default_rng(1).standard_normal((4, 16, 256))
         ).astype(np.float32)
    xj = jnp.asarray(x, dt)
    with jax.default_matmul_precision("highest"):
        kernel = fused_block_compatible(jblk, params, xj, interpret=True)
        xla = jax.jit(lambda p, x: jblk(p, x, ctx=JaxCtx(train=False),
                                        use_flash=False))(params, xj)
    assert kernel is not None
    tdt = getattr(torch, dtype)
    tblk = copy.deepcopy(tblk).to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    counts = fused_block.launches, sparse_block.launches
    with torch.no_grad():
        out, layout = tblk(xt, want_lazy=True)
        assert torch.equal(out, fused_block_plain(
            xt, tblk.block_weights(tdt)))
        plain_block = tblk(xt, use_flash=False)
    assert layout is None and out.shape == xt.shape and out.dtype == tdt
    assert (fused_block.launches, sparse_block.launches) == counts
    tol = 3e-5 if dtype == "float32" else 0.06
    for ref in (kernel, xla):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(plain_block.float().numpy(),
                               np.asarray(xla, np.float32), rtol=tol,
                               atol=tol)


def test_dense_block_contract(blocks):
    """No selection buffers and no null connector; canonical layout out;
    a cache of ``max_len`` slots; a lazy layout coming in is undone first;
    the dense cached decode (a 16-row prefill into the cache) equals the
    forward under a causal mask, the cache's own bias over its slots."""
    _, _, tblk = blocks
    assert tblk.null_connector is None
    assert not any("input_mask" in k for k, _ in tblk.named_buffers())
    assert tblk.next_layout(np.arange(16)[::-1], 16) is None
    assert tblk.runs_body(16) and tblk.cache_shape(3, 40) == (3, 1, 40, 128)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 256)).astype(np.float32))
    perm = np.random.default_rng(3).permutation(16)
    with torch.no_grad():
        want = tblk(x)
        got, layout = tblk(x[:, perm], layout=perm, want_lazy=True)
    assert layout is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    from image2text_torch.models.kv_cache import CacheRef, KVCache
    from image2text_torch.ops.attention import causal_bias

    ref = CacheRef(KVCache.create([tblk.cache_shape(2, 16)]))
    ref.positions = np.arange(16)
    with torch.no_grad():
        cached = tblk(x, kv_cache=ref)
        masked = tblk(x, attn_mask=causal_bias(16, 16))
    np.testing.assert_allclose(cached.numpy(), masked.numpy(), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="lazy layout"):
        tblk(x, kv_cache=ref, layout=perm)


@pytest.fixture(scope="module")
def twin():
    cfg = _flagship_config(tiny=True).model
    cfg.vision_encoder_config.transformer_config.is_sparse_attn = False
    jm = JaxModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    sd = export_state_dict(jm, params)
    tm = VisionEncoderDecoder(tcm.flagship_dense_config(tiny=True),
                              device="cpu")
    load_jax_state_dict(tm, sd)
    return jm, params, sd, tm, cfg


def test_dense_twin_config_keys_and_shapes_match_jax(twin):
    from test_torch_imports import _assert_same

    _, _, sd, tm, cfg = twin
    _assert_same(tcm.flagship_dense_config(tiny=True), cfg)
    _assert_same(tcm.FLAGSHIP_DENSE.vision_encoder_config,
                 tcm.flagship_dense_config().vision_encoder_config)
    assert not tcm.FLAGSHIP_DENSE.vision_encoder_config.transformer_config \
        .is_sparse_attn
    assert tcm.FLAGSHIP_DENSE.decoder_config == tcm.FLAGSHIP.decoder_config
    mine = state_dict_numpy(tm)
    assert set(mine) == set(sd)
    assert not any(k.startswith("encoder.") and ("input_mask" in k
                                                 or "null_connector" in k)
                   for k in sd)
    for k, v in sd.items():
        assert mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def test_dense_twin_logits_match_jax(twin):
    jm, params, _, tm, _ = twin
    img = _images()
    ids = np.random.default_rng(1).integers(0, 512, (2, 12))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, d: jm(p, i, d).logits)(
            params, jnp.asarray(img), jnp.asarray(ids)))
    counts = fused_block.launches
    with torch.no_grad():
        out = tm(torch.from_numpy(img), torch.from_numpy(ids)).logits.numpy()
    assert fused_block.launches == counts    # CPU: the plain version
    assert out.shape == (2, 12, 512)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


def test_dense_twin_greedy_tokens_match_jax(twin):
    """Greedy, n-grams 2–5, 8 new tokens, 2 images: JAX ``generate``'s ids
    exactly."""
    jm, params, _, tm, _ = twin
    img = _images(seed=11)
    prompt = np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, d: jm.generate(
            p, i, d, max_new_tokens=8, temperature=0.0,
            rng=jax.random.PRNGKey(0)))(params, jnp.asarray(img),
                                        jnp.asarray(prompt)))
    out = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=8, temperature=0.0).numpy()
    assert out.shape == (2, 9)
    np.testing.assert_array_equal(out, ref)
