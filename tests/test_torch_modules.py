"""The PyTorch port's primitive modules and ops against the JAX package's,
on the same inputs (made with numpy from a seed), f32 on the CPU with JAX
at full matmul precision."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.nn import modules as jm
from image2text_tpu.ops import attention as ja
from image2text_tpu.ops import functions as jf
from image2text_tpu.ops import preprocess as jp
from image2text_tpu.ops import static_gather as jg

from image2text_torch.nn import modules as tm
from image2text_torch.ops import attention as ta
from image2text_torch.ops import functions as tf
from image2text_torch.ops import preprocess as tp
from image2text_torch.ops import static_gather as tg

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _load(module, arrays):
    with torch.no_grad():
        for name, value in arrays.items():
            dict(module.named_parameters())[name].copy_(torch.from_numpy(value))


def test_gelu_tanh():
    x = _rng().standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(tm.gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.gelu_tanh(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm(bias):
    r = _rng(1)
    x = (r.standard_normal((3, 5, 16)) * 2 + 1).astype(np.float32)
    p = {"weight": r.standard_normal(16).astype(np.float32)}
    if bias:
        p["bias"] = r.standard_normal(16).astype(np.float32)
    ref = jm.LayerNorm(16, bias=bias)({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x))
    mod = tm.LayerNorm(16, bias, device="cpu")
    _load(mod, p)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), **TOL)


def test_layer_norm_nd_over_whole_slab():
    r = _rng(2)
    x = (r.standard_normal((3, 8, 16)) * 2 + 1).astype(np.float32)
    p = {"weight": r.standard_normal((8, 16)).astype(np.float32),
         "bias": r.standard_normal((8, 16)).astype(np.float32)}
    ref = jm.LayerNormND((8, 16), True)({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x))
    mod = tm.LayerNormND((8, 16), True, device="cpu")
    _load(mod, p)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), **TOL)


def test_conv2d_same_even_kernel():
    """'SAME' with a 6x6 kernel pads 2 before and 3 after (XLA's rule)."""
    r = _rng(3)
    x = r.standard_normal((2, 3, 17, 20)).astype(np.float32)
    p = {"weight": (r.standard_normal((8, 3, 6, 6)) * 0.1).astype(np.float32),
         "bias": r.standard_normal(8).astype(np.float32)}
    with jax.default_matmul_precision("highest"):
        ref = jm.Conv2d(3, 8, (6, 6))({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x))
    mod = tm.Conv2d(3, 8, (6, 6), device="cpu")
    _load(mod, p)
    out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 8, 17, 20)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_resize_normalize_on_device():
    u8 = _rng(4).integers(0, 256, (2, 160, 240, 3)).astype(np.uint8)
    ref = jp.resize_normalize_on_device(jnp.asarray(u8), 128)
    out = tp.resize_normalize_on_device(torch.from_numpy(u8), 128)
    assert out.shape == (2, 3, 128, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["plain", "bias", "causal", "bf16"])
def test_sdpa_multi_query(kind):
    r = _rng(5)
    q = r.standard_normal((2, 4, 5, 16)).astype(np.float32)
    k = r.standard_normal((2, 1, 7, 16)).astype(np.float32)
    v = r.standard_normal((2, 1, 7, 16)).astype(np.float32)
    mask = None
    if kind == "bias":
        mask = r.standard_normal((1, 1, 5, 7)).astype(np.float32)
        mask[..., 1, :] = -np.inf    # a fully masked row: safe softmax → 0
        mask[..., 2, 3] = -np.inf
    causal = kind == "causal"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kind == "bf16"
                else (jnp.float32, torch.float32))
    with jax.default_matmul_precision("highest"):
        ref = ja.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                      mask=None if mask is None else jnp.asarray(mask),
                      causal=causal)
    out = ta.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                  mask=None if mask is None else torch.from_numpy(mask),
                  causal=causal)
    assert out.dtype == tdt
    tol = dict(atol=2e-2, rtol=2e-2) if kind == "bf16" else TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_causal_bias():
    np.testing.assert_array_equal(ta.causal_bias(3, 5).numpy(),
                                  np.asarray(ja.causal_bias(3, 5)))


def test_static_gathers_bit_equal_under_permuted_layout():
    r = _rng(6)
    x = r.standard_normal((2, 10, 4)).astype(np.float32)
    layout = r.permutation(10)
    idx = np.sort(r.permutation(10)[:6])
    not_idx = np.setdiff1d(np.arange(10), idx)
    rows = jg.layout_rows(layout, idx)
    np.testing.assert_array_equal(tg.layout_rows(layout, idx), rows)
    with jax.default_matmul_precision("highest"):
        ref_take = jg.static_take(jnp.asarray(x), rows)
        sel, byp = ref_take, jg.static_take(jnp.asarray(x),
                                            jg.layout_rows(layout, not_idx))
        ref_comb = jg.static_combine(sel, byp, idx, not_idx)
        ref_can = jg.canonicalize(jnp.asarray(x), layout)
    xt = torch.from_numpy(x)
    take = tg.static_take(xt, rows)
    np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
    comb = tg.static_combine(take, tg.static_take(
        xt, tg.layout_rows(layout, not_idx)), idx, not_idx)
    np.testing.assert_array_equal(comb.numpy(), np.asarray(ref_comb))
    np.testing.assert_array_equal(tg.canonicalize(xt, layout).numpy(),
                                  np.asarray(ref_can))


def test_multihead_attention_with_precomputed_kv():
    r = _rng(7)
    e, h = 32, 4
    p = {"in_proj_weight": (r.standard_normal((3 * e, e)) * 0.2).astype(np.float32),
         "in_proj_bias": r.standard_normal(3 * e).astype(np.float32),
         "out_proj.weight": (r.standard_normal((e, e)) * 0.2).astype(np.float32),
         "out_proj.bias": r.standard_normal(e).astype(np.float32)}
    query = r.standard_normal((2, 3, e)).astype(np.float32)
    mem = r.standard_normal((2, 9, e)).astype(np.float32)
    jp_ = {"in_proj_weight": jnp.asarray(p["in_proj_weight"]),
           "in_proj_bias": jnp.asarray(p["in_proj_bias"]),
           "out_proj": {"weight": jnp.asarray(p["out_proj.weight"]),
                        "bias": jnp.asarray(p["out_proj.bias"])}}
    jmod = jm.MultiheadAttention(e, h)
    with jax.default_matmul_precision("highest"):
        kv = jmod.project_kv(jp_, jnp.asarray(mem), jnp.asarray(mem))
        ref = jmod(jp_, jnp.asarray(query), None, None, precomputed_kv=kv)
    mod = tm.MultiheadAttention(e, h, device="cpu")
    _load(mod, p)
    tkv = mod.project_kv(torch.from_numpy(mem), torch.from_numpy(mem))
    for a, b in zip(tkv, kv):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    out = mod(torch.from_numpy(query), precomputed_kv=tkv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    direct = mod(torch.from_numpy(query), torch.from_numpy(mem),
                 torch.from_numpy(mem))
    np.testing.assert_allclose(direct.detach().numpy(), np.asarray(ref), **TOL)


def test_normalize_gradients():
    g = _rng(8).standard_normal((3, 4)).astype(np.float32)
    x = torch.zeros(3, 4, requires_grad=True)
    y = tf.normalize_gradients(x)
    assert torch.equal(y.detach(), x.detach())
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jf.normalize_gradients, jnp.zeros((3, 4)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **TOL)
