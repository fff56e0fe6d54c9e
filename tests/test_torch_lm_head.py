"""The port's bf16 products with f32 sums (``ops/functions.py::dot_f32``)
against the JAX package's: the tied lm_head (``dot_general`` with
``preferred_element_type=f32``, ``image2text_tpu/models/decoder.py``) and
the eval attention's scores (``image2text_tpu/ops/attention.py::sdpa``).

On the CPU ``dot_f32`` multiplies the bf16 values in f32 (they are exact
there); on the card it calls ``aten::mm.dtype``/``bmm.dtype`` without an
f32 copy of either operand (``tests/test_torch_cuda.py`` holds that).  Its
backward is JAX's: the f32 cotangent against the other operand in f32,
rounded to bf16.  Tolerances: forward 1e-5 relative at the output's scale
(the same f32 sums in another order); gradients one bf16 rounding step
(2^-8 relative) at the tensor's scale, since two f32 sums that differ in
the last bits may round to neighbouring bf16 values.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.ops.attention import sdpa as jax_sdpa

from image2text_torch.ops.attention import sdpa
from image2text_torch.ops.functions import dot_f32

torch.set_num_threads(2)


def _bf16(rng, *shape, scale=1.0):
    """numpy f32 values that are exact in bf16, as a torch bf16 tensor and
    a JAX bf16 array."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * scale).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _jax_logits(x, w):
    return jax.lax.dot_general(
        x, w.astype(x.dtype), dimension_numbers=(((x.ndim - 1,), (1,)),
                                                 ((), ())),
        preferred_element_type=jnp.float32)


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 64)])
def test_lm_head_logits_and_gradients_match_jax(shape):
    rng = np.random.default_rng(0)
    x, jx = _bf16(rng, *shape)
    w, jw = _bf16(rng, 97, 64, scale=0.02)
    g = rng.standard_normal(shape[:-1] + (97,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, vjp = jax.vjp(_jax_logits, jx, jw)
        want_dx, want_dw = (np.asarray(t.astype(jnp.float32))
                            for t in vjp(jnp.asarray(g)))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = dot_f32(xt, wt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    got.backward(torch.from_numpy(g))
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for mine, ref in ((xt.grad, want_dx), (wt.grad, want_dw)):
        np.testing.assert_allclose(mine.float().numpy(), ref, rtol=2 ** -8,
                                   atol=2 ** -8 * float(np.abs(ref).max()))


def test_lm_head_casts_the_weight_to_the_hidden_dtype():
    """An f32 weight with bf16 hidden states is rounded to bf16 first, as
    JAX's ``wte.astype(x.dtype)``; f32 hidden states multiply in f32."""
    rng = np.random.default_rng(1)
    x, _ = _bf16(rng, 4, 32)
    w = torch.from_numpy(rng.standard_normal((9, 32)).astype(np.float32))
    want = x.float() @ w.to(torch.bfloat16).float().t()
    torch.testing.assert_close(dot_f32(x, w), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(dot_f32(x.float(), w), x.float() @ w.t())


@pytest.mark.parametrize("h,hk,s,l,masked,causal", [
    (4, 1, 5, 9, False, False),    # multi-query: heads folded into rows
    (4, 4, 5, 9, True, False),     # every head its own K/V, a mask
    (2, 1, 7, 7, False, True),     # causal self-attention
    (2, 1, 1, 12, False, False),   # one decode step against a cache
])
def test_eval_sdpa_bf16_matches_jax(h, hk, s, l, masked, causal):
    """Scores as bf16 products summed in f32, scaled, rounded to bf16; the
    softmax in f32; the probabilities in bf16 before the V product."""
    rng = np.random.default_rng(2)
    q, jq = _bf16(rng, 2, h, s, 16)
    k, jk = _bf16(rng, 2, hk, l, 16)
    v, jv = _bf16(rng, 2, hk, l, 16)
    mask = jmask = None
    if masked:
        m = np.zeros((2, 1, s, l), np.float32)
        m[0, ..., 6:] = -np.inf
        mask, jmask = torch.from_numpy(m), jnp.asarray(m)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sdpa(jq, jk, jv, jmask, causal=causal).astype(
            jnp.float32))
    got = sdpa(q, k, v, mask, causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8 * float(np.abs(want).max()))
