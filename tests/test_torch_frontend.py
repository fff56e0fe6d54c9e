"""The port's eval encoder front (``ops/fused_frontend.py``: projector →
LayerNormND → + positional table → LayerNormND → [CLS; tokens]) against
the JAX package's fused-front kernel in interpret mode and its module
chain, on the encoder of ``tests/test_fused_block.py``'s front test; f32
(3e-5) and bf16 (0.05), the tolerances of that test.  Inputs from a numpy
seed; JAX at full matmul precision."""
import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.configs import models as jcm
from image2text_tpu.models.encoder import (
    VisionTransformerEncoder as JaxEncoder)
from image2text_tpu.ops.fused_frontend import fused_frontend_compatible
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs import models as tcm
from image2text_torch.models.encoder import VisionTransformerEncoder
from image2text_torch.ops import fused_frontend as ff
from image2text_torch.ops.fused_frontend import (fused_frontend,
                                                 fused_frontend_plain)
from image2text_torch.utils.checkpoint import load_jax_state_dict

torch.set_num_threads(2)


def _config(cm, bias):
    """The front test's encoder: 16 patches of din 128 → d 128, 8 CLS."""
    return cm.VisionTransformerEncoderConfig(
        transformer_config=cm.TransformerConfig(
            rotator_config=cm.MoEConfig(num_experts=2, proj_features=8,
                                        gate_sizes=(16,), ff_mult_factor=2.0,
                                        top_k=1),
            attn_config=cm.SelfAttentionConfig(
                attn_type=cm.SelfAttentionType.MULTI_QUERY, n_embd=128,
                n_head=1, bias=bias),
            is_causal=False, is_cross_attn=False),
        input=cm.ImageInputSpec(n_channels=3, width=32, height=32),
        n_layer=1, n_cls=8, num_patches=4, n_channels=2)


@pytest.fixture(scope="module", params=[False, True], ids=["no_bias", "bias"])
def encoders(request):
    jenc = JaxEncoder(_config(jcm, request.param))
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0))
    tenc = VisionTransformerEncoder(_config(tcm, request.param), device="cpu")
    load_jax_state_dict(tenc, export_state_dict(jenc, params))
    return jenc, params, tenc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_front_matches_jax_kernel_and_module_chain(encoders, dtype):
    jenc, params, tenc = encoders
    dt = jnp.dtype(dtype)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, params)
    x = (0.5 * np.random.default_rng(0).standard_normal(
        (4, 16, tenc.input_d))).astype(np.float32)
    xj = jnp.asarray(x, dt)
    with jax.default_matmul_precision("highest"):
        kernel = fused_frontend_compatible(jenc, params, xj, interpret=True)
        z = jenc.ln_input(params["ln_input"],
                          jenc.projector(params["projector"], xj))
        pos = jenc.transformer._children["wpe"](
            params["transformer"]["wpe"], jnp.arange(16))[None]
        y = z + pos.astype(z.dtype)
        cls = jnp.broadcast_to(params["cls_token"].astype(z.dtype),
                               (4, 8, 128))
        chain = jnp.concatenate([cls, jenc.ln_input(params["ln_input"], y)],
                                axis=1)
    tdt = getattr(torch, dtype)
    tenc = copy.deepcopy(tenc).to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        w = tenc.frontend_weights(tdt)
        before = fused_frontend.launches
        out = fused_frontend(xt, w)
        assert fused_frontend.launches == before    # CPU: the plain version
        assert torch.equal(out, fused_frontend_plain(xt, w))
    assert out.shape == (4, 24, 128) and out.dtype == tdt
    tol = 3e-5 if dtype == "float32" else 0.05
    for ref in (kernel, chain):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


def test_eval_front_equals_the_training_module_chain(encoders):
    """The encoder's eval forward takes ``fused_frontend``; its training
    forward keeps the module chain (with its dropout): with dropout off
    the two give the same block-loop input."""
    from image2text_torch.nn.core import Ctx

    _, _, tenc = encoders
    seen = []
    hook = tenc.blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    images = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    rate, tenc.dropout_rate = tenc.dropout_rate, 0.0
    try:
        with torch.no_grad():
            tenc(images)
            tenc(images, ctx=Ctx(seed=0, train=True), use_flash=False)
    finally:
        hook.remove()
        tenc.dropout_rate = rate
    assert seen[0].shape == (2, 8 + 16, 128)
    np.testing.assert_allclose(seen[0].numpy(), seen[1].numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("t,d,want", [
    (256, 1024, ("cluster", 32768)),  # the flagship's front: 8 x 64 KB
    (256, 512, ("slab", 16384)),      # GPT-2-medium's front
    (16, 128, ("slab", 256)),         # a slab smaller than a GEMM tile
    (200, 512, ("slab", 12800)),
    (128, 2048, ("cluster", 32768)),  # SLAB_MAX_CHUNK exactly
    (256, 2048, ("slab", 65536)),     # past SLAB_MAX_CHUNK
    (384, 1024, ("slab", 49152)),
    (320, 512, ("slab", 20480)),      # below CLUSTER_MIN_CHUNK
    (192, 1024, ("cluster", 24576)),  # CLUSTER_MIN_CHUNK exactly
])
def test_front_plan_route_per_shape(t, d, want):
    """The cluster route takes every slab that SLAB_CLUSTER chunks of whole
    16-byte vectors, CLUSTER_MIN_CHUNK to SLAB_MAX_CHUNK elements each,
    cover; the slab route the rest; the plan is a pure function of t, d."""
    assert tuple(ff.front_plan(t, d)) == want


def test_front_plan_reads_the_kernel_tiling():
    """The cluster and its chunk limits come from the CUDA source."""
    from image2text_torch.ops._build import CSRC

    front = (CSRC / "fused_frontend.cu").read_text()
    for name in ("SLAB_CLUSTER", "CLUSTER_MIN_CHUNK", "SLAB_MAX_CHUNK"):
        assert re.search(rf"{name} = {getattr(ff, name)};", front)
    assert (ff.SLAB_CLUSTER, ff.CLUSTER_MIN_CHUNK, ff.SLAB_MAX_CHUNK) == (
        8, 24576, 32768)
