"""The port's block probes (``image2text_torch/probes/``) against the TPU
probes, on the CPU.

* Each of the 7 ablation variants: the port's plain ablated chain
  (``block_ablate.chain_plain``) against the JAX probe's own kernel body,
  ``tools/block_ablate_probe.py::_make_kernel``, run through
  ``pl.pallas_call(..., interpret=True)`` on the same weights (the JAX
  block's parameters exported into the port's block) and the same numpy
  input.  f32, JAX at full matmul precision, limit 3e-5 abs + rel (the
  dense block's f32 tolerance in ``tests/test_torch_dense.py``).  Width:
  b 2, t 16, d 256, 2 heads, MoE e 4, top-2, r 4: the JAX weight packer
  (``ops/fused_block.py::_gate_and_weights``) takes head dims that are
  multiples of 128 only, so d 128 with 2 heads is refused; d 256 is the
  narrowest it takes.  Importing the tool sets the process's JAX
  compilation-cache options (``setup_compile_cache`` in the tool,
  ``bench_kernels``); the fixture puts them back as they were.
* The wide probe's groupings equal the whole batch bit for bit on the
  plain path, in f32 and bf16.
* The shape rules the redesign brought: the resident attention's row
  limit (432, the shared memory of one image's K and Vᵀ at head dim 128;
  longer rows and head dim 256 take the K/V-tiled kernel) and the MoE
  FFN's regimes, pinned here (the card's own test of the tiled route:
  ``tests/test_torch_cuda.py::test_fused_block_raises_past_the_attention_shared_memory``).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from image2text_tpu.configs import models as jcm
from image2text_tpu.models.layers import TransformerBlock as JaxBlock
from image2text_tpu.ops.fused_block import _gate_and_weights
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs import models as tcm
from image2text_torch.models.layers import TransformerBlock
from image2text_torch.ops import fused_block as fb
from image2text_torch.ops import fused_moe as fm
from image2text_torch.probes import block_ablate, block_wide
from image2text_torch.utils.checkpoint import load_jax_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = 3e-5


@pytest.fixture(scope="module")
def tool():
    """``tools/block_ablate_probe.py`` as a module, the JAX options its
    import sets restored."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "block_ablate_probe", REPO / "tools" / "block_ablate_probe.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _config(cm, d=256, n_head=2):
    return cm.TransformerConfig(
        is_causal=False, is_cross_attn=False, is_sparse_attn=False,
        attn_config=cm.SelfAttentionConfig(
            attn_dropout=0.1, bias=False, dropout=0.1, n_head=n_head,
            n_embd=d, attn_type=cm.SelfAttentionType.MULTI_QUERY),
        rotator_config=cm.MoEConfig(num_experts=4, proj_features=4,
                                    gate_sizes=(32,), ff_mult_factor=2.0,
                                    top_k=2))


@pytest.fixture(scope="module")
def blocks():
    jblk = JaxBlock(_config(jcm), seed=None, n_cls=0)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0))
    tblk = TransformerBlock(_config(tcm), device="cpu")
    load_jax_state_dict(tblk, export_state_dict(jblk, params))
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 16, 256))
         ).astype(np.float32)
    return jblk, params, tblk, x


def _jax_variant(tool, jblk, params, x, modes):
    gelu, softmax, ln = modes
    xj = jnp.asarray(x)
    n_head, k_top, d, hidden, ws = _gate_and_weights(jblk, params, xj, True)
    b, t, _ = x.shape
    kernel = tool._make_kernel(n_head, k_top, d, hidden, 1, gelu_mode=gelu,
                               sm_mode=softmax, ln_mode=ln)
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    f = pl.pallas_call(
        kernel, grid=(b,),
        in_specs=[pl.BlockSpec((1, t, d), lambda i: (i, 0, 0))]
        + [full(w) for w in ws],
        out_specs=pl.BlockSpec((1, t, d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype), interpret=True)
    with jax.default_matmul_precision("highest"):
        return np.asarray(f(xj, *ws))


@pytest.mark.parametrize("variant", list(block_ablate.VARIANTS))
def test_ablated_chain_matches_the_tpu_probe_kernel(tool, blocks, variant):
    jblk, params, tblk, x = blocks
    modes, _ = block_ablate.VARIANTS[variant]
    want = _jax_variant(tool, jblk, params, x, modes)
    with torch.no_grad():
        got = block_ablate.chain_plain(
            torch.from_numpy(x), tblk.block_weights(torch.float32), modes)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_variants_differ_where_they_ablate(blocks):
    """Each ablation changes the output; exp2 and glu_sig stay close to
    the shipping chain (a substitution, not a removal)."""
    _, _, tblk, x = blocks
    w = tblk.block_weights(torch.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = {n: block_ablate.chain_plain(xt, w, m)
               for n, (m, _) in block_ablate.VARIANTS.items()}
    for n in ("no_gelu", "no_softmax", "no_ln", "dots_only"):
        assert float((out[n] - out["full"]).abs().max()) > 1e-2, n
    for n in ("exp2", "glu_sig"):
        assert float((out[n] - out["full"]).abs().max()) < 5e-2, n
    assert torch.equal(out["full"], fb.fused_block_plain(xt, w))


@pytest.mark.parametrize("variant", list(block_wide.VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_grouping_equals_the_whole_batch_bit_for_bit(blocks, variant,
                                                          dtype):
    _, _, tblk, _ = blocks
    w = tblk.block_weights(dtype)
    x = torch.from_numpy((0.3 * np.random.default_rng(2).standard_normal(
        (20, 16, 256))).astype(np.float32)).to(dtype)
    with torch.no_grad():
        whole = block_ablate.chain_plain(x, w)
        got = block_wide.grouped(block_ablate.chain_plain, x, w, variant)
    assert torch.equal(got, whole)
    kind, g = block_wide.VARIANTS[variant]
    assert block_wide.launch_rows(x, variant) == 16 * (
        1 if kind == "image" else g)


def test_attention_row_limit_is_pinned():
    """One image's K (tp x 136 bf16) and Vᵀ (128 x tp + 8) in 227 KB:
    tp 432 fits the resident kernel, 448 does not and takes the K/V-tiled
    one, as head dim 256 does at any length; every encoder length of the
    port's configs (320 at most) stays resident.  The chain refuses only
    widths and head dims its kernels lack, and a single row."""
    assert fb.MAX_ATTN_ROWS == 432
    assert fb._attn_smem(432) <= fb.ATTN_SMEM_LIMIT < fb._attn_smem(448)
    assert fb._attn_smem(160) == 86528 and fb._attn_smem(320) == 171008
    assert [fb.attn_route(t, hd) for t, hd in (
        (320, 128), (432, 128), (433, 128), (1024, 64), (160, 256))] == [
            "resident", "resident", "tiled", "tiled", "tiled"]
    for ts, n_head, d in ((432, 8, 1024), (433, 8, 1024), (1024, 8, 1024),
                          (160, 4, 1024)):
        assert fb._chain_shape_error(2, ts, d, n_head, ts,
                                     (d, d + 2 * (d // n_head))) is None
    for ts, n_head, d in ((160, 8, 1000), (1, 8, 1024), (160, 2, 1024),
                          (160, 16, 1280)):
        assert fb._chain_shape_error(2, ts, d, n_head, ts,
                                     (d, d + 2 * (d // n_head))) is not None


@pytest.mark.parametrize("rows,hidden,slices", [
    (1, 4096, 64), (16, 4096, 64), (192, 4096, 32), (256, 4096, 32),
    (256, 2048, 32), (1280, 2048, 6), (fm.FEW_ROWS, 2048, 4),
    (fm.FEW_ROWS + 1, 2048, 1), (40960, 2048, 1)])
def test_moe_regimes_from_the_row_count(rows, hidden, slices):
    """Few rows split the hidden dimension into about one block an SM
    (132 SMs: the H100 SXM's count, passed in as the card would give it);
    past FEW_ROWS the many-rows kernel runs whole (one slice)."""
    assert fm.moe_slices(rows, hidden, 132) == slices
    assert fm.moe_regime(rows) == ("few" if slices > 1 else "many")
    assert fm._moe_shape_error(1024, hidden, 32, 4, 16, 8) is None
    assert fm._moe_shape_error(1000, hidden, 32, 4, 16, 8) is not None
    assert fm._moe_shape_error(1024, hidden, 32, 4, 16, 0) is not None
