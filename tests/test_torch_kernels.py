"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; they are held
against the JAX kernels run in interpret mode, at the shapes and
tolerances of ``tests/test_fused_block.py`` and ``tests/test_fused_moe.py``.
The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
and ``chip_smoke.py`` hold them against the plain versions there."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.configs.models import MoEConfig as JMoEConfig
from image2text_tpu.configs.models import SelfAttentionConfig as JSAConfig
from image2text_tpu.configs.models import SelfAttentionType as JSAType
from image2text_tpu.configs.models import TransformerConfig as JTConfig
from image2text_tpu.models.layers import TransformerBlock as JBlock
from image2text_tpu.models.layers import _MoEMLP as JMoEMLP
from image2text_tpu.ops.fused_block import fused_sparse_block_compatible
from image2text_tpu.ops.fused_moe import fused_moe_mlp_compatible
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import (MoEConfig, SelfAttentionConfig,
                                             SelfAttentionType,
                                             TransformerConfig)
from image2text_torch.models.layers import TransformerBlock, _MoEMLP
from image2text_torch.ops.fused_block import sparse_block, sparse_block_plain
from image2text_torch.ops.fused_moe import moe_ffn_plain, topk_combine
from image2text_torch.utils.checkpoint import load_jax_state_dict

torch.set_num_threads(2)


def _bf16(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _sparse_pair(bias):
    """The JAX test's sparse block (n_embd 256, n_head 2, t 32, seed 3,
    n_cls 4) and the port's, on the same weights."""
    jcfg = JTConfig(
        is_causal=False, is_cross_attn=False, is_sparse_attn=True,
        max_block_size=32, sparsity_factor=0.5,
        attn_config=JSAConfig(attn_dropout=0.1, bias=bias, dropout=0.1,
                              n_head=2, n_embd=256,
                              attn_type=JSAType.MULTI_QUERY),
        rotator_config=JMoEConfig(num_experts=4, proj_features=16,
                                  gate_sizes=[32], ff_mult_factor=2.0,
                                  top_k=2))
    jblk = JBlock(jcfg, seed=3, n_cls=4)
    params = jblk.init(jax.random.PRNGKey(0))
    tcfg = TransformerConfig(
        is_sparse_attn=True, max_block_size=32, sparsity_factor=0.5,
        attn_config=SelfAttentionConfig(
            bias=bias, n_head=2, n_embd=256,
            attn_type=SelfAttentionType.MULTI_QUERY),
        rotator_config=MoEConfig(num_experts=4, proj_features=16,
                                 gate_sizes=(32,), ff_mult_factor=2.0,
                                 top_k=2))
    tblk = TransformerBlock(tcfg, seed=3, n_cls=4, device="cpu")
    load_jax_state_dict(tblk, export_state_dict(jblk, params))
    return jblk, params, tblk


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("permuted", [False, True])
def test_sparse_block_plain_matches_jax_kernel(bias, permuted):
    jblk, params, tblk = _sparse_pair(bias)
    x = (0.3 * np.random.default_rng(1).standard_normal((4, 32, 256))
         ).astype(np.float32)
    layout = np.random.default_rng(2).permutation(32) if permuted else None
    with jax.default_matmul_precision("highest"):
        ref = fused_sparse_block_compatible(jblk, params, jnp.asarray(x),
                                            layout, interpret=True)
    assert ref is not None
    rows_sel, rows_byp = tblk.layout_rows(layout, 32, "cpu")
    w = tblk.block_weights(torch.float32)
    out = sparse_block_plain(torch.from_numpy(x), rows_sel, rows_byp, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)
    # the block's lazy path dispatches to the same function
    stream, new_layout = tblk(torch.from_numpy(x), layout=layout,
                              want_lazy=True)
    np.testing.assert_array_equal(stream.numpy(), out.numpy())
    np.testing.assert_array_equal(
        new_layout, np.concatenate([jblk.idx_np, jblk.not_idx_np]))


def test_sparse_block_plain_matches_jax_kernel_bf16():
    jblk, params, tblk = _sparse_pair(False)
    tblk.to(torch.bfloat16)
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 32, 256))
         ).astype(np.float32)
    ref = fused_sparse_block_compatible(jblk, _bf16(params),
                                        jnp.asarray(x, jnp.bfloat16), None,
                                        interpret=True)
    rows_sel, rows_byp = tblk.layout_rows(None, 32, "cpu")
    out = sparse_block(torch.from_numpy(x).to(torch.bfloat16), rows_sel,
                       rows_byp, tblk.block_weights(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.06,
                               atol=0.06)


def _moe_pair(bias):
    cfg = JMoEConfig(num_experts=4, proj_features=16, gate_sizes=[32],
                     ff_mult_factor=2.0, top_k=2)
    jmlp = JMoEMLP(128, bias, 0.1, cfg)
    params = jmlp.init(jax.random.PRNGKey(0))
    # experts 1 and 2 get identical gate rows, so their gate values tie
    # exactly on every row: the lowest-index rule decides at the boundary
    for lin in ("c_fc", "c_proj"):
        g = params[lin]["expert_gates"]["model"]["2"]
        g["weight"] = g["weight"].at[2].set(g["weight"][1])
        if "bias" in g:
            g["bias"] = g["bias"].at[2].set(g["bias"][1])
    tmlp = _MoEMLP(128, bias, MoEConfig(num_experts=4, proj_features=16,
                                        gate_sizes=(32,), ff_mult_factor=2.0,
                                        top_k=2), device="cpu")
    load_jax_state_dict(tmlp, export_state_dict(jmlp, params))
    return jmlp, params, tmlp


@pytest.mark.parametrize("bias", [True, False])
def test_moe_ffn_plain_matches_jax_kernel_ragged_rows_and_ties(bias):
    """300 rows (not a multiple of the JAX kernel's 256-row tile)."""
    jmlp, params, tmlp = _moe_pair(bias)
    x = np.random.default_rng(1).standard_normal((300, 128)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = fused_moe_mlp_compatible(jmlp, params, jnp.asarray(x),
                                       interpret=True)
    assert ref is not None
    routes = torch.zeros(300, 2, dtype=torch.uint8)
    fc = tmlp.c_fc.packed(torch.float32)
    proj = tmlp.c_proj.packed(torch.float32)
    out = moe_ffn_plain(torch.from_numpy(x), fc, proj, routes=routes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # the tie sat on the top-k boundary for some rows: expert 1 kept, 2 not
    assert ((routes & 0b0110) == 0b0010).any()
    np.testing.assert_array_equal(tmlp(torch.from_numpy(x)).numpy(),
                                  out.numpy())


def test_topk_combine_lowest_index_ties():
    gv = np.asarray([[0.1, 0.4, 0.4, 0.1], [0.25, 0.25, 0.25, 0.25],
                     [0.7, 0.1, 0.15, 0.05]], np.float32)
    top_w, top_i = jax.lax.top_k(jnp.asarray(gv), 2)
    want = jnp.sum(jax.nn.one_hot(top_i, 4) * top_w[..., None], axis=-2)
    np.testing.assert_array_equal(topk_combine(torch.from_numpy(gv), 2).numpy(),
                                  np.asarray(want))
