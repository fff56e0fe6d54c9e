"""The checks that hold a CUDA kernel against its plain version
(``image2text_torch/utils/kernel_check.py``), and the plain versions'
forced-route mode they rely on.

The checks must accept the rounding a bf16 kernel brings and reject a
wrong kernel at any output scale, including the decoder FFN's ~4e-4 at
random init, where a fixed 0.06 bound would pass zeros.  Torch only, on
the CPU."""
import pytest
import torch

from image2text_torch.configs.models import (MoEConfig, SelfAttentionConfig,
                                             SelfAttentionType,
                                             TransformerConfig)
from image2text_torch.models.layers import TransformerBlock, _MoEMLP
from image2text_torch.nn.core import init_parameters
from image2text_torch.ops.fused_block import sparse_block_plain
from image2text_torch.ops.fused_moe import moe_ffn_plain, pack_mask
from image2text_torch.utils.kernel_check import check_output, check_routes

torch.set_num_threads(2)

MOE = MoEConfig(num_experts=4, proj_features=16, gate_sizes=(32,),
                ff_mult_factor=2.0, top_k=2)


def _want(scale):
    g = torch.Generator().manual_seed(0)
    return scale * torch.randn(256, 64, generator=g)


@pytest.mark.parametrize("scale", [4e-4, 1.0, 10.0])
def test_check_output_accepts_bf16_rounding(scale):
    want = _want(scale)
    st = check_output("rounded", want.bfloat16(), want)
    assert 0 < st["rel_l2"] < 3e-3


@pytest.mark.parametrize("scale", [4e-4, 1.0, 10.0])
@pytest.mark.parametrize("fault", ["zeros", "scaled", "one_row", "nan"])
def test_check_output_rejects_a_wrong_kernel(scale, fault):
    want = _want(scale)
    got = want.bfloat16().float()
    if fault == "zeros":
        got = torch.zeros_like(want)
    elif fault == "scaled":        # 3% off everywhere
        got = 1.03 * got
    elif fault == "one_row":       # one row of noise at the output's scale
        got[17] = scale * torch.randn(64, generator=torch.Generator()
                                      .manual_seed(1))
    else:
        got[3, 5] = float("nan")
    with pytest.raises(AssertionError):
        check_output(fault, got, want)


def _mlp(dtype):
    mlp = _MoEMLP(64, True, MOE, device="cpu")
    init_parameters(mlp, torch.Generator().manual_seed(2))
    mlp.to(dtype)
    x = torch.randn(300, 64, generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    return mlp.c_fc.packed(dtype), mlp.c_proj.packed(dtype), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forced_routes_reproduce_the_free_plain_version(dtype):
    fc, proj, x = _mlp(dtype)
    routes = torch.zeros(300, 2, dtype=torch.uint8)
    free = moe_ffn_plain(x, fc, proj, routes=routes)
    gates = torch.zeros(300, 2, 4)
    forced = moe_ffn_plain(x, fc, proj, force_routes=routes, gates=gates)
    torch.testing.assert_close(forced, free, rtol=0, atol=0)
    assert check_routes("own", routes, gates, 2)["rows_apart"] == 0


def test_check_routes_rejects_a_wrong_expert_and_a_wrong_count():
    fc, proj, x = _mlp(torch.float32)
    routes = torch.zeros(300, 2, dtype=torch.uint8)
    moe_ffn_plain(x, fc, proj, routes=routes)
    gates = torch.zeros(300, 2, 4)
    bad = routes.clone()
    bad[7, 0] = (~bad[7, 0]) & 0b1111      # row 7 takes its bottom two
    out = moe_ffn_plain(x, fc, proj, force_routes=bad, gates=gates)
    assert not torch.equal(out[7], moe_ffn_plain(x, fc, proj)[7])
    with pytest.raises(AssertionError, match="routes disagree"):
        check_routes("bottom two", bad, gates, 2)
    bad = routes.clone()
    bad[9, 1] = 0b0001                     # row 9 takes one expert
    with pytest.raises(AssertionError, match="other than 2"):
        check_routes("one expert", bad, gates, 2)


def test_check_routes_allows_a_few_near_ties():
    gv = torch.softmax(torch.randn(1000, 2, 4, generator=torch.Generator()
                                   .manual_seed(4)), -1)
    order = gv.argsort(-1, descending=True)
    took = torch.zeros_like(gv, dtype=torch.bool).scatter_(
        -1, order[..., :2], True)
    swap = took.clone()
    rows = [5, 500]
    for r in rows:                         # near tie between ranks 2 and 3
        a, b = order[r, 0, 1], order[r, 0, 2]
        gv[r, 0, b] = gv[r, 0, a] * (1 - 1e-5)
        swap[r, 0, a], swap[r, 0, b] = False, True
    st = check_routes("one tie", pack_mask(
        torch.where(torch.arange(1000)[:, None, None] == 5, swap, took)), gv, 2)
    assert st["rows_apart"] == 1 and st["max_tie_gap"] < 1e-4
    with pytest.raises(AssertionError, match="routes disagree"):
        check_routes("two ties", pack_mask(swap), gv, 2)


def test_sparse_block_plain_forced_routes_reproduce_it():
    cfg = TransformerConfig(
        is_sparse_attn=True, max_block_size=32, sparsity_factor=0.5,
        attn_config=SelfAttentionConfig(
            bias=True, n_head=2, n_embd=64,
            attn_type=SelfAttentionType.MULTI_QUERY),
        rotator_config=MOE)
    blk = TransformerBlock(cfg, seed=3, n_cls=4, device="cpu")
    init_parameters(blk, torch.Generator().manual_seed(5))
    x = torch.randn(3, 32, 64, generator=torch.Generator().manual_seed(6))
    rows_sel, rows_byp = blk.layout_rows(None, 32, "cpu")
    w = blk.block_weights(torch.float32)
    n = 3 * rows_sel.numel()
    routes = torch.zeros(n, 2, dtype=torch.uint8)
    free = sparse_block_plain(x, rows_sel, rows_byp, w, routes=routes)
    gates = torch.zeros(n, 2, 4)
    forced = sparse_block_plain(x, rows_sel, rows_byp, w, force_routes=routes,
                                gates=gates)
    torch.testing.assert_close(forced, free, rtol=0, atol=0)
    assert check_routes("own", routes, gates, 2)["rows_apart"] == 0
