"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither JAX nor the JAX package, so it
runs where they are absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are bf16 at small widths, including ragged row counts and a
selection length that is not a multiple of 16.  The plain version runs on
the kernel's own expert routes and is compared at the output's scale, and
the routes against the plain top-k (``utils/kernel_check.py``).
"""
import pytest
import torch

from image2text_torch.configs.models import (MoEConfig, SelfAttentionConfig,
                                             SelfAttentionType,
                                             TransformerConfig,
                                             flagship_config)
from image2text_torch.models.generation import decoder_step
from image2text_torch.models.layers import TransformerBlock
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.nn.core import init_parameters
from image2text_torch.ops.fused_block import sparse_block, sparse_block_plain
from image2text_torch.ops.fused_moe import moe_ffn, moe_ffn_plain
from image2text_torch.utils.kernel_check import check_output, check_routes

TOL = 0.06  # whole-stack parity, normwise


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _run_pair(kernel, plain, args, n_rows, e, **kw):
    """The kernel with its routes recorded, then the plain version forced
    onto them; returns (got, want, routes, gates)."""
    dev = args[0].device
    routes = torch.zeros(n_rows, 2, dtype=torch.uint8, device=dev)
    gates = torch.zeros(n_rows, 2, e, dtype=torch.float32, device=dev)
    got = kernel(*args, routes=routes, **kw)
    want = plain(*args, force_routes=routes, gates=gates, **kw)
    torch.cuda.synchronize()
    return got, want, routes, gates


def _block(dev, n_embd, n_head, max_block, bias):
    cfg = TransformerConfig(
        is_sparse_attn=True, max_block_size=max_block, sparsity_factor=0.5,
        attn_config=SelfAttentionConfig(
            bias=bias, n_head=n_head, n_embd=n_embd,
            attn_type=SelfAttentionType.MULTI_QUERY),
        rotator_config=MoEConfig(num_experts=4, proj_features=16,
                                 gate_sizes=(32,), ff_mult_factor=2.0,
                                 top_k=2))
    blk = TransformerBlock(cfg, seed=3, n_cls=4, device=dev)
    init_parameters(blk, _gen(dev))
    return blk.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n_embd,n_head,max_block,t,bias", [
    (256, 2, 32, 32, True),     # head dim 128, t_sel 16
    (64, 4, 80, 72, False),     # the tiny encoder's block: t_sel not % 16
])
def test_sparse_block_kernel_matches_plain(dev, n_embd, n_head, max_block, t,
                                           bias):
    blk = _block(dev, n_embd, n_head, max_block, bias)
    x = torch.randn(6, t, n_embd, device=dev, generator=_gen(dev, 1)
                    ).to(torch.bfloat16)
    layout = torch.randperm(t, generator=torch.Generator().manual_seed(2)
                            ).numpy()
    rows_sel, rows_byp = blk.layout_rows(layout, t, dev)
    w = blk.sparse_block_weights(torch.bfloat16)
    ts = rows_sel.numel()
    before = sparse_block.launches
    got, want, rk, gv = _run_pair(sparse_block, sparse_block_plain,
                                  (x, rows_sel, rows_byp, w), 6 * ts, w.fc.e)
    assert sparse_block.launches == before + 1
    check_routes("sparse_block", rk, gv, w.fc.k)
    check_output("sparse_block selected rows", got[:, :ts], want[:, :ts])
    check_output("sparse_block bypass rows", got[:, ts:], want[:, ts:])
    # the FFN stage at the residual's size (x64 is exact in bf16)
    w64 = w._replace(proj=w.proj._replace(l2w=w.proj.l2w * 64,
                                          l2b=w.proj.l2b * 64))
    got, want, rk, gv = _run_pair(sparse_block, sparse_block_plain,
                                  (x, rows_sel, rows_byp, w64), 6 * ts,
                                  w.fc.e)
    check_routes("sparse_block x64", rk, gv, w.fc.k)
    check_output("sparse_block x64", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300])
@pytest.mark.parametrize("prologue", [False, True])
def test_moe_ffn_kernel_matches_plain(dev, rows, prologue):
    blk = _block(dev, 256, 2, 32, True)
    fc = blk.mlp.c_fc.packed(torch.bfloat16)
    proj = blk.mlp.c_proj.packed(torch.bfloat16)
    x = torch.randn(rows, 256, device=dev, generator=_gen(dev, 3)
                    ).to(torch.bfloat16)
    extra = {}
    if prologue:
        extra = dict(ln_w=blk.ln_2.weight, ln_b=blk.ln_2.bias, residual=x)
        # lift the FFN term to the residual's size (x64 is exact in bf16)
        proj = proj._replace(l2w=proj.l2w * 64, l2b=proj.l2b * 64)
    got, want, rk, gv = _run_pair(moe_ffn, moe_ffn_plain, (x, fc, proj),
                                  rows, fc.e, **extra)
    check_routes("moe_ffn", rk, gv, fc.k)
    check_output("moe_ffn", got, want)


@pytest.mark.cuda
def test_tiny_flagship_on_card_kernel_path_vs_plain(dev):
    """The tiny flagship through the kernels: first-step logits against
    the plain-version path, normwise within the tolerance."""
    from image2text_torch.models import layers

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16)
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)

    def first_logits():
        with torch.no_grad():
            enc = model.encoder(images)
            cache = model.decoder.init_cache(4, 9, enc.dtype, dev)
            return decoder_step(model, prompt, cache, model.space_for_prompt,
                                enc)[0][:, -1]

    off = model.space_for_prompt
    counts = sparse_block.launches, moe_ffn.launches
    got = first_logits()
    assert sparse_block.launches == counts[0] + 2
    assert moe_ffn.launches == counts[1] + model.decoder.ffn_evaluations(off, 1)
    saved = layers.sparse_block, layers.moe_ffn
    layers.sparse_block, layers.moe_ffn = sparse_block_plain, moe_ffn_plain
    try:
        want = first_logits()
    finally:
        layers.sparse_block, layers.moe_ffn = saved
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert float(rel) <= TOL
    before = moe_ffn.launches
    ids = model.generate(images, prompt, max_new_tokens=8, temperature=0.7,
                         top_k=16, generator=_gen(dev, 5))
    assert ids.shape == (4, 9) and bool((ids < 512).all())
    want = sum(model.decoder.ffn_evaluations(off + i, 1) for i in range(9))
    assert moe_ffn.launches - before == want > 0
