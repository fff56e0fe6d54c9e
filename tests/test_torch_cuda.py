"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither JAX nor the JAX package, so it
runs where they are absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are bf16 at small widths, including ragged row counts and a
selection length that is not a multiple of 16.  The int4 dequant-matmul
is held against its plain version at ragged rows and outs, the narrowest
and widest packed widths and both scale dtypes, and the tiny int4 + LoRA
GPT-2 captioner serves and trains on the card.  The plain version runs on
the kernel's own expert routes and is compared at the output's scale, and
the routes against the plain top-k (``utils/kernel_check.py``).  The flash
kernels are compared with their plain versions on the same inputs and
dropout seed (the keep masks are identical), and one training step of the
tiny flagship runs on the card.  The encoder chain's stages alone: the
wgmma GEMM at ragged M, N and K with row lists, a row offset, bias and
residual; the head-folded attention from 16 keys to its shared-memory
limit, and its error beside the sensitivity of the reference's bf16 score
rounding at score standard deviations 1, 2 and 4; the MoE FFN in both
regimes from 1 to 40,960 rows; and every block probe variant.  The flash
backward on both routes (K/V resident up to 160 keys, tiled beyond), every
bias broadcast form, bitwise-deterministic reruns and its causal band skip;
the lm_head and the eval attention without f32 copies.
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
from image2text_torch.utils.kernel_check import (MAX_ABS_SHARE, REL_L2,
                                                 check_output, check_routes,
                                                 output_error)
from image2text_torch.ops import flash_attention as fa

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
    w = blk.block_weights(torch.bfloat16)
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


def _soft_prompt_bias(s, n_prefix, dev):
    bias = torch.zeros(1, 1, s, s, device=dev)
    bias[..., n_prefix:, :n_prefix] = float("-inf")
    return bias


def _flash_bias(kind, b, h, sq, skv, dev, g):
    """An f32 bias of each broadcast form (1|b, 1|h, 1|sq, skv)."""
    if kind is None:
        return None
    if kind == "soft_prompt":
        return _soft_prompt_bias(sq, 9, dev)
    if kind == "per_batch":
        bias = torch.zeros(b, 1, sq, skv, device=dev)
        bias[0, :, :, 30:] = float("-inf")
        return bias
    if kind == "per_head":
        return torch.randn(1, h, 1, skv, device=dev, generator=g)
    shape = {"keys": (1, 1, 1, skv), "batch_keys": (b, 1, 1, skv),
             "rows": (1, 1, sq, skv), "head_rows": (1, h, sq, skv),
             "full": (b, h, sq, skv), "batch_head": (b, h, 1, skv)}[kind]
    bias = torch.randn(*shape, device=dev, generator=g)
    bias[..., 3] = float("-inf")   # clamped to NEG_BIG inside the kernels
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk,sq,skv,d,bias,causal,rate", [
    (3, 8, 1, 160, 160, 128, None, False, 0.1),      # encoder-like, MQA
    (2, 4, 1, 137, 137, 64, "soft_prompt", True, 0.1),  # decoder-like
    (2, 2, 2, 40, 40, 32, "per_batch", False, 0.0),  # MHA, ragged
    (1, 2, 1, 40, 137, 16, "per_head", True, 0.1),   # causal sq < skv
    (2, 16, 16, 112, 64, 64, None, False, 0.0),      # cross: sq > skv
    (1, 2, 1, 161, 161, 64, None, True, 0.1),        # just past resident
    (2, 8, 1, 160, 160, 128, "soft_prompt", True, 0.1),  # 160 keys exactly
    (2, 4, 1, 256, 1024, 64, None, True, 0.1),       # long keys: tiled
    (1, 2, 2, 300, 1024, 128, "per_head", False, 0.1),  # tiled, MHA
])
def test_flash_kernels_match_plain(dev, b, h, hk, sq, skv, d, bias, causal,
                                   rate):
    """Forward and backward against the plain versions on both routes of
    each (resident K/V up to 160 keys, tiled beyond); the backward
    launched twice more gives bitwise-equal dQ, dK and dV."""
    g = _gen(dev, 11)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g
                                 ).to(torch.bfloat16)
                     for shape in ((b, h, sq, d), (b, hk, skv, d),
                                   (b, hk, skv, d), (b, h, sq, d)))
    bias = _flash_bias(bias, b, h, sq, skv, dev, g)
    seed = -987654321
    counts = fa.flash_fwd.launches, fa.flash_bwd.launches
    out, lse = fa.flash_fwd(q, k, v, bias, causal, rate, seed)
    want, want_lse = fa.flash_forward_plain(q, k, v, bias, causal, rate, seed)
    dvec = (dout.float() * want.float()).sum(-1)
    gr = (dout, want_lse, dvec, rate, seed)
    got = fa.flash_bwd(q, k, v, bias, causal, *gr)
    again = fa.flash_bwd(q, k, v, bias, causal, *gr)
    plain = fa.flash_backward_plain(q, k, v, bias, causal, *gr)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (
        counts[0] + 1, counts[1] + 2)
    check_output("flash_fwd out", out, want)
    check_output("flash_fwd lse", lse, want_lse)
    for name, mine, ref, rerun in zip(("dq", "dk", "dv"), got, plain, again):
        check_output(f"flash_bwd {name}", mine, ref)
        assert torch.equal(mine, rerun), name


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk,sq,skv,d,masked_rows", [
    (8, 1, 200, 128, 128, None),         # causal offset: rows 0..71 keyless
    (8, 1, 136, 136, 128, (5, 70, 130)),  # folded tiles straddle heads
    (4, 4, 150, 160, 64, (0, 149)),       # one head a plane, 160 keys
    (2, 1, 40, 137, 16, (39,)),           # sq < skv: the band ends late
])
def test_flash_fwd_band_skip_gives_keyless_rows_every_key(dev, h, hk, sq,
                                                          skv, d,
                                                          masked_rows):
    """The resident forward stops a causal tile at its band only once
    every row of the tile saw a key: rows the causal offset (sq > skv) or
    a bias leaves keyless average over all skv keys, with dropout, as the
    plain version does; out and the keyed rows' lse within the kernel
    checks' limits, the keyless rows' lse (NEG_BIG) equal."""
    b, rate, seed = 2, 0.1, 4242
    assert fa.fwd_plan(b, h, hk, sq, skv, 132)[0] == "resident"
    g = _gen(dev, 15)
    q = torch.randn(b, h, sq, d, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, hk, skv, d, device=dev, generator=g
                        ).to(torch.bfloat16) for _ in range(2))
    bias = None
    if masked_rows is not None:
        bias = torch.zeros(1, 1, sq, skv, device=dev)
        bias[..., :, :3] = float("-inf")
        bias[..., list(masked_rows), :] = float("-inf")
    a = (q, k, v, bias, True, rate, seed)
    out, lse = fa.flash_fwd(*a)
    want, want_lse = fa.flash_forward_plain(*a)
    torch.cuda.synchronize()
    check_output("flash_fwd out", out, want)
    keyed = want_lse > 0.5 * fa.NEG_BIG   # keyless rows: lse = NEG_BIG
    assert 0 < int(keyed.sum()) < keyed.numel()
    check_output("flash_fwd lse", lse[keyed], want_lse[keyed])
    assert torch.equal(lse[~keyed], want_lse[~keyed])


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [136, 160])
def test_flash_fwd_dropout_mask_bit_for_bit_with_folded_heads(dev, sq):
    """q = 0 and V the identity (skv = d = 64): every score is 0, so
    out[b, head, row, col] = p̃ / 64 is non-zero exactly where the entry is
    kept.  With 8 query heads folded over one K/V head (16-row tiles
    straddle two heads at sq 136), ``out != 0`` must equal
    ``dropout_keep_mask(row, col, b·h + head)`` bit for bit: the hash takes
    the unfolded (head, row)."""
    b, h, d, rate, seed = 2, 8, 64, 0.1, -123457
    q = torch.zeros(b, h, sq, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, 1, d, d, device=dev, generator=_gen(dev, 16)
                    ).to(torch.bfloat16)
    v = torch.eye(d, device=dev, dtype=torch.bfloat16).expand(b, 1, d, d
                                                             ).contiguous()
    out, _ = fa.flash_fwd(q, k, v, None, False, rate, seed)
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(d, device=dev)[None, :]
    plane = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    keep = fa.dropout_keep_mask(rows, cols, plane, seed, rate) > 0
    assert torch.equal(out != 0, keep)
    assert 0.85 < keep.float().mean() < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["keys", "batch_keys", "rows", "head_rows",
                                  "full", "batch_head"])
@pytest.mark.parametrize("hk", [1, 4])
def test_flash_bwd_takes_every_bias_broadcast_form(dev, kind, hk):
    """(1|b, 1|h, 1|sq, skv) biases, multi-query and not, causal, at the
    resident route's 160-key limit."""
    b, h, sq, skv, d, rate, seed = 2, 4, 150, 160, 64, 0.1, 321
    g = _gen(dev, 13)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g
                                 ).to(torch.bfloat16)
                     for shape in ((b, h, sq, d), (b, hk, skv, d),
                                   (b, hk, skv, d), (b, h, sq, d)))
    bias = _flash_bias(kind, b, h, sq, skv, dev, g)
    a = (q, k, v, bias, True)
    want, lse = fa.flash_forward_plain(*a, rate, seed)
    check_output("flash_fwd out", fa.flash_fwd(*a, rate, seed)[0], want)
    gr = (dout, lse, (dout.float() * want.float()).sum(-1), rate, seed)
    for name, mine, ref in zip(("dq", "dk", "dv"), fa.flash_bwd(*a, *gr),
                               fa.flash_backward_plain(*a, *gr)):
        check_output(f"flash_bwd {name} bias {kind}", mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n_prefix,keyless_row", [(32, None), (32, 70)])
def test_flash_bwd_skips_the_causal_band_only_where_every_row_sees_a_key(
        dev, n_prefix, keyless_row):
    """At the flagship decoder's s 136 with its soft-prompt bias, the
    backward visits 29 of the 45 (32-row tile, 16-key slice) pairs a head
    (``bwd_pairs``: the band, decided from the saved lse on the card); a
    row the bias leaves keyless makes its tile visit all 9 slices (it
    averages over every key), and the result still holds."""
    b, h, s, d, rate, seed = 2, 8, 136, 128, 0.1, 99
    g = _gen(dev, 14)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g
                                 ).to(torch.bfloat16)
                     for shape in ((b, h, s, d), (b, 1, s, d), (b, 1, s, d),
                                   (b, h, s, d)))
    bias = _soft_prompt_bias(s, n_prefix, dev)
    if keyless_row is not None:
        bias[..., keyless_row, :] = float("-inf")
    a = (q, k, v, bias, True)
    want, lse = fa.flash_forward_plain(*a, rate, seed)
    gr = (dout, lse, (dout.float() * want.float()).sum(-1), rate, seed)
    pairs = torch.zeros(1, dtype=torch.int32, device=dev)
    got = fa.flash_bwd(*a, *gr, pairs=pairs)
    torch.cuda.synchronize()
    band = fa.bwd_pairs(b, h, s, s, True)
    assert band == b * h * 29
    extra = 0 if keyless_row is None else b * h * (9 - 6)  # tile 64..95
    assert int(pairs) == band + extra
    for name, mine, ref in zip(("dq", "dk", "dv"), got,
                               fa.flash_backward_plain(*a, *gr)):
        st = output_error(mine, ref)
        assert (st["finite"] and st["rel_l2"] <= REL_L2
                and st["max_abs_err"] <= MAX_ABS_SHARE * st["max_plain"]), (
            name, st)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,masked_rows", [
    (200, 128, None),              # causal offset: rows 0..71 see no key
    (137, 137, (5, 20, 70, 130)),  # the bias masks whole rows in every q tile
])
def test_flash_kernels_give_keyless_rows_every_key(dev, sq, skv,
                                                   masked_rows):
    """Causal rows that see no key — left so by the causal offset (sq >
    skv) or masked whole by the bias — take the uniform average over all
    skv keys, as the plain version does, so their q tiles visit every kv
    tile (a band-limited skip would average over fewer: the forward check
    catches it, and the missing rows' terms in dK/dV the relative L2 one).
    The backward holds to the scale-tied limits only: for such a row lse
    rounds to NEG_BIG in f32 (log skv is lost), so its recomputed p is 1,
    its dS terms are O(10), and their bf16 rounding in the kernel's
    tensor-core products leaves O(0.1) errors on sums that cancel to small
    values.  Without a bias the visited (query tile, key slice) pairs are
    ``bwd_pairs``'s: every slice for a tile holding a keyless row."""
    b, h, d, rate, seed = 1, 2, 64, 0.1, 12345
    g = _gen(dev, 12)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g
                                 ).to(torch.bfloat16)
                     for shape in ((b, h, sq, d), (b, 1, skv, d),
                                   (b, 1, skv, d), (b, h, sq, d)))
    bias = None
    if masked_rows is not None:
        bias = _soft_prompt_bias(sq, 9, dev)
        bias[..., list(masked_rows), :] = float("-inf")
    a = (q, k, v, bias, True)
    out, _ = fa.flash_fwd(*a, rate, seed)
    want, lse = fa.flash_forward_plain(*a, rate, seed)
    check_output("flash_fwd out", out, want)
    gr = (dout, lse, (dout.float() * want.float()).sum(-1), rate, seed)
    pairs = torch.zeros(1, dtype=torch.int32, device=dev)
    got = fa.flash_bwd(*a, *gr, pairs=pairs)
    if masked_rows is None:
        assert int(pairs) == fa.bwd_pairs(b, h, sq, skv, True)
    for name, mine, ref in zip(("dq", "dk", "dv"), got,
                               fa.flash_backward_plain(*a, *gr)):
        st = output_error(mine, ref)
        assert (st["finite"] and st["rel_l2"] <= REL_L2
                and st["max_abs_err"] <= MAX_ABS_SHARE * st["max_plain"]), (
            name, st)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    cases = [(t(1, 2, 8, 256), t(1, 1, 8, 256), None),       # head dim
             (t(1, 4, 8, 64), t(1, 2, 8, 64), None),          # grouped K/V
             (t(1, 2, 8, 64), t(1, 1, 8, 64),
              t(1, 1, 3, 8, dtype=torch.float32)),              # bias rows
             (t(1, 2, 8, 64, dtype=torch.float32),
              t(1, 1, 8, 64, dtype=torch.float32), None)]     # dtype
    before = fa.flash_fwd.launches
    for q, k, bias in cases:
        with pytest.raises(ValueError):
            fa.flash_fwd(q, k, k, bias)
    assert fa.flash_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_tiny_training_step_on_card(dev, remat):
    """Three bf16 training steps of the tiny flagship with dropout on:
    finite, falling loss; per step one flash forward and backward for
    each self-attention call of the model, plus a recomputed forward
    under gradient checkpointing; the serving kernels not at all."""
    from image2text_torch.configs.trainer import flagship_training_config
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    cfg = flagship_training_config(tiny=True)
    cfg.model.vision_encoder_config.enable_gradient_checkpointing = remat
    cfg.model.decoder_config.enable_gradient_checkpointing = remat
    cfg.use_snr_optim = True
    cfg.trainer.mask_fraction, cfg.trainer.random_mask_fraction = 0.15, 0.2
    w = ModelTrainerWrapper(cfg.model, TokenizerInfo(0, 1, 2, 512),
                            cfg.trainer, device=dev).init_weights(0)
    trainer = Trainer(cfg, w)
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 6))
    labels = torch.randint(3, 511, (4, 48), device=dev, generator=_gen(dev, 7))
    kernels = (fa.flash_fwd, fa.flash_bwd, sparse_block, moe_ffn)
    for kern in kernels:
        kern.launches = 0
    losses = [float(trainer._train_step(images, labels, 0, i)[
        "train_loss_lm"]) for i in range(3)]
    torch.cuda.synchronize()
    calls = 3 * w.model.sdpa_calls(48)
    got = {kern.__name__: kern.launches for kern in kernels}
    assert calls > 0 and got == {
        "flash_fwd": (2 if remat else 1) * calls, "flash_bwd": calls,
        "sparse_block": 0, "moe_ffn": 0}
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


# -- int4 dequant-matmul ---------------------------------------------------------

TINY_GPT2 = dict(n_layer=2, n_embd=128, n_head=4)


# GPT-2-medium's four quantized Linears (in_pad, out) at 256 decode rows and
# the training step's 1,344, and a split case (256 rows, in 4096, out 1024:
# 16 output tiles, 8 splits of 8 strip pairs).
INT4_GPT2M = [(rows, in_f, out_f) for rows in (256, 1344)
              for in_f, out_f in ((1024, 3072), (1024, 1024), (1024, 4096),
                                  (4096, 1024))]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_f,out_f", [
    (rows, in_f, 1000) for rows in (1, 7, 256, 1344) for in_f in (64, 4096)
] + INT4_GPT2M + [(256, 4096, 1024), (300, 192, 1000), (7, 4096, 999)])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_int4_matmul_kernel_matches_plain(dev, rows, in_f, out_f,
                                          scale_dtype):
    """Rows below one tile and ragged, out 1000 and 999 (not a tile
    multiple; odd), the narrowest and the widest packed width, an odd
    count of strip pairs (in 192), the GPT-2-medium shapes on both tiles,
    split over the input and not, scales in both dtypes; two reruns
    bitwise equal (the split's partials sum in a fixed order)."""
    from image2text_torch.ops.int4_matmul import (int4_matmul,
                                                  int4_matmul_plain,
                                                  quantize_pack_int4)

    g = _gen(dev, rows + in_f)
    w = torch.randn(out_f, in_f, device=dev, generator=g) * 0.02
    packed, scales = quantize_pack_int4(w)
    scales = scales.to(scale_dtype)
    x = torch.randn(rows, in_f, device=dev, generator=g).to(torch.bfloat16)
    before = int4_matmul.launches
    got = int4_matmul(x, packed, scales)
    want = int4_matmul_plain(x, packed, scales)
    again = [int4_matmul(x, packed, scales) for _ in range(2)]
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 3
    assert got.shape == (rows, out_f) and got.dtype == torch.bfloat16
    check_output("int4_matmul", got, want)
    assert all(torch.equal(got, y) for y in again)


@pytest.mark.cuda
def test_int4_matmul_raises_on_what_the_kernel_does_not_take(dev):
    from image2text_torch.ops.int4_matmul import int4_matmul

    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    packed = t(8, 32, dtype=torch.uint8)
    cases = [(t(4, 64, dtype=torch.float32), packed, t(8, 1)),   # x dtype
             (t(4, 64), packed, t(8, 1, dtype=torch.float16)),   # scales
             (t(4, 96), t(8, 48, dtype=torch.uint8), t(8, 1)),   # in_pad % 64
             (t(4, 64), packed, t(8, 2)),                        # scales shape
             (t(4, 128), packed, t(8, 1))]                       # x width
    before = int4_matmul.launches
    for x, p, s in cases:
        with pytest.raises(ValueError):
            int4_matmul(x, p, s)
    assert int4_matmul.launches == before


def _tiny_gpt2m(dev, monkeypatch):
    from image2text_torch.configs.models import gpt2_medium_config
    from image2text_torch.models.hf_decoders import factory
    from image2text_torch.models.quantization import fill_random_int4

    monkeypatch.setitem(factory.GPT2_TABLE, "gpt2-medium", TINY_GPT2)
    model = VisionEncoderDecoder(gpt2_medium_config(tiny=True), device=dev
                                 ).init_weights(0)
    g = _gen(dev, 9)
    fill_random_int4(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".lora_B." in name:
                p.normal_(0.0, 0.02, generator=g)
    return model


@pytest.mark.cuda
def test_tiny_gpt2_caption_on_card_launches_int4(dev, monkeypatch):
    """The tiny int4 + LoRA GPT-2 captioner in bf16: every quantized
    Linear forward of a caption call launches the kernel (prefill and one
    decoder forward per new token), and the first-step logits agree with
    the plain-version path normwise."""
    from image2text_torch.models.generation import prefill
    from image2text_torch.models.quantization import QuantizedLinear
    from image2text_torch.ops import int4_matmul as i4

    model = _tiny_gpt2m(dev, monkeypatch).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.full((4, 1), 50256, dtype=torch.long, device=dev)
    n_q = sum(isinstance(m, QuantizedLinear) for m in model.decoder.modules())
    before = i4.int4_matmul.launches
    ids = model.generate(images, prompt, max_new_tokens=8, temperature=0.7,
                         top_k=16, generator=_gen(dev, 5))
    torch.cuda.synchronize()
    assert ids.shape == (4, 9) and bool((ids < 50259).all())
    assert i4.int4_matmul.launches - before == 9 * n_q > 0

    def first_logits():
        with torch.no_grad():
            return prefill(model, model.encoder(images), prompt, 9)[0][:, -1]

    got = first_logits()
    kernel = i4.int4_matmul
    monkeypatch.setattr(i4, "int4_matmul", i4.int4_matmul_plain)
    want = first_logits()
    monkeypatch.setattr(i4, "int4_matmul", kernel)
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert float(rel) <= TOL


@pytest.mark.cuda
def test_tiny_gpt2_training_step_on_card(dev, monkeypatch):
    """Three bf16 kbit + LoRA steps of the tiny captioner: finite, falling
    loss; per step one int4 launch per quantized Linear, one flash forward
    and backward per attention call; frozen tensors unchanged."""
    from image2text_torch.configs.trainer import gpt2_medium_training_config
    from image2text_torch.models.hf_decoders import factory
    from image2text_torch.models.quantization import (QuantizedLinear,
                                                      fill_random_int4)
    from image2text_torch.nn.core import frozen_param_paths
    from image2text_torch.ops.int4_matmul import int4_matmul
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    monkeypatch.setitem(factory.GPT2_TABLE, "gpt2-medium", TINY_GPT2)
    cfg = gpt2_medium_training_config(tiny=True)
    w = ModelTrainerWrapper(cfg.model, TokenizerInfo(50256, 50256, None,
                                                     50257),
                            cfg.trainer, device=dev).init_weights(0)
    fill_random_int4(w.model, _gen(dev, 8))
    tensors = dict(w.model.named_parameters()) | dict(w.model.named_buffers())
    frozen = {k: tensors[k].clone() for k in frozen_param_paths(w.model)}
    trainer = Trainer(cfg, w)
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 6))
    labels = torch.full((4, 24), -100, dtype=torch.long, device=dev)
    labels[:, :16] = torch.randint(3, 50000, (4, 16), device=dev,
                                   generator=_gen(dev, 7))
    kernels = (fa.flash_fwd, fa.flash_bwd, int4_matmul)
    for kern in kernels:
        kern.launches = 0
    losses = [float(trainer._train_step(images, labels, 0, i)[
        "train_loss_lm"]) for i in range(3)]
    torch.cuda.synchronize()
    n_q = sum(isinstance(m, QuantizedLinear) for m in w.model.decoder.modules())
    calls = 3 * w.model.sdpa_calls(24)
    assert {kern.__name__: kern.launches for kern in kernels} == {
        "flash_fwd": calls, "flash_bwd": calls,
        "int4_matmul": 3 * n_q}
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    assert all(torch.equal(tensors[k], v) for k, v in frozen.items())


# -- the beam-search slice: encoder front, dense block, ban mask ------------------


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_fused_frontend_kernel_matches_plain(dev, bias):
    """Projector GEMM + bias, the two slab LayerNorms and the positional
    table, CLS rows in front: 3 images of 16 rows, din 128 → d 128 (one
    ragged GEMM tile), and the flagship's front widths at 2 images."""
    from image2text_torch.ops.fused_frontend import (FrontendWeights,
                                                     fused_frontend,
                                                     fused_frontend_plain)

    g = _gen(dev, 13)
    for b, t, din, d, n_cls in ((3, 16, 128, 128, 8), (2, 256, 2048, 1024,
                                                         64)):
        def r(*shape, scale=1.0):
            return (torch.randn(*shape, device=dev, generator=g) * scale
                    ).to(torch.bfloat16)

        w = FrontendWeights(
            w_p=r(din, d, scale=din ** -0.5), b_p=r(d) if bias else None,
            ln_w=1 + r(t, d, scale=0.1), ln_b=r(t, d, scale=0.1) if bias
            else None, wpe=r(t, d), cls=r(n_cls, d))
        x = r(b, t, din)
        before = fused_frontend.launches
        got = fused_frontend(x, w)
        want = fused_frontend_plain(x, w)
        torch.cuda.synchronize()
        assert fused_frontend.launches == before + 1
        assert got.shape == (b, n_cls + t, d)
        assert torch.equal(got[:, :n_cls], want[:, :n_cls])
        check_output("fused_frontend", got, want)


@pytest.mark.cuda
def test_fused_frontend_raises_on_what_the_kernels_do_not_take(dev):
    from image2text_torch.ops.fused_frontend import (FrontendWeights,
                                                     fused_frontend)

    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    good = FrontendWeights(t(64, 32), None, t(4, 32), None, t(4, 32), t(2, 32))
    cases = [(t(1, 4, 64, dtype=torch.float32), good),              # dtype
             (t(1, 4, 48), good._replace(w_p=t(48, 32))),            # din % 32
             (t(1, 4, 64), good._replace(ln_w=t(5, 32))),            # table
             (t(1, 4, 64), good._replace(wpe=t(4, 32, dtype=torch.float32)))]
    before = fused_frontend.launches
    for x, w in cases:
        with pytest.raises(ValueError):
            fused_frontend(x, w)
    assert fused_frontend.launches == before


def _dense_block(dev, n_embd, n_head, bias):
    cfg = TransformerConfig(
        is_sparse_attn=False,
        attn_config=SelfAttentionConfig(
            bias=bias, n_head=n_head, n_embd=n_embd,
            attn_type=SelfAttentionType.MULTI_QUERY),
        rotator_config=MoEConfig(num_experts=4, proj_features=16,
                                 gate_sizes=(32,), ff_mult_factor=2.0,
                                 top_k=2))
    blk = TransformerBlock(cfg, device=dev)
    init_parameters(blk, _gen(dev))
    return blk.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n_embd,n_head,t,bias", [
    (256, 2, 40, True),      # head dim 128, t not % 16
    (64, 4, 320, False),     # the dense twin's 320 keys at head dim 16
])
def test_fused_block_kernel_matches_plain(dev, n_embd, n_head, t, bias):
    """The dense block's chain on every row, the plain version on the
    kernel's routes; the FFN term lifted to the residual's size too."""
    from image2text_torch.ops.fused_block import fused_block, fused_block_plain

    blk = _dense_block(dev, n_embd, n_head, bias)
    x = torch.randn(5, t, n_embd, device=dev, generator=_gen(dev, 14)
                    ).to(torch.bfloat16)
    w = blk.block_weights(torch.bfloat16)
    before = fused_block.launches
    got, want, rk, gv = _run_pair(fused_block, fused_block_plain, (x, w),
                                  5 * t, w.fc.e)
    assert fused_block.launches == before + 1
    check_routes("fused_block", rk, gv, w.fc.k)
    check_output("fused_block", got, want)
    w64 = w._replace(proj=w.proj._replace(l2w=w.proj.l2w * 64,
                                          l2b=w.proj.l2b * 64))
    got, want, rk, gv = _run_pair(fused_block, fused_block_plain, (x, w64),
                                  5 * t, w.fc.e)
    check_routes("fused_block x64", rk, gv, w.fc.k)
    check_output("fused_block x64", got, want)
    with torch.no_grad():
        assert torch.equal(blk(x), fused_block(x, w))


@pytest.mark.cuda
def test_fused_block_raises_past_the_attention_shared_memory(dev):
    """More rows than the attention kernel's scores fit in a block's
    shared memory: a ValueError before any launch, not a refused launch."""
    from image2text_torch.ops.fused_block import MAX_ATTN_ROWS, fused_block

    blk = _dense_block(dev, 64, 4, False)
    w = blk.block_weights(torch.bfloat16)
    x = torch.zeros(1, MAX_ATTN_ROWS + 16, 64, device=dev,
                    dtype=torch.bfloat16)
    before = fused_block.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_block(x, w)
    assert fused_block.launches == before


def _ban_cases(dev):
    g = torch.Generator().manual_seed(15)
    x = torch.randn(6, 50258, generator=g)
    x[0, :8] = torch.tensor([0.0, -0.0] * 4)
    x[0, 8:] = -1.0
    x[1, 3:] = float("-inf")
    x[2, :40] = x[2, 40]                         # ties at the threshold
    ban = torch.randint(0, 50258, (6, 132), generator=g, dtype=torch.int32)
    ban[torch.rand(6, 132, generator=g) < 0.3] = -1
    ban[3] = torch.arange(132, dtype=torch.int32)
    ban[4, :2] = torch.tensor([50258, 60000], dtype=torch.int32)
    return x.to(dev), ban.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 50258])
@pytest.mark.parametrize("with_bans", [False, True])
def test_topk_ban_mask_kernel_equals_reference_bit_for_bit(dev, k,
                                                           with_bans):
    """The flagship's vocabulary, signed zeros, -inf inputs, ties at the
    threshold, 132 ban columns (more live bans than the JAX kernel's cap),
    ids past the vocabulary; k from 1 to the whole row."""
    from image2text_torch.ops.topk_mask import (topk_ban_mask,
                                                topk_ban_mask_reference)

    x, ban = _ban_cases(dev)
    ban = ban if with_bans else None
    before = topk_ban_mask.launches
    got = topk_ban_mask(x, ban, k)
    want = topk_ban_mask_reference(x, ban, k)
    torch.cuda.synchronize()
    assert topk_ban_mask.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_topk_ban_mask_raises_on_what_the_kernel_does_not_take(dev):
    from image2text_torch.ops.topk_mask import MAX_VOCAB, topk_ban_mask

    before = topk_ban_mask.launches
    with pytest.raises(ValueError):
        topk_ban_mask(torch.zeros(2, MAX_VOCAB + 1, device=dev), None, 4)
    with pytest.raises(ValueError):
        topk_ban_mask(torch.zeros(2, 64, device=dev),
                      torch.zeros(3, 4, dtype=torch.int32, device=dev), 4)
    assert topk_ban_mask.launches == before


@pytest.mark.cuda
def test_tiny_dense_twin_and_beam_search_on_card(dev):
    """The tiny dense twin in bf16: an encoder forward launches the front
    once and the dense block in every encoder block, and its first-step
    logits agree with the plain-version path normwise; then a beam search
    of the tiny flagship: ids and scores of the right shapes, the front
    and the sparse block once each per encoder block."""
    from image2text_torch.configs.models import flagship_dense_config
    from image2text_torch.models import encoder as encmod
    from image2text_torch.models import layers
    from image2text_torch.models.generation_utils import (
        BeamSearchTokenGenerator)
    from image2text_torch.ops.fused_block import fused_block, fused_block_plain
    from image2text_torch.ops.fused_frontend import (fused_frontend,
                                                     fused_frontend_plain)

    model = VisionEncoderDecoder(flagship_dense_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16)
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 16)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)

    def first_logits():
        with torch.no_grad():
            enc = model.encoder(images)
            cache = model.decoder.init_cache(4, 9, enc.dtype, dev)
            return decoder_step(model, prompt, cache, model.space_for_prompt,
                                enc)[0][:, -1]

    counts = fused_frontend.launches, fused_block.launches
    got = first_logits()
    assert (fused_frontend.launches, fused_block.launches) == (
        counts[0] + 1, counts[1] + 2)
    saved = (encmod.fused_frontend, layers.fused_block, layers.sparse_block,
             layers.moe_ffn)
    (encmod.fused_frontend, layers.fused_block, layers.sparse_block,
     layers.moe_ffn) = (fused_frontend_plain, fused_block_plain,
                        sparse_block_plain, moe_ffn_plain)
    try:
        want = first_logits()
    finally:
        (encmod.fused_frontend, layers.fused_block, layers.sparse_block,
         layers.moe_ffn) = saved
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert float(rel) <= TOL

    sparse = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                  ).init_weights(0).to(torch.bfloat16)
    gen = BeamSearchTokenGenerator(sparse, beam_width=3, temperature=0.7,
                                   top_k=16, max_new_tokens=8,
                                   no_repeat_n_grams=(2, 3, 4, 5),
                                   eos_token_id=0)
    counts = fused_frontend.launches, sparse_block.launches
    ids, scores = gen(images, prompt, generator=_gen(dev, 17))
    torch.cuda.synchronize()
    assert ids.shape == (4, 3, 8) and scores.shape == (4, 3)
    assert bool(torch.isfinite(scores).all()) and bool((ids < 512).all())
    assert (fused_frontend.launches, sparse_block.launches) == (
        counts[0] + 1, counts[1] + 2)


def _gemm_plain(A, a_rows, a_T, B, bias, R, r_rows, r_T, c_T, c_off, n_img,
                t_g):
    """The GEMM contract in plain PyTorch: (n_img, c_T, N) with rows
    c_off..c_off + t_g of each image written, the rest NaN."""
    def rows_of(X, rows, T):
        if rows is None:
            return X.reshape(n_img, t_g, -1)
        return X.reshape(n_img, T, -1)[:, rows.long()]

    y = torch.matmul(rows_of(A, a_rows, a_T), B)
    if bias is not None:
        y = y + bias
    if R is not None:
        y = rows_of(R, r_rows, r_T) + y
    out = torch.full((n_img, c_T, B.shape[1]), float("nan"), device=A.device,
                     dtype=A.dtype)
    out[:, c_off:c_off + t_g] = y
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_img,t_g,K,N,rows,c_extra,bias,res", [
    (3, 37, 200, 136, True, 13, True, True),    # ragged M, N and K, row lists
    (2, 300, 1024, 1280, False, 0, False, False),  # the q/kv shape, narrow M
    (4, 160, 1024, 1024, False, 0, True, True),  # the Wo shape, residual
    (2, 256, 2048, 1024, False, 64, True, False),  # the front's projector
])
def test_gemm_kernel_matches_plain(dev, n_img, t_g, K, N, rows, c_extra,
                                   bias, res):
    """The wgmma GEMM of csrc/gemm.cuh: row lists on A and the residual, C
    rows at an offset inside longer images, optional bias and residual,
    against torch.matmul and the same bf16 adds."""
    from image2text_torch.ops import _build
    from image2text_torch.ops.fused_block import _gemm

    g = _gen(dev, 7)
    T = t_g + 11 if rows else t_g
    A = torch.randn(n_img * T, K, device=dev, generator=g).to(torch.bfloat16)
    B = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5
         ).to(torch.bfloat16)
    b = (torch.randn(N, device=dev, generator=g).to(torch.bfloat16)
         if bias else None)
    R = (torch.randn(n_img * T, N, device=dev, generator=g
                     ).to(torch.bfloat16) if res else None)
    idx = (torch.randperm(T, generator=torch.Generator().manual_seed(1)
                          )[:t_g].to(torch.int32).to(dev) if rows else None)
    c_T, c_off = t_g + c_extra, c_extra
    C = torch.full((n_img * c_T, N), float("nan"), device=dev,
                   dtype=torch.bfloat16)
    lib = _build.load("fused_block")
    stream = torch.cuda.current_stream(dev).cuda_stream
    import ctypes
    _gemm(lib, ctypes.c_void_p(stream), A, idx, T, B, b, R, idx, T, C, c_T,
          c_off, n_img, t_g)
    want = _gemm_plain(A, idx, T, B, b, R, idx, T, c_T, c_off, n_img, t_g)
    got = C.reshape(n_img, c_T, N)
    torch.cuda.synchronize()
    assert torch.isnan(got[:, :c_off]).all()
    check_output("gemm", got[:, c_off:], want[:, c_off:])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 17, 160, 320, 432])
def test_mqa_attention_kernel_matches_plain(dev, t):
    """The head-folded MQA kernel at 8 heads x head dim 128, from 16 keys
    to the shared-memory limit (MAX_ATTN_ROWS), against ops.attention.sdpa."""
    import ctypes
    import math

    from image2text_torch.ops import _build
    from image2text_torch.ops.attention import sdpa
    from image2text_torch.ops.fused_block import MAX_ATTN_ROWS, _attention

    assert t <= MAX_ATTN_ROWS
    b, h, hd = 3, 8, 128
    # N(0, 1) rows, as a LayerNormed stream's projections are: scores of
    # standard deviation ~1 after the 1/sqrt(hd) scale
    qkv = torch.randn(b * t, (h + 2) * hd, device=dev, generator=_gen(dev, 4)
                      ).to(torch.bfloat16)
    lib = _build.load("fused_block")
    got = _attention(lib, ctypes.c_void_p(torch.cuda.current_stream(
        dev).cuda_stream), qkv, b, t, h, hd)
    q3 = qkv.reshape(b, t, -1)
    q = q3[..., :h * hd].reshape(b, t, h, hd).transpose(1, 2)
    k = q3[..., None, h * hd:(h + 1) * hd].transpose(1, 2)
    v = q3[..., None, (h + 1) * hd:].transpose(1, 2)
    want = sdpa(q, k, v).transpose(1, 2).reshape(b * t, h * hd)
    torch.cuda.synchronize()
    assert math.isfinite(float(got.float().abs().max()))
    check_output(f"mqa_attention t={t}", got, want)


def _mqa_case(dev, b, t, h, hd, score_std, seed):
    """qkv rows whose scores q·k/sqrt(hd) have standard deviation
    ``score_std``, and their q (b, h, t, hd), k and v (b, 1, t, hd)."""
    import math

    qkv = (torch.randn(b * t, (h + 2) * hd, device=dev,
                       generator=_gen(dev, seed)) * math.sqrt(score_std)
           ).to(torch.bfloat16)
    q3 = qkv.reshape(b, t, -1)
    q = q3[..., :h * hd].reshape(b, t, h, hd).transpose(1, 2)
    k = q3[..., None, h * hd:(h + 1) * hd].transpose(1, 2)
    v = q3[..., None, (h + 1) * hd:].transpose(1, 2)
    return qkv, q, k, v


def _mqa_kernel(dev, qkv, b, t, h, hd):
    import ctypes

    from image2text_torch.ops import _build
    from image2text_torch.ops.fused_block import _attention

    got = _attention(_build.load("fused_block"), ctypes.c_void_p(
        torch.cuda.current_stream(dev).cuda_stream), qkv, b, t, h, hd)
    return got.reshape(b, t, h, hd).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 17, 160, 320, 432])
def test_mqa_attention_kernel_matches_plain_at_input_scale_2(dev, t):
    """The 2·N(0, 1) inputs next to the N(0, 1) ones above: scores of
    standard deviation 4, where a score near a bf16 rounding boundary may
    round the other way in the kernel and in sdpa (both round the scores
    to bf16, as the reference specifies), so one element can exceed the
    0.06 element bound.  The bound here is the measured sensitivity of
    that rounding (``kernel_check.attention_sensitivity``): the worst
    element error at most twice the larger of sdpa's and a reordered
    sdpa's error against the f64 formulation rounded at the same points;
    and the normwise limits as everywhere."""
    from image2text_torch.ops.fused_block import MAX_ATTN_ROWS
    from image2text_torch.utils.kernel_check import attention_sensitivity

    assert t <= MAX_ATTN_ROWS
    b, h, hd = 3, 8, 128
    qkv, q, k, v = _mqa_case(dev, b, t, h, hd, 4.0, 4)
    got = _mqa_kernel(dev, qkv, b, t, h, hd)
    st = attention_sensitivity(got, q, k, v)
    from image2text_torch.ops.attention import sdpa
    norm = output_error(got, sdpa(q, k, v))
    assert norm["finite"] and norm["rel_l2"] <= REL_L2, norm
    assert st["kernel_vs_sdpa"] <= 2 * st["sensitivity"], st


@pytest.mark.cuda
@pytest.mark.parametrize("t", [160, 320])
@pytest.mark.parametrize("score_std", [1.0, 2.0, 4.0])
def test_mqa_attention_error_within_twice_the_reference_sensitivity(
        dev, t, score_std):
    """The chain attention at the flagship's 8 heads x 128 and the dense
    twin's and sparse encoder's key counts: the kernel's worst element
    error against sdpa stays within twice the sensitivity of the
    reference's own bf16 score rounding (else it is a kernel fault)."""
    from image2text_torch.utils.kernel_check import attention_sensitivity

    b, h, hd = 4, 8, 128
    qkv, q, k, v = _mqa_case(dev, b, t, h, hd, score_std, 5)
    st = attention_sensitivity(_mqa_kernel(dev, qkv, b, t, h, hd), q, k, v)
    assert 0 < st["sensitivity"] and st["kernel_vs_sdpa"] <= 2 * st[
        "sensitivity"], st


@pytest.mark.cuda
def test_lm_head_and_eval_attention_make_no_f32_copy(dev):
    """The tied lm_head at the flagship's vocab (50,258 x 1,024) and a
    decode step's eval attention against a bf16 KV cache: bf16 products
    summed in f32 (aten::mm.dtype / bmm.dtype), f32 results.  The rise in
    peak memory over each call stays below the f32 copy of its weight or
    of the cache that the previous formulation made."""
    from image2text_torch.ops.attention import sdpa
    from image2text_torch.ops.functions import dot_f32

    g = _gen(dev, 15)
    x = torch.randn(256, 1, 1024, device=dev, generator=g).to(torch.bfloat16)
    w = (0.02 * torch.randn(50258, 1024, device=dev, generator=g)
         ).to(torch.bfloat16)

    def rise(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    logits, up = rise(lambda: dot_f32(x, w))
    assert logits.dtype == torch.float32 and logits.shape == (256, 1, 50258)
    assert up < w.numel() * 4, up     # an f32 copy of w alone: 206 MB
    torch.testing.assert_close(logits, x.float() @ w.float().t(),
                               rtol=1e-4, atol=1e-4)
    cache = torch.randn(2, 256, 16, 512, 64, device=dev, generator=g
                        ).to(torch.bfloat16)
    q = torch.randn(256, 16, 1, 64, device=dev, generator=g
                    ).to(torch.bfloat16)
    k, v = cache[0, :, :, :300], cache[1, :, :, :300]
    out, up = rise(lambda: sdpa(q, k, v))
    assert up < k.numel() * 4, up     # an f32 copy of the cached keys
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 192, 256, 40960])
@pytest.mark.parametrize("regime", ["auto", "other"])
def test_moe_ffn_kernel_regimes_match_plain(dev, rows, regime):
    """The MoE FFN at 1024 → 2048 → 1024 with the LN2 prologue and the
    residual, in the regime the row count picks and forced into the other
    one (the many-rows kernel at few rows; the hidden split at 40,960)."""
    from image2text_torch.ops.fused_moe import launch_moe_ffn, moe_slices
    from image2text_torch.utils.device import sm_count

    blk = _block(dev, 1024, 8, 32, True)
    fc = blk.mlp.c_fc.packed(torch.bfloat16)
    proj = blk.mlp.c_proj.packed(torch.bfloat16)
    proj = proj._replace(l2w=proj.l2w * 64, l2b=proj.l2b * 64)
    x = torch.randn(rows, 1024, device=dev, generator=_gen(dev, 5)
                    ).to(torch.bfloat16)
    auto = moe_slices(rows, fc.l2w.shape[1], sm_count(dev))
    slices = auto if regime == "auto" else (1 if auto > 1 else 8)
    ln = dict(ln_w=blk.ln_2.weight, ln_b=blk.ln_2.bias)
    routes = torch.zeros(rows, 2, dtype=torch.uint8, device=dev)
    gates = torch.zeros(rows, 2, fc.e, dtype=torch.float32, device=dev)
    got = torch.empty_like(x)
    launch_moe_ffn(x, fc, proj, got, residual=x, routes=routes,
                   slices=slices, **ln)
    want = moe_ffn_plain(x, fc, proj, residual=x, force_routes=routes,
                         gates=gates, **ln)
    torch.cuda.synchronize()
    check_routes("moe_ffn", routes, gates, fc.k)
    check_output(f"moe_ffn rows={rows} slices={slices}", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_gelu", "no_softmax", "no_ln",
                                     "dots_only", "exp2", "glu_sig"])
def test_block_ablate_variant_matches_its_plain_chain(dev, variant):
    """Each probe build of the chain (its own .so) against the probe's
    plain chain with the same substitutions, at the probe's widths."""
    from image2text_torch.probes.block_ablate import check_variant, probe_block

    x, w = probe_block(2, dev)
    with torch.no_grad():
        check_variant(variant, x, w)


@pytest.mark.cuda
def test_block_wide_groupings_equal_the_whole_batch(dev):
    """Launches over groups of images give the whole batch's rows: bit for
    bit where the MoE FFN splits its hidden sum alike, else within the
    kernel checks' limits."""
    from image2text_torch.ops.fused_block import run_chain
    from image2text_torch.ops.fused_moe import moe_slices
    from image2text_torch.probes.block_ablate import probe_block
    from image2text_torch.probes.block_wide import (VARIANTS, grouped,
                                                    launch_rows)
    from image2text_torch.utils.device import sm_count

    x, w = probe_block(16, dev)
    hidden = w.fc.l2w.shape[1]
    with torch.no_grad():
        ref = run_chain(x, w)
        for name in VARIANTS:
            y = grouped(run_chain, x, w, name)
            if moe_slices(launch_rows(x, name), hidden,
                          sm_count(dev)) == moe_slices(
                    x.shape[0] * x.shape[1], hidden, sm_count(dev)):
                assert torch.equal(y, ref), name
            check_output(f"block_wide {name}", y, ref)
