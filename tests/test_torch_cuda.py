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
kernels on both routes (K/V resident up to 160 keys, tiled beyond and at
head dim 256), every bias broadcast form on each, bitwise-deterministic
reruns and the causal band skip with its visited pairs on each;
the lm_head and the eval attention without f32 copies.  The f32 forms of
the flash kernels and the encoder front (the offline configs' precision
'no') against their plain versions at the f32 limits.  The W8A8
product (``torch._int_mm`` on padded operands) bit for bit against the
CPU's exact one, and the serving modes' launch counts.  The caption call's
graph route (``models/graphs.py``): a replayed call's ids bit for bit the
eager route's, greedy and sampled, through a run of calls on one
generator; a weight written in place captures anew; a replay adds the
launch counts of one eager call.  Beam search's graph route: ids, scores
and rounds taken bit for bit the eager route's, every beam finishing
early included, a generator's state after calls in a row alike; the HF
decoders' caption and beam calls (the tiny GPT-2-medium, the f32 tiny
Llama-2-7B form) on the graph route.
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


@pytest.mark.cuda
def test_graphed_caption_call_equals_eager_and_counts_launches(dev):
    """The tiny flagship's caption call on the graph route: the capturing
    call and the replays give the eager route's ids bit for bit (greedy
    and sampled, a generator's run of calls, the default generator), and
    a replay adds what one eager call counts."""
    from image2text_torch.models import graphs

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)
    assert graphs.graph_plan(model, dev, prompt_len=1,
                             max_new_tokens=8)[0] == "graph"
    wrappers = graphs.counted_wrappers()

    def call(use, gen, temperature=0.7, x=images):
        before = [w.launches for w in wrappers]
        ids = model.generate(x, prompt[:x.shape[0]], max_new_tokens=8,
                             temperature=temperature, top_k=16,
                             generator=gen, graphs=use)
        torch.cuda.synchronize()
        return ids, [w.launches - n for w, n in zip(wrappers, before)]

    for temperature in (0.0, 0.7):
        want, counts = call(False, _gen(dev, 5), temperature)
        assert sum(counts) > 0
        for _ in range(2):     # the capturing call, then a replay
            got, got_counts = call(True, _gen(dev, 5), temperature)
            assert torch.equal(got, want) and got_counts == counts
    assert graphs.held_graphs(model) == 2
    g, h = _gen(dev, 9), _gen(dev, 9)
    for _ in range(3):
        assert torch.equal(call(True, g)[0], call(False, h)[0])
    torch.cuda.manual_seed(3)
    want = call(False, None)[0]
    torch.cuda.manual_seed(3)
    assert torch.equal(call(True, None)[0], want)
    assert graphs.held_graphs(model) == 2
    call(True, _gen(dev, 5), x=images[:2])     # another batch: its own
    assert graphs.held_graphs(model) == 3


@pytest.mark.cuda
def test_graphed_caption_call_recaptures_after_a_weight_write(dev):
    from image2text_torch.models import graphs

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)

    def call(use):
        return model.generate(images, prompt, max_new_tokens=8,
                              temperature=0.7, top_k=16,
                              generator=_gen(dev, 6), graphs=use)

    before = call(True)
    assert torch.equal(call(True), before)
    with torch.no_grad():      # the MoE FFNs' packed operands, and ln_f
        for blk in model.decoder.blocks:
            next(blk.mlp.parameters()).mul_(-1.0)
        model.decoder.transformer.ln_f.weight.mul_(-1.0)
    want = call(False)
    assert not torch.equal(want, before)
    assert torch.equal(call(True), want)      # captured anew
    assert torch.equal(call(True), want)      # and replayed
    assert graphs.held_graphs(model) == 1


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


@pytest.mark.cuda
def test_graphed_caption_call_holds_the_cached_operands_it_reads(dev):
    """A replay reads the packed operands its warm-up cached: dropping the
    model's caches (as ``int8_serving_params`` does) and writing over
    blocks of their sizes leaves a replay's ids the eager route's, and
    the eager call that refills the caches does not disturb it."""
    from image2text_torch.models import graphs
    from image2text_torch.models.layers import _Cached

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)

    def call(use):
        return model.generate(images, prompt, max_new_tokens=8,
                              temperature=0.7, top_k=16,
                              generator=_gen(dev, 6), graphs=use)

    want = call(False)
    assert torch.equal(call(True), want)             # captured
    specs = [(t.shape, t.dtype)
             for t in _tensors(graphs.cached_operands(model))]
    assert specs
    for mod in model.modules():
        for value in vars(mod).values():
            if isinstance(value, _Cached):
                value.clear()
        getattr(mod, "_rows", {}).clear()
    torch.cuda.synchronize()
    junk = [torch.full(shape, 7, dtype=dtype, device=dev)
            for shape, dtype in specs]
    assert torch.equal(call(True), want)             # a replay
    assert torch.equal(call(False), want)            # refills the caches
    del junk
    assert torch.equal(call(True), want)
    assert graphs.held_graphs(model) == 1


def _eos_hook(model, eos: int, after: int):
    """A hook raising ``eos``'s logit far above the rest at every decoder
    position from ``space_for_prompt + after`` on (a Python offset, so a
    capture records it): every beam ends in EOS a few rounds in."""
    def hook(module, args, kwargs, out):
        if kwargs.get("pos_offset", 0) < model.space_for_prompt + after:
            return out
        # a comparison with a Python int: no host-to-device copy
        ids = torch.arange(out[0].shape[-1], device=out[0].device)
        return out[0] + (ids == eos) * 1e3, out[1]
    return model.decoder.register_forward_hook(hook, with_kwargs=True)


def _beam_routes(model, dev, images, prompt, wrappers, **kw):
    """``call(use, gen)``: one synchronised beam call on the graph route
    (``use``) or the eager one: (ids, scores, rounds taken, the counted
    wrappers' launches over it)."""
    from image2text_torch.models.generation_utils import (
        BeamSearchTokenGenerator)

    beam = BeamSearchTokenGenerator(
        model, **(dict(beam_width=3, beam_expansion_factor=4, top_k=16,
                       max_new_tokens=8, no_repeat_n_grams=(2, 3, 4, 5),
                       eos_token_id=0) | kw))

    def call(use, gen):
        before = [w.launches for w in wrappers]
        ids, scores = beam(images, prompt, generator=gen, graphs=use)
        torch.cuda.synchronize()
        return (ids, scores, int(beam.rounds_taken),
                [w.launches - n for w, n in zip(wrappers, before)])
    return beam, call


@pytest.mark.cuda
def test_graphed_beam_call_equals_eager_and_counts_launches(dev):
    """The tiny flagship's beam search on the graph route: the capturing
    call and a replay give the eager route's ids, scores and rounds taken
    bit for bit (greedy, sampled, int8 cross-KV), and a replay adds what
    an eager call that ran every round counts; every beam finishing early
    (EOS pushed by a hook): the same outputs, the eager loop stopping;
    two calls in a row from one generator on each route equal, the
    generators left in one state."""
    from image2text_torch.models import graphs

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev
                                 ).init_weights(0).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)
    assert graphs.graph_plan(model, dev, prompt_len=1, max_new_tokens=8,
                             beam=True)[0] == "graph"
    wrappers = graphs.counted_wrappers()
    for kw in (dict(temperature=0.0, consolidation_temperature=0.0),
               dict(temperature=0.7), dict(temperature=0.7,
                                           cross_kv_quant="int8")):
        beam, call = _beam_routes(model, dev, images, prompt, wrappers, **kw)
        want = call(False, _gen(dev, 5))
        assert beam.rounds == 7 and want[2] == 7 and sum(want[3]) > 0
        for _ in range(2):     # the capturing call, then a replay
            got = call(True, _gen(dev, 5))
            assert beam.rounds == 7
            assert (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]))
            assert got[2:] == want[2:]
    assert graphs.held_graphs(model) == 3
    handle = _eos_hook(model, 0, 3)
    try:
        graphs.release(model)
        beam, call = _beam_routes(model, dev, images, prompt, wrappers,
                                  temperature=0.7, length_boost=1.5)
        g_eager, g_graph = _gen(dev, 6), _gen(dev, 6)
        for _ in range(3):     # capture, then replays
            want = call(False, g_eager)
            assert beam.rounds < 7 and want[2] == beam.rounds
            got = call(True, g_graph)
            assert (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]) and got[2] == want[2])
        assert bool((want[0][:, :, -1] == 0).all())
        assert torch.equal(g_eager.get_state(), g_graph.get_state())
    finally:
        handle.remove()
        graphs.release(model)


@pytest.mark.cuda
def test_graphed_hf_calls_equal_eager(dev, monkeypatch):
    """The tiny int4 + LoRA GPT-2-medium (bf16) on the graph route: a
    caption call and a beam-search call, each captured then replayed,
    equal to the eager route's bit for bit with the same launch counts;
    the tiny f32 Llama-2-7B form's greedy caption too (cuBLAS products
    under capture)."""
    from image2text_torch.models import graphs

    model = _tiny_gpt2m(dev, monkeypatch).to(torch.bfloat16).eval()
    images = torch.randn(4, 3, 64, 64, device=dev, generator=_gen(dev, 4)
                         ).to(torch.bfloat16)
    prompt = torch.full((4, 1), 50256, dtype=torch.long, device=dev)
    assert graphs.graph_plan(model, dev, prompt_len=1,
                             max_new_tokens=8)[0] == "graph"
    wrappers = graphs.counted_wrappers()

    def caption(m, use, x, p, temperature=0.7):
        before = [w.launches for w in wrappers]
        ids = m.generate(x, p, max_new_tokens=8, temperature=temperature,
                         top_k=16, generator=_gen(dev, 5), graphs=use)
        torch.cuda.synchronize()
        return ids, [w.launches - n for w, n in zip(wrappers, before)]

    want = caption(model, False, images, prompt)
    assert sum(want[1]) > 0
    for _ in range(2):
        got = caption(model, True, images, prompt)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
    beam, call = _beam_routes(model, dev, images, prompt, wrappers,
                              temperature=0.7, eos_token_id=None)
    want = call(False, _gen(dev, 6))
    for _ in range(2):
        got = call(True, _gen(dev, 6))
        assert (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and got[2:] == want[2:])
    assert graphs.held_graphs(model) == 2
    llama = _hf_tiny("llama", dev, monkeypatch, int4=False).init_weights(
        0).eval()
    x = torch.randn(2, 3, 32, 32, generator=_gen(dev), device=dev)
    p = torch.ones(2, 1, dtype=torch.long, device=dev)
    want = caption(llama, False, x, p, 0.0)[0]
    assert torch.equal(caption(llama, True, x, p, 0.0)[0], want)
    assert torch.equal(caption(llama, True, x, p, 0.0)[0], want)


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
    # the families' training planes (batch cut): nano's d 64 full heads,
    # Llama-2-13B's 272 keys, Falcon-7B's 71 heads on one K/V head
    (2, 20, 20, 256, 256, 64, None, True, 0.1),
    (1, 40, 40, 272, 272, 128, "soft_prompt", True, 0.0),
    (1, 71, 1, 320, 320, 64, "soft_prompt", True, 0.0),
    # Falcon-7B's 71 heads on one K/V head with dropout; the tiled route at
    # head dim 256 with the soft-prompt bias, causal, dropout
    (1, 71, 1, 320, 320, 64, None, True, 0.1),
    (2, 4, 1, 200, 200, 256, "soft_prompt", True, 0.1),
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
@pytest.mark.parametrize("skv", [160, 200])
def test_flash_bwd_takes_every_bias_broadcast_form(dev, kind, hk, skv):
    """(1|b, 1|h, 1|sq, skv) biases, multi-query and not, causal, at the
    resident route's 160-key limit and past it on the tiled route."""
    b, h, sq, d, rate, seed = 2, 4, 150, 64, 0.1, 321
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
    (400, 300, None),              # the tiled route: rows 0..99 keyless
    (300, 300, (5, 70, 130, 290)),  # the tiled route, rows masked whole
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
    values.  Without a bias the visited pairs are ``bwd_pairs``'s
    (resident: query tile × key slice) or ``tiled_bwd_pairs``'s (tiled:
    query tile × key tile): every key slice or tile for a query tile
    holding a keyless row."""
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
    count = (fa.bwd_pairs if fa.bwd_plan(b, h, 1, sq, skv, 132, d)[0]
             == "resident" else fa.tiled_bwd_pairs)
    if masked_rows is None:
        assert int(pairs) == count(b, h, sq, skv, True)
    for name, mine, ref in zip(("dq", "dk", "dv"), got,
                               fa.flash_backward_plain(*a, *gr)):
        st = output_error(mine, ref)
        assert (st["finite"] and st["rel_l2"] <= REL_L2
                and st["max_abs_err"] <= MAX_ABS_SHARE * st["max_plain"]), (
            name, st)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk,sq,skv,d,bias", [
    (20, 20, 256, 256, 64, None),          # nano's plane, one head a plane
    (71, 1, 320, 320, 64, None),           # Falcon-7B's: G > 1, partials
    (8, 1, 256, 1024, 128, None),          # FLASH_LONG's
    (4, 4, 272, 272, 128, "soft_prompt"),  # a bias that leaves no row keyless
    (8, 1, 160, 160, 256, None),           # head dim 256 at 160 keys
])
def test_flash_tiled_bwd_visits_the_pairs_the_band_leaves(dev, h, hk, sq,
                                                          skv, d, bias):
    """The tiled dK/dV kernel's visited (32-row query tile, 64-key tile)
    pairs are ``tiled_bwd_pairs``'s, decided on the card from the causal
    band and, under a bias, the saved lse; the gradients within the
    kernel checks' limits and a rerun bitwise equal (batch cut to 1)."""
    b, rate, seed = 1, 0.1, 2468
    assert fa.bwd_plan(b, h, hk, sq, skv, 132, d)[0] == "tiled"
    g = _gen(dev, 17)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g
                                 ).to(torch.bfloat16)
                     for shape in ((b, h, sq, d), (b, hk, skv, d),
                                   (b, hk, skv, d), (b, h, sq, d)))
    bias = _flash_bias(bias, b, h, sq, skv, dev, g)
    a = (q, k, v, bias, True)
    want, lse = fa.flash_forward_plain(*a, rate, seed)
    gr = (dout, lse, (dout.float() * want.float()).sum(-1), rate, seed)
    pairs = torch.zeros(1, dtype=torch.int32, device=dev)
    got = fa.flash_bwd(*a, *gr, pairs=pairs)
    again = fa.flash_bwd(*a, *gr)
    torch.cuda.synchronize()
    band = fa.tiled_bwd_pairs(b, h, sq, skv, True)
    assert int(pairs) == band < fa.tiled_bwd_pairs(b, h, sq, skv, False)
    for name, mine, ref, rerun in zip(("dq", "dk", "dv"), got,
                                      fa.flash_backward_plain(*a, *gr),
                                      again):
        check_output(f"flash_bwd {name}", mine, ref)
        assert torch.equal(mine, rerun), name


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    cases = [(t(1, 2, 8, 320), t(1, 1, 8, 320), None),       # head dim
             (t(1, 4, 8, 64), t(1, 2, 8, 64), None),          # grouped K/V
             (t(1, 2, 8, 64), t(1, 1, 8, 64),
              t(1, 1, 3, 8, dtype=torch.float32)),              # bias rows
             (t(1, 2, 8, 64, dtype=torch.float16),
              t(1, 1, 8, 64, dtype=torch.float16), None),     # dtype
             (t(1, 2, 8, 64, dtype=torch.float32),
              t(1, 1, 8, 64), None)]                          # mixed dtypes
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


# Llama-2-13B's int4 Linears split over tp2 (parallel/sharding_rules.py,
# 3): (in_pad, out) of a rank's shard — q/k/v and gate/up keep half their
# rows, o_proj and down_proj half their byte columns — at 24 beam decode
# rows and 384 training rows.
INT4_LLAMA_TP2 = [(rows, in_f, out_f) for rows in (24, 384)
                  for in_f, out_f in ((5120, 2560), (2560, 5120),
                                      (5120, 6912), (6912, 5120))]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_f,out_f", INT4_LLAMA_TP2)
@pytest.mark.parametrize("f32_out", [False, True], ids=["bf16", "f32"])
def test_int4_matmul_on_shard_operands_matches_plain(dev, rows, in_f, out_f,
                                                     f32_out):
    """A whole Linear's shards as the placement cuts them (two halves of
    rows for a column shard, a contiguous run of byte columns and their
    scale columns for a row shard): the kernel on each shard against its
    plain version, bf16 scales as the model's cast leaves them; a column
    shard's output is the whole product's columns of its halves, the row
    shards' outputs sum to the whole product.  In x's bf16 at the kernel
    check's limits, and with ``out_dtype`` f32 (a row shard's unrounded
    partial product; one split and, at 24 rows of 5120 → 2560, three
    summed by the reduce kernel) at the f32 limits."""
    from image2text_torch.ops.int4_matmul import (int4_matmul,
                                                  int4_matmul_plain,
                                                  int4_plan,
                                                  quantize_pack_int4)
    from image2text_torch.parallel.sharding_rules import shard
    from image2text_torch.utils.device import sm_count
    from image2text_torch.utils.kernel_check import F32_LIMITS

    col = in_f == 5120
    whole_in, whole_out = (in_f, 2 * out_f) if col else (2 * in_f, out_f)
    g = _gen(dev, rows + in_f + out_f)
    w = torch.randn(whole_out, whole_in, device=dev, generator=g) * 0.02
    packed, scales = quantize_pack_int4(w)
    scales = scales.to(torch.bfloat16)
    x = torch.randn(rows, whole_in, device=dev, generator=g).to(
        torch.bfloat16)
    kw = {"out_dtype": torch.float32} if f32_out else {}
    limits = (F32_LIMITS,) if f32_out else ()
    outs = []
    for r in range(2):
        if col:
            p, s, xr = (shard(packed, 0, 2, r, 2), shard(scales, 0, 2, r, 2),
                        x)
        else:
            p, s = shard(packed, 1, 1, r, 2), shard(scales, 1, 1, r, 2)
            xr = shard(x, 1, 2, r, 2).contiguous()
        assert tuple(p.shape) == (out_f, in_f // 2)
        before = int4_matmul.launches
        got = int4_matmul(xr, p, s, **kw)
        torch.cuda.synchronize()
        assert int4_matmul.launches == before + 1
        assert got.dtype == (torch.float32 if f32_out else torch.bfloat16)
        check_output("int4_matmul", got, int4_matmul_plain(xr, p, s, **kw),
                     *limits)
        outs.append(got.float())
    whole = int4_matmul_plain(x, packed, scales, **kw).float()
    if col:
        for r in range(2):
            check_output("int4_matmul", outs[r], shard(whole, 1, 2, r, 2),
                         *limits)
    else:
        check_output("int4_matmul", outs[0] + outs[1], whole, *limits)
    if (rows, in_f, out_f) == (24, 5120, 2560):
        assert int4_plan(rows, out_f, in_f, sm_count(x.device))[2] > 1


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
@pytest.mark.parametrize("b,t,din,d,n_cls,route", [
    (3, 16, 128, 128, 8, "slab"),         # t < a GEMM tile: tiles straddle images
    (3, 200, 256, 512, 8, "slab"),        # rows past t in the second GEMM tile
    (2, 256, 2048, 1024, 64, "cluster"),  # the flagship's front
    (40, 256, 2048, 512, 64, "slab"),     # GPT-2-medium's: clusters take 3 images
    (2, 256, 256, 2048, 8, "slab"),       # past SLAB_MAX_CHUNK
])
def test_fused_frontend_kernel_matches_plain(dev, bias, b, t, din, d, n_cls,
                                             route):
    """Projector GEMM + bias, the two slab LayerNorms and the positional
    table, CLS rows in front, on the route front_plan gives the shape; the
    slab route forced at every shape, the cluster route wherever its chunk
    fits; reruns bitwise equal."""
    from image2text_torch.ops.fused_frontend import (SLAB_MAX_CHUNK,
                                                     FrontendWeights,
                                                     FrontPlan, front_plan,
                                                     fused_frontend,
                                                     fused_frontend_plain,
                                                     launch_front)

    g = _gen(dev, 13)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale
                ).to(torch.bfloat16)

    w = FrontendWeights(
        w_p=r(din, d, scale=din ** -0.5), b_p=r(d) if bias else None,
        ln_w=1 + r(t, d, scale=0.1), ln_b=r(t, d, scale=0.1) if bias
        else None, wpe=r(t, d), cls=r(n_cls, d))
    x = r(b, t, din)
    plan = front_plan(t, d)
    assert plan.route == route
    before = fused_frontend.launches
    got = fused_frontend(x, w)
    want = fused_frontend_plain(x, w)
    torch.cuda.synchronize()
    assert fused_frontend.launches == before + 1
    assert got.shape == (b, n_cls + t, d)
    assert torch.equal(got[:, :n_cls], want[:, :n_cls])
    check_output(f"fused_frontend {route}", got, want)
    assert torch.equal(fused_frontend(x, w), got)
    routes = ["slab"] + (["cluster"] if plan.chunk <= SLAB_MAX_CHUNK else [])
    for forced in routes:
        out = launch_front(x, w, FrontPlan(forced, plan.chunk))
        torch.cuda.synchronize()
        assert torch.equal(out[:, :n_cls], want[:, :n_cls])
        check_output(f"fused_frontend {forced} route", out, want)
        assert torch.equal(launch_front(x, w, FrontPlan(forced, plan.chunk)),
                           out)


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
@pytest.mark.parametrize("t", [448, 1024])
def test_fused_block_raises_past_the_attention_shared_memory(dev, t):
    """More rows than the resident attention kernel holds in a block's
    shared memory (432 at head dim 128): the chain's K/V-tiled attention
    takes them, one launch, against the plain version on its routes.  The
    name is the one the test had while the chain raised there."""
    from image2text_torch.ops.fused_block import (MAX_ATTN_ROWS, attn_route,
                                                  fused_block,
                                                  fused_block_plain)

    assert t > MAX_ATTN_ROWS and attn_route(t, 128) == "tiled"
    blk = _dense_block(dev, 256, 2, True)
    w = blk.block_weights(torch.bfloat16)
    x = torch.randn(2, t, 256, device=dev, generator=_gen(dev, 15)
                    ).to(torch.bfloat16)
    before = fused_block.launches
    got, want, rk, gv = _run_pair(fused_block, fused_block_plain, (x, w),
                                  2 * t, w.fc.e)
    assert fused_block.launches == before + 1
    check_routes("fused_block", rk, gv, w.fc.k)
    check_output(f"fused_block t={t}", got, want)


def _ban_cases(dev, rows, vocab):
    """(rows, vocab) f32 logits and (rows, 644) bans: signed zeros, -inf
    inputs, ties at the threshold, a row of equal values (its first digit
    overflows the candidate list), a fully banned head, ids past the
    vocabulary, a repeated id, a row whose top 644 values are banned (the
    k-th key's digit below the sampled guess); random rows after the
    seventh, their bans in the first 132 columns."""
    g = torch.Generator().manual_seed(15)
    x = torch.randn(rows, vocab, generator=g)
    x[0, :8] = torch.tensor([0.0, -0.0] * 4)
    x[0, 8:] = -1.0
    x[1, 3:] = float("-inf")
    x[2, :40] = x[2, 40]                         # ties at the threshold
    x[5] = 0.75                                  # one value: overflow
    ban = torch.full((rows, 644), -1, dtype=torch.int32)
    ban[:, :132] = torch.randint(0, vocab, (rows, 132), generator=g,
                                 dtype=torch.int32)
    ban[torch.rand(rows, 644, generator=g) < 0.3] = -1
    ban[3, :132] = torch.arange(132, dtype=torch.int32)
    ban[4, :2] = torch.tensor([vocab, vocab + 9000], dtype=torch.int32)
    ban[4, 2:6] = int(torch.argmax(x[4]))       # the top id, four times
    ban[6] = torch.argsort(x[6], descending=True)[:644].to(torch.int32)
    return x.to(dev), ban.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, "all"])
@pytest.mark.parametrize("with_bans", [False, True])
@pytest.mark.parametrize("rows,vocab", [(7, 50258), (192, 50258),
                                        (7, 151936)])
def test_topk_ban_mask_kernel_equals_reference_bit_for_bit(dev, k, with_bans,
                                                           rows, vocab):
    """The flagship's vocabulary at 7 engineered rows and at the beam's 192
    decode rows, and Qwen-2's 151,936: signed zeros, -inf inputs, ties at
    the threshold, up to 644 live bans a row (the JAX kernel's cap is
    128), ids past the vocabulary, repeated ids, a row whose first digit
    overflows the candidate list, a row whose bans push the k-th key's
    digit below the sampled guess; k from 1 to the whole row.  At k 1 and 16
    the routes (``tests/torch_radix_select.py``) of the engineered rows are
    pinned: each of the kernel's four is taken."""
    from image2text_torch.ops.topk_mask import (topk_ban_mask,
                                                topk_ban_mask_reference)
    from torch_radix_select import kth_key_radix

    k = vocab if k == "all" else k
    x, ban = _ban_cases(dev, rows, vocab)
    ban = ban if with_bans else None
    before = topk_ban_mask.launches
    got = topk_ban_mask(x, ban, k)
    want = topk_ban_mask_reference(x, ban, k)
    torch.cuda.synchronize()
    assert topk_ban_mask.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if k in (1, 16):   # rows of one value (-1.0, -inf, 0.75) fill their bins
        _, routes = kth_key_radix(x[:7].cpu(), None if ban is None
                                  else ban[:7].cpu(), k)
        assert routes[0] == routes[1] == ("reread" if k == 1 else "overflow")
        assert routes[5] == "overflow"
        assert routes[6] == ("list" if ban is None else "guess_high")


@pytest.mark.cuda
def test_topk_ban_mask_raises_on_what_the_kernel_does_not_take(dev):
    from image2text_torch.ops.topk_mask import topk_ban_mask

    before = topk_ban_mask.launches
    with pytest.raises(ValueError):
        topk_ban_mask(torch.zeros(2, 64, device=dev),
                      torch.zeros(3, 4, dtype=torch.int32, device=dev), 4)
    with pytest.raises(ValueError):
        topk_ban_mask(torch.zeros(2, 64, device=dev), None, 0)
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


# -- the f32 kernels (training_configs/local/synthetic-*.yaml) ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk,sq,skv,d,bias,causal,rate", [
    (2, 4, 1, 264, 264, 16, None, False, 0.1),       # offline encoder
    (2, 4, 1, 128, 128, 16, "soft_prompt", True, 0.1),  # offline decoder
    (2, 2, 2, 70, 100, 128, None, True, 0.0),        # MHA, causal sq < skv
    (1, 4, 1, 112, 64, 64, "per_head", False, 0.1),  # cross: sq > skv
    (2, 2, 1, 40, 33, 32, "full", False, 0.2),       # every bias element
    (1, 2, 2, 300, 1024, 64, "batch_keys", True, 0.1),  # long keys
    # the families' f32 training calls at b 1 (nano-mini at b 2: a
    # multi-query plane whose dK/dV kernel takes G > 1 groups)
    (1, 32, 32, 272, 272, 128, None, True, 0.0),     # Llama-2-7B
    (1, 12, 12, 256, 256, 64, "soft_prompt", True, 0.1),  # nano-lsh
    (1, 12, 12, 272, 272, 64, None, True, 0.0),      # GPT-2
    (2, 8, 1, 92, 92, 128, "soft_prompt", True, 0.1),  # nano-mini
    (1, 2, 1, 100, 100, 256, "soft_prompt", True, 0.1),  # head dim 256
    (1, 2, 2, 200, 128, 64, None, True, 0.1),        # causal sq > skv
])
def test_flash_f32_kernels_match_plain(dev, b, h, hk, sq, skv, d, bias,
                                       causal, rate):
    """The f32 forward and backward against the plain versions at the f32
    limits, the same dropout seed; the backward rerun bitwise equal; each
    wrapper counts one launch a call.  The nano-mini case's dK/dV plan
    takes more than one group (partials summed in group order)."""
    from image2text_torch.utils.device import sm_count
    from image2text_torch.utils.kernel_check import F32_LIMITS

    groups = fa.f32_bwd_plan(b, h, hk, sq, skv, sm_count(dev),
                             fa.kernel_head_dim(d))
    if (b, h, hk, sq, d) == (2, 8, 1, 92, 128):
        assert groups > 1

    g = _gen(dev, 21)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g)
                     for shape in ((b, h, sq, d), (b, hk, skv, d),
                                   (b, hk, skv, d), (b, h, sq, d)))
    bias = _flash_bias(bias, b, h, sq, skv, dev, g)
    seed = 424242
    counts = fa.flash_fwd.launches, fa.flash_bwd.launches
    out, lse = fa.flash_fwd(q, k, v, bias, causal, rate, seed)
    want, want_lse = fa.flash_forward_plain(q, k, v, bias, causal, rate, seed)
    dvec = (dout * want).sum(-1)
    gr = (dout, want_lse, dvec, rate, seed)
    got = fa.flash_bwd(q, k, v, bias, causal, *gr)
    again = fa.flash_bwd(q, k, v, bias, causal, *gr)
    plain = fa.flash_backward_plain(q, k, v, bias, causal, *gr)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (
        counts[0] + 1, counts[1] + 2)
    assert out.dtype == torch.float32 and got[0].dtype == torch.float32
    check_output("flash_fwd f32 out", out, want, F32_LIMITS)
    check_output("flash_fwd f32 lse", lse, want_lse, F32_LIMITS)
    for name, mine, ref, rerun in zip(("dq", "dk", "dv"), got, plain, again):
        check_output(f"flash_bwd f32 {name}", mine, ref, F32_LIMITS)
        assert torch.equal(mine, rerun), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 2, 64, 48, 16),
    (2, 8, 92, 92, 128),   # nano-mini's multi-query shape: G > 1 groups
])
def test_flash_f32_gives_keyless_rows_every_key(dev, b, h, sq, skv, d):
    """Rows that a bias leaves without a key average every key (p = 1 in
    the forward; in the backward p = exp(s - lse) = 1, lse rounding to
    NEG_BIG), as the plain version does; the dK/dV kernel in groups."""
    from image2text_torch.utils.device import sm_count
    from image2text_torch.utils.kernel_check import F32_LIMITS

    assert fa.f32_bwd_plan(b, h, 1, sq, skv, sm_count(dev), d) > 1
    g = _gen(dev, 22)
    q, dout = (torch.randn(b, h, sq, d, device=dev, generator=g)
               for _ in range(2))
    k, v = (torch.randn(b, 1, skv, d, device=dev, generator=g)
            for _ in range(2))
    bias = torch.zeros(1, 1, sq, skv, device=dev)
    bias[..., 40:, :] = float("-inf")
    out, lse = fa.flash_fwd(q, k, v, bias, False)
    want, want_lse = fa.flash_forward_plain(q, k, v, bias, False)
    dvec = (dout * want).sum(-1)
    got = fa.flash_bwd(q, k, v, bias, False, dout, want_lse, dvec)
    plain = fa.flash_backward_plain(q, k, v, bias, False, dout, want_lse,
                                    dvec)
    torch.cuda.synchronize()
    assert torch.allclose(out[0, 0, 50], v[0, 0].mean(0), atol=1e-5)
    check_output("flash_fwd f32 keyless", out, want, F32_LIMITS)
    for name, mine, ref in zip(("dq", "dk", "dv"), got, plain):
        check_output(f"flash_bwd f32 keyless {name}", mine, ref, F32_LIMITS)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,d,n_cls,bias,route", [
    (4, 256, 128, 64, 8, True, "cluster"),   # the offline configs' front
    (8, 256, 128, 64, 8, True, "cluster"),   # at the offline trainer's eval batch
    (3, 16, 40, 24, 2, False, "cluster"),    # ragged tiles, no biases, one block
    (2, 100, 200, 128, 0, True, "cluster"),  # no CLS rows, 7 blocks of 16 rows
    (2, 300, 37, 64, 4, True, "cluster"),    # 5 blocks of 64 rows; din % 4 != 0
    (2, 256, 1024, 256, 8, True, "slab"),    # Wp past a block's shared memory
])
def test_fused_frontend_f32_matches_plain(dev, b, t, din, d, n_cls, bias,
                                          route):
    """The f32 front on the route ``front_plan_f32`` gives the shape, and
    the slab route forced at every shape, the cluster route at each block
    height of 16, 32 or 64 rows whose blocks fit (at most F32_CLUSTER an
    image, their operands in F32_FRONT_SMEM), against its plain version
    and against a float64 evaluation of it at the f32 limits; CLS rows
    copied exactly; reruns bitwise equal."""
    from image2text_torch.ops import fused_frontend as ff
    from image2text_torch.ops.fused_frontend import (FrontendWeights,
                                                     FrontPlanF32,
                                                     front_plan_f32,
                                                     fused_frontend,
                                                     fused_frontend_plain,
                                                     launch_front_f32)
    from image2text_torch.probes import front_f64_truth
    from image2text_torch.utils.kernel_check import F32_LIMITS

    g = _gen(dev, 23)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=g)

    w = FrontendWeights(r(din, d, scale=din ** -0.5),
                        r(d, scale=0.1) if bias else None,
                        1.0 + r(t, d, scale=0.1),
                        r(t, d, scale=0.1) if bias else None,
                        r(t, d), r(n_cls, d))
    x = r(b, t, din)
    assert front_plan_f32(t, din, d).route == route
    before = fused_frontend.launches
    got, again = fused_frontend(x, w), fused_frontend(x, w)
    want = fused_frontend_plain(x, w)
    torch.cuda.synchronize()
    assert fused_frontend.launches == before + 2
    truth = front_f64_truth(ff, x, w)
    check_output("fused_frontend f32", got, want, F32_LIMITS)
    check_output("fused_frontend f32 vs float64", got, truth, F32_LIMITS)
    assert torch.equal(got[:, :n_cls], want[:, :n_cls])
    assert torch.equal(got, again)
    plans = [FrontPlanF32("slab", 0, 0)] + [
        FrontPlanF32("cluster", -(-t // rows), rows) for rows in (16, 32, 64)
        if -(-t // rows) <= ff.F32_CLUSTER
        and ff.front32_smem(rows, din, d) <= ff.F32_FRONT_SMEM]
    for plan in plans:
        out = launch_front_f32(x, w, plan)
        torch.cuda.synchronize()
        check_output(f"fused_frontend f32 {plan}", out, want, F32_LIMITS)
        check_output(f"fused_frontend f32 {plan} vs float64", out, truth,
                     F32_LIMITS)
        assert torch.equal(out[:, :n_cls], want[:, :n_cls])
        assert torch.equal(launch_front_f32(x, w, plan), out)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (256, 1024, 50258),     # the flagship's W8A8 lm_head: outer padded
    (256, 1024, 1024),      # q_proj, out_proj, null_connector
    (256, 1024, 256),       # kv_proj
    (192, 1024, 50258),     # beam search's decode rows
    (1, 1024, 1024),        # one decode row: rows padded to 24
    (17, 70, 50),           # every size padded
])
def test_int8_mm_bit_equal_to_the_cpu(dev, m, k, n):
    """The W8A8 product on the card (``torch._int_mm`` on the padded
    operands) equals the CPU's exact product bit for bit, on int8 operands
    up to ±127 (the extremes included), and counts one launch."""
    from image2text_torch.ops.functions import int8_mm, int8_mm_plain

    g = torch.Generator().manual_seed(m * 7 + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    a[0], b[0] = 127, -127
    before = int8_mm.launches
    got = int8_mm(a.to(dev), b.to(dev))
    assert int8_mm.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), int8_mm_plain(a, b))
    assert int(got[0, 0]) == -127 * 127 * k


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(50258, 1024), (1024, 1024), (50, 70)])
def test_int8_form_pads_its_weight_once(dev, n, k):
    """An int8 form keeps its weight operand padded to ``torch._int_mm``'s
    shapes on the card: a second call reuses it, a write to ``qweight``
    makes it anew.  The tied lm_head and the Linear through it equal
    ``int8_dot_rows`` on the unpadded rows bit for bit, at 256 and 1 rows
    (the flagship's vocabulary of 50,258 pads to 50,264)."""
    from image2text_torch.nn.modules import Embedding, Linear, int8_dot_rows
    from image2text_torch.ops.functions import int8_mm_shapes

    g = _gen(dev, n)
    emb, lin = Embedding(n, k, device=dev), Linear(k, n, bias=False,
                                                   device=dev)
    for mod in (emb, lin):
        with torch.no_grad():
            mod.weight.normal_(generator=g)
        mod.to_int8()
        padded = mod.int8_operand()
        _, kp, np_ = int8_mm_shapes(1, k, n)
        assert tuple(padded.shape) == (np_, kp)
        assert torch.equal(padded[:n, :k], mod.qweight)
        assert mod.int8_operand() is padded
    for rows in (256, 1):
        x = torch.randn(rows, k, generator=g, device=dev).to(torch.bfloat16)
        want = int8_dot_rows(x, emb.qweight, emb.qscale)
        assert torch.equal(emb.lm_head(x), want)
        assert torch.equal(lin(x), int8_dot_rows(x, lin.qweight, lin.qscale)
                           .to(x.dtype))
    with torch.no_grad():
        emb.qweight[0] = -emb.qweight[0]
    assert emb.int8_operand() is not padded
    assert torch.equal(emb.int8_operand()[0, :k], emb.qweight[0])


@pytest.mark.cuda
def test_serving_modes_on_the_card_keep_the_kernels(dev):
    """The tiny flagship in bf16 on the card: int8 cross-KV, W8A8 (at a
    min_elems that leaves the MoE gates in float, as the flagship's
    default does: at these widths that is the tied table alone, so the
    W8A8 products are its lm_head's) with int8 cross-KV, and approx top-k
    each launch the
    same sparse_block and moe_ffn counts as the exact mode; the W8A8
    products run on the card; the logits of a cached 8-token step against
    the mode's cross memory stay finite and near the exact mode's (equal
    for approx top-k, which the port takes as exact)."""
    import copy

    from image2text_torch.models.generation import (decoder_step,
                                                    precompute_cross_kv,
                                                    quantize_cross_kv)
    from image2text_torch.models.quantization import int8_serving_params
    from image2text_torch.ops.functions import int8_mm

    model = VisionEncoderDecoder(flagship_config(tiny=True), device=dev)
    model.init_weights(0).to(torch.bfloat16).eval()
    w8a8 = copy.deepcopy(model)
    int8_serving_params(w8a8.decoder, min_elems=10000)
    assert w8a8.decoder.transformer.wte.is_int8
    assert all(blk.mlp.plain_weights for blk in w8a8.decoder.blocks)
    img = torch.randn(4, 3, 64, 64, generator=_gen(dev), device=dev,
                      dtype=torch.bfloat16)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)
    chunk = torch.randint(0, 512, (4, 8), generator=_gen(dev, 2), device=dev)
    counts, first = {}, {}
    for mode, m, kw in (("exact", model, {}),
                        ("int8_kv", model, dict(cross_kv_quant="int8")),
                        ("w8a8", w8a8, dict(cross_kv_quant="int8")),
                        ("approx", model, dict(approx_top_k=True))):
        sparse_block.launches = moe_ffn.launches = 0
        products = int8_mm.launches
        with torch.no_grad():
            ids = m.generate(img, prompt, max_new_tokens=8, temperature=0.7,
                             top_k=16, generator=_gen(dev, 1), **kw)
            enc = m.encoder(img)
            kv = quantize_cross_kv(precompute_cross_kv(m, enc),
                                   kw.get("cross_kv_quant"))
            cache = m.decoder.init_cache(4, 8, enc.dtype, dev)
            first[mode] = decoder_step(m, chunk, cache, m.space_for_prompt,
                                       enc, kv)[0].float()
        counts[mode] = (sparse_block.launches, moe_ffn.launches)
        assert ids.shape == (4, 9) and bool((ids[:, 0] == 1).all())
        assert (int8_mm.launches > products) == (mode == "w8a8")
        assert bool(torch.isfinite(first[mode]).all())
    assert len(set(counts.values())) == 1 and counts["exact"][1] > 0
    assert torch.equal(first["approx"], first["exact"])
    for mode in ("int8_kv", "w8a8"):
        rel = (torch.linalg.vector_norm(first[mode] - first["exact"])
               / torch.linalg.vector_norm(first["exact"]))
        assert 0 < float(rel) < 0.1, (mode, float(rel))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((256, 1024), torch.bfloat16),    # the flagship's W8A8 decode activations
    ((192, 1024), torch.bfloat16),    # beam search's decode rows
    ((64, 8, 64, 128), torch.bfloat16),   # cross K/V (b, h, s, hd)
    ((1000, 70), torch.float32),
])
def test_quantize_rows_int8_bit_equal_to_the_cpu(dev, shape, dtype):
    """``quantize_rows_int8`` on the card gives the CPU's scales and int8
    values bit for bit: the scale max|t| / 127 is a true division there
    too (``nn/modules.py::divide``), not a product with the f32
    reciprocal of 127, which lands up to one ulp away."""
    from image2text_torch.nn.modules import divide, quantize_rows_int8

    g = torch.Generator().manual_seed(sum(shape))
    t = (torch.randn(shape, generator=g) * 3).to(dtype)
    q, s = quantize_rows_int8(t.to(dev))
    cq, cs = quantize_rows_int8(t)
    assert torch.equal(s.cpu().view(torch.int32), cs.view(torch.int32))
    assert torch.equal(q.cpu(), cq)
    x = torch.rand(1 << 16, generator=g) * 1000
    assert torch.equal(divide(x.to(dev), 127.0).cpu().view(torch.int32),
                       (x / 127.0).view(torch.int32))


def _nano_tiny(name, dev, monkeypatch):
    """A tiny form of a pretrained-ViT configuration, from its YAML: the
    ViT-B/16 at depth 2 on 32² images (width 768), narrow heads and
    decoders; random bf16 weights."""
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models import encoder as tenc

    path = {"nano-mini": "training_configs/local/nano-mini.yaml",
            "nano": "training_configs/tpu/nano.yaml",
            "nano-lsh": "training_configs/local/nano.yaml"}[name]
    cfg = load_training_config(path).model
    enc, dec = cfg.vision_encoder_config, cfg.decoder_config
    enc.n_cls, enc.n_embd_out_vit = 4, 64
    if enc.peer_config is not None:
        pc = enc.peer_config
        pc.num_units_sqrt, pc.topk, pc.nhead, pc.query_dim = 16, 4, 2, 16
    dec.n_layer, dec.block_size = 2, 64
    dec.transformer_config.attn_config.n_embd = 64
    dec.transformer_config.attn_config.n_head = 4
    if dec.transformer_config.is_sparse_attn:
        dec.transformer_config.max_block_size = 80
    monkeypatch.setattr(tenc, "VIT_B16_ARGS",
                        dict(image_size=32, num_layers=2))
    return VisionEncoderDecoder(cfg, device=dev)


def lsh_bins(model, images):
    """{(cls, resolution): bins (b, 1, n_proj)} of an LSH model's fixed
    heads on ``images``, and the projections z whose bins they are."""
    enc = model.vision_encoder
    x = enc.model(images)
    out = {}
    for i, comp in enumerate(enc.lsh_emb):
        for j, mod in enumerate(comp.emb):
            out[i, j] = mod.bins(x[:, None, :]), mod
    return x, out


def lsh_bin_margin(x_card, x_cpu, card, cpu):
    """(bins that differ, the largest distance of their projections from a
    grid point on the CPU): a differing bin is a projection lying on a
    boundary, where the card's and the CPU's f32 sums round apart."""
    from image2text_torch.models.layers import _unit_rows

    n, margin = 0, 0.0
    for key, (b_card, _) in card.items():
        b_cpu, mod = cpu[key]
        diff = b_card.cpu() != b_cpu
        if bool(diff.any()):
            z = torch.matmul(_unit_rows(x_cpu[:, None, :]), mod.projection_mat)
            dist = (z[..., None] - mod.grid).abs().amin(-1)
            n += int(diff.sum())
            margin = max(margin, float(dist[diff].max()))
    return n, margin


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nano-mini", "nano", "nano-lsh"])
def test_nano_family_card_equals_cpu(dev, name, monkeypatch):
    """The tiny nano forms on the card against a CPU copy: encoder output
    and a cached prefill's logits (PEER's tie-exact top-k, LSH's
    ``searchsorted``, the positional MLP's ``forward_at``), then greedy
    ids.  f32 (TF32 off, in the GEMMs and in cuDNN's patch convolution)
    for PEER and LSH: relative L2 within 1e-4 and the
    ids equal, unless an LSH projection lies within 1e-5 of a bin boundary
    (then its bin may differ, and only that is asserted).  nano-mini in
    bf16 (``moe_ffn`` takes bf16 only, as JAX's kernel gate on the TPU):
    within 0.03, and its decoder launches ``moe_ffn`` once per cached
    forward of a block that runs its body."""
    import copy

    from image2text_torch.models.generation import prefill

    m = _nano_tiny(name, dev, monkeypatch)
    gpt2 = {} if m.decoder.config.pretrained_model is not None else None
    m.init_weights(0, gpt2_state_dict=gpt2).eval()   # {}: random GPT-2
    dtype = torch.bfloat16 if name == "nano-mini" else torch.float32
    m.to(dtype)
    cpu = copy.deepcopy(m).cpu()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    img = torch.randn(4, 3, 32, 32, generator=_gen(dev), device=dev,
                      dtype=dtype)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)
    with torch.no_grad():
        enc, cenc = m.encoder(img), cpu.encoder(img.cpu())
        got = prefill(m, enc, prompt, 4)[0][:, -1].cpu()
        want = prefill(cpu, cenc, prompt.cpu(), 4)[0][:, -1]
        moe_ffn.launches = 0
        ids = m.generate(img, prompt, max_new_tokens=6, temperature=0.0)
        launched = moe_ffn.launches
        cids = cpu.generate(img.cpu(), prompt.cpu(), max_new_tokens=6,
                            temperature=0.0)
        flips = 0
        if name == "nano-lsh":
            x, card = lsh_bins(m, img)
            cx, cbins = lsh_bins(cpu, img.cpu())
            flips, margin = lsh_bin_margin(x, cx, card, cbins)
            assert margin < 1e-5, (flips, margin)
    rel = float(torch.linalg.vector_norm(got.float() - want.float())
                / torch.linalg.vector_norm(want.float()))
    off = m.space_for_prompt
    if name == "nano-mini":
        assert rel < 0.03 and bool(torch.isfinite(got).all())
        assert launched == sum(m.decoder.ffn_evaluations(off + i, 1)
                               for i in range(7)) > 0
    elif not flips:
        assert rel < 1e-4
        assert torch.equal(ids.cpu(), cids)
        assert launched == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 17, 256, 1280, 4097])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("slices", [None, 1])
def test_moe_ffn_f32_form_matches_plain(dev, rows, prologue, slices):
    """The f32 form (f32 operands: the configurations at precision 'no')
    at nano-mini's FFN widths (1024 → 2048 → 1024), ragged rows and the
    paths' rows (256: a nano-mini f32 caption call's every launch; 1280:
    the f32 sparse encoder block's b 8 x 160 selected rows), with and
    without the LN2 prologue and residual, at the planned slices and
    unsplit; held at the f32 limits on the kernel's own routes, against
    the plain version and against a float64 evaluation of it (3xTF32
    products must keep f32's accuracy over the 1024- and 2048-deep sums),
    reruns bitwise equal, one counted launch a call."""
    from image2text_torch.ops import fused_moe
    from image2text_torch.ops.fused_moe import launch_moe_ffn
    from image2text_torch.probes import moe_f64_truth
    from image2text_torch.utils.kernel_check import F32_LIMITS

    blk = _block(dev, 1024, 8, 32, True)
    fc = blk.mlp.c_fc.packed(torch.float32)
    proj = blk.mlp.c_proj.packed(torch.float32)
    x = torch.randn(rows, 1024, device=dev, generator=_gen(dev, 6))
    extra = (dict(ln_w=blk.ln_2.weight.float(), ln_b=blk.ln_2.bias.float(),
                  residual=x) if prologue else {})
    routes = torch.zeros(rows, 2, dtype=torch.uint8, device=dev)
    gates = torch.zeros(rows, 2, fc.e, dtype=torch.float32, device=dev)
    if slices is None:
        before = moe_ffn.launches
        got = moe_ffn(x, fc, proj, routes=routes, **extra)
        again = moe_ffn(x, fc, proj, **extra)
        assert moe_ffn.launches == before + 2
    else:
        got, again = torch.empty_like(x), torch.empty_like(x)
        for out, r in ((got, routes), (again, None)):
            launch_moe_ffn(x, fc, proj, out, routes=r, slices=slices, **extra)
    want = moe_ffn_plain(x, fc, proj, force_routes=routes, gates=gates,
                         **extra)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    check_routes("moe_ffn f32", routes, gates, fc.k)
    check_output(f"moe_ffn f32 rows={rows}", got, want, F32_LIMITS)
    truth = moe_f64_truth(fused_moe, x, fc, proj, routes, **extra)
    check_output(f"moe_ffn f32 rows={rows} vs float64", got, truth,
                 F32_LIMITS)
    assert torch.equal(got, again)


def _moe_linear(dev, g, fin, fout, gate, e, r, k, dtype=torch.float32):
    from image2text_torch.ops.fused_moe import pack_moe_linear

    def w(*shape, fan):
        return torch.randn(*shape, device=dev, generator=g) * fan ** -0.5

    return pack_moe_linear(w(e, r, fin, fan=fin), w(e, r, fan=4),
                           w(e, fout, r, fan=r), w(e, fout, fan=4),
                           w(gate, fin, fan=fin), w(gate, fan=4),
                           w(e, gate, fan=gate), w(e, fan=4), k, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fin,hidden,gate,e,r,k", [
    (70, 150, 20, 3, 5, 2),      # no width a multiple of 4: 4-byte copies
    (96, 200, 4, 2, 6, 1),       # g + e·r = 16: the narrowest accumulators
    (1024, 2048, 64, 8, 8, 3),   # g + e·r = 128, e = 8: the widest
])
@pytest.mark.parametrize("rows", [33, 300])
def test_moe_ffn_f32_form_at_other_widths(dev, fin, hidden, gate, e, r, k,
                                          rows):
    """The f32 form takes any fin and hidden, g + e·r up to 128 and e up to
    8 (its accumulators' width a template parameter, ragged chunks
    zero-filled): held to the plain version and its float64 evaluation at
    the f32 limits with the LN2 prologue, split and unsplit."""
    from image2text_torch.ops import fused_moe
    from image2text_torch.ops.fused_moe import launch_moe_ffn
    from image2text_torch.probes import moe_f64_truth
    from image2text_torch.utils.kernel_check import F32_LIMITS

    g = _gen(dev, 31)
    fc = _moe_linear(dev, g, fin, hidden, gate, e, r, k)
    proj = _moe_linear(dev, g, hidden, fin, gate, e, r, k)
    x = torch.randn(rows, fin, device=dev, generator=g)
    extra = dict(ln_w=1 + 0.1 * torch.randn(fin, device=dev, generator=g),
                 ln_b=0.1 * torch.randn(fin, device=dev, generator=g))
    for slices in (None, 1):
        routes = torch.zeros(rows, 2, dtype=torch.uint8, device=dev)
        gates = torch.zeros(rows, 2, e, dtype=torch.float32, device=dev)
        got = torch.empty_like(x)
        launch_moe_ffn(x, fc, proj, got, routes=routes, slices=slices,
                       **extra)
        want = fused_moe.moe_ffn_plain(x, fc, proj, force_routes=routes,
                                       gates=gates, **extra)
        torch.cuda.synchronize()
        check_routes("moe_ffn f32", routes, gates, k)
        check_output(f"moe_ffn f32 {fin} {hidden} slices={slices}", got,
                     want, F32_LIMITS)
        check_output("moe_ffn f32 vs float64", got, moe_f64_truth(
            fused_moe, x, fc, proj, routes, **extra), F32_LIMITS)


@pytest.mark.cuda
def test_moe_ffn_raises_on_dtypes_neither_form_takes(dev):
    blk = _block(dev, 256, 2, 32, True)
    fc32 = blk.mlp.c_fc.packed(torch.float32)
    proj32 = blk.mlp.c_proj.packed(torch.float32)
    x = torch.randn(4, 256, device=dev)
    before = moe_ffn.launches
    for args in ((x.half(), blk.mlp.c_fc.packed(torch.float16),
                  blk.mlp.c_proj.packed(torch.float16)),
                 (x, blk.mlp.c_fc.packed(torch.bfloat16), proj32),
                 (x.to(torch.bfloat16), fc32, proj32)):
        with pytest.raises(ValueError):
            moe_ffn(*args)
    assert moe_ffn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_f,out_f", [
    (256, 4544, 4672), (300, 4544, 4544), (256, 18176, 4544),
    (1040, 4544, 18176), (256, 1600, 4800), (1040, 6400, 1600),
    (272, 5120, 13824)])
def test_int4_matmul_at_the_hf_decoders_widths(dev, rows, in_f, out_f):
    """Falcon-7B's widths (in 4,544: 71 strip pairs, an odd count, so the
    last pipeline stage is half empty; out 4,672 and 18,176), GPT-2-xl's
    (in 1,600: 25 pairs) and Llama-2-13B's MLP, at decode and prefill-like
    rows: within the limits of the plain version, reruns bitwise equal."""
    from image2text_torch.ops.int4_matmul import (int4_matmul,
                                                  int4_matmul_plain,
                                                  quantize_pack_int4)

    g = _gen(dev, rows + in_f + out_f)
    w = torch.randn(out_f, in_f, device=dev, generator=g) * 0.02
    packed, scales = quantize_pack_int4(w)
    scales = scales.to(torch.bfloat16)
    x = torch.randn(rows, in_f, device=dev, generator=g).to(torch.bfloat16)
    got = int4_matmul(x, packed, scales)
    want = int4_matmul_plain(x, packed, scales)
    again = int4_matmul(x, packed, scales)
    torch.cuda.synchronize()
    check_output(f"int4_matmul {rows} x {in_f} -> {out_f}", got, want)
    assert torch.equal(got, again)


def _hf_tiny(name, dev, monkeypatch, int4=None):
    """A tiny form of an HF-family configuration from its YAML: a 2-layer
    decoder of width 64 (Qwen: 96, 6 query heads on 2 KV heads), the
    pretrained ViT at depth 2 on 32² images or the scratch encoder at
    depth 2 and width 64; uninitialised."""
    import dataclasses

    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models import encoder as tenc
    from image2text_torch.models.hf_decoders import factory

    path = {"llama": "training_configs/local/llama2-7b.yaml",
            "llama13b": "training_configs/tpu/llama2-13b.yaml",
            "qwen": "training_configs/local/qwen-1.5b-deepseek-distill.yaml",
            "falcon": "training_configs/tpu/falcon-7b.yaml"}[name]
    cfg = load_training_config(path).model
    enc, dec = cfg.vision_encoder_config, cfg.decoder_config
    if int4 is not None:
        dec.load_in_4bit = int4
    width = 96 if name == "qwen" else 64
    for table in (factory.LLAMA_TABLE, factory.QWEN_TABLE,
                  factory.FALCON_TABLE):
        if dec.model_str in table:
            kw = dict(n_layer=2, n_embd=width, n_head=4)
            if name == "qwen":
                kw.update(n_head=6, n_kv_head=2, intermediate=128)
            elif table is not factory.FALCON_TABLE:
                kw.update(n_kv_head=4, intermediate=128)
            monkeypatch.setitem(table, dec.model_str, dataclasses.replace(
                table[dec.model_str], **kw))
    if hasattr(enc, "n_embd_out_vit"):
        enc.n_cls, enc.gate_sizes, enc.n_embd_out_vit = 4, (32,), 64
        monkeypatch.setattr(tenc, "VIT_B16_ARGS",
                            dict(image_size=32, num_layers=2))
    else:
        enc.n_layer = 2
        enc.transformer_config.attn_config.n_embd = 64
        enc.transformer_config.attn_config.n_head = 4
    return VisionEncoderDecoder(cfg, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama", "qwen", "falcon"])
def test_tiny_hf_families_card_equals_cpu(dev, name, monkeypatch):
    """The decoders of Llama (multi-head), Qwen (grouped: 6 query heads on
    2 KV heads) and Falcon (multi-query, parallel attention; its Linears
    in float) in f32 on the card against a CPU copy, TF32 off, both on the
    CPU copy's encoder output (Falcon's scratch encoder has sparse blocks,
    whose kernel takes bf16): a cached prefill's logits within 1e-4
    relative L2, greedy ids equal over 16 steps."""
    import copy

    from image2text_torch.models.generation import prefill

    m = _hf_tiny(name, dev, monkeypatch, int4=False).init_weights(0).eval()
    cpu = copy.deepcopy(m).cpu()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    size = 32 if name != "falcon" else 128
    img = torch.randn(4, 3, size, size, generator=_gen(dev), device=dev).cpu()
    prompt = torch.ones(4, 1, dtype=torch.long)
    with torch.no_grad():
        cenc = cpu.encoder(img)
        enc = cenc.to(dev)
        got = prefill(m, enc, prompt.to(dev), 4)[0][:, -1].cpu()
        want = prefill(cpu, cenc, prompt, 4)[0][:, -1]
        ids = m.generate(img, prompt, max_new_tokens=16, temperature=0.0,
                         encoder_output=enc)
        cids = cpu.generate(img, prompt, max_new_tokens=16, temperature=0.0,
                            encoder_output=cenc)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel < 1e-4
    assert torch.equal(ids.cpu(), cids)


@pytest.mark.cuda
def test_tiny_int4_llama_and_falcon_captions_launch_int4(dev, monkeypatch):
    """The tiny int4 + LoRA Llama-2-13B and Falcon-7B forms in bf16: one
    int4_matmul launch per quantized Linear per decoder forward, the
    Falcon form's scratch encoder one fused_frontend and a sparse_block
    per block; first-step logits against the plain-version path."""
    from image2text_torch.models.generation import prefill
    from image2text_torch.models.quantization import (QuantizedLinear,
                                                      fill_random_int4)
    from image2text_torch.ops import int4_matmul as i4
    from image2text_torch.ops.fused_frontend import fused_frontend

    for name, size in (("llama13b", 32), ("falcon", 128)):
        m = _hf_tiny(name, dev, monkeypatch).init_weights(0)
        fill_random_int4(m, _gen(dev, 7))
        m = m.to(torch.bfloat16).eval()
        img = torch.randn(2, 3, size, size, generator=_gen(dev), device=dev
                          ).to(torch.bfloat16)
        prompt = torch.ones(2, 1, dtype=torch.long, device=dev)
        n_q = sum(isinstance(x, QuantizedLinear) for x in m.decoder.modules())
        before = i4.int4_matmul.launches, fused_frontend.launches
        with torch.no_grad():
            m.generate(img, prompt, max_new_tokens=6, temperature=0.0)
            got = prefill(m, m.encoder(img), prompt, 4)[0][:, -1]
        torch.cuda.synchronize()
        assert i4.int4_matmul.launches - before[0] == (7 + 1) * n_q > 0
        assert fused_frontend.launches - before[1] == (2 if name == "falcon"
                                                       else 0)
        kernel = i4.int4_matmul
        monkeypatch.setattr(i4, "int4_matmul", i4.int4_matmul_plain)
        with torch.no_grad():
            want = prefill(m, m.encoder(img), prompt, 4)[0][:, -1]
        monkeypatch.setattr(i4, "int4_matmul", kernel)
        rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(
            want)
        assert float(rel) <= TOL


@pytest.mark.cuda
def test_tiny_nano_mini_f32_card_equals_cpu(dev, monkeypatch):
    """nano-mini at its own precision 'no' (f32): its decoder's MoE FFNs
    launch moe_ffn's f32 form on the card, once per cached forward of a
    block that runs its body; a cached prefill's logits within 1e-4 of a
    CPU copy's, greedy ids equal."""
    import copy

    from image2text_torch.models.generation import prefill

    m = _nano_tiny("nano-mini", dev, monkeypatch).init_weights(0).eval()
    cpu = copy.deepcopy(m).cpu()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    img = torch.randn(4, 3, 32, 32, generator=_gen(dev), device=dev)
    prompt = torch.ones(4, 1, dtype=torch.long, device=dev)
    with torch.no_grad():
        got = prefill(m, m.encoder(img), prompt, 4)[0][:, -1].cpu()
        want = prefill(cpu, cpu.encoder(img.cpu()), prompt.cpu(), 4)[0][:, -1]
        moe_ffn.launches = 0
        ids = m.generate(img, prompt, max_new_tokens=6, temperature=0.0)
        launched = moe_ffn.launches
        cids = cpu.generate(img.cpu(), prompt.cpu(), max_new_tokens=6,
                            temperature=0.0)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    off = m.space_for_prompt
    assert rel < 1e-4
    assert torch.equal(ids.cpu(), cids)
    assert launched == sum(m.decoder.ffn_evaluations(off + i, 1)
                           for i in range(7)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_grouped_kv_training_attention_on_the_card(dev, rate):
    """Qwen-2's grouped K/V (12 query heads on 2 K/V heads, 272 keys, the
    soft-prompt bias) in a training ``sdpa``: repeated to full heads into
    the flash kernels on the card; forward and the q, k, v gradients
    against the same call on CPU copies (the plain versions, the same
    dropout mask), at the kernels' limits."""
    from image2text_torch.nn.core import Ctx
    from image2text_torch.ops.attention import sdpa

    g = _gen(dev, 21)
    b, h, hk, s, d = 2, 12, 2, 272, 128
    q, dout = (torch.randn(b, h, s, d, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hk, s, d, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    bias = _soft_prompt_bias(s, 16, dev)
    outs = []
    for device in (dev, torch.device("cpu")):
        tq, tk, tv = (t.to(device).detach().requires_grad_()
                      for t in (q, k, v))
        before = fa.flash_fwd.launches
        out = sdpa(tq, tk, tv, bias.to(device), causal=True,
                   dropout_rate=rate, ctx=Ctx(5, True), use_flash=True)
        out.backward(dout.to(device))
        launched = fa.flash_fwd.launches - before
        assert launched == (1 if device.type == "cuda" else 0)
        assert tk.grad.shape == (b, hk, s, d)
        outs.append([t.float().cpu() for t in (out, tq.grad, tk.grad,
                                               tv.grad)])
    for name, mine, ref in zip(("out", "dq", "dk", "dv"), *outs):
        check_output(f"grouped sdpa {name}", mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["dots", "nothing", "everything"])
def test_remat_policies_give_the_gradients_of_full_on_the_card(dev, policy):
    """The tiny flagship's training forward and backward on the card (bf16
    compute, dropout 0.1, both stacks checkpointing) under each remat
    policy: the loss and every gradient bitwise equal to ``full``'s, the
    flash kernels launched as often (their launches are recomputed under
    every policy)."""
    from torch.func import functional_call

    from image2text_torch.configs.trainer import flagship_training_config
    from image2text_torch.training.loop import cast_for_compute
    from image2text_torch.training.remat import set_remat_policy
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    cfg = flagship_training_config(tiny=True)
    for sub in (cfg.model.vision_encoder_config, cfg.model.decoder_config):
        sub.enable_gradient_checkpointing = True
    tok = TokenizerInfo(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                        vocab_size=cfg.model.decoder_config.vocab_size)
    tw = ModelTrainerWrapper(cfg.model, tok, cfg.trainer,
                             device=dev).init_weights(0)
    g = _gen(dev, 22)
    images = torch.randn(2, 3, 64, 64, device=dev, generator=g)
    labels = torch.randint(3, 500, (2, 24), device=dev, generator=g)
    runs = []
    for name in ("full", policy):
        set_remat_policy(tw.model, name)
        for p in tw.parameters():
            p.grad = None
        before = fa.flash_fwd.launches
        loss, _ = functional_call(
            tw, cast_for_compute(tw, torch.bfloat16),
            (images.to(torch.bfloat16), labels),
            dict(seed=77, backward=True))
        runs.append((loss, {n: p.grad.clone() for n, p in
                            tw.named_parameters() if p.grad is not None},
                     fa.flash_fwd.launches - before))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert torch.equal(l0, l1) and n0 == n1 > 0
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,sq,skv,causal", [
    (80, 160, 160, False),     # padded to 128: the resident pair (bf16)
    (48, 40, 300, True),       # padded to 64, tiled keys
    (192, 136, 136, True),     # padded to 256: the tiled pair
    (256, 160, 160, False),    # 256 itself
])
def test_flash_kernels_pad_head_dims(dev, dtype, d, sq, skv, causal):
    """Head dims the kernels do not take pad with zero lanes to the next
    they do (scaled by the true head dim), 256 included: forward and
    backward against the plain versions with dropout, in bf16 and f32."""
    from image2text_torch.utils.kernel_check import F32_LIMITS

    g = _gen(dev, 31)
    b, h = 2, 4
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=g).to(dtype)
                     for shape in ((b, h, sq, d), (b, 1, skv, d),
                                   (b, 1, skv, d), (b, h, sq, d)))
    rate, seed = 0.1, 77
    out, lse = fa.flash_fwd(q, k, v, None, causal, rate, seed)
    want, want_lse = fa.flash_forward_plain(q, k, v, None, causal, rate, seed)
    gr = (dout, want_lse, (dout.float() * want.float()).sum(-1), rate, seed)
    got = fa.flash_bwd(q, k, v, None, causal, *gr)
    plain = fa.flash_backward_plain(q, k, v, None, causal, *gr)
    torch.cuda.synchronize()
    limits = F32_LIMITS if dtype == torch.float32 else None
    assert out.shape == q.shape and got[1].shape == k.shape
    for name, mine, ref in (("out", out, want), ("lse", lse, want_lse),
                            *zip(("dq", "dk", "dv"), got, plain)):
        if limits is None:
            check_output(f"flash d={d} {name}", mine, ref)
        else:
            check_output(f"flash f32 d={d} {name}", mine, ref, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("skv", [160, 300])
def test_flash_kernels_with_planes_equal_the_whole_calls_slice(dev, dtype,
                                                              skv):
    """Rows 2–3 of 4 and heads 2–3 of 4 with their planes (``planes_of``):
    the forward's output and lse and the backward's dQ are bit for bit the
    whole call's slice (both routes), dK and dV match the plain version
    with the same planes."""
    from image2text_torch.utils.kernel_check import F32_LIMITS

    g = _gen(dev, 33)
    B, H, s, d, rate, seed = 4, 4, 136, 64, 0.1, 5150
    q, dout = (torch.randn(B, H, s, d, device=dev, generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(B, 1, skv, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    out_w, lse_w = fa.flash_fwd(q, k, v, None, True, rate, seed)
    dvec = (dout.float() * out_w.float()).sum(-1)
    dq_w = fa.flash_bwd(q, k, v, None, True, dout, lse_w, dvec, rate, seed)[0]
    mine = (slice(2, 4), slice(2, 4))
    planes = fa.planes_of(2, 2, rows=(2, B), heads=(2, H))
    ql, doutl = q[mine].contiguous(), dout[mine].contiguous()
    kl, vl = k[2:].contiguous(), v[2:].contiguous()
    out, lse = fa.flash_fwd(ql, kl, vl, None, True, rate, seed, planes)
    gr = (doutl, lse, dvec[mine].contiguous(), rate, seed)
    got = fa.flash_bwd(ql, kl, vl, None, True, *gr, planes=planes)
    plain = fa.flash_backward_plain(ql, kl, vl, None, True, *gr,
                                    planes=planes)
    torch.cuda.synchronize()
    assert torch.equal(out, out_w[mine]) and torch.equal(lse, lse_w[mine])
    assert torch.equal(got[0], dq_w[mine])
    limits = F32_LIMITS if dtype == torch.float32 else None
    for name, mine_, ref in zip(("dk", "dv"), got[1:], plain[1:]):
        if limits is None:
            check_output(f"flash planes {name}", mine_, ref)
        else:
            check_output(f"flash planes f32 {name}", mine_, ref, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("t,hd", [(160, 128), (432, 64), (448, 128),
                                  (1000, 64), (40, 256), (320, 256)])
def test_mqa_attention_tiled_route_matches_plain(dev, t, hd):
    """The chain's K/V-tiled attention (past 432 rows, and at head dim 256)
    against ops.attention.sdpa; where the resident kernel also runs, the
    two routes bit for bit (the same keys in the same order)."""
    import ctypes
    import math

    from image2text_torch.ops import _build
    from image2text_torch.ops.attention import sdpa
    from image2text_torch.ops.fused_block import (_attn_blocks, _fn,
                                                  attn_route)
    from image2text_torch.utils.device import sm_count

    b, h = 2, 1024 // hd if hd == 256 else 8
    qkv, q, k, v = _mqa_case(dev, b, t, h, hd, 1.0, 9)
    lib = _build.load("fused_block")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launch(tiled):
        o = torch.empty(b * t, h * hd, dtype=qkv.dtype, device=dev)
        err = _fn(lib, "mqa_attention_launch")(
            _build.ptr(qkv), _build.ptr(o), ctypes.c_int(b), ctypes.c_int(t),
            ctypes.c_int(h), ctypes.c_int(hd),
            ctypes.c_float(1.0 / math.sqrt(hd)),
            ctypes.c_int(_attn_blocks(b, h, t, sm_count(dev))),
            ctypes.c_int(tiled), stream)
        _build.check(err, "mqa_attention_launch")
        return o

    got = launch(1)
    want = sdpa(q, k, v).transpose(1, 2).reshape(b * t, h * hd)
    torch.cuda.synchronize()
    check_output(f"mqa tiled t={t} hd={hd}", got, want)
    if attn_route(t, hd) == "resident":
        assert torch.equal(got, launch(0))


@pytest.mark.cuda
def test_f32_block_takes_the_composed_forward_on_the_card(dev):
    """An f32 sparse eval block on the card: JAX's gate on hardware
    declines f32, so no chain kernel runs and the FFN is ``moe_ffn``'s f32
    form (one launch); the output matches a CPU copy (the chain's plain
    version) at the f32 limits.  bf16 still launches ``sparse_block``."""
    import copy

    from image2text_torch.utils.kernel_check import F32_LIMITS

    blk = _block(dev, 256, 2, 64, True).float().eval()
    x = torch.randn(3, 64, 256, device=dev, generator=_gen(dev, 35))
    counts = sparse_block.launches, moe_ffn.launches
    with torch.no_grad():
        got, layout = blk(x, want_lazy=True)
        want, _ = copy.deepcopy(blk).cpu()(x.cpu(), want_lazy=True)
    assert (sparse_block.launches, moe_ffn.launches) == (counts[0],
                                                         counts[1] + 1)
    check_output("f32 block", got.cpu(), want, F32_LIMITS)
    with torch.no_grad():
        blk.to(torch.bfloat16)(x.to(torch.bfloat16), want_lazy=True)
    assert sparse_block.launches == counts[0] + 1


@pytest.mark.cuda
def test_mesh_trainer_at_one_rank_equals_the_trainer(dev, tmp_path):
    """The tiny flagship's bf16 step through an NCCL mesh of one rank
    (``parallel/mesh.py``, the mesh Trainer: gradients and metrics through
    the all-reduces) is bit for bit the one-device Trainer's."""
    import torch.distributed as dist

    from image2text_torch.parallel import checks
    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.training.loop import Trainer

    cfg = checks.tiny_config()
    cfg.precision = "bf16"
    cfg.mesh = checks.MeshConfig()
    data = checks.batches(2)
    w = checks.build(cfg, device="cuda")
    tr = Trainer(cfg, w)
    want = [{k: float(v) for k, v in tr.train_step(*b).items()} for b in data]
    params = {k: p.detach().clone() for k, p in w.named_parameters()}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/r",
                            rank=0, world_size=1)
    try:
        w2 = checks.build(cfg, device="cuda")
        tr2 = Trainer(cfg, w2, mesh=make_mesh(cfg.mesh, "cuda"))
        assert tr2.mesh.distributed
        got = [{k: float(v) for k, v in tr2.train_step(*b).items()}
               for b in data]
    finally:
        dist.destroy_process_group()
    assert got == want
    for k, p in w2.named_parameters():
        assert torch.equal(p, params[k]), k
