"""Times of the serving and flash kernels of one checkout, for comparing
two trees in one process each, on one card, in turns.

    python -m image2text_torch.probes.kernel_times \
        [--flash-only | --flash-f32-only | --int4-only |
         --front-topk-only | --steps-only | --moe-front-f32-only] TREE...

For each TREE (the root of a checkout: this repository, or an unpacked
``git archive`` of another commit) a fresh process imports that tree's
``chip_smoke.py`` and runs its serving-kernel phases at the flagship's
shapes (``phase_kernels``: fused_frontend, sparse_block, moe_ffn at
decode and encoder rows) and the dense twin's (``phase_dense_kernel``:
fused_block), then its flash phase (``phase_flash_kernels``) at the
flagship's and GPT-2-medium's training shapes (``FLASH_FLAGSHIP``,
``FLASH_GPT2M``), the families' largest bf16 training calls
(``FLASH_FAMILIES``) and the long-key call (``FLASH_LONG``), each
kernel checked against its plain version as
``chip_smoke.py`` checks it; ``--flash-only`` runs the flash phase alone,
``--int4-only`` the int4 dequant-matmul's phase alone
(``phase_int4_kernels``: the GPT-2-medium decoder's four quantized
Linears at 256 decode rows and 1,344 training rows, beside the bf16
``torch.matmul`` yardstick; ``int4_matmul.<decode|train>_<linear>.ms`` and
``.library_ms``), ``--front-topk-only`` the encoder front and the ban mask
with the kernels that share the front's GEMM (``gemm.cuh``): the
flagship's ``phase_kernels`` and ``phase_dense_kernel``, a depth-1
GPT-2-medium's ``phase_kernels`` (its front and sparse block, under
``gpt2m``), and ``phase_topk_kernel`` at (256, 50258) and (192, 50258),
k 16, with the bans of a random id buffer; beside ``ms`` the front's and
the ban mask's ``device_ms`` and ``device_kernels`` (by kernel name),
measured by this module's own code with this checkout's
``probes.device_kernel_ms`` for every tree.  Per flash shape it prints
the forward's and the backward's ms (dQ, dK and dV: one call, or a tree's dK/dV and dQ kernels
summed) and, timed in the same process by this module's own code, SDPA's
forward and its backward alone (``sdpa_fwd.<label>.ms``,
``sdpa_bwd.<label>.ms``).  A tree whose ``chip_smoke.py`` defers device
times (``run_device_times``) also gives ``flash_fwd.<label>.device_ms`` and
``int4_matmul.<...>.device_ms``, read after every CUDA-event time; at the
families' and the long-key calls this module's own code reads, in every
tree, the device ms of the flash forward and backward and of SDPA's
forward and backward alone (``<flash|sdpa>_<fwd|bwd>.<label>.device_ms``,
this checkout's ``probes.device_kernel_ms``).  With the flash phase it
also holds each tree's backward at a case whose rows 0–71 see no key
(causal, sq 200 > skv 128, as the card test
``test_flash_kernels_give_keyless_rows_every_key``) against the plain
version on the same inputs: ``keyless.<dq|dk|dv>`` are
``utils/kernel_check.py::output_error``'s statistics.  Prints one JSON
line per tree, in the order given (name the trees alternately, e.g. A B B
A A B, and take medians).

``--flash-f32-only`` times the f32 flash kernels (the tree's
``flash_fwd``/``flash_bwd`` on f32 tensors) at ``FLASH_F32_FAMILIES``
beside f32 SDPA's forward and backward alone, CUDA-event ``ms`` and then
``device_ms`` of all four, and holds the tree's kernels and plain
versions to a float64 truth on the same inputs and keep mask
(``err.<label>.<out|lse|dq|dk|dv>``, ``plain_err...``: max_abs_err over
max |truth|, relative L2).  ``--steps-only`` times the training steps
of ``STEP_FAMILIES`` (``step.<name>.ms``: the median of 5 windows of 2
steps after a warm one; Llama-2-7B in f32 takes ~32 GiB of the card).

``--moe-front-f32-only`` times the f32 forms of ``moe_ffn`` (the tree's
wrapper on f32 tensors, on a nano-mini decoder block's MoE FFN built alone,
at ``MOE_F32_ROWS``, with the LN2 prologue and residual where the path has
them) and of ``fused_frontend`` (the offline front's shapes at
``FRONT_F32_BATCHES``, random weights, beside the projector's f32
``torch.matmul``): CUDA-event ``ms``; ``host_ms``, the host's time to
issue one call (100 calls issued back to back, no wait); then
``device_ms``, ``device_kernels`` (by kernel name) and ``launches`` (a
call) by this checkout's ``probes.device_kernels``, and each tree's
errors and its plain version's against a float64 truth
(``probes.moe_f64_truth`` on the kernel's own routes,
``probes.front_f64_truth``; ``err.<label>`` and ``plain_err.<label>`` =
``probes.truth_error``).  Then a nano-mini f32 caption call at batch 256:
``nano_mini_f32.walls_ms``, the walls of three calls after a warm one
with no profiler on (``wall_ms`` their median); then the busy ms of one
profiled call (the device's own events, as ``chip_smoke.py --profile``
counts them), ``nano_mini_f32.busy_ms``, that call's wall
(``profiled_wall_ms``) and its MoE kernels' part,
``nano_mini_f32.moe_ms``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# The families' largest bf16 training calls (chip_smoke.py's
# [train-kernels], as its flash cases' fields): (label, b, h, K/V heads, sq,
# skv, head dim, causal, soft-prompt prefix length or None, dropout rate).
# Every one is causal with no bias (the HF decoders' self-attention takes
# none; nano's decoder has no soft prompt), and only nano's scratch
# decoder drops probabilities.
FLASH_FAMILIES = (
    ("train_nano", 24, 20, 20, 256, 256, 64, True, None, 0.1),
    ("train_llama13b", 4, 40, 40, 272, 272, 128, True, None, 0.0),
    ("train_falcon7b", 4, 71, 1, 320, 320, 64, True, None, 0.0),
    ("train_qwen", 1, 12, 12, 272, 272, 128, True, None, 0.0),
    ("train_gpt2xl", 12, 25, 25, 320, 320, 64, True, None, 0.0))
# The f32 flash calls (the kernels of csrc/flash_attention_f32.cu), as
# FLASH_FAMILIES' fields: the families' largest f32 training calls
# (chip_smoke.py's [train-kernels]; the nano decoders' soft prompt of
# n_cls 16 rows), GPT-2's cross-attention on its 16 encoder rows, and the
# offline configs' (chip_smoke.py's FLASH_OFFLINE).
FLASH_F32_FAMILIES = (
    ("f32_llama7b", 1, 32, 32, 272, 272, 128, True, None, 0.0),
    ("f32_nano_lsh", 2, 12, 12, 256, 256, 64, True, 16, 0.1),
    ("f32_gpt2", 4, 12, 12, 272, 272, 64, True, None, 0.0),
    ("f32_gpt2_cross", 4, 12, 12, 272, 16, 64, False, None, 0.0),
    ("f32_nano_mini", 4, 8, 1, 92, 92, 128, True, 16, 0.1),
    ("f32_offline_encoder", 8, 4, 1, 264, 264, 16, False, None, 0.1),
    ("f32_offline_decoder", 8, 4, 1, 128, 128, 16, True, 8, 0.1))
# The f32 families whose training steps ``--steps-only`` times.
STEP_FAMILIES = ("llama7b", "gpt2")
# The f32 MoE FFN's calls ``--moe-front-f32-only`` times: (label, rows, LN2
# prologue and residual): every launch of a nano-mini f32 caption call
# (256 rows), the f32 sparse encoder block's (chip_smoke.py's [f32-chain]:
# b 8 x 160 selected rows), and 1, 17 and 4,097 rows.
MOE_F32_ROWS = (("decode", 256, False), ("f32_chain", 1280, True),
                ("rows1", 1, False), ("rows17", 17, False),
                ("rows4097", 4097, False))
# The f32 front's batches: the evaluate CLI's and the offline trainer's
# eval batch (chip_smoke.py's OFFLINE_FRONT_BATCH and synthetic-smoke.yaml).
FRONT_F32_BATCHES = (4, 8)

_CHILD = r'''
import importlib.util, json, sys, types
tree, mode, own_probes = sys.argv[1], sys.argv[2], sys.argv[3]
families = tuple(tuple(c) if isinstance(c, list) else c
                 for c in json.loads(sys.argv[4]))
sys.path.insert(0, tree)
import torch
import torch.nn.functional as F
import chip_smoke as cs
from image2text_torch.ops.attention import causal_bias
from image2text_torch.configs.models import FLAGSHIP, FLAGSHIP_DENSE
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
torch.backends.cuda.matmul.allow_tf32 = False
res, args = {}, types.SimpleNamespace(profile=False)
out = {"tree": tree, "device": torch.cuda.get_device_name(0)}


def sdpa_ms(b, h, hk, sq, s, d, causal, n_prefix, rate):
    """(forward, backward alone) ms of one SDPA call at a flash shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen
                                 ).to(torch.bfloat16).requires_grad_()
                     for shape in ((b, h, sq, d), (b, hk, s, d),
                                   (b, hk, s, d), (b, h, sq, d)))
    mask = None
    if n_prefix is not None or causal:
        mask = torch.zeros(1, 1, sq, s, device=dev)
        if n_prefix is not None:
            mask[..., n_prefix:, :n_prefix] = float("-inf")
        if causal:
            mask = mask + causal_bias(sq, s, dev)
        mask = mask.to(torch.bfloat16)
    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              dropout_p=rate, enable_gqa=True)

    with torch.enable_grad():
        o = fwd()
    return cs.cuda_ms(torch, fwd), cs.cuda_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), dout.detach(), retain_graph=True))


def own_probes_module():
    spec = importlib.util.spec_from_file_location("own_probes", own_probes)
    probes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probes)
    return probes


def flash_device(cases):
    """Device ms (this checkout's probes.device_kernel_ms, summed over the
    kernels) of the tree's flash forward and backward and of SDPA's
    forward and backward alone at each case, after every event time."""
    from image2text_torch.ops import flash_attention as fa
    probes = own_probes_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in cases:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen
                                     ).to(torch.bfloat16)
                         for shape in ((b, h, sq, d), (b, hk, s, d),
                                       (b, hk, s, d), (b, h, sq, d)))
        bias = (None if n_prefix is None
                else cs.soft_prompt_bias(torch, s, n_prefix, dev))
        a = (q, k, v, bias, causal)
        o_, lse = fa.flash_fwd(*a, rate, 9)
        g = (dout, lse, (dout.float() * o_.float()).sum(-1), rate, 9)
        mask = None
        if bias is not None or causal:
            mask = ((0 if bias is None else bias) + (
                causal_bias(sq, s, dev) if causal else 0)).to(torch.bfloat16)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               dropout_p=rate, enable_gqa=True)
        calls = {"flash_fwd": lambda: fa.flash_fwd(*a, rate, 9),
                 "flash_bwd": lambda: fa.flash_bwd(*a, *g),
                 "sdpa_fwd": lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask, dropout_p=rate,
                     enable_gqa=True),
                 "sdpa_bwd": lambda: torch.autograd.grad(
                     o, (qg, kg, vg), dout, retain_graph=True)}
        for name, fn in calls.items():
            out[f"{name}.{label}.device_ms"] = sum(
                probes.device_kernel_ms(fn).values())


def soft_prompt(s, n_prefix, dev):
    bias = torch.zeros(1, 1, s, s, device=dev)
    bias[..., n_prefix:, :n_prefix] = float("-inf")
    return bias


def flash_f32(cases):
    """The tree's f32 flash forward and backward and f32 SDPA's forward
    and backward alone at each case: CUDA-event ms, then (after every
    event time) device ms by this checkout's probes.device_kernel_ms; and
    the tree's kernels' errors (and the plain version's) against a
    float64 truth (this checkout's probes.flash_f64_truth):
    ``err.<label>.<out|lse|dq|dk|dv>`` = probes.truth_error."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias
    probes = own_probes_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    seed, calls = 9, {}
    err = probes.truth_error

    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in cases:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen)
                         for shape in ((b, h, sq, d), (b, hk, s, d),
                                       (b, hk, s, d), (b, h, sq, d)))
        bias = None if n_prefix is None else soft_prompt(s, n_prefix, dev)
        a = (q, k, v, bias, causal)
        o_, lse = fa.flash_fwd(*a, rate, seed)
        g = (dout, lse, (dout * o_).sum(-1), rate, seed)
        truth = probes.flash_f64_truth(fa, q, k, v, bias, causal, rate,
                                       seed, dout)
        got = (o_, lse) + tuple(fa.flash_bwd(*a, *g))
        po, pl = fa.flash_forward_plain(*a, rate, seed)
        plain = (po, pl) + tuple(fa.flash_backward_plain(
            *a, dout, pl, (dout * po).sum(-1), rate, seed))
        for name, x, y, z in zip(("out", "lse", "dq", "dk", "dv"), got,
                                 plain, truth):
            out[f"err.{label}.{name}"] = err(x, z)
            out[f"plain_err.{label}.{name}"] = err(y, z)
        mask = None
        if bias is not None or causal:
            mask = (0 if bias is None else bias) + (
                causal_bias(sq, s, dev) if causal else 0)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               dropout_p=rate, enable_gqa=True)
        fns = {"flash_fwd": lambda a=a, r=rate: fa.flash_fwd(*a, r, seed),
               "flash_bwd": lambda a=a, g=g: fa.flash_bwd(*a, *g),
               "sdpa_fwd": lambda q=q, k=k, v=v, m=mask, r=rate:
                   F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                  dropout_p=r, enable_gqa=True),
               "sdpa_bwd": lambda o=o, t=(qg, kg, vg), dout=dout:
                   torch.autograd.grad(o, t, dout, retain_graph=True)}
        for name, fn in fns.items():
            out[f"{name}.{label}.ms"] = probes.time_ms(fn)
        calls[label] = fns
    for label, fns in calls.items():   # after every event time
        for name, fn in fns.items():
            out[f"{name}.{label}.device_ms"] = sum(
                probes.device_kernel_ms(fn).values())


def family_steps(names):
    """Step ms of each family's training step (chip_smoke.py's
    family_setup and family_inputs, as [train-<name>] runs it): a warm
    step, then the median of 5 windows of 2 steps (the host's spread on
    the card's machine reached 25% of a window with 3)."""
    import statistics
    import time
    for name in names:
        cfg, wrapper, trainer = cs.family_setup(torch, name)
        images, labels = cs.family_inputs(torch, cfg, cfg.batch_size,
                                          cs.SEED + 50)
        step = trainer._train_step
        step(images, labels, cfg.seed, 0)
        windows = []
        for w in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(2):
                step(images, labels, cfg.seed, 1 + 2 * w + i)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / 2 * 1e3)
        out[f"step.{name}.ms"] = statistics.median(windows)
        out[f"step.{name}.windows"] = windows
        del cfg, wrapper, trainer, images, labels, step
        torch.cuda.empty_cache()


def keyless_errors():
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.utils.kernel_check import output_error
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    b, h, sq, s, d, rate, seed = 1, 2, 200, 128, 64, 0.1, 77
    q, dout = (torch.randn(b, h, sq, d, device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, 1, s, d, device=dev, generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_forward_plain(q, k, v, None, True, rate, seed)
    got = fa.flash_backward(q, k, v, None, True, o, lse, dout, rate, seed)
    dvec = (dout.float() * o.float()).sum(-1)
    want = fa.flash_backward_plain(q, k, v, None, True, dout, lse, dvec,
                                   rate, seed)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        out[f"keyless.{name}"] = output_error(x, y)


def front_topk():
    """The front and the ban mask in both trees' own phases, device times
    by kernel from this checkout's probes."""
    probes = own_probes_module()
    from image2text_torch.models.sampling import _ngram_bans
    from image2text_torch.ops.fused_frontend import fused_frontend
    from image2text_torch.ops.topk_mask import topk_ban_mask
    calls = {}

    def front_call(model, label):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
        images, _, _ = cs.block_input(torch, model, gen)
        enc = model.vision_encoder
        x = enc.feature_extractor(images)
        x = x.reshape(x.shape[0], enc.n_patches ** 2, enc.input_d)
        w = enc.frontend_weights(x.dtype)
        calls[label] = lambda: fused_frontend(x, w)

    for cfg, phase in ((FLAGSHIP, cs.phase_kernels),
                       (FLAGSHIP_DENSE, cs.phase_dense_kernel)):
        model = VisionEncoderDecoder(cfg, device="cuda").init_weights(
            cs.SEED).to(torch.bfloat16).eval()
        phase(torch, model, args, res)
        if cfg is FLAGSHIP:
            front_call(model, "fused_frontend")
            vocab = cfg.decoder_config.vocab_size
            ngrams = tuple(model.no_repeat_n_grams)
        del model
        torch.cuda.empty_cache()
    with cs.gpt2_depth(1):
        model = cs.gpt2m_model(torch)
    cs.phase_kernels(torch, model, args, res, tag="gpt2m")
    front_call(model, "fused_frontend.gpt2m")
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    for rows, tag in ((cs.BATCH, None), (3 * cs.BEAM_BATCH, "beam")):
        ids = torch.randint(0, vocab, (rows, 1 + cs.MAX_NEW_TOKENS),
                            device="cuda", generator=gen)
        cs.phase_topk_kernel(torch, res, ids, ngrams, vocab, tag=tag)
        x = 2 * torch.randn(rows, vocab, device="cuda", generator=gen)
        cand, ban = _ngram_bans(ids, ids.shape[1], ngrams)
        banned = torch.where(ban, cand, -1).to(torch.int32)
        label = "topk_ban_mask" + ("" if tag is None else f".{tag}")
        calls[label] = (lambda x=x, banned=banned:
                        topk_ban_mask(x, banned, 16))
    for label, fn in calls.items():   # after every event time
        split = probes.device_kernel_ms(fn)
        out[f"{label}.device_ms"] = sum(split.values())
        out[f"{label}.device_kernels"] = split
    for name in ("fused_frontend", "topk_ban_mask"):
        for tag in (None, "gpt2m", "beam"):
            r = res.get(name, {})
            r = r if tag is None else r.get(f"{tag}_shape")
            if r:
                label = name + ("" if tag is None else f".{tag}")
                for key in ("ms", "library_ms", "plain_ms", "other_route_ms"):
                    if key in r:
                        out[f"{label}.{key}"] = r[key]
    r = res["sparse_block"]
    out["sparse_block.gpt2m.ms"] = r["gpt2m_shape"]["ms"]


def moe_front_f32(cases):
    """The tree's f32 moe_ffn and fused_frontend at ``cases`` (rows, then
    front batches): event and host ms first, then device ms, launches and
    the errors against a float64 truth, then a nano-mini f32 caption
    call's walls and busy ms."""
    import statistics
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models.generation import caption
    from image2text_torch.models.layers import _MoEMLP
    from image2text_torch.nn.core import init_parameters
    from image2text_torch.ops import fused_frontend as ff
    from image2text_torch.ops import fused_moe as fm
    probes = own_probes_module()
    rows_cases, batches = cases
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 40)
    f32 = torch.float32
    tc = load_training_config(cs.NANO_YAML["nano-mini"]).model \
        .decoder_config.transformer_config
    mlp = _MoEMLP(tc.attn_config.n_embd, tc.attn_config.bias,
                  tc.rotator_config, device=dev)
    init_parameters(mlp, gen)
    fc, proj = mlp.c_fc.packed(f32), mlp.c_proj.packed(f32)
    fin = fc.wa.shape[0]
    calls, checks = {}, {}

    def host_ms(fn, iters=100):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return issued / iters * 1e3

    for label, n, prologue in rows_cases:
        x = torch.randn(n, fin, device=dev, generator=gen)
        extra = (dict(ln_w=1 + 0.1 * torch.randn(fin, device=dev,
                                                 generator=gen),
                      ln_b=0.1 * torch.randn(fin, device=dev, generator=gen),
                      residual=x) if prologue else {})
        fn = (lambda x=x, extra=extra: fm.moe_ffn(x, fc, proj, **extra))
        out[f"moe_ffn.{label}.ms"] = probes.time_ms(fn, 20)
        out[f"moe_ffn.{label}.host_ms"] = host_ms(fn)
        calls[f"moe_ffn.{label}"] = fn
        checks[f"moe_ffn.{label}"] = ("moe", x, extra)
    t, din, d, n_cls = 256, 128, 64, 8

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    for b in batches:
        w = ff.FrontendWeights(r(din, d, scale=din ** -0.5), r(d, scale=0.1),
                               1 + r(t, d, scale=0.1), r(t, d, scale=0.1),
                               r(t, d), r(n_cls, d))
        x = r(b, t, din)
        fn = (lambda x=x, w=w: ff.fused_frontend(x, w))
        out[f"fused_frontend.b{b}.ms"] = probes.time_ms(fn, 20)
        out[f"fused_frontend.b{b}.host_ms"] = host_ms(fn)
        out[f"fused_frontend.b{b}.library_ms"] = probes.time_ms(
            lambda x=x, w=w: torch.matmul(x, w.w_p), 20)
        calls[f"fused_frontend.b{b}"] = fn
        checks[f"fused_frontend.b{b}"] = ("front", x, w)
    for label, fn in calls.items():   # after every event time
        seen = probes.device_kernels(fn)
        out[f"{label}.device_ms"] = sum(ms for ms, _ in seen.values())
        out[f"{label}.device_kernels"] = {k: ms for k, (ms, _) in seen.items()}
        out[f"{label}.launches"] = sum(n for _, n in seen.values())
    for label, (kind, x, a) in checks.items():
        if kind == "moe":
            routes = torch.zeros(x.shape[0], 2, dtype=torch.uint8, device=dev)
            got = fm.moe_ffn(x, fc, proj, routes=routes, **a)
            truth = probes.moe_f64_truth(fm, x, fc, proj, routes, **a)
            plain = fm.moe_ffn_plain(x, fc, proj, force_routes=routes, **a)
        else:
            got = ff.fused_frontend(x, a)
            truth = probes.front_f64_truth(ff, x, a)
            plain = ff.fused_frontend_plain(x, a)
        out[f"err.{label}"] = probes.truth_error(got, truth)
        out[f"plain_err.{label}"] = probes.truth_error(plain, truth)
    del calls, checks
    torch.cuda.empty_cache()
    model, _, _ = cs.nano_model(torch, "nano-mini", f32)
    frames, prompt = cs.serving_inputs(torch, model, cs.BATCH, cs.SEED + 2,
                                       cs.NANO_BOS)

    def run():
        g = torch.Generator(device=dev).manual_seed(1)
        return caption(model, frames, prompt,
                       max_new_tokens=cs.MAX_NEW_TOKENS, temperature=0.7,
                       top_k=16, generator=g)

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["nano_mini_f32.walls_ms"] = walls
    out["nano_mini_f32.wall_ms"] = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type == DeviceType.CPU}
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in host
              and not getattr(e, "is_user_annotation", False)]
    out["nano_mini_f32.busy_ms"] = sum(
        e.self_device_time_total for e in events) / 1e3
    out["nano_mini_f32.profiled_wall_ms"] = wall * 1e3
    out["nano_mini_f32.moe_ms"] = sum(
        e.self_device_time_total for e in events if "moe32" in e.key) / 1e3


if mode == "moe_front_f32":
    with torch.no_grad():
        moe_front_f32(families)
    print("KERNEL_TIMES " + json.dumps(out), flush=True)
    sys.exit(0)
if mode == "steps":
    family_steps(families)
    print("KERNEL_TIMES " + json.dumps(out), flush=True)
    sys.exit(0)
with torch.no_grad():
    if mode == "flash_f32":
        flash_f32(families)
        print("KERNEL_TIMES " + json.dumps(out), flush=True)
        sys.exit(0)
    if mode == "front_topk":
        front_topk()
    if mode == "int4":
        with cs.gpt2_depth(1):
            model = cs.gpt2m_model(torch)
        cs.phase_int4_kernels(torch, model, res)
        if hasattr(cs, "run_device_times"):   # after every event time
            cs.run_device_times()
        for key, r in res["int4_matmul"].items():
            if key.endswith("_shape"):
                out[f"int4_matmul.{key[:-6]}.ms"] = r["ms"]
                out[f"int4_matmul.{key[:-6]}.library_ms"] = r["library_ms"]
                if "device_ms" in r:
                    out[f"int4_matmul.{key[:-6]}.device_ms"] = r["device_ms"]
        print("KERNEL_TIMES " + json.dumps(out), flush=True)
        sys.exit(0)
    if mode == "all":
        for cfg, phase in ((FLAGSHIP, cs.phase_kernels),
                           (FLAGSHIP_DENSE, cs.phase_dense_kernel)):
            model = VisionEncoderDecoder(cfg, device="cuda").init_weights(
                cs.SEED).to(torch.bfloat16).eval()
            phase(torch, model, args, res)
            del model
            torch.cuda.empty_cache()
    if mode in ("all", "flash"):
        for cases in (cs.FLASH_FLAGSHIP, cs.FLASH_GPT2M, families,
                      cs.FLASH_LONG):
            cs.phase_flash_kernels(torch, args, res, cases)
            for case in cases:
                label = case[0]

                def ms(name):
                    r = res.get(name, {})
                    r = r if label == "encoder" else r.get(f"{label}_shape", {})
                    return r.get("ms")

                fused = ms("flash_bwd")
                out[f"flash_fwd.{label}.ms"] = ms("flash_fwd")
                out[f"flash_bwd.{label}.ms"] = (
                    fused if fused is not None
                    else ms("flash_bwd_dkv") + ms("flash_bwd_dq"))
                out[f"sdpa_fwd.{label}.ms"], out[f"sdpa_bwd.{label}.ms"] = sdpa_ms(
                    *case[1:])
        keyless_errors()
        if hasattr(cs, "run_device_times"):   # after every event time
            cs.run_device_times()
            for case in cs.FLASH_FLAGSHIP + cs.FLASH_GPT2M:
                label = case[0]
                fwd = res["flash_fwd"]
                fwd = fwd if label == "encoder" else fwd[f"{label}_shape"]
                out[f"flash_fwd.{label}.device_ms"] = fwd["device_ms"]
        flash_device(families + cs.FLASH_LONG)
for name, r in res.items():
    if name.startswith("flash_"):
        continue
    for key in ("ms", "library_ms", "gemm_ms", "attention_ms",
                "attention_library_ms"):
        if key in r:
            out[f"{name}.{key}"] = r[key]
    if "encoder_shape" in r:
        out[f"{name}.encoder.ms"] = r["encoder_shape"]["ms"]
print("KERNEL_TIMES " + json.dumps(out), flush=True)
'''


MODES = {"--flash-only": "flash", "--int4-only": "int4",
         "--front-topk-only": "front_topk", "--flash-f32-only": "flash_f32",
         "--steps-only": "steps", "--moe-front-f32-only": "moe_front_f32"}


def main(argv) -> int:
    mode = next((MODES[a] for a in argv if a in MODES), "all")
    cases = {"flash_f32": FLASH_F32_FAMILIES, "steps": STEP_FAMILIES,
             "moe_front_f32": (MOE_F32_ROWS, FRONT_F32_BATCHES)}.get(
                 mode, FLASH_FAMILIES)
    for tree in [a for a in argv if a not in MODES]:
        root = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, mode,
                               str(Path(__file__).with_name("__init__.py")),
                               json.dumps(cases)],
                              cwd=root, capture_output=True, text=True)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith("KERNEL_TIMES ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode or 1
        print(lines[-1][len("KERNEL_TIMES "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
