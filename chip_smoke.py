#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image2text_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, flagship widths
    python3 chip_smoke.py --profile    # also device time by kernel

Phases, each printing its lines:

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds every kernel source from the checkout, in parallel.
3. kernels  each CUDA kernel against its plain PyTorch version, in bf16 at
            the flagship shapes, the plain version run on the kernel's own
            expert routes and held at the output's scale
            (image2text_torch/utils/kernel_check.py): error, kernel time,
            plain time, bound.  The three flash-attention kernels at the
            training step's encoder shape (batch 48, 8 heads, s 160,
            d 128, multi-query, dropout 0.1) and a decoder shape (s 136,
            causal, soft-prompt bias), with the same dropout seed as their
            plain versions, and F.scaled_dot_product_attention's time as a
            yardstick the port never calls.
4. main     the flagship serving path at full width with random weights:
            raw uint8 frames → preprocess → encoder → cached generate
            (32 new tokens, temperature 0.7, top-k 16, n-grams 2–5);
            launch counts of every kernel and captions/s.
5. parity   at batch 8, first-step logits and greedy tokens of the kernel
            path against the plain-version path.
6. train    the flagship training step (training_configs/tpu/nano-mini.yaml:
            batch 48, 256 labels, bf16 compute from f32 masters, dropout
            0.1, gradient checkpointing; SNRAdam lr 6e-4 and mask
            fractions 0.15/0.2 as bench_train.py) at full width and depth:
            launches of every kernel in one step (flash as predicted, the
            serving kernels none), then 3 windows of 4 steps on one batch:
            step ms, tokens/s, peak memory, the loss of every step (finite
            and falling).
7. train-parity  at batch 8, full width, depth 2 + 2: one training step on
            the kernels, then on the plain versions, same weights, seeds
            and batch: loss and gradients.

The second-to-last lines are the ``kernels`` JSON object and the
nvidia-smi line; the last line is ``{"ok": true, "device": ...}``.  Any
failed phase exits non-zero without that line; so does a run without a
CUDA device or outside the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 0.06       # whole-stack parity: the JAX bf16 kernel tests' tolerance
TRAIN_LOSS_TOL = 1e-2   # train parity: loss, relative
TRAIN_GRAD_TOL = 2e-2   # train parity: gradients, relative L2
DROPOUT = 0.1    # the flagship's attention dropout
TRAIN_BATCH = 48     # training_configs/tpu/nano-mini.yaml
TRAIN_SEQ = 256      # bench_train.py's padded caption length
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak
MAX_NEW_TOKENS = 32
BATCH = 256      # the main path's batch
SEED = 0         # weights, frames and sampling noise derive from it


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_flops: float):
    tb, tf = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    total = 0
    for t in ts:
        if t is None:
            continue
        if isinstance(t, tuple):
            total += nbytes(*[f for f in t if hasattr(f, "numel")])
        else:
            total += t.numel() * t.element_size()
    return total


def compare(name, got, want, routes=None, gates=None, k=None):
    """Hold a kernel's output against its plain version, which ran on the
    kernel's own expert routes, at the output's scale; and the routes
    against the plain gate values (``image2text_torch.utils.kernel_check``).
    Raises on disagreement; returns the largest absolute error."""
    from image2text_torch.utils import kernel_check

    st = kernel_check.output_error(got, want)
    line = (f"  {name}: max_abs_err {st['max_abs_err']:.6g} (max|plain| "
            f"{st['max_plain']:.6g}, limit {kernel_check.MAX_ABS_SHARE} x), "
            f"rel_l2 {st['rel_l2']:.6g} (limit {kernel_check.REL_L2}), "
            f"bitwise-equal share {st['equal_share']:.4f}, elements beyond "
            f"{kernel_check.ELEMENT_TOL} abs + rel {st['elements_beyond']}")
    if routes is not None:
        rt = kernel_check.check_routes(name, routes, gates, k)
        line += (f"; rows routed apart {rt['rows_apart']} of {rt['rows']}, "
                 f"largest tie gap crossed {rt['max_tie_gap']:.3g} (limit "
                 f"{kernel_check.TIE})")
    log(line)
    kernel_check.check_output(name, got, want)
    return st["max_abs_err"]


def run_pair(torch, kernel, plain, args, n_rows, e, **kw):
    """``kernel(*args)`` with its routes recorded, then ``plain(*args)``
    forced onto them; returns (got, want, routes, gates)."""
    dev = args[0].device
    routes = torch.zeros(n_rows, 2, dtype=torch.uint8, device=dev)
    gates = torch.zeros(n_rows, 2, e, dtype=torch.float32, device=dev)
    got = kernel(*args, routes=routes, **kw)
    want = plain(*args, force_routes=routes, gates=gates, **kw)
    torch.cuda.synchronize()
    return got, want, routes, gates


@contextlib.contextmanager
def plain_versions():
    """Run the model's kernel call sites on the plain versions (for the
    parity phases only)."""
    from image2text_torch.models import layers
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.fused_block import sparse_block_plain
    from image2text_torch.ops.fused_moe import moe_ffn_plain

    saved = (layers.sparse_block, layers.moe_ffn, fa.flash_fwd,
             fa.flash_bwd_dkv, fa.flash_bwd_dq)
    layers.sparse_block, layers.moe_ffn = sparse_block_plain, moe_ffn_plain
    fa.flash_fwd = fa.flash_forward_plain
    fa.flash_bwd_dkv = lambda *a: fa.flash_backward_plain(*a)[1:]
    fa.flash_bwd_dq = lambda *a: fa.flash_backward_plain(*a)[0]
    try:
        yield
    finally:
        (layers.sparse_block, layers.moe_ffn, fa.flash_fwd, fa.flash_bwd_dkv,
         fa.flash_bwd_dq) = saved


def moe_flops_bytes(x, fc, proj):
    n, fin = x.shape[0], x.shape[-1]
    hidden = fc.l2w.shape[1]
    per_row = 2 * (fin * fc.wa.shape[1] + fc.g * fc.e
                   + (fc.l2w.shape[0] + fc.e) * hidden
                   + hidden * proj.wa.shape[1] + proj.g * proj.e
                   + (proj.l2w.shape[0] + proj.e) * fin)
    return n * per_row, nbytes(x, fc, proj) + nbytes(x)


def phase_kernels(torch, model, args, results):
    from image2text_torch.ops.fused_block import (sparse_block,
                                                  sparse_block_plain)
    from image2text_torch.ops.fused_moe import moe_ffn, moe_ffn_plain

    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    enc = model.encoder
    # block 2's input and layout, from a real encoder forward
    captured = {}

    class Captured(Exception):
        pass

    def grab(mod, a, kw):
        captured["x"], captured["layout"] = a[0].clone(), kw["layout"]
        raise Captured

    frames = torch.randint(0, 256, (BATCH, 160, 240, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    images = resize_normalize_on_device(frames, 128, out_dtype=bf)
    h = enc.blocks[2].register_forward_pre_hook(grab, with_kwargs=True)
    try:
        enc(images)
    except Captured:
        pass
    finally:
        h.remove()
    x, layout = captured["x"], captured["layout"]
    blk = enc.blocks[2]
    b, t, d = x.shape
    rows_sel, rows_byp = blk.layout_rows(layout, t, dev)
    w = blk.sparse_block_weights(bf)
    ts, tb = rows_sel.numel(), rows_byp.numel()
    e, k = w.fc.e, w.fc.k
    got, want, rk, gv = run_pair(torch, sparse_block, sparse_block_plain,
                                 (x, rows_sel, rows_byp, w), b * ts, e)
    err = compare(f"sparse_block b={b} t={t} t_sel={ts} d={d}", got, want,
                  rk, gv, k)
    # At random init the FFN term (~0.03) lies below the bf16 resolution
    # of the O(10) residual it is added to, so the check above cannot see
    # the FFN stage.  Scaling the second MoELinear's output weights by 64
    # (exact in bf16) lifts that term to the residual's size.
    w64 = w._replace(proj=w.proj._replace(l2w=w.proj.l2w * 64,
                                          l2b=w.proj.l2b * 64))
    got, want, rk, gv = run_pair(torch, sparse_block, sparse_block_plain,
                                 (x, rows_sel, rows_byp, w64), b * ts, e)
    compare("sparse_block, FFN output weights x64", got, want, rk, gv, k)
    del got, want, w64
    ms = cuda_ms(torch, lambda: sparse_block(x, rows_sel, rows_byp, w))
    plain = cuda_ms(torch, lambda: sparse_block_plain(x, rows_sel, rows_byp,
                                                      w))
    hd = d // w.n_head
    n_sel = b * ts
    ffn_flops, _ = moe_flops_bytes(torch.empty(n_sel, d), w.fc, w.proj)
    flops = (2 * n_sel * d * (d + 2 * hd) + 4 * b * w.n_head * ts * ts * hd
             + 2 * n_sel * d * d + ffn_flops + 2 * b * tb * d * d)
    wbytes = sum(nbytes(getattr(w, f)) for f in w._fields[:8]) + nbytes(
        w.fc, w.proj, w.w_n, w.b_n, rows_sel, rows_byp)
    bms, by = bound_ms(2 * nbytes(x) + wbytes, flops)
    # torch.matmul at the block's three GEMM shapes, as a yardstick only
    a_sel = torch.randn(n_sel, d, device=dev, dtype=bf, generator=gen)
    a_byp = torch.randn(b * tb, d, device=dev, dtype=bf, generator=gen)
    lib = cuda_ms(torch, lambda: (torch.matmul(a_sel, w.w_qkv),
                                  torch.matmul(a_sel, w.w_o),
                                  torch.matmul(a_byp, w.w_n)))
    if args.profile:
        log("  device time by kernel, one sparse_block call:")
        device_profile(torch, lambda: sparse_block(x, rows_sel, rows_byp, w),
                       top=6)
    log(f"  sparse_block: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP), torch.matmul at its "
        f"GEMM shapes {lib:.4f} ms")
    results["sparse_block"] = dict(
        name="sparse_block", route="cuda",
        source="image2text_torch/csrc/fused_block.cu",
        replaces="image2text_tpu/ops/fused_block.py:118", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)

    # decode: a decoder block's FFN on its 256 rows; encoder: the sparse
    # block's FFN stage (LN2 prologue) on its b·t_sel rows, held at the
    # FFN term's own scale
    for label, mlp, rows, ln in (
            ("decode", model.decoder.blocks[0].mlp, BATCH, {}),
            ("encoder", blk.mlp, b * ts, dict(ln_w=w.ln2_w, ln_b=w.ln2_b))):
        fc, proj = mlp.c_fc.packed(bf), mlp.c_proj.packed(bf)
        xm = torch.randn(rows, fc.wa.shape[0], device=dev, dtype=bf,
                         generator=gen)
        got, want, rk, gv = run_pair(torch, moe_ffn, moe_ffn_plain,
                                     (xm, fc, proj), rows, fc.e, **ln)
        hidden = fc.l2w.shape[1]
        err = compare(f"moe_ffn {label} rows={rows} hidden={hidden}", got,
                      want, rk, gv, fc.k)
        ms = cuda_ms(torch, lambda: moe_ffn(xm, fc, proj, **ln), iters=20)
        plain = cuda_ms(torch, lambda: moe_ffn_plain(xm, fc, proj, **ln),
                        iters=20)
        flops, byts = moe_flops_bytes(xm, fc, proj)
        bms, by = bound_ms(byts + nbytes(*ln.values()), flops)
        log(f"  moe_ffn {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
            f"{byts / 1e6:.2f} MB)")
        if label == "decode":
            results["moe_ffn"] = dict(
                name="moe_ffn", route="cuda",
                source="image2text_torch/csrc/fused_moe.cu",
                replaces="image2text_tpu/ops/fused_moe.py:95",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)
        else:
            results["moe_ffn"]["encoder_shape"] = dict(
                rows=rows, hidden=hidden, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


def phase_main(torch, model, args, results):
    from image2text_torch.models.generation import caption
    from image2text_torch.ops.fused_block import sparse_block
    from image2text_torch.ops.fused_moe import moe_ffn

    dev, b = model.device, BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    frames = torch.randint(0, 256, (b, 160, 240, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    prompt = torch.ones((b, 1), dtype=torch.long, device=dev)

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return caption(model, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.7, top_k=16, generator=g)

    run(0)  # warm-up: builds caches and per-block index tensors
    torch.cuda.synchronize()
    sparse_block.launches = moe_ffn.launches = 0
    ids = run(1)
    torch.cuda.synchronize()
    counts = {"sparse_block": sparse_block.launches,
              "moe_ffn": moe_ffn.launches}
    vocab = model.config.decoder_config.vocab_size
    if tuple(ids.shape) != (b, 1 + MAX_NEW_TOKENS):
        raise AssertionError(f"main path: ids shape {tuple(ids.shape)}")
    if not bool(((ids >= 0) & (ids < vocab)).all()) or not bool(
            (ids[:, 0] == 1).all()):
        raise AssertionError("main path: ids out of range or prompt lost")
    dec = model.decoder
    off = model.space_for_prompt
    want_ffn = dec.ffn_evaluations(off, 1) + sum(
        dec.ffn_evaluations(off + 1 + i, 1) for i in range(MAX_NEW_TOKENS))
    want_blocks = len(model.encoder.blocks)
    log(f"  launches in one caption call: sparse_block {counts['sparse_block']}"
        f" (want {want_blocks}), moe_ffn {counts['moe_ffn']} (want "
        f"{want_ffn} of at most {len(dec.blocks) * (1 + MAX_NEW_TOKENS)})")
    if counts["sparse_block"] != want_blocks or counts["moe_ffn"] != want_ffn:
        raise AssertionError(f"main path launch counts {counts}")
    for k, v in counts.items():
        results.setdefault(k, {"name": k})["launches"] = v
    windows = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(10 + w)
        torch.cuda.synchronize()
        windows.append(b / (time.perf_counter() - t0))
    log(f"  captions/s (batch {b}, {MAX_NEW_TOKENS} new tokens, median of 3 "
        f"windows): {statistics.median(windows):.2f} on "
        f"{torch.cuda.get_device_name(0)}; windows "
        f"{[round(x, 2) for x in windows]}")
    log(f"  sample ids: {ids[0, :12].tolist()}")
    if args.profile:
        log("  device time by kernel, one caption call:")
        device_profile(torch, lambda: run(20))


def device_profile(torch, fn, top: int = 12) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time.  Only the device's
    own events (kernels, copies) count: an operator, an autograd node or
    a ``record_function`` range also reports the device time of the
    kernels it launched — some as device-side spans under the host
    event's name (``aten::mm``, ``Optimizer.step#…``) — and adding those
    in would count that time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type == DeviceType.CPU}
    device = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events = [e for e in device if e.key not in host
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e3  # ms
    spans = sum(e.self_device_time_total for e in device) / 1e3 - busy
    if not events:
        log("  profiler saw no device time")
        return
    log(f"  wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
        f"(share {busy / (wall * 1e3):.3f}; profiler on); {spans:.2f} ms "
        f"more under host events' names, not added")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    ops = [e for e in averages if e.device_type == DeviceType.CPU]
    log(f"  host time by operator (self, profiler on; "
        f"{sum(e.count for e in ops)} events):")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top // 2]:
        log(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_parity(torch, model):
    from image2text_torch.models.generation import decoder_step, generate
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    dev, b = model.device, 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = torch.randint(0, 256, (b, 160, 240, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    images = resize_normalize_on_device(frames, 128, out_dtype=torch.bfloat16)
    prompt = torch.ones((b, 1), dtype=torch.long, device=dev)

    def first_logits():
        with torch.no_grad():
            enc = model.encoder(images)
            cache = model.decoder.init_cache(b, 1 + MAX_NEW_TOKENS, enc.dtype,
                                             dev)
            logits, _ = decoder_step(model, prompt, cache,
                                     model.space_for_prompt, enc)
        return logits[:, -1]

    def greedy():
        return generate(model, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                        temperature=0.0)

    got, ids_k = first_logits(), greedy()
    with plain_versions():
        want, ids_p = first_logits(), greedy()
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want))
    beyond = int((err > TOL + TOL * want.abs()).sum())
    agree = float((ids_k[:, 1:] == ids_p[:, 1:]).float().mean())
    first = float((ids_k[:, 1] == ids_p[:, 1]).float().mean())
    log(f"  first-step logits (batch {b}, f32 from bf16, 24 layers): "
        f"relative L2 error {rel_l2:.6g}, max_abs_err {float(err.max()):.6g}"
        f" (max |logit| {float(want.abs().max()):.4g}), mean_abs_err "
        f"{float(err.mean()):.6g}; elements beyond {TOL} abs + {TOL} rel: "
        f"{beyond} of {err.numel()}")
    log(f"  greedy tokens agreeing: first step {first:.4f}, over "
        f"{MAX_NEW_TOKENS} steps {agree:.4f}")
    # Through 24 bf16 layers, rounding-order differences and near-tied MoE
    # gates compound, so the whole-stack check is normwise: the relative L2
    # error and the largest error against the largest logit, both within
    # the bf16 tolerance.  (Phase 3 holds each kernel elementwise.)
    if (not torch.isfinite(got).all() or rel_l2 > TOL
            or float(err.max()) > TOL * float(want.abs().max())):
        raise AssertionError("parity: kernel path disagrees with the plain "
                             "path beyond tolerance")


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.fused_block import sparse_block
    from image2text_torch.ops.fused_moe import moe_ffn

    return (sparse_block, moe_ffn, fa.flash_fwd, fa.flash_bwd_dkv,
            fa.flash_bwd_dq)


def soft_prompt_bias(torch, s: int, n_prefix: int, dev):
    """(1, 1, s, s) f32: 0, but -inf from text rows to the prefix (the
    decoder's soft-prompt bias)."""
    bias = torch.zeros(1, 1, s, s, device=dev)
    bias[..., n_prefix:, :n_prefix] = float("-inf")
    return bias


def flash_work(q, k, bias, causal: bool, kind: str):
    """(bytes, FLOP) one flash kernel call must move and do: each input
    read once and each output written once; the products over the
    (row, col) pairs the causal mask leaves (kind: fwd, dkv or dq)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    pairs = (sum(min(skv, max(0, r + skv - sq + 1)) for r in range(sq))
             if causal else sq * skv)
    qb, kb = nbytes(q), nbytes(k)
    rows = b * h * sq * 4
    mm = 2 * b * h * pairs * d
    ins = nbytes(bias) + 2 * kb + qb
    if kind == "fwd":                    # q, k, v, bias → out, lse
        return ins + qb + rows, 2 * mm
    ins += qb + 2 * rows                 # + dO, lse, D
    if kind == "dkv":                    # → dk, dv; S, dP, dV, dK
        return ins + 2 * kb, 4 * mm
    return ins + qb, 3 * mm              # → dq; S, dP, dQ


def phase_flash_kernels(torch, args, results):
    """The three flash kernels against their plain versions at the train
    step's two attention shapes, same inputs and dropout seed."""
    import torch.nn.functional as F

    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    b, h, d, seed = TRAIN_BATCH, 8, 128, -987654321
    for label, s, causal, n_prefix in (("encoder", 160, False, None),
                                       ("decoder", 136, True, 32)):
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen
                                     ).to(bf)
                         for shape in ((b, h, s, d), (b, 1, s, d),
                                       (b, 1, s, d), (b, h, s, d)))
        bias = None if n_prefix is None else soft_prompt_bias(torch, s,
                                                              n_prefix, dev)
        a = (q, k, v, bias, causal)
        out, lse = fa.flash_fwd(*a, DROPOUT, seed)
        want, want_lse = fa.flash_forward_plain(*a, DROPOUT, seed)
        dvec = (dout.float() * want.float()).sum(-1)
        g = (dout, want_lse, dvec, DROPOUT, seed)
        dk, dv = fa.flash_bwd_dkv(*a, *g)
        dq = fa.flash_bwd_dq(*a, *g)
        pq, pk, pv = fa.flash_backward_plain(*a, *g)
        torch.cuda.synchronize()
        shape = (f"b={b} h={h} s={s} d={d} MQA causal={causal} "
                 f"bias={None if bias is None else tuple(bias.shape)} "
                 f"dropout={DROPOUT}")
        errs = {"fwd": compare(f"flash_fwd out {label} {shape}", out, want)}
        compare(f"flash_fwd lse {label}", lse, want_lse)
        errs["dkv"] = max(compare(f"flash_bwd_dkv dk {label}", dk, pk),
                          compare(f"flash_bwd_dkv dv {label}", dv, pv))
        errs["dq"] = compare(f"flash_bwd_dq dq {label}", dq, pq)
        del out, lse, dk, dv, dq, pq, pk, pv
        ms = {"fwd": cuda_ms(torch, lambda: fa.flash_fwd(*a, DROPOUT, seed)),
              "dkv": cuda_ms(torch, lambda: fa.flash_bwd_dkv(*a, *g)),
              "dq": cuda_ms(torch, lambda: fa.flash_bwd_dq(*a, *g))}
        plain_fwd = cuda_ms(torch, lambda: fa.flash_forward_plain(
            *a, DROPOUT, seed))
        plain_bwd = cuda_ms(torch, lambda: fa.flash_backward_plain(*a, *g))
        # the library yardstick: one SDPA call, causal folded into the mask
        mask = None
        if bias is not None or causal:
            mask = (0 if bias is None else bias) + (
                causal_bias(s, s, dev) if causal else 0)
            mask = mask.to(bf)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=DROPOUT, enable_gqa=True)

        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def lib_fwd_bwd():
            with torch.enable_grad():
                F.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=mask, dropout_p=DROPOUT,
                    enable_gqa=True).backward(dout)

        lib = {"fwd": cuda_ms(torch, lib_fwd),
               "fwd_bwd": cuda_ms(torch, lib_fwd_bwd)}
        log(f"  flash {label}: fwd {ms['fwd']:.4f} ms (plain {plain_fwd:.4f}"
            f", SDPA {lib['fwd']:.4f}), bwd_dkv {ms['dkv']:.4f} ms, bwd_dq "
            f"{ms['dq']:.4f} ms (plain backward, dq dk dv together "
            f"{plain_bwd:.4f}; SDPA forward + backward {lib['fwd_bwd']:.4f})")
        for kind, line in (("fwd", 181), ("dkv", 362), ("dq", 400)):
            name = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
            n_bytes, flops = flash_work(q, k, bias, causal, kind)
            bms, by = bound_ms(n_bytes, flops)
            log(f"    {name} {label}: bound {bms:.5f} ms ({by}; "
                f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB), kernel "
                f"at {bms / ms[kind]:.3f} of it")
            row = dict(max_abs_err=errs[kind], ms=ms[kind],
                       plain_ms=plain_fwd if kind == "fwd" else plain_bwd,
                       bound_ms=bms, bound_by=by,
                       library_ms=lib["fwd"] if kind == "fwd"
                       else lib["fwd_bwd"])
            if label == "encoder":
                results[name] = dict(
                    name=name, route="cuda",
                    source="image2text_torch/csrc/flash_attention.cu",
                    replaces=f"image2text_tpu/ops/flash_attention.py:{line}",
                    **row)
            else:
                results[name]["decoder_shape"] = dict(s=s, causal=causal,
                                                      **row)


def train_inputs(torch, cfg, batch: int, seed: int):
    """Images and eos-padded labels as bench_train.py::_inputs makes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    size = cfg.model.vision_encoder_config.input.width
    vocab = cfg.model.decoder_config.vocab_size
    images = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    labels = np.zeros((batch, TRAIN_SEQ), np.int64)
    for i, n in enumerate(rng.integers(8, TRAIN_SEQ - 1, batch)):
        labels[i, :n] = rng.integers(3, vocab - 1, n)
    dev = torch.device("cuda")
    return (torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev))


def train_setup(torch, n_layer=None):
    """The flagship training configuration (as bench_train.py sets it:
    SNRAdam, mask fractions 0.15 / 0.2) and its Trainer on the card."""
    from image2text_torch.configs.trainer import flagship_training_config
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    cfg = flagship_training_config()
    if n_layer is not None:
        cfg.model.vision_encoder_config.n_layer = n_layer
        cfg.model.decoder_config.n_layer = n_layer
    cfg.use_snr_optim = True
    cfg.trainer.mask_fraction, cfg.trainer.random_mask_fraction = 0.15, 0.2
    tok = TokenizerInfo(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                        vocab_size=cfg.model.decoder_config.vocab_size)
    wrapper = ModelTrainerWrapper(cfg.model, tok, cfg.trainer,
                                  device="cuda").init_weights(SEED)
    return cfg, wrapper, Trainer(cfg, wrapper)


def flash_launches_per_step(cfg, model, seq_len: int):
    """Launches of each flash kernel in one training step on ``seq_len``
    labels: one forward, backward and (both stacks checkpointing every
    block) recomputed forward per self-attention call of the model."""
    stacks = (cfg.model.vision_encoder_config, cfg.model.decoder_config)
    if not all(c.enable_gradient_checkpointing for c in stacks):
        raise ValueError("the launch count assumes full gradient "
                         "checkpointing in both stacks")
    calls = model.self_attention_calls(seq_len)
    return {"flash_fwd": 2 * calls, "flash_bwd_dkv": calls,
            "flash_bwd_dq": calls}


def phase_train(torch, args, results):
    cfg, wrapper, trainer = train_setup(torch)
    n_params = sum(p.numel() for p in wrapper.model.parameters())
    images, labels = train_inputs(torch, cfg, TRAIN_BATCH, SEED + 5)
    step = trainer._train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_wrappers()
    for kern in kernels:
        kern.launches = 0
    losses = [step(images, labels, cfg.seed, 0)["train_loss_lm"]]
    torch.cuda.synchronize()
    counts = {kern.__name__: kern.launches for kern in kernels}
    want = {"sparse_block": 0, "moe_ffn": 0,
            **flash_launches_per_step(cfg, wrapper.model, TRAIN_SEQ)}
    log(f"  flagship training step ({n_params:,} parameters, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} labels, bf16 compute, f32 masters, "
        f"dropout {DROPOUT}, gradient checkpointing): launches in one step "
        f"{counts} (want {want})")
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want}")
    for name, n in counts.items():
        if name.startswith("flash"):
            results[name]["launches"] = n
    windows = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(4):
            losses.append(step(images, labels, cfg.seed, 1 + 4 * w + i)[
                "train_loss_lm"])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 4)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    step_s = statistics.median(windows)
    log(f"  step ms (median of 3 windows of 4 steps): {step_s * 1e3:.2f}; "
        f"windows {[round(x * 1e3, 2) for x in windows]}; tokens/s "
        f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f}; peak memory "
        f"{peak:.3f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"  loss by step: {[round(x, 5) for x in losses]}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: loss not finite or not falling "
                             f"{losses}")
    if args.profile:
        log("  device time by kernel, one training step:")
        device_profile(torch, lambda: step(images, labels, cfg.seed, 99),
                       top=16)
    del trainer, wrapper
    torch.cuda.empty_cache()


def phase_train_parity(torch):
    """One training step at depth 2 + 2, on the kernels and then on the
    plain versions, from the same weights, seeds and batch."""
    from image2text_torch.training.loop import make_train_step
    from image2text_torch.training.optimizer import build_optimizer

    cfg, wrapper, trainer = train_setup(torch, n_layer=2)
    images, labels = train_inputs(torch, cfg, 8, SEED + 6)
    start = {k: v.clone() for k, v in wrapper.state_dict().items()}
    kernels = kernel_wrappers()
    runs = []
    for plain in (False, True):
        wrapper.load_state_dict(start)
        opt, _ = build_optimizer(wrapper, cfg.optimizers, use_snr=True)
        step = make_train_step(wrapper, opt, precision=cfg.precision)
        for kern in kernels:
            kern.launches = 0
        with plain_versions() if plain else contextlib.nullcontext():
            loss = float(step(images, labels, cfg.seed, 0)["train_loss_lm"])
        torch.cuda.synchronize()
        grads = {n: p.grad.float().clone()
                 for n, p in wrapper.model.named_parameters()
                 if p.grad is not None}
        runs.append((loss, grads, sum(k.launches for k in kernels[2:])))
    (lk, gk, nk), (lp, gp, npl) = runs

    def rel_l2(names):
        num = sum(float((gk[n] - gp[n]).square().sum()) for n in names)
        den = sum(float(gp[n].square().sum()) for n in names)
        return math.sqrt(num / den)

    attn = [n for n in gp if ".attn.q_proj." in n or ".attn.kv_proj." in n]
    loss_err = abs(lk - lp) / abs(lp)
    whole, qkv = rel_l2(list(gp)), rel_l2(attn)
    log(f"  batch 8, depth 2 + 2, full width: loss kernels {lk:.6f} vs plain "
        f"{lp:.6f} (relative error {loss_err:.3g}, limit {TRAIN_LOSS_TOL}); "
        f"gradient relative L2 error {whole:.4g} over {len(gp)} tensors, "
        f"{qkv:.4g} over the {len(attn)} attention q_proj/kv_proj ones "
        f"(limit {TRAIN_GRAD_TOL}); flash launches {nk} on the kernel path, "
        f"{npl} on the plain one")
    if (set(gk) != set(gp) or nk == 0 or npl != 0 or loss_err > TRAIN_LOSS_TOL
            or whole > TRAIN_GRAD_TOL or qkv > TRAIN_GRAD_TOL):
        raise AssertionError("train-parity: kernel path disagrees with the "
                             "plain-version path beyond tolerance")
    del trainer, wrapper
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "image2text_torch" / "csrc").is_dir():
        print("chip_smoke: image2text_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from image2text_torch.configs.models import FLAGSHIP
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for text in logs:
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  " + line.strip())

    t0 = time.perf_counter()
    model = VisionEncoderDecoder(FLAGSHIP, device="cuda").init_weights(
        SEED).to(torch.bfloat16)
    model.eval()
    log(f"[model] flagship (12 + 12 layers, d 1024, vocab "
        f"{FLAGSHIP.decoder_config.vocab_size}) with random bf16 weights "
        f"built in {time.perf_counter() - t0:.1f} s")

    results = {}
    with torch.no_grad():
        log("[kernels] kernel vs plain version (bf16, flagship shapes)")
        phase_kernels(torch, model, args, results)
        log("  flash-attention kernels vs plain versions, same dropout "
            "seed (bf16, the training step's attention shapes)")
        phase_flash_kernels(torch, args, results)
        log("[main] flagship serving path at full width")
        phase_main(torch, model, args, results)
        log("[parity] kernel path vs plain-version path at full width")
        phase_parity(torch, model)
    del model
    torch.cuda.empty_cache()
    log("[train] flagship training step at full width and depth")
    phase_train(torch, args, results)
    log("[train-parity] training step, kernel path vs plain-version path")
    phase_train_parity(torch)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys}
               | {k: v for k, v in r.items() if k.endswith("_shape")}
               for r in results.values()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
