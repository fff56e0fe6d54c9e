#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image2text_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, flagship widths
    python3 chip_smoke.py --profile    # also device time by kernel

Phases, each printing its lines:

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds every kernel source from the checkout, and the
            probes' ablation builds of two of them, in parallel.
3. kernels  each CUDA kernel against its plain PyTorch version, in bf16 at
            the flagship shapes, the plain version run on the kernel's own
            expert routes and held at the output's scale
            (image2text_torch/utils/kernel_check.py): error, kernel time,
            plain time, bound.  The flash-attention forward and backward
            (dQ, dK and dV in one call) at the training step's encoder
            shape (batch 48, 8 heads, s 160, d 128, multi-query, dropout
            0.1) and a decoder shape (s 136, causal, soft-prompt bias),
            with the same dropout seed as their plain versions; the
            forward's route and groups (fwd_plan) and its registers and
            spills (the build's -Xptxas -v); the
            backward launched three times, bitwise equal, and its visited
            (query tile, key slice) pairs counted against the causal band;
            F.scaled_dot_product_attention's forward, backward alone and
            both as yardsticks the port never calls.  The chain
            attention's worst error at score standard deviations 1, 2 and
            4 (t 160, 320) beside the sensitivity of the reference's own
            bf16 score rounding.
   lm_head  the tied lm_head's bf16 product with f32 sums (dot_f32) at
            256 rows and the flagship's and GPT-2-medium's vocab widths,
            its two cuBLAS formulations, and the f32 formulation it
            replaced.
            The encoder front (fused_frontend) at the serving batch, with
            the projector's torch.matmul as a yardstick.  The block
            chain's stages alone: its wgmma GEMMs against torch.matmul at
            the same shapes, its head-folded attention against one SDPA
            call on the folded query.  moe_ffn's two regimes forced at
            256 to 40,960 rows (where the switch FEW_ROWS lies).
   probes   the two block probes (image2text_torch/probes/) at batch 64:
            the chain built with each ablation (GELU, softmax, LayerNorm
            swapped out) held against its plain chain, and launched per
            image and per group of images against the whole batch; ms of
            every variant.
4. main     the flagship serving path at full width with random weights:
            raw uint8 frames → preprocess → encoder → cached generate
            (32 new tokens, temperature 0.7, top-k 16, n-grams 2–5);
            launch counts of every kernel and captions/s.  Then
            topk_ban_mask (a kernel no path dispatches, as in the JAX
            package) bit for bit against its reference on (256, 50258)
            f32 logits, k 16, with the n-gram bans of the call's id buffer
            (132 columns), torch.topk as a yardstick.
5. parity   at batch 8, first-step logits and greedy tokens of the kernel
            path against the plain-version path.
   beam     the beam-search serving path (bench.py::_bench_beam): raw
            frames, batch 64 → encoder → beam width 3, expansion 4,
            temperature 0.7, top-k 16, 32 new tokens, eos 0, n-grams 2–5,
            consolidation temperature 1.0; launches per call held to the
            counts derived from the rounds it ran, captions/s; then
            topk_ban_mask at its 192 decode rows.
   beam-parity  at batch 8, greedy beam search (temperature 0,
            consolidation 0), kernel path against plain-version path:
            where the histories agree, round by round, the last logits
            (normwise, as parity) and the candidates' log-scores (0.1
            nats); then the rounds each sample's ids stayed equal and the
            near-tie margin where they parted.
   dense    the flagship's dense-encoder twin (FLAGSHIP_DENSE): the eval
            dense block kernel (fused_block) against its plain version at
            its encoder's shapes (batch 256, t 320), then its serving path
            as [main] (12 fused_block launches, no sparse_block) and its
            parity as [parity] (dense-parity).
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

Then the int4 + LoRA GPT-2-medium captioner
(training_configs/tpu/gpt2-medium.yaml) at full width and depth, random
weights from the seed (int4 weights quantized from N(0, 0.02) matrices,
LoRA B N(0, 0.02): zero initialisers would make both vanish):

8. kernels  int4_matmul against its plain version at the decoder's four
            quantized Linear shapes, at 256 decode rows and at the training
            step's 12 x 112 rows (bf16, bf16 scales), its plan (tile and
            split of the input) and two reruns bitwise equal, with torch.matmul on
            the weight dequantised once to bf16 as a yardstick; the front,
            the sparse block and the MoE FFN at the GPT-2-medium encoder's
            shapes; the
            flash forward and backward at its training step's attention shapes
            (encoder MQA s 80, GPT-2 self-attention 16 heads s 112 causal,
            cross-attention 112 x 64; batch 12, head dim 64).
9. gpt2m    the serving path, batch 256, 32 new tokens: launches per
            caption call held to the counts derived from the model, and
            captions/s.
10. gpt2m-parity  at batch 8: first-step logits and greedy tokens, kernel
            path against plain-version path.
11. gpt2m-train  the kbit + LoRA training step (batch 12 x 48 labels,
            accumulation 1, bf16 compute from f32 masters, checkpointing,
            SNRAdam lr 6e-4): launches per step, step ms, peak memory, the
            loss of every step, frozen tensors bitwise unchanged.
12. gpt2m-train-parity  depth 2 + 2, full width, batch 8: loss and
            gradients, kernel path against plain-version path.

13. device-times  the device time of the flash forward and int4_matmul
            rows (torch.profiler's kernel durations, free of the wrapper's
            host time that their CUDA-event times include), taken last:
            the profiler slows every later host call of the process.

Every launch count is read over one run of its path with every count set
to 0 just before it (``launches_by_path`` in the JSON line).

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
# greedy beam parity: candidates' log-scores (nats) in one round, an
# absolute limit over the card's readings (at most 0.062 on an H100)
BEAM_SCORE_TOL = 0.1
TRAIN_LOSS_TOL = 1e-2   # train parity: loss, relative
TRAIN_GRAD_TOL = 2e-2   # train parity: gradients, relative L2
DROPOUT = 0.1    # the flagship's attention dropout
TRAIN_BATCH = 48     # training_configs/tpu/nano-mini.yaml
TRAIN_SEQ = 256      # bench_train.py's padded caption length
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak
F32_OP_PER_S = 67e12        # f32 outside the tensor cores
MAX_NEW_TOKENS = 32
BATCH = 256      # the main path's batch
PROBE_BATCH = 64  # the block probes' batch (tools/ ran 256; cut for time)
BEAM_BATCH = 64  # bench.py::_bench_beam's batch (3 beams: 192 decode rows)
FLAGSHIP_BOS = 1   # the flagship's prompt token
FLAGSHIP_EOS = 0   # bench.py's beam eos_token_id
SEED = 0         # weights, frames and sampling noise derive from it


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOP_PER_S):
    tb, tf = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    from image2text_torch.probes import time_ms

    return time_ms(fn, iters)


# (kernel row, call) pairs whose device time is read at the end of the run:
# the profiler that reads it slows every later host call of the process,
# so no CUDA-event time is taken after it (run_device_times).
DEVICE_TIMES = []


def defer_device_ms(label: str, row: dict, fn) -> None:
    """Have ``row["device_ms"]`` measured at the end of the run: ``fn``'s
    device time in ms, the host's launch overhead excluded (torch.profiler's
    kernel durations)."""
    DEVICE_TIMES.append((label, row, fn))


def run_device_times() -> None:
    """Measure every deferred device time (after all CUDA-event timing)."""
    from image2text_torch.probes import device_ms

    for label, row, fn in DEVICE_TIMES:
        row["device_ms"] = device_ms(fn)
        log(f"  {label}: device {row['device_ms']:.4f} ms (CUDA events "
            f"{row['ms']:.4f})")
    DEVICE_TIMES.clear()


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
    from image2text_torch.models import encoder, layers
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops import int4_matmul as i4
    from image2text_torch.ops.fused_block import (fused_block_plain,
                                                  sparse_block_plain)
    from image2text_torch.ops.fused_frontend import fused_frontend_plain
    from image2text_torch.ops.fused_moe import moe_ffn_plain

    saved = (layers.sparse_block, layers.fused_block, layers.moe_ffn,
             encoder.fused_frontend, fa.flash_fwd, fa.flash_bwd,
             i4.int4_matmul)
    layers.sparse_block, layers.moe_ffn = sparse_block_plain, moe_ffn_plain
    layers.fused_block = fused_block_plain
    encoder.fused_frontend = fused_frontend_plain
    fa.flash_fwd = fa.flash_forward_plain
    fa.flash_bwd = fa.flash_backward_plain
    i4.int4_matmul = i4.int4_matmul_plain
    try:
        yield
    finally:
        (layers.sparse_block, layers.fused_block, layers.moe_ffn,
         encoder.fused_frontend, fa.flash_fwd, fa.flash_bwd,
         i4.int4_matmul) = saved


def moe_flops_bytes(x, fc, proj):
    n, fin = x.shape[0], x.shape[-1]
    hidden = fc.l2w.shape[1]
    per_row = 2 * (fin * fc.wa.shape[1] + fc.g * fc.e
                   + (fc.l2w.shape[0] + fc.e) * hidden
                   + hidden * proj.wa.shape[1] + proj.g * proj.e
                   + (proj.l2w.shape[0] + proj.e) * fin)
    return n * per_row, nbytes(x, fc, proj) + nbytes(x)


def block_input(torch, model, gen, depth: int = 2):
    """The serving batch of frames, preprocessed, and encoder block
    ``depth``'s input stream and row layout from a real encoder forward on
    them: (images, x, layout)."""
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    enc, captured = model.vision_encoder, {}

    class Captured(Exception):
        pass

    def grab(mod, a, kw):
        captured["x"], captured["layout"] = a[0].clone(), kw["layout"]
        raise Captured

    frames = torch.randint(0, 256, (BATCH, 160, 240, 3), dtype=torch.uint8,
                           device=model.device, generator=gen)
    images = resize_normalize_on_device(
        frames, model.config.vision_encoder_config.input.width,
        out_dtype=torch.bfloat16)
    h = enc.blocks[depth].register_forward_pre_hook(grab, with_kwargs=True)
    try:
        model.encoder(images)
    except Captured:
        pass
    finally:
        h.remove()
    return images, captured["x"], captured["layout"]


def chain_stage_ms(torch, w, b: int, ts: int, tb: int, gen) -> dict:
    """The block chain's stages alone on random inputs at its shapes: the
    wgmma GEMM at the q/kv, Wo and (tb > 0) bypass shapes (``gemm_ms``),
    the head-folded attention kernel (``attention_ms``), and, as
    yardsticks the port never calls, one F.scaled_dot_product_attention
    on the folded (b, 1, n_head·ts, hd) query against the shared K/V
    (``attention_library_ms``)."""
    import ctypes

    import torch.nn.functional as F

    from image2text_torch.ops import _build
    from image2text_torch.ops.fused_block import _attention, _gemm

    dev, bf = w.w_o.device, torch.bfloat16
    d = w.w_o.shape[0]
    hd = d // w.n_head
    lib = _build.load("fused_block")
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    a = torch.randn(b * ts, d, device=dev, dtype=bf, generator=gen)
    a_b = torch.randn(b * max(tb, 1), d, device=dev, dtype=bf, generator=gen)
    qkv = torch.randn(b * ts, d + 2 * hd, device=dev, dtype=bf,
                      generator=gen)
    c_qkv, c_o = torch.empty_like(qkv), torch.empty_like(a)
    c_b = torch.empty_like(a_b)

    def gemms():
        _gemm(lib, st, a, None, ts, w.w_qkv, w.b_qkv, None, None, ts, c_qkv,
              ts, 0, b, ts)
        _gemm(lib, st, a, None, ts, w.w_o, w.b_o, a, None, ts, c_o, ts, 0, b,
              ts)
        if tb:
            _gemm(lib, st, a_b, None, tb, w.w_n, w.b_n, a_b, None, tb, c_b,
                  tb, 0, b, tb)

    q = qkv[:, :d].reshape(b, ts, w.n_head, hd).transpose(1, 2).reshape(
        b, 1, w.n_head * ts, hd).contiguous()
    k = qkv[:, None, d:d + hd].reshape(b, ts, 1, hd).transpose(1, 2)
    v = qkv[:, None, d + hd:].reshape(b, ts, 1, hd).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    return dict(
        gemm_ms=cuda_ms(torch, gemms),
        attention_ms=cuda_ms(torch, lambda: _attention(lib, st, qkv, b, ts,
                                                       w.n_head, hd)),
        attention_library_ms=cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v)))


def phase_lm_head(torch, rows: int = BATCH):
    """The tied lm_head (``ops/functions.py::dot_f32``: bf16 products,
    f32 sums and logits) at ``rows`` decode rows and the flagship's and
    GPT-2-medium's vocab widths: its time, both cuBLAS formulations it
    picks between by the width's parity (direct; transposed and copied
    back), and the f32 formulation it replaced."""
    from image2text_torch.ops.functions import dot_f32

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.randn(rows, 1024, device="cuda", generator=gen).to(
        torch.bfloat16)
    for vocab in (50258, 50259):
        w = (0.02 * torch.randn(vocab, 1024, device="cuda", generator=gen)
             ).to(torch.bfloat16)
        ms = {
            "dot_f32": cuda_ms(torch, lambda: dot_f32(x, w)),
            "direct": cuda_ms(torch, lambda: torch.mm(
                x, w.t(), out_dtype=torch.float32)),
            "transposed": cuda_ms(torch, lambda: torch.mm(
                w, x.t(), out_dtype=torch.float32).t().contiguous()),
            "f32_copies": cuda_ms(torch, lambda: torch.mm(
                x.float(), w.float().t()))}
        err = float((dot_f32(x, w) - x.float() @ w.float().t()).abs().max())
        log(f"    lm_head {rows} x 1024 x {vocab}: dot_f32 "
            f"{ms['dot_f32']:.4f} ms (direct {ms['direct']:.4f}, transposed "
            f"+ copy {ms['transposed']:.4f}); the f32 formulation it "
            f"replaced {ms['f32_copies']:.4f}; max |difference| {err:.3g}")


# The chain attention's sensitivity cases: (keys t, score standard
# deviation); its q/k/v rows are N(0, std) so that q·k/sqrt(hd) has that
# standard deviation.
SENSITIVITY_CASES = tuple((t, std) for t in (160, 320) for std in (1, 2, 4))


def mqa_case(torch, b: int, t: int, n_head: int, hd: int, score_std: float,
             gen):
    """qkv rows (b·t, (n_head + 2)·hd) in bf16 whose scores have standard
    deviation ``score_std``, and their q (b, n_head, t, hd), k and v (b, 1,
    t, hd)."""
    qkv = (torch.randn(b * t, (n_head + 2) * hd, device="cuda",
                       generator=gen) * math.sqrt(score_std)
           ).to(torch.bfloat16)
    q3 = qkv.reshape(b, t, -1)
    q = q3[..., :n_head * hd].reshape(b, t, n_head, hd).transpose(1, 2)
    k = q3[..., None, n_head * hd:(n_head + 1) * hd].transpose(1, 2)
    v = q3[..., None, (n_head + 1) * hd:].transpose(1, 2)
    return qkv, q, k, v


def phase_attention_sensitivity(torch, results, b: int = 8):
    """The encoder chain's head-folded attention (8 heads, head dim 128) at
    ``SENSITIVITY_CASES``: its worst element error against ``sdpa`` beside
    the sensitivity of the reference's own bf16 score rounding
    (``kernel_check.attention_sensitivity``).  An error above twice that
    sensitivity is a kernel fault and fails the phase."""
    import ctypes

    from image2text_torch.ops import _build
    from image2text_torch.ops.fused_block import _attention
    from image2text_torch.utils import kernel_check

    lib = _build.load("fused_block")
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    h, hd, rows = 8, 128, []
    for t, std in SENSITIVITY_CASES:
        qkv, q, k, v = mqa_case(torch, b, t, h, hd, std, gen)
        got = _attention(lib, st, qkv, b, t, h, hd).reshape(
            b, t, h, hd).transpose(1, 2)
        e = kernel_check.attention_sensitivity(got, q, k, v)
        rows.append(dict(t=t, score_std=std, **e))
        log(f"    mqa_attention b={b} t={t} score std {std}: kernel vs sdpa "
            f"{e['kernel_vs_sdpa']:.6g}, kernel vs f64 "
            f"{e['kernel_vs_f64']:.6g}; the reference's sensitivity: sdpa vs "
            f"f64 {e['sdpa_vs_f64']:.6g}, reordered sums vs f64 "
            f"{e['reordered_vs_f64']:.6g} (kernel at "
            f"{e['kernel_vs_sdpa'] / e['sensitivity']:.3g}x, limit 2x)")
        if e["kernel_vs_sdpa"] > 2 * e["sensitivity"]:
            raise AssertionError(f"mqa_attention t={t} score std {std}: "
                                 f"error beyond twice the sensitivity {e}")
    results["sparse_block"]["sensitivity"] = rows


def kernel_row(results, name, tag, source, replaces, row, **shape):
    """Keep a kernel's measurements: its row (``tag`` None) or one of its
    ``<tag>_shape`` entries."""
    if tag is None:
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, **row)
    else:
        results.setdefault(name, {"name": name})[f"{tag}_shape"] = dict(
            **shape, **row)


def phase_front_kernel(torch, model, images, results, tag=None):
    """fused_frontend against its plain version on ``model``'s patch stream
    of ``images``, and torch.matmul of the projector alone as a
    yardstick the port never calls."""
    from image2text_torch.ops.fused_frontend import (fused_frontend,
                                                     fused_frontend_plain)

    enc = model.vision_encoder
    x = enc.feature_extractor(images)
    x = x.reshape(x.shape[0], enc.n_patches ** 2, enc.input_d)
    w = enc.frontend_weights(x.dtype)
    b, t, din = x.shape
    d, n_cls = w.w_p.shape[1], w.cls.shape[0]
    got = fused_frontend(x, w)
    want = fused_frontend_plain(x, w)
    torch.cuda.synchronize()
    err = compare(f"fused_frontend b={b} t={t} din={din} d={d} n_cls={n_cls}",
                  got, want)
    if not torch.equal(got[:, :n_cls], want[:, :n_cls]):
        raise AssertionError("fused_frontend: CLS rows differ")
    del got, want
    ms = cuda_ms(torch, lambda: fused_frontend(x, w))
    plain = cuda_ms(torch, lambda: fused_frontend_plain(x, w))
    lib = cuda_ms(torch, lambda: torch.matmul(x, w.w_p))
    # the projector's products on the tensor cores; the two slab norms'
    # few operations per element are far below them
    flops = 2 * b * t * din * d
    n_bytes = nbytes(x, *w) + b * (n_cls + t) * d * x.element_size()
    bms, by = bound_ms(n_bytes, flops)
    log(f"  fused_frontend: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} "
        f"MB; kernel at {bms / ms:.3f} of it), torch.matmul of the projector "
        f"alone {lib:.4f} ms")
    kernel_row(results, "fused_frontend", tag,
               "image2text_torch/csrc/fused_frontend.cu",
               "image2text_tpu/ops/fused_frontend.py:45",
               dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib), b=b, t=t, din=din, d=d)


def phase_dense_kernel(torch, model, args, results):
    """fused_block (the eval dense block) against its plain version, run
    on the kernel's own expert routes, at block 2 of the dense twin's
    encoder on the serving batch; the block's two projections and its
    attention, one PyTorch call each, as a yardstick."""
    import torch.nn.functional as F

    from image2text_torch.ops.fused_block import fused_block, fused_block_plain

    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    _, x, _ = block_input(torch, model, gen)
    w = model.vision_encoder.blocks[2].block_weights(bf)
    b, t, d = x.shape
    n, e, k = b * t, w.fc.e, w.fc.k
    got, want, rk, gv = run_pair(torch, fused_block, fused_block_plain, (x, w),
                                 n, e)
    err = compare(f"fused_block b={b} t={t} d={d}", got, want, rk, gv, k)
    # the FFN term at the residual's size, as for sparse_block
    w64 = w._replace(proj=w.proj._replace(l2w=w.proj.l2w * 64,
                                          l2b=w.proj.l2b * 64))
    got, want, rk, gv = run_pair(torch, fused_block, fused_block_plain,
                                 (x, w64), n, e)
    compare("fused_block, FFN output weights x64", got, want, rk, gv, k)
    del got, want, w64
    ms = cuda_ms(torch, lambda: fused_block(x, w))
    plain = cuda_ms(torch, lambda: fused_block_plain(x, w))
    hd = d // w.n_head
    ffn_flops, _ = moe_flops_bytes(x.reshape(n, d), w.fc, w.proj)
    flops = (2 * n * d * (d + 2 * hd) + 4 * b * w.n_head * t * t * hd
             + 2 * n * d * d + ffn_flops)
    wbytes = sum(nbytes(getattr(w, f)) for f in w._fields[:8]) + nbytes(
        w.fc, w.proj)
    bms, by = bound_ms(2 * nbytes(x) + wbytes, flops)
    a = torch.randn(n, d, device=dev, dtype=bf, generator=gen)
    q = torch.randn(b, w.n_head, t, hd, device=dev, dtype=bf, generator=gen)
    kv = torch.randn(b, 1, t, hd, device=dev, dtype=bf, generator=gen)
    lib = cuda_ms(torch, lambda: (
        torch.matmul(a, w.w_qkv), torch.matmul(a, w.w_o),
        F.scaled_dot_product_attention(q, kv, kv, enable_gqa=True)))
    stages = chain_stage_ms(torch, w, b, t, 0, gen)
    if args.profile:
        log("  device time by kernel, one fused_block call:")
        device_profile(torch, lambda: fused_block(x, w), top=8)
    log(f"  fused_block: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP; kernel at "
        f"{bms / ms:.3f} of it), torch.matmul at its two projections + "
        f"SDPA {lib:.4f} ms; its two GEMMs alone {stages['gemm_ms']:.4f} "
        f"ms, attention kernel {stages['attention_ms']:.4f} ms, SDPA on "
        f"the head-folded query {stages['attention_library_ms']:.4f} ms")
    kernel_row(results, "fused_block", None,
               "image2text_torch/csrc/fused_block.cu",
               "image2text_tpu/ops/fused_block.py:105",
               dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, **stages))


def phase_topk_kernel(torch, results, ids, ngrams, vocab: int, tag=None,
                      k: int = 16):
    """topk_ban_mask's kernel against its reference, bit for bit, on
    (rows, vocab) f32 logits drawn from the seed with the n-gram bans of a
    real decode buffer ``ids`` (rows, L) after its last step (one column
    per window and n-gram size, -1 where nothing is banned);
    torch.topk(x, k) as a yardstick."""
    from image2text_torch.models.sampling import _ngram_bans
    from image2text_torch.ops.topk_mask import (topk_ban_mask,
                                                topk_ban_mask_reference)

    rows, cur = ids.shape
    gen = torch.Generator(device=ids.device).manual_seed(SEED + 8)
    x = 2 * torch.randn(rows, vocab, device=ids.device, generator=gen)
    cand, ban = _ngram_bans(ids, cur, ngrams)
    banned = torch.where(ban, cand, -1).to(torch.int32)
    got = topk_ban_mask(x, banned, k)
    want = topk_ban_mask_reference(x, banned, k)
    torch.cuda.synchronize()
    live = (banned >= 0).sum(-1)
    fin = torch.isfinite(want)
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float((got[fin] - want[fin]).abs().max())
    log(f"  topk_ban_mask rows={rows} V={vocab} k={k} M={banned.shape[1]} "
        f"(live bans per row: max {int(live.max())}, mean "
        f"{float(live.float().mean()):.2f}): bit-for-bit equal {same}, "
        f"-inf patterns equal {torch.equal(torch.isinf(got), ~fin)}, "
        f"max_abs_err {err}, kept per row {int(fin.sum(-1).min())}.."
        f"{int(fin.sum(-1).max())}")
    if not same or err != 0:
        raise AssertionError("topk_ban_mask: kernel differs from reference")
    ms = cuda_ms(torch, lambda: topk_ban_mask(x, banned, k), iters=20)
    plain = cuda_ms(torch, lambda: topk_ban_mask_reference(x, banned, k),
                    iters=20)
    lib = cuda_ms(torch, lambda: torch.topk(x, k), iters=20)
    # each row read and written once; 32 bisection rounds of one compare
    # per element on the CUDA cores
    n_bytes = 2 * nbytes(x) + nbytes(banned)
    bms, by = bound_ms(n_bytes, 32 * rows * vocab, F32_OP_PER_S)
    log(f"  topk_ban_mask: kernel {ms:.4f} ms, reference {plain:.4f} ms, "
        f"bound {bms:.5f} ms ({by}; {n_bytes / 1e6:.1f} MB; kernel at "
        f"{bms / ms:.3f} of it), torch.topk(x, {k}) {lib:.4f} ms")
    kernel_row(results, "topk_ban_mask", tag,
               "image2text_torch/csrc/topk_mask.cu",
               "image2text_tpu/ops/topk_mask.py:91",
               dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib), rows=rows, V=vocab, k=k,
               M=banned.shape[1])


def phase_kernels(torch, model, args, results, tag=None):
    """The serving kernels against their plain versions at ``model``'s
    shapes: the flagship's rows (``tag`` None), or another model's encoder
    shapes, kept under ``<tag>_shape`` in the rows."""
    from image2text_torch.ops.fused_block import (sparse_block,
                                                  sparse_block_plain)
    from image2text_torch.ops.fused_moe import moe_ffn, moe_ffn_plain

    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    enc = model.vision_encoder
    images, x, layout = block_input(torch, model, gen)
    phase_front_kernel(torch, model, images, results, tag)
    blk = enc.blocks[2]
    b, t, d = x.shape
    rows_sel, rows_byp = blk.layout_rows(layout, t, dev)
    w = blk.block_weights(bf)
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
    stages = chain_stage_ms(torch, w, b, ts, tb, gen)
    if args.profile:
        log("  device time by kernel, one sparse_block call:")
        device_profile(torch, lambda: sparse_block(x, rows_sel, rows_byp, w),
                       top=8)
    log(f"  sparse_block: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP), torch.matmul at its "
        f"GEMM shapes {lib:.4f} ms; its three GEMMs alone "
        f"{stages['gemm_ms']:.4f} ms ({stages['gemm_ms'] / lib:.3f} x "
        f"torch.matmul), attention kernel {stages['attention_ms']:.4f} ms, "
        f"SDPA on the head-folded query "
        f"{stages['attention_library_ms']:.4f} ms")
    kernel_row(results, "sparse_block", tag,
               "image2text_torch/csrc/fused_block.cu",
               "image2text_tpu/ops/fused_block.py:118",
               dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, **stages), b=b, t=t,
               t_sel=ts, d=d)

    # decode: a decoder block's FFN on its 256 rows; encoder: the sparse
    # block's FFN stage (LN2 prologue) on its b·t_sel rows, held at the
    # FFN term's own scale
    cases = [("encoder", blk.mlp, b * ts, dict(ln_w=w.ln2_w, ln_b=w.ln2_b))]
    if tag is None:
        cases.insert(0, ("decode", model.decoder.blocks[0].mlp, BATCH, {}))
    for label, mlp, rows, ln in cases:
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
            key = "encoder_shape" if tag is None else f"{tag}_encoder_shape"
            results.setdefault("moe_ffn", {"name": "moe_ffn"})[key] = dict(
                rows=rows, hidden=hidden, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


MOE_SWEEP_ROWS = (256, 512, 1024, 2048, 4096, 8192, 40960)


def phase_moe_regimes(torch, model, results):
    """moe_ffn's two regimes at the encoder's FFN widths (1024 → 2048),
    each forced at every row count of MOE_SWEEP_ROWS: the many-rows kernel
    (no split) and the hidden split with the slices the few-rows rule
    gives (past FEW_ROWS, those at FEW_ROWS rows): where the switch point
    FEW_ROWS should lie."""
    from image2text_torch.ops.fused_moe import (FEW_ROWS, launch_moe_ffn,
                                                moe_slices)
    from image2text_torch.utils.device import sm_count

    mlp = model.vision_encoder.blocks[2].mlp
    bf = torch.bfloat16
    fc, proj = mlp.c_fc.packed(bf), mlp.c_proj.packed(bf)
    hidden = fc.l2w.shape[1]
    gen = torch.Generator(device=model.device).manual_seed(SEED + 12)
    sweep, n_sms = [], sm_count(model.device)
    for n in MOE_SWEEP_ROWS:
        x = torch.randn(n, fc.wa.shape[0], device=model.device, dtype=bf,
                        generator=gen)
        out = torch.empty_like(x)
        split = moe_slices(min(n, FEW_ROWS), hidden, n_sms)
        many = cuda_ms(torch, lambda: launch_moe_ffn(x, fc, proj, out,
                                                     slices=1), iters=20)
        few = cuda_ms(torch, lambda: launch_moe_ffn(x, fc, proj, out,
                                                    slices=split), iters=20)
        sweep.append(dict(rows=n, many_ms=many, split_ms=few, slices=split,
                          picked=moe_slices(n, hidden, n_sms)))
        log(f"  moe_ffn regimes rows={n} hidden={hidden}: many-rows kernel "
            f"{many:.4f} ms, hidden split in {split} {few:.4f} ms; the "
            f"wrapper picks {moe_slices(n, hidden, n_sms)} slice(s) (FEW_ROWS "
            f"{FEW_ROWS})")
    results.setdefault("moe_ffn", {"name": "moe_ffn"})["regimes"] = sweep


def phase_probes(torch, results):
    """The two block probes (image2text_torch/probes/) at batch 64: every
    variant held against its plain chain or the whole batch, and timed."""
    from image2text_torch.ops.fused_block import fused_block_plain
    from image2text_torch.probes import block_ablate, block_wide

    for name, mod, replaces, held in (
            ("block_ablate_probe", block_ablate,
             "tools/block_ablate_probe.py:134",
             "its plain chain with the same substitutions"),
            ("block_wide_probe", block_wide, "tools/block_wide_probe.py:100",
             "the whole batch in one launch")):
        # ms: the shipping chain (full / the whole batch); the probe's
        # variants under variants_ms
        out = mod.main(PROBE_BATCH)
        variants = {v: out[f"{v}_ms"] for v in mod.VARIANTS}
        errs = [out[f"{v}_max_abs_err"] for v in mod.VARIANTS]
        extra = "".join(f"; {v} held {out[f'{v}_held']}"
                        for v in mod.VARIANTS if f"{v}_held" in out)
        log(f"  {name} (batch {PROBE_BATCH}, t 160, d 1024; the TPU probe "
            f"ran batch 256): "
            + ", ".join(f"{v} {t:.4f} ms" for v, t in variants.items())
            + (f", whole batch {out['whole_ms']:.4f} ms"
               if "whole_ms" in out else "")
            + f"; max_abs_err against {held} {max(errs):.6g}" + extra)
        results[name] = dict(
            name=name, route="cuda", replaces=replaces,
            source=f"image2text_torch/probes/{mod.__name__.split('.')[-1]}.py",
            variants_ms=variants, max_abs_err=max(errs), **out)
    # the chain's plain version, bound and yardstick at the probe's shapes
    x, w = block_ablate.probe_block(PROBE_BATCH, "cuda")
    b, t, d = x.shape
    plain = cuda_ms(torch, lambda: fused_block_plain(x, w))
    n, hd = b * t, d // w.n_head
    ffn_flops, _ = moe_flops_bytes(x.reshape(n, d), w.fc, w.proj)
    flops = (2 * n * d * (d + 2 * hd) + 4 * b * w.n_head * t * t * hd
             + 2 * n * d * d + ffn_flops)
    wbytes = sum(nbytes(getattr(w, f)) for f in w._fields[:8]) + nbytes(
        w.fc, w.proj)
    bms, by = bound_ms(2 * nbytes(x) + wbytes, flops)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    a = torch.randn(n, d, device="cuda", dtype=torch.bfloat16, generator=gen)
    lib = cuda_ms(torch, lambda: (torch.matmul(a, w.w_qkv),
                                  torch.matmul(a, w.w_o)))
    for name, ms_key in (("block_ablate_probe", "full_ms"),
                         ("block_wide_probe", "whole_ms")):
        results[name].update(ms=results[name][ms_key], plain_ms=plain,
                             bound_ms=bms, bound_by=by, library_ms=lib)
    log(f"  probe chain (b {b}, t {t}): plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}), torch.matmul at its two projections "
        f"{lib:.4f} ms")


def serving_launches(model, n_forwards: int = 1 + MAX_NEW_TOKENS):
    """Launches of each kernel wrapper in one caption call with a one-token
    prompt and ``n_forwards`` one-token decoder forwards at text positions
    0, 1, ... (the prefill, then one per decode step: 1 + MAX_NEW_TOKENS
    for ``generate``, 1 + rounds for beam search), derived from the model:
    one fused_frontend (the encoder front); one sparse_block per sparse
    encoder block that runs its body and one fused_block per dense one
    (the block's MoE FFN runs inside); one moe_ffn per cached forward of a
    scratch-decoder block that runs its body; one int4_matmul per
    quantized Linear per decoder forward."""
    from image2text_torch.models.quantization import QuantizedLinear

    enc, dec = model.vision_encoder, model.decoder
    t = enc.n_cls + enc.n_patches ** 2
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    want["fused_frontend"] = 1
    want["sparse_block"] = sum(blk.is_sparse and blk.runs_body(t)
                               for blk in enc.blocks)
    want["fused_block"] = sum(not blk.is_sparse for blk in enc.blocks)
    if hasattr(dec, "ffn_evaluations"):
        want["moe_ffn"] = sum(dec.ffn_evaluations(model.space_for_prompt + i,
                                                  1)
                              for i in range(n_forwards))
    n_q = sum(isinstance(m, QuantizedLinear) for m in dec.modules())
    want["int4_matmul"] = n_forwards * n_q
    return want


def serving_inputs(torch, model, b: int, seed: int, bos: int):
    """Raw uint8 frames (b, 160, 240, 3) from ``seed`` and the one-token
    prompt ``bos``."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    frames = torch.randint(0, 256, (b, 160, 240, 3), dtype=torch.uint8,
                           device=model.device, generator=gen)
    return frames, torch.full((b, 1), bos, dtype=torch.long,
                              device=model.device)


def phase_serve(torch, model, args, results, path: str, bos: int):
    """A serving path: raw uint8 frames → caption (batch 256, 32 new
    tokens, temperature 0.7, top-k 16, n-grams 2–5): launches of every
    kernel in one caption call, held to ``serving_launches``, and
    captions/s, the median of 3 warm windows."""
    from image2text_torch.models.generation import caption

    dev, b = model.device, BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 2, bos)

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return caption(model, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.7, top_k=16, generator=g)

    ids = drive_serving(torch, args, results, path, run, b,
                        lambda: serving_launches(model), "one caption call")
    vocab = model.decoder.transformer.wte.weight.shape[0]
    if (tuple(ids.shape) != (b, 1 + MAX_NEW_TOKENS)
            or not bool(((ids >= 0) & (ids < vocab)).all())
            or not bool((ids[:, 0] == bos).all())):
        raise AssertionError(f"{path}: ids {tuple(ids.shape)} out of range "
                             "or prompt lost")
    log(f"  sample ids: {ids[0, :12].tolist()}")
    return ids


def drive_serving(torch, args, results, path: str, run, b: int, want,
                  what: str):
    """What every serving phase does with its ``run(seed)``: a warm-up
    call (it builds caches and per-block index tensors), one call with
    every launch count set to 0 just before it, kept under ``path`` and
    held to ``want()`` (read just after it), then captions/s over 3 warm
    windows of one call on ``b`` images each (the median reported) and,
    with ``--profile``, device time by kernel of one more call.  Returns
    the counted call's output."""
    run(0)
    torch.cuda.synchronize()
    counts, out = launch_counts(lambda: run(1))
    record_launches(results, path, counts)
    want = want()
    log(f"  launches in {what}: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"{path} launch counts {counts} != {want}")
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
    if args.profile:
        log(f"  device time by kernel, {what}:")
        device_profile(torch, lambda: run(20))
    return out


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


def phase_parity(torch, model, phase: str, bos: int):
    """At batch 8: the first-step logits (the prefill's last row) and the
    greedy tokens of the kernel path against the plain-version path."""
    from image2text_torch.models.generation import generate, prefill
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    b = 8
    frames, prompt = serving_inputs(torch, model, b, SEED + 3, bos)
    images = resize_normalize_on_device(
        frames, model.config.vision_encoder_config.input.width,
        out_dtype=torch.bfloat16)

    def first_logits():
        return prefill(model, model.encoder(images), prompt,
                       1 + MAX_NEW_TOKENS)[0][:, -1]

    def greedy():
        return generate(model, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                        temperature=0.0)

    got, ids_k = first_logits(), greedy()
    with plain_versions():
        want, ids_p = first_logits(), greedy()
    torch.cuda.synchronize()
    n_layers = len(model.vision_encoder.blocks) + len(model.decoder.blocks)
    rel_l2, err, scale, ok = logits_error(torch, got, want)
    beyond = int(((got - want).abs() > TOL + TOL * want.abs()).sum())
    agree = float((ids_k[:, 1:] == ids_p[:, 1:]).float().mean())
    first = float((ids_k[:, 1] == ids_p[:, 1]).float().mean())
    log(f"  first-step logits (batch {b}, f32 from bf16, {n_layers} layers): "
        f"relative L2 error {rel_l2:.6g}, max_abs_err {err:.6g} (max "
        f"|logit| {scale:.4g}), mean_abs_err "
        f"{float((got - want).abs().mean()):.6g}; elements beyond {TOL} abs"
        f" + {TOL} rel: {beyond} of {got.numel()}")
    log(f"  greedy tokens agreeing: first step {first:.4f}, over "
        f"{MAX_NEW_TOKENS} steps {agree:.4f}")
    if not ok:
        raise AssertionError(f"{phase}: kernel path disagrees with the "
                             "plain path beyond tolerance")


def logits_error(torch, got, want):
    """(relative L2 error, max abs error, max |want|, within the limits) of
    whole-stack logits.  Through 24 bf16 layers, rounding-order differences
    and near-tied MoE gates compound, so the whole-stack check is normwise:
    the relative L2 error and the largest error against the largest logit,
    both within the bf16 tolerance TOL.  (The kernel rows hold each kernel
    elementwise.)"""
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and rel_l2 <= TOL and (
        err <= TOL * scale)
    return rel_l2, err, scale, ok


def beam_generator(model, **kw):
    """bench.py::_bench_beam's generator: beam width 3, expansion 4,
    temperature 0.7, top-k 16, MAX_NEW_TOKENS new tokens, eos 0, the
    model's n-gram sizes, consolidation temperature 1.0 (the class
    default); ``kw`` overrides."""
    from image2text_torch.models.generation_utils import (
        BeamSearchTokenGenerator)

    args = dict(beam_width=3, beam_expansion_factor=4, temperature=0.7,
                top_k=16, max_new_tokens=MAX_NEW_TOKENS,
                eos_token_id=FLAGSHIP_EOS,
                no_repeat_n_grams=tuple(model.no_repeat_n_grams))
    return BeamSearchTokenGenerator(model, **(args | kw))


def phase_beam(torch, model, args, results):
    """The beam-search serving path (bench.py::_bench_beam at batch 64):
    raw uint8 frames → caption; launches in one call held to
    ``serving_launches`` over the rounds it ran, and captions/s, the
    median of 3 warm windows.  Returns the ids (b, beams, T)."""
    dev, b = model.device, BEAM_BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 12,
                                    FLAGSHIP_BOS)
    beam = beam_generator(model)
    bw = beam.beam_width

    def run(seed):
        return beam.caption(frames, prompt,
                            torch.Generator(device=dev).manual_seed(seed))

    rounds = []

    def want():     # the prefill and one decoder forward per round
        rounds.append(beam.rounds)
        return serving_launches(model, 1 + beam.rounds)

    ids, scores = drive_serving(
        torch, args, results, "flagship_beam", run, b, want,
        f"one beam-search call (width {bw} x expansion "
        f"{beam.beam_expansion_factor}: {bw * b} decode rows)")
    vocab = model.decoder.transformer.wte.weight.shape[0]
    if (tuple(ids.shape) != (b, bw, MAX_NEW_TOKENS)
            or tuple(scores.shape) != (b, bw)
            or not bool(((ids >= 0) & (ids < vocab)).all())
            or not bool((ids[:, :, 0] == FLAGSHIP_BOS).all())
            or not bool(torch.isfinite(scores).all())):
        raise AssertionError(f"beam: ids {tuple(ids.shape)} or scores "
                             f"{tuple(scores.shape)} malformed")
    log(f"  rounds in the counted call: {rounds[0]}; sample beams: "
        f"{ids[0, :, :10].tolist()}, scores "
        f"{[round(float(s), 4) for s in scores[0]]}")
    return ids


def phase_beam_parity(torch, model):
    """At batch 8, greedy beam search (temperature 0, consolidation 0) on
    the kernel path and on the plain-version path, every round's scorer
    input recorded.  A greedy beam keeps its beams identical: it is greedy
    decoding scored by the beam scorer.  Wherever a row's history is the
    same on both paths (every row in round 0), its last logits are held as
    ``phase_parity`` holds the first-step logits, the log-scores of the
    candidate ids both paths propose differ by at most BEAM_SCORE_TOL, and
    each path's best candidate is among the other's.  Then, as a report,
    the rounds each sample's ids stayed equal, and where they parted the
    near-tie margin: how far the plain logits put the plain choice ahead
    of the kernel path's, beside the two paths' logit differences at
    those two ids (with identical beams, greedy choices part only where
    the margin lies within them)."""
    frames, prompt = serving_inputs(torch, model, 8, SEED + 13,
                                    FLAGSHIP_BOS)
    runs = []
    for plain in (False, True):
        beam = beam_generator(model, temperature=0.0,
                              consolidation_temperature=0.0)
        rounds, candidates = [], beam._candidates

        def record(last, ids_flat, cur_len, generator, rounds=rounds,
                   candidates=candidates):
            out = candidates(last, ids_flat, cur_len, generator)
            rounds.append((ids_flat[:, :cur_len].clone(), last.float(),
                           *out))
            return out

        beam._candidates = record
        with plain_versions() if plain else contextlib.nullcontext():
            counts, (ids, scores) = launch_counts(
                lambda: beam.caption(frames, prompt))
        runs.append((ids, scores, rounds, sum(counts.values())))
    (ik, sk, rk, nk), (ip, _, rp, npl) = runs
    bs, t0 = ik.shape[0], prompt.shape[-1]
    ok, rows, rel_max, err_max, gap_max, first = True, 0, 0.0, 0.0, 0.0, None
    for r, ((hk, lk, idk, lsk), (hp, lp, idp, lsp)) in enumerate(zip(rk, rp)):
        same = (hk == hp).all(-1)
        if r == 0:
            ok &= bool(same.all())
        if not bool(same.any()):
            continue
        rel, err, scale, within = logits_error(torch, lk[same], lp[same])
        first = first or (rel, err, scale)
        ok &= within
        idk, lsk, idp, lsp = idk[same], lsk[same], idp[same], lsp[same]
        both = idk[:, :, None] == idp[:, None, :]
        gap = float((lsk[:, :, None] - lsp[:, None, :]).abs()[both].max())
        ok &= gap <= BEAM_SCORE_TOL
        ok &= bool((idk[:, :1] == idp).any(-1).all()
                   and (idp[:, :1] == idk).any(-1).all())
        rel_max, err_max = max(rel_max, rel), max(err_max, err)
        gap_max, rows = max(gap_max, gap), rows + int(same.sum())
    equal_rounds, partings = [], []
    for s in range(bs):
        differ = (ik[s] != ip[s]).any(0).nonzero()
        equal_rounds.append(int(differ[0]) - t0 if len(differ) else len(rk))
        if not len(differ):
            continue
        pos = int(differ[0])
        ck, cp = int(ik[s, 0, pos]), int(ip[s, 0, pos])
        lk, lp = rk[pos - t0][1][s], rp[pos - t0][1][s]
        partings.append((s, pos - t0, round(float(lp[cp] - lp[ck]), 6),
                         round(float((lk[cp] - lp[cp]).abs()
                                     + (lk[ck] - lp[ck]).abs()), 6)))
    identical = all(bool((i == i[:, :1]).all()) for i in (ik, ip))
    log(f"  greedy beam (batch {bs}, width 3, expansion 4, top-k 16, "
        f"{MAX_NEW_TOKENS} new tokens): {len(rk)} / {len(rp)} rounds; round "
        f"0 last logits: relative L2 error {first[0]:.6g}, max_abs_err "
        f"{first[1]:.6g} (max |logit| {first[2]:.4g}); over {rows} "
        f"beam-rounds with the same history: logits relative L2 at most "
        f"{rel_max:.6g}, max_abs_err at most {err_max:.6g} (limits {TOL}, "
        f"{TOL} x max |logit|), candidate log-scores within {gap_max:.6g} "
        f"(limit {BEAM_SCORE_TOL} per round); kernel launches {nk} on the "
        f"kernel path, {npl} on the plain one")
    log(f"  beams identical within each path: {identical}; rounds with "
        f"equal ids per sample: {equal_rounds}; partings (sample, round, "
        f"plain logit of the plain choice minus that of the kernel path's, "
        f"the paths' logit differences at the two ids summed): {partings}")
    if (not ok or nk == 0 or npl != 0 or rows == 0
            or not bool(torch.isfinite(sk).all())):
        raise AssertionError("beam-parity: kernel path disagrees with the "
                             "plain-version path beyond tolerance")


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.fused_block import fused_block, sparse_block
    from image2text_torch.ops.fused_frontend import fused_frontend
    from image2text_torch.ops.fused_moe import moe_ffn
    from image2text_torch.ops.int4_matmul import int4_matmul
    from image2text_torch.ops.topk_mask import topk_ban_mask

    return (sparse_block, moe_ffn, fa.flash_fwd, fa.flash_bwd, int4_matmul,
            fused_frontend, fused_block, topk_ban_mask)


def launch_counts(run):
    """{wrapper name: launches} over ``run()``, every count set to 0 just
    before it and read just after (the device synchronised)."""
    import torch

    kernels = kernel_wrappers()
    for kern in kernels:
        kern.launches = 0
    out = run()
    torch.cuda.synchronize()
    return {kern.__name__: kern.launches for kern in kernels}, out


def record_launches(results, path: str, counts) -> None:
    """Keep ``counts`` under each kernel's ``launches_by_path``; its
    ``launches`` is the count of the first path that launched it (the
    flagship's caption call, the flagship's step, then the GPT-2-medium
    caption call, in the order the phases run)."""
    for name, n in counts.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("launches_by_path", {})[path] = n
        if n and "launches" not in entry:
            entry["launches"] = n


def soft_prompt_bias(torch, s: int, n_prefix: int, dev):
    """(1, 1, s, s) f32: 0, but -inf from text rows to the prefix (the
    decoder's soft-prompt bias)."""
    bias = torch.zeros(1, 1, s, s, device=dev)
    bias[..., n_prefix:, :n_prefix] = float("-inf")
    return bias


def flash_work(q, k, bias, causal: bool, kind: str):
    """(bytes, FLOP) one flash call must move and do: each input read once
    and each output written once; the products over the (row, col) pairs
    the causal mask leaves.  ``kind`` fwd: S, PV; bwd (dQ, dK and dV
    together, each product counted once): S, dP, dV, dK, dQ."""
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
    return ins + qb + 2 * kb, 5 * mm     # → dq, dk, dv


# Training attention calls: (label, b, h, K/V heads, sq, skv, head dim,
# causal, soft-prompt prefix length or None, dropout rate).
FLASH_FLAGSHIP = (
    ("encoder", TRAIN_BATCH, 8, 1, 160, 160, 128, False, None, DROPOUT),
    ("decoder", TRAIN_BATCH, 8, 1, 136, 136, 128, True, 32, DROPOUT))
FLASH_GPT2M = (   # batch 12: the sparse encoder, GPT-2's self and cross
    ("gpt2m_encoder", 12, 8, 1, 80, 80, 64, False, None, DROPOUT),
    ("gpt2m_self", 12, 16, 16, 112, 112, 64, True, None, 0.0),
    ("gpt2m_cross", 12, 16, 16, 112, 64, 64, False, None, 0.0))
# Keys past the resident route's limit (ops/flash_attention.py::
# RESIDENT_MAX_KEYS): the tiled backward kernels, at the flagship's width.
FLASH_LONG = (
    ("long_keys", 4, 8, 1, 256, 1024, 128, True, None, DROPOUT),)


def sdpa_times(torch, q, k, v, dout, mask, rate: float) -> dict:
    """ms of one F.scaled_dot_product_attention call (the yardstick the
    port never calls): forward, forward + backward, and the backward alone
    (autograd.grad over one retained forward graph)."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd(a=q, b=k, c=v):
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              dropout_p=rate, enable_gqa=True)

    def fwd_bwd():
        with torch.enable_grad():
            fwd(qg, kg, vg).backward(dout)

    with torch.enable_grad():
        out = fwd(qg, kg, vg)
    bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dout, retain_graph=True))
    return {"fwd": cuda_ms(torch, fwd), "fwd_bwd": cuda_ms(torch, fwd_bwd),
            "bwd": bwd}


def phase_flash_kernels(torch, args, results, cases=FLASH_FLAGSHIP):
    """The flash forward and the flash backward against their plain
    versions at training attention shapes, same inputs and dropout seed;
    the backward twice more, bitwise equal; on the resident route its
    visited (query tile, key slice) pairs held to ``bwd_pairs`` (the tiled
    route counts none).  The first
    flagship case fills the kernels' rows, every other case a
    ``<label>_shape``."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    seed = -987654321
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in cases:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen
                                     ).to(bf)
                         for shape in ((b, h, sq, d), (b, hk, s, d),
                                       (b, hk, s, d), (b, h, sq, d)))
        bias = None if n_prefix is None else soft_prompt_bias(torch, s,
                                                              n_prefix, dev)
        a = (q, k, v, bias, causal)
        out, lse = fa.flash_fwd(*a, rate, seed)
        want, want_lse = fa.flash_forward_plain(*a, rate, seed)
        dvec = (dout.float() * want.float()).sum(-1)
        g = (dout, want_lse, dvec, rate, seed)
        pairs = torch.zeros(1, dtype=torch.int32, device=dev)
        got = fa.flash_bwd(*a, *g, pairs=pairs)
        again = [fa.flash_bwd(*a, *g) for _ in range(2)]
        plain = fa.flash_backward_plain(*a, *g)
        torch.cuda.synchronize()
        shape = (f"b={b} h={h} hk={hk} sq={sq} skv={s} d={d} causal={causal} "
                 f"bias={None if bias is None else tuple(bias.shape)} "
                 f"dropout={rate}")
        errs = {"fwd": compare(f"flash_fwd out {label} {shape}", out, want)}
        compare(f"flash_fwd lse {label}", lse, want_lse)
        errs["bwd"] = max(compare(f"flash_bwd {n} {label}", x, y)
                          for n, x, y in zip(("dq", "dk", "dv"), got, plain))
        same = all(torch.equal(x, y) for run in again
                   for x, y in zip(got, run))
        fwd_route, fwd_groups = fa.fwd_plan(b, h, hk, sq, s, n_sms)
        regs, spills = _build.resources("flash_attention", (
            "flash_fwd_res_kernel" if fwd_route == "resident"
            else "flash_fwd_kernel") + f"ILi{d}E")
        log(f"    flash_fwd {label}: route {fwd_route}, G {fwd_groups}; "
            f"{regs} registers, {spills} bytes spilled a thread")
        route, groups = fa.bwd_plan(b, h, hk, sq, s, n_sms)
        resident = route == "resident"
        want_pairs = fa.bwd_pairs(b, h, sq, s, causal) if resident else 0
        full = fa.bwd_pairs(b, h, sq, s, False) if resident else 0
        log(f"    flash_bwd {label}: route {route}, G {groups}; two more "
            f"launches bitwise equal: {same}; ({fa.BWD_TILE_ROWS}-row query "
            f"tile, {fa.BWD_KEY_SLICE}-key slice) pairs visited {int(pairs)} "
            f"(want {want_pairs}; {full} without the causal skip)")
        if not same or int(pairs) != want_pairs:
            raise AssertionError(f"flash_bwd {label}: not deterministic or "
                                 f"pairs {int(pairs)} != {want_pairs}")
        del out, lse, got, again, plain
        ms = {"fwd": cuda_ms(torch, lambda: fa.flash_fwd(*a, rate, seed)),
              "bwd": cuda_ms(torch, lambda: fa.flash_bwd(*a, *g))}
        plain_ms = {"fwd": cuda_ms(torch, lambda: fa.flash_forward_plain(
            *a, rate, seed)),
            "bwd": cuda_ms(torch, lambda: fa.flash_backward_plain(*a, *g))}
        mask = None   # the yardstick's bf16 mask: bias and causal folded
        if bias is not None or causal:
            mask = ((0 if bias is None else bias) + (
                causal_bias(sq, s, dev) if causal else 0)).to(bf)
        lib = sdpa_times(torch, q, k, v, dout, mask, rate)
        log(f"  flash {label}: fwd {ms['fwd']:.4f} ms (plain "
            f"{plain_ms['fwd']:.4f}, SDPA {lib['fwd']:.4f}), bwd (dq dk dv) "
            f"{ms['bwd']:.4f} ms (plain {plain_ms['bwd']:.4f}; SDPA backward "
            f"alone {lib['bwd']:.4f}, forward + backward "
            f"{lib['fwd_bwd']:.4f})")
        for kind, line in (("fwd", "181"), ("bwd", "362 + :400")):
            name = f"flash_{kind}"
            n_bytes, flops = flash_work(q, k, bias, causal, kind)
            bms, by = bound_ms(n_bytes, flops)
            log(f"    {name} {label}: bound {bms:.5f} ms ({by}; "
                f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB), kernel "
                f"at {bms / ms[kind]:.3f} of it")
            row = dict(max_abs_err=errs[kind], ms=ms[kind],
                       plain_ms=plain_ms[kind], bound_ms=bms, bound_by=by,
                       library_ms=lib[kind])
            if kind == "bwd":
                row.update(library_bwd_ms=lib["bwd"],
                           library_fwd_bwd_ms=lib["fwd_bwd"],
                           pairs=int(pairs), groups=groups)
            else:
                row.update(plan_route=fwd_route, groups=fwd_groups,
                           registers=regs, spill_bytes=spills)
            if label == "encoder":
                stored = results[name] = dict(
                    name=name, route="cuda",
                    source="image2text_torch/csrc/flash_attention.cu",
                    replaces=f"image2text_tpu/ops/flash_attention.py:{line}",
                    **row)
            else:
                stored = results.setdefault(name, {"name": name})[
                    f"{label}_shape"] = dict(b=b, h=h, hk=hk, sq=sq, skv=s,
                                             d=d, causal=causal, **row)
            if kind == "fwd":
                defer_device_ms(f"flash_fwd {label}", stored,
                                lambda a=a, r=rate: fa.flash_fwd(*a, r, seed))


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
    calls = model.sdpa_calls(seq_len)
    return {"flash_fwd": 2 * calls, "flash_bwd": calls}


def train_launches(cfg, model, seq_len: int):
    """Launches of each kernel wrapper in one training step: the flash
    kernels as ``flash_launches_per_step``, one int4_matmul per quantized
    Linear in the forward and again in the checkpoint recompute, and no
    serving kernel."""
    from image2text_torch.models.quantization import QuantizedLinear

    n_q = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    want.update(int4_matmul=2 * n_q,
                **flash_launches_per_step(cfg, model, seq_len))
    return want


def phase_train(torch, args, results, path: str, setup, inputs):
    """A training step at full width and depth (``setup()`` gives the
    config, the wrapper and its Trainer; ``inputs(cfg)`` the batch):
    launches in one step held to ``train_launches``, then 3 windows of 4
    steps on the batch: step ms, tokens/s, peak memory, the loss of every
    step (finite and lower at the end), frozen tensors bitwise unchanged."""
    from image2text_torch.nn.core import frozen_param_paths

    cfg, wrapper, trainer = setup()
    model = wrapper.model
    n_params = sum(p.numel() for p in model.parameters())
    n_trainable = sum(p.numel() for p in model.parameters()
                      if p.requires_grad)
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    frozen = {k: tensors[k].detach().clone()
              for k in frozen_param_paths(model)}
    images, labels = inputs(cfg)
    batch, seq = labels.shape
    step = trainer._train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, metrics = launch_counts(lambda: step(images, labels, cfg.seed,
                                                 0))
    losses = [metrics["train_loss_lm"]]
    record_launches(results, path, counts)
    want = train_launches(cfg, model, seq)
    log(f"  training step ({n_params:,} float parameters, {n_trainable:,} "
        f"trainable, {len(frozen)} frozen tensors; batch {batch} x {seq} "
        f"labels, bf16 compute from f32 masters, gradient checkpointing): "
        f"launches in one step {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"{path} launch counts {counts} != {want}")
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
        f"windows {[round(x * 1e3, 2) for x in windows]}; tokens/s (label "
        f"positions) {batch * seq / step_s:.1f}; peak memory "
        f"{peak:.3f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"  loss by step: {[round(x, 5) for x in losses]}")
    moved = [k for k, v in frozen.items() if not torch.equal(tensors[k], v)]
    log(f"  frozen tensors changed by the steps: {len(moved)} of "
        f"{len(frozen)}")
    if (moved or not all(math.isfinite(x) for x in losses)
            or losses[-1] >= losses[0]):
        raise AssertionError(f"{path}: frozen moved {moved[:3]} or loss not "
                             f"finite or not falling {losses}")
    if args.profile:
        log("  device time by kernel, one training step:")
        device_profile(torch, lambda: step(images, labels, cfg.seed, 99),
                       top=16)
    del trainer, wrapper, model, tensors, frozen
    torch.cuda.empty_cache()


def phase_train_parity(torch, phase: str, setup, inputs, focus):
    """One training step at depth 2 + 2, on the kernels and then on the
    plain versions, from the same weights, seeds and batch: the loss, the
    gradients normwise, and on their own the ones ``focus`` (label, name
    test) picks."""
    from image2text_torch.training.loop import make_train_step
    from image2text_torch.training.optimizer import build_optimizer

    cfg, wrapper, trainer = setup()
    images, labels = inputs(cfg)
    start = {k: v.clone() for k, v in wrapper.state_dict().items()}
    runs = []
    for plain in (False, True):
        wrapper.load_state_dict(start)
        opt, _ = build_optimizer(wrapper, cfg.optimizers, use_snr=True)
        step = make_train_step(wrapper, opt, precision=cfg.precision)

        def one_step():   # the kernels' counts are read around the swap
            with plain_versions() if plain else contextlib.nullcontext():
                return step(images, labels, cfg.seed, 0)

        counts, metrics = launch_counts(one_step)
        grads = {n: p.grad.float().clone()
                 for n, p in wrapper.model.named_parameters()
                 if p.grad is not None}
        runs.append((float(metrics["train_loss_lm"]), grads,
                     sum(counts.values())))
    (lk, gk, nk), (lp, gp, npl) = runs

    def rel_l2(names):
        num = sum(float((gk[n] - gp[n]).square().sum()) for n in names)
        den = sum(float(gp[n].square().sum()) for n in names)
        return math.sqrt(num / den)

    label, picks = focus
    sub = [n for n in gp if picks(n)]
    loss_err = abs(lk - lp) / abs(lp)
    whole, part = rel_l2(list(gp)), rel_l2(sub)
    log(f"  batch {labels.shape[0]}, depth 2 + 2, full width: loss kernels "
        f"{lk:.6f} vs plain {lp:.6f} (relative error {loss_err:.3g}, limit "
        f"{TRAIN_LOSS_TOL}); gradient relative L2 error {whole:.4g} over "
        f"{len(gp)} trainable tensors, {part:.4g} over the {len(sub)} "
        f"{label} ones (limit {TRAIN_GRAD_TOL}); kernel launches {nk} on the "
        f"kernel path, {npl} on the plain one")
    if (set(gk) != set(gp) or nk == 0 or npl != 0 or loss_err > TRAIN_LOSS_TOL
            or whole > TRAIN_GRAD_TOL or part > TRAIN_GRAD_TOL):
        raise AssertionError(f"{phase}: kernel path disagrees with the "
                             "plain-version path beyond tolerance")
    del trainer, wrapper
    torch.cuda.empty_cache()


ATTN_GRADS = ("attention q_proj/kv_proj",
              lambda n: ".attn.q_proj." in n or ".attn.kv_proj." in n)
LORA_GRADS = ("LoRA", lambda n: ".lora_" in n)


# -- the int4 + LoRA GPT-2-medium captioner (gpt2-medium.yaml) ---------------

GPT2M_TRAIN_BATCH = 12   # training_configs/tpu/gpt2-medium.yaml
GPT2M_TRAIN_SEQ = 48     # tools/bench_gpt2_medium_int4.py's label length
GPT2M_EOS = 50256        # GPT-2's <|endoftext|>: EOS and BOS, as the tool


@contextlib.contextmanager
def gpt2_depth(n_layer):
    """Build GPT-2-medium decoders ``n_layer`` deep (None: the table's 24)."""
    from image2text_torch.models.hf_decoders import factory

    saved = factory.GPT2_TABLE["gpt2-medium"]
    if n_layer is not None:
        factory.GPT2_TABLE["gpt2-medium"] = dict(saved, n_layer=n_layer)
    try:
        yield
    finally:
        factory.GPT2_TABLE["gpt2-medium"] = saved


def randomize_gpt2m(torch, model, seed):
    """Random weights that make every stage work: the port's initialisers
    (as the JAX package's) leave the int4 weights and LoRA B zero, so the
    int4 weights get the quantized image of N(0, 0.02) matrices (the import
    path's own step) and LoRA B N(0, 0.02)."""
    from image2text_torch.models.quantization import fill_random_int4

    gen = torch.Generator(device=model.device).manual_seed(seed + 100)
    fill_random_int4(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".lora_B." in name:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def int4_work(lin, x):
    """(bytes, FLOP) of one int4_matmul call on ``x``: x, the packed weight
    and the scales read once, y written once; 2·rows·out·in_pad
    operations."""
    rows = x.numel() // x.shape[-1]
    out_bytes = rows * lin.out_features * x.element_size()
    return (nbytes(x, lin.weight, lin.weight_scales) + out_bytes,
            2 * rows * lin.out_features * lin.in_pad)


def phase_int4_kernels(torch, model, results):
    """int4_matmul against its plain version at the GPT-2-medium decoder's
    four quantized Linear shapes, at the serving batch (256 decode rows)
    and at the training step's rows (12 x 112), bf16 x and the bf16 scales
    the model's cast leaves, with the plan (tile, splits of the input) and
    two more launches bitwise equal; beside it torch.matmul on the weight
    dequantised once to bf16, a yardstick the port never calls."""
    from image2text_torch.ops.int4_matmul import (dequantize_int4,
                                                  int4_matmul,
                                                  int4_matmul_plain, int4_plan)
    from image2text_torch.utils.device import sm_count

    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    blk = model.decoder.blocks[0]
    linears = (("c_attn", blk.attn.c_attn), ("attn_c_proj", blk.attn.c_proj),
               ("c_fc", blk.mlp.c_fc), ("mlp_c_proj", blk.mlp.c_proj))
    train_rows = GPT2M_TRAIN_BATCH * (model.space_for_prompt
                                      + GPT2M_TRAIN_SEQ)
    for phase, rows in (("decode", BATCH), ("train", train_rows)):
        for label, lin in linears:
            packed, scales = lin.weight, lin.weight_scales
            x = torch.randn(rows, lin.in_pad, device=dev, generator=gen).to(bf)
            got = int4_matmul(x, packed, scales)
            want = int4_matmul_plain(x, packed, scales)
            same = all(torch.equal(got, int4_matmul(x, packed, scales))
                       for _ in range(2))
            torch.cuda.synchronize()
            bm, bn, splits = int4_plan(rows, lin.out_features, lin.in_pad,
                                       sm_count(dev))
            shape = (f"rows={rows} in={lin.in_pad} out={lin.out_features} "
                     f"scales {scales.dtype}")
            err = compare(f"int4_matmul {phase} {label} {shape}", got, want)
            log(f"    {phase} {label}: tile {bm} x {bn}, {splits} split(s) of "
                f"the input; two more launches bitwise equal: {same}")
            if not same:
                raise AssertionError(f"int4_matmul {phase} {label}: reruns "
                                     "differ")
            ms = cuda_ms(torch, lambda: int4_matmul(x, packed, scales), 20)
            plain = cuda_ms(torch, lambda: int4_matmul_plain(x, packed,
                                                             scales), 20)
            w16 = dequantize_int4(packed, scales, bf)
            lib = cuda_ms(torch, lambda: torch.matmul(x, w16.t()), 20)
            n_bytes, flops = int4_work(lin, x)
            bms, by = bound_ms(n_bytes, flops)
            log(f"    {phase} {label}: kernel {ms:.4f} ms, plain {plain:.4f} "
                f"ms, bound {bms:.5f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
                f"{n_bytes / 1e6:.2f} MB; kernel at {bms / ms:.3f} of it), "
                f"torch.matmul on the bf16-dequantised weight {lib:.4f} ms")
            row = dict(rows=rows, in_pad=lin.in_pad, out=lin.out_features,
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=lib, tile=[bm, bn],
                       splits=splits, reruns_bitwise_equal=same)
            entry = results.setdefault("int4_matmul",
                                       {"name": "int4_matmul"})
            if "source" not in entry:   # the first row: decode c_attn
                entry.update(
                    route="cuda", source="image2text_torch/csrc/int4_matmul.cu",
                    replaces="image2text_tpu/ops/int4_matmul.py:102",
                    **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})
            entry[f"{phase}_{label}_shape"] = row
            defer_device_ms(f"int4_matmul {phase} {label}", row,
                            lambda x=x, p=packed, sc=scales: int4_matmul(
                                x, p, sc))


def gpt2m_model(torch):
    from image2text_torch.configs.models import GPT2_MEDIUM
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    model = VisionEncoderDecoder(GPT2_MEDIUM, device="cuda").init_weights(SEED)
    return randomize_gpt2m(torch, model, SEED).to(torch.bfloat16).eval()


def gpt2m_train_setup(torch, n_layer=None):
    """gpt2-medium.yaml's training in the form that runs
    (``gpt2_medium_training_config``: accumulation 1, SNRAdam), the tokens
    as tools/bench_gpt2_medium_int4.py sets them, and its Trainer."""
    from image2text_torch.configs.trainer import gpt2_medium_training_config
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    cfg = gpt2_medium_training_config()
    if n_layer is not None:
        cfg.model.vision_encoder_config.n_layer = n_layer
    tok = TokenizerInfo(eos_token_id=GPT2M_EOS, bos_token_id=GPT2M_EOS,
                        mask_token_id=None, vocab_size=50257)
    with gpt2_depth(n_layer):
        wrapper = ModelTrainerWrapper(cfg.model, tok, cfg.trainer,
                                      device="cuda").init_weights(SEED)
    randomize_gpt2m(torch, wrapper.model, SEED)
    return cfg, wrapper, Trainer(cfg, wrapper)


def gpt2m_train_inputs(torch, batch: int, seed: int):
    """Images and labels as tools/bench_gpt2_medium_int4.py makes them:
    8–40 tokens per row, then -100."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 3, 128, 128)).astype(np.float32)
    labels = np.full((batch, GPT2M_TRAIN_SEQ), -100, np.int64)
    for i, n in enumerate(rng.integers(8, 40, batch)):
        labels[i, :n] = rng.integers(3, 50000, n)
    dev = torch.device("cuda")
    return (torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev))


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
    from image2text_torch.configs.models import FLAGSHIP, FLAGSHIP_DENSE
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

    from image2text_torch.probes.block_ablate import build_units

    t0 = time.perf_counter()
    logs = _build.build_all(build_units())
    log(f"[build] {len(logs)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s (every source, and "
        f"fused_block.cu and fused_moe.cu once per probe variant)")
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
        phase_moe_regimes(torch, model, results)
        log("[probes] the block probes: ablations and launch groupings of "
            "the encoder-block chain")
        phase_probes(torch, results)
        log("  flash-attention kernels vs plain versions, same dropout "
            "seed (bf16, the training step's attention shapes)")
        phase_flash_kernels(torch, args, results)
        phase_flash_kernels(torch, args, results, FLASH_LONG)
        log("  the chain attention's error against the sensitivity of the "
            "reference's bf16 score rounding")
        phase_attention_sensitivity(torch, results)
        log("[lm_head] the tied lm_head's product at the serving batch")
        phase_lm_head(torch)
        log("[main] flagship serving path at full width")
        ids = phase_serve(torch, model, args, results, "flagship_caption",
                          FLAGSHIP_BOS)
        vocab = FLAGSHIP.decoder_config.vocab_size
        ngrams = tuple(model.no_repeat_n_grams)
        log("[kernels] topk_ban_mask vs its reference, bans from the caption "
            "call's id buffer")
        phase_topk_kernel(torch, results, ids, ngrams, vocab)
        log("[parity] kernel path vs plain-version path at full width")
        phase_parity(torch, model, "parity", FLAGSHIP_BOS)
        log("[beam] flagship beam-search serving path at full width and "
            "depth")
        ids = phase_beam(torch, model, args, results)
        log("[kernels] topk_ban_mask at the beam's decode rows, bans from "
            "its id buffer")
        phase_topk_kernel(torch, results,
                          ids.transpose(0, 1).reshape(-1, ids.shape[-1]),
                          ngrams, vocab, tag="beam")
        log("[beam-parity] greedy beam search, kernel path vs plain-version "
            "path at full width")
        phase_beam_parity(torch, model)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = VisionEncoderDecoder(FLAGSHIP_DENSE, device="cuda").init_weights(
        SEED).to(torch.bfloat16)
    model.eval()
    log(f"[dense-model] the flagship's dense-encoder twin (every encoder "
        f"block dense, the decoder the flagship's) with random bf16 weights "
        f"built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        log("[kernels] fused_block (the dense eval block) vs plain version "
            "(bf16, the twin's encoder shapes)")
        phase_dense_kernel(torch, model, args, results)
        log("[dense] dense-twin serving path at full width and depth")
        phase_serve(torch, model, args, results, "dense_caption",
                    FLAGSHIP_BOS)
        log("[dense-parity] kernel path vs plain-version path at full width")
        phase_parity(torch, model, "dense-parity", FLAGSHIP_BOS)
    del model
    torch.cuda.empty_cache()
    log("[train] flagship training step at full width and depth")
    phase_train(torch, args, results, "flagship_train_step",
                lambda: train_setup(torch),
                lambda cfg: train_inputs(torch, cfg, TRAIN_BATCH, SEED + 5))
    log("[train-parity] training step, kernel path vs plain-version path")
    phase_train_parity(torch, "train-parity",
                       lambda: train_setup(torch, n_layer=2),
                       lambda cfg: train_inputs(torch, cfg, 8, SEED + 6),
                       ATTN_GRADS)

    t0 = time.perf_counter()
    model = gpt2m_model(torch)
    log(f"[gpt2m-model] int4 + LoRA GPT-2-medium captioner "
        f"(training_configs/tpu/gpt2-medium.yaml: 6-block d-512 sparse "
        f"encoder, 24-layer d-1024 GPT-2 with cross-attention, vocab "
        f"{model.decoder.vocab_eff}) with random bf16 weights built in "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        log("[kernels] int4_matmul vs plain version (bf16, GPT-2-medium "
            "decoder shapes); the serving kernels at its encoder's shapes")
        phase_int4_kernels(torch, model, results)
        phase_kernels(torch, model, args, results, tag="gpt2m")
        log("  flash-attention kernels at the GPT-2-medium training step's "
            "attention shapes")
        phase_flash_kernels(torch, args, results, FLASH_GPT2M)
        log("[gpt2m] GPT-2-medium serving path at full width and depth")
        phase_serve(torch, model, args, results, "gpt2m_caption", GPT2M_EOS)
        log("[gpt2m-parity] kernel path vs plain-version path at full width")
        phase_parity(torch, model, "gpt2m-parity", GPT2M_EOS)
    del model
    torch.cuda.empty_cache()
    log("[gpt2m-train] int4 + LoRA training step at full width and depth")
    phase_train(torch, args, results, "gpt2m_train_step",
                lambda: gpt2m_train_setup(torch),
                lambda cfg: gpt2m_train_inputs(torch, GPT2M_TRAIN_BATCH,
                                               SEED + 10))
    log("[gpt2m-train-parity] training step, kernel path vs plain-version "
        "path")
    phase_train_parity(torch, "gpt2m-train-parity",
                       lambda: gpt2m_train_setup(torch, n_layer=2),
                       lambda cfg: gpt2m_train_inputs(torch, 8, SEED + 11),
                       LORA_GRADS)

    log("[device-times] kernel device times (torch.profiler), taken after "
        "every CUDA-event time of the run")
    run_device_times()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("gemm_ms", "attention_ms", "attention_library_ms", "regimes",
             "variants_ms", "library_bwd_ms", "library_fwd_bwd_ms", "pairs",
             "groups", "plan_route", "registers", "spill_bytes", "device_ms",
             "sensitivity",
             "launches_by_path")
    # a kernel no path launches (topk_ban_mask, the probes) has 0 launches
    kernels = [{k: r.get(k, 0) if k == "launches" else r[k] for k in keys}
               | {k: r[k] for k in extra if k in r}
               | {k: v for k, v in r.items() if k.endswith("_shape")}
               for r in results.values()]
    if len(kernels) != len(kernel_wrappers()) + 2:   # + the two probes
        raise AssertionError(f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
