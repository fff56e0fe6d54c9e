#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image2text_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, flagship widths
    python3 chip_smoke.py --profile    # also device time by kernel

Phases, each printing its lines:

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds every kernel source from the checkout, and the
            probes' ablation builds of two of them, in parallel; the
            dryrun's CPU ranks run beside it.  tf32-sass: every 3xTF32
            kernel (the f32 flash pair, the f32 MoE FFN, the f32 front's
            cluster kernel) has HMMA.1688.F32.TF32 in its SASS
            (cuobjdump -sass).
3. kernels  each CUDA kernel against its plain PyTorch version, in bf16 at
            the flagship shapes, the plain version run on the kernel's own
            expert routes and held at the output's scale
            (image2text_torch/utils/kernel_check.py): error, kernel time,
            plain time, bound.  The flash-attention forward and backward
            (dQ, dK and dV in one call) at the training step's encoder
            shape (batch 48, 8 heads, s 160, d 128, multi-query, dropout
            0.1) and a decoder shape (s 136, causal, soft-prompt bias),
            with the same dropout seed as their plain versions; each
            call's routes and groups (fwd_plan, bwd_plan) and the kernels'
            registers and spills (the build's -Xptxas -v); the
            backward launched three times, bitwise equal, and its visited
            (query tile, key slice or key tile) pairs counted against the
            causal band;
            F.scaled_dot_product_attention's forward, backward alone and
            both as yardsticks the port never calls.  The chain
            attention's worst error at score standard deviations 1, 2 and
            4 (t 160, 320) beside the sensitivity of the reference's own
            bf16 score rounding.
   lm_head  the tied lm_head's bf16 product with f32 sums (dot_f32) at
            256 rows and the flagship's and GPT-2-medium's vocab widths,
            its two cuBLAS formulations, and the f32 formulation it
            replaced.
            The encoder front (fused_frontend) at the serving batch on the
            route front_plan gives it and on the other route forced at the
            same shape (the cluster route: its chunk, resident clusters,
            registers and spills), reruns bitwise equal, with the
            projector's torch.matmul as a yardstick.  The block
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
            (132 columns), its bound the bytes alone, torch.topk as a
            yardstick.
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
   serve-modes  bench.py's serving modes (BENCH_FULL=1) on the flagship at
            full width and depth, batch 256, in this process: exact, int8
            cross-KV, W8A8 decoder weights (int8_serving_params at its
            default min_elems) with int8 cross-KV, approx top-k, all
            stacked.  Each: launches held to the exact path's counts,
            captions/s, W8A8 products a call, peak memory, the prefill's
            and an 8-token cached step's logits against exact's, greedy
            agreement with exact over 32 tokens; approx equal to exact
            (and all to w8a8) token for token.  The encoder in W8A8 as
            well: no sparse_block or front kernel (the blocks' module
            path, whose MoE FFN launches moe_ffn).  Then the W8A8 product
            (torch._int_mm on zero-padded operands) bit for bit against
            the CPU's at the lm_head's and every decode projection's
            shapes (256, 192 and 1 rows), the row scales and int8
            activations equal to the CPU's (0 ulp, 0 flips), and the W8A8
            lm_head's ms.
   graph    the caption call as one captured CUDA graph
            (image2text_torch/models/graphs.py; every serving phase of a
            scratch MQA decoder takes that route by default, the others
            stay eager by graph_plan and print their route).  Each graphed
            serving path (main, the five serve-modes, dense, nano-mini)
            holds its counted call, a replay, against an eager call of the
            same key under torch.profiler: each kernel of the port as many
            device records in both, the launch counts the replay adds the
            eager call's, the ids equal.  The phase itself: the eager (E)
            and graphed (G) routes in turns E G G E, greedy and sampled
            under one seed, ids bit for bit (G no further from E than E
            from itself), at batch 256 for the flagship and, in their own
            phases, the dense twin and nano-mini; E G G greedy in the
            flagship's four other serving modes; the capturing call's
            wall, both routes' walls and captions/s (median of 3
            windows), a replay's host calls (cudaGraphLaunch, launches,
            copies) beside its device records, peak memory and the pool a
            model's graphs share; on the flagship, after an in-place
            write to a weight the next call captures anew and equals
            eager, and right after the write that restores it a second
            batch gets a graph of its own, equal to eager.
            --profile: each route's device busy ms and share.
   beam-int8  beam search (batch 64, width 3, expansion 4) exact, with
            int8 cross-KV and with W8A8 + int8 cross-KV: captions/s,
            launches, greedy beam ids against exact's.
   reforward  generate(force_no_cache=True), greedy, batch 16: launches
            held to the counts derived from the model (the MoE FFN of
            each block the bypass rule keeps at each length).
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
   gpt2m-int8  as serve-modes, exact against int8 cross-KV with
            int8_serving_params on the decoder (its float tables and
            Linears; the int4 Linears stay int4: 3,168 int4_matmul
            launches a call either way).
11. gpt2m-train  the kbit + LoRA training step (batch 12 x 48 labels,
            accumulation 1, bf16 compute from f32 masters, checkpointing,
            SNRAdam lr 6e-4): launches per step, step ms, peak memory, the
            loss of every step, frozen tensors bitwise unchanged.
12. gpt2m-train-parity  depth 2 + 2, full width, batch 8: loss and
            gradients, kernel path against plain-version path.

Then the pretrained-ViT nano family at full width and depth, batch 256,
random weights from the seed (ViT-B/16 at 224², 197 tokens; a
GPT-2-initialised decoder imports a GPT-2-layout state dict of seeded
numpy normals in HF names and Conv1D layout through
``import_gpt2_state_dict``, loose as its config says):

Each family of the nano and HF parts is trained first, at full width and
depth from f32 masters (train-<family>), and the trained model then
serves, so that nothing builds twice:

   train-<family>  nano-mini, nano, nano-lsh, gpt2 (local/gpt2.yaml),
            llama13b, falcon7b, qwen, llama7b, gpt2xl: the YAML's batch x
            256 labels, precision, optimizer groups (unmatched paths
            frozen), SNRAdam or AdamW, gradient accumulation (Falcon-7B's
            4 / 8 and GPT-2-xl's 12 / 8, refused by both packages, with
            accumulation 1), checkpointing, LoRA; launches in the warm step
            held to train_launches (per micro-batch, the recompute where a
            stack checkpoints), the flash and int4 shapes recorded; then 3
            timed steps: step ms, tokens/s, peak memory, losses finite and
            lower at the end, every frozen tensor unchanged (a digest on
            the card).
   nano-mini  training_configs/local/nano-mini.yaml: positional-MLP head
            (16 x 768), bridge 768 → 1024, 6 sparse MQA/MoE decoder
            layers with the positional-MLP embedding, soft prompt +
            cross-attention: moe_ffn at its decode shape (256 rows, 1024 →
            2048) against its plain version, then the serving path as
            [main] (launches held to serving_launches: moe_ffn only),
            captions/s and the call's wall; nano-mini-parity as [parity].
   nano     training_configs/tpu/nano.yaml: PEER head (65,536 units,
            top-8, 4 heads, query 128, out 1600), bridge 1600 → 1280, the
            36-layer d-1280 MHA decoder from GPT-2-large's layout (its
            1,024-row wpe skipped against 256), cross-attention alone.
   nano-lsh training_configs/local/nano.yaml: LSH head (8 CLS, bins
            4/8/20, 32 projections), the 12-layer d-768 MHA decoder from
            GPT-2's layout, soft prompt + cross-attention.
   nano-cpu depth 2 + 2 forms of the three, card against a CPU copy:
            encoder output, first-step logits (f32, TF32 off: within 1e-4
            relative L2; nano-mini in bf16, moe_ffn's dtype, within 0.03)
            and greedy ids; the LSH bins that differ, each within 1e-5 of
            a grid point.

   nano-f32 local/nano-mini.yaml at its own precision 'no' (f32): the
            serving path through moe_ffn's f32 form (launches as derived;
            the rows of each f32 moe_ffn call recorded), then its depth-2
            form card against CPU (f32 logits within 1e-4, greedy ids
            equal).

Then the HF decoder families at full width and depth, batch 256, random
weights from the seed (int4 weights and LoRA B as for GPT-2-medium):

   hf-kernels  int4_matmul against its plain version at every Linear
            shape of the Llama-2-13B, Falcon-7B and GPT-2-xl decoders, at
            256 decode rows and at their prefill rows (256 x 17, 256 x
            65), reruns bitwise equal, torch.matmul on the dequantised
            weight as a yardstick; moe_ffn's f32 form (3xTF32) on
            nano-mini's FFN at every row count the paths gave it
            ([nano-f32], [f32-chain]) and at 1, 17 and 4,097 rows, each
            with and without the LN2 prologue and residual: f32 limits on
            its own routes, errors against a float64 truth beside the
            plain version's, reruns bitwise equal, ms, device ms by kernel,
            kernels a call, the bound at the 3xTF32 and FFMA peaks,
            registers and spills.
   llama13b, falcon7b, qwen, llama7b, gpt2xl  tpu/llama2-13b.yaml,
            tpu/falcon-7b.yaml, local/qwen-1.5b-deepseek-distill.yaml,
            local/llama2-7b.yaml, tpu/gpt2-xl.yaml: parameters, build
            seconds and the build's peak memory against the resident
            size, the serving path as [main] (launches held to
            serving_launches), peak memory; for the models that launch a
            kernel, parity as [parity], the plain path also run with its
            int4 products summed in another f32 order (its own spread).
   hf-cpu   depth-1 forms card against CPU: each family in f32 (logits
            within 1e-4, ids equal; Falcon's and GPT-2-xl's decoders on the
            CPU's encoder output), and the int4 Llama-2-13B form in bf16
            (its logits alone).

   train-parity  each family's depth-1 form at full width, batch 1,
            dropout 0: one training step on the card against one on a CPU
            copy (loss 1e-2 and gradients 2e-2 relative L2 in bf16, 1e-5
            in f32; tpu/nano.yaml in f32, its PEER top-k parting at bf16
            near ties; a bf16 form beyond them within twice the CPU bf16
            step's distance from the CPU's f32 step).
   remat    tpu/llama2-13b.yaml at depth 2 under full, dots, nothing and
            everything: loss and gradients against full's, step ms and
            peak memory of each.
   train-kernels  the flash forward and backward at each family's largest
            training call of each dtype (the tiled bf16 route past 160
            keys, with its G, registers, spills and visited pairs; the f32
            kernels with their G, registers, spills, and the bound as 3 x
            their FLOP at the TF32 peak beside the FFMA peak's) and
            int4_matmul at every training shape, against
            their plain versions, beside the bound, SDPA and bf16
            torch.matmul.

Then the offline end-to-end path (training_configs/local/synthetic-*.yaml:
f32, precision 'no'; 2 + 2 dense blocks of d 64 with _MLP FFNs):

13. offline-kernels  the f32 forms of the flash forward and backward at
            synthetic-smoke.yaml's training shapes (b 8, 4 heads, one K/V
            head, d 16; the encoder's 264 rows, the decoder's 128, causal,
            with the soft-prompt bias; dropout 0.1, the plain version's
            seed) and of the encoder front at the evaluate batch and the
            trainer's eval batch (4 and 8 images of quality2_ck.npz's val
            stream; its cluster route, the slab route and the other
            cluster sizes forced), against their plain versions at the f32
            limits (utils/kernel_check.py F32_LIMITS), the front also
            against a float64 truth: ms, device ms, the bound (3xTF32 at
            the TF32 peak, beside the f32 FFMA peak's), the flash
            kernels' G, registers and spills,
            F.scaled_dot_product_attention in f32 and the projector's f32
            torch.matmul as yardsticks; kept as ``offline_*_f32_shape`` in
            the kernels' rows.
14. offline-train  the trainer twin (python -m image2text_torch.trainer)
            on synthetic-smoke.yaml, 20 steps x 2 loop epochs with eval and
            val, --chkpt_file and --resume_dir into a directory under
            build/: launches of the whole run held to the counts derived
            from the model, the loss of every step (finite, lower at the
            end), peak memory, step ms (--profile: device time by kernel of
            one step).
15. offline-eval  the evaluate twin, greedy, 8 images, on the new
            checkpoint and on artifacts/quality2_ck.npz: the card's tokens,
            BLEU-4 and CIDEr-D equal to the CPU run's in this process; the
            sampled metrics beside them.
16. offline-beam  greedy beam search on quality2_ck.npz, card against CPU:
            the rounds each sample's ids stay equal, and the margins where
            they part.

17. offline-modes  the evaluate twin on quality2_ck.npz with
            --int8_serving and with --approx_topk: greedy, card = CPU token
            for token and in BLEU-4 and CIDEr-D; each mode's change
            against exact, greedy and sampled (candidate 0, 5 references).
   local-data  64 images from the seed (.npy, and PNG where PIL is
            importable) and a captions.json in a directory: the trainer
            twin's CLI on derived local/nano-mini.yaml (the ViT's
            transform) and synthetic-smoke.yaml at 128 px (the C++ core,
            its library built by that run); the first batch of each route
            against the plain versions.
18. reforward  the fallback on quality2_ck.npz: force_no_cache greedy ids
            equal to the cached path's and to the CPU's.

   chain-rows  fused_block past the resident attention's 432 rows (448,
            1,024: the K/V-tiled attention) and at head dim 256, against
            the plain version on the kernel's routes; times, bound,
            torch.matmul + SDPA.  f32-chain: an f32 sparse encoder block
            takes the composed forward on the card (moe_ffn's f32 form, no
            chain kernel), against a CPU copy.  The flash kernels at head
            dims 80 and 192 (zero-padded) and 256 (the rows' ``head_dim_*``
            shapes).  flash-planes: one rank's slice of a dp2 × tp2
            training call with its dropout planes, bit for bit the whole
            call's slice (bf16, f32).
   dist     the mesh over NCCL on every card (one here: world size 1,
            in-process): the full flagship step through parallel/mesh.py
            and the mesh Trainer (zero_sharded_optimizer set) bit for bit
            the one-device step, flash launches 48/24, step ms and peak
            memory of both, greedy generate's tokens equal; what a data
            rank's dropout pays for drawing the global mask
            (dropout_cost); on two or more cards also the dp × tp mesh
            dryrun_multichip picks.
   dist-tp  with one card, 2 gloo ranks sharing it (dp1 × tp2 with SP,
            the flagship at full width and depth 2): a train step, a val
            step and greedy generate against one device (losses within
            TRAIN_LOSS_TOL, launches equal, 3/4 of the tokens equal).
   dist-tp-int4  llama2-13b.yaml's int4 + LoRA decoder at full width,
            split over tp2 (2 gloo ranks sharing the card, SP) against
            one device on the same seeded weights (parallel/checks.py's
            Llama form), captions of the initial weights, then a step:
            in f32 on the int4 plain version at INT4_TP_DEPTH layers the
            same losses, gradients, greedy tokens and beam ids; in bf16
            on the kernel at INT4_TP_SHALLOW and INT4_TP_DEPTH layers the
            loss within 1e-3 (gradients within 2e-2 at INT4_TP_SHALLOW),
            and no further from the f32 truth than twice one device's
            bf16 run; int4_matmul at the shard shapes as often as one
            device, half the int4 bytes a rank, beams checked alike over
            the group; int4_matmul at the shard shapes against its plain
            version, bf16 and f32 output.
   dryrun   graft_entry.entry() on the card, then the result of
            graft_entry.dryrun_multichip(4), started beside the build: 4
            gloo ranks on the CPU (a CPU phase), JAX's two phases and
            lines.
   lora-vit, lora-decoder  local/gpt2.yaml's pretrained ViT and
            tpu/nano.yaml's GPT-2-initialised decoder with a LoRA spec set
            in code, at full width and depth: a training step (frozen
            digests kept, every adapter moved), a caption call, and the
            depth-2 form card against CPU.
   moe-gates  the flagship's blocks with gates of no and of two hidden
            layers: no sparse_block, fused_block or moe_ffn launch; card
            against CPU at depth 2 in f32.
19. device-times  the device time of the flash forward, int4_matmul,
            fused_frontend (both routes) and topk_ban_mask rows, in all and
            by kernel (torch.profiler's kernel durations, free of the
            wrapper's host time that their CUDA-event times include), taken
            last: the profiler slows every later host call of the process.

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
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 0.06       # whole-stack parity: the JAX bf16 kernel tests' tolerance
# a serving mode's logits, card against a CPU copy of the model (decoder
# only, on the card's encoder output), relative L2: over the readings on an
# H100 (flagship exact 0.0085, int8_kv 0.0085, w8a8 0.0225; GPT-2-medium
# exact 0.0166, int8 0.0202)
CPU_MODE_TOL = 0.03
CPU_ROWS = 2     # images of that check
# the int8 cross-attention read against f64 (relative L2): two bf16
# roundings, each within 2^-9 relative
INT8_READ_TOL = 1e-2
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
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores (FFMA)
TF32_FLOP_PER_S = 495e12    # dense TF32 tensor-core peak (3xTF32: 3 a FLOP)
MAX_NEW_TOKENS = 32
BATCH = 256      # the main path's batch
PROBE_BATCH = 64  # the block probes' batch (tools/ ran 256; cut for time)
BEAM_BATCH = 64  # bench.py::_bench_beam's batch (3 beams: 192 decode rows)
FLAGSHIP_BOS = 1   # the flagship's prompt token
FLAGSHIP_EOS = 0   # bench.py's beam eos_token_id
SEED = 0         # weights, frames and sampling noise derive from it
CARD = ""        # the card's nvidia-smi name and power limit, set by main()


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's heading line ("[phase] ...") ends with the
    seconds since the start."""
    if msg.startswith("["):
        msg += f" [{time.perf_counter() - T0:.0f} s]"
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


def defer_device_ms(label: str, row: dict, fn, key: str = "device",
                    held=None, launches=None) -> None:
    """Have ``row[key + "_ms"]`` measured at the end of the run: ``fn``'s
    device time in ms, the host's launch overhead excluded (torch.profiler's
    kernel durations), and ``row[key + "_kernels"]`` the same by kernel.
    With ``held`` (a tensor), ``fn`` takes it as its argument: the run
    keeps a host copy and puts it back on the device only to measure, so
    that it does not count in later phases' peak memory.  With
    ``launches``, the device launches the profiler records a call (kept as
    ``row[prefix + "kernels_a_call"]``, the prefix being ``key`` without
    its "device") must be that number, rounded (a profiler session can
    miss an event): the run fails otherwise."""
    if held is None:
        DEVICE_TIMES.append((label, row, lambda: fn, key, launches))
        return
    host, device = held.cpu(), held.device

    def make():
        arg = host.to(device)
        return lambda: fn(arg)

    DEVICE_TIMES.append((label, row, make, key, launches))


DEVICE_TRIES = 3   # profiler sessions a deferred device time may take


def run_device_times() -> None:
    """Measure every deferred device time (after all CUDA-event timing).
    A profiler session on the card's machine can record no kernel at all
    (every other session, in a run of many): such a session is taken
    again, up to DEVICE_TRIES times, and a time never recorded is kept as
    None ("not measured"), never as 0.  Where launches a call were asked
    for (defer_device_ms), a count other than that, or none, fails."""
    from image2text_torch.probes import device_kernels

    for label, row, make, key, want in DEVICE_TIMES:
        fn = make()
        for _ in range(DEVICE_TRIES):
            seen = device_kernels(fn)
            if seen:
                break
        split = {name: ms for name, (ms, _) in seen.items()}
        calls = sum(n for _, n in seen.values()) if seen else None
        prefix = key[:-len("device")]
        row[f"{key}_ms"] = sum(split.values()) if split else None
        row[f"{key}_kernels"] = split
        row[f"{prefix}kernels_a_call"] = calls
        shown = ("not measured (no kernel recorded in "
                 f"{DEVICE_TRIES} profiler sessions)" if not split
                 else f"{row[f'{key}_ms']:.4f} ms")
        log(f"  {label}: device {shown} (CUDA events "
            f"{row[prefix + 'ms']:.4f}), {calls} launches a call; by "
            "kernel " + ", ".join(f"{name[:60]} {ms:.4f}"
                                  for name, ms in split.items()))
        if want is not None and (calls is None or round(calls) != want):
            raise AssertionError(f"{label}: {calls} device launches a call "
                                 f"(torch.profiler), not {want}")
    DEVICE_TIMES.clear()


# The kernels whose products run as 3xTF32 on the tensor cores, by source:
# parts of their (mangled) names; every instantiation's SASS must hold the
# TF32 tensor-core product HMMA.1688.F32.TF32.
TF32_KERNELS = {
    "fused_moe": ("moe32_kernel",),
    "fused_frontend": ("front32_cluster_kernel",),
    "flash_attention_f32": ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel",
                            "flash_bwd_dq_f32_kernel")}


def sass_tf32_counts(source: str) -> dict:
    """{kernel (mangled name): its HMMA ... TF32 instructions} in the SASS
    of ``csrc/<source>.cu``'s shipping build (``cuobjdump -sass``)."""
    from image2text_torch.ops import _build

    _build.load(source)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_build._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in line and "TF32" in line:
            counts[fn] += 1
    return counts


def phase_tf32_sass() -> dict:
    """Every kernel of TF32_KERNELS, each instantiation, has the TF32
    tensor-core product in its SASS; raises otherwise.  Returns the
    counts."""
    found = {}
    for source, names in TF32_KERNELS.items():
        counts = sass_tf32_counts(source)
        for name in names:
            fns = {f: n for f, n in counts.items() if name in f}
            if not fns or not all(fns.values()):
                raise AssertionError(f"{source}.cu: {name} without an HMMA "
                                     f"TF32 product in its SASS: {fns}")
            found.update(fns)
    log("  HMMA ... TF32 instructions a kernel: " + ", ".join(
        f"{f[:48]} {n}" for f, n in found.items()))
    return found


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


def compare(name, got, want, routes=None, gates=None, k=None, f32=False):
    """Hold a kernel's output against its plain version, which ran on the
    kernel's own expert routes, at the output's scale (``f32``: the f32
    kernels' tighter limits); and the routes against the plain gate
    values (``image2text_torch.utils.kernel_check``).  Raises on
    disagreement; returns the largest absolute error."""
    from image2text_torch.utils import kernel_check

    limits = (kernel_check.F32_LIMITS if f32 else (
        kernel_check.ELEMENT_TOL, kernel_check.MAX_ABS_SHARE,
        kernel_check.REL_L2))
    st = kernel_check.output_error(got, want, limits[0])
    line = (f"  {name}: max_abs_err {st['max_abs_err']:.6g} (max|plain| "
            f"{st['max_plain']:.6g}, limit {limits[1]} x), "
            f"rel_l2 {st['rel_l2']:.6g} (limit {limits[2]}), "
            f"bitwise-equal share {st['equal_share']:.4f}, elements beyond "
            f"{limits[0]} abs + rel {st['elements_beyond']}")
    if routes is not None:
        rt = kernel_check.check_routes(name, routes, gates, k)
        line += (f"; rows routed apart {rt['rows_apart']} of {rt['rows']}, "
                 f"largest tie gap crossed {rt['max_tie_gap']:.3g} (limit "
                 f"{kernel_check.TIE})")
    log(line)
    kernel_check.check_output(name, got, want, limits)
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
    ``<tag>_shape`` entries; returns the dict kept."""
    if tag is None:
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, **row)
        return results[name]
    kept = results.setdefault(name, {"name": name})[f"{tag}_shape"] = dict(
        **shape, **row)
    return kept


def phase_front_kernel(torch, model, images, results, tag=None):
    """fused_frontend against its plain version on ``model``'s patch stream
    of ``images``, on the route front_plan gives its shape and on the other
    route forced at the same shape where it runs (the cluster route where
    its chunk fits: its chunk, resident clusters, registers and spills),
    reruns bitwise equal; torch.matmul of the projector alone as a
    yardstick the port never calls.  Device times by kernel of both routes,
    read at the end."""
    from image2text_torch.ops import _build
    from image2text_torch.ops.fused_frontend import (SLAB_MAX_CHUNK,
                                                     FrontPlan, front_plan,
                                                     fused_frontend,
                                                     fused_frontend_plain,
                                                     launch_front,
                                                     resident_clusters)

    enc = model.vision_encoder
    x = enc.feature_extractor(images)
    x = x.reshape(x.shape[0], enc.n_patches ** 2, enc.input_d)
    w = enc.frontend_weights(x.dtype)
    b, t, din = x.shape
    d, n_cls = w.w_p.shape[1], w.cls.shape[0]
    plan = front_plan(t, d)
    other = FrontPlan("slab" if plan.route == "cluster" else "cluster",
                      plan.chunk)
    if other.route == "cluster" and plan.chunk > SLAB_MAX_CHUNK:
        other = None
    got = fused_frontend(x, w)
    want = fused_frontend_plain(x, w)
    again = fused_frontend(x, w)
    label = f"fused_frontend b={b} t={t} din={din} d={d} n_cls={n_cls}"
    err = compare(f"{label} ({plan.route} route)", got, want)
    if not torch.equal(got[:, :n_cls], want[:, :n_cls]):
        raise AssertionError("fused_frontend: CLS rows differ")
    if not torch.equal(got, again):
        raise AssertionError("fused_frontend: reruns differ")
    if other is not None:
        by_other = launch_front(x, w, other)
        compare(f"{label} ({other.route} route)", by_other, want)
        if not torch.equal(by_other[:, :n_cls], want[:, :n_cls]):
            raise AssertionError("fused_frontend: CLS rows differ")
        del by_other
    del got, want, again
    ms = cuda_ms(torch, lambda: fused_frontend(x, w))
    plain = cuda_ms(torch, lambda: fused_frontend_plain(x, w))
    lib = cuda_ms(torch, lambda: torch.matmul(x, w.w_p))
    # the projector's products on the tensor cores; the two slab norms'
    # few operations per element are far below them
    flops = 2 * b * t * din * d
    n_bytes = nbytes(x, *w) + b * (n_cls + t) * d * x.element_size()
    bms, by = bound_ms(n_bytes, flops)
    extra = dict(plan_route=plan.route, chunk=plan.chunk)
    if other is not None:
        extra.update(other_route=other.route, other_route_ms=cuda_ms(
            torch, lambda: launch_front(x, w, other)))
    if plan.chunk <= SLAB_MAX_CHUNK:
        regs, spills = _build.resources("fused_frontend",
                                        "cluster_slab_kernel")
        extra.update(resident_clusters=resident_clusters(
            x.device.index, plan.chunk, w.ln_b is not None),
            registers=regs, spill_bytes=spills)
    log(f"  fused_frontend: {plan.route} route {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB; kernels at {bms / ms:.3f} of it), "
        f"torch.matmul of the projector alone {lib:.4f} ms; {extra}")
    row = kernel_row(results, "fused_frontend", tag,
                     "image2text_torch/csrc/fused_frontend.cu",
                     "image2text_tpu/ops/fused_frontend.py:45",
                     dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib,
                          **extra), b=b, t=t, din=din, d=d)
    defer_device_ms(f"{label} ({plan.route} route)", row,
                    lambda x: fused_frontend(x, w), held=x)
    if other is not None:
        defer_device_ms(f"{label} ({other.route} route)", row,
                        lambda x: launch_front(x, w, other),
                        key="other_route_device", held=x)


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
    # each row read and written once, the bans read once: bytes alone (a
    # compare or two an element is far below them on the CUDA cores)
    n_bytes = 2 * nbytes(x) + nbytes(banned)
    bms, by = bound_ms(n_bytes, 0)
    log(f"  topk_ban_mask: kernel {ms:.4f} ms, reference {plain:.4f} ms, "
        f"bound {bms:.5f} ms ({by}; {n_bytes / 1e6:.1f} MB; kernel at "
        f"{bms / ms:.3f} of it), torch.topk(x, {k}) {lib:.4f} ms")
    row = kernel_row(results, "topk_ban_mask", tag,
                     "image2text_torch/csrc/topk_mask.cu",
                     "image2text_tpu/ops/topk_mask.py:91",
                     dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib),
                     rows=rows, V=vocab, k=k, M=banned.shape[1])
    defer_device_ms(f"topk_ban_mask rows={rows}", row,
                    lambda x: topk_ban_mask(x, banned, k), held=x)


def phase_kernels(torch, model, args, results, tag=None):
    """The serving kernels against their plain versions at ``model``'s
    shapes: the flagship's rows (``tag`` None), or another model's encoder
    shapes, kept under ``<tag>_shape`` in the rows."""
    from image2text_torch.ops.fused_block import (sparse_block,
                                                  sparse_block_plain)

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
        row = moe_case(torch, mlp, rows, gen, label, ln)
        if label == "decode":
            row.pop("rows"), row.pop("hidden")
            results["moe_ffn"] = dict(
                name="moe_ffn", route="cuda",
                source="image2text_torch/csrc/fused_moe.cu",
                replaces="image2text_tpu/ops/fused_moe.py:95",
                library_ms=None, **row)
        else:
            key = "encoder_shape" if tag is None else f"{tag}_encoder_shape"
            results.setdefault("moe_ffn", {"name": "moe_ffn"})[key] = row


def moe_case(torch, mlp, rows: int, gen, label: str, ln=None) -> dict:
    """``moe_ffn`` on ``mlp``'s weights and ``rows`` random bf16 rows
    against its plain version on the kernel's routes (``ln``: the LN2
    prologue's weights), timed beside the plain version; its bound.  (The
    f32 form: ``phase_moe_f32``.)"""
    from image2text_torch.ops.fused_moe import moe_ffn, moe_ffn_plain

    ln, dt = ln or {}, torch.bfloat16
    fc, proj = mlp.c_fc.packed(dt), mlp.c_proj.packed(dt)
    xm = torch.randn(rows, fc.wa.shape[0], device=gen.device, dtype=dt,
                     generator=gen)
    got, want, rk, gv = run_pair(torch, moe_ffn, moe_ffn_plain,
                                 (xm, fc, proj), rows, fc.e, **ln)
    hidden = fc.l2w.shape[1]
    err = compare(f"moe_ffn {label} rows={rows} hidden={hidden}", got, want,
                  rk, gv, fc.k)
    ms = cuda_ms(torch, lambda: moe_ffn(xm, fc, proj, **ln), iters=20)
    plain = cuda_ms(torch, lambda: moe_ffn_plain(xm, fc, proj, **ln),
                    iters=20)
    flops, byts = moe_flops_bytes(xm, fc, proj)
    bms, by = bound_ms(byts + nbytes(*ln.values()), flops)
    log(f"  moe_ffn {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.5f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
        f"{byts / 1e6:.2f} MB)")
    return dict(rows=rows, hidden=hidden, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


# Rows of every f32 ``moe_ffn`` call the model layers made on a path
# ({path: {rows: calls}}, record_moe_rows), and the row counts held beside
# them in phase_moe_f32.
MOE_F32_PATH_ROWS = {}
MOE_F32_EXTRA_ROWS = (1, 17, 4097)


@contextlib.contextmanager
def record_moe_rows(path: str):
    """Record the rows of every f32 ``moe_ffn`` call the model layers make
    inside the block under ``MOE_F32_PATH_ROWS[path]`` (the wrapper itself
    runs, and counts, as ever)."""
    import torch

    from image2text_torch.models import layers

    kernel, seen = layers.moe_ffn, MOE_F32_PATH_ROWS.setdefault(path, {})

    def recording(x, *args, **kw):
        if x.dtype == torch.float32:
            n = x.numel() // x.shape[-1]
            seen[n] = seen.get(n, 0) + 1
        return kernel(x, *args, **kw)

    layers.moe_ffn = recording
    try:
        yield seen
    finally:
        layers.moe_ffn = kernel


def phase_moe_f32(torch, mlp, gen, results) -> None:
    """moe_ffn's f32 form (csrc/fused_moe.cu's 3xTF32 kernels) on ``mlp``'s
    weights (nano-mini's decoder FFN, 1024 → 2048 → 1024) at every row
    count the paths gave it (MOE_F32_PATH_ROWS: the nano-mini f32 caption
    call, [f32-chain]) and at MOE_F32_EXTRA_ROWS, each without and with the
    LN2 prologue and residual: against its plain version on its own routes
    (F32_LIMITS) and both against a float64 truth (max error over max
    |truth|, relative L2), reruns bitwise equal; ms beside the plain
    version's, its plan, the bound at the 3xTF32 peak beside the FFMA
    peak's, registers and spills; device ms by kernel and the launches a
    call read at the end (torch.profiler; the run fails unless each call
    is one launch).  256 rows without the prologue is kept as
    ``nano_mini_decode_f32_shape``, every case in ``f32_rows``."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import fused_moe as fm
    from image2text_torch.probes import moe_f64_truth, truth_error
    from image2text_torch.utils.device import sm_count

    f32, dev = torch.float32, gen.device
    fc, proj = mlp.c_fc.packed(f32), mlp.c_proj.packed(f32)
    fin, hidden, width = fc.wa.shape[0], fc.l2w.shape[1], fc.g + fc.e * fc.r
    nt = next(n for n in (4, 8, 12, 16) if width <= 8 * n)
    res = _build.resources("fused_moe", f"moe32_kernelILi{nt}E")
    path_rows = {n for seen in MOE_F32_PATH_ROWS.values() for n in seen}
    if not path_rows:
        raise AssertionError("no path launched moe_ffn's f32 form")
    log(f"  rows a call the paths gave moe_ffn's f32 form ({{path: {{rows: "
        f"calls}}}}): {MOE_F32_PATH_ROWS}; (registers, spill bytes) of the "
        f"kernel (NT {nt}): {res}")
    ln = dict(ln_w=1 + 0.1 * torch.randn(fin, device=dev, generator=gen),
              ln_b=0.1 * torch.randn(fin, device=dev, generator=gen))
    sweep = []
    for n in sorted(path_rows | set(MOE_F32_EXTRA_ROWS)):
        for prologue in (False, True):
            x = torch.randn(n, fin, device=dev, generator=gen)

            def call(x, prologue=prologue):
                extra = dict(ln, residual=x) if prologue else {}
                return fm.moe_ffn(x, fc, proj, **extra)

            extra = dict(ln, residual=x) if prologue else {}
            label = f"rows={n}" + (" LN2 + residual" if prologue else "")
            got, want, rk, gv = run_pair(torch, fm.moe_ffn, fm.moe_ffn_plain,
                                         (x, fc, proj), n, fc.e, **extra)
            err = compare(f"moe_ffn f32 {label}", got, want, rk, gv, fc.k,
                          f32=True)
            if not torch.equal(got, call(x)):
                raise AssertionError(f"moe_ffn f32 {label}: reruns differ")
            truth = moe_f64_truth(fm, x, fc, proj, rk, **extra)
            errs = truth_error(got, truth), truth_error(want, truth)
            del got, want, truth
            ms = cuda_ms(torch, lambda: call(x), iters=20)
            plain = cuda_ms(torch, lambda: fm.moe_ffn_plain(
                x, fc, proj, **extra), iters=20)
            flops, byts = moe_flops_bytes(x, fc, proj)
            byts += nbytes(*extra.values())
            bms, by = bound_ms(byts, 3 * flops, TF32_FLOP_PER_S)
            ffma, ffma_by = bound_ms(byts, flops, F32_FLOP_PER_S)
            plan = fm.moe_plan_f32(n, fin, hidden, sm_count(dev))
            log(f"  moe_ffn f32 {label}: {ms:.4f} ms (plain {plain:.4f}), "
                f"{plan}: {-(-n // fm.F32_ROWS) * plan.slices} blocks, bound "
                f"{bms:.5f} ms ({by}; 3xTF32: 3 x {flops / 1e9:.3f} GFLOP at "
                f"495 TFLOP/s, {byts / 1e6:.2f} MB), at the FFMA peak "
                f"{ffma:.5f} ({ffma_by}); error against float64 (max / "
                f"max|truth|, rel L2): kernel {errs[0][0]:.3g} "
                f"{errs[0][1]:.3g}, plain {errs[1][0]:.3g} {errs[1][1]:.3g}")
            row = dict(rows=n, hidden=hidden, prologue=prologue,
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, ffma_bound_ms=ffma, plan=list(plan), truth_err=errs[0],
                       plain_truth_err=errs[1], registers=res[0],
                       spill_bytes=res[1])
            defer_device_ms(f"moe_ffn f32 {label}", row, call, held=x,
                            launches=1)
            sweep.append(row)
            del x, extra
    kept = results.setdefault("moe_ffn", {"name": "moe_ffn"})
    kept["nano_mini_decode_f32_shape"] = next(
        r for r in sweep if r["rows"] == BATCH and not r["prologue"])
    kept["f32_rows"] = sweep


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
    for ``generate``, 1 + rounds for beam search), derived from the model.
    A scratch encoder: one fused_frontend (the encoder front), one
    sparse_block per sparse encoder block that runs its body and one
    fused_block per dense one (the block's MoE FFN runs inside); the
    pretrained ViT launches none of them.  One moe_ffn per cached forward
    of a scratch-decoder MoE block that runs its body; one int4_matmul per
    quantized Linear per decoder forward."""
    import numpy as np

    from image2text_torch.models.encoder import VisionTransformerEncoder
    from image2text_torch.models.layers import _MoEMLP
    from image2text_torch.models.quantization import QuantizedLinear

    enc, dec = model.vision_encoder, model.decoder
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    if isinstance(enc, VisionTransformerEncoder):
        t = enc.n_cls + enc.n_patches ** 2
        want["fused_frontend"] = 1
        want["sparse_block"] = sum(blk.is_sparse and blk.runs_body(t)
                                   for blk in enc.blocks)
        want["fused_block"] = sum(not blk.is_sparse for blk in enc.blocks)
    if hasattr(dec, "ffn_evaluations"):
        want["moe_ffn"] = sum(
            blk.runs_body_at(np.asarray([model.space_for_prompt + i]))
            for i in range(n_forwards) for blk in dec.blocks
            if isinstance(blk.mlp, _MoEMLP))
    n_q = sum(isinstance(m, QuantizedLinear) for m in dec.modules())
    want["int4_matmul"] = n_forwards * n_q
    return want


def vocab_rows(model) -> int:
    """Rows of the decoder's token table (its int8 form's too): the
    scratch and GPT-2 decoders' ``transformer.wte``, the Llama and Falcon
    decoders' ``embed_tokens`` / ``word_embeddings``."""
    dec = model.decoder
    table = dec._embed() if hasattr(dec, "_embed") else dec.transformer.wte
    return table.stored_shape[0]


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
    from image2text_torch.models import graphs
    from image2text_torch.models.generation import caption

    dev, b = model.device, BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 2, bos)
    route, why = graphs.graph_plan(model, dev, prompt_len=1,
                                   max_new_tokens=MAX_NEW_TOKENS)
    log(f"  route: {route} ({why})")

    def run(seed, use=True):
        g = torch.Generator(device=dev).manual_seed(seed)
        return caption(model, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.7, top_k=16, generator=g, graphs=use)

    ids, _ = drive_serving(torch, args, results, path, run, b,
                           lambda: serving_launches(model), "one caption call",
                           eager=(lambda seed: run(seed, False))
                           if route == "graph" else None)
    log(f"  graphs held: {graphs.held_graphs(model)}")
    vocab = vocab_rows(model)
    if (tuple(ids.shape) != (b, 1 + MAX_NEW_TOKENS)
            or not bool(((ids >= 0) & (ids < vocab)).all())
            or not bool((ids[:, 0] == bos).all())):
        raise AssertionError(f"{path}: ids {tuple(ids.shape)} out of range "
                             "or prompt lost")
    log(f"  sample ids: {ids[0, :12].tolist()}")
    return ids


def drive_serving(torch, args, results, path: str, run, b: int, want,
                  what: str, eager=None):
    """What every serving phase does with its ``run(seed)``: a warm-up
    call (it builds caches and per-block index tensors; on the graph
    route it captures), one call with every launch count set to 0 just
    before it, kept under ``path`` and held to ``want()`` (read just after
    it), then captions/s over 3 warm windows of one call on ``b`` images
    each and, with ``--profile``, device time by kernel of one more call.
    With ``eager`` (the same call on the eager route, for a ``run`` on
    the graph route) the counted call is a replay, held to an eager call
    of the same key under torch.profiler (``replay_against_eager``).
    Returns the counted call's output and the captions/s."""
    run(0)
    torch.cuda.synchronize()
    windows = []
    if eager is None:      # the counted call is the first window
        t0 = time.perf_counter()
        counts, out = launch_counts(lambda: run(1))
        windows.append(b / (time.perf_counter() - t0))
    else:
        counts, out = replay_against_eager(torch, path, run, eager)
    record_launches(results, path, counts)
    want = want()
    log(f"  launches in {what}: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"{path} launch counts {counts} != {want}")
    while len(windows) < 3:
        w = len(windows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(10 + w)
        torch.cuda.synchronize()
        windows.append(b / (time.perf_counter() - t0))
    rate = statistics.median(windows)
    log(f"  captions/s (batch {b}, {MAX_NEW_TOKENS} new tokens, median of 3 "
        f"windows): {rate:.2f} on {CARD or torch.cuda.get_device_name(0)}; "
        f"windows "
        f"{[round(x, 2) for x in windows]}; wall a call "
        f"{[round(b / x * 1e3, 2) for x in windows]} ms")
    if args.profile:
        log(f"  device time by kernel, {what}:")
        device_profile(torch, lambda: run(20))
    return out, rate


def port_kernel_pattern():
    """A regex that finds the name of any ``__global__`` function of the
    port's CUDA sources in a profiler's kernel name."""
    names = set()
    for src in sorted((REPO / "image2text_torch" / "csrc").glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*"
            r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)", src.read_text()))
    return re.compile(r"(?<![\w])(" + "|".join(sorted(names)) + r")\s*[<(]")


def device_records(torch, fn):
    """(``fn()``, records) with torch.profiler's CUDA activity over one
    ``fn()``, read from its raw events (no per-event Python objects):
    ``host`` the runtime's and the driver's launch, graph-launch, copy and
    memset calls by name; ``kernels`` and ``kernel_ms`` the device's kernel
    records and their time by name; ``copies``, ``memsets`` and
    ``device_ms`` the device's copy and memset records and the time of
    all of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rec = dict(host={}, kernels={}, kernel_ms={}, copies=0, memsets=0,
               device_ms=0.0)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:   # the runtime's, the driver's
            name = name.split("_v")[0]      # cudaLaunchKernel_v7000 and kin
            if name in COPY_CALLS or "Launch" in name:
                rec["host"][name] = rec["host"].get(name, 0) + 1
            continue
        ms = e.duration_ns() / 1e6
        rec["device_ms"] += ms
        if name.startswith(("Memcpy", "Memset")):
            rec["copies" if name.startswith("Memcpy") else "memsets"] += 1
        else:
            rec["kernels"][name] = rec["kernels"].get(name, 0) + 1
            rec["kernel_ms"][name] = rec["kernel_ms"].get(name, 0.0) + ms
    return out, rec


# the host's kernel launch calls (torch.profiler's names, version cut)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx")
PROFILE_TRIES = 3


def all_records(rec) -> int:
    """Every device record: kernels, copies, memsets."""
    return sum(rec["kernels"].values()) + rec["copies"] + rec["memsets"]


def port_records(rec, port) -> dict:
    """{kernel name: device records} of the port's kernels in ``rec``."""
    return {n: k for n, k in rec["kernels"].items() if port.search(n)}


def replay_against_eager(torch, path: str, run, eager):
    """A replay (``run(1)``) against an eager call of the same key
    (``eager(1)``), each under torch.profiler (``device_records``): each
    kernel of the port must have as many device records in the replay as
    in the eager call, the launch counts the replay added must be the
    eager call's, the ids equal.  The profiler may lose records of a long
    call (it kept 25,129 of 26,031 kernels of one eager call): where the
    port's kernels' records part, both calls are profiled again, at most
    ``PROFILE_TRIES`` times, and a difference that stays fails.  Logs
    both calls' host calls and records (the eager call's kernel records
    beside its host's kernel launch calls), the port's kernels' records,
    and every other kernel whose records or time differ between them (a
    graph runs some copy and memset nodes as kernels, ``memcpy32_post``
    and ``memset32``).  Returns the replay's counts and output."""
    port = port_kernel_pattern()
    for attempt in range(PROFILE_TRIES):
        eager_counts, (eager_out, eager_rec) = launch_counts(
            lambda: device_records(torch, lambda: eager(1)))
        counts, (out, rec) = launch_counts(
            lambda: device_records(torch, lambda: run(1)))
        ours = port_records(eager_rec, port)
        if port_records(rec, port) == ours:
            break
        log(f"  {path}: the port's kernels' records part, eager {ours}, "
            f"replay {port_records(rec, port)}; both again")
    else:
        raise AssertionError(f"{path}: the port's kernels' device records "
                             f"differ between the eager call {ours} and a "
                             f"replay {port_records(rec, port)}")
    names = set(eager_rec["kernels"]) | set(rec["kernels"])
    apart = {n: (eager_rec["kernels"].get(n, 0), rec["kernels"].get(n, 0),
                 round(eager_rec["kernel_ms"].get(n, 0.0), 3),
                 round(rec["kernel_ms"].get(n, 0.0), 3))
             for n in sorted(names) if n not in ours and (
                 eager_rec["kernels"].get(n, 0) != rec["kernels"].get(n, 0)
                 or abs(eager_rec["kernel_ms"].get(n, 0.0)
                        - rec["kernel_ms"].get(n, 0.0)) > 0.2)}
    launched = sum(n for k, n in eager_rec["host"].items()
                   if k in KERNEL_LAUNCHES)
    for label, r in (("eager call", eager_rec), ("replay", rec)):
        log(f"  {path} {label}: host calls {r['host']}; device records "
            f"{all_records(r)}: {sum(r['kernels'].values())} kernels, "
            f"{r['copies']} copies, {r['memsets']} memsets; device "
            f"{r['device_ms']:.3f} ms")
    log(f"  {path} eager kernel records against the host's kernel launch "
        f"calls: {sum(eager_rec['kernels'].values())} of {launched}")
    short = {n: re.match(r"\w+(<[^()]*>)?",
                         n[port.search(n).start(1):]).group(0) for n in ours}
    log(f"  {path} the port's kernels, records in both: "
        f"{ {short[n]: k for n, k in ours.items()} }")
    log(f"  {path} other kernels whose records or ms differ (eager, replay; "
        f"ms eager, replay): { {n[:90]: v for n, v in apart.items()} }")
    if not ours:
        raise AssertionError(f"{path}: no kernel of the port ran")
    if eager_counts != counts:
        raise AssertionError(f"{path}: a replay counted {counts}, the eager "
                             f"call {eager_counts}")
    if not torch.equal(eager_out, out):
        raise AssertionError(f"{path}: a replay's output is not the eager "
                             f"call's under the same seed")
    return counts, out


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


GRAPH_SETTINGS = (("greedy", 0.0), ("sampled", 0.7))
GRAPH_SEED = SEED + 7      # the [graph] calls' generator seed
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync")


def parted_rows(torch, a, b) -> int:
    """Rows of two id buffers that differ anywhere."""
    return int((a != b).any(-1).sum())


def graph_runner(torch, model, frames, prompt, kw=None):
    """``run(graphs, temperature, seed, b)``: one synchronised caption call
    (32 new tokens, top-k 16) on the first ``b`` frames, its generator
    seeded anew, on the graph route or the eager one."""
    from image2text_torch.models.generation import caption

    def run(use, temperature=0.7, seed=GRAPH_SEED, b=None):
        g = torch.Generator(device=model.device).manual_seed(seed)
        ids = caption(model, frames[:b], prompt[:b],
                      max_new_tokens=MAX_NEW_TOKENS, temperature=temperature,
                      top_k=16, generator=g, graphs=use, **(kw or {}))
        torch.cuda.synchronize()
        return ids
    return run


def graph_against_eager(torch, run, label: str, again: bool = True,
                        settings=GRAPH_SETTINGS) -> dict:
    """E G G E under one seed, in each of ``settings`` (greedy and
    sampled): the first G captures
    where its key has no graph yet (returning its eager warm-up's ids),
    the second replays.  The eager route against itself first; a graphed
    call may part from the first eager call in no more rows than the
    second eager call does (0 where eager is bit-reproducible).  With
    ``again`` False, E G G, held to 0 rows (the model's eager route shown
    bit-reproducible before).  Returns the first G call's wall (s) by
    setting."""
    walls = {}
    for setting, temperature in settings:
        e1 = run(False, temperature)
        t0 = time.perf_counter()
        g1 = run(True, temperature)
        walls[setting] = time.perf_counter() - t0
        g2 = run(True, temperature)
        ee = parted_rows(torch, run(False, temperature), e1) if again else 0
        ge = (parted_rows(torch, g1, e1), parted_rows(torch, g2, e1))
        log(f"  {label} {setting}: rows parting from the first eager call: "
            f"eager again {ee if again else '(not run)'}, first graphed call "
            f"{ge[0]}, replay {ge[1]} of {e1.shape[0]}; first graphed call "
            f"{walls[setting] * 1e3:.2f} ms")
        if max(ge) > ee:
            raise AssertionError(f"[graph] {label} {setting}: the graph "
                                 f"route parts from eager in {ge} rows, "
                                 f"eager from itself in {ee}")
    return walls


def phase_graph(torch, model, args, path: str, bos: int, w8=None):
    """[graph] on ``model`` at batch 256: the route and its reason, E G G E
    greedy and sampled (``graph_against_eager``), both routes' walls and
    captions/s (median of 3 windows), a replay's host calls beside its
    device records (``device_records``; the eager call's, and the per-kernel
    check of a replay against it, are ``drive_serving``'s), peak memory
    above the resident tensors (an eager call, a replay) and the pool the
    model's graphs share.  The flagship (``w8``, its W8A8 copy, given)
    also: an in-place weight write (ln_f's sign, flipped: the next call
    captures anew and equals eager), then, right after the write that
    restores it, a second batch size (captured anew under the restored
    weights, its capturing call and a replay equal to eager), the full
    batch again beside the first ids, and E G G greedy in each serving
    mode past exact (sampled: ``drive_serving``'s replay against its eager
    call in [serve-modes]).  Every captured call is released at the end."""
    from image2text_torch.models import graphs
    from image2text_torch.models.generation import preprocess_frames

    dev, b = model.device, BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 2, bos)
    route, why = graphs.graph_plan(model, dev, prompt_len=1,
                                   max_new_tokens=MAX_NEW_TOKENS)
    log(f"  {path}: route {route} ({why}); {CARD}")
    if route != "graph":
        raise AssertionError(f"[graph] {path}: the plan sends it {route}")
    graphs.release(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    run = graph_runner(torch, model, frames, prompt)
    capture = graph_against_eager(torch, run, path)
    held = graphs.held_graphs(model)
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved() - reserved
    row = {"capture_ms": {k: round(v * 1e3, 2) for k, v in capture.items()},
           "graphs_held": held, "pool_gib": round(pool / 2 ** 30, 3)}
    for use, name in ((False, "eager"), (True, "graph")):
        walls = []
        for w in range(3):
            t0 = time.perf_counter()
            run(use, seed=30 + w)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(use)
        peak = torch.cuda.max_memory_allocated() - resident
        row[name] = dict(wall_ms=round(wall * 1e3, 2),
                         captions_per_s=round(b / wall, 2),
                         walls_ms=[round(x * 1e3, 2) for x in walls],
                         peak_above_resident_gib=round(peak / 2 ** 30, 3))
        if use:
            rec = device_records(torch, lambda: run(use))[1]
            row[name].update(host_calls=rec["host"],
                             device_kernels=sum(rec["kernels"].values()),
                             device_copies=rec["copies"],
                             device_memsets=rec["memsets"])
        log(f"  {path} {name}: wall a call {row[name]['wall_ms']} ms "
            f"(windows {row[name]['walls_ms']}), captions/s "
            f"{row[name]['captions_per_s']}; peak "
            f"{row[name]['peak_above_resident_gib']} GiB above the resident "
            f"tensors" + (f"; host calls a call {rec['host']} beside "
                          f"{row[name]['device_kernels']} device kernels"
                          if use else ""))
        if args.profile:
            device_profile(torch, lambda: run(use))
    rec = device_records(torch, lambda: preprocess_frames(
        model, frames, model.decoder.dtype))[1]
    row["preprocess_host_calls"] = rec["host"]
    log(f"  of a call, the eager preprocessing outside the graph: host calls "
        f"{rec['host']}, {sum(rec['kernels'].values())} device kernels; "
        f"graphs held {held}, their pool {row['pool_gib']} GiB reserved")
    if row["graph"]["host_calls"].get("cudaGraphLaunch") != 1:
        raise AssertionError(f"[graph] {path}: a replay is not one graph "
                             f"launch: {row['graph']['host_calls']}")
    if w8 is None:
        graphs.release(model)
        log(f"  [graph] {path} " + json.dumps(row))
        return row
    before = run(False)
    w = model.decoder.transformer.ln_f.weight
    with torch.no_grad():
        w.neg_()
    want = run(False)
    got = run(True), run(True)
    rewritten = graphs.held_graphs(model)
    ok = (torch.equal(got[0], want) and torch.equal(got[1], want)
          and not torch.equal(want, before) and rewritten == 1)
    log(f"  {path}: ln_f's sign flipped in place: the next call captured "
        f"anew ({rewritten} graph held), its ids and a replay's equal the "
        f"eager route's on the new weights: {ok}")
    with torch.no_grad():
        w.neg_()        # restored: another in-place write
    half = b // 2
    want = run(False, b=half)
    got = run(True, b=half), run(True, b=half)
    second = graphs.held_graphs(model)
    same = torch.equal(got[0], want) and torch.equal(got[1], want)
    again = run(True), run(True)
    full = graphs.held_graphs(model)
    same_full = torch.equal(again[0], before) and torch.equal(again[1],
                                                                before)
    ok_half = same and second == 1 and same_full and full == 2
    log(f"  {path}: right after the restoring write, batch {half}: captured "
        f"anew ({second} held), its capturing call's and a replay's ids "
        f"equal to eager: {same}; "
        f"the full batch captured anew ({full} held), equal to its first "
        f"ids: {same_full}")
    if not (ok and ok_half):
        raise AssertionError(f"[graph] {path}: recapture or second batch")
    for mode, quant_weights, kw in SERVE_MODES[1:]:
        m = w8 if quant_weights else model
        mode_run = graph_runner(torch, m, frames, prompt, kw)
        row[f"first_graphed_ms_{mode}"] = {
            k: round(v * 1e3, 2) for k, v in graph_against_eager(
                torch, mode_run, f"{path} {mode}", again=False,
                settings=GRAPH_SETTINGS[:1]).items()}
    graphs.release(model)
    graphs.release(w8)
    log(f"  [graph] {path} " + json.dumps(row))
    return row


def phase_parity(torch, model, phase: str, bos: int,
                 sensitivity: bool = False):
    """At batch 8: the first-step logits (the prefill's last row) and the
    greedy tokens of the kernel path against the plain-version path.  With
    ``sensitivity`` (a deep int4 decoder: a kernel summing in another f32
    order than the plain version moves its bf16 logits further than TOL),
    the plain path is run a second time with its int4 products summed in
    another f32 order (``int4_matmul_reordered``): the reference's own
    spread.  The kernel path then passes within TOL or within twice that
    spread (as the chain attention's error is held to twice the
    reference's rounding sensitivity)."""
    from image2text_torch.models.generation import (generate, prefill,
                                                    preprocess_frames)

    b = 8
    frames, prompt = serving_inputs(torch, model, b, SEED + 3, bos)
    images = preprocess_frames(model, frames, torch.bfloat16)

    def first_logits():
        return prefill(model, model.encoder(images), prompt,
                       1 + MAX_NEW_TOKENS)[0][:, -1]

    def greedy():    # eager: a replay would not see the plain versions
        return generate(model, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                        temperature=0.0, graphs=False)

    got, ids_k = first_logits(), greedy()
    with plain_versions():
        want, ids_p = first_logits(), greedy()
        if sensitivity:
            with int4_reordered(torch):
                other = first_logits()
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
    if sensitivity:
        s_rel, s_err, _, _ = logits_error(torch, other, want)
        log(f"  the plain path against itself with its int4 products summed "
            f"in another f32 order: relative L2 {s_rel:.6g}, max_abs_err "
            f"{s_err:.6g}; the kernel path's limits: relative L2 "
            f"{max(TOL, 2 * s_rel):.6g}, max_abs_err "
            f"{max(TOL * scale, 2 * s_err):.6g}")
        ok = ok or (bool(torch.isfinite(got).all()) and rel_l2 <= 2 * s_rel
                    and err <= max(TOL * scale, 2 * s_err))
    if not ok:
        raise AssertionError(f"{phase}: kernel path disagrees with the "
                             "plain path beyond tolerance")


@contextlib.contextmanager
def int4_reordered(torch):
    """The int4 plain version with its input split in two halves, each
    half's f32 product taken alone and the two summed: the same function
    in another f32 summation order (for ``phase_parity``'s
    sensitivity)."""
    from image2text_torch.ops import int4_matmul as i4

    def reordered(x, packed, scales, out_dtype=None):
        w = i4.dequantize_int4(packed, scales, torch.float32)
        h, xf = w.shape[1] // 2, x.float()
        return (torch.matmul(xf[..., :h], w[:, :h].t())
                + torch.matmul(xf[..., h:], w[:, h:].t())).to(
                    out_dtype or x.dtype)

    saved = i4.int4_matmul
    i4.int4_matmul = reordered
    try:
        yield
    finally:
        i4.int4_matmul = saved


@contextlib.contextmanager
def int4_dequantised_once(torch):
    """The int4 plain version with each weight dequantised at its first
    call and kept for the rest of the context: the same products, bit for
    bit, for CPU copies whose int4 weights do not change meanwhile (the
    plain version dequantises at every call: a CPU Llama-2-13B decode spent
    209 s of the smoke so, measured on one H100)."""
    from image2text_torch.ops import int4_matmul as i4

    kept, plain = {}, i4.int4_matmul_plain

    def once(x, packed, scales, out_dtype=None):
        if id(packed) not in kept:   # the tensor is held: its id stays its
            kept[id(packed)] = (packed, i4.dequantize_int4(
                packed, scales, torch.float32))
        return torch.matmul(x.float(), kept[id(packed)][1].t()).to(
            out_dtype or x.dtype)

    i4.int4_matmul_plain = once
    try:
        yield
    finally:
        i4.int4_matmul_plain = plain


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


def phase_beam(torch, model, args, results, path: str = "flagship_beam",
               **kw):
    """The beam-search serving path (bench.py::_bench_beam at batch 64):
    raw uint8 frames → caption; launches in one call held to
    ``serving_launches`` over the rounds it ran, and captions/s, the
    median of 3 warm windows.  ``kw`` goes to the generator (a serving
    mode: ``cross_kv_quant``).  Returns the ids (b, beams, T) and the
    captions/s."""
    dev, b = model.device, BEAM_BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 12,
                                    FLAGSHIP_BOS)
    beam = beam_generator(model, **kw)
    bw = beam.beam_width

    def run(seed):
        return beam.caption(frames, prompt,
                            torch.Generator(device=dev).manual_seed(seed))

    rounds = []

    def want():     # the prefill and one decoder forward per round
        rounds.append(beam.rounds)
        return serving_launches(model, 1 + beam.rounds)

    (ids, scores), rate = drive_serving(
        torch, args, results, path, run, b, want,
        f"one beam-search call (width {bw} x expansion "
        f"{beam.beam_expansion_factor}: {bw * b} decode rows)")
    vocab = vocab_rows(model)
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
    return ids, rate


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


# bench.py's serving modes (BENCH_FULL=1, bench.py:243-274) and all of them
# stacked: (name, W8A8 decoder weights, generate's mode arguments)
SERVE_MODES = (
    ("exact", False, {}),
    ("int8_kv", False, dict(cross_kv_quant="int8")),
    ("w8a8", True, dict(cross_kv_quant="int8")),
    ("approx", False, dict(approx_top_k=True)),
    ("all", True, dict(cross_kv_quant="int8", approx_top_k=True)),
)


# GPT-2-medium's modes: exact, and int8 cross-KV with W8A8 float weights
GPT2M_MODES = (SERVE_MODES[0], ("int8", True, dict(cross_kv_quant="int8")))


def w8a8_model(model):
    """A copy of ``model`` whose decoder holds its W8A8 serving form at
    ``int8_serving_params``' default min_elems, as bench.py's
    ``int8_serving`` mode builds it (the MoE gates stay float, so
    ``moe_ffn`` keeps its inputs)."""
    from image2text_torch.models.quantization import int8_serving_params

    q = copy.deepcopy(model)
    int8_serving_params(q.decoder)
    return q


def int8_forms(model) -> list:
    """Paths of the modules holding an int8 serving form."""
    return [n for n, m in model.named_modules() if getattr(m, "is_int8",
                                                             False)]


def mode_logits(torch, model, enc, ids, quant=None):
    """Logits of ``model`` in a serving mode on the encoder output ``enc``:
    (the prefill's last row on the one-token prompt ``ids[:, :1]``, which
    reads the exact cross K/V as JAX's prefill does; a prefill over
    ``ids[:, :8]`` against the mode's cross K/V (``quant``), whose rows
    stand for decode steps' logits)."""
    from image2text_torch.models.generation import (prefill,
                                                    precompute_cross_kv,
                                                    quantize_cross_kv)

    kv = precompute_cross_kv(model, enc)
    first = prefill(model, enc, ids[:, :1], 1, kv)[0][:, -1]
    kv = quantize_cross_kv(kv, quant)
    steps = prefill(model, enc, ids[:, :8], 8, kv)[0]
    return first.float(), steps.float()


def cpu_copy(model):
    """A CPU copy of ``model`` that holds no card memory: the cached kernel
    operands and padded int8 weights it copied are dropped."""
    from image2text_torch.models.layers import _Cached

    c = copy.deepcopy(model).cpu()
    for mod in c.modules():
        for value in vars(mod).values():
            if isinstance(value, _Cached):
                value.clear()
        vars(mod).pop("_padded", None)
    return c


def cpu_mode_check(torch, m, cpu_m, images, ids, quant, mode: str):
    """One mode's logits (``mode_logits``, ``CPU_ROWS`` images) on the card
    against the same mode on a CPU copy of the same model, on the card's
    encoder output: the card's int8 cross-attention read and W8A8 products
    against the CPU's plain ones.  Fails beyond ``CPU_MODE_TOL``."""
    enc = m.encoder(images[:CPU_ROWS])
    ids = ids[:CPU_ROWS]
    got = mode_logits(torch, m, enc, ids, quant)
    want = mode_logits(torch, cpu_m, enc.cpu(), ids.cpu(), quant)
    errs = [rel_l2(torch, g.cpu(), w) for g, w in zip(got, want)]
    log(f"  {mode}: card against a CPU copy in the same mode ({CPU_ROWS} "
        f"images), relative L2: prefill {errs[0]:.6g}, 8-token prefill "
        f"{errs[1]:.6g} (limit {CPU_MODE_TOL})")
    if not all(bool(torch.isfinite(g).all()) for g in got) or (
            max(errs) > CPU_MODE_TOL):
        raise AssertionError(f"serve-modes {mode}: card against CPU {errs}")
    return errs


def rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def phase_serve_modes(torch, model, w8, args, results, modes=SERVE_MODES,
                      bos: int = FLAGSHIP_BOS, tag: str = "serve"):
    """bench.py's serving modes (batch 256, 32 new tokens, temperature 0.7,
    top-k 16, n-grams 2–5) in this process: for the flagship exact, int8
    cross-KV, W8A8 decoder weights with int8 cross-KV, approx top-k, and
    all stacked (``modes``).  Each mode: launches of one caption call held to
    ``serving_launches`` (unchanged by the mode), captions/s (median of 3
    windows; --profile: device busy ms and share), W8A8 products per call,
    peak memory, the logits of a one-token prefill and of an 8-token one
    against the mode's cross memory, each against exact (relative L2; an
    int8 mode must differ from exact, so none runs exact unnoticed) and
    against the same mode on a CPU copy of the model (``cpu_mode_check``,
    held to ``CPU_MODE_TOL``), and greedy tokens against exact over 32
    tokens.
    ``approx`` must equal ``exact`` token for token under the same
    generator (the port takes approx top-k as exact)."""
    from image2text_torch.models.generation import caption, generate
    from image2text_torch.models.graphs import graph_plan
    from image2text_torch.ops.functions import int8_mm
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    dev, b = model.device, BATCH
    frames, prompt = serving_inputs(torch, model, b, SEED + 2, bos)
    images = resize_normalize_on_device(
        frames, model.config.vision_encoder_config.input.width,
        out_dtype=torch.bfloat16)
    forms = int8_forms(w8)
    log(f"  W8A8 decoder: {len(forms)} int8 forms: {forms[:3]} ... "
        f"{forms[-2:]}")
    cpu_copies = {False: cpu_copy(model), True: cpu_copy(w8)}
    summary, counted, greedy, exact_logits = {}, {}, {}, None
    for mode, quant_weights, kw in modes:
        m = w8 if quant_weights else model
        quant = kw.get("cross_kv_quant")
        route, why = graph_plan(m, dev, prompt_len=1,
                                max_new_tokens=MAX_NEW_TOKENS)
        graphed = route == "graph"
        log(f"  mode {mode}: {'W8A8 decoder, ' if quant_weights else ''}"
            f"{kw or 'exact'}; route {route} ({why})")

        def run(seed, m=m, kw=kw, use=True):
            g = torch.Generator(device=dev).manual_seed(seed)
            return caption(m, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
                           temperature=0.7, top_k=16, generator=g,
                           graphs=use, **kw)

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        products = int8_mm.launches
        ids, rate = drive_serving(torch, args, results, f"{tag}_{mode}", run,
                                  b, lambda: serving_launches(model),
                                  f"one caption call ({mode})",
                                  eager=(lambda seed, run=run: run(
                                      seed, use=False)) if graphed else None)
        peak = torch.cuda.max_memory_allocated()
        # drive_serving's calls (6; 4 on the eager route), the greedy call
        # below, the profiled one
        calls = (6 if graphed else 4) + 1 + bool(args.profile)
        per_call = (int8_mm.launches - products) / calls
        counted[mode] = ids
        greedy[mode] = generate(m, images, prompt,
                                max_new_tokens=MAX_NEW_TOKENS,
                                temperature=0.0, **kw)
        got = mode_logits(torch, m, m.encoder(images), greedy["exact"],
                          quant)
        exact_logits = exact_logits or got
        on_cpu = cpu_mode_check(torch, m, cpu_copies[quant_weights], images,
                                greedy["exact"], quant, mode)
        agree = float((greedy[mode][:, 1:] == greedy["exact"][:, 1:]).float()
                      .mean())
        summary[mode] = dict(
            captions_per_s=round(rate, 2),
            peak_gib=round(peak / 2 ** 30, 3),
            peak_above_resident_gib=round((peak - resident) / 2 ** 30, 3),
            int8_products_per_call=per_call,
            prefill_rel_l2=rel_l2(torch, got[0], exact_logits[0]),
            steps_rel_l2=rel_l2(torch, got[1], exact_logits[1]),
            greedy_agreement=agree, cpu_prefill_rel_l2=on_cpu[0],
            cpu_steps_rel_l2=on_cpu[1])
        log(f"  {mode}: peak {summary[mode]['peak_gib']} GiB "
            f"({summary[mode]['peak_above_resident_gib']} above the resident "
            f"weights of both models); W8A8 products per call {per_call}; "
            f"prefill logits relative L2 against exact "
            f"{summary[mode]['prefill_rel_l2']:.6g}, an 8-token prefill "
            f"on exact's greedy ids {summary[mode]['steps_rel_l2']:.6g}; "
            f"greedy tokens equal "
            f"to exact's over {MAX_NEW_TOKENS} steps: {agree:.4f}")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"serve-modes {mode}: logits not finite")
        if (per_call > 0) != quant_weights:
            raise AssertionError(f"serve-modes {mode}: {per_call} W8A8 "
                                 "products a call")
        if (quant is not None or quant_weights) and not (
                summary[mode]["steps_rel_l2"] > 0
                and (summary[mode]["prefill_rel_l2"] > 0) == quant_weights):
            raise AssertionError(f"serve-modes {mode}: the logits do not "
                                 "show its int8 forms")
    del cpu_copies
    for mode in [m for m in ("approx", "all") if m in summary]:
        base = "exact" if mode == "approx" else "w8a8"
        same = bool(torch.equal(counted[mode], counted[base])
                    and torch.equal(greedy[mode], greedy[base]))
        log(f"  {mode} equals {base} token for token (sampled under the "
            f"same generator, and greedy): {same}")
        if not same:
            raise AssertionError(f"serve-modes: {mode} differs from {base}")
    log(f"  [{tag}-modes] summary " + json.dumps(summary))
    return summary


def phase_encoder_w8a8(torch, w8, results, b: int = 16):
    """The encoder in W8A8 as well (JAX's
    ``test_int8_serving_composes_on_encoder_subtree``), one caption call
    at batch ``b``: its blocks hold int8 forms, so none takes the
    sparse_block kernel (JAX's chain gate declines W8A8 forms) and the
    front runs its module chain; each block's MoE FFN, whose gates stay
    float, launches moe_ffn instead.  Launches held to that derivation."""
    from image2text_torch.models.generation import caption
    from image2text_torch.models.quantization import int8_serving_params

    m = copy.deepcopy(w8)
    int8_serving_params(m.encoder)
    enc = m.vision_encoder
    frames, prompt = serving_inputs(torch, m, b, SEED + 16, FLAGSHIP_BOS)
    want = serving_launches(m)
    t = enc.n_cls + enc.n_patches ** 2
    want["moe_ffn"] += sum(blk.runs_body(t) for blk in enc.blocks)
    want["sparse_block"] = want["fused_frontend"] = 0

    def run():
        return caption(m, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.7, top_k=16, cross_kv_quant="int8",
                       generator=torch.Generator(device=m.device)
                       .manual_seed(SEED))

    run()
    counts, ids = launch_counts(run)
    record_launches(results, "serve_w8a8_encoder", counts)
    log(f"  encoder in W8A8 too ({len(int8_forms(m.encoder))} int8 forms in "
        f"it), batch {b}: launches {counts} (want {want})")
    if counts != want or tuple(ids.shape) != (b, 1 + MAX_NEW_TOKENS):
        raise AssertionError(f"encoder W8A8: launches {counts} != {want}")


def phase_int8_products(torch, w8):
    """The W8A8 product (``ops/functions.py::int8_mm``: ``torch._int_mm``
    on zero-padded operands) at the flagship's shapes, the int32 result
    bit for bit against the CPU's exact product on the same int8 operands:
    the tied lm_head (its 50,258 rows padded), every decode projection,
    at 256, 192 (beam) and 1 (rows padded) decode rows, with the weight
    padded in the call and through the form's operand padded once.  Then
    the W8A8 lm_head (activation rounding, product, scales) as the form
    runs it, and with the table padded in every call, against the exact
    mode's bf16 ``dot_f32`` lm_head, CUDA-event ms."""
    from image2text_torch.nn.modules import int8_dot_rows, quantize_rows_int8
    from image2text_torch.ops.functions import (dot_f32, int8_mm,
                                                int8_mm_plain,
                                                int8_mm_shapes)

    dec = w8.decoder
    blk = dec.blocks[0]
    weights = (("lm_head", dec.transformer.wte),
               ("q_proj", blk.attn.q_proj), ("kv_proj", blk.attn.kv_proj),
               ("out_proj", blk.attn.out_proj),
               ("null_connector", blk.null_connector),
               ("cross out_proj", blk.cross_attn.out_proj))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = torch.randn(BATCH, 1024, device="cuda", generator=gen).to(
        torch.bfloat16)
    xq, _ = quantize_rows_int8(x)
    ok = True
    for name, mod in weights:
        ok &= w8a8_against_cpu(torch, x, mod, name)
        for rows in (BATCH, 3 * BEAM_BATCH, 1):
            a = xq[:rows]
            want = int8_mm_plain(a.cpu(), mod.qweight.cpu())
            kept = int8_mm(a, mod.int8_operand())[:, :want.shape[1]]
            equal = bool(torch.equal(int8_mm(a, mod.qweight).cpu(), want)
                         and torch.equal(kept.cpu(), want))
            ok &= equal
            log(f"    int8 product {name} {rows} x {mod.qweight.shape[1]} x "
                f"{mod.qweight.shape[0]} (padded to "
                f"{int8_mm_shapes(rows, mod.qweight.shape[1], mod.qweight.shape[0])}"
                f"; also through the form's padded operand): int32 equal "
                f"to the CPU's bit for bit: {equal}")
    wte = dec.transformer.wte
    w_exact = torch.empty(wte.qweight.shape, dtype=torch.bfloat16,
                          device="cuda").normal_(0, 0.02, generator=gen)
    ms = {"w8a8": cuda_ms(torch, lambda: wte.lm_head(x)),
          "int8_mm": cuda_ms(torch, lambda: int8_mm(xq, wte.int8_operand())),
          "padding": cuda_ms(torch, lambda: int8_dot_rows(x, wte.qweight,
                                                          wte.qscale)),
          "dot_f32": cuda_ms(torch, lambda: dot_f32(x, w_exact))}
    log(f"    lm_head {BATCH} x 1024 x {wte.qweight.shape[0]}: W8A8 "
        f"{ms['w8a8']:.4f} ms (its int8 product alone {ms['int8_mm']:.4f}; "
        f"with the table padded in every call {ms['padding']:.4f}) against "
        f"the exact bf16 dot_f32 {ms['dot_f32']:.4f} ms")
    if not ok:
        raise AssertionError("int8 products differ from the CPU's")


def w8a8_against_cpu(torch, x, mod, name: str) -> bool:
    """One W8A8 product as an int8 form runs it on the card
    (``int8_dot_rows`` through its padded operand) against the CPU on the
    same input: the row scales and the int8 activations equal the CPU's
    bit for bit (0 ulp, 0 activations on another quantum: the scale is a
    true division on the card too, ``nn/modules.py::divide``), and the
    result equal bit for bit to the CPU's product and scales."""
    from image2text_torch.nn.modules import int8_dot_rows, quantize_rows_int8
    from image2text_torch.ops.functions import int8_mm_plain

    got = int8_dot_rows(x, mod.int8_operand(), mod.qscale).cpu()
    xq, xs = (t.cpu() for t in quantize_rows_int8(x))
    cq, cs = quantize_rows_int8(x.cpu())
    ulps = int((xs.view(torch.int32).long() - cs.view(torch.int32).long())
               .abs().max())
    flips = int((xq != cq).sum())
    want = (int8_mm_plain(cq, mod.qweight.cpu()).float() * cs[..., None]
            * mod.qscale.cpu())
    same = bool(torch.equal(got, want))
    log(f"    W8A8 {name} {x.shape[0]} rows, card against CPU: scales within "
        f"{ulps} ulp, {flips} of {xq.numel()} activations on the other "
        f"quantum, the product and scales equal the CPU's bit for bit: "
        f"{same}")
    return same and ulps == 0 and flips == 0


def phase_int8_kv_read(torch, model, b: int = BATCH):
    """The int8 cross-attention read (``MultiheadAttention.
    _int8_kv_attention``, bf16) on the card at the flagship's decode shape
    (``b`` rows, one query each, a cross layer's K/V of the encoder's
    output) against an f64 computation of the same read from the same q
    and int8 memory on the CPU.  The read rounds twice to bf16 (the scaled
    probabilities and the output, each within 2^-9 relative), so the
    relative L2 stays near 2^-8; it fails beyond ``INT8_READ_TOL``."""
    from image2text_torch.nn.core import EVAL_CTX
    from image2text_torch.nn.modules import QuantizedKV
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    attn = next(blk.cross_attn for blk in model.decoder.blocks
                if blk.is_cross_attn)
    frames, _ = serving_inputs(torch, model, 16, SEED + 17, FLAGSHIP_BOS)
    images = resize_normalize_on_device(
        frames, model.config.vision_encoder_config.input.width,
        out_dtype=torch.bfloat16)
    enc = model.encoder(images).repeat(b // 16, 1, 1)
    kv = QuantizedKV.of(*attn.project_kv(enc, enc))
    g = torch.Generator(device=model.device).manual_seed(SEED + 18)
    query = torch.randn(b, 1, attn.embed_dim, device=model.device,
                        generator=g).to(torch.bfloat16)
    q = attn._split_heads(attn._proj(query, 0))
    got = attn._int8_kv_attention(q, kv, query, EVAL_CTX).cpu().double()
    kq, ks, vq, vs = (t.cpu().double() for t in kv)
    scores = (q.cpu().double() @ kq.transpose(-1, -2) * ks[..., None, :]
              / math.sqrt(attn.head_dim))
    pv = torch.softmax(scores, dim=-1) * vs[..., None, :]
    want = (pv @ vq).transpose(-3, -2).reshape(got.shape)
    err = rel_l2(torch, got, want)
    log(f"    int8 cross-attention read, {b} rows x {kq.shape[-2]} memory "
        f"positions x {attn.num_heads} heads: relative L2 against f64 "
        f"{err:.6g} (limit {INT8_READ_TOL})")
    if not err <= INT8_READ_TOL:
        raise AssertionError(f"int8 cross-attention read: {err}")


def phase_beam_modes(torch, model, w8, args, results):
    """Beam search (bench.py::_bench_beam: batch 64, width 3, expansion 4,
    31 rounds) exact, with int8 cross-KV, and with W8A8 decoder weights
    and int8 cross-KV, in this process: captions/s, launches held to the
    rounds each ran (moe_ffn unchanged by the mode), and the greedy beam
    ids (temperature 0, consolidation 0) of each int8 mode against
    exact's."""
    frames, prompt = serving_inputs(torch, model, BEAM_BATCH, SEED + 12,
                                    FLAGSHIP_BOS)
    rates, beams = {}, {}
    for mode, m, kw in (("exact", model, {}),
                        ("int8_kv", model, dict(cross_kv_quant="int8")),
                        ("w8a8", w8, dict(cross_kv_quant="int8"))):
        log(f"  beam mode {mode}")
        _, rates[mode] = phase_beam(torch, m, args, results,
                                    path=f"beam_{mode}", **kw)
        greedy = beam_generator(m, temperature=0.0,
                                consolidation_temperature=0.0, **kw)
        beams[mode] = greedy.caption(frames, prompt)[0]
    for mode in ("int8_kv", "w8a8"):
        same = (beams[mode] == beams["exact"]).all(-1).all(-1)
        agree = float((beams[mode] == beams["exact"]).float().mean())
        log(f"  {mode}: {rates[mode]:.2f} captions/s against exact's "
            f"{rates['exact']:.2f} (x{rates[mode] / rates['exact']:.3f}); "
            f"greedy beam ids equal to exact's in {int(same.sum())} of "
            f"{BEAM_BATCH} samples, {agree:.4f} of the ids")
    return rates


def reforward_launches(model, t0: int, n_new: int):
    """Launches of a greedy ``generate(force_no_cache=True)`` from images:
    the encoder once (fused_frontend, sparse_block per sparse block that
    runs its body), then one non-cached decoder forward per new token over
    the whole buffer of ``space_for_prompt + t0 + n_new`` rows (cut at the
    block size), each running the MoE FFN of the blocks the bypass rule at
    the current length keeps (``reforward_ffn_evaluations``)."""
    want = serving_launches(model, 0)
    dec, off = model.decoder, model.space_for_prompt
    t = min(dec.block_size, off + t0 + n_new)
    want["moe_ffn"] = sum(dec.reforward_ffn_evaluations(t, off + t0 + i)
                          for i in range(n_new))
    return want


def phase_reforward_flagship(torch, model, results, b: int = 16):
    """The full-reforward fallback on the flagship at full width
    (``force_no_cache``, greedy, batch 16, 32 new tokens): launches held to
    ``reforward_launches``, the wall time of the call, and the ids against
    the cached path's (reported: the two paths round bf16 differently)."""
    from image2text_torch.models.generation import generate
    from image2text_torch.ops.preprocess import resize_normalize_on_device

    frames, prompt = serving_inputs(torch, model, b, SEED + 14, FLAGSHIP_BOS)
    images = resize_normalize_on_device(
        frames, model.config.vision_encoder_config.input.width,
        out_dtype=torch.bfloat16)

    def run():
        return generate(model, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                        temperature=0.0, force_no_cache=True)

    run()
    t0 = time.perf_counter()
    counts, ids = launch_counts(run)
    wall = time.perf_counter() - t0
    record_launches(results, "flagship_reforward", counts)
    want = reforward_launches(model, 1, MAX_NEW_TOKENS)
    cached = generate(model, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                      temperature=0.0)
    agree = float((ids[:, 1:] == cached[:, 1:]).float().mean())
    log(f"  force_no_cache, batch {b}: launches {counts} (want {want}); "
        f"{wall * 1e3:.1f} ms a call; greedy ids equal to the cached "
        f"path's: {agree:.4f}")
    if counts != want:
        raise AssertionError(f"reforward launches {counts} != {want}")
    if tuple(ids.shape) != (b, 1 + MAX_NEW_TOKENS):
        raise AssertionError("reforward: malformed ids")


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its launch count: the
    counted wrappers but the W8A8 product (``torch._int_mm``, no kernel of
    the port's)."""
    from image2text_torch.models.graphs import counted_wrappers
    from image2text_torch.ops.functions import int8_mm

    return tuple(w for w in counted_wrappers() if w is not int8_mm)


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


def flash_f32_plan(torch, label: str, q, k) -> dict:
    """Log the f32 flash kernels' plan at one call (the forward's and the
    dQ kernel's groups a plane, the dK/dV kernel's groups a key tile, each
    kernel's registers and spill bytes from the build's -Xptxas -v) and
    return it."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.utils.device import sm_count

    (b, h, sq, d), hk, s = q.shape, k.shape[1], k.shape[2]
    dk = fa.kernel_head_dim(d)
    groups = fa.f32_groups(h, hk, sq)
    dkv_groups = fa.f32_bwd_plan(b, h, hk, sq, s, sm_count(q.device), dk)
    res = {kind: _build.resources("flash_attention_f32",
                                  f"flash_{kind}_f32_kernelILi{dk}E")
           for kind in ("fwd", "bwd_dkv", "bwd_dq")}
    key_tiles = b * hk * -(-s // fa.f32_dkv_keys(dk))
    log(f"    flash f32 {label}: forward and dQ G {groups} ({groups * b * hk} "
        f"blocks), dK/dV G {dkv_groups} ({dkv_groups * key_tiles} blocks, "
        f"partials {fa.part_elems(dkv_groups, b * hk * s * dk):,} f32); "
        f"(registers, bytes spilled) {res}")
    return dict(fwd_groups=groups, dkv_groups=dkv_groups, dq_groups=groups,
                resources=res)


def f32_flash_bound(label: str, kind: str, q, k, bias, causal, ms: float):
    """(bound ms, bound_by) of an f32 flash call: the larger of its bytes
    at the memory rate and 3 × its FLOP at the TF32 peak (3xTF32: the least
    time for f32-accurate products on the card), logged beside the bound
    at the f32 FFMA peak."""
    n_bytes, flops = flash_work(q, k, bias, causal, kind)
    bms, by = bound_ms(n_bytes, 3 * flops, TF32_FLOP_PER_S)
    ffma, ffma_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    log(f"    flash_{kind} {label}: bound {bms:.5f} ms ({by}; 3 x "
        f"{flops / 1e9:.4f} GFLOP at the TF32 peak, {n_bytes / 1e6:.3f} MB), "
        f"kernel at {bms / ms:.3f} of it; at the f32 FFMA peak {ffma:.5f} ms "
        f"({ffma_by}), kernel at {ffma / ms:.3f} of that")
    return bms, by


def flash_plan(torch, label: str, q, k, causal: bool, pairs: int,
               check: bool) -> dict:
    """Log the bf16 flash kernels' plans at one call (routes, groups, each
    kernel's registers and spill bytes from the build's -Xptxas -v) and
    the backward's visited pairs against ``bwd_pairs`` (resident: query
    tile × key slice) or ``tiled_bwd_pairs`` (tiled: query tile × key
    tile); with ``check`` (no bias leaving a row keyless) raise where they
    differ.  Returns them as a dict."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.utils.device import sm_count

    (b, h, sq, d), hk, s = q.shape, k.shape[1], k.shape[2]
    n_sms, dk = sm_count(q.device), fa.kernel_head_dim(d)
    fwd_route, fwd_groups = fa.fwd_plan(b, h, hk, sq, s, n_sms, dk)
    fwd_kernel = {"resident": "flash_fwd_res_kernel",
                  "tiled": "flash_fwd_tiled_kernel"}[fwd_route]
    regs, spills = _build.resources("flash_attention",
                                    f"{fwd_kernel}ILi{dk}E")
    log(f"    flash_fwd {label}: route {fwd_route}, G {fwd_groups}; "
        f"{regs} registers, {spills} bytes spilled a thread")
    route, groups = fa.bwd_plan(b, h, hk, sq, s, n_sms, dk)
    if route == "resident":
        count, unit = fa.bwd_pairs, (f"{fa.BWD_TILE_ROWS}-row query "
                                     f"tile, {fa.BWD_KEY_SLICE}-key slice")
        bwd_kernels = ("flash_bwd_kernel",)
        extra = ""
    else:
        count, unit = fa.tiled_bwd_pairs, (f"{fa.DKV_ROWS}-row query "
                                           f"tile, {fa.DKV_KEYS}-key tile")
        bwd_kernels = ("flash_bwd_dkv_tiled_kernel",
                       "flash_bwd_dq_tiled_kernel")
        extra = f", dQ G {fa.tiled_groups(h, hk, sq)}"
    want, full = count(b, h, sq, s, causal), count(b, h, sq, s, False)
    bwd_res = [_build.resources("flash_attention", f"{kn}ILi{dk}E")
               for kn in bwd_kernels]
    log(f"    flash_bwd {label}: route {route}, G {groups}{extra}; "
        f"registers, bytes spilled a thread {bwd_res}; ({unit}) pairs "
        f"visited {pairs} (want {want}; {full} without the causal skip)")
    if check and pairs != want:
        raise AssertionError(f"flash_bwd {label}: pairs {pairs} != {want}")
    return dict(fwd_route=fwd_route, fwd_groups=fwd_groups, registers=regs,
                spill_bytes=spills, bwd_route=route, bwd_groups=groups,
                bwd_resources=bwd_res, pairs=pairs)


def phase_flash_kernels(torch, args, results, cases=FLASH_FLAGSHIP):
    """The flash forward and the flash backward against their plain
    versions at training attention shapes, same inputs and dropout seed;
    the backward twice more, bitwise equal; its visited (query tile, key
    slice) pairs held to ``bwd_pairs`` on the resident route, its (query
    tile, key tile) pairs to ``tiled_bwd_pairs`` on the tiled one; each
    route's G, registers and spills logged.  The first flagship case fills
    the kernels' rows, every other case a ``<label>_shape``."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    seed = -987654321
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
        plan = flash_plan(torch, label, q, k, causal, int(pairs), True)
        log(f"    flash_bwd {label}: two more launches bitwise equal: {same}")
        if not same:
            raise AssertionError(f"flash_bwd {label}: not deterministic")
        fwd_route, fwd_groups, regs, spills = (
            plan[x] for x in ("fwd_route", "fwd_groups", "registers",
                              "spill_bytes"))
        route, groups, bwd_res = (plan[x] for x in ("bwd_route",
                                                    "bwd_groups",
                                                    "bwd_resources"))
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
                           pairs=int(pairs), groups=groups, plan_route=route,
                           resources=bwd_res)
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
    labels: per micro-batch (``gradient_accumulation_steps`` of them) one
    forward and one backward per self-attention call of the model
    (``sdpa_calls``: every call lies upstream of a trainable parameter in
    each configuration run here), and a second forward, the recompute, per
    call of a stack that checkpoints its blocks."""
    dec = model.decoder
    n_dec = dec.sdpa_calls(min(dec.block_size,
                               model.space_for_prompt + seq_len))
    n_enc = model.sdpa_calls(seq_len) - n_dec
    m = cfg.model
    remat = (n_enc * bool(getattr(m.vision_encoder_config,
                                  "enable_gradient_checkpointing", False))
             + n_dec * bool(m.decoder_config.enable_gradient_checkpointing))
    k = cfg.gradient_accumulation_steps
    return {"flash_fwd": k * (n_enc + n_dec + remat),
            "flash_bwd": k * (n_enc + n_dec)}


def train_launches(cfg, model, seq_len: int):
    """Launches of each kernel wrapper in one training step: the flash
    kernels as ``flash_launches_per_step``; per micro-batch one
    int4_matmul per quantized Linear in the forward and, where the decoder
    checkpoints its blocks, again in the recompute; no serving kernel."""
    from image2text_torch.models.quantization import QuantizedLinear

    n_q = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    remat = bool(cfg.model.decoder_config.enable_gradient_checkpointing)
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    want.update(int4_matmul=cfg.gradient_accumulation_steps * n_q
                * (1 + remat),
                **flash_launches_per_step(cfg, model, seq_len))
    return want


def tensor_digest(torch, t, chunk: int = 1 << 26):
    """A digest of ``t``'s bits computed on its device, chunk by chunk (no
    copy of the tensor): the sum and a position-weighted sum of its 32-,
    16- or 8-bit words as int64."""
    flat = t.detach().reshape(-1).view(torch.uint8)
    for dt, size in ((torch.int32, 4), (torch.int16, 2)):
        if flat.numel() % size == 0:
            flat = flat.view(dt)
            break
    total = weighted = 0
    for start in range(0, flat.numel(), chunk):
        w = flat[start:start + chunk].to(torch.int64)
        pos = torch.arange(start, start + w.numel(), device=w.device)
        total += int(w.sum())
        weighted += int((w * (pos % 1_000_003 + 1)).sum())
    return total, weighted


@contextlib.contextmanager
def kernel_shapes(flash: dict, int4: set):
    """Record what the kernel autograd Functions are given while inside:
    each flash forward's (q shape, K/V heads, causal, rate, dtype) with its
    bias, each int4_matmul's (rows, in, out)."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops import int4_matmul as im

    f0, i0 = fa.FlashSDPA.forward, im.Int4Matmul.forward

    def flash_forward(ctx, q, k, v, bias, causal, rate, seed, planes=None):
        key = (tuple(q.shape), k.shape[1], k.shape[2], causal, rate, q.dtype)
        if key not in flash:
            flash[key] = None if bias is None else bias.detach().cpu()
        return f0(ctx, q, k, v, bias, causal, rate, seed, planes)

    def int4_forward(ctx, x, packed, scales, *rest):
        int4.add((x.numel() // x.shape[-1], x.shape[-1], packed.shape[0]))
        return i0(ctx, x, packed, scales, *rest)

    fa.FlashSDPA.forward = staticmethod(flash_forward)
    im.Int4Matmul.forward = staticmethod(int4_forward)
    try:
        yield
    finally:
        fa.FlashSDPA.forward = staticmethod(f0)
        im.Int4Matmul.forward = staticmethod(i0)


def phase_train(torch, args, results, path: str, setup, inputs,
                steps_per_window: int = 4, keep: bool = False,
                shapes=None):
    """A training step at full width and depth (``setup()`` gives the
    config, the wrapper and its Trainer; ``inputs(cfg)`` the batch):
    launches in one step held to ``train_launches`` (and, given
    ``shapes`` = (flash dict, int4 set), the kernels' shapes recorded),
    then 3 windows of ``steps_per_window`` steps on the batch: step ms,
    tokens/s, peak memory, the loss of every step (finite and lower at the
    end), every frozen tensor (a parameter no optimizer moves, the int4
    weights) unchanged by a digest taken on the card.  ``keep``: return
    the model (its gradients dropped) instead of freeing it."""
    from image2text_torch.nn.core import frozen_param_paths

    cfg, wrapper, trainer = setup()
    model = wrapper.model
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    n_trainable = sum(p.numel() for p in named.values() if p.requires_grad)
    tensors = named | dict(model.named_buffers())
    frozen_names = sorted({k for k, p in named.items() if not p.requires_grad}
                          | (set(frozen_param_paths(model)) & set(tensors)))
    n_frozen = sum(tensors[k].numel() for k in frozen_names)
    frozen = {k: tensor_digest(torch, tensors[k]) for k in frozen_names}
    images, labels = inputs(cfg)
    batch, seq = labels.shape
    step = trainer._train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    record = (kernel_shapes(*shapes) if shapes is not None
              else contextlib.nullcontext())
    with record:
        counts, metrics = launch_counts(
            lambda: step(images, labels, cfg.seed, 0))
    losses = [metrics["train_loss_lm"]]
    record_launches(results, path, counts)
    want = train_launches(cfg, model, seq)
    log(f"  training step ({n_params:,} float parameters, {n_trainable:,} "
        f"trainable; {len(frozen)} frozen tensors, {n_frozen:,} elements; "
        f"batch {batch} x {seq} labels, gradient accumulation "
        f"{cfg.gradient_accumulation_steps}, precision {cfg.precision!r}, "
        f"{'SNRAdam' if cfg.use_snr_optim else 'AdamW'}, remat policy "
        f"{cfg.remat_policy or 'full'}): launches in one step {counts} "
        f"(want {want})")
    if counts != want:
        raise AssertionError(f"{path} launch counts {counts} != {want}")
    windows = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps_per_window):
            losses.append(step(images, labels, cfg.seed,
                               1 + steps_per_window * w + i)["train_loss_lm"])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / steps_per_window)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    step_s = statistics.median(windows)
    log(f"  step ms (median of 3 windows of {steps_per_window} steps): "
        f"{step_s * 1e3:.2f}; windows {[round(x * 1e3, 2) for x in windows]}; "
        f"tokens/s (label positions) {batch * seq / step_s:.1f}; peak memory "
        f"{peak:.3f} GiB on {torch.cuda.get_device_name(0)} ({CARD})")
    log(f"  loss by step: {[round(x, 5) for x in losses]}")
    moved = [k for k, v in frozen.items()
             if tensor_digest(torch, tensors[k]) != v]
    log(f"  frozen tensors changed by the steps (digest on the card): "
        f"{len(moved)} of {len(frozen)}")
    if (moved or not all(math.isfinite(x) for x in losses)
            or losses[-1] >= losses[0]):
        raise AssertionError(f"{path}: frozen moved {moved[:3]} or loss not "
                             f"finite or not falling {losses}")
    if args.profile:
        log("  device time by kernel, one training step:")
        device_profile(torch, lambda: step(images, labels, cfg.seed, 99),
                       top=16)
    del trainer, tensors, frozen, named, images, labels
    for p in model.parameters():
        p.grad = None
    if keep:
        return model
    del wrapper, model
    torch.cuda.empty_cache()
    return None


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


def int4_work(x, packed, scales):
    """(bytes, FLOP) of one int4_matmul call on ``x``: x, the packed weight
    and the scales read once, y written once; 2·rows·out·in_pad
    operations."""
    rows, in_pad = x.numel() // x.shape[-1], x.shape[-1]
    out_bytes = rows * packed.shape[0] * x.element_size()
    return (nbytes(x, packed, scales) + out_bytes,
            2 * rows * packed.shape[0] * in_pad)


def int4_case(torch, results, key: str, x, packed, scales,
              iters: int = 20, f32_out: bool = False) -> dict:
    """int4_matmul on ``x`` against its plain version, with the plan (tile,
    splits of the input) and two more launches bitwise equal; beside it
    torch.matmul on the weight dequantised once to bf16, a yardstick the
    port never calls.  ``f32_out``: also the f32 output (``out_dtype``
    f32, a row shard's unrounded partial product, written by the tile
    kernel or, with splits, by the reduce kernel) against the plain
    version's f32 output at the f32 limits, and its time.  Kept as the
    int4_matmul row's ``<key>_shape`` (the first case also gives the
    row's own numbers); its device time is read at the end of the run,
    with x held on the host meanwhile."""
    from image2text_torch.ops.int4_matmul import (dequantize_int4,
                                                  int4_matmul,
                                                  int4_matmul_plain, int4_plan)
    from image2text_torch.utils.device import sm_count

    rows, in_pad, out_f = x.shape[0], x.shape[-1], packed.shape[0]
    got = int4_matmul(x, packed, scales)
    want = int4_matmul_plain(x, packed, scales)
    same = all(torch.equal(got, int4_matmul(x, packed, scales))
               for _ in range(2))
    torch.cuda.synchronize()
    bm, bn, splits = int4_plan(rows, out_f, in_pad, sm_count(x.device))
    label = key.replace("_", " ")
    err = compare(f"int4_matmul {label} rows={rows} in={in_pad} out={out_f} "
                  f"scales {scales.dtype}", got, want)
    del got, want
    log(f"    {label}: tile {bm} x {bn}, {splits} split(s) of the input; "
        f"two more launches bitwise equal: {same}")
    if not same:
        raise AssertionError(f"int4_matmul {label}: reruns differ")
    ms = cuda_ms(torch, lambda: int4_matmul(x, packed, scales), iters)
    plain = cuda_ms(torch, lambda: int4_matmul_plain(x, packed, scales),
                    iters)
    w16 = dequantize_int4(packed, scales, torch.bfloat16)
    lib = cuda_ms(torch, lambda: torch.matmul(x, w16.t()), iters)
    del w16
    n_bytes, flops = int4_work(x, packed, scales)
    bms, by = bound_ms(n_bytes, flops)
    log(f"    {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.5f} ms ({by}; {flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} "
        f"MB; kernel at {bms / ms:.3f} of it), torch.matmul on the "
        f"bf16-dequantised weight {lib:.4f} ms")
    row = dict(rows=rows, in_pad=in_pad, out=out_f, max_abs_err=err, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
               tile=[bm, bn], splits=splits, reruns_bitwise_equal=same)
    if f32_out:
        f32 = torch.float32
        got = int4_matmul(x, packed, scales, out_dtype=f32)
        want = int4_matmul_plain(x, packed, scales, out_dtype=f32)
        same = all(torch.equal(got, int4_matmul(x, packed, scales,
                                                out_dtype=f32))
                   for _ in range(2))
        torch.cuda.synchronize()
        row["f32_max_abs_err"] = compare(
            f"int4_matmul {label} out_dtype f32 ({splits} split(s))", got,
            want, f32=True)
        del got, want
        if not same:
            raise AssertionError(f"int4_matmul {label} f32: reruns differ")
        row["f32_ms"] = cuda_ms(torch, lambda: int4_matmul(
            x, packed, scales, out_dtype=f32), iters)
        row["f32_plain_ms"] = cuda_ms(torch, lambda: int4_matmul_plain(
            x, packed, scales, out_dtype=f32), iters)
        log(f"    {label} out_dtype f32: kernel {row['f32_ms']:.4f} ms, "
            f"plain {row['f32_plain_ms']:.4f} ms; two more launches bitwise "
            f"equal: {same}")
    entry = results.setdefault("int4_matmul", {"name": "int4_matmul"})
    if "source" not in entry:   # the first row: GPT-2-medium's decode c_attn
        entry.update(
            route="cuda", source="image2text_torch/csrc/int4_matmul.cu",
            replaces="image2text_tpu/ops/int4_matmul.py:102",
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
    entry[f"{key}_shape"] = row
    defer_device_ms(f"int4_matmul {label}", row,
                    lambda x_, p=packed, sc=scales: int4_matmul(x_, p, sc),
                    held=x)
    return row


def phase_int4_kernels(torch, model, results):
    """int4_matmul against its plain version at the GPT-2-medium decoder's
    four quantized Linear shapes, at the serving batch (256 decode rows)
    and at the training step's rows (12 x 112), bf16 x and the bf16 scales
    the model's cast leaves (``int4_case``)."""
    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    blk = model.decoder.blocks[0]
    linears = (("c_attn", blk.attn.c_attn), ("attn_c_proj", blk.attn.c_proj),
               ("c_fc", blk.mlp.c_fc), ("mlp_c_proj", blk.mlp.c_proj))
    train_rows = GPT2M_TRAIN_BATCH * (model.space_for_prompt
                                      + GPT2M_TRAIN_SEQ)
    for phase, rows in (("decode", BATCH), ("train", train_rows)):
        for label, lin in linears:
            x = torch.randn(rows, lin.in_pad, device=dev, generator=gen).to(bf)
            int4_case(torch, results, f"{phase}_{label}", x, lin.weight,
                      lin.weight_scales)


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


# -- the offline end-to-end path (training_configs/local/synthetic-*.yaml) -----

SMOKE_YAML = "training_configs/local/synthetic-smoke.yaml"
QUALITY2_YAML = "training_configs/local/synthetic-quality2.yaml"
QUALITY2_CK = "artifacts/quality2_ck.npz"
OFFLINE_EVAL_IMAGES = 8    # evaluate.py's default 20, cut for time
OFFLINE_BEAM_BATCH = 8
# The offline configs' training attention (as FLASH_FLAGSHIP's fields):
# synthetic-smoke.yaml's batch 8, 4 heads of 16, one K/V head; the encoder's
# 8 CLS + 256 patch rows (past RESIDENT_MAX_KEYS); the decoder's soft
# prompt and labels cut at its block size 128, causal, with the bias.
FLASH_OFFLINE = (
    ("offline_encoder", 8, 4, 1, 264, 264, 16, False, None, DROPOUT),
    ("offline_decoder", 8, 4, 1, 128, 128, 16, True, 8, DROPOUT))
OFFLINE_FRONT_BATCH = 4   # evaluate.py's --num_candidates: a call's images
OFFLINE_EVAL_BATCH = 8    # synthetic-smoke.yaml's batch: the trainer's eval calls


def offline_model(torch, yaml: str, ck: str, device: str):
    """The f32 model of ``yaml`` with the weights of the checkpoint ``ck``
    on ``device``, and its config."""
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                                   load_state_dict)

    cfg = load_training_config(REPO / yaml)
    model = VisionEncoderDecoder(cfg.model, device=device)
    load_jax_state_dict(model, load_state_dict(str(REPO / ck)))
    return model, cfg


def offline_images(torch, cfg, n: int, device):
    """The first ``n`` val images of ``cfg``'s synthetic stream (f32)."""
    from image2text_torch.trainer import build_inner_datasets, config_tokenizer

    _, val_ds = build_inner_datasets(cfg, config_tokenizer(cfg))
    return torch.as_tensor(next(iter(val_ds))["image"][:n], device=device)


def phase_offline_kernels(torch, results):
    """The f32 kernels against their plain versions (kernel_check's f32
    limits): the flash forward and backward at the offline training
    shapes, the dropout seed shared, the backward rerun bitwise equal; the
    front at the evaluate batch and the trainer's eval batch on
    quality2_ck.npz's weights and val images (``front_f32_case``).  ms,
    plain ms, the bound (3xTF32 at the TF32 peak beside the f32 FFMA
    peak's, ``f32_flash_bound``), the flash plan's groups, registers and
    spills (``flash_f32_plan``), and as yardsticks
    F.scaled_dot_product_attention in f32 (forward; backward alone); kept
    as each kernel's ``<label>_f32_shape`` beside its bf16 numbers."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias
    from image2text_torch.ops.fused_frontend import (fused_frontend,
                                                     fused_frontend_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    seed = -987654321
    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in FLASH_OFFLINE:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen)
                         for shape in ((b, h, sq, d), (b, hk, s, d),
                                       (b, hk, s, d), (b, h, sq, d)))
        bias = None if n_prefix is None else soft_prompt_bias(torch, s,
                                                              n_prefix, dev)
        a = (q, k, v, bias, causal)
        out, lse = fa.flash_fwd(*a, rate, seed)
        want, want_lse = fa.flash_forward_plain(*a, rate, seed)
        dvec = (dout * want).sum(-1)
        g = (dout, want_lse, dvec, rate, seed)
        got = fa.flash_bwd(*a, *g)
        again = fa.flash_bwd(*a, *g)
        plain = fa.flash_backward_plain(*a, *g)
        torch.cuda.synchronize()
        shape = (f"b={b} h={h} hk={hk} sq={sq} skv={s} d={d} causal={causal} "
                 f"bias={None if bias is None else tuple(bias.shape)} "
                 f"dropout={rate}")
        errs = {"fwd": compare(f"flash_fwd f32 out {label} {shape}", out,
                               want, f32=True)}
        compare(f"flash_fwd f32 lse {label}", lse, want_lse, f32=True)
        errs["bwd"] = max(compare(f"flash_bwd f32 {n} {label}", x, y,
                                  f32=True)
                          for n, x, y in zip(("dq", "dk", "dv"), got, plain))
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_bwd f32 {label}: reruns differ")
        plan = flash_f32_plan(torch, label, q, k)
        res = plan["resources"]
        log(f"    f32 kernels {label}: backward rerun bitwise equal")
        del out, lse, got, again, plain
        ms = {"fwd": cuda_ms(torch, lambda: fa.flash_fwd(*a, rate, seed)),
              "bwd": cuda_ms(torch, lambda: fa.flash_bwd(*a, *g))}
        plain_ms = {"fwd": cuda_ms(torch, lambda: fa.flash_forward_plain(
            *a, rate, seed)),
            "bwd": cuda_ms(torch, lambda: fa.flash_backward_plain(*a, *g))}
        mask = None
        if bias is not None or causal:
            mask = (0 if bias is None else bias) + (
                causal_bias(sq, s, dev) if causal else 0)
        lib = sdpa_times(torch, q, k, v, dout, mask, rate)
        log(f"  flash f32 {label}: fwd {ms['fwd']:.4f} ms (plain "
            f"{plain_ms['fwd']:.4f}, SDPA f32 {lib['fwd']:.4f}), bwd (dq dk "
            f"dv) {ms['bwd']:.4f} ms (plain {plain_ms['bwd']:.4f}; SDPA f32 "
            f"backward alone {lib['bwd']:.4f})")
        for kind in ("fwd", "bwd"):
            bms, by = f32_flash_bound(f"f32 {label}", kind, q, k, bias,
                                      causal, ms[kind])
            regs = ([res["fwd"]] if kind == "fwd"
                    else [res["bwd_dkv"], res["bwd_dq"]])
            results.setdefault(f"flash_{kind}", {"name": f"flash_{kind}"})[
                f"{label}_f32_shape"] = dict(
                    b=b, h=h, hk=hk, sq=sq, skv=s, d=d, causal=causal,
                    dtype="float32",
                    source="image2text_torch/csrc/flash_attention_f32.cu",
                    max_abs_err=errs[kind], ms=ms[kind],
                    plain_ms=plain_ms[kind], bound_ms=bms, bound_by=by,
                    library_ms=lib[kind],
                    groups=(plan["fwd_groups"] if kind == "fwd"
                            else [plan["dkv_groups"], plan["dq_groups"]]),
                    registers=[r for r, _ in regs],
                    spill_bytes=[sp for _, sp in regs])

    model, cfg = offline_model(torch, QUALITY2_YAML, QUALITY2_CK, "cuda")
    enc = model.vision_encoder
    w = enc.frontend_weights(torch.float32)
    for b, key in ((OFFLINE_FRONT_BATCH, "offline_f32_shape"),
                   (OFFLINE_EVAL_BATCH, "offline_b8_f32_shape")):
        x = enc.feature_extractor(offline_images(torch, cfg, b, dev))
        front_f32_case(torch, x.reshape(b, enc.n_patches ** 2, enc.input_d),
                       w, results, key)
    del model


def front_f32_case(torch, x, w, results, key: str) -> None:
    """The f32 front on ``x`` (b, t, din) and ``w``: on the route
    front_plan_f32 gives the shape, against its plain version (F32_LIMITS)
    and both against a float64 truth; CLS rows exact, reruns bitwise
    equal; ms beside the plain version's and the projector's f32
    torch.matmul (a yardstick the port never calls), the bound (bytes, or
    3xTF32 operations at the TF32 peak) beside the FFMA peak's, registers
    and spills; the slab route (the first f32 design's two kernels) forced
    and timed in the same process; device ms and launches a call of each
    read at the end (torch.profiler; the run fails unless the cluster route
    is one launch and the slab route two).  Kept as
    ``results["fused_frontend"][key]``."""
    from image2text_torch.ops import _build
    from image2text_torch.ops import fused_frontend as ff
    from image2text_torch.probes import front_f64_truth, truth_error

    b, t, din = x.shape
    d, n_cls = w.w_p.shape[1], w.cls.shape[0]
    plan = ff.front_plan_f32(t, din, d)
    got, again = ff.fused_frontend(x, w), ff.fused_frontend(x, w)
    want = ff.fused_frontend_plain(x, w)
    torch.cuda.synchronize()
    label = f"fused_frontend f32 b={b} t={t} din={din} d={d} n_cls={n_cls}"
    err = compare(f"{label} ({plan.route} route, cluster {plan.cluster} of "
                  f"{plan.rows} rows)", got, want, f32=True)
    if not torch.equal(got[:, :n_cls], want[:, :n_cls]):
        raise AssertionError(f"{label}: CLS rows differ")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: reruns differ")
    truth = front_f64_truth(ff, x, w)
    errs = truth_error(got, truth), truth_error(want, truth)
    ms = cuda_ms(torch, lambda: ff.fused_frontend(x, w), iters=20)
    plain = cuda_ms(torch, lambda: ff.fused_frontend_plain(x, w))
    lib = cuda_ms(torch, lambda: torch.matmul(x, w.w_p), iters=20)
    others = {"slab": ff.FrontPlanF32("slab", 0, 0)}
    other_ms = {}
    for name, p in others.items():
        out = ff.launch_front_f32(x, w, p)
        torch.cuda.synchronize()
        compare(f"{label} forced {p}", out, want, f32=True)
        if not torch.equal(out, ff.launch_front_f32(x, w, p)):
            raise AssertionError(f"{label} {p}: reruns differ")
        other_ms[name] = cuda_ms(
            torch, lambda p=p: ff.launch_front_f32(x, w, p), iters=20)
    flops = 2 * b * t * din * d
    n_bytes = nbytes(x, *w) + b * (n_cls + t) * d * x.element_size()
    bms, by = bound_ms(n_bytes, 3 * flops, TF32_FLOP_PER_S)
    ffma, ffma_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    regs = [_build.resources("fused_frontend", k) for k in (
        "front32_cluster_kernel", "gemm_f32_kernel", "slab_kernelIfE")]
    log(f"  {label}: {plan.route} route {ms:.4f} ms (plain {plain:.4f}); "
        f"forced "
        f"{ {k: round(v, 4) for k, v in other_ms.items()} }; bound "
        f"{bms:.5f} ms ({by}; {n_bytes / 1e6:.3f} MB, 3 x "
        f"{flops / 1e6:.1f} MFLOP at 495 TFLOP/s), at the FFMA peak "
        f"{ffma:.5f} ({ffma_by}); f32 torch.matmul of the projector alone "
        f"{lib:.4f} ms; error against float64 (max / max|truth|, rel L2): "
        f"kernel {errs[0][0]:.3g} {errs[0][1]:.3g}, plain {errs[1][0]:.3g} "
        f"{errs[1][1]:.3g}; (registers, bytes spilled) of the cluster "
        f"kernel, the slab route's GEMM and slab kernel {regs}")
    row = dict(b=b, t=t, din=din, d=d, dtype="float32",
               source="image2text_torch/csrc/fused_frontend.cu",
               plan=list(plan), max_abs_err=err, ms=ms, plain_ms=plain,
               bound_ms=bms, bound_by=by, ffma_bound_ms=ffma,
               library_ms=lib, truth_err=errs[0], plain_truth_err=errs[1],
               registers=[r for r, _ in regs],
               spill_bytes=[sp for _, sp in regs],
               **{f"{k}_ms": v for k, v in other_ms.items()})
    results.setdefault("fused_frontend", {"name": "fused_frontend"})[key] = row
    kernels = {"cluster": 1, "slab": 2}
    defer_device_ms(label, row, lambda xx: ff.fused_frontend(xx, w), held=x,
                    launches=kernels[plan.route])
    for name, p in others.items():
        defer_device_ms(f"{label} forced {p}", row,
                        lambda xx, p=p: ff.launch_front_f32(xx, w, p),
                        key=f"{name}_device", held=x,
                        launches=kernels[p.route])


def offline_train_launches(cfg, trainer, seq_len: int):
    """Launches of each kernel wrapper in the trainer twin's run of ``cfg``:
    each step one flash forward and one backward per self-attention call,
    and a second forward per call of a stack that checkpoints its blocks;
    per loop epoch one encoder front for eval_model's caption call and one
    per val step; no other kernel."""
    model = trainer.wrapper.model
    enc = model.vision_encoder
    enc_calls = sum(blk.runs_body(enc.n_cls + enc.n_patches ** 2)
                    for blk in enc.blocks)
    calls = model.sdpa_calls(seq_len)
    recompute = (enc_calls * cfg.model.vision_encoder_config
                 .enable_gradient_checkpointing
                 + (calls - enc_calls) * cfg.model.decoder_config
                 .enable_gradient_checkpointing)
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    want["flash_fwd"] = trainer.step * (calls + recompute)
    want["flash_bwd"] = trainer.step * calls
    want["fused_frontend"] = cfg.max_loop_epochs * (1 + cfg.num_val_steps)
    return want


def phase_offline_train(torch, args, results, work: Path) -> Path:
    """The trainer twin (image2text_torch/trainer.py::main) on
    synthetic-smoke.yaml, as ci.sh runs trainer.py, into ``work`` with
    --chkpt_file and --resume_dir: every launch count of the whole run
    held to ``offline_train_launches``, the loss of every step (finite,
    lower at the end), the train state and the checkpoint written, the
    peak memory; then step ms, the median of 3 windows of 4 steps on one
    batch of the stream (with ``--profile``, device time by kernel of one
    more step).  Returns the checkpoint."""
    import numpy as np

    from image2text_torch import trainer as twin
    from image2text_torch.utils.checkpoint import load_state_dict

    ck, state = work / "smoke_ck.npz", work / "smoke_state"
    cli = twin.parse_args(["--config_file", str(REPO / SMOKE_YAML),
                           "--chkpt_file", str(ck), "--resume_dir",
                           str(state)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts, trainer = launch_counts(lambda: twin.main(cli))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches(results, "offline_train", counts)
    cfg = trainer.config
    train_dl, _ = twin.build_dataloaders(cfg, twin.config_tokenizer(cfg))
    images, labels = trainer._on_device(*next(iter(train_dl)))
    want = offline_train_launches(cfg, trainer, labels.shape[1])
    losses = [float(m["train_loss_lm"]) for m in trainer.history]
    sd = load_state_dict(str(ck))
    log(f"  {trainer.step} steps ({cfg.max_loop_epochs} loop epochs of "
        f"{cfg.num_steps}, batch {cfg.batch_size}, precision "
        f"{cfg.precision!r}: f32) with eval and val in {wall:.1f} s; peak "
        f"memory {peak:.3f} GiB on {torch.cuda.get_device_name(0)}; "
        f"launches {counts} (want {want}); checkpoint {len(sd)} keys, train "
        f"state {sorted(p.name for p in state.iterdir())}")
    log(f"  loss by step: {[round(x, 5) for x in losses]}")
    if counts != want:
        raise AssertionError(f"offline-train launch counts {counts} != {want}")
    if (not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]
            or len(losses) != trainer.step or not (state / "train_state.pt"
                                                   ).exists()):
        raise AssertionError(f"offline-train: loss not finite or not falling "
                             f"{losses}, or no train state")
    step, windows = trainer._train_step, []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(4):
            step(images, labels, cfg.seed, 100 + 4 * w + i)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 4)
    step_s = statistics.median(windows)
    log(f"  step ms (median of 3 windows of 4 steps, one batch): "
        f"{step_s * 1e3:.2f}; windows {[round(x * 1e3, 2) for x in windows]}; "
        f"tokens/s (label positions) "
        f"{int(np.prod(labels.shape)) / step_s:.1f}")
    if args.profile:
        log("  device time by kernel, one offline training step:")
        device_profile(torch, lambda: step(images, labels, cfg.seed, 99))
    del trainer
    torch.cuda.empty_cache()
    return ck


def phase_offline_eval(torch, results, smoke_ck: Path):
    """The evaluate twin (image2text_torch/evaluate.py::main), greedy on
    OFFLINE_EVAL_IMAGES val images, on the card and on the CPU (plain
    versions) in this process: the trained smoke checkpoint and
    artifacts/quality2_ck.npz.  The card's tokens, BLEU-4 and CIDEr-D
    equal the CPU's; launches held to one front an image; then the
    sampled metrics at evaluate.py's defaults (temperature 1.0, top-k
    16) on the card."""
    from image2text_torch import evaluate as ev

    for label, yaml, ck in (("smoke", SMOKE_YAML, str(smoke_ck)),
                            ("quality2", QUALITY2_YAML,
                             str(REPO / QUALITY2_CK))):
        common = ["--config_file", str(REPO / yaml), "--chkpt_file", ck,
                  "--num_images", str(OFFLINE_EVAL_IMAGES)]
        greedy = ev.parse_args(common + ["--temperature", "0"])
        t0 = time.perf_counter()
        counts, card = launch_counts(lambda: ev.main(greedy))
        t_card = time.perf_counter() - t0
        record_launches(results, f"offline_eval_{label}", counts)
        t0 = time.perf_counter()
        cpu = ev.main(greedy, device="cpu")
        t_cpu = time.perf_counter() - t0
        want = {kern.__name__: 0 for kern in kernel_wrappers()}
        want["fused_frontend"] = OFFLINE_EVAL_IMAGES
        equal = sum(a == b for a, b in zip(card["candidates"],
                                           cpu["candidates"]))
        log(f"  {label} greedy ({OFFLINE_EVAL_IMAGES} images): card BLEU-4 "
            f"{card['bleu']!r} CIDEr-D {card['cider']!r} ({t_card:.1f} s), "
            f"CPU BLEU-4 {cpu['bleu']!r} CIDEr-D {cpu['cider']!r} "
            f"({t_cpu:.1f} s); captions equal token for token {equal} of "
            f"{len(card['candidates'])}; launches {counts} (want {want})")
        if counts != want:
            raise AssertionError(f"offline-eval {label}: launches {counts}")
        if (card["candidates"] != cpu["candidates"]
                or card["bleu"] != cpu["bleu"]
                or card["cider"] != cpu["cider"]):
            raise AssertionError(f"offline-eval {label}: the card's greedy "
                                 "captions or metrics differ from the CPU's")
        sampled = ev.main(ev.parse_args(common))
        log(f"  {label} sampled (temperature 1.0, top-k 16, card): BLEU-4 "
            f"{sampled['bleu']!r} CIDEr-D {sampled['cider']!r}")


def phase_offline_beam(torch):
    """Greedy beam search (width 3, expansion 4, top-k 16, 32 new tokens,
    eos 0, consolidation 0) on quality2_ck.npz at batch 8 of its val
    images, on the card and on the CPU: every round's scorer input
    recorded; the rounds each sample's ids stayed equal, and where they
    part the margin (how far the CPU's logits put its choice ahead of the
    card's, beside the two paths' logit differences there); the round-0
    logits held to the f32 kernels' relative L2 limit."""
    from image2text_torch.models.generation_utils import (
        BeamSearchTokenGenerator)
    from image2text_torch.utils import kernel_check

    runs = []
    for device in ("cuda", "cpu"):
        model, cfg = offline_model(torch, QUALITY2_YAML, QUALITY2_CK, device)
        images = offline_images(torch, cfg, OFFLINE_BEAM_BATCH, device)
        beam = BeamSearchTokenGenerator(
            model, beam_width=3, temperature=0.0, top_k=16,
            max_new_tokens=MAX_NEW_TOKENS, eos_token_id=0,
            no_repeat_n_grams=tuple(cfg.model.no_repeat_n_grams),
            consolidation_temperature=0.0)
        rounds, candidates = [], beam._candidates

        def record(last, ids_flat, cur_len, generator, rounds=rounds,
                   candidates=candidates):
            out = candidates(last, ids_flat, cur_len, generator)
            rounds.append(last.float().cpu())
            return out

        beam._candidates = record
        prompt = torch.ones(1, 1, dtype=torch.long)
        with torch.no_grad():
            ids, scores = beam(images, prompt)
        runs.append((ids.cpu(), scores.cpu(), rounds))
    (ik, sk, rk), (ip, sp, rp) = runs
    equal_rounds, partings = [], []
    for s in range(ik.shape[0]):
        differ = (ik[s] != ip[s]).any(0).nonzero()
        equal_rounds.append(int(differ[0]) - 1 if len(differ) else len(rk))
        if len(differ):
            pos = int(differ[0])
            ck, cp = int(ik[s, 0, pos]), int(ip[s, 0, pos])
            lk, lp = rk[pos - 1][s], rp[pos - 1][s]   # beam 0's row
            partings.append((s, pos - 1, round(float(lp[cp] - lp[ck]), 6),
                             round(float((lk[cp] - lp[cp]).abs()
                                         + (lk[ck] - lp[ck]).abs()), 6)))
    rel0 = float(torch.linalg.vector_norm(rk[0] - rp[0])
                 / torch.linalg.vector_norm(rp[0]))
    margins = []
    for lk in rk:   # the gap between the two largest raw logits of a row
        top2 = torch.topk(lk, 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    log(f"  greedy beam on quality2_ck.npz (batch {ik.shape[0]}, width 3, "
        f"{len(rk)} / {len(rp)} rounds): round-0 logits relative L2 "
        f"{rel0:.3g} (limit {kernel_check.F32_LIMITS[2]}); rounds with equal "
        f"ids per sample {equal_rounds}; partings (sample, round, CPU logit "
        f"of the CPU's choice minus that of the card's, the paths' logit "
        f"differences at the two ids summed): {partings}; smallest gap "
        f"between a row's two largest raw logits on the card "
        f"{min(margins):.6g}; scores equal {bool(torch.equal(sk, sp))}, "
        f"largest score difference {float((sk - sp).abs().max()):.3g}")
    if rel0 > kernel_check.F32_LIMITS[2] or not bool(
            torch.isfinite(sk).all()):
        raise AssertionError("offline-beam: the card's first logits part "
                             "from the CPU's beyond the f32 limit")


def phase_offline_modes(torch, results):
    """The evaluate twin on quality2_ck.npz (OFFLINE_EVAL_IMAGES val
    images) with ``--int8_serving`` and with ``--approx_topk``: greedy,
    the card's tokens, BLEU-4 and CIDEr-D equal to the CPU's in this
    process (one front launch an image; no W8A8 product: at d 64 no weight
    reaches int8_serving_params' 2^18 elements, so ``--int8_serving`` is
    int8 cross-KV alone on this checkpoint, as in JAX); then each mode's
    change against exact by tools/quality_price_tags.py's protocol
    (candidate 0 against 5 references), greedy and sampled (temperature
    1.0, top-k 16, the same generator seed)."""
    from image2text_torch import evaluate as ev
    from image2text_torch.ops.functions import int8_mm

    common = ["--config_file", str(REPO / QUALITY2_YAML), "--chkpt_file",
              str(REPO / QUALITY2_CK), "--num_images",
              str(OFFLINE_EVAL_IMAGES)]
    want = {kern.__name__: 0 for kern in kernel_wrappers()}
    want["fused_frontend"] = OFFLINE_EVAL_IMAGES
    metrics = {}
    for flags in ([], ["--int8_serving"], ["--approx_topk"]):
        label = flags[0][2:] if flags else "exact"
        greedy = ev.parse_args(common + flags + ["--temperature", "0"])
        products = int8_mm.launches
        counts, card = launch_counts(lambda: ev.main(greedy))
        record_launches(results, f"offline_modes_{label}", counts)
        sampled = ev.main(ev.parse_args(common + flags))
        metrics[label] = (card, sampled)
        if counts != want or int8_mm.launches != products:
            raise AssertionError(f"offline-modes {label}: launches {counts}, "
                                 f"{int8_mm.launches - products} W8A8 "
                                 "products")
        if not flags:
            continue
        cpu = ev.main(greedy, device="cpu")
        equal = sum(a == b for a, b in zip(card["candidates"],
                                           cpu["candidates"]))
        log(f"  {label} greedy ({OFFLINE_EVAL_IMAGES} images): card BLEU-4 "
            f"{card['bleu']!r} CIDEr-D {card['cider']!r}; CPU BLEU-4 "
            f"{cpu['bleu']!r} CIDEr-D {cpu['cider']!r}; captions equal token "
            f"for token {equal} of {len(card['candidates'])}; launches "
            f"{counts}")
        if (card["candidates"] != cpu["candidates"]
                or card["bleu"] != cpu["bleu"]
                or card["cider"] != cpu["cider"]):
            raise AssertionError(f"offline-modes {label}: the card's greedy "
                                 "captions or metrics differ from the CPU's")
    (eg, es) = metrics["exact"]
    for label in ("int8_serving", "approx_topk"):
        g, smp = metrics[label]
        same = sum(a == b for a, b in zip(g["candidates"], eg["candidates"]))
        log(f"  {label} against exact (card): greedy BLEU-4 "
            f"{g['bleu'] - eg['bleu']:+.6f}, CIDEr-D "
            f"{g['cider'] - eg['cider']:+.6f} ({same} of "
            f"{OFFLINE_EVAL_IMAGES} captions the same); sampled BLEU-4 "
            f"{smp['bleu'] - es['bleu']:+.6f} ({smp['bleu']!r} against "
            f"{es['bleu']!r}), CIDEr-D {smp['cider'] - es['cider']:+.6f} "
            f"({smp['cider']!r} against {es['cider']!r})")
    if metrics["approx_topk"][1] != es:
        raise AssertionError("offline-modes: approx top-k sampled differently "
                             "from exact under the same generator")


def phase_reforward_quality2(torch, results):
    """The full-reforward fallback on quality2_ck.npz (``force_no_cache``,
    greedy, OFFLINE_BEAM_BATCH val images, 32 new tokens): the card's ids
    equal the card's cached path's and the CPU's fallback's; one front
    launch."""
    from image2text_torch.models.generation import generate

    out = {}
    for device in ("cuda", "cpu"):
        model, cfg = offline_model(torch, QUALITY2_YAML, QUALITY2_CK, device)
        images = offline_images(torch, cfg, OFFLINE_BEAM_BATCH, device)
        prompt = torch.ones(1, 1, dtype=torch.long)
        for force in (True, False) if device == "cuda" else (True,):
            def run(force=force):
                return generate(model, images, prompt,
                                max_new_tokens=MAX_NEW_TOKENS,
                                temperature=0.0, force_no_cache=force)
            if device == "cuda" and force:
                counts, ids = launch_counts(run)
                record_launches(results, "quality2_reforward", counts)
                if counts["fused_frontend"] != 1 or sum(counts.values()) != 1:
                    raise AssertionError(f"reforward quality2: {counts}")
            else:
                ids = run()
            out[(device, force)] = ids.cpu()
    re, cached, cpu = (out[("cuda", True)], out[("cuda", False)],
                       out[("cpu", True)])
    log(f"  quality2 force_no_cache greedy (batch {OFFLINE_BEAM_BATCH}, "
        f"{MAX_NEW_TOKENS} new tokens): equal to the cached path's "
        f"{bool(torch.equal(re, cached))}, to the CPU's "
        f"{bool(torch.equal(re, cpu))}; sample {re[0, :12].tolist()}")
    if not (torch.equal(re, cached) and torch.equal(re, cpu)):
        raise AssertionError("reforward quality2: the fallback's ids differ")


NANO_YAML = {"nano-mini": "training_configs/local/nano-mini.yaml",
             "nano": "training_configs/tpu/nano.yaml",
             "nano-lsh": "training_configs/local/nano.yaml"}
NANO_BOS = 50256    # GPT-2's <|endoftext|>, the nano family's tokenizer
NANO_CPU_BATCH = 4  # [nano-cpu]'s images
NANO_CPU_TOL = 1e-4     # [nano-cpu] f32 logits, card against CPU (rel L2)
LSH_EDGE = 1e-5     # a bin may differ only this close to a grid point


def gpt2_layout_state_dict(n_layer: int, d: int, vocab: int = 50257,
                           positions: int = 1024, seed: int = SEED + 30):
    """An HF GPT-2 state dict of seeded normals (N(0, 0.02); LayerNorm
    weights 1 + N(0, 0.02)), built in numpy on the host: HF key names,
    Conv1D (in, out) weights, the causal-mask buffers (skipped by the
    import) and the tied ``lm_head.weight``."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= 0.02
        return a

    mask = np.tril(np.ones((1, 1, positions, positions), np.float32))
    sd = {"transformer.wte.weight": w(vocab, d),
          "transformer.wpe.weight": w(positions, d),
          "transformer.ln_f.weight": 1 + w(d), "transformer.ln_f.bias": w(d)}
    for i in range(n_layer):
        h = f"transformer.h.{i}."
        sd.update({h + "ln_1.weight": 1 + w(d), h + "ln_1.bias": w(d),
                   h + "attn.bias": mask,
                   h + "attn.masked_bias": np.asarray(-1e4, np.float32),
                   h + "attn.c_attn.weight": w(d, 3 * d),
                   h + "attn.c_attn.bias": w(3 * d),
                   h + "attn.c_proj.weight": w(d, d),
                   h + "attn.c_proj.bias": w(d),
                   h + "ln_2.weight": 1 + w(d), h + "ln_2.bias": w(d),
                   h + "mlp.c_fc.weight": w(d, 4 * d),
                   h + "mlp.c_fc.bias": w(4 * d),
                   h + "mlp.c_proj.weight": w(4 * d, d),
                   h + "mlp.c_proj.bias": w(d)})
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def nano_model(torch, name: str, dtype, depth=None, device="cuda"):
    """A nano-family model from its YAML at full width, at full depth or
    with ``depth`` ViT and decoder layers, random weights from SEED.  A
    GPT-2-initialised decoder takes a GPT-2-layout state dict of its GPT-2
    size (``gpt2_layout_state_dict``) through ``import_gpt2_state_dict``
    with the config's loose flag, as ``init_weights`` runs it.  Returns
    (model, seconds to build, seconds of the GPT-2 surgery)."""
    from image2text_torch.configs.models import GPT2_MODEL_TABLE
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models import encoder as tenc
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    t0 = time.perf_counter()
    cfg = load_training_config(NANO_YAML[name]).model
    dec, vit_args = cfg.decoder_config, tenc.VIT_B16_ARGS
    if depth is not None:
        dec.n_layer = depth
        tenc.VIT_B16_ARGS = dict(num_layers=depth)
    try:
        model = VisionEncoderDecoder(cfg, device=device)
    finally:
        tenc.VIT_B16_ARGS = vit_args
    sd, surgery = None, 0.0
    if dec.pretrained_model is not None:
        d = GPT2_MODEL_TABLE[dec.pretrained_model]["n_embd"]
        sd = gpt2_layout_state_dict(dec.n_layer, d)
    t1 = time.perf_counter()
    model.init_weights(SEED, gpt2_state_dict=sd)
    if sd is not None:
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        surgery = time.perf_counter() - t1
    del sd
    model = model.to(dtype).eval()
    return model, time.perf_counter() - t0, surgery


def describe(torch, model, label: str, built: float, surgery: float) -> None:
    enc, dec = model.vision_encoder, model.decoder
    n = sum(p.numel() for p in model.parameters())
    size = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{label}-model] {type(enc).__name__} ({len(enc.blocks)} ViT "
        f"blocks, head {'PEER' if enc.use_peer else 'LSH' if enc.use_lsh else 'positional MLP'}"
        f", {enc.num_outputs} x {enc.output_embed_dim}), "
        f"{'bridge, ' if model.encoder is not enc else ''}"
        f"{len(dec.blocks)}-layer d-{dec.n_embd} decoder "
        f"({dec.blocks[0].attn.__class__.__name__}, vocab "
        f"{dec.transformer.wte.stored_shape[0]}); {n:,} parameters "
        f"({size / 2 ** 30:.2f} GiB in {dec.dtype}), built in {built:.1f} s"
        + (f" (the GPT-2 surgery {surgery:.1f} s)" if surgery else ""))


def phase_nano_moe_kernel(torch, model, results):
    """``moe_ffn`` at nano-mini's decode shape (256 rows, 1024 → 2048 →
    1024) against its plain version, kept as ``nano_mini_decode_shape``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    results.setdefault("moe_ffn", {"name": "moe_ffn"})[
        "nano_mini_decode_shape"] = moe_case(
            torch, model.decoder.blocks[0].mlp, BATCH, gen, "nano-mini decode")


def first_parting(torch, ids_a, ids_b):
    """(row, step) of the first id where two greedy runs part, or None."""
    diff = (ids_a.cpu() != ids_b.cpu()).nonzero()
    if not len(diff):
        return None
    row, step = (int(v) for v in diff[diff[:, 1].argmin()])
    return row, step


def phase_nano_cpu(torch):
    """Depth-reduced forms (ViT depth 2, decoder depth 2, widths as
    configured) on the card against a CPU copy of the same weights:
    encoder output, first-step logits (a one-token prefill's last row) and
    greedy ids over MAX_NEW_TOKENS, NANO_CPU_BATCH images.  PEER and LSH
    forms in f32 with TF32 off: logits within NANO_CPU_TOL and the ids
    equal; every LSH bin that differs is reported, and must lie within
    LSH_EDGE of a grid point.  nano-mini in bf16: ``moe_ffn`` takes bf16
    only (JAX's kernel gate declines f32 on the TPU likewise), so its
    card-against-CPU distance is bf16's, within CPU_MODE_TOL."""
    from image2text_torch.models.generation import (generate, prefill,
                                                    preprocess_frames)
    from image2text_torch.models.layers import _unit_rows

    for name in ("nano", "nano-lsh", "nano-mini"):
        t0 = time.perf_counter()
        dtype = torch.bfloat16 if name == "nano-mini" else torch.float32
        m, _, _ = nano_model(torch, name, dtype, depth=2)
        cpu = cpu_copy(m)
        frames, prompt = serving_inputs(torch, m, NANO_CPU_BATCH, SEED + 32,
                                        NANO_BOS)
        images = preprocess_frames(m, frames, dtype)
        enc, cenc = m.encoder(images), cpu.encoder(images.cpu())
        got = prefill(m, enc, prompt, 1 + MAX_NEW_TOKENS)[0][:, -1].float()
        want = prefill(cpu, cenc, prompt.cpu(),
                       1 + MAX_NEW_TOKENS)[0][:, -1].float()
        ids = generate(m, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.0)
        cids = generate(cpu, images.cpu(), prompt.cpu(),
                        max_new_tokens=MAX_NEW_TOKENS, temperature=0.0)
        flips, margin = 0, 0.0
        if name == "nano-lsh":
            vit, cvit = m.vision_encoder, cpu.vision_encoder
            x, cx = vit.model(images), cvit.model(images.cpu())
            for comp, ccomp in zip(vit.lsh_emb, cvit.lsh_emb):
                for mod, cmod in zip(comp.emb, ccomp.emb):
                    diff = (mod.bins(x[:, None]).cpu()
                            != cmod.bins(cx[:, None]))
                    if bool(diff.any()):
                        z = torch.matmul(_unit_rows(cx[:, None]),
                                         cmod.projection_mat)
                        edge = (z[..., None] - cmod.grid).abs().amin(-1)
                        flips += int(diff.sum())
                        margin = max(margin, float(edge[diff].max()))
        enc_err = rel_l2(torch, enc.float().cpu(), cenc.float())
        err = rel_l2(torch, got.cpu(), want)
        parting = first_parting(torch, ids, cids)
        tol = CPU_MODE_TOL if name == "nano-mini" else NANO_CPU_TOL
        log(f"  {name} (depth 2 + 2, {str(dtype).split('.')[-1]}), card "
            f"against CPU, {NANO_CPU_BATCH} images: encoder output relative "
            f"L2 {enc_err:.6g}, first-step logits {err:.6g} (limit {tol}); "
            f"greedy ids over {MAX_NEW_TOKENS} steps equal: "
            f"{parting is None}" + ("" if parting is None else
                                    f" (first parting at row, step "
                                    f"{parting})")
            + (f"; LSH bins differing {flips} (largest distance of their "
               f"projection from a grid point {margin:.3g}, limit "
               f"{LSH_EDGE})" if name == "nano-lsh" else ""))
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"nano-cpu {name}: logits {err} > {tol}")
        if margin > LSH_EDGE:
            raise AssertionError(f"nano-cpu {name}: an LSH bin differs "
                                 f"{margin} from a grid point")
        if name != "nano-mini" and not flips and parting is not None:
            raise AssertionError(f"nano-cpu {name}: greedy ids part at "
                                 f"{parting}")
        log(f"    {name}: {time.perf_counter() - t0:.1f} s")
        del m, cpu
        torch.cuda.empty_cache()


def phase_nano(torch, args, results):
    """The nano configurations at full width and depth, each trained first
    ([train-<name>], its f32 masters) and its trained model then serving at
    batch 256, so that nothing builds twice: nano-mini in f32 ([nano-f32],
    its precision 'no') and in bf16 ([nano-mini], with its moe_ffn row and
    [nano-mini-parity]); [nano]; [nano-lsh]; then [train-gpt2]
    (local/gpt2.yaml, which has no serving phase) and [nano-cpu]."""
    bf = torch.bfloat16
    for name, path in (("nano-mini", "nano_mini_caption"),
                       ("nano", "nano_caption"),
                       ("nano-lsh", "nano_lsh_caption")):
        with torch.enable_grad():
            model = phase_train_family(torch, args, results, name)
        if name == "nano-mini":
            model.eval()
            describe(torch, model, "nano-f32", model.built_s, 0.0)
            log(f"[nano-f32] local/nano-mini.yaml serving path in f32 at "
                f"full width and depth ({CARD})")
            with record_moe_rows("nano_mini_f32_caption"):
                phase_serve(torch, model, args, results,
                            "nano_mini_f32_caption", NANO_BOS)
        model = model.to(bf).eval()
        describe(torch, model, name, model.built_s, 0.0)
        log(f"[{name}] {NANO_YAML[name]} serving path at full width and "
            "depth")
        if name == "nano-mini":
            phase_nano_moe_kernel(torch, model, results)
        phase_serve(torch, model, args, results, path, NANO_BOS)
        if name == "nano-mini":
            log(f"[graph] nano-mini's caption call, graph against eager "
                f"({CARD})")
            phase_graph(torch, model, args, "nano-mini", NANO_BOS)
            log("[nano-mini-parity] kernel path vs plain-version path at "
                "full width")
            phase_parity(torch, model, "nano-mini-parity", NANO_BOS)
        del model
        torch.cuda.empty_cache()
    with torch.enable_grad():
        phase_train_family(torch, args, results, "gpt2")
    torch.cuda.empty_cache()
    log("[nano-cpu] depth-reduced forms, card against CPU")
    phase_nano_cpu(torch)


# -- the HF decoder families: Llama-2, Qwen-2, Falcon, GPT-2-xl --------------

HF_YAML = {"llama13b": "training_configs/tpu/llama2-13b.yaml",
           "falcon7b": "training_configs/tpu/falcon-7b.yaml",
           "qwen": "training_configs/local/qwen-1.5b-deepseek-distill.yaml",
           "llama7b": "training_configs/local/llama2-7b.yaml",
           "gpt2xl": "training_configs/tpu/gpt2-xl.yaml"}
# the tokenizers' BOS ids: each caption's one-token prompt
HF_BOS = {"llama13b": 1, "llama7b": 1, "falcon7b": 11, "qwen": 151646,
          "gpt2xl": 50256}
# int4_matmul on this slice's path: (model, prefill rows an image (the
# soft prompt's CLS rows + the prompt), its Linear shapes (label, in, out))
HF_INT4 = (
    ("llama13b", 16 + 1, (("q_k_v_o_proj", 5120, 5120),
                          ("gate_up_proj", 5120, 13824),
                          ("down_proj", 13824, 5120))),
    ("falcon7b", 64 + 1, (("query_key_value", 4544, 4672),
                          ("dense", 4544, 4544),
                          ("dense_h_to_4h", 4544, 18176),
                          ("dense_4h_to_h", 18176, 4544))),
    ("gpt2xl", 64 + 1, (("c_attn", 1600, 4800), ("attn_c_proj", 1600, 1600),
                        ("c_fc", 1600, 6400), ("mlp_c_proj", 6400, 1600))))
HF_CPU_BATCH = 4    # [hf-cpu]'s images
HF_CPU_DEPTH = 1    # [hf-cpu]'s layers, cut for time


def phase_hf_kernels(torch, results):
    """int4_matmul against its plain version at every Linear shape of the
    Llama-2-13B, Falcon-7B and GPT-2-xl decoders, at the serving batch's
    256 decode rows and its prefill rows (``int4_case``; bf16 x, bf16
    scales as the models' cast leaves them); then the f32 form of moe_ffn
    (``phase_moe_f32``) on the FFN of a block of nano-mini's decoder built
    alone in f32 (1024 → 2048 → 1024)."""
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models.layers import _MoEMLP
    from image2text_torch.models.quantization import quantize_blockwise
    from image2text_torch.nn.core import init_parameters

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    for model, per_image, shapes in HF_INT4:
        for label, in_f, out_f in shapes:
            w = torch.empty(out_f, in_f, device=dev).normal_(
                0.0, 0.02, generator=gen)
            packed, scales = quantize_blockwise(w)
            scales = scales.to(bf)
            del w
            for phase, rows in (("decode", BATCH),
                                ("prefill", BATCH * per_image)):
                x = torch.randn(rows, packed.shape[1] * 2, device=dev,
                                generator=gen).to(bf)
                int4_case(torch, results, f"{model}_{phase}_{label}", x,
                          packed, scales, iters=20 if phase == "decode"
                          else 5)
                del x
            del packed, scales
            torch.cuda.empty_cache()
    dcfg = load_training_config(NANO_YAML["nano-mini"]).model.decoder_config
    tc = dcfg.transformer_config
    mlp = _MoEMLP(tc.attn_config.n_embd, tc.attn_config.bias,
                  tc.rotator_config, device=dev)
    init_parameters(mlp, gen)
    phase_moe_f32(torch, mlp, gen, results)


@contextlib.contextmanager
def hf_depth(name: str, depth):
    """Build ``name``'s HF decoder ``depth`` layers deep (None: as its table
    says), and a pretrained ViT encoder as deep (a scratch decoder's depth
    is its config's)."""
    import dataclasses

    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models import encoder as tenc
    from image2text_torch.models.hf_decoders import factory

    s = getattr(load_training_config(FAMILY_YAML[name]).model.decoder_config,
                "model_str", None)
    table = next((t for t in (factory.GPT2_TABLE, factory.LLAMA_TABLE,
                              factory.QWEN_TABLE, factory.FALCON_TABLE)
                  if s in t), {})
    saved, vit = table.get(s), tenc.VIT_B16_ARGS
    if depth is not None:
        if saved is not None:
            table[s] = (dict(saved, n_layer=depth) if isinstance(saved, dict)
                        else dataclasses.replace(saved, n_layer=depth))
        tenc.VIT_B16_ARGS = dict(num_layers=depth)
    try:
        yield
    finally:
        if saved is not None:
            table[s] = saved
        tenc.VIT_B16_ARGS = vit


def hf_model(torch, name: str, depth=None, device="cuda", int4=None,
             dtype=None):
    """``name``'s model from its YAML at full width, at full depth or
    ``depth`` layers (decoder, and a scratch or pretrained encoder), with
    random weights from SEED (the int4 weights and LoRA B as
    ``randomize_gpt2m`` makes them), in its precision's dtype (bf16, or f32
    for 'no') unless ``dtype``; ``int4`` overrides ``load_in_4bit``.
    Returns (model, seconds to build, the build's peak device bytes)."""
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    t0 = time.perf_counter()
    cfg = load_training_config(HF_YAML[name])
    mcfg = cfg.model
    if int4 is not None:
        mcfg.decoder_config.load_in_4bit = int4
    if depth is not None and hasattr(mcfg.vision_encoder_config, "n_layer"):
        mcfg.vision_encoder_config.n_layer = depth
    if dtype is None:
        dtype = torch.float32 if cfg.precision == "no" else torch.bfloat16
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with hf_depth(name, depth):
        model = VisionEncoderDecoder(mcfg, device=device).init_weights(SEED)
    randomize_gpt2m(torch, model, SEED)
    model = model.to(dtype).eval()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return model, time.perf_counter() - t0, peak


def describe_hf(torch, model, label: str, built: float, peak: int) -> None:
    from image2text_torch.models.quantization import QuantizedLinear

    enc, dec = model.vision_encoder, model.decoder
    n = sum(p.numel() for p in model.parameters())
    n_q = sum(isinstance(m, QuantizedLinear) for m in dec.modules())
    resident = torch.cuda.memory_allocated()
    log(f"[{label}-model] {HF_YAML[label]}: {type(enc).__name__} "
        f"({len(enc.blocks)} blocks, {enc.num_outputs} x "
        f"{enc.output_embed_dim}), "
        f"{'bridge, ' if model.encoder is not enc else ''}"
        f"{type(dec).__name__} {dec.config.model_str} ({len(dec.blocks)} "
        f"layers, d {dec.n_embd}, vocab {vocab_rows(model)}, "
        f"{n_q} int4 Linears, {dec.dtype}); {n:,} parameter elements (int4 "
        f"bytes not counted), built in {built:.1f} s; device memory "
        f"resident {resident / 2 ** 30:.2f} GiB, the build's peak "
        f"{peak / 2 ** 30:.2f} GiB ({peak / max(resident, 1):.2f}x)")
    return resident


def phase_hf(torch, args, results):
    """The five configurations at full width and depth, one at a time,
    each trained first ([train-<name>]: f32 masters, its YAML's batch,
    precision, optimizer and accumulation) and its trained model then, in
    its precision's dtype, serving at batch 256: [llama13b], [falcon7b],
    [qwen], [llama7b], [gpt2xl] (the serving path as [main] with launches
    held to serving_launches, peak memory; the kernel path against the
    plain-version path where the model launches a kernel); then
    [hf-cpu]."""
    for name in ("llama13b", "falcon7b", "qwen", "llama7b", "gpt2xl"):
        with torch.enable_grad():
            model = phase_train_family(torch, args, results, name)
        precision = load_precision(name)
        model = model.to(torch.float32 if precision == "no"
                         else torch.bfloat16).eval()
        peak, built_resident = model.build_peak, model.build_resident
        resident = describe_hf(torch, model, name, model.built_s, peak)
        if name == "llama13b" and peak > 2 * built_resident:
            raise AssertionError(f"llama13b: the build's peak {peak} is "
                                 f"more than twice its resident "
                                 f"{built_resident}")
        log(f"[{name}] {HF_YAML[name]} serving path at full width and "
            f"depth ({CARD})")
        torch.cuda.reset_peak_memory_stats()
        phase_serve(torch, model, args, results, f"{name}_caption",
                    HF_BOS[name])
        log(f"  peak device memory over the serving calls "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
            f"(resident {resident / 2 ** 30:.2f} GiB)")
        if any(serving_launches(model).values()):
            log(f"[{name}-parity] kernel path vs plain-version path at full "
                "width")
            phase_parity(torch, model, f"{name}-parity", HF_BOS[name],
                         sensitivity=True)
        del model
        torch.cuda.empty_cache()
    log(f"[hf-cpu] each family at depth {HF_CPU_DEPTH}, card against a CPU "
        f"copy ({CARD})")
    phase_hf_cpu(torch)


def load_precision(name: str) -> str:
    from image2text_torch.configs.reader import load_training_config

    return load_training_config(FAMILY_YAML[name]).precision


def card_against_cpu(torch, m, label: str, bos: int, tol: float,
                     ids_equal: bool, cpu_encoder: bool = False) -> None:
    """``m`` on the card against a CPU copy of it: the encoder output and
    first-step logits (a one-token prefill's last row) within ``tol``
    (relative L2), HF_CPU_BATCH images; with ``ids_equal`` also greedy ids
    over MAX_NEW_TOKENS, which must be equal (a bf16 form, whose ids part
    at near ties, is held to its logits alone: its greedy decode on the
    CPU is the slowest part of the check on a host without bf16 units).
    ``cpu_encoder``: both decoders take the CPU copy's encoder output (an
    f32 form whose scratch encoder's sparse blocks the card's bf16 kernel
    does not take: the decoder alone is compared)."""
    from image2text_torch.models.generation import (generate, prefill,
                                                    preprocess_frames)

    cpu = cpu_copy(m)
    frames, prompt = serving_inputs(torch, m, HF_CPU_BATCH, SEED + 41, bos)
    images = preprocess_frames(m, frames, m.decoder.dtype)
    cenc = cpu.encoder(images.cpu())
    enc = cenc.to(m.device) if cpu_encoder else m.encoder(images)
    got = prefill(m, enc, prompt, 1 + MAX_NEW_TOKENS)[0][:, -1].float()
    want = prefill(cpu, cenc, prompt.cpu(),
                   1 + MAX_NEW_TOKENS)[0][:, -1].float()
    parting = None
    if ids_equal:
        ids = generate(m, images, prompt, max_new_tokens=MAX_NEW_TOKENS,
                       temperature=0.0, encoder_output=enc)
        cids = generate(cpu, images.cpu(), prompt.cpu(),
                        max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
                        encoder_output=cenc)
        parting = first_parting(torch, ids, cids)
    enc_err = rel_l2(torch, enc.float().cpu(), cenc.float())
    err = rel_l2(torch, got.cpu(), want)
    log(f"  {label} ({len(m.decoder.blocks)}-layer decoder, "
        f"{str(m.decoder.dtype).split('.')[-1]}), card against CPU, "
        f"{HF_CPU_BATCH} images: encoder output "
        + ("the CPU's, on both" if cpu_encoder
           else f"relative L2 {enc_err:.6g}")
        + f", first-step logits {err:.6g} (limit {tol})"
        + (f"; greedy ids over {MAX_NEW_TOKENS} steps equal: "
           f"{parting is None}" if ids_equal else ""))
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: logits {err} > {tol}")
    if ids_equal and parting is not None:
        raise AssertionError(f"{label}: greedy ids part at {parting}")
    del cpu


def phase_hf_cpu(torch):
    """HF_CPU_DEPTH-layer forms (decoder and encoder) at full width, card
    against a CPU copy (``card_against_cpu``): each family in f32 with
    TF32 off (Llama-2-7B as configured; Qwen-2; Falcon and GPT-2-xl with
    their Linears in float, their decoders alone on the CPU's encoder
    output) within NANO_CPU_TOL and the ids equal; and Llama-2-13B as
    configured, int4 in bf16 (the kernel against the CPU's plain version)
    within CPU_MODE_TOL, its logits alone.  The CPU copies dequantise each int4 weight once
    (``int4_dequantised_once``)."""
    f32 = torch.float32
    for name, kw, tol, exact in (
            ("llama7b", {}, NANO_CPU_TOL, True),
            ("qwen", dict(dtype=f32), NANO_CPU_TOL, True),
            ("falcon7b", dict(int4=False, dtype=f32), NANO_CPU_TOL, True),
            ("gpt2xl", dict(int4=False, dtype=f32), NANO_CPU_TOL, True),
            ("llama13b", {}, CPU_MODE_TOL, False)):
        t0 = time.perf_counter()
        m, _, _ = hf_model(torch, name, depth=HF_CPU_DEPTH, **kw)
        with int4_dequantised_once(torch):
            card_against_cpu(torch, m, name, HF_BOS[name], tol, exact,
                             cpu_encoder=name in ("falcon7b", "gpt2xl"))
        log(f"    {name}: {time.perf_counter() - t0:.1f} s")
        del m
        torch.cuda.empty_cache()


def phase_nano_f32(torch):
    """local/nano-mini.yaml at its own precision 'no' (f32), its depth-2
    form on the card against a CPU copy in f32 (logits within
    NANO_CPU_TOL, ids equal, as [nano-cpu] holds the f32 forms); its
    full-depth serving path is [nano-f32] in ``phase_nano``."""
    m, _, _ = nano_model(torch, "nano-mini", torch.float32, depth=2)
    card_against_cpu(torch, m, "nano-mini f32", NANO_BOS, NANO_CPU_TOL, True)
    del m
    torch.cuda.empty_cache()


# -- training of the nano and HF families ------------------------------------

FAMILY_YAML = dict(NANO_YAML, gpt2="training_configs/local/gpt2.yaml",
                   **HF_YAML)
# the tokenizers' EOS and BOS ids (the labels are synthetic token ids)
FAMILY_EOS = {"nano-mini": 50256, "nano": 50256, "nano-lsh": 50256,
              "gpt2": 50256, "llama13b": 2, "llama7b": 2, "falcon7b": 11,
              "qwen": 151643, "gpt2xl": 50256}
FAMILY_BOS = dict(HF_BOS, **{n: NANO_BOS for n in ("nano-mini", "nano",
                                                   "nano-lsh", "gpt2")})
FAMILY_SEQ = 256        # the text block: 256 label positions
FAMILY_STEPS = 1        # timed steps a window (3 windows), one warm step
FAMILY_PARITY_BATCH = 1   # cut for time
FAMILY_PARITY_DEPTH = 1   # [train-parity]'s layers (decoder and encoder),
                          # cut for time; the LoRA phases run 2
F32_PARITY_TOL = 1e-5   # [train-parity] f32: loss and gradients, relative
REMAT_FAMILY, REMAT_DEPTH = "llama13b", 2   # depth cut for time
# kernel shapes each family's step gave (kernel_shapes), for [train-kernels]
TRAIN_FLASH = {}
TRAIN_INT4 = {}


def no_dropout(model_cfg) -> None:
    """Attention, residual and LoRA dropout of ``model_cfg`` set to 0."""
    for sub in (model_cfg.vision_encoder_config, model_cfg.decoder_config):
        tc = getattr(sub, "transformer_config", None)
        if tc is not None:
            tc.attn_config.dropout = tc.attn_config.attn_dropout = 0.0
        if getattr(sub, "lora_spec", None) is not None:
            sub.lora_spec.lora_dropout = 0.0


def family_setup(torch, name: str, depth=None, device="cuda",
                 dropout: bool = True, batch=None, init: bool = True,
                 edit=None):
    """(cfg, wrapper, Trainer) of ``name``'s YAML at full width, at full
    depth or ``depth`` layers (decoder and encoder), on ``device``: f32
    masters with random weights from SEED (a GPT-2-initialised decoder
    imports a GPT-2-layout state dict of its size; the int4 weights and
    LoRA B as ``randomize_gpt2m`` makes them), the YAML's batch,
    precision, optimizer groups and accumulation.  A YAML whose batch its
    accumulation does not divide (Falcon-7B's 4 / 8, GPT-2-xl's 12 / 8;
    both packages refuse it) runs with accumulation 1, as gpt2-medium.yaml
    does.  ``dropout`` False zeroes every dropout; ``batch`` overrides the
    batch (and then accumulation is 1); ``init`` False leaves the weights
    as allocated (for a copy that loads another's); ``edit(cfg)`` changes
    the config before the build (a LoRA spec set in code).  The build's
    time and peak device memory go on the wrapper (``built_s``,
    ``build_peak``)."""
    from image2text_torch.configs.models import GPT2_MODEL_TABLE
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.training.loop import Trainer
    from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                                   TokenizerInfo)

    cfg = load_training_config(FAMILY_YAML[name])
    if edit is not None:
        edit(cfg)
    enc, dec = cfg.model.vision_encoder_config, cfg.model.decoder_config
    if depth is not None:
        if hasattr(enc, "n_layer"):
            enc.n_layer = depth
        if getattr(dec, "model_str", None) is None:
            dec.n_layer = depth
    if batch is not None:
        cfg.batch_size, cfg.gradient_accumulation_steps = batch, 1
    if cfg.batch_size % cfg.gradient_accumulation_steps:
        log(f"  {FAMILY_YAML[name]}: batch {cfg.batch_size} is not divisible "
            f"by gradient_accumulation_steps "
            f"{cfg.gradient_accumulation_steps}; run with accumulation 1")
        cfg.gradient_accumulation_steps = 1
    if not dropout:
        no_dropout(cfg.model)
    tok = TokenizerInfo(eos_token_id=FAMILY_EOS[name],
                        bos_token_id=FAMILY_BOS[name], mask_token_id=None,
                        vocab_size=dec.vocab_size)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with hf_depth(name, depth):
        wrapper = ModelTrainerWrapper(cfg.model, tok, cfg.trainer,
                                      device=device)
    model = wrapper.model
    if init:
        sd = None
        if getattr(dec, "pretrained_model", None) is not None:
            sd = gpt2_layout_state_dict(
                dec.n_layer, GPT2_MODEL_TABLE[dec.pretrained_model]["n_embd"])
        model.init_weights(SEED, gpt2_state_dict=sd)
        del sd
        randomize_gpt2m(torch, model, SEED)
    if not dropout:
        for mod in model.modules():
            if hasattr(mod, "dropout_rate"):
                mod.dropout_rate = 0.0
    if device == "cuda":
        torch.cuda.synchronize()
        wrapper.build_peak = torch.cuda.max_memory_allocated()
        wrapper.build_resident = torch.cuda.memory_allocated()
    wrapper.built_s = time.perf_counter() - t0
    return cfg, wrapper, Trainer(cfg, wrapper)


def family_inputs(torch, cfg, batch: int, seed: int, device="cuda"):
    """Images (the ViT's 224² or the scratch encoder's input) and
    FAMILY_SEQ labels: 8–254 synthetic token ids, then -100."""
    import numpy as np

    from image2text_torch.configs.models import PretrainedViTConfig

    rng = np.random.default_rng(seed)
    enc = cfg.model.vision_encoder_config
    size = 224 if isinstance(enc, PretrainedViTConfig) else enc.input.width
    vocab = cfg.model.decoder_config.vocab_size
    images = rng.standard_normal((batch, 3, size, size), dtype=np.float32)
    labels = np.full((batch, FAMILY_SEQ), -100, np.int64)
    for i, n in enumerate(rng.integers(8, FAMILY_SEQ - 1, batch)):
        labels[i, :n] = rng.integers(3, vocab - 1, n)
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def phase_train_family(torch, args, results, name: str):
    """[train-<name>]: the family's training step at full width and depth
    through its Trainer (``phase_train``, 3 windows of FAMILY_STEPS steps
    after the warm step that counts the launches); the kernels' shapes
    kept for [train-kernels].  Returns the model (f32 masters), for the
    family's serving phase to reuse."""
    holder = {}

    def setup():
        cfg, wrapper, trainer = family_setup(torch, name)
        holder["wrapper"] = wrapper
        return cfg, wrapper, trainer

    flash, int4 = TRAIN_FLASH.setdefault(name, {}), TRAIN_INT4.setdefault(
        name, set())
    log(f"[train-{name}] {FAMILY_YAML[name]} training step at full width "
        f"and depth ({CARD})")
    model = phase_train(
        torch, args, results, f"{name}_train_step", setup,
        lambda cfg: family_inputs(torch, cfg, cfg.batch_size, SEED + 50),
        steps_per_window=FAMILY_STEPS, keep=True, shapes=(flash, int4))
    w = holder.pop("wrapper")
    calls = sorted((q, hk, skv, causal, str(dt).split(".")[-1])
                   for q, hk, skv, causal, _, dt in flash)
    log(f"  built in {w.built_s:.1f} s, the build's peak device memory "
        f"{w.build_peak / 2 ** 30:.2f} GiB; flash forward (q, K/V heads, "
        f"keys, causal, dtype) {calls}; int4_matmul (rows, in, out) "
        f"{sorted(int4)}")
    model.build_peak, model.build_resident = w.build_peak, w.build_resident
    model.built_s = w.built_s
    return model


def grads_of(wrapper) -> dict:
    return {n: p.grad.detach().float().cpu()
            for n, p in wrapper.model.named_parameters()
            if p.grad is not None}


def grad_error(torch, got: dict, want: dict) -> float:
    num = sum(float((got[n] - want[n]).double().square().sum()) for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    return math.sqrt(num / den)


def grad_sums(torch, got: dict, want: dict) -> dict:
    """{name: (squared L2 of got - want, squared L2 of want)} in f64 over
    the names both hold, one pass over each tensor."""
    return {n: (float((got[n] - want[n]).double().square().sum()),
                float(want[n].double().square().sum()))
            for n in want if n in got}


def phase_train_cpu(torch):
    """[train-parity]: each family's FAMILY_PARITY_DEPTH-layer form (decoder
    and encoder) at full width, one training step on the card against one on
    a CPU copy of the same weights (batch FAMILY_PARITY_BATCH, dropout 0:
    the card's and the CPU's generators draw different masks): the loss and
    the trainable gradients (relative L2 over all of them) within
    TRAIN_LOSS_TOL and TRAIN_GRAD_TOL in bf16, F32_PARITY_TOL in f32.
    ``tpu/nano.yaml`` runs in f32, as [nano-cpu] holds it: its PEER head's
    bf16 top-k picks other experts on the card than on the CPU at near ties,
    and a pick apart moves a table row's gradient whole.  A bf16 form beyond
    those limits is held to the reference's own bf16 error, as
    ``phase_attention_sensitivity`` holds the chain: the CPU step in f32
    from the same weights is the measure, and the card's bf16 step must lie
    within twice the CPU's bf16 step's distance from it (loss and
    gradients).  Llama-2-13B's int4 form needed it at depth 2: its bf16
    steps on the card and on the CPU parted by more than 2e-2.  The CPU copy
    is built without weights of its own (it loads the card's) and
    dequantises each int4 weight once (``int4_dequantised_once``)."""
    failed = [name for name in FAMILY_YAML
              if not family_card_vs_cpu(torch, name,
                                        depth=FAMILY_PARITY_DEPTH)]
    if failed:
        raise AssertionError(f"train-parity: card and CPU differ: {failed}")


def family_card_vs_cpu(torch, name: str, edit=None, label=None,
                       depth: int = 2) -> bool:
    """One family's training step at ``depth`` layers (decoder and
    encoder) on the card against a CPU copy (``phase_train_cpu``'s
    limits); ``edit`` changes the config before both builds.  Whether it
    held."""
    from image2text_torch.training.loop import Trainer, make_train_step

    t0 = time.perf_counter()
    cfg, w, tr = family_setup(torch, name, depth=depth, dropout=False,
                              batch=FAMILY_PARITY_BATCH, edit=edit)
    ccfg, cw, ctr = family_setup(torch, name, depth=depth, device="cpu",
                                 dropout=False, init=False,
                                 batch=FAMILY_PARITY_BATCH, edit=edit)
    if name == "nano":
        cfg.precision = ccfg.precision = "no"
        tr._train_step = make_train_step(w, tr.optimizer, 1, "no")
        ctr._train_step = make_train_step(cw, ctr.optimizer, 1, "no")
    start = {k: v.cpu().clone() for k, v in w.state_dict().items()}
    cw.load_state_dict(start)
    images, labels = family_inputs(torch, cfg, FAMILY_PARITY_BATCH,
                                   SEED + 51)
    cpu_in = (images.cpu(), labels.cpu(), cfg.seed, 0)
    loss = float(tr._train_step(images, labels, cfg.seed, 0)[
        "train_loss_lm"])
    with int4_dequantised_once(torch):
        closs = float(ctr._train_step(*cpu_in)["train_loss_lm"])
    g, cg = grads_of(w), grads_of(cw)
    f32 = cfg.precision == "no"
    ltol, gtol = ((F32_PARITY_TOL, F32_PARITY_TOL) if f32
                  else (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL))
    lerr = abs(loss - closs) / abs(closs)
    sums = grad_sums(torch, g, cg)
    gerr = (math.sqrt(sum(a for a, _ in sums.values())
                      / sum(b for _, b in sums.values()))
            if set(g) == set(cg) else math.inf)
    worst = sorted(((math.sqrt(a / b), n) for n, (a, b) in sums.items()
                    if b > 0), reverse=True)[:3]
    line = (f"  {label or name} (depth {depth} + {depth}, "
            f"{cfg.precision!r}, batch "
            f"{FAMILY_PARITY_BATCH}): loss card {loss:.7f} vs CPU "
            f"{closs:.7f} (relative error {lerr:.3g}, limit {ltol}); "
            f"gradients relative L2 {gerr:.3g} over {len(cg)} trainable "
            f"tensors (limit {gtol}); the largest by tensor "
            f"{[(n, float(f'{e:.3g}')) for e, n in worst]}")
    ok = bool(cg) and lerr <= ltol and gerr <= gtol
    if cg and not f32 and not ok:
        cw.load_state_dict(start)
        ref_step = make_train_step(cw, Trainer(ccfg, cw).optimizer, 1,
                                   "no")
        with int4_dequantised_once(torch):
            rloss = float(ref_step(*cpu_in)["train_loss_lm"])
        rg = grads_of(cw)
        e_card, e_cpu = grad_error(torch, g, rg), grad_error(torch, cg, rg)
        l_card = abs(loss - rloss) / abs(rloss)
        l_cpu = abs(closs - rloss) / abs(rloss)
        ok = (e_card <= 2 * e_cpu
              and l_card <= max(TRAIN_LOSS_TOL, 2 * l_cpu))
        line += (f"; against the CPU's f32 step: card's bf16 gradients "
                 f"{e_card:.3g}, the CPU's {e_cpu:.3g} (limit twice "
                 f"that), loss {l_card:.3g} and {l_cpu:.3g}")
    log(line + f" [{time.perf_counter() - t0:.1f} s]")
    del cfg, w, tr, ccfg, cw, ctr, g, cg, start
    torch.cuda.empty_cache()
    return ok


def phase_remat(torch):
    """[remat]: REMAT_FAMILY at REMAT_DEPTH layers, full width, the YAML's
    batch and accumulation, under each remat policy from the same weights:
    the first step's loss and gradients against ``full``'s, then the step
    ms (median of 3 more steps) and the peak device memory of each."""
    cfg, w, _ = family_setup(torch, REMAT_FAMILY, depth=REMAT_DEPTH)
    start = {k: v.clone() for k, v in w.state_dict().items()}
    images, labels = family_inputs(torch, cfg, cfg.batch_size, SEED + 52)
    from image2text_torch.training.loop import Trainer

    base = None
    for policy in ("full", "dots", "nothing", "everything"):
        w.load_state_dict(start)
        cfg.remat_policy = policy
        trainer = Trainer(cfg, w)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(trainer._train_step(images, labels, cfg.seed, 0)[
            "train_loss_lm"])
        g = grads_of(w)
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._train_step(images, labels, cfg.seed, 1 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if base is None:
            base = (loss, g)
        err = grad_error(torch, g, base[1])
        same = all(torch.equal(g[n], base[1][n]) for n in g)
        log(f"  {policy}: loss {loss:.7f} (full {base[0]:.7f}); gradients "
            f"relative L2 against full {err:.3g}, bitwise equal {same}; step "
            f"ms {statistics.median(times) * 1e3:.2f}, peak memory "
            f"{peak:.3f} GiB ({CARD})")
        if loss != base[0] or err > 1e-6 or set(g) != set(base[1]):
            raise AssertionError(f"remat {policy}: gradients differ from "
                                 "full's")
        del trainer, g
    for p in w.parameters():
        p.grad = None
    del w, start
    torch.cuda.empty_cache()


def largest_flash_calls(name: str):
    """The largest flash forward (b·h·sq·skv) of each dtype that
    ``name``'s training step ran, as (key, bias)."""
    best = {}
    for key, bias in TRAIN_FLASH.get(name, {}).items():
        (b, h, sq, d), hk, skv, causal, rate, dt = key
        if dt not in best or b * h * sq * skv > best[dt][0]:
            best[dt] = (b * h * sq * skv, key, bias)
    return [(k, bias) for _, k, bias in best.values()]


def flash_case(torch, results, label: str, key, bias, gen):
    """The flash forward and backward at one training call's shape against
    their plain versions (same dropout seed; the backward rerun bitwise
    equal; in bf16 the plans, registers, spills and visited pairs of
    ``flash_plan``, the pairs held to their count where no bias is given;
    in f32 ``flash_f32_plan``'s groups, registers and spills), with ms,
    the bound (f32: ``f32_flash_bound``, 3xTF32 at the TF32 peak, logged
    beside the f32 FFMA peak's), SDPA's forward and backward alone as the
    yardstick; kept as ``<label>_shape``."""
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import causal_bias

    (b, h, sq, d), hk, skv, causal, rate, dt = key
    dev, f32, seed = torch.device("cuda"), dt == torch.float32, -123456789
    q, dout = (torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
               for _ in range(2))
    k, v = (torch.randn(b, hk, skv, d, device=dev, generator=gen).to(dt)
            for _ in range(2))
    bias = None if bias is None else bias.to(dev)
    a = (q, k, v, bias, causal)
    out, lse = fa.flash_fwd(*a, rate, seed)
    want, want_lse = fa.flash_forward_plain(*a, rate, seed)
    dvec = (dout.float() * want.float()).sum(-1)
    g = (dout, want_lse, dvec, rate, seed)
    pairs = torch.zeros(1, dtype=torch.int32, device=dev)
    got = fa.flash_bwd(*a, *g, pairs=pairs)
    again = fa.flash_bwd(*a, *g)
    plain = fa.flash_backward_plain(*a, *g)
    torch.cuda.synchronize()
    shape = (f"b={b} h={h} hk={hk} sq={sq} skv={skv} d={d} causal={causal} "
             f"bias={None if bias is None else tuple(bias.shape)} "
             f"dropout={rate} {str(dt).split('.')[-1]}")
    errs = {"fwd": compare(f"flash_fwd out {label} {shape}", out, want,
                           f32=f32)}
    compare(f"flash_fwd lse {label}", lse, want_lse, f32=f32)
    errs["bwd"] = max(compare(f"flash_bwd {n} {label}", x, y, f32=f32)
                      for n, x, y in zip(("dq", "dk", "dv"), got, plain))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    if not same:
        raise AssertionError(f"flash_bwd {label}: reruns differ")
    plan = (flash_f32_plan(torch, label, q, k) if f32 else
            flash_plan(torch, label, q, k, causal, int(pairs), bias is None))
    del out, lse, got, again, plain, want, want_lse
    routes = ("f32" if f32 else
              f"fwd {plan['fwd_route']}, bwd {plan['bwd_route']}")
    ms = {"fwd": cuda_ms(torch, lambda: fa.flash_fwd(*a, rate, seed)),
          "bwd": cuda_ms(torch, lambda: fa.flash_bwd(*a, *g))}
    plain_ms = {"fwd": cuda_ms(torch, lambda: fa.flash_forward_plain(
        *a, rate, seed), 3),
        "bwd": cuda_ms(torch, lambda: fa.flash_backward_plain(*a, *g), 3)}
    mask = None
    if bias is not None or causal:
        mask = ((0 if bias is None else bias) + (
            causal_bias(sq, skv, dev) if causal else 0)).to(dt)
    lib = sdpa_times(torch, q, k, v, dout, mask, rate)
    log(f"  flash {label} ({routes}): fwd {ms['fwd']:.4f} ms (plain "
        f"{plain_ms['fwd']:.4f}, SDPA {lib['fwd']:.4f}), bwd (dq dk dv) "
        f"{ms['bwd']:.4f} ms (plain {plain_ms['bwd']:.4f}; SDPA backward "
        f"alone {lib['bwd']:.4f})")
    for kind in ("fwd", "bwd"):
        if f32:
            bms, by = f32_flash_bound(label, kind, q, k, bias, causal,
                                      ms[kind])
        else:
            n_bytes, flops = flash_work(q, k, bias, causal, kind)
            bms, by = bound_ms(n_bytes, flops)
            log(f"    flash_{kind} {label}: bound {bms:.5f} ms ({by}; "
                f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB), kernel "
                f"at {bms / ms[kind]:.3f} of it")
        results.setdefault(f"flash_{kind}", {"name": f"flash_{kind}"})[
            f"{label}_shape"] = dict(
                b=b, h=h, hk=hk, sq=sq, skv=skv, d=d, causal=causal,
                dtype=str(dt).split(".")[-1], route=routes,
                max_abs_err=errs[kind], ms=ms[kind], plain_ms=plain_ms[kind],
                bound_ms=bms, bound_by=by, library_ms=lib[kind], plan=plan)


def phase_train_kernels(torch, results):
    """[train-kernels]: each family's largest flash call of each dtype and
    every int4_matmul shape its training step ran, against the plain
    versions, timed beside the bound and the yardsticks (SDPA; bf16
    torch.matmul on the weight dequantised once)."""
    from image2text_torch.models.quantization import quantize_blockwise

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    for name in FAMILY_YAML:
        for key, bias in largest_flash_calls(name):
            dt = "f32" if key[5] == torch.float32 else "bf16"
            flash_case(torch, results, f"train_{name}_{dt}".replace("-", "_"),
                       key, bias, gen)
        for rows, in_f, out_f in sorted(TRAIN_INT4.get(name, ())):
            w = torch.empty(out_f, in_f, device=dev).normal_(
                0.0, 0.02, generator=gen)
            packed, scales = quantize_blockwise(w)
            del w
            x = torch.randn(rows, in_f, device=dev, generator=gen).to(bf)
            int4_case(torch, results, f"train_{name}_{in_f}x{out_f}", x,
                      packed, scales.to(bf), iters=5)
            del x, packed, scales
        torch.cuda.empty_cache()


LOCAL_IMAGES = 64


def write_image_dir(root: Path, n: int, seed: int) -> str:
    """``n`` images of random sizes made from ``seed`` (uint8 ``.npy``,
    and every other one a PNG where PIL is importable) and a captions.json
    of 1–5 captions each (synthetic token ids); returns which formats."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.default_rng(seed)
    mapping = {}
    for i in range(n):
        h, w = (int(v) for v in rng.integers(160, 400, 2))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if Image is not None and i % 2:
            name = f"img_{i:03d}.png"
            Image.fromarray(arr).save(root / name)
        else:
            name = f"img_{i:03d}.npy"
            np.save(root / name, arr)
        mapping[name] = [" ".join(str(int(t)) for t in rng.integers(
            3, 50000, int(rng.integers(6, 20)))) for _ in range(1 + i % 5)]
    (root / "captions.json").write_text(json.dumps(mapping))
    return "npy and png" if Image is not None else "npy (no PIL)"


def local_yaml(src: str, out: Path, image_dir: Path, extra: dict) -> Path:
    """``src`` on ``image_dir`` (dataset: local, the synthetic tokenizer)
    with ``extra`` lines replaced: a copy of the YAML's text."""
    text = (REPO / src).read_text()
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("tokenizer_str:", "dataset:",
                                   "dataset_dir:", "max_loop_epochs:"))]
    text = "\n".join(lines) + "\n"
    for old, new in extra.items():
        if old not in text:
            raise AssertionError(f"{src}: no {old!r}")
        text = text.replace(old, new)
    text = (f"tokenizer_str: 'synthetic'\ndataset: 'local'\n"
            f"dataset_dir: '{image_dir}'\nmax_loop_epochs: 1\n") + text
    out.write_text(text)
    return out


def run_trainer_cli(yaml: Path, ck: Path) -> list:
    """``python -m image2text_torch.trainer`` on ``yaml``: its exit code
    must be 0; returns the losses it printed."""
    import ast

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "image2text_torch.trainer",
                           "--config_file", str(yaml), "--chkpt_file",
                           str(ck)], cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise AssertionError(f"trainer CLI on {yaml.name}: exit "
                             f"{proc.returncode}")
    losses = []
    for line in proc.stdout.splitlines():
        if line.startswith("epoch ") and "{" in line:
            d = ast.literal_eval(line[line.index("{"):line.index("}") + 1])
            losses += [v for k, v in d.items() if "loss" in k]
        elif line.startswith("Epoch:"):
            losses.append(float(line.split("loss:")[1].split(",")[0]))
    log(f"  python -m image2text_torch.trainer --config_file {yaml.name}: "
        f"exit 0 in {time.perf_counter() - t0:.1f} s; losses printed "
        f"{losses}; checkpoint {ck.stat().st_size:,} bytes")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"trainer CLI on {yaml.name}: losses {losses}")
    return losses


def phase_local_data(torch, work: Path):
    """[local-data]: LOCAL_IMAGES images from SEED in a directory; the
    trainer twin's CLI on a derived local/nano-mini.yaml (dataset: local,
    the synthetic tokenizer, 3 steps, one val step: the ViT's transforms)
    and on a derived synthetic-smoke.yaml with its scratch encoder at the
    loader's 128 px (the Flickr resize: the C++ core, its library removed
    first so that this run builds it); the first batch of each route
    against the plain versions: the tokens bit for bit, the ViT's images
    bit for bit against the same transform, the C++ resize within 2e-5
    of the numpy resize."""
    import numpy as np

    from image2text_torch.training import data as tdata
    from image2text_torch.training import native
    from image2text_torch.training.tokenizer import SyntheticTokenizer

    image_dir = work / "images"
    image_dir.mkdir()
    formats = write_image_dir(image_dir, LOCAL_IMAGES, SEED + 60)
    try:
        import PIL  # noqa: F401
        vit_route = "PIL bicubic"
    except ImportError:
        vit_route = "the bilinear host resize (no PIL)"
    log(f"  {LOCAL_IMAGES} images ({formats}) in {image_dir}; the ViT "
        f"transform's resize here: {vit_route}")
    lib = native.lib_path()
    lib.unlink(missing_ok=True)
    nano = local_yaml(NANO_YAML["nano-mini"], work / "nano-mini-local.yaml",
                      image_dir, {"num_steps: 200": "num_steps: 3",
                                  "num_val_steps: 20": "num_val_steps: 1"})
    run_trainer_cli(nano, work / "nano-mini-local.npz")
    built_by_vit = lib.exists()
    smoke = local_yaml(SMOKE_YAML, work / "smoke-local.yaml", image_dir, {
        "width: 64": "width: 128", "height: 64": "height: 128",
        "num_steps: 20": "num_steps: 3", "num_val_steps: 4":
        "num_val_steps: 1"})
    run_trainer_cli(smoke, work / "smoke-local.npz")
    log(f"  the C++ core's library {lib.name}: built by the ViT run "
        f"{built_by_vit} (its transform does not use it), by the 128-px "
        f"run {lib.exists()}")
    if built_by_vit or not lib.exists():
        raise AssertionError("local-data: the C++ core was not built by the "
                             "run that uses it")
    for is_vit in (True, False):
        tok = SyntheticTokenizer(50259)
        train, _ = tdata.get_local_dataloader(tok, 8, False, is_vit,
                                              dataset_dir=str(image_dir))
        batch = next(iter(train))
        rows = train.rows
        max_err = 0.0
        for i in range(8):
            row = rows[i]
            img = np.asarray(row["image"])
            if is_vit:
                want = tdata.preprocess_image_vit(img)
                if not np.array_equal(batch["image"][i], want):
                    raise AssertionError("local-data: ViT image differs")
            else:
                want = ((tdata._resize_bilinear(img, 128) / 255.0
                         - tdata.FLICKR_MEAN[:, None, None])
                        / tdata.FLICKR_STD[:, None, None]).astype(np.float32)
                max_err = max(max_err, float(np.abs(
                    batch["image"][i] - want).max()))
            for k in range(5):
                enc = tok(text=row[f"caption_{k}"][0], max_length=256,
                          truncation="longest_first", padding="max_length")
                if not (np.array_equal(batch[f"input_ids_{k}"][i],
                                       enc["input_ids"])
                        and np.array_equal(batch[f"attn_mask_{k}"][i],
                                           enc["attention_mask"])):
                    raise AssertionError("local-data: tokens differ")
        log(f"  first batch ({'ViT 224' if is_vit else 'Flickr 128'}): "
            f"{tuple(batch['image'].shape)}, tokens and masks bit for bit; "
            + ("images bit for bit against the transform" if is_vit else
               f"the C++ resize against the numpy resize: max abs error "
               f"{max_err:.3g} (limit 2e-5)"))
        if max_err > 2e-5:
            raise AssertionError(f"local-data: C++ resize {max_err}")


# -- fault (d)'s shapes, the flash planes, the mesh --------------------------

# Head dims the flash kernels pad (80 → 128, 192 → 256) or take (256): the
# flagship's encoder call at 4 images, 8 heads on one K/V head
FLASH_HEAD_DIMS = (
    ("head_dim_80", 4, 8, 1, 160, 160, 80, False, None, DROPOUT),
    ("head_dim_192", 4, 8, 1, 160, 160, 192, True, None, DROPOUT),
    ("head_dim_256", 4, 8, 1, 160, 160, 256, False, None, DROPOUT))
# (label, images, rows an image, heads): the chain past the resident
# attention's 432 rows at the flagship's width (head dim 128), and at head
# dim 256 (4 heads of d 1024) below and past it
CHAIN_ROWS = (("rows_448", 4, 448, 8), ("rows_1024", 4, 1024, 8),
              ("head_dim_256", 8, 320, 4), ("head_dim_256_rows_1024", 4,
                                             1024, 4))
MESH_GEN_BATCH = 8   # [dist]'s generate: images, 4 new tokens


def dense_block(torch, n_head: int, dtype):
    """A dense flagship encoder block (d 1024, MQA, the MoE FFN) with
    ``n_head`` heads and random weights from SEED, on the card."""
    from image2text_torch.configs.models import FLAGSHIP
    from image2text_torch.models.layers import TransformerBlock
    from image2text_torch.nn.core import generator, init_parameters

    cfg = copy.deepcopy(FLAGSHIP.vision_encoder_config.transformer_config)
    cfg.is_sparse_attn = False
    cfg.attn_config.n_head = n_head
    blk = TransformerBlock(cfg, device="cuda")
    init_parameters(blk, generator(SEED + 7, "cuda"))
    return blk.to(dtype).eval()


def route_ties(routes, gates, k) -> dict:
    """``kernel_check.check_routes``'s statistics held to its tie limit
    alone: every row routed apart from the plain top-k crosses a gap
    within TIE of its largest gate; no limit on how many there are."""
    import torch

    from image2text_torch.ops.fused_moe import topk_mask, unpack_mask
    from image2text_torch.utils.kernel_check import TIE

    n, _, e = gates.shape
    took = unpack_mask(routes.reshape(n, 2), e)
    lowest = torch.where(took, gates, torch.inf).amin(-1)
    highest = torch.where(took, -torch.inf, gates).amax(-1)
    gap = float(((highest - lowest).clamp_min(0) / gates.amax(-1)).amax())
    apart = int((took != topk_mask(gates, k)).any(-1).any(-1).sum())
    if gap > TIE or not bool((took.sum(-1) == min(k, e)).all()):
        raise AssertionError(f"chain routes: tie gap {gap} or expert count")
    return {"rows_apart": apart, "rows": n, "max_tie_gap": gap, "limit": TIE}


def phase_chain_rows(torch, results):
    """fused_block past the resident attention's shared memory (448 and
    1,024 rows an image: its K/V-tiled route) and at head dim 256, against
    the plain version on the kernel's own routes; kernel, plain, bound,
    the two projections' ``torch.matmul`` + SDPA, and the attention kernel
    alone beside SDPA on the folded query."""
    import torch.nn.functional as F

    from image2text_torch.ops.fused_block import (attn_route, fused_block,
                                                  fused_block_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for label, b, t, n_head in CHAIN_ROWS:
        blk = dense_block(torch, n_head, torch.bfloat16)
        w = blk.block_weights(torch.bfloat16)
        d = w.w_o.shape[0]
        hd = d // n_head
        x = torch.randn(b, t, d, device="cuda", generator=gen).to(
            torch.bfloat16)
        n, e, k = b * t, w.fc.e, w.fc.k
        before = fused_block.launches
        got, want, rk, gv = run_pair(torch, fused_block, fused_block_plain,
                                     (x, w), n, e)
        assert fused_block.launches == before + 1
        err = compare(f"fused_block {label} b={b} t={t} d={d} heads "
                      f"{n_head} (attention route {attn_route(t, hd)})",
                      got, want)
        # the plain version ran on the kernel's routes; a row routed apart
        # from the plain top-k must be a near tie (random gates at d 1024
        # put a few of these b·t rows within 1e-6 of one)
        rt = route_ties(rk, gv, k)
        log(f"    routes: {rt['rows_apart']} of {rt['rows']} rows apart "
            f"from the plain top-k, largest tie gap {rt['max_tie_gap']:.3g} "
            f"(limit {rt['limit']})")
        del got, want
        ms = cuda_ms(torch, lambda: fused_block(x, w))
        plain = cuda_ms(torch, lambda: fused_block_plain(x, w))
        ffn_flops, _ = moe_flops_bytes(x.reshape(n, d), w.fc, w.proj)
        flops = (2 * n * d * (d + 2 * hd) + 4 * b * n_head * t * t * hd
                 + 2 * n * d * d + ffn_flops)
        wbytes = sum(nbytes(getattr(w, f)) for f in w._fields[:8]) + nbytes(
            w.fc, w.proj)
        bms, by = bound_ms(2 * nbytes(x) + wbytes, flops)
        a = torch.randn(n, d, device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        q = torch.randn(b, n_head, t, hd, device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        kv = torch.randn(b, 1, t, hd, device="cuda", dtype=torch.bfloat16,
                         generator=gen)
        lib = cuda_ms(torch, lambda: (
            torch.matmul(a, w.w_qkv), torch.matmul(a, w.w_o),
            F.scaled_dot_product_attention(q, kv, kv, enable_gqa=True)))
        stages = chain_stage_ms(torch, w, b, t, 0, gen)
        log(f"  fused_block {label}: kernel {ms:.4f} ms, plain {plain:.4f}, "
            f"bound {bms:.4f} ({by}; at {bms / ms:.3f} of it), torch.matmul "
            f"x2 + SDPA {lib:.4f}; attention kernel {stages['attention_ms']:.4f}"
            f" ms, SDPA on the folded query "
            f"{stages['attention_library_ms']:.4f} ({CARD})")
        kernel_row(results, "fused_block", label, None, None,
                   dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                        bound_by=by, library_ms=lib,
                        route=attn_route(t, hd), **stages),
                   b=b, t=t, d=d, n_head=n_head)
        del blk, w, x, a, q, kv
        torch.cuda.empty_cache()


def phase_f32_chain(torch):
    """An f32 sparse flagship encoder block's eval forward on the card
    takes the composed route (JAX's gate on hardware declines f32): no
    chain kernel, one ``moe_ffn`` launch (its f32 form); against a CPU
    copy, which takes the chain's plain version, at the f32 limits."""
    from image2text_torch.configs.models import FLAGSHIP
    from image2text_torch.models.layers import TransformerBlock
    from image2text_torch.nn.core import generator, init_parameters
    from image2text_torch.ops.fused_block import fused_block, sparse_block
    from image2text_torch.ops.fused_moe import moe_ffn

    cfg = FLAGSHIP.vision_encoder_config
    blk = TransformerBlock(cfg.transformer_config, seed=1, device="cuda")
    init_parameters(blk, generator(SEED + 9, "cuda"))
    blk.eval()
    t = cfg.transformer_config.max_block_size
    x = torch.randn(8, t, blk.attn.n_embd, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    with record_moe_rows("f32_chain"):
        counts, (got, layout) = launch_counts(
            lambda: blk(x, want_lazy=True))
    cpu = copy.deepcopy(blk).cpu()
    want, layout_cpu = cpu(x.cpu(), want_lazy=True)
    log(f"  f32 sparse block (b 8, t {t}, d {blk.attn.n_embd}): launches "
        f"{ {k: v for k, v in counts.items() if v} } (want moe_ffn 1, no "
        f"chain kernel)")
    if (counts["sparse_block"] or counts["fused_block"]
            or counts["moe_ffn"] != 1 or got.dtype != torch.float32
            or not (layout == layout_cpu).all()):
        raise AssertionError(f"f32 chain route: {counts}")
    compare("f32 sparse block card (composed) vs CPU (chain plain)",
            got.cpu(), want, f32=True)


def phase_flash_planes(torch, results):
    """One rank's slice of a dp2 × tp2 flagship training attention call
    (rows 48–95 of 96, heads 4–7 of 8, the encoder's 160 keys, dropout
    0.1): with its planes (``planes_of``) the forward's output and lse and
    the backward's dQ are bit for bit the whole call's slice, and its dK,
    dV match the plain version with the same planes; bf16 and f32."""
    from image2text_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    B, H, s, d, rate, seed = 2 * TRAIN_BATCH, 8, 160, 128, DROPOUT, 20240
    b0, h0 = TRAIN_BATCH, 4
    for dtype in (torch.bfloat16, torch.float32):
        q, dout = (torch.randn(B, H, s, d, device="cuda", generator=gen
                               ).to(dtype) for _ in range(2))
        k, v = (torch.randn(B, 1, s, d, device="cuda", generator=gen
                            ).to(dtype) for _ in range(2))
        out_w, lse_w = fa.flash_fwd(q, k, v, None, False, rate, seed)
        dvec_w = (dout.float() * out_w.float()).sum(-1)
        dq_w = fa.flash_bwd(q, k, v, None, False, dout, lse_w, dvec_w, rate,
                            seed)[0]
        mine = (slice(b0, B), slice(h0, H))
        ql, doutl = (t[mine].contiguous() for t in (q, dout))
        kl, vl = (t[b0:].contiguous() for t in (k, v))
        planes = fa.planes_of(B - b0, H - h0, rows=(b0, B), heads=(h0, H))
        out, lse = fa.flash_fwd(ql, kl, vl, None, False, rate, seed, planes)
        g = (doutl, lse, dvec_w[mine].contiguous(), rate, seed)
        got = fa.flash_bwd(ql, kl, vl, None, False, *g, planes=planes)
        plain = fa.flash_backward_plain(ql, kl, vl, None, False, *g,
                                        planes=planes)
        unplaced, _ = fa.flash_fwd(ql, kl, vl, None, False, rate, seed)
        torch.cuda.synchronize()
        same = (torch.equal(out, out_w[mine]), torch.equal(lse, lse_w[mine]),
                torch.equal(got[0], dq_w[mine]))
        log(f"  flash {str(dtype)[6:]} b {B - b0} of {B}, heads {H - h0} of "
            f"{H}, planes {planes}: out, lse, dQ bit for bit the whole "
            f"call's slice {same}; without the planes the output differs: "
            f"{not torch.equal(unplaced, out)}")
        if not all(same) or torch.equal(unplaced, out):
            raise AssertionError(f"flash planes {dtype}: {same}")
        for name, x, y in zip(("dk", "dv"), got[1:], plain[1:]):
            compare(f"flash_bwd {name} with planes ({str(dtype)[6:]})", x, y,
                    f32=dtype == torch.float32)
        del q, k, v, dout, out_w, lse_w, dq_w, got, plain


def _dist_flagship(torch, zero: bool):
    """The flagship's training setup (as ``train_setup``) with ZeRO-1 set
    as asked."""
    cfg, wrapper, _ = train_setup(torch)
    cfg.zero_sharded_optimizer = zero
    return cfg, wrapper


def step_windows(torch, trainer, images, labels):
    """(median step ms of 3 windows of 2 steps, peak GiB since the last
    reset)."""
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(images, labels)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 2)
    log(f"    windows (ms): {[round(x * 1e3, 2) for x in windows]}")
    return (statistics.median(windows) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _greedy(torch, model, images):
    prompt = torch.full((images.shape[0], 1), FLAGSHIP_BOS,
                        dtype=torch.long, device="cuda")
    with torch.no_grad():
        return model.generate(images, prompt, max_new_tokens=4,
                              temperature=0.0)


def phase_dist(torch, results):
    """The mesh on the card, NCCL over every card there is.  In this
    process (world size 1): the full-width flagship step (b 48, full
    depth, bf16, SNRAdam, dropout 0.1, ``zero_sharded_optimizer`` set:
    with one data rank ZeRO-1 stays off, as JAX's rule has it) through
    ``parallel/mesh.py`` and the mesh Trainer, bit for bit the one-device
    Trainer's step (every parameter's digest, the loss), flash launches
    48/24; its step ms and peak memory; greedy generate under the mesh
    with the one-device tokens.  With two or more cards, also the
    dp × tp mesh ``dryrun_multichip`` picks, one rank a card."""
    import torch.distributed as dist

    from image2text_torch.parallel.mesh import make_mesh
    from image2text_torch.training.loop import Trainer

    n = torch.cuda.device_count()
    cfg, wrapper = _dist_flagship(torch, zero=True)
    images, labels = train_inputs(torch, cfg, TRAIN_BATCH, SEED + 5)
    gen_images = torch.as_tensor(images[:MESH_GEN_BATCH], device="cuda")
    tokens = _greedy(torch, wrapper.model, gen_images)
    trainer = Trainer(cfg, wrapper)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, m = launch_counts(lambda: trainer.train_step(images, labels))
    want = {k: float(v) for k, v in m.items()}
    digests = {k: tensor_digest(torch, p)
               for k, p in wrapper.named_parameters()}
    one_ms, one_peak = step_windows(torch, trainer, images, labels)
    log(f"  one device: launches {counts}; metrics {want}; step ms "
        f"{one_ms:.2f}, peak memory {one_peak:.3f} GiB")
    del trainer, wrapper
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="dist-", dir=REPO / "build")
    dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous",
                            rank=0, world_size=1)
    try:
        cfg, wrapper = _dist_flagship(torch, zero=True)
        mesh = make_mesh(cfg.mesh, "cuda")
        trainer = Trainer(cfg, wrapper, mesh=mesh)
        tokens_mesh = _greedy(torch, wrapper.model, gen_images)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_m, m = launch_counts(lambda: trainer.train_step(images,
                                                               labels))
        got = {k: float(v) for k, v in m.items()}
        moved = [k for k, p in wrapper.named_parameters()
                 if tensor_digest(torch, p) != digests[k]]
        record_launches(results, "mesh_train_step", counts_m)
        log(f"  mesh {mesh} over NCCL ({dist.get_backend()}), ZeRO-1 "
            f"{'on' if trainer.zero else 'off (one data rank)'}: launches "
            f"{counts_m}; metrics {got}; parameters not bit for bit the "
            f"one-device step's: {len(moved)}; generate's tokens equal: "
            f"{torch.equal(tokens, tokens_mesh)}")
        if (got != want or moved or counts_m != counts
                or counts_m["flash_fwd"] != 48 or counts_m["flash_bwd"] != 24
                or not torch.equal(tokens, tokens_mesh)):
            raise AssertionError(f"[dist] mesh step differs: {moved[:3]}")
        step_ms, peak = step_windows(torch, trainer, images, labels)
        log(f"  mesh step ms (median of 3 windows of 2 steps after the "
            f"compared one): {step_ms:.2f} (one device {one_ms:.2f}); peak "
            f"memory {peak:.3f} GiB (one device {one_peak:.3f}) on "
            f"{torch.cuda.get_device_name(0)} ({CARD})")
        del trainer, wrapper
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    dropout_cost(torch)
    if n < 2:
        log(f"  one card ({n}): NCCL ran at world size 1; the ranks of a "
            f"mesh meet on this card over gloo ([dist-tp]) and on CPU gloo "
            f"ranks ([dryrun])")
        return
    from image2text_torch.parallel import checks
    from image2text_torch.parallel.launch import run_ranks

    out = run_ranks(checks.card_mesh_step, n, backend="nccl")[0]
    cfg = checks.card_flagship_config(2, 8)
    w = checks.build(cfg, device="cuda")
    one = Trainer(cfg, w).train_step(*checks.batches(
        1, 8, seed=5, image=128, vocab=cfg.model.decoder_config.vocab_size
    )[0])
    ref = {k: float(v) for k, v in one.items()}
    log(f"  {n} cards, mesh dp{out['mesh'][0]} x tp{out['mesh'][1]}, depth "
        f"2: {out['metrics']} against one card's {ref}")
    for k, v in ref.items():
        if abs(out["metrics"][k] - v) > TRAIN_LOSS_TOL * abs(v):
            raise AssertionError(f"[dist] {n} cards: {k}")


def dropout_cost(torch, data: int = 8, batch: int = TRAIN_BATCH,
                 t: int = TRAIN_SEQ, d: int = 1024):
    """What a data rank pays for a dropout under a mesh of ``data`` data
    ranks: ``nn.core.dropout`` draws the mask of the global batch and keeps
    the rank's rows.  Its ms and transient peak on the rank's ``batch /
    data`` rows of a bf16 (rows, t, d) residual, beside the same rows
    drawn alone (one device at that batch)."""
    from image2text_torch.nn.core import Ctx, dropout

    x = torch.randn(batch // data, t, d, device="cuda").to(torch.bfloat16)
    out = {}
    for name, rows in (("global draw", (0, batch)), ("local draw", (0, 0))):
        ctx = Ctx(SEED, True, rows)
        dropout(x, 0.1, ctx)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: dropout(x, 0.1, ctx))
        out[name] = (ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    (g_ms, g_mb), (l_ms, l_mb) = out["global draw"], out["local draw"]
    log(f"  dropout on one data rank's {batch // data} of {batch} rows of a "
        f"bf16 ({t}, {d}) residual (dp{data}): the global draw "
        f"{g_ms:.4f} ms, {g_mb:.1f} MiB transient, against {l_ms:.4f} ms, "
        f"{l_mb:.1f} MiB drawn alone ({g_ms / l_ms:.1f}x) on {CARD}")


def phase_dist_tp(torch):
    """The ranks of a mesh on this card: ``parallel/checks.py::
    card_tp_check`` on 2 gloo ranks (dp1 x tp2 with SP, the flagship at
    full width and depth 2, bf16, SNRAdam, dropout 0.1): a train step, a
    val step and greedy generate, held against ``card_reference`` (one
    device, in this process meanwhile): losses within TRAIN_LOSS_TOL (a
    bf16 split sum reorders additions), the same kernel launches, and at
    least 3/4 of the tokens equal (a near-tie the bf16 sums flip changes
    a row's later tokens)."""
    from image2text_torch.parallel import checks
    from image2text_torch.parallel.launch import Ranks

    t0 = time.perf_counter()
    ranks = Ranks(checks.card_tp_check, 2)
    try:
        ref = checks.card_reference()[0]
    finally:
        got = ranks.join()[0][0]
    log(f"  {got['mesh']} on 2 gloo ranks sharing {CARD} "
        f"({time.perf_counter() - t0:.1f} s with the reference)")
    bad = []
    for part in ("train", "val"):
        g, r = got[part]["result"], ref[part]["result"]
        log(f"  {part}: {g} against one device's {r}")
        bad += [f"{part} {k}" for k, v in r.items()
                if abs(g[k] - v) > TRAIN_LOSS_TOL * abs(v)]
    for part in ("train", "val", "greedy"):
        counts = got[part]["launches"]
        log(f"  {part} launches on rank 0: {counts} (one device: "
            f"{ref[part]['launches']})")
        if counts != ref[part]["launches"]:
            bad.append(f"{part} launches")
    used = {k for p in ("train", "val", "greedy")
            for k, n in got[p]["launches"].items() if n}
    if not {"sparse_block", "moe_ffn", "flash_fwd", "flash_bwd"} <= used:
        bad.append(f"kernels launched: {sorted(used)}")
    tokens, want = got["greedy"]["result"], ref["greedy"]["result"]
    agree = float((tokens == want).mean())
    distinct = len({tuple(row) for row in want[:, 1:].tolist()})
    log(f"  generate on images of distinct means: tokens {tokens.tolist()}, "
        f"equal to one device's: {agree:.4f}; {distinct} distinct captions "
        f"of {len(want)} on one device")
    if agree < 0.75:
        bad.append("generate")
    if bad:
        raise AssertionError(f"[dist-tp] differs: {bad}")


# -- the int4 + LoRA model split, LoRA on the ViT and the scratch decoder,
# MoE gates of other depths -------------------------------------------------

INT4_TP_DEPTH = 4       # llama2-13b.yaml's 40 layers cut for time (PERF.md)
INT4_TP_SHALLOW = 2     # the bf16 kernel run held to one device exactly
INT4_TP_BATCH = 8       # its training batch (accumulation 2 cut to 1)
INT4_TP_NEW = 8         # new tokens of the greedy and beam calls
INT4_TP_LOSS_TOL = 1e-3     # bf16, tp2 against one device: loss, relative
INT4_TP_GRAD_TOL = 2e-2     # adapter gradients, relative L2
INT4_TP_F32_TOL = 1e-6      # f32: loss, relative
# phase → (family, the part its LoRA spec goes on, the spec's targets, the
# modules it keeps trainable: the decoder's that tpu/nano.yaml's groups
# train, as local/gpt2.yaml's spec keeps its cross-attention)
LORA_PHASES = {
    "lora-vit": ("gpt2", "encoder", ["out_proj", "mlp.0", "mlp.3"], None),
    "lora-decoder": ("nano", "decoder", ["c_attn", "c_proj", "c_fc"],
                     ["*.cross_attn.*", "*.ln_3.*", "*.wpe.*"]),
}
LORA_BATCH = 64         # the caption call's images
MOE_GATES = (None, (32, 16))


def _int4_tp_diffs(torch, got, ref) -> dict:
    """What parts two runs of ``checks._card_run``: loss (relative),
    adapter gradients and first-token logits (relative L2), the share of
    greedy tokens and beam ids equal, the beam's worst log-score gap."""
    import numpy as np

    gl = got["train"]["result"]["train_loss_lm"]
    rl = ref["train"]["result"]["train_loss_lm"]
    grads = {k: torch.from_numpy(v) for k, v in got["adapter_grads"].items()}
    rgrads = {k: torch.from_numpy(v) for k, v in ref["adapter_grads"].items()}
    lg, rlg = (torch.from_numpy(x["logits"]["result"]) for x in (got, ref))
    gb, rb = got["beam"]["result"], ref["beam"]["result"]
    return dict(
        loss=abs(gl - rl) / abs(rl),
        grads=(grad_error(torch, grads, rgrads) if set(grads) == set(rgrads)
               else math.inf),
        logits=rel_l2(torch, lg, rlg),
        greedy=float((got["greedy"]["result"]
                      == ref["greedy"]["result"]).mean()),
        beam=float((gb["ids"] == rb["ids"]).mean()),
        scores=float(np.abs(gb["scores"] - rb["scores"]).max()),
        rounds=rb["rounds"])


def _fmt(d: dict) -> str:
    return (f"loss {d['loss']:.3g}, adapter gradients {d['grads']:.3g}, "
            f"first-token logits {d['logits']:.3g} (relative), greedy "
            f"tokens equal {d['greedy']:.3f}, beam ids equal {d['beam']:.3f}, "
            f"log-scores worst {d['scores']:.4g} over {d['rounds']} rounds")


def _exact(d: dict) -> bool:
    """A split that computes the unsplit model in f32: loss within
    INT4_TP_F32_TOL, adapter gradients and logits within NANO_CPU_TOL,
    every greedy token and beam id equal, log-scores within
    BEAM_SCORE_TOL a round."""
    return (d["loss"] <= INT4_TP_F32_TOL and d["grads"] <= NANO_CPU_TOL
            and d["logits"] <= NANO_CPU_TOL and d["greedy"] == 1.0
            and d["beam"] == 1.0
            and d["scores"] <= BEAM_SCORE_TOL * max(d["rounds"], 1))


def _within_twice(split: dict, one: dict) -> list:
    """The keys on which the split's bf16 run is further from the f32
    truth than twice one device's bf16 run: gradients and logits by
    their relative error, greedy tokens and beam ids by the share that
    differs."""
    bad = [k for k in ("grads", "logits") if split[k] > 2 * one[k]]
    return bad + [k for k in ("greedy", "beam")
                  if 1 - split[k] > 2 * (1 - one[k])]


def phase_dist_tp_int4(torch, results):
    """[dist-tp-int4]: ``parallel/checks.py``'s Llama form at
    ``training_configs/tpu/llama2-13b.yaml``'s full width (int4 + LoRA,
    SNRAdam): each run on one device (in this process), then the same
    runs on dp1 x tp2 with SP on 2 gloo ranks sharing the card (one
    spawn), on the same seeded weights: a greedy caption call, the first
    token's logits and a greedy beam call (width 3, expansion 4) on
    images of distinct means, all of the initial weights, then a train
    step.

    * f32 at INT4_TP_DEPTH layers on the int4 product's plain version
      (the kernel takes bf16 only): the split computes the unsplit model
      (``_exact``).
    * bf16 on the kernel at INT4_TP_SHALLOW and at INT4_TP_DEPTH layers:
      held against one device, the loss within INT4_TP_LOSS_TOL (and at
      INT4_TP_SHALLOW layers the adapter gradients within
      INT4_TP_GRAD_TOL); held against the f32 truth (one device's f32
      run at that depth), the split no further from it than twice one
      device's bf16 run (``_within_twice``).  Tokens are not held equal
      in bf16: on these random weights any change of the f32 sums' order
      parts some of them at near ties, one device's kernel against its
      own plain version (at INT4_TP_SHALLOW layers, reported) as much as
      the split.
      int4_matmul launches as many times at the shard shapes as one
      device at the whole ones, each rank half of the int4 bytes, the
      beams checked alike over the model group every round.  Step,
      greedy and beam ms of rank 0 beside one device's.
    Then int4_matmul at the rank's shard shapes (training and greedy
    decode rows) against its plain version, in bf16 and with its f32
    output (``int4_case``)."""
    from image2text_torch.configs.reader import load_training_config
    from image2text_torch.models.quantization import quantize_blockwise
    from image2text_torch.parallel import checks
    from image2text_torch.parallel.launch import Ranks

    base = dict(depth=INT4_TP_DEPTH, batch=INT4_TP_BATCH,
                n_gen=INT4_TP_BATCH, n_new=INT4_TP_NEW)
    f32 = dict(precision="no", plain=True)
    runs = [dict(base, **f32), dict(base), dict(base, depth=INT4_TP_SHALLOW)]
    t0 = time.perf_counter()
    refs = checks.card_reference("llama", runs + [
        dict(runs[2], plain=True), dict(runs[2], **f32)])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    outs = Ranks(checks.card_tp_check, 2, "llama", runs).join()
    log(f"  one device {t1 - t0:.1f} s, 2 gloo ranks sharing the card "
        f"{time.perf_counter() - t1:.1f} s (f32 on the int4 plain version "
        f"and bf16 on the kernel at {INT4_TP_DEPTH} layers, bf16 on the "
        f"kernel at {INT4_TP_SHALLOW}; one device also bf16 on the plain "
        f"version and f32 at {INT4_TP_SHALLOW}; build, captions, step "
        f"each)")
    (f_ref, ref, s_ref, s_plain, s_f32), (f_got, got, s_got) = (
        refs, outs[0])
    bad = []
    d = _int4_tp_diffs(torch, f_got, f_ref)
    log(f"  f32, {INT4_TP_DEPTH} layers, tp2 against one device: {_fmt(d)}")
    if not _exact(d):
        bad.append("f32")
    log(f"  bf16, {INT4_TP_SHALLOW} layers, one device's kernel against "
        f"its plain version: {_fmt(_int4_tp_diffs(torch, s_plain, s_ref))}")
    for depth, g, r, truth in ((INT4_TP_SHALLOW, s_got, s_ref, s_f32),
                               (INT4_TP_DEPTH, got, ref, f_ref)):
        one = _int4_tp_diffs(torch, g, r)
        g_t = _int4_tp_diffs(torch, g, truth)
        r_t = _int4_tp_diffs(torch, r, truth)
        log(f"  bf16 kernel, {depth} layers, tp2 against one device: "
            f"{_fmt(one)}")
        log(f"  bf16 kernel, {depth} layers, against the f32 truth: tp2 "
            f"{_fmt(g_t)}; one device {_fmt(r_t)}")
        if one["loss"] > INT4_TP_LOSS_TOL:
            bad.append(f"bf16 {depth} layers loss")
        if depth == INT4_TP_SHALLOW and one["grads"] > INT4_TP_GRAD_TOL:
            bad.append(f"bf16 {depth} layers grads")
        bad += [f"bf16 {depth} layers {k} (truth)"
                for k in _within_twice(g_t, r_t)]
    log(f"  int4 weights (in_pad, out) on rank 0 {got['int4_shapes']}, one "
        f"device {ref['int4_shapes']}")
    for label, g_run, r_run in (("", got, ref),
                                (f" at {INT4_TP_SHALLOW} layers", s_got,
                                 s_ref)):
        for part in ("train", "greedy", "beam"):
            g, r = g_run[part], r_run[part]
            n, want = (g["launches"]["int4_matmul"],
                       r["launches"]["int4_matmul"])
            log(f"  bf16{label} {part}: {g['ms']:.1f} ms on rank 0 against "
                f"{r['ms']:.1f} ms on one device; launches on rank 0 "
                f"{g['launches']} (one device {r['launches']})")
            if n != want or not n:
                bad.append(f"{part}{label} launches")
            if not label:
                record_launches(results, f"llama13b_tp2_{part}",
                                {"int4_matmul": n})
    for label, g_run, r_run in (("f32", f_got, f_ref), ("bf16", got, ref),
                                (f"bf16 at {INT4_TP_SHALLOW} layers", s_got,
                                 s_ref)):
        ri = r_run["greedy"]["result"]
        distinct = len({tuple(row) for row in ri[:, 1:].tolist()})
        gb = g_run["beam"]["result"]
        log(f"  {label}: {distinct} distinct captions of {len(ri)} images; "
            f"beam rounds checked alike over the model group {gb['agreed']} "
            f"of {gb['rounds']}")
        if distinct < 2 or gb["agreed"] != gb["rounds"] or not gb["rounds"]:
            bad.append(f"{label} captions")
    whole = ref["int4_bytes"]
    per_rank = [o[1]["int4_bytes"] for o in outs]
    log(f"  int4 bytes (packed + f32 scales): one device "
        f"{whole / 2 ** 30:.3f} GiB, ranks "
        f"{[round(b / 2 ** 30, 3) for b in per_rank]} GiB; resident device "
        f"bytes after the run: one device {ref['resident'] / 2 ** 30:.2f} "
        f"GiB, ranks {[round(o[1]['resident'] / 2 ** 30, 2) for o in outs]} "
        f"GiB")
    if any(2 * b != whole for b in per_rank):
        bad.append("int4 bytes")
    if bad:
        raise AssertionError(f"[dist-tp-int4] differs: {bad}")
    log("  int4_matmul at the rank's shard shapes (training rows and "
        "greedy decode rows) vs its plain version, bf16 and f32 output:")
    n_cls = load_training_config(
        checks.LLAMA_YAML).model.vision_encoder_config.n_cls
    rows = (INT4_TP_BATCH * (n_cls + checks.FORMS["llama"].card_seq),
            INT4_TP_BATCH)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    for r in sorted(rows):
        for in_pad, out in got["int4_shapes"]:
            w = torch.empty(out, in_pad, device=dev).normal_(
                0.0, 0.02, generator=gen)
            packed, scales = quantize_blockwise(w)
            del w
            x = torch.randn(r, in_pad, device=dev, generator=gen).to(bf16)
            int4_case(torch, results, f"llama13b_tp2_{r}x{in_pad}x{out}", x,
                      packed, scales.to(bf16), f32_out=True)
            del x, packed, scales
    torch.cuda.empty_cache()


def lora_edit(phase: str):
    """The config edit of a LoRA phase: its spec on the encoder or the
    decoder (r 16, alpha 64, dropout 0.1, as the YAMLs' decoder specs), and
    an optimizer group on ``*lora*`` ahead of the YAML's."""
    from image2text_torch.configs.models import LoraSpec
    from image2text_torch.configs.trainer import OptimizerConfig

    _, part, targets, enabled = LORA_PHASES[phase]

    def edit(cfg):
        sub = (cfg.model.vision_encoder_config if part == "encoder"
               else cfg.model.decoder_config)
        sub.lora_spec = LoraSpec(r=16, lora_alpha=64, lora_dropout=0.1,
                                 target_modules=targets,
                                 force_enable_update_modules=enabled)
        groups = [g for g in cfg.optimizers if g.target_modules]
        lr = cfg.optimizers[0].lr if cfg.optimizers else 6e-4
        # a catch-all group must be alone: the spec's group replaces it
        cfg.optimizers = [OptimizerConfig(lr=lr, target_modules=["*lora*"])
                          ] + groups
    return edit


def phase_lora(torch, args, results, phase: str):
    """[lora-vit] / [lora-decoder]: the family's YAML at full width and
    depth with the phase's LoRA spec set in code (``lora_edit``): a
    training step (``phase_train``: launches as derived, frozen tensors
    keep their digests, the loss falls) after which every adapter of the
    spec has moved; then a caption call in bf16 (greedy, LORA_BATCH
    images, MAX_NEW_TOKENS) with its launches held to
    ``serving_launches``; then the depth-2 form's training step, card
    against a CPU copy (``family_card_vs_cpu``)."""
    name, part, _, _ = LORA_PHASES[phase]
    holder = {}
    prefix = f"model.{part}."

    def setup():
        cfg, wrapper, trainer = family_setup(torch, name,
                                             edit=lora_edit(phase))
        holder["adapters"] = {
            k: tensor_digest(torch, p)
            for k, p in wrapper.named_parameters()
            if ".lora_" in k and k.startswith(prefix)}
        holder["wrapper"] = wrapper
        return cfg, wrapper, trainer

    with torch.enable_grad():
        model = phase_train(
            torch, args, results, f"{phase.replace('-', '_')}_train_step",
            setup, lambda cfg: family_inputs(torch, cfg, cfg.batch_size,
                                             SEED + 60),
            steps_per_window=1, keep=True)
    wrapper, adapters = holder.pop("wrapper"), holder.pop("adapters")
    named = dict(wrapper.named_parameters())
    moved = sum(tensor_digest(torch, named[k]) != v
                for k, v in adapters.items())
    log(f"  {len(adapters)} adapters of the spec on the {part}; moved by "
        f"the steps: {moved}")
    if not adapters or moved != len(adapters):
        raise AssertionError(f"[{phase}] adapters moved {moved} of "
                             f"{len(adapters)}")
    del wrapper, named
    model = model.to(torch.bfloat16).eval()
    bos = FAMILY_BOS[name]
    with torch.no_grad():
        frames, prompt = serving_inputs(torch, model, LORA_BATCH, SEED + 61,
                                        bos)
        from image2text_torch.models.generation import caption

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, ids = launch_counts(lambda: caption(
            model, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
            temperature=0.0, top_k=None))
        ms = (time.perf_counter() - t0) * 1e3
    record_launches(results, f"{phase.replace('-', '_')}_caption", counts)
    want = serving_launches(model)
    vocab = vocab_rows(model)
    log(f"  caption call, {LORA_BATCH} images, greedy, {MAX_NEW_TOKENS} new "
        f"tokens: {ms:.1f} ms; launches {counts} (want {want}); ids in "
        f"range {bool(((ids >= 0) & (ids < vocab)).all())}")
    if counts != want or not bool(((ids >= 0) & (ids < vocab)).all()):
        raise AssertionError(f"[{phase}] caption call")
    del model, ids
    torch.cuda.empty_cache()
    with torch.enable_grad():
        ok = family_card_vs_cpu(torch, name, edit=lora_edit(phase),
                                label=f"{phase} {name}")
    if not ok:
        raise AssertionError(f"[{phase}] depth 2: card and CPU differ")


def moe_gates_model(torch, gates, depth: int, dtype, device="cuda"):
    """The flagship with every block's MoE gates at ``gates`` (None: one
    linear gate), ``depth`` encoder and decoder layers, random weights
    from SEED."""
    from image2text_torch.configs.models import flagship_config
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    cfg = flagship_config()
    for sub in (cfg.vision_encoder_config, cfg.decoder_config):
        sub.transformer_config.rotator_config.gate_sizes = gates
        sub.n_layer = depth
    return VisionEncoderDecoder(cfg, device=device).init_weights(SEED).to(
        dtype).eval()


@contextlib.contextmanager
def moe_routes(record=None, replay=None, flips=None):
    """Every MoE linear's top-k route while inside: appended to
    ``record`` (the mask and the gate values, on the host), or taken from
    ``replay`` in call order, ``flips`` getting (rows whose own route
    differs, the largest k-th to (k+1)-th gate gap among them)."""
    from image2text_torch.models import layers

    own_topk = layers.topk_mask
    it = iter(replay) if replay is not None else None

    def topk_mask(gv, k):
        mask = own_topk(gv, k)
        if record is not None:
            record.append((mask.cpu(), gv.float().cpu()))
        if it is None:
            return mask
        forced, _ = next(it)
        differ = (forced != mask.cpu()).any(-1)
        top = gv.float().cpu().topk(k + 1, dim=-1).values
        gap = (top[..., k - 1] - top[..., k])[differ]
        flips.append((int(differ.sum()), float(gap.max()) if gap.numel()
                      else 0.0))
        return forced.to(mask.device)

    layers.topk_mask = topk_mask
    try:
        yield
    finally:
        layers.topk_mask = own_topk


def moe_gates_against_cpu(torch, m, label: str) -> None:
    """``m`` (f32) on the card against a CPU copy, the CPU on the card's
    expert routes (as the kernel checks run the plain version on the
    kernel's routes): a deep gate's softmax values lie within ~1e-5 of
    each other at random init, so f32 rounding order picks another
    expert at near ties.  Held: the encoder output and first-step logits
    within NANO_CPU_TOL (relative L2), greedy ids over MAX_NEW_TOKENS
    equal; the rows whose own route differs are reported with their
    largest near-tie gap (limit 1e-5)."""
    from image2text_torch.models.generation import generate, prefill

    cpu = cpu_copy(m)
    frames, prompt = serving_inputs(torch, m, HF_CPU_BATCH, SEED + 63,
                                    FLAGSHIP_BOS)
    from image2text_torch.models.generation import preprocess_frames

    images = preprocess_frames(m, frames, m.decoder.dtype)
    routes, flips = [], []
    outs = []
    for model, imgs, p, kw in ((m, images, prompt, dict(record=routes)),
                               (cpu, images.cpu(), prompt.cpu(),
                                dict(replay=routes, flips=flips))):
        with moe_routes(**kw):
            enc = model.encoder(imgs)
            logits = prefill(model, enc, p, 1 + MAX_NEW_TOKENS)[0][:, -1]
            ids = generate(model, imgs, p, max_new_tokens=MAX_NEW_TOKENS,
                           temperature=0.0, encoder_output=enc,
                           graphs=False)   # the routes are read on the host
        outs.append((enc.float().cpu(), logits.float().cpu(), ids.cpu()))
    (enc, lg, ids), (cenc, clg, cids) = outs
    enc_err, err = rel_l2(torch, enc, cenc), rel_l2(torch, lg, clg)
    rows = sum(n for n, _ in flips)
    gap = max((g for _, g in flips), default=0.0)
    log(f"  {label} (f32), card against CPU on the card's routes, "
        f"{HF_CPU_BATCH} images: encoder output relative L2 {enc_err:.6g}, "
        f"first-step logits {err:.6g} (limit {NANO_CPU_TOL}); greedy ids "
        f"over {MAX_NEW_TOKENS} steps equal {bool(torch.equal(ids, cids))}; "
        f"{len(flips)} MoE routings, rows whose CPU route differed {rows} "
        f"(largest gap {gap:.3g}, limit 1e-5)")
    if (enc_err > NANO_CPU_TOL or err > NANO_CPU_TOL
            or not torch.equal(ids, cids) or gap > 1e-5):
        raise AssertionError(f"[moe-gates] {label}: card and CPU differ")
    del cpu


def phase_moe_gates(torch, results):
    """[moe-gates]: the flagship's blocks with gates of no hidden layer and
    of two (32, 16), at full width and depth in bf16: a caption call
    (PROBE_BATCH images) launches no sparse_block, fused_block or moe_ffn
    (the gates decline them, as JAX's) and its ids are in range; the
    depth-2 forms in f32 card against a CPU copy (logits within
    NANO_CPU_TOL, ids equal); the one-hidden-layer gate of
    the flagship at depth 2 still launches both kernels."""
    from image2text_torch.configs.models import FLAGSHIP
    from image2text_torch.models.generation import caption

    n_layers = FLAGSHIP.decoder_config.n_layer
    for gates in MOE_GATES + ((32,),):
        depth = n_layers if gates != (32,) else 2
        m = moe_gates_model(torch, gates, depth, torch.bfloat16)
        frames, prompt = serving_inputs(torch, m, PROBE_BATCH, SEED + 62,
                                        FLAGSHIP_BOS)
        counts, ids = launch_counts(lambda: caption(
            m, frames, prompt, max_new_tokens=MAX_NEW_TOKENS,
            temperature=0.0, top_k=None))
        vocab = vocab_rows(m)
        ok_ids = bool(((ids >= 0) & (ids < vocab)).all())
        log(f"  gates {gates} ({depth} + {depth} layers, bf16): caption "
            f"launches {counts}; ids in range {ok_ids}")
        kernels = counts["sparse_block"] + counts["moe_ffn"] + counts[
            "fused_block"]
        if not ok_ids or (kernels != 0) != (gates == (32,)):
            raise AssertionError(f"[moe-gates] gates {gates}: {counts}")
        if gates != (32,):
            record_launches(results, f"moe_gates_{len(gates or ())}_caption",
                            counts)
        del m
        torch.cuda.empty_cache()
        if gates == (32,):
            continue
        m = moe_gates_model(torch, gates, 2, torch.float32)
        moe_gates_against_cpu(torch, m, f"gates {gates} depth 2")
        del m
        torch.cuda.empty_cache()


def start_dryrun():
    """``graft_entry.dryrun_multichip(4)`` on a thread (its 4 gloo ranks
    are CPU processes, so it runs beside the kernels' build); returns
    the thread and the dict its result, error and seconds go into."""
    from image2text_torch.graft_entry import dryrun_multichip

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["out"] = dryrun_multichip(4)
        except BaseException as e:   # re-raised by phase_dryrun
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="dryrun", daemon=True)
    thread.start()
    return thread, box


def phase_dryrun(torch, dryrun):
    """``graft_entry.entry()`` on the card, then the result of
    ``graft_entry.dryrun_multichip(4)`` (``start_dryrun``): 4 gloo ranks
    on the CPU, the tiny dp2 × tp2 phase and the flagship widths at depth
    2 with ZeRO-1 and SP (train, val, generate, checkpoint); a CPU
    phase."""
    from image2text_torch.graft_entry import entry

    forward, example = entry()
    logits = forward(*example)
    log(f"  graft_entry.entry(): the flagship forward on the card, logits "
        f"{tuple(logits.shape)} {logits.dtype}, finite "
        f"{bool(torch.isfinite(logits).all())}")
    if not torch.isfinite(logits).all():
        raise AssertionError("[dryrun] entry() logits not finite")
    del forward, example, logits
    torch.cuda.empty_cache()
    thread, box = dryrun
    thread.join()
    if "error" in box:
        raise box["error"]
    out = box["out"]
    log(f"  dryrun_multichip(4) on CPU gloo ranks: {out[0]} in "
        f"{box['s']:.1f} s (beside the build)")
    if not out[0] or not all(math.isfinite(v) for v in out[0].values()):
        raise AssertionError(f"[dryrun] {out}")



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel (torch.profiler)")
    args = ap.parse_args()

    if not (REPO / "image2text_torch" / "csrc").is_dir():
        print("chip_smoke: image2text_torch not found beside this script",
              file=sys.stderr)
        return 2
    # Where Python runs with PYTHONDONTWRITEBYTECODE beside site-packages
    # holding no bytecode, every process (each rank, each CLI run)
    # compiles torch's sources again, seconds each: the bytecode goes
    # under build/, written by this process and read by its children.
    prefix = str(REPO / "build" / "pycache")
    sys.pycache_prefix, sys.dont_write_bytecode = prefix, False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from image2text_torch.configs.models import FLAGSHIP, FLAGSHIP_DENSE
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.ops import _build

    global CARD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    CARD = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from image2text_torch.probes.block_ablate import build_units

    dryrun = start_dryrun()
    t0 = time.perf_counter()
    logs = _build.build_all(build_units())
    log(f"[build] {len(logs)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s (every source, and "
        f"fused_block.cu and fused_moe.cu once per probe variant; the "
        f"[dryrun] ranks beside it)")
    for text in logs:
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  " + line.strip())
    log(f"[tf32-sass] the 3xTF32 kernels' products on the tensor cores "
        f"(cuobjdump -sass; {CARD})")
    phase_tf32_sass()

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
        ids, _ = phase_beam(torch, model, args, results)
        log("[kernels] topk_ban_mask at the beam's decode rows, bans from "
            "its id buffer")
        phase_topk_kernel(torch, results,
                          ids.transpose(0, 1).reshape(-1, ids.shape[-1]),
                          ngrams, vocab, tag="beam")
        log("[beam-parity] greedy beam search, kernel path vs plain-version "
            "path at full width")
        phase_beam_parity(torch, model)
        w8 = w8a8_model(model)
        log("[serve-modes] bench.py's serving modes on the flagship at full "
            "width and depth: exact, int8 cross-KV, W8A8 + int8 cross-KV, "
            "approx top-k, all")
        phase_serve_modes(torch, model, w8, args, results)
        log(f"[graph] the flagship's caption call as one captured CUDA "
            f"graph against the eager route, then the five serving modes "
            f"({CARD})")
        phase_graph(torch, model, args, "flagship", FLAGSHIP_BOS, w8)
        phase_encoder_w8a8(torch, w8, results)
        log("  the W8A8 product at the flagship's shapes, card against CPU")
        phase_int8_products(torch, w8)
        phase_int8_kv_read(torch, model)
        log("[beam-int8] beam search with int8 cross-KV and with W8A8 + "
            "int8 cross-KV at full width")
        phase_beam_modes(torch, model, w8, args, results)
        del w8
        log("[reforward] the full-reforward fallback on the flagship at full "
            "width (force_no_cache)")
        phase_reforward_flagship(torch, model, results)
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
        log(f"[graph] the dense twin's caption call, graph against eager "
            f"({CARD})")
        phase_graph(torch, model, args, "dense", FLAGSHIP_BOS)
        log("[dense-parity] kernel path vs plain-version path at full width")
        phase_parity(torch, model, "dense-parity", FLAGSHIP_BOS)
    del model
    torch.cuda.empty_cache()
    with torch.no_grad():
        log(f"[chain-rows] fused_block past the resident attention's 432 "
            f"rows and at head dim 256, vs plain version ({CARD})")
        phase_chain_rows(torch, results)
        log("[f32-chain] an f32 sparse encoder block: the composed route, "
            "card vs CPU")
        phase_f32_chain(torch)
        log(f"[moe-gates] the flagship's blocks with MoE gates of other "
            f"depths: no chain or MoE kernel, card against CPU ({CARD})")
        phase_moe_gates(torch, results)
        log("  flash-attention kernels at head dims the kernels pad (80, "
            "192) or take (256) vs plain versions")
        phase_flash_kernels(torch, args, results, FLASH_HEAD_DIMS)
        log("[flash-planes] the flash kernels on one rank's slice of a "
            "dp2 x tp2 call: bit for bit the whole call's slice")
        phase_flash_planes(torch, results)
    log(f"[dist] the mesh over NCCL: the flagship step through the mesh "
        f"Trainer against the one-device step ({CARD})")
    phase_dist(torch, results)
    if torch.cuda.device_count() < 2:
        log(f"[dist-tp] the mesh's ranks on one card: dp1 x tp2 with SP "
            f"over gloo against one device ({CARD})")
        phase_dist_tp(torch)
    log(f"[dist-tp-int4] llama2-13b.yaml's int4 + LoRA decoder split over "
        f"tp2: 2 gloo ranks sharing the card against one device, "
        f"{INT4_TP_DEPTH} layers at full width ({CARD})")
    phase_dist_tp_int4(torch, results)
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
        log("[gpt2m-int8] GPT-2-medium with int8 cross-KV and W8A8 float "
            "weights (the tied table and its lm_head, wpe, the cross "
            "q_attn and c_proj; the int4 Linears stay int4)")
        phase_serve_modes(torch, model, w8a8_model(model), args, results,
                          modes=GPT2M_MODES, bos=GPT2M_EOS, tag="gpt2m")
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

    with torch.no_grad():
        phase_nano(torch, args, results)
        for phase, (name, part, targets, _) in LORA_PHASES.items():
            log(f"[{phase}] {FAMILY_YAML[name]} with LoRA on its {part} "
                f"({targets}, set in code) at full width and depth ({CARD})")
            phase_lora(torch, args, results, phase)
        phase_nano_f32(torch)
        log(f"[hf-kernels] int4_matmul vs plain version at the Llama-2-13B, "
            f"Falcon-7B and GPT-2-xl decoders' shapes (decode and prefill "
            f"rows); moe_ffn's f32 form at nano-mini's decode shape ({CARD})")
        phase_hf_kernels(torch, results)
        phase_hf(torch, args, results)
    log(f"[train-parity] each family's depth-{FAMILY_PARITY_DEPTH} form at "
        f"full width, one "
        f"training step on the card against a CPU copy ({CARD})")
    phase_train_cpu(torch)
    log(f"[remat] {FAMILY_YAML[REMAT_FAMILY]} at depth {REMAT_DEPTH}, "
        f"gradients and cost under each remat policy ({CARD})")
    phase_remat(torch)
    log(f"[train-kernels] the flash kernels and int4_matmul at the shapes "
        f"the families' training steps ran, vs their plain versions "
        f"({CARD})")
    with torch.no_grad():
        phase_train_kernels(torch, results)

    log("[offline-kernels] the f32 kernels of the offline path (flash at "
        "synthetic-smoke.yaml's training shapes, the front at the evaluate "
        "batch) vs their plain versions")
    with torch.no_grad():
        phase_offline_kernels(torch, results)
    work = Path(tempfile.mkdtemp(prefix="offline-", dir=REPO / "build"))
    try:
        log("[offline-train] the trainer twin on synthetic-smoke.yaml "
            "(ci.sh step 3's run) at the config's full size")
        smoke_ck = phase_offline_train(torch, args, results, work)
        log("[offline-eval] the evaluate twin, greedy, card vs CPU: the "
            "smoke checkpoint and artifacts/quality2_ck.npz")
        phase_offline_eval(torch, results, smoke_ck)
        log(f"[local-data] the trainer twin's CLI on a local image "
            f"directory ({CARD})")
        phase_local_data(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("[offline-beam] greedy beam ids on quality2_ck.npz, card vs CPU, "
        "every round")
    phase_offline_beam(torch)
    log("[offline-modes] the evaluate twin with --int8_serving and "
        "--approx_topk on quality2_ck.npz, card vs CPU, and against exact")
    phase_offline_modes(torch, results)
    log("[reforward] the fallback on quality2_ck.npz: card vs its cached "
        "path and vs the CPU")
    phase_reforward_quality2(torch, results)

    log("[dryrun] dryrun_multichip(4): the mesh's multi-rank path on 4 CPU "
        "gloo ranks (a CPU phase, run beside [build])")
    phase_dryrun(torch, dryrun)

    log("[device-times] kernel device times (torch.profiler), taken after "
        "every CUDA-event time of the run")
    run_device_times()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("gemm_ms", "attention_ms", "attention_library_ms", "regimes",
             "variants_ms", "library_bwd_ms", "library_fwd_bwd_ms", "pairs",
             "groups", "plan_route", "registers", "spill_bytes", "device_ms",
             "device_kernels", "chunk", "resident_clusters", "other_route",
             "other_route_ms", "other_route_device_ms",
             "other_route_device_kernels", "sensitivity",
             "launches_by_path", "f32_rows")
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
