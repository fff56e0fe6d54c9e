"""Times of the tiled flash route against build variants of its source,
on the card: the alternatives behind its shipped choices.

    python -m image2text_torch.probes.flash_variants [--f32 | --front-f32]

Each variant is ``csrc/flash_attention.cu`` with a few text edits
(``VARIANTS``), built by ``nvcc`` with the shipping flags into its own
directory under ``build/`` and swapped in under the wrappers
(``ops/_build.py``'s loaded library), so the same ``flash_fwd`` and
``flash_bwd`` calls time it.  At the families' largest bf16 training
calls (``kernel_times.FLASH_FAMILIES``) and the long-key call
(``chip_smoke.FLASH_LONG``) it prints, per variant, the forward's and the
backward's median CUDA-event ms over two passes (variants in order, then
reversed) and their device ms (``probes.device_kernel_ms``, after every
event time), with each build's registers and spill bytes a tiled kernel.

``--f32``: the same for ``csrc/flash_attention_f32.cu`` (``F32_VARIANTS``:
the shipped choices' alternatives and ablations that show where the time
goes; an ablation computes another function and only its time counts) at
the f32 calls (``kernel_times.FLASH_F32_FAMILIES``, f32 tensors, the
soft-prompt bias where given), with each variant's errors against a
float64 truth (``probes.flash_f64_truth``; ``err``: max error over max
|truth|, relative L2, of out, lse, dq, dk and dv).

``--front-f32``: the f32 front's cluster route (``csrc/fused_frontend.cu``)
built at other cluster sizes (``FRONT_F32_VARIANTS``: the most blocks an
image, F32_CLUSTER, and the least rows a block that fits them) at the
offline configs' front (t 256, din 128, d 64, 8 CLS rows) at the
evaluate CLI's and the offline trainer's eval batch (b 4, 8), on random
weights: per variant its plan, the median CUDA-event ms over two passes
(variants in order, then reversed), device ms and launches a call
(``probes.device_kernels``) and the largest difference from the plain
version.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

# variant: (edits of the shipped source as (old, new) pairs)
VARIANTS = {
    "shipped": (),
    # three stages leave room for three d-64 forward blocks an SM, not four
    "three_stages": (("constexpr int TILE_STAGES = 2;", "constexpr int TILE_STAGES = 3;"),
                     ("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;"),
                     ("return d > 128 ? 1 : d > 64 ? 3 : 4; }", "return d > 128 ? 1 : 3; }")),
    "keys64_at_d128": (("return d > 64 ? TILE_KEYS / 2 : TILE_KEYS; }",
                        "return d > 128 ? TILE_KEYS / 2 : TILE_KEYS; }"),
                       ("return d > 128 ? 1 : d > 64 ? 3 : 4; }",
                        "return d > 64 ? 1 : 4; }")),
    "three_blocks_at_d64": (("return d > 128 ? 1 : d > 64 ? 3 : 4; }",
                             "return d > 128 ? 1 : 3; }"),),
    "expf": (("__expf(", "expf("),),
}

# The f32 kernels' variants.  Alternatives: every product straight into
# its running sum (no zeroed accumulator a k-step, mma3's FRESH), the
# forward's O fresh at head dim 128 too, the d-128 dK/dV block without its
# split (64 keys, a warp all 128 dims: its fresh accumulators spill), half
# the keys a forward stage past d 64 (three blocks an SM at d 128),
# ``__expf``, the small half rounded by cvt.rna.tf32, the dQ kernel's
# full-size stages (one block an SM at d 128).  Ablation (another
# function, timed only): one TF32 product instead of three.
F32_VARIANTS = {
    "shipped": (),
    "all_running": (
        ("fresh_products(int d) { return d <= 128; }", "fresh_products(int d) { return false; }"),
        ("fresh_o(int d) { return d <= 64; }", "fresh_o(int d) { return false; }"),
        ("fresh_grads(int d) { return d <= 128; }", "fresh_grads(int d) { return false; }")),
    "fresh_o_at_128": (("fresh_o(int d) { return d <= 64; }",
                        "fresh_o(int d) { return d <= 128; }"),),
    "no_split_at_128": (("return d > 64 ? 2 : 1; }", "return d > 128 ? 2 : 1; }"),),
    "fwd_half_stages": (("constexpr int LD = D + 4, KT = stage_keys(D), NST = F32_STAGES;",
                         "constexpr int LD = D + 4, KT = dq_keys(D), NST = F32_STAGES;"),
                        ("return d > 128 ? 1 : 2; }", "return d > 128 ? 1 : 3; }")),
    "fast_exp": (("expf(", "__expf("),),
    "one_tf32": (("    mma_tf32(t, as, bb[0], bb[1]);\n    mma_tf32(t, ab, bs[0], bs[1]);\n", ""),
                 ("    mma_tf32(c, as, bb[0], bb[1]);\n    mma_tf32(c, ab, bs[0], bs[1]);\n", "")),
    "small_cvt_rna": (("  small = __float_as_uint(x - __uint_as_float(big));",
                       "  small = to_tf32(x - __uint_as_float(big));"),),
    "dq_full_stages": (("return d > 64 ? stage_keys(d) / 2 : stage_keys(d);",
                        "return stage_keys(d);"),),
}


# The f32 front's cluster sizes: (F32_CLUSTER, edits).  Past 8 blocks a
# cluster needs the non-portable cluster attribute.
_NON_PORTABLE = (
    "        front32_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n",
    "        front32_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n"
    "    if (err == cudaSuccess) err = cudaFuncSetAttribute(\n"
    "        front32_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")
FRONT_F32_VARIANTS = {
    "shipped": (8, ()),
    "cluster4": (4, (("constexpr int F32_CLUSTER = 8;", "constexpr int F32_CLUSTER = 4;"),)),
    "cluster16": (16, (("constexpr int F32_CLUSTER = 8;", "constexpr int F32_CLUSTER = 16;"),
                       _NON_PORTABLE)),
}


def _resources(log: str) -> dict:
    """{kernel<d>: (registers, spill store bytes)} of the tiled kernels in
    an ``-Xptxas -v`` log."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(flash_\w+?_(?:tiled|f32)_kernel)ILi(\d+)E",
                      line)
        if "entry function" in line:
            entry = f"{m.group(1)}<{m.group(2)}>" if m else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
    return out


def build(name: str, edits, source: str = "flash_attention") -> tuple:
    """(library, resources) of one variant of ``csrc/<source>.cu``, built
    under build/."""
    from image2text_torch.ops import _build

    out = _build.BUILD_DIR.parent / "flash_variants" / source / name
    out.mkdir(parents=True, exist_ok=True)
    # the source first, then its headers (the 3xTF32 helpers live in
    # flash_common.cuh): each edit applies to the first file holding it
    files = [f"{source}.cu"] + sorted(f.name for f in _build.CSRC.glob("*.cuh"))
    texts = {f: (_build.CSRC / f).read_text() for f in files}
    for old, new in edits:
        where = next((f for f in files if old in texts[f]), None)
        if where is None:
            raise KeyError(f"{name}: {old!r} not in the source or its headers")
        texts[where] = texts[where].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out / "lib.so"), str(out / f"{source}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(out / "lib.so")), _resources(proc.stdout + proc.stderr)


def front_f32_main() -> int:
    """``--front-f32``: see the module docstring."""
    import statistics

    import torch

    from image2text_torch.ops import _build
    from image2text_torch.ops import fused_frontend as ff
    from image2text_torch.probes import device_kernels, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA GPU")
    source, t, din, d, n_cls = "fused_frontend", 256, 128, 64, 8
    libs = {name: build(name, edits, source)[0]
            for name, (_, edits) in FRONT_F32_VARIANTS.items()}

    def use(name):
        _build._loaded[(source, ())] = libs[name]
        _build._entry_points.clear()

    def plan(cluster):   # front_plan_f32's rule at another cluster size
        rows = next(r for r in (16, 32, 64) if r * cluster >= t)
        return ff.FrontPlanF32("cluster", -(-t // rows), rows)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    cases = []
    for b in (4, 8):
        w = ff.FrontendWeights(r(din, d, scale=din ** -0.5), r(d, scale=0.1),
                               1 + r(t, d, scale=0.1), r(t, d, scale=0.1),
                               r(t, d), r(n_cls, d))
        x = r(b, t, din)
        cases.append((f"b{b}", x, w, ff.fused_frontend_plain(x, w)))
    ms = {n: {} for n in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        p = plan(FRONT_F32_VARIANTS[name][0])
        for label, x, w, _ in cases:
            ms[name].setdefault(label, []).append(
                time_ms(lambda x=x, w=w: ff.launch_front_f32(x, w, p), 20))
    for name in libs:
        use(name)
        p = plan(FRONT_F32_VARIANTS[name][0])
        res = {"variant": name, "device": torch.cuda.get_device_name(0),
               "plan": list(p)}
        for label, x, w, want in cases:
            seen = device_kernels(lambda x=x, w=w: ff.launch_front_f32(x, w, p))
            res[label] = {
                "ms": statistics.median(ms[name][label]),
                "device_ms": sum(v for v, _ in seen.values()),
                "launches": sum(n for _, n in seen.values()),
                "max_diff_vs_plain": (ff.launch_front_f32(x, w, p) - want)
                .abs().max().item()}
        print(json.dumps(res), flush=True)
    _build._loaded.pop((source, ()), None)
    _build._entry_points.clear()
    return 0


def main(argv=()) -> int:
    import statistics

    import torch

    sys.path.insert(0, ".")
    import chip_smoke as cs
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch import probes
    from image2text_torch.probes import device_kernel_ms, time_ms
    from image2text_torch.probes.kernel_times import (FLASH_F32_FAMILIES,
                                                      FLASH_FAMILIES)

    if "--front-f32" in argv:
        return front_f32_main()
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA GPU")
    f32 = "--f32" in argv
    source, variants, calls, dt = (
        ("flash_attention_f32", F32_VARIANTS, FLASH_F32_FAMILIES, torch.float32)
        if f32 else ("flash_attention", VARIANTS, FLASH_FAMILIES + cs.FLASH_LONG,
                     torch.bfloat16))
    libs = {name: build(name, edits, source) for name, edits in variants.items()}

    def use(name):
        _build._loaded[(source, ())] = libs[name][0]
        _build._entry_points.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases, truths = [], {}
    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in calls:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen).to(dt)
                         for shape in ((b, h, sq, d), (b, hk, s, d), (b, hk, s, d),
                                       (b, h, sq, d)))
        bias = None if n_prefix is None else cs.soft_prompt_bias(torch, s, n_prefix, dev)
        a = (q, k, v, bias, causal)
        out, lse = fa.flash_fwd(*a, rate, 77)
        g = (dout, lse, (dout.float() * out.float()).sum(-1), rate, 77)
        cases.append((label, lambda a=a, r=rate: fa.flash_fwd(*a, r, 77),
                      lambda a=a, g=g: fa.flash_bwd(*a, *g)))
        if f32:   # the float64 truth of each variant's errors
            truths[label] = (a, rate, dout, probes.flash_f64_truth(
                fa, q, k, v, bias, causal, rate, 77, dout))
    ms = {n: {} for n in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        for label, fwd, bwd in cases:
            ms[name].setdefault(label, []).append((time_ms(fwd, 20), time_ms(bwd, 20)))
    for name in libs:
        use(name)
        res = {"variant": name, "device": torch.cuda.get_device_name(0),
               "resources": libs[name][1]}
        for label, fwd, bwd in cases:
            res[label] = {
                "fwd_ms": statistics.median(x[0] for x in ms[name][label]),
                "bwd_ms": statistics.median(x[1] for x in ms[name][label]),
                "fwd_device_ms": sum(device_kernel_ms(fwd).values()),
                "bwd_device_kernels": device_kernel_ms(bwd)}
            res[label]["bwd_device_ms"] = sum(res[label]["bwd_device_kernels"].values())
            if label in truths:   # errors against the float64 truth
                a, rate, dout, truth = truths[label]
                o, lse = fa.flash_fwd(*a, rate, 77)
                got = (o, lse) + tuple(fa.flash_bwd(
                    *a, dout, lse, (dout * o).sum(-1), rate, 77))
                res[label]["err"] = {n: probes.truth_error(x, t) for n, x, t in
                                     zip(("out", "lse", "dq", "dk", "dv"), got, truth)}
        print(json.dumps(res), flush=True)
    _build._loaded.pop((source, ()), None)
    _build._entry_points.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
