"""Times of the tiled flash route against build variants of its source,
on the card: the alternatives behind its shipped choices.

    python -m image2text_torch.probes.flash_variants

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
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
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


def _resources(log: str) -> dict:
    """{kernel<d>: (registers, spill store bytes)} of the tiled kernels in
    an ``-Xptxas -v`` log."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(flash_\w+?_tiled_kernel)ILi(\d+)E", line)
        if "entry function" in line:
            entry = f"{m.group(1)}<{m.group(2)}>" if m else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
    return out


def build(name: str, edits) -> tuple:
    """(library, resources) of one variant, built under build/."""
    from image2text_torch.ops import _build

    out = _build.BUILD_DIR.parent / "flash_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, out)
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise KeyError(f"{name}: {old!r} not in the source")
        text = text.replace(old, new)
    (out / "flash_attention.cu").write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out / "lib.so"), str(out / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(out / "lib.so")), _resources(proc.stdout + proc.stderr)


def main() -> int:
    import statistics

    import torch

    sys.path.insert(0, ".")
    import chip_smoke as cs
    from image2text_torch.ops import _build
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.probes import device_kernel_ms, time_ms
    from image2text_torch.probes.kernel_times import FLASH_FAMILIES

    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA GPU")
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}

    def use(name):
        _build._loaded[("flash_attention", ())] = libs[name][0]
        _build._entry_points.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for label, b, h, hk, sq, s, d, causal, _, rate in FLASH_FAMILIES + cs.FLASH_LONG:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
                         for shape in ((b, h, sq, d), (b, hk, s, d), (b, hk, s, d),
                                       (b, h, sq, d)))
        a = (q, k, v, None, causal)
        out, lse = fa.flash_fwd(*a, rate, 77)
        g = (dout, lse, (dout.float() * out.float()).sum(-1), rate, 77)
        cases.append((label, lambda a=a, r=rate: fa.flash_fwd(*a, r, 77),
                      lambda a=a, g=g: fa.flash_bwd(*a, *g)))
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
                "bwd_device_ms": sum(device_kernel_ms(bwd).values())}
        print(json.dumps(res), flush=True)
    _build._loaded.pop(("flash_attention", ()), None)
    _build._entry_points.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
