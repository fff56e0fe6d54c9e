"""Times of the serving and flash kernels of one checkout, for comparing
two trees in one process each, on one card, in turns.

    python -m image2text_torch.probes.kernel_times [--flash-only | --int4-only] TREE...

For each TREE (the root of a checkout: this repository, or an unpacked
``git archive`` of another commit) a fresh process imports that tree's
``chip_smoke.py`` and runs its serving-kernel phases at the flagship's
shapes (``phase_kernels``: fused_frontend, sparse_block, moe_ffn at
decode and encoder rows) and the dense twin's (``phase_dense_kernel``:
fused_block), then its flash phase (``phase_flash_kernels``) at the
flagship's and GPT-2-medium's training shapes (``FLASH_FLAGSHIP``,
``FLASH_GPT2M``), each kernel checked against its plain version as
``chip_smoke.py`` checks it; ``--flash-only`` runs the flash phase alone,
``--int4-only`` the int4 dequant-matmul's phase alone
(``phase_int4_kernels``: the GPT-2-medium decoder's four quantized
Linears at 256 decode rows and 1,344 training rows, beside the bf16
``torch.matmul`` yardstick; ``int4_matmul.<decode|train>_<linear>.ms`` and
``.library_ms``).  Per flash shape it prints the forward's and the
backward's ms (dQ, dK and dV: one call, or a tree's dK/dV and dQ kernels
summed) and, timed in the same process by this module's own code, SDPA's
forward and its backward alone (``sdpa_fwd.<label>.ms``,
``sdpa_bwd.<label>.ms``).  A tree whose ``chip_smoke.py`` defers device
times (``run_device_times``) also gives ``flash_fwd.<label>.device_ms`` and
``int4_matmul.<...>.device_ms``, read after every CUDA-event time.  With the flash phase it
also holds each tree's backward at a case whose rows 0–71 see no key
(causal, sq 200 > skv 128, as the card test
``test_flash_kernels_give_keyless_rows_every_key``) against the plain
version on the same inputs: ``keyless.<dq|dk|dv>`` are
``utils/kernel_check.py::output_error``'s statistics.  Prints one JSON
line per tree, in the order given (name the trees alternately, e.g. A B B
A A B, and take medians).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_CHILD = r'''
import json, sys, types
tree, mode = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
import torch.nn.functional as F
import chip_smoke as cs
from image2text_torch.configs.models import FLAGSHIP, FLAGSHIP_DENSE
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
from image2text_torch.ops.attention import causal_bias
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


with torch.no_grad():
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
    for cases in (cs.FLASH_FLAGSHIP, cs.FLASH_GPT2M):
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


MODES = {"--flash-only": "flash", "--int4-only": "int4"}


def main(argv) -> int:
    mode = next((MODES[a] for a in argv if a in MODES), "all")
    for tree in [a for a in argv if a not in MODES]:
        root = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, mode],
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
