"""Times of the serving kernels of one checkout, for comparing two trees
in one process each, on one card, in turns.

    python -m image2text_torch.probes.kernel_times TREE [TREE ...]

For each TREE (the root of a checkout: this repository, or an unpacked
``git archive`` of another commit) a fresh process imports that tree's
``chip_smoke.py`` and runs its serving-kernel phases at the flagship's
shapes (``phase_kernels``: fused_frontend, sparse_block, moe_ffn at
decode and encoder rows) and the dense twin's (``phase_dense_kernel``:
fused_block), each kernel checked against its plain version as
``chip_smoke.py`` checks it.  Prints one JSON line per tree, in the order
given (name the trees alternately, e.g. A B B A A B, and take medians).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_CHILD = r'''
import json, sys, types
tree = sys.argv[1]
sys.path.insert(0, tree)
import torch
import chip_smoke as cs
from image2text_torch.configs.models import FLAGSHIP, FLAGSHIP_DENSE
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
torch.backends.cuda.matmul.allow_tf32 = False
res, args = {}, types.SimpleNamespace(profile=False)
with torch.no_grad():
    for cfg, phase in ((FLAGSHIP, cs.phase_kernels),
                       (FLAGSHIP_DENSE, cs.phase_dense_kernel)):
        model = VisionEncoderDecoder(cfg, device="cuda").init_weights(
            cs.SEED).to(torch.bfloat16).eval()
        phase(torch, model, args, res)
        del model
        torch.cuda.empty_cache()
out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
for name, r in res.items():
    for key in ("ms", "library_ms", "gemm_ms", "attention_ms",
                "attention_library_ms"):
        if key in r:
            out[f"{name}.{key}"] = r[key]
    if "encoder_shape" in r:
        out[f"{name}.encoder.ms"] = r["encoder_shape"]["ms"]
print("KERNEL_TIMES " + json.dumps(out), flush=True)
'''


def main(trees) -> int:
    for tree in trees:
        root = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, "-c", _CHILD, root],
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
