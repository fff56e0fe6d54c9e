"""Per-image versus group-wide launches of the encoder-block chain on the
card: what do small, per-image matrix products cost?

Counterpart of ``tools/block_wide_probe.py`` (the TPU probe,
``_wide_kernel``), on the same stream and block as
:mod:`image2text_torch.probes.block_ablate`.  The shipping chain
(:func:`image2text_torch.ops.fused_block.run_chain`) is launched

* ``wide{4,8,16}``  once per group of 4, 8 or 16 images;
* ``full{4,8}``     once per image, the images taken in groups of 4 or 8
  (every stage's products at one image's 160 rows);

and each is compared with the whole batch in one launch.  A row's result
does not depend on how rows are grouped into launches, so every variant
equals the whole-batch output bit for bit, except where a launch's row
count splits the MoE FFN's hidden sum otherwise than the whole batch's
(``ops/fused_moe.py::moe_slices``: the few-rows regime, or another slice
count): the f32 summation order then changes, and that variant is held
to ``utils/kernel_check.py``'s limits instead.

    python -m image2text_torch.probes.block_wide [batch]   # on the card
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

import torch

# name: (launch per "group" or per "image", group size)
VARIANTS: Dict[str, Tuple[str, int]] = {
    "full4": ("image", 4), "full8": ("image", 8),
    "wide4": ("group", 4), "wide8": ("group", 8), "wide16": ("group", 16),
}


def grouped(run, x: torch.Tensor, w, variant: str) -> torch.Tensor:
    """``run(x_part, w)`` over ``x`` (b, t, d) cut as ``variant`` says,
    the outputs concatenated in image order."""
    kind, g = VARIANTS[variant]
    outs = []
    for i in range(0, x.shape[0], g):
        part = x[i:i + g]
        if kind == "group":
            outs.append(run(part, w))
        else:
            outs.extend(run(part[j:j + 1], w) for j in range(part.shape[0]))
    return torch.cat(outs)


def launch_rows(x: torch.Tensor, variant: str) -> int:
    """Rows of the MoE FFN in one launch of ``variant`` (the last group
    may be shorter)."""
    kind, g = VARIANTS[variant]
    return x.shape[1] * (1 if kind == "image" else min(g, x.shape[0]))


def main(batch: int = 64) -> dict:
    """Every variant against the whole batch, then timed (CUDA events,
    median of 10)."""
    from image2text_torch.ops.fused_block import run_chain
    from image2text_torch.ops.fused_moe import moe_slices
    from image2text_torch.probes import time_ms
    from image2text_torch.probes.block_ablate import probe_block
    from image2text_torch.utils.device import sm_count
    from image2text_torch.utils import kernel_check

    x, w = probe_block(batch, "cuda")
    hidden = w.fc.l2w.shape[1]
    n_sms = sm_count(x.device)
    whole = moe_slices(x.shape[0] * x.shape[1], hidden, n_sms)
    out = {"batch": batch, "t_sel": x.shape[1],
           "device": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        ref = run_chain(x, w)
        out["whole_ms"] = time_ms(lambda: run_chain(x, w))
        for name in VARIANTS:
            y = grouped(run_chain, x, w, name)
            exact = moe_slices(launch_rows(x, name), hidden, n_sms) == whole
            if exact and not torch.equal(y, ref):
                raise AssertionError(f"block_wide {name}: differs from the "
                                     "whole batch in one launch")
            st = kernel_check.check_output(f"block_wide {name}", y, ref)
            out[f"{name}_max_abs_err"] = st["max_abs_err"]
            out[f"{name}_held"] = "bit for bit" if exact else "kernel_check"
            out[f"{name}_ms"] = time_ms(lambda n=name: grouped(
                run_chain, x, w, n))
    return out


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:]))))
