"""Times of the tiled flash kernels over their launch groups, on the card.

    python -m image2text_torch.probes.flash_groups [LABEL...]

At each tiled training shape (``kernel_times.FLASH_FAMILIES``, the
families' largest bf16 calls, and ``chip_smoke.FLASH_LONG``; the LABELs
given, or all) the tiled forward over its blocks a plane G (the plan's
and others, from one block a tile down to a few blocks an SM), the tiled
backward over the dK/dV kernel's G with the dQ kernel's as planned and
over the dQ kernel's G with the dK/dV kernel's as planned, each the
median of CUDA-event times (``probes.time_ms``); beside them the plan's
device time by kernel (``probes.device_kernel_ms``) and SDPA's forward
and backward alone.  Prints one JSON line a shape, with the card's name.
"""
from __future__ import annotations

import json
import sys


def _candidates(plan: int, tiles: int, planes: int, n_sms: int):
    """The plan's G, one block a tile, and G for 1, 2, 4 and 8 blocks an
    SM over the planes, each within [1, tiles]."""
    gs = {plan, tiles}
    for waves in (1, 2, 4, 8):
        gs.add(max(1, min(tiles, -(-waves * n_sms // planes))))
    return sorted(gs)


def main(argv) -> int:
    import torch

    sys.path.insert(0, ".")
    import chip_smoke as cs
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.probes import device_kernel_ms, time_ms
    from image2text_torch.probes.kernel_times import FLASH_FAMILIES

    if not torch.cuda.is_available():
        raise SystemExit("flash_groups: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = fa.fwd_plan, fa.bwd_plan, fa.tiled_groups
    gen = torch.Generator(device=dev).manual_seed(5)
    done = []
    for label, b, h, hk, sq, s, d, causal, n_prefix, rate in (
            FLASH_FAMILIES + cs.FLASH_LONG):
        if argv and label not in argv:
            continue
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=gen
                                     ).to(torch.bfloat16)
                         for shape in ((b, h, sq, d), (b, hk, s, d),
                                       (b, hk, s, d), (b, h, sq, d)))
        bias = (None if n_prefix is None
                else cs.soft_prompt_bias(torch, s, n_prefix, dev))
        a = (q, k, v, bias, causal)
        seed = 77
        out, lse = fa.flash_fwd(*a, rate, seed)
        dvec = (dout.float() * out.float()).sum(-1)
        g = (dout, lse, dvec, rate, seed)
        kd = fa.kernel_head_dim(d)
        route, fwd_g = fa.fwd_plan(b, h, hk, sq, s, n_sms, kd)
        _, dkv_g = fa.bwd_plan(b, h, hk, sq, s, n_sms, kd)
        dq_g = fa.tiled_groups(h, hk, sq)
        nh = h if hk == 1 else 1
        row_tiles = -(-nh * sq // fa.TILED_ROWS)
        q_tiles = nh * -(-sq // fa.DKV_ROWS)
        key_tiles = b * hk * -(-s // fa.DKV_KEYS)
        res = {"label": label, "device": torch.cuda.get_device_name(0),
               "route": route, "plan": {"fwd": fwd_g, "dkv": dkv_g,
                                        "dq": dq_g}}
        try:
            res["fwd_ms"] = {}
            for gg in _candidates(fwd_g, row_tiles, b * hk, n_sms):
                fa.fwd_plan = lambda *_, gg=gg: ("tiled", gg)
                res["fwd_ms"][gg] = time_ms(lambda: fa.flash_fwd(
                    *a, rate, seed))
            fa.fwd_plan = plans[0]
            res["dkv_ms"] = {}
            for gg in _candidates(dkv_g, q_tiles, key_tiles, n_sms):
                fa.bwd_plan = lambda *_, gg=gg: ("tiled", gg)
                res["dkv_ms"][gg] = time_ms(lambda: fa.flash_bwd(*a, *g))
            fa.bwd_plan = plans[1]
            res["dq_ms"] = {}
            for gg in _candidates(dq_g, row_tiles, b * hk, n_sms):
                fa.tiled_groups = lambda *_, gg=gg: gg
                res["dq_ms"][gg] = time_ms(lambda: fa.flash_bwd(*a, *g))
        finally:
            fa.fwd_plan, fa.bwd_plan, fa.tiled_groups = plans
        mask = None
        if bias is not None or causal:
            from image2text_torch.ops.attention import causal_bias
            mask = ((0 if bias is None else bias) + (
                causal_bias(sq, s, dev) if causal else 0)).to(torch.bfloat16)
        lib = cs.sdpa_times(torch, q, k, v, dout, mask, rate)
        res["sdpa_fwd_ms"], res["sdpa_bwd_ms"] = lib["fwd"], lib["bwd"]
        done.append((res, lambda a=a, r=rate: fa.flash_fwd(*a, r, seed),
                     lambda a=a, g=g: fa.flash_bwd(*a, *g)))
    # device times by kernel after every CUDA-event time: the profiler
    # slows the process's later host calls
    for res, fwd, bwd in done:
        res["fwd_device"] = device_kernel_ms(fwd)
        res["bwd_device"] = device_kernel_ms(bwd)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
