"""Measurement probes on the card: of the encoder-block chain
(counterparts of the TPU probes under ``tools/``: ``block_ablate`` and
``block_wide``), and of two checkouts' kernel times in turns
(``kernel_times``)."""
from __future__ import annotations

import statistics


def time_ms(fn, iters: int = 10) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch

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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` in ms: the kernels' durations that
    torch.profiler records over ``iters`` calls after warm-up, summed and
    divided by ``iters``.  Free of the host's launch overhead, which
    :func:`time_ms` includes wherever it exceeds the kernels' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / iters / 1e3
