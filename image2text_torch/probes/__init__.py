"""Measurement probes on the card: of the encoder-block chain
(counterparts of the TPU probes under ``tools/``: ``block_ablate`` and
``block_wide``), of two checkouts' kernel times in turns
(``kernel_times``), and of the tiled flash route over its launch groups
(``flash_groups``) and against build variants of its source
(``flash_variants``)."""
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


PAD = 1000   # torch.cuda._sleep launches that open a profiler session


def device_kernels(fn, iters: int = 20) -> dict:
    """``{kernel name: (ms, launches)}`` of one ``fn()``: the device time
    and the number of launches that torch.profiler records of each kernel
    over ``iters`` calls after warm-up, divided by ``iters``.  Free of the
    host's launch overhead, which :func:`time_ms` includes wherever it
    exceeds the kernels' time.  The session opens with :data:`PAD`
    launches of torch's ``spin_kernel``, left out of the result: a session
    on the H100's machine drops records at its start (every kernel of a
    short call, in some sessions), and the pad takes those places."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(1)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key}


def device_kernel_ms(fn, iters: int = 20) -> dict:
    """Device time of one ``fn()`` in ms by kernel name
    (:func:`device_kernels`)."""
    return {k: ms for k, (ms, _) in device_kernels(fn, iters).items()}


def flash_f64_truth(fa, q, k, v, bias, causal, rate, seed, dout):
    """(out, lse, dq, dk, dv) of the flash function in float64 on the
    same f32 inputs and keep mask (a row that sees no key: the uniform
    average forward, p = 1 backward), for the flash module ``fa`` of any
    checkout: the truth the f32 kernels' errors are measured against."""
    import torch

    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    qd, kd, vd, gd = (t.double() for t in (q, k, v, dout))
    s = qd @ kd.transpose(-1, -2) / d ** 0.5
    if bias is not None:
        s = s + bias.double().clamp_min(fa.NEG_BIG)
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        col = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, fa.NEG_BIG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    keep = (fa._keep(b, h, sq, skv, seed, rate, q.device).double()
            / (1.0 - rate) if rate > 0 else torch.ones_like(p))
    out = (p * keep) @ vd / l
    # the backward's p = exp(s - lse): 1 at every key of a row that sees
    # none (its lse rounds to NEG_BIG in f32), as the kernels specify
    pn = torch.where(m <= fa.NEG_BIG / 2, torch.ones_like(p), p / l)
    dvec = (gd * out).sum(-1, keepdim=True)
    ds = pn * (keep * (gd @ vd.transpose(-1, -2)) - dvec)
    dq = ds @ kd / d ** 0.5
    dk = ds.transpose(-1, -2) @ qd / d ** 0.5
    dv = (pn * keep).transpose(-1, -2) @ gd
    if hk == 1 and h > 1:
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    return out, (m + torch.log(l))[..., 0], dq, dk, dv


def moe_f64_truth(fm, x, fc, proj, routes, **extra):
    """The MoE FFN in float64 on the same f32 inputs and the expert routes
    ``routes`` (a kernel's own), for the MoE module ``fm`` of any checkout:
    its plain version on float64 operands (the gate's softmax stays in f32,
    as the function specifies): the truth the f32 forms' errors are
    measured against.  ``extra``: ln_w, ln_b, residual."""
    def f64(w):
        return w._replace(**{f: getattr(w, f).double()
                             for f in w._fields[:6]})

    extra = {k: None if v is None else v.double() for k, v in extra.items()}
    return fm.moe_ffn_plain(x.double(), f64(fc), f64(proj),
                            force_routes=routes, **extra)


def front_f64_truth(ff, x, w):
    """The encoder front in float64 on the same f32 inputs (the plain
    version of the front module ``ff`` of any checkout on float64
    operands)."""
    return ff.fused_frontend_plain(x.double(), type(w)(
        *[None if t is None else t.double() for t in w]))


def truth_error(x, truth) -> list:
    """[max |x − truth| / max |truth|, relative L2] of ``x`` against a
    float64 ``truth``."""
    diff = (x.double() - truth).flatten()
    return [float(diff.abs().max() / truth.abs().max()),
            float(diff.norm() / truth.norm())]
