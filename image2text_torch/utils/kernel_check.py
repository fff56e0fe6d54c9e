"""Holding a kernel's output against its plain version, at the output's
own scale.

A fixed absolute tolerance says nothing about an output far smaller than
it: the decoder's MoE FFN at random init gives values near 4e-4, so a
kernel returning zeros would pass a 0.06 bound.  So besides that bound
(0.06 abs + 0.06 rel per element, the JAX bf16 kernel tests' own) the
limits scale with what they compare: the largest error against the
largest plain value, and the relative L2 error.

The MoE kernels report the experts each row took.  A kernel is compared
with its plain version forced onto those same routes, so every row is
compared; :func:`check_routes` then holds the routes themselves against
the top-k of the plain gate values: a route that differs must be a near
tie (rounding order), and such rows must be few.

An attention kernel that rounds its scores to bf16 (as the reference
``ops/attention.py::sdpa`` specifies) can part from the reference by more
than sums in another order explain element by element: a score near a
bf16 rounding boundary rounds the other way.  :func:`attention_sensitivity`
measures how far that rounding alone moves the result, so that a kernel's
error is judged against it.
"""
from __future__ import annotations

import math

import torch

from image2text_torch.ops.fused_moe import topk_mask, unpack_mask

ELEMENT_TOL = 0.06    # per element: |got - want| <= tol + tol * |want|
MAX_ABS_SHARE = 0.06  # largest error over the largest |plain| value
REL_L2 = 1e-2         # ||got - want|| / ||want||
# The f32 kernels (f32-accurate products: FFMA, or 3xTF32 on the tensor
# cores in the flash pair, the MoE FFN's and the front's f32 forms; their
# sums in another order than the plain version's, a few f32 ulps): the
# same three limits, each hundreds of times tighter.  (Measured on an H100 at the offline shapes: largest error 1e-7
# of the largest plain value, relative L2 1e-7; the 3xTF32 flash pair
# within 1e-6 of the largest float64-truth value at the f32 calls.)
F32_LIMITS = (1e-4, 1e-5, 1e-5)  # ELEMENT_TOL, MAX_ABS_SHARE, REL_L2
TIE = 1e-3            # gate gap a differing route may cross, over max gate
MAX_APART = 1e-3      # share of rows whose routes may differ (at least 1)


def output_error(got: torch.Tensor, want: torch.Tensor,
                 element_tol: float = ELEMENT_TOL) -> dict:
    g, w = got.float(), want.float()
    diff = g - w
    norm = float(torch.linalg.vector_norm(w))
    dnorm = float(torch.linalg.vector_norm(diff))
    return {"max_abs_err": float(diff.abs().max()),
            "max_plain": float(w.abs().max()),
            "rel_l2": dnorm / norm if norm > 0 else (0.0 if dnorm == 0
                                                     else float("inf")),
            "equal_share": float((diff == 0).float().mean()),
            "elements_beyond": int((diff.abs() > element_tol
                                    + element_tol * w.abs()).sum()),
            "finite": bool(torch.isfinite(g).all())}


def check_output(name: str, got: torch.Tensor, want: torch.Tensor,
                 limits=(ELEMENT_TOL, MAX_ABS_SHARE, REL_L2)) -> dict:
    """Raises AssertionError unless ``got`` is finite, every element is
    within ELEMENT_TOL, its largest error is within MAX_ABS_SHARE of the
    largest plain value and its relative L2 error within REL_L2 (or the
    three ``limits`` given: :data:`F32_LIMITS` for an f32 kernel).
    Returns the statistics."""
    element_tol, max_abs_share, rel_l2 = limits
    st = output_error(got, want, element_tol)
    if (not st["finite"] or st["elements_beyond"]
            or st["max_abs_err"] > max_abs_share * st["max_plain"]
            or st["rel_l2"] > rel_l2):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: {st} (limits: "
            f"no element beyond {element_tol} abs + {element_tol} rel, "
            f"max_abs_err <= {max_abs_share} * max_plain, rel_l2 <= "
            f"{rel_l2})")
    return st


def check_routes(name: str, routes: torch.Tensor, gates: torch.Tensor,
                 k: int) -> dict:
    """Hold a kernel's routes ((n, 2) uint8 expert bit masks per MoELinear)
    against the plain gate values ((n, 2, e) f32, computed on those
    routes).  Every row must take min(k, e) experts; a row whose experts
    are not the top-k of its gates must be a near tie (the gap it crosses
    within TIE of its largest gate value); at most max(1, MAX_APART · n)
    rows may differ.  Raises AssertionError; returns the statistics."""
    n, _, e = gates.shape
    took = unpack_mask(routes.reshape(n, 2), e)
    if not bool((took.sum(-1) == min(k, e)).all()):
        raise AssertionError(f"{name}: a row took other than {min(k, e)} "
                             "experts")
    apart = (took != topk_mask(gates, k)).any(-1)            # (n, 2)
    lowest_taken = torch.where(took, gates, torch.inf).amin(-1)
    highest_left = torch.where(took, -torch.inf, gates).amax(-1)
    gap = ((highest_left - lowest_taken).clamp_min(0)
           / gates.amax(-1)).amax().item() if e > k else 0.0
    n_apart = int(apart.any(-1).sum())
    st = {"rows_apart": n_apart, "rows": n, "max_tie_gap": gap}
    if gap > TIE or n_apart > max(1, MAX_APART * n):
        raise AssertionError(
            f"{name}: kernel routes disagree with the plain top-k: {st} "
            f"(limits: max_tie_gap <= {TIE}, rows_apart <= max(1, "
            f"{MAX_APART} * rows))")
    return st


def rounding_reference(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention (q (b, h, t, d), k/v (b, 1 or h, l, d)) in f64,
    rounded to q's dtype where the reference rounds: the scaled scores, the
    probabilities and the output."""
    dt = q.dtype
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(s.to(dt).double(), dim=-1).to(dt)
    return torch.matmul(p.double(), v.double()).to(dt)


def attention_sensitivity(got: torch.Tensor, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor) -> dict:
    """Worst element errors of an attention kernel's output ``got`` (b, h,
    t, d) on (q, k, v): against ``sdpa`` (``kernel_vs_sdpa``) and against
    :func:`rounding_reference` (``kernel_vs_f64``); and the sensitivity of
    the reference's own rounding: ``sdpa`` against the f64 formulation
    (``sdpa_vs_f64``), and ``sdpa`` with its sums in another order (head
    dims and keys reversed) against it (``reordered_vs_f64``).
    ``sensitivity`` is the larger of those two."""
    from image2text_torch.ops.attention import sdpa

    want = sdpa(q, k, v)
    ref = rounding_reference(q, k, v)
    reordered = sdpa(q.flip(-1), k.flip(-1).flip(-2), v.flip(-2))

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    st = {"kernel_vs_sdpa": err(got, want), "kernel_vs_f64": err(got, ref),
          "sdpa_vs_f64": err(want, ref),
          "reordered_vs_f64": err(reordered, ref)}
    st["sensitivity"] = max(st["sdpa_vs_f64"], st["reordered_vs_f64"])
    return st
