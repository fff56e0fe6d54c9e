"""Eval encoder front: the CUDA kernels of ``csrc/fused_frontend.cu`` and
their plain version.

Replaces ``image2text_tpu/ops/fused_frontend.py::_frontend_kernel`` (the
Pallas kernel behind ``fused_frontend_compatible``).  From the (b, t, din)
raw-reshaped patch stream it builds the (b, n_cls + t, d) block-loop
input: the projector (a product rounded to the storage dtype, then its
bias), LayerNormND over each image's whole (t, d) slab, the positional
table added in the storage dtype, LayerNormND again, and the CLS rows in
front.

The JAX package launches its kernel only under ``GRAFT_FUSED_FRONTEND=1``:
Mosaic took minutes to compile it, which its measured gain on the TPU could
not pay for.  nvcc builds this one in seconds, so every eval encoder
forward on the card launches it.  What bounds it on the H100: operations
(the projector GEMM); see ``csrc/fused_frontend.cu`` for the design.

Two routes, chosen by shape (:func:`front_plan`), both the projector GEMM
and then a slab kernel: the cluster route (one thread-block cluster an
image, persistent, the tables held on the chip) where an image's slab
splits into SLAB_CLUSTER chunks of CLUSTER_MIN_CHUNK to SLAB_MAX_CHUNK
elements (the flagship's front); the slab route (one block an image over
device memory) elsewhere.  A plan of the cluster route runs any slab of
at most SLAB_CLUSTER x SLAB_MAX_CHUNK elements, the slab route any.

f32 operands (the configs with ``precision: 'no'``; the JAX kernel is
generic in the dtype) take the f32 form (:func:`launch_front_f32`), two
routes chosen by shape (:func:`front_plan_f32`): the cluster route, one
launch, a thread-block cluster an image whose blocks each compute their
slab rows' projector product on the tensor cores as 3xTF32 and exchange
both LayerNorms' statistics through distributed shared memory (z never
in device memory), wherever a block's operands fit its shared memory (the
offline configs' front); else the slab route, a SIMT f32 projector
product and the slab route's kernel instantiated for f32.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from image2text_torch.nn.modules import layer_norm
from image2text_torch.ops import _build

# The cluster route's blocks an image (one cluster) and the fewest and
# most slab elements it gives a block, read from the source, their owner.
SLAB_CLUSTER, CLUSTER_MIN_CHUNK, SLAB_MAX_CHUNK = _build.kernel_constants(
    "fused_frontend", "SLAB_CLUSTER", "CLUSTER_MIN_CHUNK", "SLAB_MAX_CHUNK")
# The f32 cluster route's most blocks an image, most slab rows a block and
# shared memory a block may take.
F32_CLUSTER, F32_FRONT_ROWS, F32_FRONT_SMEM = _build.kernel_constants(
    "fused_frontend", "F32_CLUSTER", "F32_FRONT_ROWS", "F32_FRONT_SMEM")


class FrontendWeights(NamedTuple):
    """The front's operands: the projector transposed to (din, d) and its
    bias in the compute dtype, LayerNormND's (t, d) weight and bias as
    stored, the (t, d) positional table and the (n_cls, d) CLS rows in the
    compute dtype.  A missing bias is None."""

    w_p: torch.Tensor
    b_p: Optional[torch.Tensor]
    ln_w: torch.Tensor
    ln_b: Optional[torch.Tensor]
    wpe: torch.Tensor
    cls: torch.Tensor


def fused_frontend_plain(x: torch.Tensor, w: FrontendWeights) -> torch.Tensor:
    """Plain PyTorch version: the encoder's module chain
    ``ln_input(projector(x))``, ``+ wpe``, ``ln_input`` again, CLS in
    front."""
    z = torch.matmul(x, w.w_p)
    if w.b_p is not None:
        z = z + w.b_p
    y = layer_norm(z, w.ln_w, w.ln_b, n_dims=2) + w.wpe
    cls = w.cls.expand(x.shape[0], *w.cls.shape)
    return torch.cat([cls, layer_norm(y, w.ln_w, w.ln_b, n_dims=2)], dim=1)


class FrontPlan(NamedTuple):
    """How one call runs: ``route`` "cluster" (SLAB_CLUSTER blocks an image,
    ``chunk`` slab elements each) or "slab" (one block an image)."""

    route: str
    chunk: int


@functools.lru_cache(maxsize=64)
def front_plan(t: int, d: int) -> FrontPlan:
    """The route for images of t patches and width d: the (t, d) slab in
    SLAB_CLUSTER chunks of whole 16-byte vectors; the cluster route where a
    chunk has CLUSTER_MIN_CHUNK to SLAB_MAX_CHUNK elements (the flagship's
    front), else the slab route (GPT-2-medium's front among them: there
    the slab route measured faster)."""
    chunk = -(-t * d // (8 * SLAB_CLUSTER)) * 8
    fits = CLUSTER_MIN_CHUNK <= chunk <= SLAB_MAX_CHUNK
    return FrontPlan("cluster" if fits else "slab", chunk)


@functools.lru_cache(maxsize=None)
def resident_clusters(device_index: int, chunk: int, has_lnb: bool) -> int:
    """How many clusters of the cluster route the card holds at once
    (``cudaOccupancyMaxActiveClusters``): its persistent grid."""
    fn = _build.entry_point("fused_frontend", "frontend_clusters",
                            [ctypes.c_int, ctypes.c_int])
    with torch.cuda.device(device_index):
        n = fn(chunk, int(has_lnb))
    if n <= 0:
        raise RuntimeError(f"fused_frontend: no cluster of the cluster route "
                           f"fits the card (chunk {chunk}; "
                           f"cudaOccupancyMaxActiveClusters gave {n})")
    return n


# frontend_launch(x, wp, bp, lnw, lnb, wpe, cls, out, b, t, din, d, n_cls,
# chunk, n_clusters, stream): chunk 0 is the slab route
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch_front(x: torch.Tensor, w: FrontendWeights,
                 plan: FrontPlan) -> torch.Tensor:
    """Launch ``plan``'s route on checked CUDA operands (see
    :func:`fused_frontend`): a plan of the slab route runs any shape, one
    of the cluster route any chunk up to SLAB_MAX_CHUNK."""
    b, t, din = x.shape
    d, n_cls = w.w_p.shape[1], w.cls.shape[0]
    out = torch.empty(b, n_cls + t, d, dtype=x.dtype, device=x.device)
    cluster = plan.route == "cluster"
    n_clusters = (resident_clusters(x.device.index, plan.chunk,
                                    w.ln_b is not None) if cluster else 0)
    fn = _build.entry_point("fused_frontend", "frontend_launch", _ARGTYPES)
    err = fn(*[_build.ptr(a) for a in (x, w.w_p, w.b_p, w.ln_w, w.ln_b, w.wpe,
                                       w.cls, out)],
             b, t, din, d, n_cls, plan.chunk if cluster else 0, n_clusters,
             _build.stream(x.device))
    _build.check(err, f"fused_frontend ({plan.route} route)")
    fused_frontend.launches += 1
    return out


class FrontPlanF32(NamedTuple):
    """How an f32 call runs: ``route`` "cluster" (``cluster`` blocks an
    image, ``rows`` slab rows each) or "slab" (cluster and rows 0)."""

    route: str
    cluster: int
    rows: int


def front32_smem(rows: int, din: int, d: int) -> int:
    """Shared memory of a cluster-route block (``csrc/fused_frontend.cu``'s
    ``front32_smem``): Wp (din rounded up to 8 rows, a row stride >= d that
    is 8 modulo 32), its x rows (stride din + 4), and its rows of z and of
    the tables lnw, lnb and wpe, in f32."""
    dinp = -(-din // 8) * 8
    ldw = (d + 23) // 32 * 32 + 8
    return 4 * (dinp * ldw + rows * (dinp + 4) + 4 * rows * d)


@functools.lru_cache(maxsize=64)
def front_plan_f32(t: int, din: int, d: int) -> FrontPlanF32:
    """The f32 route for images of t patches of din values and width d: the
    cluster route with up to F32_CLUSTER blocks an image (at most one a
    16-row tile) of 16, 32 or 64 rows, as few blocks as those rows need,
    where a block's operands fit F32_FRONT_SMEM (the offline configs' front:
    8 blocks of 32 rows); else the slab route."""
    want = max(1, min(F32_CLUSTER, -(-t // 16)))
    rows = 16
    while rows < -(-t // want):
        rows *= 2
    if (rows <= F32_FRONT_ROWS
            and front32_smem(rows, din, d) <= F32_FRONT_SMEM):
        return FrontPlanF32("cluster", -(-t // rows), rows)
    return FrontPlanF32("slab", 0, 0)


# frontend_launch_f32(x, wp, bp, lnw, lnb, wpe, cls, out, b, t, din, d,
# n_cls, cluster, rows, stream): cluster 0 is the slab route
_ARGTYPES_F32 = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch_front_f32(x: torch.Tensor, w: FrontendWeights,
                     plan: Optional[FrontPlanF32] = None) -> torch.Tensor:
    """The f32 form on checked CUDA operands (see :func:`fused_frontend`),
    on ``plan``'s route (by default :func:`front_plan_f32`'s)."""
    b, t, din = x.shape
    d, n_cls = w.w_p.shape[1], w.cls.shape[0]
    plan = plan or front_plan_f32(t, din, d)
    out = torch.empty(b, n_cls + t, d, dtype=x.dtype, device=x.device)
    fn = _build.entry_point("fused_frontend", "frontend_launch_f32",
                            _ARGTYPES_F32)
    err = fn(*[_build.ptr(a) for a in (x, w.w_p, w.b_p, w.ln_w, w.ln_b, w.wpe,
                                       w.cls, out)],
             b, t, din, d, n_cls, plan.cluster, plan.rows,
             _build.stream(x.device))
    _build.check(err, f"fused_frontend (f32, {plan.route} route)")
    fused_frontend.launches += 1
    return out


def fused_frontend(x: torch.Tensor, w: FrontendWeights) -> torch.Tensor:
    """The (b, n_cls + t, d) block-loop input from the (b, t, din) patch
    stream ``x``: the CUDA kernels for a CUDA tensor (bf16: the route of
    :func:`front_plan`; f32: of :func:`front_plan_f32`), the plain version
    for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_frontend_plain(x, w)
    f32 = x.dtype == torch.float32
    for name, t in [("x", x)] + list(zip(w._fields, w)):
        _build.check_operand("fused_frontend", name, t,
                             torch.float32 if f32 else torch.bfloat16)
    b, t, din = x.shape
    d = w.w_p.shape[1]
    n_cls = w.cls.shape[0]
    need = "d % 8 == 0" if f32 else "din % 32 == 0, d % 16 == 0"
    if ((d % 8 if f32 else din % 32 or d % 16) or w.w_p.shape != (din, d)
            or w.ln_w.shape != (t, d) or w.wpe.shape != (t, d)
            or w.cls.shape != (n_cls, d)
            or (w.ln_b is not None and w.ln_b.shape != (t, d))
            or (w.b_p is not None and w.b_p.shape != (d,))):
        raise ValueError(f"fused_frontend kernel: unsupported shape b={b} "
                         f"t={t} din={din} d={d} n_cls={n_cls} (needs "
                         f"{need} and (t, d) tables)")
    if f32:
        return launch_front_f32(x, w)
    return launch_front(x, w, front_plan(t, d))


fused_frontend.launches = 0
