"""The f32 forms of the MoE FFN and the encoder front at their paths' real
widths, against the JAX package's Pallas kernels in interpret mode; and
the launch plans of their CUDA kernels as pure functions.

On the CPU the wrappers run their plain PyTorch versions: ``moe_ffn`` at
nano-mini's widths (fin 1024 → hidden 2048, gate 32, 4 experts of rank
16, top-2) against ``_ffn_kernel`` through ``fused_moe_mlp_compatible``,
and ``fused_frontend`` at the offline configs' front (t 256, din 128,
d 64, 8 CLS rows) against ``_frontend_kernel`` (its gate declines d 64,
d % 128, so the test calls the kernel's runner on the gate's operands).
Inputs from a numpy seed; JAX at full matmul precision.  The CUDA kernels
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
the plans here decide their grids: every hidden chunk in exactly one
slice of a cluster, in order, and the front's route for each shape the
card tests take."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.configs.models import MoEConfig as JMoEConfig
from image2text_tpu.models.layers import _MoEMLP as JMoEMLP
from image2text_tpu.ops import fused_frontend as jff
from image2text_tpu.ops.fused_moe import fused_moe_mlp_compatible
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.models import MoEConfig
from image2text_torch.models.layers import _MoEMLP
from image2text_torch.ops import _build
from image2text_torch.ops import fused_frontend as ff
from image2text_torch.ops import fused_moe as fm
from image2text_torch.utils.checkpoint import load_jax_state_dict

NANO_MINI_MOE = dict(num_experts=4, proj_features=16, gate_sizes=(32,),
                     ff_mult_factor=2.0, top_k=2)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's CPU products on one torch thread (restored after), so
    that their sums run in one order in every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def nano_mini_ffn():
    """nano-mini's decoder FFN (n_embd 1024, bias) in both packages, on the
    JAX initialisation's weights."""
    jmlp = JMoEMLP(1024, True, 0.1, JMoEConfig(**{
        **NANO_MINI_MOE, "gate_sizes": list(NANO_MINI_MOE["gate_sizes"])}))
    params = jmlp.init(jax.random.PRNGKey(0))
    tmlp = _MoEMLP(1024, True, MoEConfig(**NANO_MINI_MOE), device="cpu")
    load_jax_state_dict(tmlp, export_state_dict(jmlp, params))
    return jmlp, params, tmlp


@pytest.mark.parametrize("rows", [16, 48])
def test_moe_ffn_matches_jax_kernel_at_nano_mini_widths(nano_mini_ffn, rows):
    """fin 1024 → 2048 → 1024 in f32 (depths 1024 and 2048): the port's
    ``moe_ffn`` on CPU tensors (its plain version) against ``_ffn_kernel``
    in interpret mode within 2e-5, and its routes against JAX's top-k."""
    jmlp, params, tmlp = nano_mini_ffn
    x = np.random.default_rng(rows).standard_normal((rows, 1024)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        ref = fused_moe_mlp_compatible(jmlp, params, jnp.asarray(x),
                                       interpret=True)
    assert ref is not None
    fc = tmlp.c_fc.packed(torch.float32)
    proj = tmlp.c_proj.packed(torch.float32)
    before = fm.moe_ffn.launches
    out = fm.moe_ffn(torch.from_numpy(x), fc, proj)
    assert fm.moe_ffn.launches == before     # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (rows, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_front_matches_jax_kernel_at_the_offline_shape():
    """b 2, t 256, din 128, d 64, 8 CLS rows in f32: ``fused_frontend`` on
    CPU tensors (its plain version) against ``_frontend_kernel`` in
    interpret mode within 3e-5, CLS rows exact."""
    rng = np.random.default_rng(7)
    b, t, din, d, n_cls = 2, 256, 128, 64, 8

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x, wp, bp = r(b, t, din), r(din, d, scale=din ** -0.5), r(d, scale=0.1)
    lnw, lnb = 1 + r(t, d, scale=0.1), r(t, d, scale=0.1)
    wpe, cls = r(t, d), r(n_cls, d)
    with jax.default_matmul_precision("highest"):
        ref = jff._run(2, n_cls, True, *map(jnp.asarray, (
            x, wp, bp[None], lnw, lnb, wpe, cls)))
    w = ff.FrontendWeights(*map(torch.from_numpy, (wp, bp, lnw, lnb, wpe,
                                                   cls)))
    before = ff.fused_frontend.launches
    out = ff.fused_frontend(torch.from_numpy(x), w)
    assert ff.fused_frontend.launches == before
    assert out.shape == (b, n_cls + t, d)
    np.testing.assert_array_equal(out[:, :n_cls].numpy(),
                                  np.broadcast_to(cls, (b, n_cls, d)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("n", [1, 17, 256, 4097, 40960])
@pytest.mark.parametrize("fin,hidden", [(1024, 2048), (70, 150)])
def test_moe_plan_f32_takes_every_hidden_chunk_once_in_order(n, fin, hidden):
    """A row tile's cluster of slices covers the hidden chunks exactly once,
    in order, none empty, and its blocks' output columns cover fin; about
    a block an SM of 132, at most F32_MAX_SLICES a cluster: one block a
    tile from 132 row tiles on."""
    plan = fm.moe_plan_f32(n, fin, hidden, 132)
    chunks = -(-hidden // fm.F32_CHUNK)
    # block r's hidden chunks, as moe32_kernel takes them
    spans = [(r * plan.chunks_per_slice,
              min((r + 1) * plan.chunks_per_slice, chunks))
             for r in range(plan.slices)]
    assert [c for c0, c1 in spans for c in range(c0, c1)] == list(
        range(chunks))
    assert all(c1 > c0 for c0, c1 in spans) and len(spans) == plan.slices
    assert 1 <= plan.slices <= fm.F32_MAX_SLICES
    assert plan.chunks_per_slice == -(-chunks // plan.slices)
    assert plan.cols_per_block % fm.F32_CHUNK == 0
    assert fin <= plan.slices * plan.cols_per_block < fin + (
        plan.slices * fm.F32_CHUNK)
    tiles = -(-n // fm.F32_ROWS)
    if tiles >= 132:
        assert plan.slices == 1
    else:
        assert plan.slices == min(fm.F32_MAX_SLICES, chunks) or (
            tiles * plan.slices >= 132)
    if (n, fin) == (256, 1024):   # a nano-mini f32 caption call's launch
        assert plan == (8, 4, 128)   # 16 tiles x 8 slices = 128 blocks
    one = fm.moe_plan_f32(n, fin, hidden, 132, slices=1)
    assert one == (1, chunks, -(-fin // fm.F32_CHUNK) * fm.F32_CHUNK)


def test_moe_plan_f32_reads_the_kernel_tiling():
    """Rows a block, columns a chunk, the widest g + e·r and the most
    slices (a cluster) come from the CUDA source, their owner."""
    src = (_build.CSRC / "fused_moe.cu").read_text()
    for name, value in (("F_ROWS", fm.F32_ROWS), ("F_CHUNK", fm.F32_CHUNK),
                        ("F_MAXA", fm.F32_MAXA),
                        ("F_MAX_SLICES", fm.F32_MAX_SLICES)):
        assert re.search(rf"constexpr int {name} = {value};", src)
    assert (fm.F32_ROWS, fm.F32_CHUNK, fm.F32_MAXA, fm.F32_MAX_SLICES) == (
        16, 64, 128, 8)


@pytest.mark.parametrize("t,din,d,want", [
    (256, 128, 64, ("cluster", 8, 32)),   # the offline configs' front
    (16, 40, 24, ("cluster", 1, 16)),     # one block an image
    (100, 200, 128, ("cluster", 7, 16)),  # 7 blocks, the last ragged
    (300, 37, 64, ("cluster", 5, 64)),    # 64-row blocks
    (64, 128, 64, ("cluster", 4, 16)),    # fewer blocks than F32_CLUSTER
    (512, 128, 64, ("cluster", 8, 64)),   # 8 blocks of 64 rows: the most
    (256, 1024, 256, ("slab", 0, 0)),     # Wp past a block's memory
    (256, 2048, 1024, ("slab", 0, 0)),    # the flagship's widths
    (1024, 128, 64, ("slab", 0, 0)),      # past 8 blocks of 64 rows
    (513, 128, 64, ("slab", 0, 0)),       # 65 rows a block: too many
])
def test_front_plan_f32_route_per_shape(t, din, d, want):
    """The f32 front's cluster route takes every shape whose slab rows fit
    up to F32_CLUSTER blocks of 16, 32 or 64 rows with their operands in a
    block's shared memory (as few blocks as the rows need); the slab route
    the rest.  A pure function of t, din and d."""
    plan = ff.front_plan_f32(t, din, d)
    assert tuple(plan) == want
    if plan.route == "cluster":
        assert (plan.cluster - 1) * plan.rows < t <= plan.cluster * plan.rows
        assert ff.front32_smem(plan.rows, din, d) <= ff.F32_FRONT_SMEM


def test_front_plan_f32_reads_the_kernel_tiling():
    """The cluster size, rows and shared-memory budget come from the CUDA
    source, and the plan's shared-memory count is the kernel's."""
    src = (_build.CSRC / "fused_frontend.cu").read_text()
    for name in ("F32_CLUSTER", "F32_FRONT_ROWS", "F32_FRONT_SMEM"):
        assert re.search(rf"constexpr int {name} = {getattr(ff, name)};", src)
    assert "return (d + 23) / 32 * 32 + 8;" in src
    assert ("return ((size_t)dinp * front32_ldw(d) + (size_t)rows * "
            "(dinp + 4) + (size_t)4 * rows * d) *" in src)
    assert ff.front32_smem(32, 128, 64) == 86528


def test_front_f32_variants_edit_the_shipped_source():
    """Every text edit of ``probes/flash_variants.py``'s f32 front variants
    finds its line, once, in the shipped front source, and each variant's
    cluster size is the one its edit sets (the shipped one F32_CLUSTER)."""
    from image2text_torch.probes.flash_variants import FRONT_F32_VARIANTS

    src = (_build.CSRC / "fused_frontend.cu").read_text()
    assert FRONT_F32_VARIANTS["shipped"] == (ff.F32_CLUSTER, ())
    for name, (cluster, edits) in FRONT_F32_VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, (name, old)
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        assert f"constexpr int F32_CLUSTER = {cluster};" in text, name
