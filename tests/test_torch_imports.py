"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its flagship config equals the JAX one field by field, and its
entry points refuse to fall back to the CPU on their own."""
import dataclasses
import enum
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, as the suite does)

from __graft_entry__ import _flagship_config

import image2text_torch
from image2text_torch.configs.models import flagship_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        image2text_torch.__path__, "image2text_torch."))


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {['image2text_torch'] + _submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'image2text_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|image2text_tpu)\b",
                     re.M)
    files = list((REPO / "image2text_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def _assert_same(mine, ref, path="model"):
    if dataclasses.is_dataclass(mine):
        for f in dataclasses.fields(mine):
            _assert_same(getattr(mine, f.name), getattr(ref, f.name),
                         f"{path}.{f.name}")
    elif isinstance(mine, enum.Enum):
        assert mine.value == ref.value, path
    elif isinstance(mine, (tuple, list)):
        assert tuple(mine) == tuple(ref), path
    else:
        assert mine == ref and type(mine) is type(ref) or (
            isinstance(mine, float) and mine == ref), path


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_config_matches_jax(tiny):
    _assert_same(flagship_config(tiny=tiny), _flagship_config(tiny=tiny).model)


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_training_config_matches_jax(tiny):
    """Every field the port's TrainingConfig keeps equals the JAX one read
    from training_configs/tpu/nano-mini.yaml."""
    from image2text_torch.configs.trainer import flagship_training_config

    mine, ref = flagship_training_config(tiny), _flagship_config(tiny)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name == "model":
            _assert_same(a, b)
        elif f.name == "optimizers":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _assert_same(x, y, "optimizers")
        else:
            _assert_same(a, b, f.name)


def test_entry_point_without_cuda_raises(monkeypatch):
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VisionEncoderDecoder(flagship_config(tiny=True))
    model = VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")
    assert model.device.type == "cpu"


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """The wrapper runs the plain version for a CPU tensor (launching
    nothing) and never for another device: there it launches the kernel or
    raises."""
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.ops.fused_moe import moe_ffn

    model = VisionEncoderDecoder(flagship_config(tiny=True),
                                 device="cpu").init_weights(0)
    mlp = model.decoder.blocks[0].mlp
    x = torch.randn(3, 64)
    before = moe_ffn.launches
    y = moe_ffn(x, mlp.c_fc.packed(x.dtype), mlp.c_proj.packed(x.dtype))
    assert y.shape == x.shape and moe_ffn.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_ffn(torch.empty(3, 64, device="meta"),
                mlp.c_fc.packed(x.dtype), mlp.c_proj.packed(x.dtype))
    assert moe_ffn.launches == before


@pytest.mark.parametrize("name", [
    "image2text_torch.ops.fused_frontend", "image2text_torch.ops.topk_mask",
    "image2text_torch.models.generation_utils"])
def test_beam_slice_modules_are_covered(name):
    """The beam-search slice's new modules are among those the no-JAX
    import check walks, and none names JAX or the JAX package."""
    assert name in _submodules()
    path = REPO / (name.replace(".", "/") + ".py")
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|image2text_tpu)\b",
                         path.read_text(), re.M)


def test_new_kernel_wrappers_take_plain_version_only_on_cpu():
    """The front, the dense block and the ban mask: plain on a CPU tensor,
    no launch; on another device the kernel or a raise."""
    from image2text_torch.configs.models import flagship_dense_config
    from image2text_torch.models.vision_encoder_decoder import (
        VisionEncoderDecoder)
    from image2text_torch.ops.fused_block import fused_block
    from image2text_torch.ops.fused_frontend import fused_frontend
    from image2text_torch.ops.topk_mask import topk_ban_mask

    model = VisionEncoderDecoder(flagship_dense_config(tiny=True),
                                 device="cpu").init_weights(0)
    enc = model.vision_encoder
    front, blk = enc.frontend_weights(torch.float32), enc.blocks[0]
    x = torch.zeros(2, enc.n_patches ** 2, enc.input_d)
    s = torch.zeros(2, enc.n_cls + enc.n_patches ** 2, enc.out_dim)
    logits = torch.zeros(2, 50)
    calls = [(fused_frontend, (x, front)),
             (fused_block, (s, blk.block_weights(torch.float32))),
             (topk_ban_mask, (logits, None, 4))]
    for fn, args in calls:
        before = fn.launches
        assert fn(*args).device.type == "cpu" and fn.launches == before
        meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args)
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*meta)
        assert fn.launches == before


@pytest.mark.parametrize("name", [
    "image2text_torch.nn.modules", "image2text_torch.ops.functions",
    "image2text_torch.models.quantization",
    "image2text_torch.models.generation", "image2text_torch.evaluate"])
def test_serving_mode_modules_are_covered(name):
    """The serving modes' new and changed modules are among those the
    no-JAX import check walks, and none names JAX or the JAX package."""
    assert name in _submodules()
    path = REPO / (name.replace(".", "/") + ".py")
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|image2text_tpu)\b",
                         path.read_text(), re.M)


@pytest.mark.parametrize("name", [
    "image2text_torch.parallel.collectives", "image2text_torch.parallel.mesh",
    "image2text_torch.parallel.sharding_rules",
    "image2text_torch.parallel.launch", "image2text_torch.parallel.checks",
    "image2text_torch.graft_entry"])
def test_parallel_slice_modules_are_covered(name):
    """The mesh's modules and the twin of ``__graft_entry__.py`` are among
    those the no-JAX import check walks, and none names JAX or the JAX
    package (the spawned ranks import them alone)."""
    assert name in _submodules()
    path = REPO / (name.replace(".", "/") + ".py")
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|image2text_tpu)\b",
                         path.read_text(), re.M)


def test_int8_product_takes_plain_version_only_on_cpu():
    """``int8_mm`` (the W8A8 product): the exact plain product on CPU
    tensors, counting no launch; on another device ``torch._int_mm`` or a
    raise, never the plain version."""
    from image2text_torch.ops.functions import int8_mm, int8_mm_plain

    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (3, 16), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (5, 16), dtype=torch.int8, generator=gen)
    before = int8_mm.launches
    assert torch.equal(int8_mm(a, b), int8_mm_plain(a, b))
    assert int8_mm.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8_mm(a.to("meta"), b.to("meta"))
    assert int8_mm.launches == before
