"""The port's local image-directory loader and its C++ preprocessing core
(``image2text_torch/training/{data,native}.py``) against the JAX
package's (``image2text_tpu/training/data.py``, ``image2text_tpu/native``)
on the same image directory: batches, row order, tokens, the native
library's bits, its build, and the trainer twin's ``dataset: local``.
"""
import json
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from image2text_tpu.native import resize_normalize_batch as jax_resize
from image2text_tpu.training import data as jdata
from image2text_tpu.training.tokenizer import (
    SyntheticTokenizer as JaxSyntheticTokenizer)

from image2text_torch.training import data as tdata
from image2text_torch.training import native
from image2text_torch.training.tokenizer import SyntheticTokenizer

torch.set_num_threads(2)
MAX_LEN = 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_dir(path, n=12, seed=0):
    """``n`` images (uint8 ``.npy`` and PNG files of several shapes) and a
    captions.json with 1–5 captions each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    mapping = {}
    for i in range(n):
        h, w = (int(v) for v in rng.integers(40, 170, 2))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            name = f"img_{i:02d}.png"
            Image.fromarray(arr).save(path / name)
        else:
            name = f"sub/img_{i:02d}.npy"
            (path / "sub").mkdir(exist_ok=True)
            np.save(path / name, arr)
        n_caps = 1 + i % 5
        mapping[name] = [" ".join(str(int(t)) for t in rng.integers(
            3, 500, rng.integers(3, 12))) + f" word{j}" for j in range(n_caps)]
    (path / "captions.json").write_text(json.dumps(mapping))
    return path


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib(tmp_path_factory):
    """JAX's build of ``native/preproc.cc`` (its loader's command and
    argument types) into a directory of this module's, installed as the
    JAX loader's library: the JAX loader's own first build writes a
    shared temporary name under HOME that concurrent workers race on
    (a known fault of the reference), so this module never triggers
    it."""
    import ctypes

    from image2text_tpu import native as jnative

    out = tmp_path_factory.mktemp("jax_native") / "preproc.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                    "-fPIC", jnative._source_path(), "-o", str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.resize_normalize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", lib)
        mp.setattr(jnative, "_TRIED", True)
        yield lib


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("images"))


def _loaders(pkg, tok_cls, image_dir, is_vit, shuffle, batch=4, **kw):
    return pkg.get_local_dataloader(tok_cls(512), batch, shuffle, is_vit,
                                    dataset_dir=str(image_dir),
                                    max_length=MAX_LEN, **kw)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "image":
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("is_vit", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_local_batches_equal_jax(image_dir, is_vit, shuffle):
    """Two passes over train and val: the same rows in the same order
    (the per-pass shuffle), tokens and masks bit for bit, images within
    1e-6 (Flickr 128 px through each package's C++ core; the ViT's PIL
    bicubic 224 crop)."""
    mine = _loaders(tdata, SyntheticTokenizer, image_dir, is_vit, shuffle)
    ref = _loaders(jdata, JaxSyntheticTokenizer, image_dir, is_vit, shuffle)
    for m, r in zip(mine, ref):
        assert len(m) == len(r)
        for _ in range(2):
            got, want = list(m), list(r)
            assert len(got) == len(want) == len(r)
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
    size = 224 if is_vit else 128
    assert got[0]["image"].shape == (4, 3, size, size)


def test_wrapped_batches_and_threaded_window_equal_jax(image_dir):
    """The 5-caption expansion over the local rows (``WrapperDataLoader``)
    equals JAX's, and the threaded row window (8 workers) gives the
    single-thread batches."""
    mine, _ = _loaders(tdata, SyntheticTokenizer, image_dir, False, True,
                       batch=3)
    ref, _ = _loaders(jdata, JaxSyntheticTokenizer, image_dir, False, True,
                      batch=3)
    wm = tdata.WrapperDataLoader(mine, 4, -100, epochs=2, seed=3)
    wr = jdata.WrapperDataLoader(ref, 4, -100, epochs=2, seed=3)
    pairs = list(zip(wm, wr))
    assert len(pairs) == 2 * len(mine) * -(-5 * 3 // 4)
    for (im, lm), (ir, lr) in pairs:
        np.testing.assert_allclose(im, ir, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(lm, lr)
    threaded = tdata.RowBatcher(mine.rows, mine.transform, 3, True, 0,
                                workers=8)
    single = tdata.RowBatcher(mine.rows, mine.transform, 3, True, 0)
    for g, w in zip(threaded, single):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_preprocessing_equals_jax_and_the_plain_resize(image_dir):
    """``preprocess_image``: uint8 through the C++ core equal to JAX's bit
    for bit, within 2e-5 of the numpy plain version, and float input
    through the plain version as JAX; ``preprocess_image_vit`` on both
    routes (PIL bicubic, and the bilinear fallback where PIL is not
    importable) equal to JAX's."""
    rows = tdata._LocalRows(sorted(json.load(open(
        image_dir / "captions.json")).items()), str(image_dir))
    for i in range(4):
        img = rows[i]["image"]
        got = tdata.preprocess_image(img, 128)
        np.testing.assert_array_equal(got, jdata.preprocess_image(img, 128))
        plain = ((tdata._resize_bilinear(img, 128) / 255.0
                  - tdata.FLICKR_MEAN[:, None, None])
                 / tdata.FLICKR_STD[:, None, None]).astype(np.float32)
        np.testing.assert_allclose(got, plain, atol=2e-5, rtol=1e-5)
        f = img.astype(np.float32)
        np.testing.assert_array_equal(tdata.preprocess_image(f, 96),
                                      jdata.preprocess_image(f, 96))
        np.testing.assert_array_equal(tdata.preprocess_image_vit(img),
                                      jdata.preprocess_image_vit(img))


def test_vit_preprocess_without_pil_takes_the_bilinear_route(image_dir,
                                                             monkeypatch):
    """With PIL hidden, both packages take the host bilinear resize: equal
    to each other and to the plain resize, and not PIL's bicubic."""
    img = np.load(image_dir / "sub" / "img_00.npy")
    with_pil = tdata.preprocess_image_vit(img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = tdata.preprocess_image_vit(img)
    np.testing.assert_array_equal(got, jdata.preprocess_image_vit(img))
    assert got.shape == (3, 224, 224)
    assert not np.array_equal(got, with_pil)


def test_native_resize_equals_jax_build_bit_for_bit():
    """The port's copy of preproc.cc, built with the JAX package's flags,
    gives JAX's build's bits at every size (sizes where -march=native's
    fused multiply-adds change the last bit included), Flickr and ImageNet
    statistics."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (5, 157, 203, 3), dtype=np.uint8)
    for size in (16, 64, 128, 224, 300):
        for mean, std in ((tdata.FLICKR_MEAN, tdata.FLICKR_STD),
                          (tdata.IMAGENET_MEAN, tdata.IMAGENET_STD)):
            got = native.resize_normalize_batch(images, size, mean, std)
            want = jax_resize(images, size, mean, std)
            assert got.shape == (5, 3, size, size)
            np.testing.assert_array_equal(got, want, err_msg=str(size))
    with pytest.raises(ValueError, match="uint8"):
        native.resize_normalize_batch(images.astype(np.float32), 16,
                                      tdata.FLICKR_MEAN, tdata.FLICKR_STD)


def _build_into(out):
    from image2text_torch.training import native as n

    return str(n.build(out))


def test_concurrent_builds_do_not_clash(tmp_path):
    """Four processes build the same library at once: each compiles to its
    own temporary name and renames it into place; every one returns the
    loadable library and no temporary file is left."""
    out = tmp_path / "libpreproc-test.so"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        paths = pool.map(_build_into, [out] * 4)
    assert paths == [str(out)] * 4
    import ctypes

    lib = ctypes.CDLL(str(out))
    assert hasattr(lib, "resize_normalize_batch")
    assert hasattr(lib, "permute_gather")
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]


def test_threads_of_one_process_share_the_first_build(tmp_path,
                                                     monkeypatch):
    """A trainer's train and val prefetch threads can both make the first
    uint8 call: sixteen threads at once on an empty build directory all
    get the library (one builds, the others wait) and the same bits, and
    no temporary file is left."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    img = np.random.default_rng(5).integers(0, 256, (37, 53, 3),
                                            dtype=np.uint8)
    with ThreadPoolExecutor(16) as ex:
        outs = list(ex.map(lambda _: tdata.preprocess_image(img, 32),
                           range(16)))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        native.lib_path().name]


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    """No silent fallback: a missing compiler or a source that does not
    compile raises, and the uint8 path raises with it."""
    with pytest.raises(RuntimeError, match="needs"):
        native.build(tmp_path / "a.so", compiler="no-such-compiler-x")
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="bad.cc"):
        native.build()
    img = np.zeros((20, 20, 3), np.uint8)
    with pytest.raises(RuntimeError, match="error"):
        tdata.preprocess_image(img, 16)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_strided_rows_and_host_shard_match_jax(monkeypatch):
    """Each process's rows: JAX's ``_StridedRows`` at every rank of a
    world of 3, and ``_host_shard`` reading the world from
    torch.distributed (identity without a process group)."""
    rows = list(range(20))
    assert tdata._host_shard(rows) is rows
    for rank in range(3):
        got = tdata._StridedRows(rows, rank, 3)
        want = jdata._StridedRows(rows, rank, 3)
        assert len(got) == len(want) == 6
        assert [got[i] for i in range(len(got))] == \
            [want[i] for i in range(len(want))]
        monkeypatch.setattr(tdata, "process_count", lambda: 3)
        monkeypatch.setattr(tdata, "process_index", lambda r=rank: r)
        shard = tdata._host_shard(rows)
        assert [shard[i] for i in range(len(shard))] == \
            [want[i] for i in range(len(want))]


def test_local_dataloader_refuses_a_missing_dir_as_jax():
    for pkg, tok in ((tdata, SyntheticTokenizer),
                     (jdata, JaxSyntheticTokenizer)):
        with pytest.raises(ValueError, match="dataset_dir"):
            pkg.get_local_dataloader(tok(64), 2, False, False,
                                     dataset_dir=None)


def _local_yaml(tmp_path, image_dir):
    """synthetic-smoke.yaml on the local directory, its scratch encoder at
    the loader's 128 px."""
    text = open(os.path.join(REPO, "training_configs", "local",
                             "synthetic-smoke.yaml")).read()
    text = (text.replace("dataset: 'synthetic'",
                         f"dataset: 'local'\ndataset_dir: '{image_dir}'")
            .replace("width: 64", "width: 128")
            .replace("height: 64", "height: 128")
            .replace("num_steps: 20", "num_steps: 2")
            .replace("num_val_steps: 4", "num_val_steps: 1")
            .replace("max_loop_epochs: 2", "max_loop_epochs: 1")
            .replace("batch_size: 8", "batch_size: 4"))
    path = tmp_path / "local-smoke.yaml"
    path.write_text(text)
    return str(path)


def test_trainer_dataloaders_on_a_local_dir_equal_jax(tmp_path, image_dir):
    """The trainer twins' ``build_dataloaders`` with ``dataset: local``:
    the port's train and val batches equal the root trainer.py's."""
    import yaml

    import trainer as jtrainer
    from image2text_tpu.configs.trainer import TrainingConfig

    from image2text_torch import trainer as ttrainer
    from image2text_torch.configs.reader import load_training_config

    path = _local_yaml(tmp_path, image_dir)
    tcfg = load_training_config(path)
    jcfg = TrainingConfig.model_validate(yaml.safe_load(open(path)))
    mine = ttrainer.build_dataloaders(tcfg, ttrainer.config_tokenizer(tcfg))
    ref = jtrainer.build_dataloaders(jcfg, JaxSyntheticTokenizer(1024))
    for m, r in zip(mine, ref):
        for (im, lm), (ir, lr), _ in zip(m, r, range(3)):
            assert im.shape == (4, 3, 128, 128)
            np.testing.assert_allclose(im, ir, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(lm, lr)


def test_trainer_cli_trains_on_a_local_dir(tmp_path, image_dir):
    """``python -m image2text_torch.trainer`` on the CPU is not a flag
    (the twin runs on the card); ``main(args, device='cpu')`` trains the
    local directory: finite losses, a checkpoint written."""
    from image2text_torch import trainer as ttrainer

    ck = tmp_path / "local.npz"
    tr = ttrainer.main(ttrainer.parse_args(
        ["--config_file", _local_yaml(tmp_path, image_dir),
         "--chkpt_file", str(ck)]), device="cpu")
    losses = [float(m["train_loss_lm"]) for m in tr.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ck.exists()


def test_trainer_cli_refuses_flickr30k():
    """The Deep Lake loader stays unported: ``dataset: flickr30k``
    raises."""
    from image2text_torch import trainer as ttrainer
    from image2text_torch.configs.reader import load_training_config

    cfg = load_training_config(os.path.join(
        REPO, "training_configs", "local", "synthetic-smoke.yaml"))
    cfg.dataset = "flickr30k"
    with pytest.raises(NotImplementedError, match="Deep Lake"):
        ttrainer.build_inner_datasets(cfg, SyntheticTokenizer(64))


def test_module_entry_point_names_its_flags():
    """``python -m image2text_torch.trainer --help`` runs (the CLI the
    card's smoke drives on a local directory)."""
    out = subprocess.run([sys.executable, "-m", "image2text_torch.trainer",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "--config_file" in out.stdout
