"""The offline slice's host-side modules against the JAX package's: the
YAML reader (``configs/reader.py``) against ``yaml.safe_load`` and the
pydantic ``TrainingConfig`` for every file of ``training_configs/``, the
synthetic tokenizer, the synthetic streams and ``WrapperDataLoader`` (bit
for bit), the metrics (equal floats), the nucleus and full-vocabulary
samplers on the same noise, ``_MLP``, and the f32 flash attention at the
offline configs' shapes (CPU route: the plain versions) against JAX's
kernels in interpret mode.
f32 comparisons at ``jax.default_matmul_precision("highest")``."""
import dataclasses
import enum
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.eval import metrics as jmetrics
from image2text_tpu.models import layers as jlayers
from image2text_tpu.models import sampling as jsampling
from image2text_tpu.ops.flash_attention import flash_sdpa as jax_flash_sdpa
from image2text_tpu.training import data as jdata
from image2text_tpu.training import tokenizer as jtok

from image2text_torch.configs import models as tcm
from image2text_torch.configs.reader import (from_dict, load_training_config,
                                             parse_yaml)
from image2text_torch.eval import metrics as tmetrics
from image2text_torch.models import layers as tlayers
from image2text_torch.models import sampling as tsampling
from image2text_torch.ops import flash_attention as fa
from image2text_torch.training import data as tdata
from image2text_torch.training import tokenizer as ttok

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "training_configs").glob("*/*.yaml"))


def _same(mine, ref, path):
    """Every field of the port's dataclass ``mine`` equals the pydantic
    ``ref``'s (the port keeps a subset of the trainer's fields)."""
    if dataclasses.is_dataclass(mine):
        assert type(mine).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(mine):
            _same(getattr(mine, f.name), getattr(ref, f.name),
                  f"{path}.{f.name}")
    elif isinstance(mine, enum.Enum):
        assert mine.value == ref.value, path
    elif isinstance(mine, (tuple, list)):
        assert len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _same(a, b, f"{path}[{i}]")
        assert type(mine) is type(ref), path
    else:
        assert mine == ref and (type(mine) is type(ref) or isinstance(
            mine, float)), (path, mine, ref)


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_safe_load_and_the_jax_config(path):
    text = (REPO / path).read_text()
    raw = yaml.safe_load(text)
    assert parse_yaml(text) == raw
    _same(load_training_config(REPO / path),
          JTrainingConfig.model_validate(raw), path)


def test_yaml_reader_subset_and_union_rule():
    doc = ("a: 'it''s' # note\nb: \"x#y\"\nc:\n- 1\n- [2, {}]\n"
           "d: {e: 0x1F, f: [g, ~]}\nh: 3e-3\ni: .5\nj: yes\n")
    assert parse_yaml(doc) == yaml.safe_load(doc)
    for bad in ("a: &x 1\n", "a:\n\t- 1\n", "a: 1\n---\nb: 2\n", "a: |\n x\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)
    attn = {"attn_type": "multi_query"}
    mlp = from_dict(tcm.TransformerConfig, {"rotator_config": {"ff_mult": 2},
                                            "attn_config": attn})
    assert mlp.rotator_config == tcm.MLPConfig(ff_mult=2.0)
    moe = from_dict(tcm.TransformerConfig, {
        "rotator_config": {"num_experts": 2, "proj_features": 4,
                           "ff_mult_factor": 2}, "attn_config": attn})
    assert isinstance(moe.rotator_config, tcm.MoEConfig)
    with pytest.raises(KeyError):
        from_dict(tcm.ImageInputSpec, {"width": 4})


@pytest.mark.parametrize("name", [
    "image2text_torch.configs.reader", "image2text_torch.eval.metrics",
    "image2text_torch.training.tokenizer", "image2text_torch.training.data",
    "image2text_torch.training.checkpoint", "image2text_torch.utils.profiling",
    "image2text_torch.trainer", "image2text_torch.evaluate"])
def test_offline_modules_import_no_jax(name):
    path = REPO / (name.replace(".", "/") + ".py")
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|image2text_tpu|"
                         r"yaml|pydantic)\b", path.read_text(), re.M)


def test_synthetic_tokenizer_matches_jax():
    mine, ref = ttok.get_tokenizer("synthetic", synthetic_vocab=1024), \
        jtok.get_tokenizer("synthetic", synthetic_vocab=1024)
    text = "<BOS> a cat 17 2049 <MSK> sat <EOS>"
    for kw in ({}, dict(max_length=4, truncation=True),
               dict(max_length=12, padding="max_length")):
        a, b = mine(text=text, **kw), ref(text=text, **kw)
        assert a.input_ids == b.input_ids and dict(a) == dict(b)
    ids = [1, 5, 0, 2, 999]
    assert mine.decode(ids) == ref.decode(ids)
    assert mine.batch_decode([ids, ids[:2]]) == ref.batch_decode(
        [ids, ids[:2]])
    with pytest.raises(NotImplementedError, match="HF"):
        ttok.get_tokenizer("gpt2")
    assert isinstance(ttok.get_tokenizer("gpt2", allow_fallback=True),
                      ttok.SyntheticTokenizer)


def test_trace_window_writes_a_trace_of_its_steps_and_throughput_counts(
        tmp_path):
    from image2text_torch.utils.profiling import Throughput, TraceWindow

    trace, meter = TraceWindow(str(tmp_path), start=1, stop=3), Throughput()
    for i in range(5):
        trace.step(i)
        torch.ones(8).sum()
        meter.update(items=10)
    trace.close()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert meter.steps == 5 and meter.items == 50
    assert meter.items_per_sec > 0 and meter.steps_per_sec > 0
    TraceWindow(None).step(10)     # no directory: no trace


@pytest.mark.parametrize("kind", ["SyntheticFlickrDataset",
                                  "SyntheticCompositeDataset"])
def test_synthetic_streams_and_wrapper_loader_bit_equal(kind):
    kw = dict(image_size=32, vocab_size=1024, eos_token_id=0, seed=7)
    mine = getattr(tdata, kind)(24, 6, **kw)
    ref = getattr(jdata, kind)(24, 6, **kw)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for dl_a, dl_b in ((tdata.WrapperDataLoader(mine, 4, -100, 2, seed=3),
                        jdata.WrapperDataLoader(ref, 4, -100, 2, seed=3)),):
        n = 0
        for (ia, la), (ib, lb) in zip(dl_a, dl_b):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(la, lb)
            n += 1
        assert n == 2 * 4 * -(-30 // 4) and len(dl_a) == len(dl_b)
    it = tdata.Prefetcher(iter(range(5)))
    assert list(it) == list(range(5)) and tdata.process_index() == 0


def test_metrics_equal_jax_floats():
    rng = np.random.default_rng(4)
    refs = [[list(rng.integers(3, 30, rng.integers(4, 12))) for _ in range(5)]
            for _ in range(12)]
    cands = [r[0][:len(r[0]) - i % 3] + [int(rng.integers(3, 30))]
             for i, r in enumerate(refs)]
    assert tmetrics.corpus_bleu(cands, refs) == jmetrics.corpus_bleu(
        cands, refs) > 0
    assert tmetrics.cider_d(cands, refs) == jmetrics.cider_d(cands, refs) > 0


@pytest.mark.parametrize("top_k,nucleus_p", [(None, 0.6), (16, 0.6),
                                             (None, None), (16, None)])
def test_sample_logits_matches_jax_on_the_same_noise(top_k, nucleus_p):
    """The port's sampler against JAX's ``sample_logits`` (and its
    ``nucleus_sample``) with JAX's Gumbel noise handed over: the nucleus
    draw over the sorted positions, a full-row draw over the row, top-k
    over the head."""
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((6, 300))).astype(np.float32)
    logits[0, :4] = logits[0, 4]     # ties at the top, lowest index first
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsampling.sample_logits(jnp.asarray(logits), key, 0.7,
                                              top_k, nucleus_p))
    width = top_k if top_k is not None and nucleus_p is None else 300
    noise = np.array(jax.random.gumbel(key, (6, width), jnp.float32))
    got = tsampling.sample_logits(torch.from_numpy(logits), None, 0.7, top_k,
                                  nucleus_p, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_nucleus_sample_keeps_the_prefix_and_at_least_one_token():
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05], [0.9, 0.05, 0.03, 0.02]])
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tsampling.nucleus_sample(probs, 0.8, g)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) == {0, 1}      # the 0.8 prefix
    assert set(draws[:, 1].tolist()) == {0}         # p0 above p: p0 alone
    rng = np.random.default_rng(2)
    p = torch.softmax(torch.from_numpy(rng.standard_normal((3, 50))
                                       .astype(np.float32)), -1)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jsampling.nucleus_sample(jnp.asarray(p.numpy()), 0.6,
                                               key))
    noise = np.array(jax.random.gumbel(key, (3, 50), jnp.float32))
    got = tsampling.nucleus_sample(p, 0.6, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mlp_matches_jax():
    """``_MLP`` (c_fc → tanh GELU → c_proj) on the JAX module's weights."""
    jm = jlayers._MLP(64, True, 0.1, jlayers.MLPConfig(ff_mult=2))
    params = jm.init(jax.random.PRNGKey(3))
    tm = tlayers._MLP(64, True, tcm.MLPConfig(ff_mult=2.0), "cpu", 0.1)
    with torch.no_grad():
        for name in ("c_fc", "c_proj"):
            lin = getattr(tm, name)
            lin.weight.copy_(torch.from_numpy(np.array(
                params[name]["weight"])))
            lin.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert sorted(n for n, _ in tm.named_parameters()) == [
        "c_fc.bias", "c_fc.weight", "c_proj.bias", "c_proj.weight"]


# The offline configs' training attention at batch 2 (chip_smoke.py's
# FLASH_OFFLINE): (h, hk, sq, skv, d, causal, soft-prompt prefix, rate).
OFFLINE_SHAPES = {"offline_encoder": (4, 1, 264, 264, 16, False, None, 0.1),
                  "offline_decoder": (4, 1, 128, 128, 16, True, 8, 0.1)}


@pytest.mark.parametrize("label", list(OFFLINE_SHAPES))
def test_flash_f32_cpu_route_matches_jax_at_offline_shapes(label):
    """flash_sdpa on f32 CPU tensors (the plain versions of the f32
    kernels): output and gradients against JAX's flash_sdpa (its Pallas
    kernels in interpret mode), the same dropout seed; f32 sums in another
    order, so 1e-5 of each tensor's largest value."""
    h, hk, sq, skv, d, causal, n_prefix, rate = OFFLINE_SHAPES[label]
    b, seed = 2, 31337
    rng = np.random.default_rng(5)
    q, g = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, hk, skv, d)).astype(np.float32)
            for _ in range(2))
    bias = None
    if n_prefix is not None:
        bias = np.zeros((1, 1, sq, skv), np.float32)
        bias[..., n_prefix:, :n_prefix] = -np.inf
    jb = None if bias is None else jnp.asarray(bias)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_sdpa(q_, k_, v_, jb, causal, rate,
                                              jnp.int32(seed)),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    before = fa.flash_fwd.launches, fa.flash_bwd.launches
    got = fa.flash_sdpa(tq, tk, tv, tb, causal, rate, seed)
    got.backward(torch.from_numpy(g))
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before
    for name, mine, ref in zip(("out", "dq", "dk", "dv"),
                               (got, tq.grad, tk.grad, tv.grad), want):
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=name)
