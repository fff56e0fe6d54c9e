"""The serving modes of ``bench.py`` in the port against the JAX package:
the int8 primitives (``quantize_rows_int8``, ``int8_dot_rows``,
``embedding_rows``), the W8A8 transform ``int8_serving_params`` (the same
int8 rows and scales, bit for bit, on the same modules), int8 cross-KV
(one cached step, greedy ``generate``, greedy beam search; the scratch
decoder and the tiny GPT-2), W8A8 decoder weights with int8 cross-KV (and
the encoder in W8A8 as well), and approximate top-k, which the port takes
as exact.  f32 on the CPU, JAX at full matmul precision; inputs from
numpy seeds.  JAX's W8A8 trees reach the port through ``export_state_dict``
and the port's ``load_jax_state_dict`` into modules already in their int8
form."""
import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.models import sampling as js
from image2text_tpu.models.generation import (
    decoder_step as jax_decoder_step, precompute_cross_kv as jax_cross_kv)
from image2text_tpu.models.generation_utils import (
    BeamSearchTokenGenerator as JaxBeam)
from image2text_tpu.models.quantization import (
    int8_serving_params as jax_int8_serving_params)
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.nn import modules as jmod
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs.models import flagship_config
from image2text_torch.models import sampling as ts
from image2text_torch.models.generation import decoder_step, prefill
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.quantization import int8_serving_params
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.nn import modules as tmod
from image2text_torch.ops.functions import (int8_mm, int8_mm_plain,
                                            int8_mm_weight,
                                            int8_mm_shapes)
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)

from test_torch_gpt2m import pair  # noqa: F401  (the tiny GPT-2 fixture)

torch.set_num_threads(2)
NGRAMS = (2, 3, 4, 5)
BEAM = dict(beam_width=3, beam_expansion_factor=4, temperature=0.0,
            top_k=16, no_repeat_n_grams=NGRAMS, consolidation_temperature=0.0)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, params, the port's model on the same weights): the tiny
    flagship, weights from key 0."""
    jm = JaxModel(_flagship_config(tiny=True).model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = VisionEncoderDecoder(flagship_config(tiny=True), device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    return jm, params, tm


def _w8a8_pair(jm, params, tm, min_elems=1, encoder=False):
    """JAX's params with the decoder (and the encoder) in W8A8, and a copy
    of the port's model holding the same int8 forms, loaded from JAX's
    export of them."""
    pq = dict(params)
    pq["decoder"] = jax_int8_serving_params(jm.decoder, params["decoder"],
                                            min_elems=min_elems)
    tq = copy.deepcopy(tm)
    int8_serving_params(tq.decoder, min_elems=min_elems)
    if encoder:
        pq["encoder"] = jax_int8_serving_params(jm.encoder, params["encoder"],
                                                min_elems=min_elems)
        int8_serving_params(tq.encoder, min_elems=min_elems)
    load_jax_state_dict(tq, export_state_dict(jm, pq))
    return pq, tq


# -- the int8 primitives ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_int8_bit_equal_to_jax(dtype):
    """Values and scales bit for bit, with rows built to hit the rounding
    half-way points (k + 0.5 quanta, half to even) and an all-zero row
    (scale floored at 1e-12)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3, 40)).astype(np.float32)
    x[0, 0] = 0.25
    x[0, 0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]  # scale 1
    x[1, 1] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js_ = jmod.quantize_rows_int8(jx)
    tq, ts_ = tmod.quantize_rows_int8(tx)
    assert tq.dtype == torch.int8 and ts_.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    assert float(ts_[1, 1]) == np.float32(1e-12)
    assert tq[0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 64), (1, 48)])
def test_int8_dot_rows_matches_jax(shape):
    """W8A8 product: equal to JAX's within 1e-6 relative (its int32
    product is exact in both; the scales apply in the same order)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((72, shape[-1])).astype(np.float32)
    qw, qs = jmod.quantize_rows_int8(jnp.asarray(w))
    want = np.asarray(jmod.int8_dot_rows(jnp.asarray(x), qw, qs))
    got = tmod.int8_dot_rows(torch.from_numpy(x),
                             torch.from_numpy(np.asarray(qw)),
                             torch.from_numpy(np.asarray(qs)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_int8_mm_plain_is_the_exact_product_and_pads_for_the_card():
    """The CPU route is the exact integer product (against numpy's int64
    one), also at the extremes (±127 everywhere, the flagship's inner size
    1,024); the card's padded shapes cover the vocabulary of 50,258 and a
    single decode row."""
    rng = np.random.default_rng(2)
    for m, k, n in ((3, 64, 50), (17, 1024, 33), (1, 16, 8)):
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (n, k)).astype(np.int8)
        want = a.astype(np.int64) @ b.astype(np.int64).T
        got = int8_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    ext = torch.full((2, 1024), -127, dtype=torch.int8)
    assert int(int8_mm_plain(ext, ext)[0, 0]) == 127 * 127 * 1024
    assert int8_mm_shapes(256, 1024, 50258) == (256, 1024, 50264)
    assert int8_mm_shapes(1, 1024, 1024) == (24, 1024, 1024)
    assert int8_mm_shapes(192, 64, 8) == (192, 64, 16)


@pytest.mark.parametrize("n,k", [(50, 64), (1024, 1024), (37, 24)])
def test_int8_mm_weight_pads_to_the_card_shapes_and_is_cut_back(n, k):
    """The weight operand padded once (``int8_mm_weight``, what an int8
    form keeps on the card) holds the rows, zeros past them, and the card's
    outer and inner sizes; ``int8_dot_rows`` through it cuts the zero rows
    and equals the product on the unpadded rows bit for bit (inner sizes
    the card needs no padding for: the CPU's plain product takes the
    operands' own).  On the CPU a form's ``int8_operand`` is its
    ``qweight``."""
    rng = np.random.default_rng(n + k)
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    qs = torch.from_numpy(rng.random(n).astype(np.float32))
    padded = int8_mm_weight(qw)
    _, kp, np_ = int8_mm_shapes(1, k, n)
    assert tuple(padded.shape) == (np_, kp) and padded.is_contiguous()
    assert torch.equal(padded[:n, :k], qw)
    assert not padded[n:].any() and not padded[:, k:].any()
    assert (padded is qw) == ((np_, kp) == (n, k))
    x = torch.from_numpy(rng.standard_normal((3, 5, k)).astype(np.float32))
    got = tmod.int8_dot_rows(x, padded, qs)
    assert tuple(got.shape) == (3, 5, n)
    assert torch.equal(got, tmod.int8_dot_rows(x, qw, qs))
    emb = tmod.Embedding(n, k)
    with torch.no_grad():
        emb.weight.normal_(generator=torch.Generator().manual_seed(n))
    emb.to_int8()
    assert emb.int8_operand() is emb.qweight


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_embedding_rows_match_jax_in_the_recorded_dtype(qdtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    jw = jnp.asarray(w).astype(qdtype)
    jq, js_ = jmod.quantize_rows_int8(jw)
    node = {"qweight": jq, "qscale": js_, "qdtype": jnp.zeros((0,), qdtype)}
    idx = np.array([[3, 0, 49], [7, 7, 1]])
    want = jmod.embedding_rows(node, jnp.asarray(idx))
    got = tmod.embedding_rows(torch.from_numpy(np.asarray(jq)),
                              torch.from_numpy(np.asarray(js_)),
                              getattr(torch, qdtype), torch.from_numpy(idx))
    assert got.dtype == getattr(torch, qdtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# -- the W8A8 transform -----------------------------------------------------

def _int8_keys(flat):
    return {k[:-len(".qweight")] for k in flat if k.endswith(".qweight")}


@pytest.mark.parametrize("min_elems", [1, 4096, 1 << 18])
@pytest.mark.parametrize("subtree", ["decoder", "encoder"])
def test_int8_serving_params_bit_equal_to_jax(flagship, min_elems, subtree):
    """The same modules take their int8 form (the tied wte among them,
    MoE experts and the cross-attention's in_proj never), with equal
    qweight and qscale bit for bit and the storage dtype recorded."""
    jm, params, tm = flagship
    jq = jax_int8_serving_params(getattr(jm, subtree), params[subtree],
                                 min_elems=min_elems)
    jflat = {k: np.asarray(v) for k, v in flatten(jq).items()}
    tq = copy.deepcopy(getattr(tm, subtree))
    int8_serving_params(tq, min_elems=min_elems)
    tflat = state_dict_numpy(tq)
    keys = _int8_keys(jflat)
    assert keys == _int8_keys(tflat)
    for k in keys:
        for leaf in ("qweight", "qscale"):
            np.testing.assert_array_equal(tflat[f"{k}.{leaf}"],
                                          jflat[f"{k}.{leaf}"], err_msg=k)
        assert tflat[f"{k}.qdtype"].shape == (0,)
        assert tflat[f"{k}.qdtype"].dtype == jflat[f"{k}.qdtype"].dtype
        assert f"{k}.weight" not in tflat
    if subtree == "decoder" and min_elems <= 4096:
        assert "transformer.wte" in keys and "transformer.wpe" in keys
        assert "transformer.h.0.attn.q_proj" in keys
    if subtree == "encoder" and min_elems == 1:
        assert "projector" in keys
        assert "transformer.wpe" not in keys     # its own table type
    if min_elems == 1 << 18:
        assert not keys                          # every tiny weight is small
    assert not any("l1_weight" in k or "in_proj" in k for k in keys)


def test_int8_forms_cross_the_bridge_both_ways(flagship):
    """A bf16 W8A8 decoder: the port's export carries the bf16 marker
    (and no tied alias of the int8 table); JAX's export of its own W8A8
    tree loads into the port's int8 modules with equal rows and the
    marker's dtype."""
    jm, params, tm = flagship
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16)
                                  if a.dtype == jnp.float32 else a,
                                  params["decoder"])
    jq = jax_int8_serving_params(jm.decoder, jp16, min_elems=1)
    sd = {f"decoder.{k}": v
          for k, v in export_state_dict(jm.decoder, jq).items()}
    tq = copy.deepcopy(tm).to(torch.bfloat16)
    int8_serving_params(tq.decoder, min_elems=1)
    load_jax_state_dict(tq.decoder, {k[len("decoder."):]: v
                                     for k, v in sd.items()})
    wte = tq.decoder.transformer.wte
    assert wte.is_int8 and wte.stored_dtype == torch.bfloat16
    assert tq.decoder.dtype == torch.bfloat16
    back = state_dict_numpy(tq.decoder)
    assert "lm_head.weight" not in back and set(back) == {
        k[len("decoder."):] for k in sd}
    for k, v in sd.items():
        k = k[len("decoder."):]
        if k.endswith(("qweight", "qscale", "qdtype")):
            assert back[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


# -- int8 cross-KV ------------------------------------------------------------

def _cached_step(jm, params, tm, tq, pq, quant, t=3, aligned=None):
    """The logits of one cached decoder step over ``t`` prompt ids with the
    cross K/V in ``quant`` form: (port, JAX); ``aligned`` (an
    ``_AlignedQuantization``) gives the port JAX's activation roundings."""
    img = _images()
    ids = np.random.default_rng(4).integers(0, 512, (2, t))
    off = tm.space_for_prompt
    record = aligned.record() if aligned else contextlib.nullcontext()
    replay = aligned.replay() if aligned else contextlib.nullcontext()
    with jax.default_matmul_precision("highest"), record:
        enc = jm.encoder(pq["encoder"], jnp.asarray(img))
        kv = jax_cross_kv(jm, pq, enc, quant=quant)
        want, _ = jax_decoder_step(jm, pq, jnp.asarray(ids),
                                   jm.decoder.init_cache(2, 12, jnp.float32),
                                   off, enc, cross_kv=kv)
    with torch.no_grad(), replay:
        tenc = tq.encoder(torch.from_numpy(img))
        tkv = tq.decoder.precompute_cross_kv(tenc, quant=quant)
        if quant:
            assert all(isinstance(v, tmod.QuantizedKV) for v in tkv.values())
        got, _ = decoder_step(tq, torch.from_numpy(ids),
                              tq.decoder.init_cache(2, 12, torch.float32,
                                                    "cpu"), off, tenc, tkv)
    return got.numpy(), np.asarray(want)


def test_int8_cross_kv_step_logits_match_jax(flagship):
    jm, params, tm = flagship
    got, want = _cached_step(jm, params, tm, tm, params, "int8")
    assert _rel_l2(got, want) <= 1e-4
    exact, _ = _cached_step(jm, params, tm, tm, params, None)
    assert 0 < _rel_l2(got, exact) < 0.05     # the int8 rounding shows


def test_int8_cross_kv_greedy_generate_token_for_token(flagship):
    jm, params, tm = flagship
    img, prompt = _images(seed=11), np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=8, temperature=0.0,
            cross_kv_quant="int8"))(params, jnp.asarray(img),
                                    jnp.asarray(prompt)))
    got = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=8, temperature=0.0,
                      cross_kv_quant="int8").numpy()
    np.testing.assert_array_equal(got, want)


def _beam_pair(jm, params, tm, img, prompt, **kw):
    gen = JaxBeam(jm, **kw)
    with jax.default_matmul_precision("highest"):
        jids, jsc = jax.jit(lambda p, i, d: gen(
            p, i, d, rng=jax.random.PRNGKey(0)))(params, jnp.asarray(img),
                                                 jnp.asarray(prompt))
    ids, sc = BeamSearchTokenGenerator(tm, **kw)(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    return (ids.numpy(), sc.numpy()), (np.asarray(jids), np.asarray(jsc))


@pytest.mark.parametrize("w8a8", [False, True])
def test_int8_cross_kv_greedy_beam_ids_equal_jax(flagship, w8a8):
    """Greedy beam search (consolidation 0) with int8 cross-KV, and with
    W8A8 decoder weights as well: ids equal, scores within 1e-4."""
    jm, params, tm = flagship
    p, m = (_w8a8_pair(jm, params, tm) if w8a8 else (params, tm))
    img, prompt = _images(2, 22), np.ones((2, 1), np.int32)
    (ids, sc), (jids, jsc) = _beam_pair(
        jm, p, m, img, prompt, **dict(BEAM, max_new_tokens=6,
                                      cross_kv_quant="int8"))
    assert ids.shape == (2, 3, 6)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, atol=1e-4, rtol=0)


def test_gpt2_int8_cross_kv_step_and_greedy_match_jax(pair):  # noqa: F811
    """The tiny int4 + LoRA GPT-2 captioner: the prefix-in-decode prefill
    on the exact memory, then steps on the int8 one dequantised on read
    (logits within 1e-4 relative L2 of JAX's); then W8A8 (its float
    Linears and both tables; the int4 Linears stay int4) with int8
    cross-KV: greedy ids equal."""
    jw, params, tw, _ = pair
    jm, jp, tm = jw.model, params["model"], tw.model
    img = _images(seed=5)
    ids = np.random.default_rng(6).integers(0, 512, (2, 8))
    off = tm.space_for_prompt

    def jax_steps(jp, img, ids):
        enc = jm.encoder(jp["encoder"], img)
        cache = jm.decoder.init_cache(2, off + 8, jnp.float32)
        embeds = jnp.concatenate([enc, jm.decoder.get_inputs_embeds(
            jp["decoder"], ids[:, :5])], axis=-2)
        _, cache = jax_decoder_step(jm, jp, None, cache, 0, enc,
                                    inputs_embeds=embeds)
        kv = jax_cross_kv(jm, jp, enc, quant="int8")
        out = []
        for i in range(5, 8):
            li, cache = jax_decoder_step(jm, jp, ids[:, i:i + 1], cache,
                                         off + i, enc, cross_kv=kv)
            out.append(li)
        return jnp.concatenate(out, 1)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax_steps)(jp, jnp.asarray(img),
                                             jnp.asarray(ids)))
    with torch.no_grad():
        tids = torch.from_numpy(ids)
        tenc = tm.encoder(torch.from_numpy(img))
        _, cache = prefill(tm, tenc, tids[:, :5], 8)
        kv = tm.decoder.precompute_cross_kv(tenc, quant="int8")
        got = torch.cat([decoder_step(tm, tids[:, i:i + 1], cache, off + i,
                                      tenc, kv)[0] for i in range(5, 8)], 1)
    assert _rel_l2(got.numpy(), want) <= 1e-4

    pq, tq = _w8a8_pair(jm, jp, tm)
    assert tq.decoder.transformer.wte.is_int8
    cross = tq.decoder.transformer.h[0].crossattention
    assert cross.q_attn.is_int8 and cross.c_proj.is_int8
    assert not cross.c_attn.is_int8       # LoRA-wrapped: never rewritten
    prompt = np.full((2, 1), 50256, np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=6, temperature=0.0,
            cross_kv_quant="int8"))(pq, jnp.asarray(img), jnp.asarray(prompt)))
    out = tq.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=6, temperature=0.0,
                      cross_kv_quant="int8").numpy()
    np.testing.assert_array_equal(out, ref)


def test_gpt2_int8_cross_kv_greedy_and_beam_equal_jax(pair):  # noqa: F811
    """The tiny GPT-2 captioner with int8 cross-KV alone (float weights):
    greedy ``generate`` ids, and greedy beam search ids (width 3,
    expansion 4, consolidation 0) with scores within 1e-4, equal to
    JAX's."""
    jw, params, tw, _ = pair
    jm, jp, tm = jw.model, params["model"], tw.model
    img, prompt = _images(seed=9), np.full((2, 1), 50256, np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=6, temperature=0.0,
            cross_kv_quant="int8"))(jp, jnp.asarray(img), jnp.asarray(prompt)))
    out = tm.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=6, temperature=0.0,
                      cross_kv_quant="int8").numpy()
    np.testing.assert_array_equal(out, ref)
    (ids, sc), (jids, jsc) = _beam_pair(
        jm, jp, tm, img, prompt, **dict(BEAM, max_new_tokens=6,
                                        cross_kv_quant="int8"))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, atol=1e-4, rtol=0)


# -- W8A8 decoder weights + int8 cross-KV -----------------------------------

class _AlignedQuantization:
    """Runs the port with JAX's activation roundings.  ``record`` wraps
    JAX's ``quantize_rows_int8`` (the activations of every W8A8 product,
    in call order, in an eager JAX forward); ``replay`` wraps the port's:
    each call takes JAX's int8 values and scales for the same activations
    (same shape, same order), and counts where the port's own rounding
    took the other quantum, with the distance of the port's value from
    the half-quantum boundary it crossed (in quanta).  With the roundings
    aligned, the two packages differ only by f32 summation order."""

    def __init__(self, monkeypatch):
        self.mp, self.calls, self.flips, self.margins = monkeypatch, [], 0, []

    @contextlib.contextmanager
    def record(self):
        orig = jmod.quantize_rows_int8

        def rec(t):
            q, sc = orig(t)
            self.calls.append((np.asarray(q), np.asarray(sc)))
            return q, sc

        with self.mp.context() as mp:
            mp.setattr(jmod, "quantize_rows_int8", rec)
            yield

    @contextlib.contextmanager
    def replay(self):
        orig, calls = tmod.quantize_rows_int8, iter(self.calls)

        def rep(t):
            q, sc = orig(t)
            jq, jsc = next(calls)
            assert tuple(q.shape) == jq.shape
            differ = q.numpy() != jq
            if differ.any():
                y = (t.float() / sc[..., None]).numpy()[differ]
                self.flips += int(differ.sum())
                self.margins.extend(np.abs(np.abs(y - np.floor(y)) - 0.5))
            return torch.from_numpy(jq.copy()), torch.from_numpy(jsc.copy())

        with self.mp.context() as mp:
            mp.setattr(tmod, "quantize_rows_int8", rep)
            yield
        assert next(calls, None) is None, "JAX quantized more activations"

def _hold_own_run(own, want, aligned):
    """The port's own (unaligned) logits: at most one activation in 10,000
    took the other quantum, and each flip may move the logits by 2.5e-3
    relative L2 beyond the 1e-3 bound, 1e-2 at most."""
    n = sum(q.size for q, _ in aligned.calls)
    assert aligned.flips <= max(1, n // 10_000), (aligned.flips, n)
    limit = min(1e-2, 1e-3 + 2.5e-3 * aligned.flips)
    assert _rel_l2(own, want) <= limit, (_rel_l2(own, want), aligned.flips)


@pytest.mark.parametrize("encoder", [False, True])
def test_w8a8_logits_and_greedy_tokens_match_jax(flagship, encoder,
                                                 monkeypatch):
    """W8A8 at min_elems 1 (every 2-D Linear and Embedding weight of the
    subtree) with int8 cross-KV.  The full forward's logits within 1e-3
    relative L2 of JAX's, a cached step's likewise, greedy tokens of
    generate equal.  With the encoder in W8A8 too, the port's encoder
    blocks take the module path, not the block kernel (JAX's gate declines
    W8A8 forms), and its front the module chain.

    An activation on a rounding boundary may take the other quantum in
    one package (f32 sums in another order put it a hair either side of
    k + 0.5), and the error it leaves grows through every later W8A8
    product: with the encoder in W8A8 the unaligned logits part from
    JAX's by more than the bound (relative L2 0.0039 on these inputs, two
    activations of the projector's 262,144 flipped).  So the bound is held
    with the two packages' roundings aligned (the port replays JAX's int8
    activations, ``_AlignedQuantization``), and every rounding where the
    port on its own took the other quantum must lie within 1e-3 quanta of
    its half-quantum boundary: that margin is what explains the parting.

    The port's own run is held too (``_hold_own_run``): at most one
    activation in 10,000 flipped, and its logits within
    ``min(1e-2, 1e-3 + 2.5e-3 · flips)`` relative L2 of JAX's.  Readings
    on these inputs (full forward; cached step): decoder alone, 1 flip of
    30,976 and 6.7e-8, 0 of 4,352 and 4.8e-8; with the encoder, 2 of
    368,384 and 0.0039, 9 of 341,760 and 0.0032."""
    jm, params, tm = flagship
    pq, tq = _w8a8_pair(jm, params, tm, encoder=encoder)
    assert all(not blk.plain_weights for blk in tq.decoder.blocks)
    assert all(blk.plain_weights != encoder
               for blk in tq.vision_encoder.blocks)
    img = _images(seed=7)
    ids = np.random.default_rng(8).integers(0, 512, (2, 10))
    aligned = _AlignedQuantization(monkeypatch)
    with jax.default_matmul_precision("highest"), aligned.record():
        want = np.asarray(jm(pq, jnp.asarray(img), jnp.asarray(ids)).logits)
    with torch.no_grad():
        own = tq(torch.from_numpy(img), torch.from_numpy(ids)).logits.numpy()
        with aligned.replay():
            got = tq(torch.from_numpy(img),
                     torch.from_numpy(ids)).logits.numpy()
    assert len(aligned.calls) > 10
    assert _rel_l2(got, want) <= 1e-3
    assert max(aligned.margins, default=0.0) <= 1e-3, aligned.margins
    _hold_own_run(own, want, aligned)
    step = _AlignedQuantization(monkeypatch)
    got, want = _cached_step(jm, params, tm, tq, pq, "int8", aligned=step)
    assert _rel_l2(got, want) <= 1e-3
    assert max(step.margins, default=0.0) <= 1e-3, step.margins
    own, _ = _cached_step(jm, params, tm, tq, pq, "int8")
    _hold_own_run(own, want, step)
    prompt = np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=8, temperature=0.0,
            cross_kv_quant="int8"))(pq, jnp.asarray(img), jnp.asarray(prompt)))
    out = tq.generate(torch.from_numpy(img), torch.from_numpy(prompt).long(),
                      max_new_tokens=8, temperature=0.0,
                      cross_kv_quant="int8").numpy()
    np.testing.assert_array_equal(out, ref)


def test_w8a8_never_feeds_the_kernels_an_int8_form(flagship):
    """The eval kernels' operands (``_Cached``) are dropped by the
    transform and never built from an int8 form: a W8A8 encoder block
    answers ``plain_weights`` False and its MoE FFN runs the module path;
    a float one keeps its kernel operands."""
    _, _, tm = flagship
    tq = copy.deepcopy(tm)
    blk = tq.vision_encoder.blocks[0]
    with torch.no_grad():
        tq.encoder(torch.from_numpy(_images()))
    assert blk._weights._value is not None and blk.plain_weights
    int8_serving_params(tq.encoder, min_elems=1)
    assert blk._weights._value is None and not blk.plain_weights
    assert not blk.mlp.plain_weights
    calls = []
    from image2text_torch.models import layers
    orig = layers.moe_ffn
    layers.moe_ffn = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            tq.encoder(torch.from_numpy(_images()))
    finally:
        layers.moe_ffn = orig
    assert not calls and blk._weights._value is None


# -- approximate top-k --------------------------------------------------------

def _ids(b=4, l=24, cur=20, vocab=12, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, l))
    ids[:, cur:] = 0
    return ids.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_approx_top_k_sampling_equals_jax_with_the_same_noise(seed):
    """JAX's approx pull on the CPU is the exact top-k, and the port takes
    the flag as exact: with JAX's Gumbel noise fed to the port, the fused
    n-gram sampler and ``sample_logits`` draw the same ids; greedy ignores
    the flag."""
    b, v, k, cur = 4, 300, 16, 20
    ids = _ids(cur=cur, seed=seed)
    rng = np.random.default_rng(20 + seed)
    logits = rng.standard_normal((b, v)).astype(np.float32)
    logits[:, :12] += 3.0
    key = jax.random.PRNGKey(seed)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (b, k),
                                                        jnp.float32)))
    ref = js.sample_topk_with_ngram(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(cur), NGRAMS, key, 0.7, k,
                                    approx=True)
    out = ts.sample_topk_with_ngram(torch.from_numpy(logits),
                                    torch.from_numpy(ids).long(), cur,
                                    NGRAMS, None, 0.7, k, gumbel=noise,
                                    approx=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = js.sample_logits(jnp.asarray(logits), key, 0.7, k, approx=True)
    out = ts.sample_logits(torch.from_numpy(logits), None, 0.7, k,
                           gumbel=noise, approx=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = js.sample_topk_with_ngram(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(cur), NGRAMS, key, 0.0, None,
                                    approx=True)
    out = ts.sample_topk_with_ngram(torch.from_numpy(logits),
                                    torch.from_numpy(ids).long(), cur,
                                    NGRAMS, None, 0.0, None, approx=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_approx_top_k_generate_equals_exact(flagship):
    """In the port the flag changes nothing: greedy and sampled (the same
    generator seed) ids equal the exact mode's, and greedy equals JAX's
    approx-mode ids."""
    jm, params, tm = flagship
    img, prompt = _images(seed=12), np.ones((2, 1), np.int32)
    timg, tprompt = torch.from_numpy(img), torch.from_numpy(prompt).long()
    for kw in (dict(temperature=0.0), dict(temperature=0.7, top_k=16)):
        runs = [tm.generate(timg, tprompt, max_new_tokens=8,
                            generator=torch.Generator().manual_seed(5),
                            approx_top_k=approx, **kw)
                for approx in (False, True)]
        assert torch.equal(*runs)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, i, pr: jm.generate(
            p, i, pr, max_new_tokens=8, temperature=0.0,
            approx_top_k=True))(params, jnp.asarray(img), jnp.asarray(prompt)))
    got = tm.generate(timg, tprompt, max_new_tokens=8, temperature=0.0,
                      approx_top_k=True)
    np.testing.assert_array_equal(got.numpy(), want)
