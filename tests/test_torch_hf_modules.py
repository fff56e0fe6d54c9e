"""The Llama-2, Qwen-2 and Falcon decoders' modules, their importers and the
``model_str`` / ``config.json`` dispatch, the port against the JAX package
on the CPU at tiny sizes (2 layers, width 64).

JAX weights cross by ``export_state_dict`` → ``load_jax_state_dict``; f32
is compared inside ``jax.default_matmul_precision("highest")``.  Covered:
RMSNorm and the rotary embedding; whole decoders of each attention shape
(Llama's multi-head, Qwen's grouped 4 → 2 query heads with biases, a
multi-query Llama 4 → 1, Falcon's one K/V head with parallel attention),
their logits and their KV-cached decode against the full forward; the
importers on numpy state dicts (strict and loose, vocabulary growth, tied
aliases, int4 destinations, raising where JAX raises); ``config.json``
dispatch for the four ``model_type``s; the int4 build that never allocates
a float weight; the nf4 copy bit for bit; W8A8 on a Llama with an untied
lm_head; and the MoE FFN's f32 path (``moe_ffn``'s plain version, what the
f32 kernel is held to on the card) against JAX's.
"""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.configs.models import (
    HuggingfaceDecoderConfig as JDecoderConfig, LoraSpec as JLoraSpec,
    MoEConfig as JMoEConfig)
from image2text_tpu.models import nf4 as jnf4
from image2text_tpu.models.hf_decoders import common as jcommon
from image2text_tpu.models.hf_decoders import factory as jfactory
from image2text_tpu.models.hf_decoders.falcon import import_hf_falcon as \
    jax_import_falcon
from image2text_tpu.models.hf_decoders.llama import import_hf_llama as \
    jax_import_llama
from image2text_tpu.models.layers import _MoEMLP as JaxMoEMLP
from image2text_tpu.models.quantization import (
    int8_serving_params as jax_int8_serving_params)
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs.models import (HuggingfaceDecoderConfig,
                                             LoraSpec, MoEConfig)
from image2text_torch.models import nf4
from image2text_torch.models.hf_decoders import common
from image2text_torch.models.hf_decoders import factory
from image2text_torch.models.kv_cache import CacheRef
from image2text_torch.models.layers import _MoEMLP
from image2text_torch.models.quantization import (QuantizedLinear,
                                                  int8_serving_params)
from image2text_torch.nn.modules import Linear
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)
from test_torch_serving_modes import _AlignedQuantization, _hold_own_run

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 2e-4, 1e-4

LLAMA_ID = "meta-llama/Llama-2-7b-hf"
QWEN_ID = "deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B"
FALCON_ID = "tiiuae/falcon-7b"
# (table, model_str, tiny fields, vocabulary): each attention shape
SHAPES = {
    "llama_mha": ("LLAMA_TABLE", LLAMA_ID,
                  dict(n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
                       intermediate=96), 32000),
    "qwen_gqa_4_2": ("QWEN_TABLE", QWEN_ID,
                     dict(n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
                          intermediate=96), 151936),
    "llama_mqa_4_1": ("LLAMA_TABLE", LLAMA_ID,
                      dict(n_layer=2, n_embd=64, n_head=4, n_kv_head=1,
                           intermediate=96), 32000),
    "falcon": ("FALCON_TABLE", FALCON_ID,
               dict(n_layer=2, n_embd=64, n_head=4), 65024),
}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _configs(model_str, vocab, extra=0, int4=False, lora=None, cross=False):
    kw = dict(model_str=model_str, use_cross_attn=cross, vocab_size=vocab,
              extra_tokens=extra, load_in_4bit=int4,
              prepare_for_kbit_training=int4)
    return (JDecoderConfig(**kw, lora_spec=None if lora is None
                           else JLoraSpec(**lora)),
            HuggingfaceDecoderConfig(**kw, lora_spec=None if lora is None
                                     else LoraSpec(**lora)))


def _tiny(mp, shape):
    """Patch both packages' table entry of ``shape`` to its tiny form."""
    table, key, fields, vocab = SHAPES[shape]
    for pkg in (jfactory, factory):
        t = getattr(pkg, table)
        mp.setitem(t, key, dataclasses.replace(t[key], **fields))
    return key, vocab


def _pair(shape, extra=0, int4=False, lora=None):
    """(JAX decoder, its params, the port's decoder on the same weights)."""
    with pytest.MonkeyPatch.context() as mp:
        key, vocab = _tiny(mp, shape)
        jc, tc = _configs(key, vocab, extra, int4, lora)
        jd = jfactory.build_hf_decoder(jc, load_weights=False)
        params = jd.init(KEY)
        td = factory.build_hf_decoder(tc, device="cpu")
    load_jax_state_dict(td, export_state_dict(jd, params))
    return jd, params, td


@pytest.fixture(scope="module")
def decoders():
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = _pair(shape)
        return cache[shape]
    return get


# -- the shared pieces --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """f32 statistics, the cast to the input dtype before the weight
    multiply (HF's order): bit for bit in bf16, within f32 rounding in
    f32."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jn = jcommon.RMSNorm(48, eps=1e-6)
    want = np.asarray(jn({"weight": jnp.asarray(w).astype(dtype)}, jx)
                      .astype(jnp.float32))
    tn = common.RMSNorm(48, eps=1e-6)
    tn.weight.data = torch.from_numpy(w).to(getattr(torch, dtype))
    got = tn(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta,offset", [(10000.0, 0), (1e6, 37)])
def test_rope_tables_and_rotation_match_jax(theta, offset):
    """The cos/sin tables (f32, at positions offset + t) and HF's
    rotate_half rotation of a (b, h, t, d) tensor."""
    pos = np.arange(offset, offset + 9)
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), 32, theta)
    tc, ts = common.rope_cos_sin(torch.from_numpy(pos), 32, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 32)).astype(
        np.float32)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jc, js))
    got = common.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- whole decoders of each attention shape -----------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
def test_decoder_logits_match_jax(decoders, shape):
    jd, params, td = decoders(shape)
    ids = np.random.default_rng(2).integers(0, 32000, (2, 9))
    with jax.default_matmul_precision("highest"):
        want, _ = jd(params, idx=jnp.asarray(ids), use_flash=False)
    with torch.no_grad():
        got, _ = td(idx=torch.from_numpy(ids))
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= 2e-4
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_cache_shapes_and_cached_decode_match_full_forward(decoders, shape):
    """``(b, n_kv_head, len, hd)`` caches (GQA's 2, MQA's and Falcon's 1);
    a prefill of 4 tokens then single tokens at their positions equal the
    full forward, and the gathered (beam-reordered) cache decodes the
    reordered rows."""
    jd, params, td = decoders(shape)
    n_kv = {"llama_mha": 4, "qwen_gqa_4_2": 2}.get(shape, 1)
    cache = td.init_cache(3, 8, torch.float32, "cpu")
    assert [tuple(k.shape) for k, _ in cache.layers] == [(3, n_kv, 8, 16)] * 2
    jcache = jd.init_cache(3, 8, jnp.float32)
    assert [tuple(k.shape) for k, _ in jcache.layers] == [(3, n_kv, 8, 16)] * 2
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 32000,
                                                             (3, 7)))
    with torch.no_grad():
        full, _ = td(idx=ids)
        steps = [td(idx=ids[:, :4], kv_cache=CacheRef(cache))[0]]
        for i in range(4, 6):
            steps.append(td(idx=ids[:, i:i + 1], kv_cache=CacheRef(cache),
                            pos_offset=i)[0])
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                                   full[:, :6].numpy(), atol=ATOL, rtol=RTOL)
        order = torch.tensor([2, 0, 1])
        cache.gather_batch(order)
        last = td(idx=ids[order, 6:7], kv_cache=CacheRef(cache),
                  pos_offset=6)[0]
    np.testing.assert_allclose(last[:, 0].numpy(), full[order, 6].numpy(),
                               atol=ATOL, rtol=RTOL)


def test_backbone_decoders_refuse_cross_attention():
    with pytest.MonkeyPatch.context() as mp:
        key, vocab = _tiny(mp, "llama_mha")
        jc, tc = _configs(key, vocab, cross=True)
        jd = jfactory.build_hf_decoder(jc, load_weights=False)
        td = factory.build_hf_decoder(tc, device="cpu")
    ids = np.zeros((1, 2), np.int64)
    with pytest.raises(ValueError, match="cross attention") as jerr:
        jd(jd.init(KEY), idx=jnp.asarray(ids), use_flash=False)
    with pytest.raises(ValueError, match="cross attention") as terr:
        td(idx=torch.from_numpy(ids))
    assert str(terr.value) == str(jerr.value)


def test_load_hf_weights_raises_and_names_the_importers():
    with pytest.MonkeyPatch.context() as mp:
        key, vocab = _tiny(mp, "falcon")
        td = factory.build_hf_decoder(_configs(key, vocab)[1], device="cpu")
    with pytest.raises(RuntimeError, match="import_hf_falcon"):
        factory.load_hf_weights(td)


# -- the importers on numpy state dicts ---------------------------------------

def _hf_llama_sd(arch, vocab, seed=0, bias=False, tied=False):
    """An HF ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` state dict of seeded
    normals: (out, in) Linears, ``rotary_emb.inv_freq`` buffers."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    d, hd = arch["n_embd"], arch["n_embd"] // arch["n_head"]
    kv, inter = arch["n_kv_head"] * hd, arch["intermediate"]
    sd = {"model.embed_tokens.weight": w(vocab, d),
          "model.norm.weight": 1 + w(d)}
    for i in range(arch["n_layer"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(d),
                   p + "post_attention_layernorm.weight": 1 + w(d),
                   p + "self_attn.q_proj.weight": w(d, d),
                   p + "self_attn.k_proj.weight": w(kv, d),
                   p + "self_attn.v_proj.weight": w(kv, d),
                   p + "self_attn.o_proj.weight": w(d, d),
                   p + "self_attn.rotary_emb.inv_freq": w(hd // 2),
                   p + "mlp.gate_proj.weight": w(inter, d),
                   p + "mlp.up_proj.weight": w(inter, d),
                   p + "mlp.down_proj.weight": w(d, inter)})
        if bias:
            sd.update({p + "self_attn.q_proj.bias": w(d),
                       p + "self_attn.k_proj.bias": w(kv),
                       p + "self_attn.v_proj.bias": w(kv)})
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"] if tied
                            else w(vocab, d))
    return sd


def _hf_falcon_sd(d, n_head, n_layer, vocab, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    hd = d // n_head
    sd = {"transformer.word_embeddings.weight": w(vocab, d),
          "transformer.ln_f.weight": 1 + w(d), "transformer.ln_f.bias": w(d)}
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(d),
                   p + "input_layernorm.bias": w(d),
                   p + "self_attention.query_key_value.weight":
                       w(d + 2 * hd, d),
                   p + "self_attention.dense.weight": w(d, d),
                   p + "mlp.dense_h_to_4h.weight": w(4 * d, d),
                   p + "mlp.dense_4h_to_h.weight": w(d, 4 * d)})
    sd["lm_head.weight"] = sd["transformer.word_embeddings.weight"]
    return sd


def _import_both(shape, sd, extra=0, int4=False, loose=False):
    """Import ``sd`` into a fresh JAX decoder and a fresh port decoder of
    ``shape`` (seeded, then equal weights); return both trees as numpy."""
    jd, params, td = _pair(shape, extra=extra, int4=int4)
    jimport = (jax_import_falcon if shape == "falcon" else
               lambda p, s, loose=False: jax_import_llama(
                   p, s, loose, tie_embeddings=jd.arch.tie_embeddings))
    before = state_dict_numpy(td)
    jp = jimport(params, sd, loose=loose)
    td.hf_importer(td, sd, loose=loose)
    return (export_state_dict(jd, jp), state_dict_numpy(td), before)


@pytest.mark.parametrize("shape,extra", [("llama_mha", 3), ("qwen_gqa_4_2", 0),
                                         ("falcon", 2)])
def test_importer_matches_jax_with_vocab_growth(shape, extra):
    """Strict import: every key lands where JAX puts it (the tied
    ``lm_head.weight`` into the table of Qwen and Falcon, Llama's own
    ``lm_head``; ``rotary_emb.inv_freq`` skipped); the extra tokens' rows
    keep their own values in both tables."""
    _, fields, vocab = SHAPES[shape][1:]
    if shape == "falcon":
        sd = _hf_falcon_sd(64, 4, 2, vocab)
    else:
        sd = _hf_llama_sd(fields, vocab, bias=shape == "qwen_gqa_4_2",
                          tied=shape == "qwen_gqa_4_2")
    want, got, before = _import_both(shape, sd, extra=extra)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    table = ("transformer.word_embeddings.weight" if shape == "falcon"
             else "model.embed_tokens.weight")
    assert got[table].shape[0] == vocab + extra
    np.testing.assert_array_equal(got[table][:vocab],
                                  sd["lm_head.weight"] if shape != "llama_mha"
                                  else sd[table])
    np.testing.assert_array_equal(got[table][vocab:], before[table][vocab:])
    if shape == "llama_mha":
        np.testing.assert_array_equal(got["lm_head.weight"][:vocab],
                                      sd["lm_head.weight"])


def test_importer_quantizes_into_int4_destinations_like_jax():
    """Under ``load_in_4bit`` every decoder Linear is int4: the float
    weights quantize on import to JAX's packed bytes and scales."""
    fields, vocab = SHAPES["llama_mha"][2:]
    sd = _hf_llama_sd(fields, vocab, seed=5)
    want, got, _ = _import_both("llama_mha", sd, int4=True)
    key = "model.layers.1.mlp.down_proj.weight"
    assert got[key].dtype == np.uint8 and got[key].shape == (64, 64)  # 96 → 128
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fault", ["unknown_key", "shape"])
def test_importer_raises_where_jax_raises_and_loose_skips(fault):
    """A key the decoder lacks, or a weight of another shape: strict raises
    in both packages with the same message; loose skips it in both and
    imports the rest."""
    fields, vocab = SHAPES["llama_mha"][2:]
    sd = _hf_llama_sd(fields, vocab, seed=6)
    if fault == "unknown_key":
        sd["model.layers.0.mlp.extra.weight"] = np.zeros((2, 2), np.float32)
    else:
        sd["model.layers.0.mlp.up_proj.weight"] = np.zeros((95, 64),
                                                           np.float32)
    with pytest.raises(ValueError) as jerr:
        _import_both("llama_mha", sd)
    jd, params, td = _pair("llama_mha")
    with pytest.raises(ValueError) as terr:
        td.hf_importer(td, sd)
    assert str(terr.value) == str(jerr.value)
    want, got, before = _import_both("llama_mha", sd, loose=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["model.layers.1.mlp.up_proj.weight"],
                                  sd["model.layers.1.mlp.up_proj.weight"])


# -- config.json dispatch ------------------------------------------------------

CONFIG_JSONS = {
    "gpt2": {"model_type": "gpt2", "n_layer": 2, "n_embd": 32, "n_head": 2,
             "n_positions": 64, "vocab_size": 96},
    "llama": {"model_type": "llama", "num_hidden_layers": 2,
              "hidden_size": 32, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 64,
              "vocab_size": 96, "max_position_embeddings": 128,
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
              "tie_word_embeddings": False},
    "qwen2": {"model_type": "qwen2", "num_hidden_layers": 2,
              "hidden_size": 48, "num_attention_heads": 6,
              "num_key_value_heads": 2, "intermediate_size": 64,
              "vocab_size": 96, "max_position_embeddings": 256,
              "rms_norm_eps": 1e-6, "rope_theta": 1e6,
              "tie_word_embeddings": True},
    "falcon": {"model_type": "falcon", "num_hidden_layers": 2,
               "hidden_size": 32, "num_attention_heads": 4,
               "vocab_size": 65024, "multi_query": True,
               "layer_norm_epsilon": 1e-5},
}


@pytest.mark.parametrize("family", list(CONFIG_JSONS))
@pytest.mark.parametrize("as_file", [False, True])
def test_config_json_dispatch_matches_jax(tmp_path, family, as_file):
    """A local checkpoint directory (or its config.json itself) builds the
    family its ``model_type`` names, with JAX's architecture (GPT-2's
    ``n_positions`` as its block size), its parameter tree and its logits
    on the same weights."""
    d = tmp_path / f"{family}-ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(CONFIG_JSONS[family]))
    path = str(d / "config.json") if as_file else str(d)
    vocab = CONFIG_JSONS[family]["vocab_size"]
    jc, tc = _configs(path, vocab)
    jfam, jarch = jfactory.arch_from_hf_config(CONFIG_JSONS[family])
    tfam, tarch = factory.arch_from_hf_config(CONFIG_JSONS[family])
    assert tfam == jfam
    assert (tarch if isinstance(tarch, dict)
            else dataclasses.asdict(tarch)) == (
                jarch if isinstance(jarch, dict)
                else dataclasses.asdict(jarch))
    jd = jfactory.build_hf_decoder(jc, load_weights=False)
    td = factory.build_hf_decoder(tc, device="cpu")
    assert type(td).__name__ == type(jd).__name__
    assert td.block_size == jd.block_size
    if family == "gpt2":
        assert td.block_size == 64
    params = jd.init(KEY)
    load_jax_state_dict(td, export_state_dict(jd, params))
    ids = np.random.default_rng(9).integers(0, 96, (2, 7))
    with jax.default_matmul_precision("highest"):
        want, _ = jd(params, idx=jnp.asarray(ids), use_flash=False)
    with torch.no_grad():
        got, _ = td(idx=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("cfg", [
    {"model_type": "falcon", "num_hidden_layers": 2, "hidden_size": 32,
     "num_attention_heads": 4, "vocab_size": 65024, "multi_query": False},
    {"model_type": "mistral", "num_hidden_layers": 2}])
def test_config_json_raises_where_jax_raises(tmp_path, cfg):
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jc, tc = _configs(str(tmp_path), 65024)
    with pytest.raises(ValueError) as jerr:
        jfactory.build_hf_decoder(jc, load_weights=False)
    with pytest.raises(ValueError) as terr:
        factory.build_hf_decoder(tc, device="meta")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("model_str", [
    "gpt2-turbo", "meta-llama/Llama-2-70b-hf", "Qwen/Qwen2-7B",
    "tiiuae/falcon-40b", "mistralai/Mistral-7B-v0.1"])
def test_unknown_model_strings_raise_with_jax_message(model_str):
    jc, tc = _configs(model_str, 200000)
    with pytest.raises(ValueError) as jerr:
        jfactory.build_hf_decoder(jc, load_weights=False)
    with pytest.raises(ValueError) as terr:
        factory.build_hf_decoder(tc, device="meta")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("model_str", sorted(
    jfactory.GPT2_TABLE) + sorted(jfactory.LLAMA_TABLE) + sorted(
        jfactory.QWEN_TABLE) + sorted(jfactory.FALCON_TABLE))
def test_every_table_id_builds_at_full_size(model_str):
    """Every id JAX builds, built by the port at full size on the meta
    device, with JAX's parameter count; shrinking the vocabulary raises
    in both."""
    vocab = (50257 if model_str.startswith("gpt2") else
             {**{k: 32000 for k in jfactory.LLAMA_TABLE},
              **{k: 151936 for k in jfactory.QWEN_TABLE},
              **{k: 65024 for k in jfactory.FALCON_TABLE}}[model_str])
    jc, tc = _configs(model_str, vocab, extra=1)
    jd = jfactory.build_hf_decoder(jc, load_weights=False)
    td = factory.build_hf_decoder(tc, device="meta")
    want = sum(int(np.prod(s.shape)) for s in jd.param_specs().values())
    assert sum(p.numel() for p in td.parameters()) == want
    jc, tc = _configs(model_str, vocab - 1)
    with pytest.raises((AssertionError, ValueError)):
        jfactory.build_hf_decoder(jc, load_weights=False)
    with pytest.raises(ValueError, match="shrink"):
        factory.build_hf_decoder(tc, device="meta")


def test_int4_build_never_allocates_a_float_weight(monkeypatch):
    """Under ``load_in_4bit`` the decoder is built on the meta device and
    its Linears become int4 on the target device: no float weight of a
    quantized Linear is ever allocated (a 13B model's would take 51 GB);
    the cross-attention Linears stay float; LoRA wraps the int4 bases."""
    from image2text_torch.nn import modules

    made = []
    orig = modules.new_param

    def record(module, name, shape, init, device=None):
        made.append((type(module).__name__, name, tuple(shape),
                     torch.device(device or "cpu").type))
        return orig(module, name, shape, init, device)

    monkeypatch.setattr(modules, "new_param", record)
    monkeypatch.setitem(factory.GPT2_TABLE, "gpt2",
                        dict(n_layer=2, n_embd=64, n_head=4))
    lora = dict(r=4, lora_alpha=8, lora_dropout=0.0,
                target_modules=["c_attn", "mlp.c_fc"])
    tc = _configs("gpt2", 50257, int4=True, lora=lora, cross=True)[1]
    td = factory.build_hf_decoder(tc, device="cpu")
    linear_weights = [m for m in made if m[0] == "Linear" and m[1] == "weight"]
    assert linear_weights and all(dev == "meta"
                                  for *_, dev in linear_weights)
    n_float = sum(isinstance(m, Linear) for name, m in td.named_modules()
                  if "crossattention" not in name)
    assert n_float == 0
    blk = td.blocks[0]
    assert isinstance(blk.attn.c_attn, QuantizedLinear)
    assert hasattr(blk.attn.c_attn, "lora_A")
    assert type(blk.crossattention.q_attn) is Linear
    assert not isinstance(blk.crossattention.c_attn, QuantizedLinear)
    assert all(not t.is_meta for t in td.parameters())
    assert all(not t.is_meta for t in td.buffers())


# -- nf4 ----------------------------------------------------------------------

@pytest.mark.parametrize("double_quant", [False, True])
def test_nf4_copy_bit_equal_to_jax(double_quant):
    w = np.random.default_rng(10).standard_normal((24, 100)).astype(
        np.float32)
    got, want = nf4.quantize_nf4(w, double_quant), jnf4.quantize_nf4(
        w, double_quant)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(nf4.dequantize_nf4(got["weight"], got,
                                                     w.shape),
                                  jnf4.dequantize_nf4(want["weight"], want,
                                                      w.shape))


def test_nf4_state_dict_conversion_feeds_import_hf_llama():
    """A bitsandbytes-layout state dict (every Linear of a tiny Llama in
    nf4 with double quantization) converts bit for bit as JAX's does and
    imports into both packages' int4 decoders alike; a missing shape
    raises in both."""
    fields, vocab = SHAPES["llama_mha"][2:]
    plain = _hf_llama_sd(fields, vocab, seed=11)
    bnb, shapes = {}, {}
    for k, v in plain.items():
        if k.endswith("proj.weight"):
            base = k[:-len(".weight")] + ".weight"
            for part, arr in nf4.quantize_nf4(v, double_quant=True).items():
                bnb[base if part == "weight" else f"{base}.{part}"] = arr
            shapes[base] = v.shape
        else:
            bnb[k] = v
    got = nf4.convert_bnb_nf4_state_dict(bnb, shapes)
    want = jnf4.convert_bnb_nf4_state_dict(bnb, shapes)
    assert set(got) == set(want) == set(plain)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtree, ttree, _ = _import_both("llama_mha", got, int4=True)
    for k in jtree:
        np.testing.assert_array_equal(ttree[k], jtree[k], err_msg=k)
    del shapes["model.layers.0.mlp.up_proj.weight"]
    for mod in (nf4, jnf4):
        with pytest.raises(ValueError, match="original shape"):
            mod.convert_bnb_nf4_state_dict(bnb, shapes)


# -- W8A8 ---------------------------------------------------------------------

def test_w8a8_llama_with_untied_lm_head_matches_jax(decoders, monkeypatch):
    """``int8_serving_params`` on the Llama decoder (min_elems 1): the same
    modules take their int8 form bit for bit (the table, the untied
    ``lm_head``, every projection); the W8A8 logits within 1e-3 relative
    L2 of JAX's with JAX's activation roundings replayed, the port's own
    run held as ``test_torch_serving_modes`` holds it."""
    jd, params, td = decoders("llama_mha")
    jq = jax_int8_serving_params(jd, params, min_elems=1)
    tq = copy.deepcopy(td)
    int8_serving_params(tq, min_elems=1)
    jflat = {k: np.asarray(v) for k, v in flatten(jq).items()}
    tflat = state_dict_numpy(tq)
    for key in ("lm_head", "model.embed_tokens",
                "model.layers.0.self_attn.q_proj", "model.layers.1.mlp.up_proj"):
        for leaf in ("qweight", "qscale"):
            np.testing.assert_array_equal(tflat[f"{key}.{leaf}"],
                                          jflat[f"{key}.{leaf}"], err_msg=key)
    assert {k for k in tflat if k.endswith(".qweight")} == {
        k for k in jflat if k.endswith(".qweight")}
    ids = np.random.default_rng(12).integers(0, 32000, (2, 10))
    aligned = _AlignedQuantization(monkeypatch)
    with jax.default_matmul_precision("highest"), aligned.record():
        want = np.asarray(jd(jq, idx=jnp.asarray(ids), use_flash=False)[0])
    with torch.no_grad():
        own = tq(idx=torch.from_numpy(ids))[0].numpy()
        with aligned.replay():
            got = tq(idx=torch.from_numpy(ids))[0].numpy()
    assert len(aligned.calls) > 10
    assert _rel_l2(got, want) <= 1e-3
    assert max(aligned.margins, default=0.0) <= 1e-3, aligned.margins
    _hold_own_run(own, want, aligned)


# -- the MoE FFN's f32 path ------------------------------------------------------

def test_moe_ffn_f32_path_matches_jax():
    """nano-mini's FFN (4 experts of rank 16, a 32-wide gate, top 2, 2x
    hidden) at a tiny width in f32: the port's eval MoE FFN (``moe_ffn``'s
    plain version on the CPU, the reference the card's f32 kernel is held
    to) against JAX's f32 path (its XLA composition: its kernel gate
    declines f32)."""
    kw = dict(num_experts=4, proj_features=16, gate_sizes=(32,),
              ff_mult_factor=2.0, top_k=2)
    jm = JaxMoEMLP(64, True, 0.0, JMoEConfig(**kw))
    params = jm.init(KEY)
    tm = _MoEMLP(64, True, MoEConfig(**kw), device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    x = np.random.default_rng(13).standard_normal((3, 7, 64)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
