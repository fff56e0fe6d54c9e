"""The pretrained-ViT family's modules in the port against the JAX
package's, module by module, on the CPU: the ViT-B/16 backbone (also
against the torchvision-layout oracle, ``tests/vit_oracle.py``), the
positional MLP, PEER, the LSH embeddings, the three ``PretrainedViT``
heads, multi-head self-attention, the GPT-2 weight surgery and the
ImageNet preprocessing of ``caption``.  Weights cross from JAX by
``export_state_dict`` → ``load_jax_state_dict``; inputs come from numpy
seeds; f32, JAX at full matmul precision, unless a case says bf16.  The
backbone keeps its width, 768 (every head takes it), at depth 2 and 32²
images.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.configs import models as jcm
from image2text_tpu.models import encoder as jenc
from image2text_tpu.models import layers as jlayers
from image2text_tpu.models.decoder import TransformerDecoder as JDecoder
from image2text_tpu.models.hf_import import (
    import_gpt2_state_dict as jax_import_gpt2)
from image2text_tpu.models.vit import VisionTransformerB16 as JViT
from image2text_tpu.ops.preprocess import (
    resize_normalize_on_device as jax_preprocess)
from image2text_tpu.training.data import IMAGENET_MEAN, IMAGENET_STD
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs import models as tcm
from image2text_torch.models import encoder as tenc
from image2text_torch.models import layers as tlayers
from image2text_torch.models.decoder import TransformerDecoder
from image2text_torch.models.hf_import import (import_gpt2_state_dict,
                                               load_pretrained_gpt2_params)
from image2text_torch.models.kv_cache import CacheRef, KVCache
from image2text_torch.models.vit import (VisionTransformerB16,
                                         import_torchvision_vit_state_dict)
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.ops import preprocess as tpre
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               state_dict_numpy)
from torch_nano_pairs import gpt2_state_dict

torch.set_num_threads(2)
VIT_TINY = dict(image_size=32, num_layers=2)   # width 768, 12 heads
ATOL, RTOL = 2e-4, 1e-4   # f32, through two 768-wide blocks


def _carry(jmod, tmod, seed=0, init=None):
    """JAX params of ``jmod`` (``init(params)`` may edit them), loaded into
    ``tmod``; returns (params, the exported state dict)."""
    params = jmod.init(jax.random.PRNGKey(seed))
    if init is not None:
        params = init(params)
    sd = export_state_dict(jmod, params)
    load_jax_state_dict(tmod, sd)
    return params, sd


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jax(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _port(fn, *args):
    with torch.no_grad():
        return fn(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()


# -- the backbone --------------------------------------------------------------

def test_vit_backbone_matches_jax():
    jm, tm = JViT(**VIT_TINY), VisionTransformerB16(**VIT_TINY, device="cpu")
    params, sd = _carry(jm, tm, init=lambda p: {
        **p, "class_token": jnp.asarray(_normal((1, 1, 768), 5, 0.02))})
    assert set(state_dict_numpy(tm)) == set(sd)
    img = _normal((2, 3, 32, 32), 1)
    ref = _jax(lambda x: jm(params, x), img)
    out = _port(tm, img)
    assert out.shape == (2, 768)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def _oracle():
    from vit_oracle import VisionTransformerOracle

    with torch.random.fork_rng():
        torch.manual_seed(0)
        return VisionTransformerOracle(image_size=32, patch_size=16,
                                       num_layers=2, num_heads=12,
                                       hidden_dim=768, mlp_dim=3072).eval()


def test_vit_imports_the_torchvision_layout():
    """A torchvision-layout state dict loads one to one (``heads.*``
    skipped) and the port's output equals the oracle's."""
    oracle = _oracle()
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    tm = VisionTransformerB16(**VIT_TINY, device="cpu")
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    import_torchvision_vit_state_dict(
        tm, {**sd, "heads.head.weight": np.zeros((10, 768), np.float32)})
    img = _normal((2, 3, 32, 32), 2)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(_port(tm, img), ref, atol=ATOL, rtol=RTOL)


def test_vit_import_rejects_unknown_keys_and_shapes():
    tm = VisionTransformerB16(**VIT_TINY, device="cpu")
    with pytest.raises(KeyError):
        import_torchvision_vit_state_dict(tm, {"nope.weight": np.zeros(1)})
    with pytest.raises(ValueError):
        import_torchvision_vit_state_dict(
            tm, {"class_token": np.zeros((1, 1, 32), np.float32)})


# -- the positional MLP --------------------------------------------------------

@pytest.mark.parametrize("widths", [(8, 12, (16, 4)), (8, 8, (32, 128, 32))])
def test_positional_mlp_forward_and_forward_at_match_jax(widths):
    """``forward`` on the first t positions, ``forward_at`` on a
    contiguous run (a slice) and on scattered positions (an index), and
    the split checkpoint keys, with and without the residual projection."""
    fin, fout, gates = widths
    jm = jlayers.AdvancedPositionalBiasMLP(6, fin, fout, gates)
    tm = tlayers.AdvancedPositionalBiasMLP(6, fin, fout, gates,
                                           device="cpu")
    params, sd = _carry(jm, tm)
    n = len(gates) + 1
    want = {f"models.{i}.model.{2 * j}.{w}" for i in range(6)
            for j in range(n) for w in ("weight", "bias")}
    if fin != fout:
        want |= {f"models.{i}.residual_connector.{w}" for i in range(6)
                 for w in ("weight", "bias")}
    assert set(sd) == want == set(state_dict_numpy(tm))
    x = _normal((2, 5, fin), 3)
    np.testing.assert_allclose(_port(tm, x), _jax(
        lambda a: jm(params, a), x), atol=1e-5, rtol=1e-5)
    for pos in ([3], [2, 3, 4], [1, 2, 5]):
        xp = x[:, :len(pos)]
        ref = _jax(lambda a: jm.forward_at(params, a, jnp.asarray(pos)), xp)
        with torch.no_grad():
            out = tm.forward_at(torch.from_numpy(xp), np.asarray(pos))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


# -- PEER ----------------------------------------------------------------------

PEER = dict(in_features=16, out_features=12, num_units=64, topk=4, nhead=2,
            query_dim=8)


def test_peer_matches_jax():
    jm = jlayers.PeerLookup(**PEER)
    tm = tlayers.PeerLookup(**PEER, device="cpu")
    params, _ = _carry(jm, tm)
    x = _normal((3, 2, 16), 4)
    np.testing.assert_allclose(_port(tm, x), _jax(lambda a: jm(params, a), x),
                               atol=1e-5, rtol=1e-5)


def _tied(params):
    """Both query units' scorers with every row repeated (units 2i and
    2i + 1 score alike, exactly), so top-k meets ties at every level."""
    for side in ("query_left", "query_right"):
        w = np.asarray(params[side]["linear"]["weight"])
        params[side]["linear"]["weight"] = jnp.asarray(np.repeat(
            w[::2], 2, axis=0))
    return params


def test_peer_bf16_ties_take_lax_top_k_choice():
    """In bf16 with scores built to tie, the port's three top-ks pick the
    expert rows ``lax.top_k`` picks (lowest index first), so the composite
    indices (``left * topk + right``, the reference's radix) and the
    output agree with JAX's."""
    jm = jlayers.PeerLookup(**PEER)
    tm = tlayers.PeerLookup(**PEER, device="cpu")
    params, _ = _carry(jm, tm, init=_tied)
    tm.to(torch.bfloat16)
    x = _normal((3, 2, 16), 6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        q = tm.query_linear(xb).reshape(3, 2, 2, 8)
        scores, idx = tm.expert_indices(q)
        out = tm(xb).float().numpy()
    bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    qj = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    lv, li = jax.lax.top_k(jm.query_left.linear(bf["query_left"]["linear"],
                                                qj), 4)
    rv, ri = jax.lax.top_k(jm.query_right.linear(
        bf["query_right"]["linear"], qj), 4)
    assert bool((lv[..., :-1] == lv[..., 1:]).any())   # ties were met
    dot, sel = jax.lax.top_k(
        (lv[..., :, None] + rv[..., None, :]).reshape(3, 2, 2, 16), 4)
    want = (np.take_along_axis(np.asarray(li), np.asarray(sel) // 4, -1) * 4
            + np.take_along_axis(np.asarray(ri), np.asarray(sel) % 4, -1))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        scores.float().numpy(),
        np.asarray(jax.nn.softmax(dot.astype(jnp.float32), -1)
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    ref = np.asarray(jm(bf, jnp.asarray(x).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    np.testing.assert_allclose(out, ref, atol=0.05, rtol=0.02)


# -- LSH -----------------------------------------------------------------------

def test_lsh_buffers_equal_jax_bit_for_bit():
    for seed, bins in ((0, 4), (3002, 20)):
        jm = jlayers.CosineVectorEmbedding(768, 16, 32, bins, seed=seed)
        tm = tlayers.CosineVectorEmbedding(768, 16, 32, bins, seed=seed,
                                           device="cpu")
        for name, value in jm._buffers.items():
            got = getattr(tm, name).numpy()
            assert got.shape == value.shape and got.dtype == value.dtype
            np.testing.assert_array_equal(got, value)


def test_lsh_buffers_take_the_serving_cast_as_jax():
    """The serving cast (JAX ``bench.py`` casts every floating leaf to
    bf16; the port ``model.to(bfloat16)``) rounds ``grid`` and
    ``projection_mat`` alike and leaves ``pos_offset`` an integer, so the
    bins are taken on the same bf16 grid."""
    jm = jlayers.CosineVectorEmbedding(768, 8, 32, 20, seed=2)
    tm = tlayers.CosineVectorEmbedding(768, 8, 32, 20, seed=2, device="cpu")
    tm.to(torch.bfloat16)
    for name, value in jm._buffers.items():
        got = getattr(tm, name)
        if np.issubdtype(value.dtype, np.floating):
            want = jnp.asarray(value).astype(jnp.bfloat16).astype(jnp.float32)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want))
        else:
            assert not got.is_floating_point()
            np.testing.assert_array_equal(got.numpy(), value)


@pytest.mark.parametrize("learnable", [False, True])
def test_composite_lsh_matches_jax(learnable):
    jm = jlayers.CompositeCosineVectorEmbedding(768, 24, (4, 8, 20), 32,
                                                learnable, seed=1)
    tm = tlayers.CompositeCosineVectorEmbedding(768, 24, (4, 8, 20), 32,
                                                learnable, seed=1,
                                                device="cpu")
    params, sd = _carry(jm, tm)
    assert set(sd) == set(state_dict_numpy(tm))
    x = _normal((4, 768), 7)
    np.testing.assert_allclose(_port(tm, x), _jax(lambda a: jm(params, a), x),
                               atol=1e-5, rtol=1e-5)


def test_fixed_lsh_bins_match_jax_searchsorted():
    """The bins (``searchsorted`` left on the f32 grid), including inputs
    placed exactly on grid points."""
    jm = jlayers.CosineVectorEmbedding(768, 8, 32, 8, seed=5)
    tm = tlayers.CosineVectorEmbedding(768, 8, 32, 8, seed=5, device="cpu")
    params, _ = _carry(jm, tm)
    x = _normal((3, 2, 768), 8)
    with torch.no_grad():
        got = tm.bins(torch.from_numpy(x)).numpy()
        z = torch.tensor([[-1.0, -0.875, -0.125, 0.0, 0.125, 0.875, 1.0]])
        on_grid = torch.searchsorted(tm.grid, z).numpy()
    with jax.default_matmul_precision("highest"):
        xn = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
        zj = jnp.asarray(xn) @ params["projection_mat"]
        want = np.asarray(jnp.searchsorted(params["grid"], zj, side="left")
                          + jnp.arange(32) * 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(on_grid, np.asarray(jnp.searchsorted(
        params["grid"], jnp.asarray(z.numpy()), side="left")))


def test_learnable_lsh_top_k_matches_jax():
    jm = jlayers.LearnableCosineVectorEmbedding(768, 12, 8, 20, top_k=5)
    tm = tlayers.LearnableCosineVectorEmbedding(768, 12, 8, 20, top_k=5,
                                                device="cpu")
    params, _ = _carry(jm, tm)
    x = _normal((2, 3, 768), 9)
    np.testing.assert_allclose(_port(tm, x), _jax(lambda a: jm(params, a), x),
                               atol=1e-5, rtol=1e-5)


# -- PretrainedViT -------------------------------------------------------------

HEADS = {
    "positional_mlp": dict(n_cls=4, n_embd_out_vit=32, gate_sizes=(64,),
                           refine_base_model=False),
    "peer": dict(n_cls=2, n_embd_out_vit=24, refine_base_model=False,
                 peer=dict(num_units_sqrt=8, topk=4, nhead=2, query_dim=16)),
    "lsh": dict(n_cls=2, n_embd_out_vit=32, refine_base_model=True,
                lsh=dict(num_bins=(4, 8), num_proj=8, learnable=False)),
    "lsh_learnable": dict(n_cls=2, n_embd_out_vit=32,
                          lsh=dict(num_bins=(4, 8), num_proj=8,
                                   learnable=True)),
    "positional_mlp_refined": dict(n_cls=2, n_embd_out_vit=16,
                                   gate_sizes=(32,), refine_base_model=True),
}


def _vit_config(cm, name):
    kw = dict(HEADS[name])
    peer, lsh = kw.pop("peer", None), kw.pop("lsh", None)
    if peer:
        kw["peer_config"] = cm.PeerConfig(**peer)
    if lsh:
        kw["lsh_config"] = cm.LshConfig(**lsh)
    return cm.PretrainedViTConfig(**kw)


@pytest.fixture
def tiny_vit(monkeypatch):
    monkeypatch.setattr(jenc, "VIT_B16_ARGS", VIT_TINY)
    monkeypatch.setattr(tenc, "VIT_B16_ARGS", VIT_TINY)


@pytest.mark.parametrize("head", list(HEADS))
def test_pretrained_vit_heads_match_jax(tiny_vit, head):
    """Each head's output, the state-dict keys (the dummy ``peer_proj_wt``
    buffer on the PEER-less heads, the LSH buffers) and the frozen set:
    the backbone unless refined; always under LSH."""
    jm = jenc.Encoder.from_config(_vit_config(jcm, head))
    tm = tenc.encoder_from_config(_vit_config(tcm, head), device="cpu")
    params, sd = _carry(jm, tm, seed=3)
    assert set(state_dict_numpy(tm)) == set(sd)
    assert ("peer_proj_wt" in dict(tm.named_buffers())) == (head != "peer")
    assert sorted(frozen_param_paths(tm)) == sorted(jm.frozen_param_paths())
    assert bool(frozen_param_paths(tm)) == (head != "positional_mlp_refined")
    img = _normal((2, 3, 32, 32), 10)
    ref = _jax(lambda a: jm(params, a), img)
    out = _port(tm, img)
    assert out.shape == (2, HEADS[head]["n_cls"],
                         HEADS[head]["n_embd_out_vit"])
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_pretrained_vit_detaches_a_frozen_backbone(tiny_vit):
    tm = tenc.encoder_from_config(_vit_config(tcm, "positional_mlp"),
                                  device="cpu")
    for p in tm.parameters():
        p.requires_grad_(True)
    out = tm(torch.from_numpy(_normal((1, 3, 32, 32), 11)))
    out.sum().backward()
    assert all(p.grad is None for p in tm.model.parameters())
    assert tm.proj.w0.grad is not None


def test_encoder_lora_raises_with_its_roadmap_item():
    """LoRA on the pretrained ViT is ported (JAX ``encoder.py:54-58``): a
    spec that matches no Linear of it raises as JAX's ``apply_lora`` (and
    peft) do, one that matches wraps the backbone's Linears."""
    cfg = _vit_config(tcm, "positional_mlp")
    cfg.lora_spec = tcm.LoraSpec(target_modules=["c_attn"])
    with pytest.raises(ValueError, match="not found"):
        tenc.encoder_from_config(cfg, device="meta")
    cfg.lora_spec = tcm.LoraSpec(target_modules=["out_proj", "mlp.0"])
    enc = tenc.encoder_from_config(cfg, device="meta")
    assert any(n.endswith("self_attention.out_proj.lora_A.weight")
               for n, _ in enc.named_parameters())


# -- multi-head self-attention -------------------------------------------------

def _mha_config(cm):
    return cm.SelfAttentionConfig(attn_type=cm.SelfAttentionType.MULTI_HEAD,
                                  attn_dropout=0.0, dropout=0.0, bias=True,
                                  n_head=4, n_embd=32)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    jm = jlayers.SelfAttention.from_config(_mha_config(jcm))
    tm = tlayers.self_attention_from_config(_mha_config(tcm), device="cpu")
    assert isinstance(tm, tlayers.MultiHeadAttention)
    params, _ = _carry(jm, tm)
    x = _normal((2, 7, 32), 12)
    ref = _jax(lambda a: jm(params, a, causal=causal, use_flash=False), x)
    out = _port(lambda a: tm(a, causal=causal, use_flash=False), x)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_multi_head_attention_cached_equals_uncached():
    """Prefill 4 rows into a full-head (b, h, L, hd) cache, then 3 single
    rows: the causal uncached rows."""
    tm = tlayers.self_attention_from_config(_mha_config(tcm), device="cpu")
    _carry(jlayers.SelfAttention.from_config(_mha_config(jcm)), tm)
    x = torch.from_numpy(_normal((2, 7, 32), 13))
    cache = KVCache.create([tm.kv_shape(2, 7)], torch.float32, "cpu")
    assert cache.layers[0][0].shape == (2, 4, 7, 8)
    with torch.no_grad():
        full = tm(x, causal=True)
        rows = [tm(x[:, :4], kv_cache=CacheRef(cache))]
        rows += [tm(x[:, i:i + 1], kv_cache=CacheRef(cache))
                 for i in range(4, 7)]
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), full.numpy(),
                               atol=1e-5, rtol=1e-5)


# -- the GPT-2 weight surgery --------------------------------------------------

def _decoders(vocab=128, block=64, cross=False):
    def cfg(cm):
        return cm.TransformerDecoderConfig(
            transformer_config=cm.TransformerConfig(
                rotator_config=cm.MLPConfig(ff_mult=4.0), is_causal=True,
                is_cross_attn=cross, attn_config=_mha_config(cm)),
            n_layer=2, block_size=block, vocab_size=vocab)
    jd, td = JDecoder(cfg(jcm)), TransformerDecoder(cfg(tcm), device="cpu")
    params, _ = _carry(jd, td)
    return jd, params, td


def _wte(td):
    return td.transformer.wte.weight.detach().numpy()


def test_gpt2_import_matches_jax_logits():
    sd = gpt2_state_dict()
    jd, params, td = _decoders()
    params = jax_import_gpt2(params, sd, loose=False)
    import_gpt2_state_dict(td, sd, loose=False)
    np.testing.assert_array_equal(
        td.transformer.h[0].attn.c_attn.weight.detach().numpy(),
        sd["transformer.h.0.attn.c_attn.weight"].T)
    ids = np.random.default_rng(0).integers(0, 128, (3, 20))
    ref = _jax(lambda i: jd(params, idx=i)[0], ids)
    out = _port(lambda i: td(idx=i)[0], ids)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_gpt2_import_strict_and_loose():
    """A 32-position decoder against GPT-2's 64: strict raises, loose keeps
    the decoder's ``wpe`` and imports the rest."""
    sd = gpt2_state_dict()
    _, _, td = _decoders(block=32)
    with pytest.raises(ValueError):
        import_gpt2_state_dict(td, sd, loose=False)
    before = td.transformer.wpe.weight.detach().clone()
    import_gpt2_state_dict(td, sd, loose=True)
    assert torch.equal(td.transformer.wpe.weight, before)
    np.testing.assert_array_equal(_wte(td), sd["transformer.wte.weight"])


def test_gpt2_import_grows_the_vocabulary():
    sd = gpt2_state_dict()
    _, params, td = _decoders(vocab=130)
    before = _wte(td).copy()
    import_gpt2_state_dict(td, sd, loose=False)
    np.testing.assert_array_equal(_wte(td)[:128], sd["transformer.wte.weight"])
    np.testing.assert_array_equal(_wte(td)[128:], before[128:])


def test_gpt2_strict_import_keeps_the_cross_attention():
    sd = gpt2_state_dict()
    jd, params, td = _decoders(cross=True)
    before = td.transformer.h[0].cross_attn.in_proj_weight.detach().clone()
    import_gpt2_state_dict(td, sd, loose=False)
    params = jax_import_gpt2(params, sd, loose=False)
    assert torch.equal(td.transformer.h[0].cross_attn.in_proj_weight, before)
    mine = state_dict_numpy(td)
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)


def test_gpt2_strict_import_refuses_a_partial_state_dict():
    """The reverse check: a base parameter left unfilled raises in strict
    mode, as does an unknown key; loose mode takes both."""
    sd = gpt2_state_dict()
    del sd["transformer.h.1.mlp.c_fc.bias"]
    _, params, td = _decoders()
    with pytest.raises(ValueError, match="base params missing"):
        import_gpt2_state_dict(td, sd, loose=False)
    with pytest.raises(ValueError, match="base params missing"):
        jax_import_gpt2(params, sd, loose=False)
    extra = {**gpt2_state_dict(), "transformer.h.9.ln_1.weight": np.ones(32)}
    with pytest.raises(ValueError, match="not present"):
        import_gpt2_state_dict(td, extra, loose=False)
    import_gpt2_state_dict(td, sd, loose=True)
    import_gpt2_state_dict(td, extra, loose=True)


def test_gpt2_weights_are_never_downloaded():
    with pytest.raises(RuntimeError, match="import_gpt2_state_dict"):
        load_pretrained_gpt2_params(None, tcm.ModelType.GPT2, 50257, True)


# -- caption's preprocessing ----------------------------------------------------

def test_imagenet_preprocessing_matches_jax():
    """``resize_normalize_on_device(raw, 224, IMAGENET_MEAN, IMAGENET_STD)``
    in both packages, on raw uint8 frames of another size."""
    raw = np.random.default_rng(14).integers(0, 256, (2, 160, 240, 3),
                                             dtype=np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(raw), 224, IMAGENET_MEAN,
                                    IMAGENET_STD))
    out = tpre.resize_normalize_on_device(
        torch.from_numpy(raw), 224, tpre.IMAGENET_MEAN,
        tpre.IMAGENET_STD).numpy()
    assert out.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(tpre.IMAGENET_MEAN, np.float32),
                                  IMAGENET_MEAN)
    np.testing.assert_array_equal(np.asarray(tpre.IMAGENET_STD, np.float32),
                                  IMAGENET_STD)
