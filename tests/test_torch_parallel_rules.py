"""The mesh's pure functions against the JAX package's
(``image2text_torch/parallel/`` vs ``image2text_tpu/parallel/``): the
placement rules on every parameter path of six configurations' tiny
forms, the sequence-parallel tags, the mesh arithmetic and the rows a rank
takes, and the dropout keep mask of a rank's slice of the batch and heads.
No processes."""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.configs.trainer import MeshConfig as JMeshConfig
from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.ops.flash_attention import (
    dropout_keep_mask as jax_keep_mask)
from image2text_tpu.parallel import sharding_rules as jrules
from image2text_tpu.parallel.mesh import make_mesh as jax_make_mesh

from image2text_torch.configs.models import flagship_config
from image2text_torch.configs.reader import load_training_config
from image2text_torch.configs.trainer import MeshConfig
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
from image2text_torch.nn.core import Ctx, dropout
from image2text_torch.ops import flash_attention as fa
from image2text_torch.parallel import sharding_rules as rules
from image2text_torch.parallel.mesh import (Mesh, batch_rows, make_mesh,
                                            shard_batch)

import torch_hf_pairs as hf
import torch_nano_pairs as nano

CASES = ("flagship", "nano-mini", "gpt2", "llama13b", "qwen", "falcon7b")


def _models(name):
    """(the port's model, the JAX model) of a tiny form, unbuilt weights."""
    if name == "flagship":
        return (VisionEncoderDecoder(flagship_config(tiny=True),
                                     device="cpu"),
                JaxModel(_flagship_config(tiny=True).model))
    pairs = nano if name in nano.CONFIGS else hf
    with pairs.patched():
        path = pairs.CONFIGS[name]
        with open(path) as f:
            jcfg = pairs.cut(JTrainingConfig.model_validate(
                yaml.safe_load(f)), name)
        tcfg = pairs.cut(load_training_config(path), name)
        return VisionEncoderDecoder(tcfg, device="meta"), JaxModel(jcfg)


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    return request.param, *_models(request.param)


def _jspec(path, shape, tp):
    return tuple(jrules._spec_for(path, shape, tp))


def _row_of(mods, group):
    """The row-split Linear of a group (None where it has none)."""
    for mpath, m in mods.items():
        if mpath.rpartition(".")[0] == group and \
                rules._rule(f"{mpath}.weight") == "row":
            return m
    return None


def _documented(model, path, tp) -> bool:
    """Whether the port may replicate ``path`` where JAX splits it: the
    module docstring's cases 2 and 3 (an int4 row split with no exact
    shard keeps its group whole)."""
    import fnmatch

    mods = dict(model.named_modules())
    owner_path, _, name = path.rpartition(".")
    group = rules._group_of(owner_path, name)
    row = _row_of(mods, group)
    pairs = 1
    if row is not None and rules._is_int4(row):
        if not rules.int4_splits_exactly(row, tp):
            return True
        pairs = 2
    wpath = path[:-len("bias")] + "weight" if path.endswith("bias") else path
    if any(fnmatch.fnmatch(wpath, p) for p in rules.UNSECTIONED):
        return True
    attn = mods.get(group)
    hd = rules._head_dim(attn) if attn is not None else None
    if hd is None:
        return False
    p = dict(rules._tensors_of(model))[path]
    rows = p.shape[0] // (rules.sections_of(path) * pairs)
    return ((rows // tp) % hd != 0
            or rules._grouped_kv_replicated(attn, tp * pairs))


def _follows_base(model, path, specs) -> bool:
    """Whether the port may split ``path`` where JAX replicates it: an
    int4 Linear's scales, or a LoRA adapter, carried with its split base
    (module docstring, 3)."""
    owner_path, _, name = path.rpartition(".")
    mods = dict(model.named_modules())
    if name == "weight_scales" and rules._is_int4(mods[owner_path]):
        return specs[f"{owner_path}.weight"] != rules.REPLICATED
    a = rules._adapter(path)
    return a is not None and specs[f"{a[0]}.weight"] != rules.REPLICATED


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_specs_are_jaxs_but_for_the_documented_cases(pair, tp):
    """Every parameter path: the port's copy of the rule (``jax_spec``)
    is JAX's ``_spec_for``; the placement (``tp_param_shardings``) is
    JAX's spec, or replicated where the module docstring says why, or
    split where an int4 Linear's scales or a LoRA adapter follow their
    split base (JAX replicates both)."""
    name, tm, jm = pair
    specs = rules.tp_param_shardings(tm, tp)
    differ = []
    for path, p in tm.named_parameters():
        want = _jspec(path, tuple(p.shape), tp)
        assert rules.jax_spec(path, tuple(p.shape), tp) == want, path
        if specs[path] != want:
            if specs[path] == rules.REPLICATED:
                assert _documented(tm, path, tp), path
            else:
                assert want == rules.REPLICATED, path
                assert _follows_base(tm, path, specs), path
            differ.append(path)
    if name == "flagship" and tp == 8:   # 4 heads: 8 ranks split a head
        assert any(p.endswith("attn.q_proj.weight") for p in differ)
    if name == "flagship" and tp == 2:
        assert not differ


def test_parameter_paths_are_jaxs():
    """The port's parameter paths are JAX's tree paths (tiny flagship): the
    rules see the same names in both packages."""
    tm = VisionEncoderDecoder(flagship_config(tiny=True), device="meta")
    jm = JaxModel(_flagship_config(tiny=True).model)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    from image2text_tpu.utils.tree import flatten

    jpaths = {k: tuple(v.shape) for k, v in flatten(shapes).items()}
    mine = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert mine.items() <= jpaths.items()


def test_falcon_fused_projection_stays_whole():
    """Falcon-7B's ``query_key_value`` (71 query heads, one K and one V:
    4,672 rows): JAX splits it in two, the port replicates it; its
    ``dense`` is row-split in both."""
    qkv = "decoder.transformer.h.0.self_attention.query_key_value.weight"
    dense = "decoder.transformer.h.0.self_attention.dense.weight"
    assert _jspec(qkv, (4672, 4544), 2) == rules.COL
    assert rules.spec_for(qkv, (4672, 4544), 2, 64) == rules.REPLICATED
    assert rules.spec_for(dense, (4544, 4544), 2, 64) == rules.ROW == \
        _jspec(dense, (4544, 4544), 2)


def test_packed_projections_split_by_heads():
    """A packed [q; k; v] keeps this rank's heads of each section; a
    shard's concatenation over the ranks is the tensor again."""
    t = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3 * 8, 2)
    shards = [rules.shard(t, 0, 3, r, 2) for r in range(2)]
    assert torch.equal(shards[0][:4], t[:4])          # q heads 0-1
    assert torch.equal(shards[0][4:8], t[8:12])       # k heads 0-1
    assert torch.equal(shards[1][8:], t[20:])         # v heads 2-3
    per = [s.chunk(3) for s in shards]
    whole = torch.cat([per[r][s] for s in range(3) for r in range(2)])
    assert torch.equal(whole, t)


def test_sequence_parallel_tags_jaxs_blocks(pair):
    """``set_sequence_parallel`` tags the blocks JAX's tags (JAX
    ``tests/test_training.py:351``), none without a model axis."""
    name, tm, jm = pair
    jmesh = jax_make_mesh(JMeshConfig(data=1, model=2), jax.devices()[:2])
    want = jrules.set_sequence_parallel(jm, jmesh)
    assert want > 0
    assert rules.set_sequence_parallel(tm, Mesh(1, 2)) == want
    assert rules.set_sequence_parallel(tm, Mesh(2, 1)) == 0


def test_make_mesh_arithmetic_is_jaxs():
    """-1 takes every remaining rank; a layout that does not cover the
    world fails with JAX's message (one rank without a process group)."""
    for cfg in (None, MeshConfig(), MeshConfig(data=1, model=1)):
        jm = jax_make_mesh(None if cfg is None else JMeshConfig(
            data=cfg.data, model=cfg.model), jax.devices()[:1])
        assert make_mesh(cfg).shape == dict(jm.shape)
    for data, model in ((2, 1), (1, 2), (-1, 2)):
        with pytest.raises(AssertionError) as mine:
            make_mesh(MeshConfig(data=data, model=model))
        with pytest.raises(AssertionError) as ref:
            jax_make_mesh(JMeshConfig(data=data, model=model),
                          jax.devices()[:1])
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("micro", [1, 2])
def test_batch_rows_split_the_global_batch(micro):
    """Data ranks take disjoint rows covering the batch, model peers the
    same; with micro-batches, each rank its share of every one."""
    rows = {r: batch_rows(Mesh(2, 2, rank=r), 8, micro) for r in range(4)}
    assert rows[0] == rows[1] and rows[2] == rows[3]
    assert sorted(rows[0] + rows[2]) == list(range(8))
    for r in (0, 2):
        per = 8 // micro
        assert [x // per for x in rows[r]] == sorted(
            [i for i in range(micro)] * (per // 2))
    x = np.arange(16).reshape(8, 2)
    got = shard_batch(Mesh(2, 2, rank=2), x, micro=micro)
    np.testing.assert_array_equal(got, x[rows[2]])
    with pytest.raises(AssertionError):
        batch_rows(Mesh(4, 1, rank=0), 6)


def test_keep_mask_of_a_slice_is_jaxs_global_mask():
    """The plain keep mask of rows [2, 4) of 4 and heads [4, 8) of 8
    (``planes_of``) is JAX's ``dropout_keep_mask`` over the global planes,
    sliced, bit for bit."""
    B, H, sq, skv, seed, rate = 4, 8, 5, 7, 1234, 0.3
    r = jnp.arange(sq)[:, None]
    c = jnp.arange(skv)[None, :]
    plane = jnp.arange(B * H).reshape(B, H, 1, 1)
    want = np.asarray(jax_keep_mask(r, c, plane, jnp.int32(seed), rate))
    got = fa._keep(2, 4, sq, skv, seed, rate, "cpu",
                   fa.planes_of(2, 4, rows=(2, B), heads=(4, H)))
    np.testing.assert_array_equal(got.numpy(), want[2:4, 4:8])
    whole = fa._keep(B, H, sq, skv, seed, rate, "cpu")
    np.testing.assert_array_equal(whole.numpy(), want)


def test_dropout_of_a_slice_is_the_global_draws_slice():
    """``nn.core.dropout`` under ``rows`` and ``heads`` draws the global
    shape and keeps the rank's slice: the one-device mask's slice."""
    x = torch.ones(4, 8, 3, 5)
    ctx = Ctx(99, True)
    whole, _ = dropout(x, 0.4, ctx, head_dim=1)
    part, _ = dropout(x[2:4, 4:8], 0.4,
                      Ctx(99, True, rows=(2, 4)).with_heads(4, 8),
                      head_dim=1)
    assert torch.equal(part, whole[2:4, 4:8])
