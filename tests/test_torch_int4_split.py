"""The model split of int4 and LoRA-wrapped Linears
(``image2text_torch/parallel/sharding_rules.py`` module docstring, 3) as
pure functions, no processes: the placements of the int4 + LoRA decoders
at full size on the meta device, and the shards' products against the
whole Linear's.

* Llama-2-13B (``training_configs/tpu/llama2-13b.yaml``) at tp2: every
  int4 Linear and every LoRA-wrapped one is split, each rank holds half
  of the packed bytes and scales; q/k/v and gate/up keep their rows in
  two halves, o_proj and down_proj whole byte columns.
* GPT-2-xl (25 heads) and Falcon-7B at tp2: the attention, whose int4
  row split has no exact shard, stays whole with its adapters; the MLP
  splits.
* A column shard of each pair split is the whole product's columns, bit
  for bit; the row shards' products, summed, are the whole product up
  to summation order (f32, 1e-5 of its largest value); the shards' bytes
  and scales are slices of the whole Linear's, never re-quantised.
"""
import pytest
import torch

from image2text_torch.configs.reader import load_training_config
from image2text_torch.models.decoder import decoder_from_config
from image2text_torch.models.lora import apply_lora
from image2text_torch.models.quantization import (QuantizedLinear,
                                                  quantize_blockwise)
from image2text_torch.ops.int4_matmul import int4_matmul_plain
from image2text_torch.parallel import sharding_rules as rules

torch.set_num_threads(2)
YAMLS = {"llama13b": "training_configs/tpu/llama2-13b.yaml",
         "gpt2xl": "training_configs/tpu/gpt2-xl.yaml",
         "falcon7b": "training_configs/tpu/falcon-7b.yaml",
         "gpt2m": "training_configs/tpu/gpt2-medium.yaml"}


def _decoder(name):
    cfg = load_training_config(YAMLS[name])
    return decoder_from_config(cfg.model.decoder_config, device="meta")


@pytest.fixture(scope="module")
def llama():
    dec = _decoder("llama13b")
    return dec, rules.tp_placements(dec, 2)


def _int4(dec):
    return {p: m for p, m in dec.named_modules()
            if isinstance(m, QuantizedLinear)}


def _nbytes(t):
    return t.numel() * t.element_size()


def test_llama13b_splits_every_int4_and_lora_linear(llama):
    """No int4 or LoRA-wrapped Linear of Llama-2-13B is replicated at tp2;
    the column splits keep two halves of their rows, the row splits
    whole byte columns (sections 1) and their scales' columns."""
    dec, places = llama
    lins = _int4(dec)
    assert len(lins) == 7 * 40
    for path, m in lins.items():
        w, s = places[f"{path}.weight"], places[f"{path}.weight_scales"]
        if path.endswith(("o_proj", "down_proj")):
            assert w == s == (1, 1), path
        else:
            assert w == s == (0, 2), path
        if hasattr(m, "lora_A"):
            a, b = (places[f"{path}.lora_{x}.weight"] for x in "AB")
            if w[0] == 0:
                assert a is None and b == (0, 2), path
            else:
                assert a == (1, 2) and b is None, path
    assert sum(hasattr(m, "lora_A") for m in lins.values()) == 6 * 40


def test_each_llama13b_rank_holds_half_the_int4_bytes(llama):
    """The packed bytes and scales one rank holds are half of the whole
    decoder's (meta tensors: sizes only)."""
    dec, places = llama
    whole = half = 0
    for path, m in _int4(dec).items():
        for name in ("weight", "weight_scales"):
            t = getattr(m, name)
            place = places[f"{path}.{name}"]
            whole += _nbytes(t)
            shard = rules.shard(torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"),
                                place[0], place[1], 0, 2)
            half += _nbytes(shard)
    assert whole == 2 * half and whole > 6 * 2 ** 30


@pytest.mark.parametrize("name", ["gpt2xl", "falcon7b"])
def test_an_int4_row_split_with_no_exact_shard_keeps_its_group_whole(name):
    """GPT-2-xl's attention (25 heads, ``c_proj``'s P/2 = 400 not whole
    strips) and Falcon-7B's (``dense``'s P/2 = 1,136) stay whole with
    their scales and adapters; their MLPs split, the int4 row split on
    whole byte columns."""
    dec = _decoder(name)
    places = rules.tp_placements(dec, 2)
    attn, mlp = (("attn.", "mlp.") if name == "gpt2xl"
                 else ("self_attention.", "mlp."))
    seen = {"attn": 0, "mlp": 0}
    for path, m in _int4(dec).items():
        tensors = [f"{path}.weight", f"{path}.weight_scales"]
        if hasattr(m, "lora_A"):
            tensors += [f"{path}.lora_A.weight", f"{path}.lora_B.weight"]
        if f".{attn}" in path and "crossattention" not in path:
            assert all(places[t] is None for t in tensors), path
            seen["attn"] += 1
        elif f".{mlp}" in path:
            assert places[f"{path}.weight"] is not None, path
            seen["mlp"] += 1
    assert seen["attn"] and seen["mlp"]


def test_gpt2_medium_splits_its_int4_attention_and_mlp():
    """GPT-2-medium (16 heads of 64): ``c_attn`` keeps two halves of each
    of q, k and v (6 sections), ``c_proj`` whole byte columns."""
    dec = _decoder("gpt2m")
    places = rules.tp_placements(dec, 2)
    lins = _int4(dec)
    assert lins and all(places[f"{p}.weight"] is not None for p in lins)
    c_attn = [p for p in lins if p.endswith("attn.c_attn")
              and "crossattention" not in p]
    assert c_attn and all(places[f"{p}.weight"] == (0, 6) for p in c_attn)


def _random_int4(in_f, out_f, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(out_f, in_f, generator=g) * 0.02
    return quantize_blockwise(w)


@pytest.mark.parametrize("tp", [2, 4])
def test_row_shards_sum_to_the_whole_product(tp):
    """A row split of an int4 Linear (in 512: P = 256, P/tp whole strips):
    each rank's bytes and scales are slices of the whole Linear's, its
    input is its chunk of each half (two sections), and the shards'
    products sum to the whole product."""
    packed, scales = _random_int4(512, 96, 0)
    x = torch.randn(5, 512, generator=torch.Generator().manual_seed(1))
    whole = int4_matmul_plain(x, packed, scales)
    lin = QuantizedLinear(512, 96, bias=False, device="meta")
    assert rules.int4_splits_exactly(lin, tp)
    total = torch.zeros_like(whole)
    for r in range(tp):
        p = rules.shard(packed, 1, 1, r, tp)
        s = rules.shard(scales, 1, 1, r, tp)
        c = 256 // tp
        assert torch.equal(p, packed[:, r * c:(r + 1) * c])
        assert torch.equal(s, scales[:, r * c // 32:(r + 1) * c // 32])
        total += int4_matmul_plain(rules.shard(x, 1, 2, r, tp), p, s)
    scale = float(whole.abs().max())
    torch.testing.assert_close(total, whole, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("tp", [2, 4])
def test_pair_column_shards_are_the_whole_products_columns(tp):
    """A column split in two halves (the layer before an int4 row split):
    each rank's rows of bytes and scales, its product the whole product's
    columns of the same halves, bit for bit."""
    packed, scales = _random_int4(128, 256, 2)
    x = torch.randn(3, 128, generator=torch.Generator().manual_seed(3))
    whole = int4_matmul_plain(x, packed, scales)
    for r in range(tp):
        y = int4_matmul_plain(x, rules.shard(packed, 0, 2, r, tp),
                              rules.shard(scales, 0, 2, r, tp))
        assert torch.equal(y, rules.shard(whole, 1, 2, r, tp))


def test_unexact_row_splits_stay_whole():
    """No shard where the input is padded, or where P/tp is not whole
    32-column strips."""
    assert not rules.int4_splits_exactly(
        QuantizedLinear(96, 8, device="meta"), 2)       # in_pad 128
    assert not rules.int4_splits_exactly(
        QuantizedLinear(1600, 8, device="meta"), 2)     # P/2 = 400
    assert rules.int4_splits_exactly(
        QuantizedLinear(5120, 8, device="meta"), 2)     # P/2 = 1280
    assert not rules.int4_splits_exactly(
        QuantizedLinear(5120, 8, device="meta"), 3)     # P/3 not whole
    assert not rules.int4_splits_exactly(
        QuantizedLinear(5120, 8, device="meta"), 32)    # P/32 = 80


def test_lora_follows_a_float_base_split():
    """A LoRA-wrapped float Linear splits as its base: B with a column
    split's rows, A with a row split's columns (the tiny flagship
    decoder's blocks, every attention and MLP projection wrapped)."""
    from image2text_torch.configs.models import LoraSpec, flagship_config

    cfg = flagship_config(tiny=True)
    dec = decoder_from_config(cfg.decoder_config, device="meta")
    apply_lora(dec, LoraSpec(r=4, lora_alpha=8, lora_dropout=0.0,
                             target_modules=["q_proj", "out_proj",
                                             "kv_proj"]))
    places = rules.tp_placements(dec, 2)
    q = [p for p in places if p.endswith("attn.q_proj.lora_B.weight")]
    o = [p for p in places if p.endswith("attn.out_proj.lora_A.weight")]
    assert q and all(places[p] == (0, 1) for p in q)
    assert o and all(places[p] == (1, 1) for p in o)
    assert all(places[p.replace("lora_B", "lora_A")] is None for p in q)
    kv = [p for p in places if "attn.kv_proj.lora_" in p]
    assert kv and all(places[p] is None for p in kv)
