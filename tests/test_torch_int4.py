"""The port's int4 quantization (``image2text_torch/ops/int4_matmul.py``,
``models/quantization.py``, ``models/lora.py``) against the JAX package's.

The packing is integer and scale arithmetic in f32, so it must be bit for
bit the JAX one.  The matmul's plain version and the autograd backward
are held against JAX ``int4_matmul`` run the way
``tests/test_hf_decoders.py`` runs it: ``INT4_KERNEL`` forced to
``"pallas"``, so the Pallas kernel runs in interpret mode, at packed
widths ``_pick_bp`` accepts.  Tolerance: 1e-5 absolute plus 1e-5
relative, f32 on both sides with JAX at full matmul precision (the sums
run in different orders over O(1) values).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.models import quantization as jq
from image2text_tpu.ops import int4_matmul as jint4
from image2text_tpu.utils.tree import flatten

from image2text_torch.models import lora, quantization
from image2text_torch.nn.modules import Linear
from image2text_torch.ops import int4_matmul as ti

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _w(out_f, in_f, seed=0, std=0.02):
    return (np.random.default_rng(seed).standard_normal((out_f, in_f))
            * std).astype(np.float32)


@pytest.mark.parametrize("out_f,in_f", [(48, 100), (16, 64), (7, 1000),
                                        (3, 4096)])
def test_packing_bit_equal_to_jax(out_f, in_f):
    w = _w(out_f, in_f, seed=in_f)
    w[0, :40] = 0.0            # an all-zero strip: scale 0
    want_q, want_s = jint4.quantize_pack_int4(w)
    q, s = ti.quantize_pack_int4(w)
    assert q.dtype == np.uint8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(
        ti.unpack_int4(q), np.asarray(jint4.unpack_int4_jnp(jnp.asarray(q))))
    np.testing.assert_array_equal(
        ti.dequantize_int4(q, s),
        np.asarray(jint4.dequantize_int4(jnp.asarray(q), jnp.asarray(s))))
    np.testing.assert_array_equal(
        quantization.dequantize_blockwise(q, s, in_f),
        np.asarray(jq.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s),
                                           in_f)))
    # the torch form on torch tensors gives the same bits
    tq, ts = ti.quantize_pack_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), want_q)
    np.testing.assert_array_equal(ts.numpy(), want_s)


@pytest.mark.parametrize("rows,in_f,out_f", [(16, 256, 192), (40, 512, 300),
                                             (8, 200, 64)])
def test_matmul_and_input_gradient_match_jax_pallas(rows, in_f, out_f,
                                                    monkeypatch):
    """Forward: the plain version against the Pallas kernel (interpret
    mode); backward: the autograd function's dx against the JAX custom
    VJP's."""
    monkeypatch.setattr(jint4, "INT4_KERNEL", "pallas")
    packed, scales = ti.quantize_pack_int4(_w(out_f, in_f, seed=rows))
    in_pad = packed.shape[1] * 2
    assert jint4._pick_bp(in_pad // 2) is not None
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, in_pad)).astype(np.float32)
    g = rng.standard_normal((rows, out_f)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, vjp = jax.vjp(lambda x_: jint4.int4_matmul(
            x_, jnp.asarray(packed), jnp.asarray(scales)), jnp.asarray(x))
        want_dx = vjp(jnp.asarray(g))[0]
    tx = torch.from_numpy(x).requires_grad_()
    tp, ts = torch.from_numpy(packed), torch.from_numpy(scales)
    before = ti.int4_matmul.launches
    got = ti.Int4Matmul.apply(tx, tp, ts)
    got.backward(torch.from_numpy(g))
    assert ti.int4_matmul.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(
        ti.int4_matmul_plain(tx.detach(), tp, ts).numpy(), np.asarray(want),
        **TOL)


@pytest.mark.parametrize("rows", [3, 16])
def test_quantized_linear_matches_jax(rows):
    """In 100 (padded to 128), out 48, f32 bias; rows below and above the
    JAX module's rows < 8 fallback (the same function in f32)."""
    jlin = jq.QuantizedLinear(100, 48, bias=True)
    packed, scales = ti.quantize_pack_int4(_w(48, 100))
    bias = np.random.default_rng(2).standard_normal(48).astype(np.float32)
    p = {"weight": jnp.asarray(packed), "weight_scales": jnp.asarray(scales),
         "bias": jnp.asarray(bias)}
    x = np.random.default_rng(3).standard_normal((rows, 100)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jlin(p, jnp.asarray(x)))
    lin = quantization.QuantizedLinear(100, 48, bias=True, device="cpu")
    assert lin.weight.dtype == torch.uint8 and lin.in_pad == 128
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(packed))
        lin.weight_scales.copy_(torch.from_numpy(scales))
        lin.bias.copy_(torch.from_numpy(bias))
        got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # bf16: the scales as the bf16 cast of the model leaves them
    lin16 = lin.to(torch.bfloat16)
    assert lin16.weight.dtype == torch.uint8
    assert lin16.weight_scales.dtype == torch.bfloat16
    y16 = lin16(torch.from_numpy(x).to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), want, atol=0.05,
                               rtol=0.05)


def test_wrapper_launches_or_raises_off_the_cpu():
    """Not on the CPU: the wrapper checks its operands and raises on what
    the kernel does not take; it never runs the plain version there."""
    packed = torch.zeros(8, 32, dtype=torch.uint8, device="meta")
    scales = torch.zeros(8, 1, device="meta")
    before = ti.int4_matmul.launches
    for x in (torch.zeros(4, 64, device="meta"),                   # f32 x
              torch.zeros(4, 64, dtype=torch.bfloat16, device="meta")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ti.int4_matmul(x, packed, scales)
    assert ti.int4_matmul.launches == before


# GPT-2-medium's quantized Linears (in_pad, out) at 256 decode rows and the
# training step's 12 x 112 rows, and the plan the kernel takes on 132 SMs.
GPT2M_PLANS = [
    ((256, 3072, 1024), (256, 64, 2)),    # c_attn: 48 tiles
    ((256, 1024, 1024), (256, 64, 8)),    # attn c_proj: 16 tiles
    ((256, 4096, 1024), (256, 64, 2)),    # c_fc: 64 tiles
    ((256, 1024, 4096), (256, 64, 8)),    # mlp c_proj
    ((1344, 3072, 1024), (128, 128, 1)),  # 11 x 24 tiles: two full waves
    ((1344, 1024, 1024), (128, 128, 1)),
    ((1344, 4096, 1024), (128, 128, 1)),
    ((1344, 1024, 4096), (128, 128, 1)),
    ((1, 1000, 64), (256, 64, 1)),        # a single strip pair: no split
    ((7, 1000, 4096), (256, 64, 8)),
    ((257, 1000, 64), (128, 128, 1)),
]


@pytest.mark.parametrize("shape,want", GPT2M_PLANS)
def test_int4_plan(shape, want):
    rows, out_f, in_pad = shape
    assert ti.int4_plan(rows, out_f, in_pad, 132) == want


@pytest.mark.parametrize("in_pad", [64, 128, 192, 1024, 4096])
@pytest.mark.parametrize("n_sms", [1, 16, 132])
@pytest.mark.parametrize("rows,out_f", [(1, 1000), (7, 64), (256, 1024),
                                        (1344, 4096)])
def test_int4_split_covers_the_input_in_whole_strips(in_pad, n_sms, rows,
                                                     out_f):
    """The split never cuts a strip pair (one scale) and covers in_pad
    exactly, every split non-empty; split blocks fill at most one wave."""
    bm, bn, splits = ti.int4_plan(rows, out_f, in_pad, n_sms)
    assert 1 <= splits <= in_pad // ti.QBLOCK
    tiles = -(-rows // bm) * -(-out_f // bn)
    assert splits == 1 or tiles * splits <= n_sms
    nb = in_pad // ti.QBLOCK   # the kernel's split z: [z·nb/splits, (z+1)·nb/splits)
    ranges = [(z * nb // splits, (z + 1) * nb // splits)
              for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] * ti.QBLOCK == in_pad
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(ranges[-1][1], 0)]):
        assert lo < hi == nxt


def test_int4_plan_reads_the_kernel_tiling():
    """The tiles come from csrc/int4_matmul.cu, their one owner."""
    src = (ti._build.CSRC / "int4_matmul.cu").read_text()
    for name, value in (("DEC_BM", ti.DEC_ROWS), ("DEC_BN", ti.DEC_OUTS),
                        ("TRAIN_BM", ti.TRAIN_ROWS),
                        ("TRAIN_BN", ti.TRAIN_OUTS),
                        ("PAIRS", ti.STAGE_PAIRS)):
        assert f"constexpr int {name} = {value};" in src
    assert (ti.DEC_ROWS, ti.DEC_OUTS, ti.TRAIN_ROWS, ti.TRAIN_OUTS,
            ti.STAGE_PAIRS) == (256, 64, 128, 128, 2)


def test_structure_lora_wrapping_and_its_errors():
    """``quantize_module_structure`` skips the cross-attention paths;
    ``apply_lora`` matches peft-style targets, keeps the base's tensor
    paths, freezes the subtree but the adapters, and refuses a target
    list that wraps nothing."""
    from image2text_torch.nn.core import frozen_param_paths
    from image2text_torch.configs.models import LoraSpec

    def tree():
        root = torch.nn.Module()
        root.attn = torch.nn.Module()
        root.attn.c_attn = Linear(64, 192, device="cpu")
        root.crossattention = torch.nn.Module()
        root.crossattention.c_attn = Linear(64, 128, device="cpu")
        root.mlp = torch.nn.Module()
        root.mlp.c_fc = Linear(64, 256, device="cpu")
        root.mlp.c_proj = Linear(256, 64, device="cpu")
        return root

    root = tree()
    quantization.quantize_module_structure(root, ("crossattention",))
    assert type(root.attn.c_attn) is quantization.QuantizedLinear
    assert type(root.crossattention.c_attn) is Linear
    lora.apply_lora(root, LoraSpec(r=4, lora_alpha=8, target_modules=[
        "c_attn", "mlp.c_fc"], force_enable_update_modules=[
        "crossattention.*"]))
    assert isinstance(root.attn.c_attn, lora.LoRAQuantizedLinear)
    assert isinstance(root.crossattention.c_attn, lora.LoRALinear)
    assert type(root.mlp.c_proj) is quantization.QuantizedLinear
    names = set(dict(root.named_parameters())) | set(
        dict(root.named_buffers()))
    assert {"attn.c_attn.weight", "attn.c_attn.weight_scales",
            "attn.c_attn.lora_A.weight", "attn.c_attn.lora_B.weight",
            "crossattention.c_attn.weight"} <= names
    frozen = set(frozen_param_paths(root))
    assert "attn.c_attn.weight" in frozen and "mlp.c_proj.weight" in frozen
    assert not any("lora_" in p or "crossattention" in p for p in frozen)
    with pytest.raises(ValueError, match="nothing was LoRA-wrapped"):
        lora.apply_lora(tree(), LoraSpec(target_modules=["q_proj"]))


def test_checkpoint_bridge_copies_integer_weights():
    """``load_jax_state_dict`` copies the packed uint8 weights (they are
    parameters), still only compares the sparse-selection buffers, and
    ``state_dict_numpy`` exports uint8 unchanged and no gradient for it."""
    from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                                   state_dict_numpy)

    lin = quantization.QuantizedLinear(64, 8, device="cpu")
    packed, scales = ti.quantize_pack_int4(_w(8, 64))
    sd = {"weight": packed, "weight_scales": scales,
          "bias": np.ones(8, np.float32)}
    load_jax_state_dict(lin, sd)
    out = state_dict_numpy(lin)
    assert out["weight"].dtype == np.uint8
    for k, v in sd.items():
        np.testing.assert_array_equal(out[k], v)
    assert "weight" not in state_dict_numpy(lin, grads=True)


def test_import_hf_gpt2_quantizes_like_jax():
    """An HF GPT2LMHeadModel state dict (Conv1D layouts, a vocabulary
    grown by 2 extra tokens) imported into the int4 + LoRA decoder: every
    tensor the JAX importer writes, the port's writes bit for bit."""
    from transformers import GPT2Config, GPT2LMHeadModel

    from image2text_tpu.configs.models import (
        HuggingfaceDecoderConfig as JCfg, LoraSpec as JLora)
    from image2text_tpu.models.hf_decoders import factory as jfactory
    from image2text_tpu.models.hf_decoders.gpt2 import (
        import_hf_gpt2 as jax_import)

    from image2text_torch.configs.models import (HuggingfaceDecoderConfig,
                                                 LoraSpec)
    from image2text_torch.models.hf_decoders import factory
    from image2text_torch.models.hf_decoders.gpt2 import import_hf_gpt2
    from image2text_torch.utils.checkpoint import state_dict_numpy

    with torch.random.fork_rng():   # leave the global RNG as it was
        torch.manual_seed(0)
        hf = GPT2LMHeadModel(GPT2Config(n_layer=1, n_embd=64, n_head=2,
                                        vocab_size=50257,
                                        add_cross_attention=True))
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    kw = dict(model_str="gpt2", use_cross_attn=True, vocab_size=50257,
              extra_tokens=2, load_in_4bit=True,
              prepare_for_kbit_training=True)
    targets = ["c_attn", "mlp.c_fc", "mlp.c_proj"]
    arch = dict(n_layer=1, n_embd=64, n_head=2)
    saved = jfactory.GPT2_TABLE["gpt2"], factory.GPT2_TABLE["gpt2"]
    jfactory.GPT2_TABLE["gpt2"] = factory.GPT2_TABLE["gpt2"] = arch
    try:
        jdec = jfactory.build_hf_decoder(
            JCfg(lora_spec=JLora(r=4, target_modules=targets), **kw),
            load_weights=False)
        want = flatten(jax_import(jdec.init(jax.random.PRNGKey(0)), sd))
        tdec = factory.build_hf_decoder(HuggingfaceDecoderConfig(
            lora_spec=LoraSpec(r=4, target_modules=targets), **kw),
            device="cpu")
        import_hf_gpt2(tdec, sd)
    finally:
        jfactory.GPT2_TABLE["gpt2"], factory.GPT2_TABLE["gpt2"] = saved
    got = state_dict_numpy(tdec)
    # strict matching: a key the decoder lacks, or a shape it cannot take
    for bad, what in (({"transformer.h.0.attn.q.weight": np.zeros(3)},
                       "not present"),
                      ({"transformer.ln_f.weight": np.zeros(3, np.float32)},
                       "not the same shape")):
        with pytest.raises(ValueError, match=what):
            import_hf_gpt2(tdec, bad)
    written = [k for k in want if "lora_" not in k]
    assert "transformer.h.0.mlp.c_fc.weight" in written
    for k in written:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        if k == "transformer.wte.weight":   # the 2 new rows keep their init
            np.testing.assert_array_equal(got[k][:50257], want[k][:50257])
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
