"""``MoELinear`` with a gate of any depth, and the kernel gates, against
the JAX package (``image2text_torch/models/layers.py`` vs
``image2text_tpu/models/layers.py``, ``ops/fused_moe.py::_supported``,
``ops/fused_block.py::_gate_and_weights`` and
``fused_sparse_block_compatible``).

* The MoE linear with ``gate_sizes`` None (one linear gate), (32,) and
  (32, 16) on the same weights: the output and every parameter's and the
  input's gradient in f32 within 1e-5 of its largest value.
* The tiny flagship with its blocks' gates of other depths: eval logits
  (the port's kernels decline these gates, JAX's CPU path composes) at
  ``tests/test_torch_model.py``'s limits (atol 2e-4, rtol 1e-4).
* The kernel gates decline exactly where JAX's do: a gate of another
  depth, a LoRA-wrapped gate Linear, a LoRA-wrapped q/kv/out projection
  or null connector; both accept the plain block (widths 128, as JAX's
  lane rule wants).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.configs.models import LoraSpec as JLoraSpec
from image2text_tpu.models import layers as jl
from image2text_tpu.models.lora import apply_lora as jax_apply_lora
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.ops.fused_block import (_gate_and_weights,
                                            fused_sparse_block_compatible)
from image2text_tpu.ops.fused_moe import _supported
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten

from image2text_torch.configs.models import LoraSpec, flagship_config
from image2text_torch.models import layers as tl
from image2text_torch.models.lora import apply_lora
from image2text_torch.models.vision_encoder_decoder import (
    VisionEncoderDecoder)
from image2text_torch.utils.checkpoint import load_jax_state_dict

torch.set_num_threads(2)
TOL = 1e-5
GATES = [None, (32,), (32, 16)]


def _load(module, params):
    with torch.no_grad():
        named = dict(module.named_parameters())
        for k, v in flatten(params).items():
            named[k].copy_(torch.from_numpy(np.array(v)))


def _close(got, want, err=""):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=err)


@pytest.mark.parametrize("gates", GATES)
def test_moe_linear_of_any_gate_depth_equals_jaxs(gates):
    jm = jl.MoELinear(48, 40, 8, 6, bias=True, top_k=2, gate_sizes=gates)
    params = jm.init(jax.random.PRNGKey(1))
    tm = tl.MoELinear(48, 40, 8, 6, bias=True, top_k=2, gate_sizes=gates)
    _load(tm, params)
    for q in tm.parameters():
        q.requires_grad_(True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal((3, 5, 40)).astype(np.float32)

    def loss(p, x_):
        return (jm(p, x_) * w).sum()

    with jax.default_matmul_precision("highest"):
        y = np.asarray(jm(params, jnp.asarray(x)))
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tm(xt)
    (yt * torch.from_numpy(w)).sum().backward()
    _close(yt.detach().numpy(), y)
    _close(xt.grad.numpy(), np.asarray(gx), "x")
    named = dict(tm.named_parameters())
    for k, v in flatten(gp).items():
        _close(named[k].grad.numpy(), np.asarray(v), k)
    assert len(tm.expert_gates.linears) == len(gates or ()) + 1
    assert tm.plain_gates == (gates == (32,))


def _flagship_pair(gates):
    jcfg, tcfg = _flagship_config(tiny=True), flagship_config(tiny=True)
    for cfg in (jcfg.model, tcfg):
        for sub in (cfg.vision_encoder_config, cfg.decoder_config):
            sub.transformer_config.rotator_config.gate_sizes = gates
            a = sub.transformer_config.attn_config
            a.dropout = a.attn_dropout = 0.0
    jm = JaxModel(jcfg.model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = VisionEncoderDecoder(tcfg, device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    return jm, params, tm


@pytest.mark.parametrize("gates", [None, (32, 16)])
def test_flagship_with_other_gate_depths_equals_jax(gates):
    """Eval logits (composed FFNs: the kernels decline these gates)."""
    jm, params, tm = _flagship_pair(gates)
    assert not any(b.mlp.plain_weights for b in tm.encoder.blocks)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    ids = rng.integers(3, 500, (2, 10))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(params, jnp.asarray(images),
                             jnp.asarray(ids)).logits)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("gates", GATES)
def test_moe_ffn_gate_declines_where_jaxs_does(gates):
    """``_MoEMLP.plain_weights`` against JAX's ``_supported`` on both
    MoE linears at widths 128."""
    cfg = copy.deepcopy(flagship_config().vision_encoder_config
                        .transformer_config.rotator_config)
    cfg.gate_sizes = gates
    jcfg = _flagship_config().model.vision_encoder_config \
        .transformer_config.rotator_config.model_copy(deep=True)
    jcfg.gate_sizes = gates
    jmlp = jl._MoEMLP(128, True, 0.0, jcfg)
    p = jmlp.init(jax.random.PRNGKey(0))
    tmlp = tl._MoEMLP(128, True, cfg, device="meta")
    want = _supported(jmlp.c_fc, p["c_fc"]) and _supported(
        jmlp.c_proj, p["c_proj"])
    assert tmlp.plain_weights == want == (gates == (32,))


def _block_pair(sparse: bool):
    """A flagship encoder block at d 128, one head (JAX's lane rule)."""
    jt = _flagship_config().model.vision_encoder_config \
        .transformer_config.model_copy(deep=True)
    tt = copy.deepcopy(flagship_config().vision_encoder_config
                       .transformer_config)
    for c in (jt, tt):
        c.attn_config.n_embd, c.attn_config.n_head = 128, 1
        c.is_sparse_attn = sparse
        c.max_block_size = 16
        c.sparsity_factor = 0.5
    return (jl.TransformerBlock(jt, seed=0, n_cls=0),
            tl.TransformerBlock(tt, seed=0, n_cls=0, device="cpu"))


TARGETS = [None, "q_proj", "kv_proj", "out_proj", "expert_gates.model.0",
           "null_connector"]


@pytest.mark.parametrize("target", TARGETS)
def test_block_kernel_gate_declines_where_jaxs_does(target):
    """``TransformerBlock.plain_weights`` against JAX's gates: the dense
    chain's ``_gate_and_weights`` and, for the null connector, the
    sparse entry ``fused_sparse_block_compatible`` (interpret mode)."""
    sparse = target == "null_connector"
    jb, tb = _block_pair(sparse)
    if target is not None:
        jb = jax_apply_lora(jb, JLoraSpec(r=4, lora_alpha=8,
                                          lora_dropout=0.0,
                                          target_modules=[target]))
        tb = apply_lora(tb, LoraSpec(r=4, lora_alpha=8, lora_dropout=0.0,
                                     target_modules=[target]))
    p = jb.init(jax.random.PRNGKey(0))
    x = jnp.zeros((1, 16, 128), jnp.float32)
    if sparse:
        want = fused_sparse_block_compatible(jb, p, x, None,
                                             interpret=True) is not None
    else:
        want = _gate_and_weights(jb, p, x, True) is not None
    assert tb.plain_weights == want == (target is None)


def test_sparse_block_kernel_gate_takes_the_plain_block():
    jb, tb = _block_pair(True)
    p = jb.init(jax.random.PRNGKey(0))
    x = jnp.zeros((1, 16, 128), jnp.float32)
    assert fused_sparse_block_compatible(jb, p, x, None,
                                         interpret=True) is not None
    assert tb.plain_weights
