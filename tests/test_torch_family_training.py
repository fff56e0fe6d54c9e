"""One training step of each family's tiny pair (the pretrained-ViT nano
family from ``tests/torch_nano_pairs.py``, the HF decoder families from
``tests/torch_hf_pairs.py``) in the port against the JAX package's
``make_train_step`` on the same weights and batch.

Each configuration keeps what its YAML trains with: its optimizer groups
(``target_modules``; unmatched paths frozen), SNRAdam or AdamW, its
gradient accumulation (the batch is one image a micro-batch), gradient
checkpointing where the YAML enables it, LoRA on the int4 Linears and the
forced-trainable modules; dropout is 0 for the comparison.  The JAX
step's gradients are read from its optimizer state (a transform that
keeps them), the port's from ``.grad`` after its step.

Limits: in f32 (JAX at ``default_matmul_precision("highest")``) the loss
within 1e-5 relative and each trainable gradient within 1e-5 of its
tensor's largest value; at the YAML's bf16 the flagship training parity's
limits (loss 1e-2 relative, the gradients 2e-2 relative L2 over all
trainable tensors).  Frozen paths get no gradient in the port, and the
step moves no frozen tensor.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import torch_hf_pairs as hp
import torch_nano_pairs as npairs
from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.training.loop import TrainState
from image2text_tpu.training.loop import make_train_step as jax_make_train_step
from image2text_tpu.training.wrapper import (ModelTrainerWrapper as JaxWrapper,
                                             TokenizerInfo as JaxTok)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs.reader import load_training_config
from image2text_torch.nn.core import frozen_param_paths
from image2text_torch.training.loop import Trainer
from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                               TokenizerInfo)
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               split_specs, state_dict_numpy)

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-2, 2e-2
SEQ = 24
# family → (its pairs module, the tokenizer's EOS and BOS)
FAMILIES = {
    "nano-mini": (npairs, 0, 1),      # its tiny form's vocabulary is 512
    "nano": (npairs, 50256, 50256),
    "nano-lsh": (npairs, 50256, 50256),
    "gpt2": (npairs, 50256, 50256),
    "llama13b": (hp, 2, 1),
    "llama7b": (hp, 2, 1),
    "qwen": (hp, 151643, 151646),
    "falcon7b": (hp, 11, 11),
    "gpt2xl": (hp, 50256, 50256),
}


def _no_dropout(model_cfg):
    for sub in (model_cfg.vision_encoder_config, model_cfg.decoder_config):
        tc = getattr(sub, "transformer_config", None)
        if tc is not None:
            tc.attn_config.dropout = tc.attn_config.attn_dropout = 0.0
        spec = getattr(sub, "lora_spec", None)
        if spec is not None:
            spec.lora_dropout = 0.0


def _cut(pairs, cfg, name):
    """The pairs module's tiny form, with the YAML's gradient
    checkpointing kept (the cut turns it off for the serving tests)."""
    keep = [getattr(c, "enable_gradient_checkpointing", None) for c in (
        cfg.model.vision_encoder_config, cfg.model.decoder_config)]
    pairs.cut(cfg, name)
    for c, flag in zip((cfg.model.vision_encoder_config,
                        cfg.model.decoder_config), keep):
        if flag is not None:
            c.enable_gradient_checkpointing = flag
    _no_dropout(cfg.model)
    return cfg


def _zero_dropout_rates(modules):
    for mod in modules:
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0


def _build(name, seed=0):
    """(JAX wrapper, params, port wrapper, port config, JAX config) on the
    same weights."""
    pairs, eos, bos = FAMILIES[name]
    with pairs.patched():
        with open(pairs.CONFIGS[name]) as f:
            jcfg = _cut(pairs, JTrainingConfig.model_validate(
                yaml.safe_load(f)), name)
        tcfg = _cut(pairs, load_training_config(pairs.CONFIGS[name]), name)
        vocab = jcfg.model.decoder_config.vocab_size
        jw = JaxWrapper(jcfg.model, JaxTok(eos_token_id=eos, bos_token_id=bos,
                                           vocab_size=vocab), jcfg.trainer)
        if pairs is hp or name == "gpt2":
            jw.model.decoder._load_weights = False
        params = jw.init(jax.random.PRNGKey(seed))
        model = params["model"]
        if pairs is hp:
            model = hp.randomize(model, seed + 1)
        elif name == "gpt2":
            model = npairs._lora_b(model)
        params = dict(params, model=model)
        tw = ModelTrainerWrapper(tcfg.model, TokenizerInfo(
            eos_token_id=eos, bos_token_id=bos, vocab_size=vocab),
            tcfg.trainer, device="cpu")
    _zero_dropout_rates(jw.model.walk())
    _zero_dropout_rates(tw.modules())
    load_jax_state_dict(tw.model, export_state_dict(jw.model, model))
    return jw, params, tw, tcfg, jcfg


def _batch(name, tw, n):
    """``n`` images and labels (8 to SEQ − 2 tokens, then -100)."""
    pairs = FAMILIES[name][0]
    images = (hp.images(name, n, seed=3) if pairs is hp
              else npairs.images(b=n, seed=3))
    vocab = pairs.vocab(tw.model)
    rng = np.random.default_rng(4)
    labels = np.full((n, SEQ), -100, np.int64)
    for i, k in enumerate(rng.integers(8, SEQ - 2, n)):
        labels[i, :k] = rng.integers(3, vocab - 1, k)
    return images, labels


def _keep_grads():
    """An optax transform whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_step(jw, params, images, labels, jcfg, precision):
    tx = _keep_grads()
    step = jax.jit(jax_make_train_step(
        jw, tx, jcfg.gradient_accumulation_steps, precision))
    with jax.default_matmul_precision("highest"):
        state, metrics = step(
            TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)),
            jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(0))
    return (float(metrics["train_loss_lm"]),
            export_state_dict(jw.model, state.opt_state["model"]))


def _export_keys(model, names):
    """The export's keys of the parameters ``names`` (a stacked expert
    tensor under its per-expert keys)."""
    specs = split_specs(model)
    shapes = {k: p.shape for k, p in model.named_parameters()}
    out = []
    for k in sorted(names):
        if k in specs:
            out += [specs[k].format(i=i) for i in range(shapes[k][0])]
        else:
            out.append(k)
    return out


CASES = [(n, "no") for n in FAMILIES] + [
    (n, "bf16") for n in ("nano", "llama13b", "qwen", "falcon7b", "gpt2xl")]


@pytest.mark.parametrize("name,precision", CASES)
def test_training_step_matches_jax(name, precision):
    """The port's ``Trainer`` step (its optimizer groups, remat policy,
    accumulation) against JAX's ``make_train_step`` (see the module's
    limits); then the step's moves: every trainable tensor the loss
    reaches moved, no frozen tensor did."""
    jw, params, tw, tcfg, jcfg = _build(name)
    n = jcfg.gradient_accumulation_steps
    assert n == tcfg.gradient_accumulation_steps
    images, labels = _batch(name, tw, n)
    jloss, jgrads = _jax_step(jw, params, images, labels, jcfg, precision)

    tcfg.precision = precision
    trainer = Trainer(tcfg, tw)
    before = {k: v.copy() for k, v in state_dict_numpy(tw.model).items()}
    metrics = trainer._train_step(torch.from_numpy(images),
                                  torch.from_numpy(labels), 0, 0)
    loss = float(metrics["train_loss_lm"])
    named = dict(tw.model.named_parameters())
    trainable = {k for k, p in named.items() if p.requires_grad}
    frozen_labels = {k[len("model."):] for k, lab in trainer.labels.items()
                     if lab == "frozen" and k.startswith("model.")}
    assert trainable and trainable == set(named) - frozen_labels
    assert set(frozen_param_paths(tw.model)) & set(named) <= frozen_labels
    for k in frozen_labels:
        assert named[k].grad is None, k
    grads = state_dict_numpy(tw.model, grads=True)
    keys = _export_keys(tw.model, trainable)
    assert set(keys) <= set(grads)
    if precision == "no":
        np.testing.assert_allclose(loss, jloss, rtol=F32_TOL)
        for k in keys:
            ref = jgrads[k]
            scale = float(np.abs(ref).max()) or 1.0
            np.testing.assert_allclose(grads[k], ref, rtol=0,
                                       atol=F32_TOL * scale, err_msg=k)
    else:
        assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss)
        num = sum(float(np.square(grads[k] - jgrads[k]).sum()) for k in keys)
        den = sum(float(np.square(jgrads[k]).sum()) for k in keys)
        assert math.sqrt(num / den) <= BF16_GRAD_TOL
    after = state_dict_numpy(tw.model)
    for k in _export_keys(tw.model, frozen_labels):
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    moved = [k for k in keys if np.abs(grads[k]).max() > 0]
    assert moved and all(not np.array_equal(after[k], before[k])
                         for k in moved)


@pytest.mark.parametrize("causal,n_prefix,rate", [(True, None, 0.1),
                                                  (True, 9, 0.0),
                                                  (False, None, 0.1)])
def test_grouped_training_attention_equals_jax_repeat_then_flash(
        causal, n_prefix, rate):
    """Qwen-2's grouped K/V (6 query heads on 2 K/V heads) in a training
    ``sdpa`` on the flash path: forward and the gradients of q, k and v
    equal JAX's gate (``jnp.repeat`` to full heads, then its ``flash_sdpa``
    in interpret mode) on the same dropout seed, within 1e-5 (f32, JAX at
    full matmul precision); each K/V head's gradient is the sum over its
    group of 3."""
    from image2text_tpu.ops.flash_attention import flash_sdpa as jax_flash

    from image2text_torch.nn.core import Ctx
    from image2text_torch.ops import flash_attention as fa
    from image2text_torch.ops.attention import sdpa

    b, h, hk, s, d = 2, 6, 2, 40, 16
    rng = np.random.default_rng(11)
    q, g = (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, hk, s, d)).astype(np.float32)
            for _ in range(2))
    bias = None
    if n_prefix is not None:
        bias = np.zeros((1, 1, s, s), np.float32)
        bias[..., n_prefix:, :n_prefix] = -np.inf
    ctx = Ctx(987654321, True)
    seed = ctx.split()[1]
    jseed = np.array(seed & 0xFFFFFFFF, np.uint32).view(np.int32)
    jb = None if bias is None else jnp.asarray(bias)

    def jax_gate(q_, k_, v_):
        return jax_flash(q_, jnp.repeat(k_, h // hk, axis=1),
                         jnp.repeat(v_, h // hk, axis=1), jb, causal, rate,
                         jnp.int32(jseed))

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(jax_gate, *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(out)] + [np.asarray(t)
                                    for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    launches = fa.flash_fwd.launches
    got = sdpa(tq, tk, tv, None if bias is None else torch.from_numpy(bias),
               causal=causal, dropout_rate=rate, ctx=ctx, use_flash=True)
    got.backward(torch.from_numpy(g))
    assert fa.flash_fwd.launches == launches   # CPU: the plain versions
    assert tk.grad.shape == (b, hk, s, d)
    for label, mine, ref in zip(("out", "dq", "dk", "dv"),
                                (got, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(mine.detach().numpy(), ref, atol=1e-5,
                                   rtol=1e-5, err_msg=label)
