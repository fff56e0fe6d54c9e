"""The remat policies of the port (``image2text_torch/training/remat.py``):
every policy gives the gradients of ``full`` (dropout on), what each
policy keeps, and the names the JAX package takes.

A policy changes what is kept, never the arithmetic, so the gradients
agree to the bit when the CPU's products run alike.  The limits leave
room for one thing the port does not control: the math library may run
a product on fewer threads under load, which moves f32 sums by an ulp
(f32: 1e-6 of each tensor's largest value; bf16, where such an ulp can
flip a rounding: 1e-3 relative L2 over all gradients).
"""
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

import torch_hf_pairs as hp
from image2text_tpu.training.remat import (
    resolve_remat_policy as jax_resolve_remat_policy)

from image2text_torch.configs.reader import load_training_config
from image2text_torch.configs.trainer import flagship_training_config
from image2text_torch.models.quantization import fill_random_int4
from image2text_torch.ops.int4_matmul import Int4Matmul, quantize_pack_int4
from image2text_torch.training.loop import cast_for_compute
from image2text_torch.training.remat import (POLICIES, checkpoint_block,
                                             resolve_remat_policy,
                                             set_remat_policy)
from image2text_torch.training.wrapper import (ModelTrainerWrapper,
                                               TokenizerInfo)
from image2text_torch.utils.checkpoint import state_dict_numpy

torch.set_num_threads(2)


class _Ops(TorchDispatchMode):
    """The aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _flagship_wrapper(dropout=0.1):
    cfg = flagship_training_config(tiny=True)
    for sub in (cfg.model.vision_encoder_config, cfg.model.decoder_config):
        a = sub.transformer_config.attn_config
        a.dropout = a.attn_dropout = dropout
        sub.enable_gradient_checkpointing = True
    tok = TokenizerInfo(eos_token_id=0, bos_token_id=1, mask_token_id=2,
                        vocab_size=cfg.model.decoder_config.vocab_size)
    tw = ModelTrainerWrapper(cfg.model, tok, cfg.trainer, device="cpu")
    return tw.init_weights(0), 64, cfg.model.decoder_config.vocab_size


def _hf_wrapper(name):
    """``name``'s tiny form (tests/torch_hf_pairs.py's cut) with every
    stack checkpointing, LoRA dropout as the YAML sets it."""
    with hp.patched():
        cfg = load_training_config(hp.CONFIGS[name])
        model = hp.cut(cfg, name)
        model.decoder_config.enable_gradient_checkpointing = True
        tok = TokenizerInfo(eos_token_id=2, bos_token_id=hp.BOS[name],
                            mask_token_id=None, vocab_size=1000)
        tw = ModelTrainerWrapper(model, tok, cfg.trainer, device="cpu")
        tw.init_weights(0)
    gen = torch.Generator().manual_seed(1)
    fill_random_int4(tw.model, gen)
    with torch.no_grad():
        for n, p in tw.model.named_parameters():
            if ".lora_B." in n:
                p.normal_(0.0, 0.02, generator=gen)
    return tw, hp.IMAGE_SIZE[name], 1000


def _grads(tw, size, vocab, policy, precision="no"):
    set_remat_policy(tw.model, policy)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal(
        (2, 3, size, size)).astype(np.float32))
    labels = torch.full((2, 24), -100, dtype=torch.int64)
    labels[0, :20] = torch.from_numpy(rng.integers(3, vocab - 1, 20))
    labels[1, :11] = torch.from_numpy(rng.integers(3, vocab - 1, 11))
    for p in tw.parameters():
        p.grad = None
    dt = torch.float32 if precision == "no" else torch.bfloat16
    loss, _ = functional_call(tw, cast_for_compute(tw, dt),
                              (images.to(dt), labels),
                              dict(seed=12345, backward=True))
    return float(loss), state_dict_numpy(tw.model, grads=True)


@pytest.fixture(scope="module", params=["flagship", "llama13b", "qwen"])
def family(request):
    """A wrapper and its gradients under ``full``."""
    if request.param == "flagship":
        tw, size, vocab = _flagship_wrapper()
    else:
        tw, size, vocab = _hf_wrapper(request.param)
    return tw, size, vocab, _grads(tw, size, vocab, "full")


@pytest.mark.parametrize("policy", ["dots", "nothing", "everything", None])
def test_every_policy_gives_the_gradients_of_full(family, policy):
    """The same loss and every gradient as ``full``'s: the tiny flagship (dropout 0.1 in every block), the int4 + LoRA Llama-2-13B
    form (LoRA dropout 0.1, ``int4_matmul`` inside the blocks) and Qwen-2
    (grouped K/V repeated for the flash path), f32 on the CPU."""
    tw, size, vocab, (loss0, g0) = family
    loss, g = _grads(tw, size, vocab, policy)
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    assert set(g) == set(g0)
    for k in g0:
        scale = float(np.abs(g0[k]).max()) or 1.0
        np.testing.assert_allclose(g[k], g0[k], rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
    assert any(np.abs(v).max() > 0 for v in g0.values())


def test_policies_in_bf16_give_the_gradients_of_full():
    """The bf16 compute path (the YAMLs' 'bf16'): ``dots`` and
    ``everything`` give ``full``'s loss and gradients on the tiny
    flagship."""
    tw, size, vocab = _flagship_wrapper()
    loss0, g0 = _grads(tw, size, vocab, "full", "bf16")
    for policy in ("dots", "everything"):
        loss, g = _grads(tw, size, vocab, policy, "bf16")
        np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=policy)
        num = sum(float(np.square(g[k] - g0[k]).sum()) for k in g0)
        den = sum(float(np.square(g0[k]).sum()) for k in g0)
        assert np.sqrt(num / den) <= 1e-3, policy


def test_each_policy_keeps_what_it_names():
    """On one block (a Linear, a GELU, an ``int4_matmul``): ``full`` runs
    the whole forward again in the backward; ``dots`` keeps the Linear's
    product (no batch dimension) and recomputes the rest; ``everything``
    keeps every aten output; under every policy the int4 kernel Function's
    forward runs again (its plain product here, a ctypes launch on the
    card: no policy keeps what is inside a kernel Function)."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 64)
    packed, scales = quantize_pack_int4(torch.randn(32, 64) * 0.02)

    def block(x):
        h = torch.nn.functional.gelu(lin(x))
        return Int4Matmul.apply(h, packed, scales)

    ops = {}
    for policy in (None, "dots", "everything"):
        x = torch.randn(4, 8, 64, requires_grad=True)
        y = checkpoint_block(block, x, policy=policy).sum()
        with _Ops() as seen:
            y.backward()
        ops[policy] = seen.ops
    count = {p: (sum("addmm" in o for o in v), sum("gelu." in o for o in v),
                 sum(o == "aten.mm.default" for o in v))
             for p, v in ops.items()}
    # (Linear products, GELU forwards, plain mm) run in the backward
    assert count[None][:2] == (1, 1)
    assert count["dots"][:2] == (0, 1)
    assert count["everything"][:2] == (0, 0)
    # the int4 plain product and its dx: the same under every policy
    assert count[None][2] == count["dots"][2] == count["everything"][2] > 0


def test_policy_names_are_the_jax_packages():
    """The names JAX takes resolve here; an unknown name raises in both;
    ``set_remat_policy`` tags every checkpointing-capable module, as JAX's
    does (the tiny flagship: its encoder and decoder)."""
    for name in (None,) + POLICIES:
        jax_resolve_remat_policy(name)
        resolve_remat_policy(name)
    for pkg in (jax_resolve_remat_policy, resolve_remat_policy):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            pkg("selective")
    tw, _, _ = _flagship_wrapper()
    assert set_remat_policy(tw.model, "dots") == 2
    assert {m._remat_policy for m in tw.model.modules()
            if hasattr(m, "enable_gradient_checkpointing")} == {"dots"}
    with pytest.raises(ValueError, match="unknown remat_policy"):
        set_remat_policy(tw.model, "offload")
