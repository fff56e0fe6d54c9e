"""Tiny forms of the pretrained-ViT configurations in both packages, on
shared weights (tests only; imported by ``tests/test_torch_nano_*.py``).

Each YAML is read by each package's own reader (pydantic in JAX, the
port's ``configs/reader.py``) and cut alike: the ViT-B/16 backbone keeps
its width (768) at depth 2 and 32² images (``VIT_B16_ARGS`` in both
packages), the heads and decoders get a few narrow layers; what the
configuration is made of stays (positional MLP, PEER or LSH head; the
bridge where the widths differ; the sparse MQA/MoE decoder with the
positional MLP, the GPT-2-initialised MHA decoder imported loose from a
numpy GPT-2 state dict, or the HF GPT-2 with LoRA).  The JAX weights cross
to the port by ``export_state_dict`` → ``load_jax_state_dict``.
"""
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models import encoder as jenc
from image2text_tpu.models import hf_import as jhf
from image2text_tpu.models.hf_decoders import factory as jfactory
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten, unflatten

from image2text_torch.configs.reader import load_training_config
from image2text_torch.models import encoder as tenc
from image2text_torch.models.hf_decoders import factory as tfactory
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.utils.checkpoint import load_jax_state_dict

VIT_TINY = dict(image_size=32, num_layers=2)
TINY_GPT2 = dict(n_layer=2, n_embd=64, n_head=4)
CONFIGS = {
    "nano-mini": "training_configs/local/nano-mini.yaml",
    "nano": "training_configs/tpu/nano.yaml",
    "nano-lsh": "training_configs/local/nano.yaml",
    "gpt2": "training_configs/local/gpt2.yaml",
}


def _cut_decoder(dec, vocab):
    dec.n_layer, dec.block_size = 2, 64
    dec.vocab_size = vocab
    dec.enable_gradient_checkpointing = False
    tc = dec.transformer_config
    tc.attn_config.n_embd, tc.attn_config.n_head = 64, 4
    if tc.is_sparse_attn:
        tc.max_block_size = 80


def cut(cfg, name: str):
    """The tiny form of ``cfg.model`` (either package's config object)."""
    m = cfg.model
    enc, dec = m.vision_encoder_config, m.decoder_config
    if name == "nano-mini":
        enc.n_cls, enc.gate_sizes, enc.n_embd_out_vit = 4, (32,), 48
        _cut_decoder(dec, 512)           # bridge 48 → 64, as 768 → 1024
    elif name == "nano":
        enc.n_cls, enc.n_embd_out_vit = 2, 96   # bridge 96 → 64
        pc = enc.peer_config
        pc.num_units_sqrt, pc.topk, pc.nhead, pc.query_dim = 8, 4, 2, 16
        _cut_decoder(dec, 50257)
    elif name == "nano-lsh":
        enc.n_cls, enc.n_embd_out_vit = 2, 64   # no bridge, as 768 = 768
        _cut_decoder(dec, 50257)
    else:
        enc.n_cls, enc.gate_sizes, enc.n_embd_out_vit = 4, (32,), 64
        dec.enable_gradient_checkpointing = False
    return m


def gpt2_state_dict(vocab=128, positions=64, d=32, n_layer=2, seed=0):
    """An HF ``GPT2LMHeadModel`` state dict of seeded normals, built in
    numpy: HF key names, Conv1D (in, out) weights, the causal-mask
    buffers and the tied ``lm_head.weight``."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.02):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"transformer.wte.weight": w(vocab, d),
          "transformer.wpe.weight": w(positions, d, s=0.01)}
    for i in range(n_layer):
        h = f"transformer.h.{i}."
        sd.update({
            h + "ln_1.weight": 1 + w(d), h + "ln_1.bias": w(d),
            h + "attn.bias": np.tril(np.ones((1, 1, positions, positions),
                                             np.float32)),
            h + "attn.masked_bias": np.asarray(-1e4, np.float32),
            h + "attn.c_attn.weight": w(d, 3 * d),
            h + "attn.c_attn.bias": w(3 * d),
            h + "attn.c_proj.weight": w(d, d), h + "attn.c_proj.bias": w(d),
            h + "ln_2.weight": 1 + w(d), h + "ln_2.bias": w(d),
            h + "mlp.c_fc.weight": w(d, 4 * d), h + "mlp.c_fc.bias": w(4 * d),
            h + "mlp.c_proj.weight": w(4 * d, d),
            h + "mlp.c_proj.bias": w(d)})
    sd["transformer.ln_f.weight"] = 1 + w(d)
    sd["transformer.ln_f.bias"] = w(d)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


@contextmanager
def patched():
    """Both packages at the tiny backbone and GPT-2 sizes; the JAX init's
    GPT-2 download replaced by the import of a local state dict."""
    sd = gpt2_state_dict(vocab=50257, positions=128, d=64, seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "VIT_B16_ARGS", VIT_TINY)
        mp.setattr(tenc, "VIT_B16_ARGS", VIT_TINY)
        mp.setitem(jfactory.GPT2_TABLE, "gpt2", TINY_GPT2)
        mp.setitem(tfactory.GPT2_TABLE, "gpt2", TINY_GPT2)
        mp.setattr(jfactory, "load_hf_weights", lambda dec, params: params)
        mp.setattr(jhf, "load_pretrained_gpt2_params",
                   lambda params, mt, vocab, loose:
                   jhf.import_gpt2_state_dict(params, sd, loose=loose))
        yield sd


def _lora_b(params, seed=3):
    """LoRA B N(0, 0.02): its zero initialiser would make the adapters
    vanish."""
    rng = np.random.default_rng(seed)
    flat = flatten(params)
    for k, v in flat.items():
        if ".lora_B." in k:
            flat[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.02,
                                  jnp.float32)
    return unflatten(flat)


def build_pair(name: str, seed: int = 0):
    """(JAX model, its params, the exported state dict, the port's model
    on the CPU with those weights, the GPT-2 state dict of the init)."""
    with patched() as gpt2_sd:
        with open(CONFIGS[name]) as f:
            jcfg = cut(JTrainingConfig.model_validate(yaml.safe_load(f)),
                       name)
        tcfg = cut(load_training_config(CONFIGS[name]), name)
        jm = JaxModel(jcfg)
        if name == "gpt2":
            jm.decoder._load_weights = False
        params = jm.init(jax.random.PRNGKey(seed))
        if name == "gpt2":
            params = _lora_b(params)
        sd = export_state_dict(jm, params)
        tm = VisionEncoderDecoder(tcfg, device="cpu")
        load_jax_state_dict(tm, sd)
    return jm, params, sd, tm, gpt2_sd


def images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 32, 32)).astype(np.float32)


def vocab(tm) -> int:
    return tm.decoder.transformer.wte.weight.shape[0]
