"""Tiny forms of the HF-family configurations in both packages, on shared
weights (tests only; imported by ``tests/test_torch_hf_*.py``).

Each YAML is read by each package's own reader (pydantic in JAX, the
port's ``configs/reader.py``) and cut alike: the decoder's table entry
(``LLAMA_TABLE``, ``QWEN_TABLE``, ``FALCON_TABLE``, ``GPT2_TABLE``) is
patched in both packages to 2 layers of a narrow width, with the
family's shape kept (Llama-2's multi-head attention, Qwen-2's grouped
query heads and biases on 2 KV heads, Falcon's single KV head and
parallel attention, GPT-2's cross-attention); the vocabulary stays the
configuration's (each family has a floor); the pretrained ViT keeps its
width at depth 2 on 32² images, the scratch encoder is cut as the tiny
GPT-2-medium captioner's.  The JAX model's int4 weights (zero from its
initialiser) are the quantized image of N(0, 0.02) matrices and its LoRA
B N(0, 0.02); the weights cross to the port by ``export_state_dict`` →
``load_jax_state_dict``.
"""
import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.models import encoder as jenc
from image2text_tpu.models.hf_decoders import factory as jfactory
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.ops.int4_matmul import quantize_pack_int4
from image2text_tpu.utils.checkpoint import export_state_dict
from image2text_tpu.utils.tree import flatten, unflatten

from image2text_torch.configs.reader import load_training_config
from image2text_torch.models import encoder as tenc
from image2text_torch.models.hf_decoders import factory as tfactory
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.utils.checkpoint import load_jax_state_dict

CONFIGS = {
    "llama13b": "training_configs/tpu/llama2-13b.yaml",
    "llama7b": "training_configs/local/llama2-7b.yaml",
    "qwen": "training_configs/local/qwen-1.5b-deepseek-distill.yaml",
    "falcon7b": "training_configs/tpu/falcon-7b.yaml",
    "gpt2xl": "training_configs/tpu/gpt2-xl.yaml",
}
VIT_TINY = dict(image_size=32, num_layers=2)
# (table name, model_str, the tiny entry's fields)
TINY = {
    "llama13b": ("LLAMA_TABLE", "meta-llama/Llama-2-13b-hf",
                 dict(n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
                      intermediate=96)),
    "llama7b": ("LLAMA_TABLE", "meta-llama/Llama-2-7b-hf",
                dict(n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
                     intermediate=96)),
    "qwen": ("QWEN_TABLE", "deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B",
             dict(n_layer=2, n_embd=96, n_head=6, n_kv_head=2,
                  intermediate=128)),
    "falcon7b": ("FALCON_TABLE", "tiiuae/falcon-7b",
                 dict(n_layer=2, n_embd=64, n_head=4)),
    "gpt2xl": ("GPT2_TABLE", "gpt2-xl", dict(n_layer=2, n_embd=96,
                                             n_head=4)),
}
BOS = {"llama13b": 1, "llama7b": 1, "qwen": 151646, "falcon7b": 11,
       "gpt2xl": 50256}
IMAGE_SIZE = {"llama13b": 32, "llama7b": 32, "qwen": 32, "falcon7b": 64,
              "gpt2xl": 64}


def _tiny_entry(entry, fields):
    if isinstance(entry, dict):
        return dict(entry, **fields)
    return dataclasses.replace(entry, **fields)


@contextmanager
def patched(mp=None):
    """Both packages' tables at the tiny sizes, the ViT at VIT_TINY, the
    JAX init's pretrained-weight fetch replaced by nothing (random
    weights)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "VIT_B16_ARGS", VIT_TINY)
        mp.setattr(tenc, "VIT_B16_ARGS", VIT_TINY)
        for table, key, fields in TINY.values():
            for pkg in (jfactory, tfactory):
                t = getattr(pkg, table)
                mp.setitem(t, key, _tiny_entry(t[key], fields))
        mp.setattr(jfactory, "load_hf_weights", lambda dec, params: params)
        yield mp


def cut(cfg, name: str):
    """The tiny form of ``cfg.model`` (either package's config object)."""
    m = cfg.model
    enc, dec = m.vision_encoder_config, m.decoder_config
    dec.enable_gradient_checkpointing = False
    if hasattr(enc, "n_embd_out_vit"):       # the pretrained ViT
        # Qwen: a bridge 128 → 96, as 4096 → 1536; else none, as in the YAMLs
        enc.n_cls, enc.gate_sizes = 4, (32,)
        enc.n_embd_out_vit = 128 if name == "qwen" else 64
    else:                                    # the scratch encoder
        enc.n_layer, enc.n_cls = 2, 8
        enc.input.width = enc.input.height = 64
        enc.num_patches = 8
        enc.transformer_config.attn_config.n_embd = 64
        enc.transformer_config.attn_config.n_head = 4
        enc.transformer_config.max_block_size = 80
        enc.enable_gradient_checkpointing = False
    return m


def randomize(params, seed=0):
    """Int4 weights quantized from N(0, 0.02) matrices, LoRA B N(0, 0.02)
    (JAX's initialisers leave both zero)."""
    rng = np.random.default_rng(seed)
    flat = flatten(params)
    for k, v in list(flat.items()):
        if v.dtype == jnp.uint8:
            w = rng.standard_normal((v.shape[0], 2 * v.shape[1])) * 0.02
            q, s = quantize_pack_int4(w.astype(np.float32))
            flat[k], flat[k + "_scales"] = jnp.asarray(q), jnp.asarray(s)
        elif ".lora_B." in k:
            flat[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.02,
                                  jnp.float32)
    return unflatten(flat)


def build_pair(name: str, seed: int = 0):
    """(JAX model, its params, the exported state dict, the port's model
    on the CPU with those weights); the tables stay patched only while
    they are built (the built models hold their own architectures)."""
    with patched():
        with open(CONFIGS[name]) as f:
            jcfg = cut(JTrainingConfig.model_validate(yaml.safe_load(f)),
                       name)
        tcfg = cut(load_training_config(CONFIGS[name]), name)
        jm = JaxModel(jcfg)
        jm.decoder._load_weights = False
        params = randomize(jm.init(jax.random.PRNGKey(seed)), seed + 1)
        sd = export_state_dict(jm, params)
        tm = VisionEncoderDecoder(tcfg, device="cpu")
        load_jax_state_dict(tm, sd)
    return jm, params, sd, tm


def images(name: str, b: int = 2, seed: int = 0):
    s = IMAGE_SIZE[name]
    return np.random.default_rng(seed).standard_normal(
        (b, 3, s, s)).astype(np.float32)


def vocab(tm) -> int:
    return tm.decoder._embed().weight.shape[0]
