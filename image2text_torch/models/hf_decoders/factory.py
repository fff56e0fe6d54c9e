"""HF decoder family: the decoder interface around the GPT-2, Llama/Qwen
and Falcon backbones and the ``model_str`` dispatch (counterpart of
``image2text_tpu/models/hf_decoders/factory.py``).

Known model strings resolve from the built-in architecture tables, and a
local HF checkpoint directory (or its ``config.json``) from that file's
``model_type``, with no network.  ``build_hf_decoder`` builds the decoder,
its frozen Linears int4 under ``load_in_4bit`` (built so from the start:
the float weights of a 13B model are never allocated; the cross-attention
modules stay in float), then wraps the LoRA targets.  The weights are the
port's initialisers' (random); pretrained ones import from a state dict of
numpy arrays (``gpt2.import_hf_gpt2``, ``llama.import_hf_llama``,
``falcon.import_hf_falcon``; ``models/nf4.py`` decodes a bitsandbytes 4-bit
one first) — the JAX package fetches them through ``transformers`` over
the network, which the port does not (:func:`load_hf_weights` raises).

Block sizes and vocabulary floors are the JAX package's: GPT-2 1024
positions (a local config's ``n_positions``), vocabulary ≥ 50,257;
Llama-2 4096, ≥ 32,000; Qwen from its table, ≥ 151,936; Falcon 2048,
≥ 65,024.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch
from torch import nn

from image2text_torch.configs.models import HuggingfaceDecoderConfig
from image2text_torch.models.hf_decoders.falcon import (FalconArch,
                                                        FalconBackbone,
                                                        import_hf_falcon)
from image2text_torch.models.hf_decoders.gpt2 import (GPT2Backbone,
                                                      import_hf_gpt2)
from image2text_torch.models.hf_decoders.llama import (LlamaArch,
                                                       LlamaBackbone,
                                                       import_hf_llama)
from image2text_torch.models.kv_cache import KVCache
from image2text_torch.nn.core import EVAL_CTX, Ctx
from image2text_torch.nn.modules import Embedding

GPT2_TABLE = {
    "gpt2": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-medium": dict(n_layer=24, n_embd=1024, n_head=16),
    "gpt2-large": dict(n_layer=36, n_embd=1280, n_head=20),
    "gpt2-xl": dict(n_layer=48, n_embd=1600, n_head=25),
}
GPT2_POSITIONS = 1024

LLAMA_TABLE = {
    "meta-llama/Llama-2-7b-hf": LlamaArch(
        vocab_size=32000, n_layer=32, n_embd=4096, n_head=32, n_kv_head=32,
        intermediate=11008, max_positions=4096),
    "meta-llama/Llama-2-13b-hf": LlamaArch(
        vocab_size=32000, n_layer=40, n_embd=5120, n_head=40, n_kv_head=40,
        intermediate=13824, max_positions=4096),
}

QWEN_TABLE = {
    "deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B": LlamaArch(
        vocab_size=151936, n_layer=28, n_embd=1536, n_head=12, n_kv_head=2,
        intermediate=8960, max_positions=131072, rope_theta=10000.0,
        rms_eps=1e-6, qkv_bias=True, tie_embeddings=True),
}

FALCON_TABLE = {
    "tiiuae/falcon-7b": FalconArch(
        vocab_size=65024, n_layer=32, n_embd=4544, n_head=71,
        max_positions=2048),
    "tiiuae/falcon-7b-instruct": FalconArch(
        vocab_size=65024, n_layer=32, n_embd=4544, n_head=71,
        max_positions=2048),
}

_CROSS_ATTN_REFUSED = ("Don't know how to use cross attention with this "
                       "model. Suggest you try a different config!!!")


def _resolve_local_hf_config(model_str: str) -> Optional[dict]:
    """The parsed ``config.json`` when ``model_str`` names a local HF
    checkpoint directory holding one, or the file itself; None for a model
    id."""
    path = None
    if os.path.isfile(model_str) and model_str.endswith(".json"):
        path = model_str
    elif os.path.isdir(model_str):
        cand = os.path.join(model_str, "config.json")
        if os.path.isfile(cand):
            path = cand
    if path is None:
        return None
    with open(path) as f:
        return json.load(f)


def arch_from_hf_config(cfg: dict):
    """An HF ``config.json`` dict → (family, architecture): ``gpt2`` (a
    dict of widths and ``n_positions``), ``llama`` or ``qwen2`` (a
    :class:`LlamaArch`), ``falcon`` (a :class:`FalconArch`; multi-query
    only).  Any other ``model_type`` raises."""
    mt = cfg.get("model_type")
    if mt == "gpt2":
        return "gpt2", dict(
            n_layer=cfg["n_layer"], n_embd=cfg["n_embd"],
            n_head=cfg["n_head"], n_positions=cfg.get("n_positions", 1024),
            vocab_size=cfg.get("vocab_size", 50257))
    if mt in ("llama", "qwen2"):
        return mt, LlamaArch(
            vocab_size=cfg["vocab_size"],
            n_layer=cfg["num_hidden_layers"],
            n_embd=cfg["hidden_size"],
            n_head=cfg["num_attention_heads"],
            n_kv_head=cfg.get("num_key_value_heads",
                              cfg["num_attention_heads"]),
            intermediate=cfg["intermediate_size"],
            max_positions=cfg.get("max_position_embeddings", 4096),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
            qkv_bias=(mt == "qwen2"),
            tie_embeddings=cfg.get("tie_word_embeddings", False))
    if mt == "falcon":
        if not cfg.get("multi_query", True):
            raise ValueError("Only multi_query falcon architectures are "
                             "supported (falcon-7b family)")
        return "falcon", FalconArch(
            vocab_size=cfg["vocab_size"],
            n_layer=cfg["num_hidden_layers"],
            n_embd=cfg["hidden_size"],
            n_head=cfg["num_attention_heads"],
            max_positions=cfg.get("max_position_embeddings", 2048),
            rope_theta=cfg.get("rope_theta", 10000.0),
            ln_eps=cfg.get("layer_norm_epsilon", 1e-5))
    raise ValueError(
        f"Unsupported HF model_type {mt!r} in config.json — supported "
        "families: gpt2, llama, qwen2, falcon")


class HuggingfaceDecoder(nn.Module):
    """Shared plumbing: the token table, the lm_head (tied to the table, or
    an untied ``lm_head`` table), the KV cache.  HF decoders are
    plain-causal, so the soft-prompt prefix lives in the decode cache
    (``prefix_in_decode``)."""

    prefix_in_decode = True
    is_causal = True
    supports_kv_cache = True

    def __init__(self, config: HuggingfaceDecoderConfig, block_size: int,
                 n_embd: int, tied: bool, embed_path: str):
        super().__init__()
        self.config = config
        self._block_size = block_size
        self._n_embd = n_embd
        self.tied = tied
        self.embed_path = embed_path
        self.vocab_eff = config.vocab_size + config.extra_tokens
        if tied:
            self.tied_aliases = {"lm_head.weight": f"{embed_path}.weight"}

    def _embed(self) -> Embedding:
        return self.get_submodule(self.embed_path)

    def get_inputs_embeds(self, idx: torch.Tensor) -> torch.Tensor:
        return self._embed()(idx)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The lm_head (the token table, or the untied ``lm_head``):
        products of the hidden dtype, f32 sums and f32 logits (the JAX
        ``preferred_element_type=f32``); W8A8 on a table's int8 serving
        form (JAX factory.py:168-186)."""
        head = self._embed() if self.tied else self.lm_head
        return head.lm_head(hidden)

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def n_embd(self) -> int:
        return self._n_embd

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the decoder computes in (its embedding table's, or the
        one its int8 form records)."""
        return self._embed().stored_dtype

    def _block_attns(self):
        """Each block's self-attention, in depth order."""
        raise NotImplementedError

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> KVCache:
        return KVCache.create([attn.kv_shape(batch, max_len)
                               for attn in self._block_attns()], dtype,
                              device)


class GPT2HuggingfaceDecoder(HuggingfaceDecoder):
    def __init__(self, config: HuggingfaceDecoderConfig, device=None,
                 args: Optional[dict] = None):
        """``args``: widths and ``n_positions`` from a local config.json
        (:func:`arch_from_hf_config`), else the table entry of
        ``config.model_str``."""
        if args is None:
            if config.model_str not in GPT2_TABLE:
                raise ValueError(
                    f"Unknown gpt2 model_str {config.model_str!r} — known: "
                    f"{sorted(GPT2_TABLE)}; or pass a local HF checkpoint "
                    "dir / config.json path as model_str")
            args = dict(GPT2_TABLE[config.model_str],
                        n_positions=GPT2_POSITIONS)
        args = dict(args)
        args.pop("vocab_size", None)
        n_positions = args.pop("n_positions", GPT2_POSITIONS)
        super().__init__(config, block_size=n_positions,
                         n_embd=args["n_embd"], tied=True,
                         embed_path="transformer.wte")
        self.transformer = GPT2Backbone(
            vocab_size=self.vocab_eff, n_positions=n_positions,
            dropout_rate=0.1, cross_attn=config.use_cross_attn,
            device=device, **args)
        self.transformer.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.h

    def _block_attns(self):
        return [blk.attn for blk in self.blocks]

    def sdpa_calls(self, t: int) -> int:
        """Attention calls (``ops.attention.sdpa``) of one non-cached
        forward: each block's self-attention and, with cross-attention on,
        its cross-attention."""
        return len(self.blocks) * (2 if self.config.use_cross_attn else 1)

    def forward(self, idx=None, inputs_embeds=None, cross_attn_embeds=None,
                attn_msk=None, kv_cache=None, pos_offset: int = 0,
                cross_kv=None, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                sparse_rule_len=None):
        """Returns (logits (b, t, V) f32, hidden state).  ``attn_msk`` is
        ignored, as by the JAX decoder: under soft prompting the composite
        model's -inf text→prefix bias is dropped and the text rows attend
        the image prefix through the plain causal mask.  So is
        ``sparse_rule_len`` (no sparse layer)."""
        if inputs_embeds is None:
            inputs_embeds = self.get_inputs_embeds(idx)
        enc = cross_attn_embeds if self.config.use_cross_attn else None
        hidden = self.transformer(inputs_embeds, enc=enc, ctx=ctx,
                                  use_flash=use_flash, kv_cache=kv_cache,
                                  pos_offset=pos_offset, cross_kv=cross_kv)
        return self._logits(hidden), hidden

    def precompute_cross_kv(self, enc: torch.Tensor, quant=None):
        """Per-depth cross K/V of the fixed encoder output (decode time);
        ``quant='int8'`` stores them as ``QuantizedKV``."""
        if not self.config.use_cross_attn:
            return {}
        return {depth: blk.crossattention.project_kv(enc, quant=quant)
                for depth, blk in enumerate(self.blocks)}


class _BackboneDecoder(HuggingfaceDecoder):
    """Llama/Qwen/Falcon: soft prompting only; cross-attention raises (as
    the JAX decoder, after the reference)."""

    _root = ""   # the backbone's attribute: 'model' or 'transformer'

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self._root)

    def sdpa_calls(self, t: int) -> int:
        return len(self.blocks)

    def forward(self, idx=None, inputs_embeds=None, cross_attn_embeds=None,
                attn_msk=None, kv_cache=None, pos_offset: int = 0,
                cross_kv=None, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                sparse_rule_len=None):
        """Returns (logits (b, t, V) f32, hidden state); ``attn_msk`` and
        ``sparse_rule_len`` are ignored, as by the GPT-2 decoder."""
        if self.config.use_cross_attn:
            raise ValueError(_CROSS_ATTN_REFUSED)
        if inputs_embeds is None:
            inputs_embeds = self.get_inputs_embeds(idx)
        hidden = self.backbone(inputs_embeds, ctx=ctx, use_flash=use_flash,
                               kv_cache=kv_cache, pos_offset=pos_offset)
        return self._logits(hidden), hidden

    def precompute_cross_kv(self, enc: torch.Tensor, quant=None):
        if self.config.use_cross_attn:
            raise ValueError(_CROSS_ATTN_REFUSED)
        return {}


class LlamaHuggingfaceDecoder(_BackboneDecoder):
    """Llama-2 and Qwen-2: the ``model`` backbone and, unless the arch ties
    it to the token table, an untied ``lm_head`` table (an ``Embedding``:
    the same (vocab, dim) layout, and the W8A8 transform's module-typed
    walk recognises it)."""

    _root = "model"

    def __init__(self, config: HuggingfaceDecoderConfig, arch: LlamaArch,
                 min_vocab: int, device=None):
        if config.vocab_size < min_vocab:
            raise ValueError("vocab should not shrink")
        # a copy: the table entries are shared module state
        arch = dataclasses.replace(
            arch, vocab_size=config.vocab_size + config.extra_tokens)
        super().__init__(config, block_size=arch.max_positions,
                         n_embd=arch.n_embd, tied=arch.tie_embeddings,
                         embed_path="model.embed_tokens")
        self.arch = arch
        self.model = LlamaBackbone(arch, device)
        self.model.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)
        if not arch.tie_embeddings:
            self.lm_head = Embedding(arch.vocab_size, arch.n_embd, device,
                                     init_std=0.02)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.model.layers

    def _block_attns(self):
        return [blk.self_attn for blk in self.blocks]


class FalconHuggingfaceDecoder(_BackboneDecoder):
    _root = "transformer"

    def __init__(self, config: HuggingfaceDecoderConfig, arch: FalconArch,
                 device=None):
        if config.vocab_size < 65024:
            raise ValueError("vocab should not shrink")
        arch = dataclasses.replace(
            arch, vocab_size=config.vocab_size + config.extra_tokens)
        super().__init__(config, block_size=arch.max_positions,
                         n_embd=arch.n_embd, tied=True,
                         embed_path="transformer.word_embeddings")
        self.arch = arch
        self.transformer = FalconBackbone(arch, device)
        self.transformer.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.h

    def _block_attns(self):
        return [blk.self_attention for blk in self.blocks]


def _table_arch(table: dict, family: str, s: str):
    if s not in table:
        raise ValueError(
            f"Unknown {family} model_str {s!r} — known: {sorted(table)}; or "
            "pass a local HF checkpoint dir / config.json path as model_str")
    return table[s]


def _llama_importer(arch: LlamaArch):
    def importer(decoder, sd, loose=False):
        import_hf_llama(decoder, sd, loose,
                        tie_embeddings=arch.tie_embeddings)
    return importer


def _dispatch(config: HuggingfaceDecoderConfig, device):
    """(decoder, importer) for ``config.model_str``, in JAX's order: a local
    checkpoint directory or config.json, then ``gpt2*``, Llama-2, Qwen,
    falcon."""
    s = config.model_str
    local = _resolve_local_hf_config(s)
    if local is not None:
        family, arch = arch_from_hf_config(local)
        if family == "gpt2":
            return (GPT2HuggingfaceDecoder(config, device, args=arch),
                    import_hf_gpt2)
        if family in ("llama", "qwen2"):
            return (LlamaHuggingfaceDecoder(config, arch, arch.vocab_size,
                                            device), _llama_importer(arch))
        return FalconHuggingfaceDecoder(config, arch, device), import_hf_falcon
    if s.startswith("gpt2"):
        if config.vocab_size < 50257:
            raise ValueError("vocab should not shrink")
        return GPT2HuggingfaceDecoder(config, device), import_hf_gpt2
    if "Llama-2" in s or "llama-2" in s.lower():
        arch = _table_arch(LLAMA_TABLE, "Llama-2", s)
        return (LlamaHuggingfaceDecoder(config, arch, 32000, device),
                _llama_importer(arch))
    if "Qwen" in s or "qwen" in s.lower():
        arch = _table_arch(QWEN_TABLE, "Qwen", s)
        return (LlamaHuggingfaceDecoder(config, arch, 151936, device),
                _llama_importer(arch))
    if "falcon" in s.lower():
        arch = _table_arch(FALCON_TABLE, "falcon", s)
        return FalconHuggingfaceDecoder(config, arch, device), import_hf_falcon
    raise ValueError(
        f"Unknown huggingface model_str: {s!r} — known ids: "
        f"{sorted(GPT2_TABLE) + sorted(LLAMA_TABLE) + sorted(QWEN_TABLE) + sorted(FALCON_TABLE)}; "
        "or pass a local HF checkpoint dir / config.json path")


def build_hf_decoder(config: HuggingfaceDecoderConfig,
                     device=None) -> HuggingfaceDecoder:
    """The decoder ``config.model_str`` names (:func:`_dispatch`), int4
    under ``load_in_4bit`` (the cross-attention modules stay in float),
    then LoRA.  Its ``hf_importer(decoder, state_dict, loose=False)`` fills
    it from an HF state dict of numpy arrays."""
    if config.load_in_4bit:
        from image2text_torch.models.quantization import build_int4

        built = {}

        def build(dev):
            built["model"], built["importer"] = _dispatch(config, dev)
            return built["model"]

        model = build_int4(build, device, skip_paths=("crossattention",
                                                      "ln_cross_attn"))
        importer = built["importer"]
    else:
        model, importer = _dispatch(config, device)
    model.hf_importer = importer
    if config.lora_spec is not None:
        from image2text_torch.models.lora import apply_lora

        apply_lora(model, config.lora_spec)
    return model


def load_hf_weights(decoder, params=None):
    """The JAX package's ``from_pretrained`` fetch has no counterpart: the
    port never downloads.  Import a local state dict instead."""
    raise RuntimeError(
        f"the port does not fetch {decoder.config.model_str!r} from the "
        "network: pass an HF state dict of numpy arrays to "
        "decoder.hf_importer (gpt2.import_hf_gpt2, llama.import_hf_llama, "
        "falcon.import_hf_falcon; models/nf4.py decodes a bitsandbytes "
        "4-bit state dict first)")


__all__ = ["FALCON_TABLE", "FalconHuggingfaceDecoder", "GPT2_TABLE",
           "GPT2HuggingfaceDecoder", "HuggingfaceDecoder", "LLAMA_TABLE",
           "LlamaHuggingfaceDecoder", "QWEN_TABLE", "arch_from_hf_config",
           "build_hf_decoder", "load_hf_weights"]
