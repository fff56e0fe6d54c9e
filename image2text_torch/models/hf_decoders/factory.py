"""HF decoder family: the decoder interface around the GPT-2 backbone and
the ``model_str`` dispatch (counterpart of
``image2text_tpu/models/hf_decoders/factory.py``).

Known model strings resolve from the built-in architecture table, with no
network.  ``build_hf_decoder`` builds the GPT-2 decoder, then swaps its
frozen Linears for int4 ones under ``load_in_4bit`` (the cross-attention
modules stay in float), then wraps the LoRA targets.  The weights are the
port's initialisers' (random); pretrained GPT-2 weights import from a
state dict of numpy arrays with ``gpt2.import_hf_gpt2`` — the JAX
package fetches them through ``transformers`` over the network, which the
port does not.

Not ported yet (ROADMAP): the Llama, Qwen and Falcon families and local
HF checkpoint directories.
"""
from __future__ import annotations

import torch
from torch import nn

from image2text_torch.configs.models import HuggingfaceDecoderConfig
from image2text_torch.models.hf_decoders.gpt2 import GPT2Backbone
from image2text_torch.models.kv_cache import KVCache
from image2text_torch.nn.core import EVAL_CTX, Ctx

GPT2_TABLE = {
    "gpt2": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-medium": dict(n_layer=24, n_embd=1024, n_head=16),
    "gpt2-large": dict(n_layer=36, n_embd=1280, n_head=20),
    "gpt2-xl": dict(n_layer=48, n_embd=1600, n_head=25),
}
GPT2_POSITIONS = 1024


class HuggingfaceDecoder(nn.Module):
    """Shared plumbing: embeddings, the tied lm_head, the KV cache.  HF
    decoders are plain-causal, so the soft-prompt prefix lives in the
    decode cache (``prefix_in_decode``)."""

    prefix_in_decode = True
    is_causal = True
    supports_kv_cache = True

    def __init__(self, config: HuggingfaceDecoderConfig, block_size: int,
                 n_embd: int, embed_path: str):
        super().__init__()
        self.config = config
        self._block_size = block_size
        self._n_embd = n_embd
        self.embed_path = embed_path
        self.vocab_eff = config.vocab_size + config.extra_tokens
        self.tied_aliases = {"lm_head.weight": f"{embed_path}.weight"}

    def _embed(self):
        return self.get_submodule(self.embed_path)

    def get_inputs_embeds(self, idx: torch.Tensor) -> torch.Tensor:
        return self._embed()(idx)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied lm_head: products of the hidden dtype, f32 sums and f32
        logits (the JAX ``preferred_element_type=f32``); W8A8 on the
        table's int8 serving form (JAX factory.py:168-186)."""
        return self._embed().lm_head(hidden)

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

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> KVCache:
        return KVCache.create([blk.attn.kv_shape(batch, max_len)
                               for blk in self.blocks], dtype, device)


class GPT2HuggingfaceDecoder(HuggingfaceDecoder):
    def __init__(self, config: HuggingfaceDecoderConfig, device=None):
        if config.model_str not in GPT2_TABLE:
            raise ValueError(f"Unknown gpt2 model_str {config.model_str!r} "
                             f"— known: {sorted(GPT2_TABLE)}")
        args = GPT2_TABLE[config.model_str]
        super().__init__(config, block_size=GPT2_POSITIONS,
                         n_embd=args["n_embd"], embed_path="transformer.wte")
        self.transformer = GPT2Backbone(
            vocab_size=self.vocab_eff, n_positions=GPT2_POSITIONS,
            dropout_rate=0.1, cross_attn=config.use_cross_attn,
            device=device, **args)
        self.transformer.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.h

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


def build_hf_decoder(config: HuggingfaceDecoderConfig,
                     device=None) -> HuggingfaceDecoder:
    """``model_str`` dispatch, then 4-bit quantization, then LoRA."""
    s = config.model_str
    if s.startswith("gpt2"):
        if config.vocab_size < 50257:
            raise ValueError("vocab should not shrink")
        model = GPT2HuggingfaceDecoder(config, device)
    elif any(f in s.lower() for f in ("llama", "qwen", "falcon")):
        raise NotImplementedError(
            f"the {s!r} decoder family is not ported yet (ROADMAP: queue 1, "
            "HF decoders)")
    else:
        raise ValueError(f"Unknown huggingface model_str: {s!r} — known "
                         f"ids: {sorted(GPT2_TABLE)}")
    if config.load_in_4bit:
        from image2text_torch.models.quantization import (
            quantize_module_structure)

        # the (new, trainable) cross-attention modules stay in float
        quantize_module_structure(model, skip_paths=("crossattention",
                                                     "ln_cross_attn"))
    if config.lora_spec is not None:
        from image2text_torch.models.lora import apply_lora

        apply_lora(model, config.lora_spec)
    return model


__all__ = ["GPT2_TABLE", "GPT2HuggingfaceDecoder", "HuggingfaceDecoder",
           "build_hf_decoder"]
