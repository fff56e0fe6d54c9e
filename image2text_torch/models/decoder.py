"""Causal decoders (counterpart of ``image2text_tpu/models/decoder.py``).

* :func:`decoder_from_config` dispatches on the config's type, as the JAX
  ``Decoder.from_config`` does: the scratch decoder, or the HF family
  (``models/hf_decoders/``; GPT-2 so far).
* :class:`TransformerDecoder`, the scratch decoder: token table ``wte``,
  positional table ``wpe`` (or, with ``use_advanced_pos_emb``, the
  positional MLP, which *replaces* the embeddings: ``x = wpe(embeds)``,
  at the chunk's absolute positions in a cached forward), sparse or dense
  MQA/MHA blocks with cross-attention on even depths only, ``ln_f`` and
  the lm_head tied to ``wte`` with f32 accumulation and f32 logits.  Its
  GPT-2 initialisation (``pretrained_model``) checks the config against
  ``GPT2_MODEL_TABLE`` unless ``loose``; the GPT-2 weights enter through
  ``models/hf_import.py::import_gpt2_state_dict`` from a local state dict.
  In training the positions are dropped and, when the config enables
  gradient checkpointing, each block is recomputed in the backward with
  its bias and cross inputs.  Under
  ``models/quantization.py::int8_serving_params`` the tables read their
  int8 forms: token and position rows dequantised on gather, the tied
  lm_head W8A8 (JAX decoder.py:233, :278-285).
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from image2text_torch.configs.models import (GPT2_MODEL_TABLE,
                                             HuggingfaceDecoderConfig,
                                             MLPConfig, TransformerConfig,
                                             TransformerDecoderConfig)
from image2text_torch.models.kv_cache import KVCache
from image2text_torch.models.layers import (AdvancedPositionalBiasMLP,
                                            MoELinear, TransformerBlock)
from image2text_torch.nn.core import (EVAL_CTX, Ctx, SequenceParallel,
                                      dropout, normal_init, zeros_init)
from image2text_torch.nn.modules import Embedding, LayerNorm, Linear
from image2text_torch.ops.static_gather import canonicalize
from image2text_torch.training.remat import checkpoint_block


def mutate_transformer_config(config: TransformerConfig, depth: int,
                              skip_alternate_cross_attn: bool):
    """Disable cross-attention on odd depths."""
    if config.is_cross_attn and skip_alternate_cross_attn and depth % 2:
        config = copy.deepcopy(config)
        config.is_cross_attn = False
    return config


def decoder_from_config(config, space_for_prompt: int = 0, device=None,
                        loose: bool = False):
    """The decoder a config describes (JAX ``Decoder.from_config``): a
    GPT-2-initialised scratch decoder is checked against its GPT-2 size
    unless ``loose`` (the composite config's
    ``loose_match_decoder_state_dict``); its vocabulary never shrinks,
    and a ``lora_spec`` wraps it (``models/lora.py``)."""
    if isinstance(config, TransformerDecoderConfig):
        if config.pretrained_model is None:
            # LoRA only on GPT-2 weights: a from-scratch decoder's
            # lora_spec is ignored, as in JAX (decoder.py:57-58)
            return TransformerDecoder(config, space_for_prompt, device,
                                      loose=loose)
        check_gpt2_shapes(config, loose)
        model = TransformerDecoder(config, space_for_prompt, device,
                                   loose=loose)
        if config.lora_spec is not None:
            from image2text_torch.models.lora import apply_lora

            model = apply_lora(model, config.lora_spec)
            # the wrapped bases keep the GPT-2 draws (JAX keeps their
            # owner class for its init policy, lora.py:37-41); the
            # adapters keep theirs
            model._gpt2_init_policy()
        return model
    if isinstance(config, HuggingfaceDecoderConfig):
        from image2text_torch.models.hf_decoders.factory import (
            build_hf_decoder)

        return build_hf_decoder(config, device)
    raise ValueError("Unknown config type!!!")


def check_gpt2_shapes(config: TransformerDecoderConfig, loose: bool) -> None:
    """JAX decoder.py:58-71: unless ``loose``, the config must be the GPT-2
    it names (depth, width, heads, bias, 1,024 positions, dense, causal,
    a 4x MLP); the vocabulary must not shrink either way."""
    args = GPT2_MODEL_TABLE[config.pretrained_model]
    tc = config.transformer_config
    if not loose:
        ok = (config.n_layer == args["n_layer"]
              and tc.attn_config.n_embd == args["n_embd"]
              and tc.attn_config.n_head == args["n_head"]
              and tc.attn_config.bias is True
              and config.block_size == 1024 and not tc.is_sparse_attn
              and tc.is_causal is True
              and isinstance(tc.rotator_config, MLPConfig)
              and tc.rotator_config.ff_mult == 4)
        if not ok:
            raise ValueError("provided configs do not match the pretrained "
                             "model")
    if config.vocab_size < 50257:
        raise ValueError("vocab should not shrink")


class TransformerDecoder(nn.Module):
    def __init__(self, config: TransformerDecoderConfig,
                 space_for_prompt: int = 0, device=None, loose: bool = False):
        super().__init__()
        self.config = config
        self.pretrained_model = config.pretrained_model
        self.loose = loose
        self.skip_alternate_cross_attn = config.skip_alternate_cross_attn
        self.tied_aliases = {"lm_head.weight": "transformer.wte.weight"}
        n_embd = config.transformer_config.attn_config.n_embd
        self.transformer = nn.Module()
        self.transformer.wte = Embedding(config.vocab_size, n_embd, device)
        if config.use_advanced_pos_emb:
            self.transformer.wpe = AdvancedPositionalBiasMLP(
                config.block_size, n_embd, n_embd,
                config.advanced_pos_emb_gate_sizes, True, device)
        else:
            self.transformer.wpe = Embedding(config.block_size, n_embd,
                                             device)
        self.transformer.h = nn.ModuleList([
            TransformerBlock(
                mutate_transformer_config(config.transformer_config, depth,
                                          config.skip_alternate_cross_attn),
                depth, space_for_prompt, device)
            for depth in range(config.n_layer)])
        self.transformer.ln_f = LayerNorm(
            n_embd, config.transformer_config.attn_config.bias, device=device)
        self.dropout_rate = config.transformer_config.attn_config.dropout
        self.enable_gradient_checkpointing = (
            config.enable_gradient_checkpointing)
        self._remat_policy = None   # training/remat.py::set_remat_policy
        self._gpt2_init_policy()

    def _gpt2_init_policy(self):
        """GPT-2 initialisation of the JAX decoder (decoder.py:137-177):
        Linear, Embedding, stacked-expert and positional-MLP weights
        N(0, 0.02), a Linear weight whose path ends in 'c_proj.weight'
        N(0, 0.02 / sqrt(2 n_layer)), the biases zero."""
        proj_std = 0.02 / math.sqrt(2 * self.config.n_layer)
        for path, mod in self.named_modules():
            fns = getattr(mod, "_init_fns", {})
            if isinstance(mod, Linear):
                for name in fns:
                    std = (proj_std if path.endswith("c_proj") else 0.02)
                    fns[name] = (normal_init(std) if name == "weight"
                                 else zeros_init())
            elif isinstance(mod, Embedding):
                fns["weight"] = normal_init(0.02)
            elif isinstance(mod, MoELinear):
                for name in fns:
                    fns[name] = (normal_init(0.02) if name.endswith("weight")
                                 else zeros_init())
            elif isinstance(mod, AdvancedPositionalBiasMLP):
                for name in fns:
                    fns[name] = (normal_init(0.02) if name.startswith("w")
                                 else zeros_init())

    @property
    def blocks(self) -> nn.ModuleList:
        """``transformer.h`` (a property, not a second registration: one
        path per parameter, as ``torch.func.functional_call`` needs)."""
        return self.transformer.h

    @property
    def block_size(self) -> int:
        return self.config.block_size

    @property
    def n_embd(self) -> int:
        return self.config.transformer_config.attn_config.n_embd

    @property
    def is_causal(self) -> bool:
        return self.config.transformer_config.is_causal

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the decoder computes in (its embedding table's, or the
        one its int8 form records)."""
        return self.transformer.wte.stored_dtype

    supports_kv_cache = True

    def sdpa_calls(self, t: int) -> int:
        """Attention calls (``ops.attention.sdpa``) of one non-cached
        forward over a ``t``-row stream: one for each block that runs its
        body (``TransformerBlock.runs_body``); the cross-attention is
        ``MultiheadAttention``'s own."""
        return sum(blk.runs_body(t) for blk in self.blocks)

    def get_inputs_embeds(self, idx: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(idx)

    def _cross_depth(self, depth: int) -> bool:
        return not self.skip_alternate_cross_attn or depth % 2 == 0

    def precompute_cross_kv(self, enc: torch.Tensor, quant=None):
        """Per-depth split-head cross K/V of the (fixed) encoder output,
        computed once per generated sequence; ``quant='int8'`` stores them
        as ``QuantizedKV``."""
        return {depth: blk.cross_attn.project_kv(enc, enc, quant=quant)
                for depth, blk in enumerate(self.blocks)
                if blk.is_cross_attn and self._cross_depth(depth)}

    def forward(self, idx=None, inputs_embeds=None, cross_attn_embeds=None,
                attn_msk=None, kv_cache=None, pos_offset: int = 0,
                cross_kv=None, ctx: Ctx = EVAL_CTX, use_flash: bool = True,
                sparse_rule_len=None):
        """Returns (logits (b, t, V) f32, hidden state).  ``pos_offset``
        (a host int) places the chunk at global positions
        pos_offset + arange(t).  ``sparse_rule_len`` (the full-reforward
        fallback's current length, soft prompt included) goes to the
        sparse blocks, which then run in canonical order."""
        if inputs_embeds is None:
            inputs_embeds = self.get_inputs_embeds(idx)
        t = inputs_embeds.shape[-2]
        if pos_offset + t > self.block_size:
            raise ValueError(f"Cannot forward positions up to "
                             f"{pos_offset + t}, block size is only "
                             f"{self.block_size}")
        if kv_cache is not None:
            kv_cache.positions = pos_offset + np.arange(t)
        wpe = self.transformer.wpe
        if isinstance(wpe, AdvancedPositionalBiasMLP):
            x = wpe.forward_at(inputs_embeds, pos_offset + np.arange(t))
        else:
            pos_emb = wpe.rows(pos_offset, pos_offset + t)
            x = inputs_embeds + pos_emb.to(inputs_embeds.dtype)
        x, ctx = dropout(x, self.dropout_rate, ctx.fold(2))
        lazy = kv_cache is None and sparse_rule_len is None
        remat = (self.enable_gradient_checkpointing and ctx.train
                 and kv_cache is None)
        layout = None
        sp = SequenceParallel.of(self.blocks, x, ctx, kv_cache)
        if sp is not None:
            x = sp.split(x)
        for depth, blk in enumerate(self.blocks):
            cross_inputs = cross_attn_embeds if self._cross_depth(depth) \
                else None
            ckv = cross_kv.get(depth) if cross_kv is not None else None
            new_layout = blk.next_layout(layout, t) if lazy else None

            def run(x_, ci_, am_, blk_=blk, ckv_=ckv, layout_=layout,
                    ctx_=ctx.fold(100 + depth)):
                out = blk_(x_, cross_attn_inputs=ci_, attn_mask=am_,
                           kv_cache=kv_cache, cross_kv=ckv_, layout=layout_,
                           want_lazy=lazy, ctx=ctx_, use_flash=use_flash,
                           sparse_rule_len=sparse_rule_len)
                return out[0] if lazy else out

            ci = None if ckv is not None else cross_inputs
            if sp is not None:
                run = sp.wrap(run)
            x = (checkpoint_block(run, x, ci, attn_msk,
                                  policy=self._remat_policy) if remat
                 else run(x, ci, attn_msk))
            layout = new_layout
        if sp is not None:
            x = sp.gather(x)
        if layout is not None:
            x = canonicalize(x, layout)
        x = self.transformer.ln_f(x)
        return self.transformer.wte.lm_head(x), x

    # -- cached decoding ------------------------------------------------------
    def cache_exact_for_window(self, start: int, end: int) -> bool:
        """Whether cached decode over global positions [start, end) is
        exact: no sparse layer's selected count crosses 2 inside it."""
        for blk in self.blocks:
            if not blk.is_sparse:
                continue
            c = blk._cum_sel_np
            at_start = int(c[min(start - 1, len(c) - 1)]) if start > 0 else 0
            at_end = int(c[min(end - 1, len(c) - 1)]) if end > 0 else 0
            if at_start < 2 <= at_end:
                return False
        return True

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> KVCache:
        return KVCache.create([blk.cache_shape(batch, max_len)
                               for blk in self.blocks], dtype, device)

    def ffn_evaluations(self, pos_offset: int, t: int) -> int:
        """How many blocks run their body (and so their MoE FFN) in a
        cached forward over positions pos_offset + arange(t)."""
        positions = pos_offset + np.arange(t)
        return sum(blk.runs_body_at(positions) for blk in self.blocks)

    def reforward_ffn_evaluations(self, t: int, rule_len: int) -> int:
        """How many blocks run their body in a non-cached forward over a
        ``t``-row stream under ``sparse_rule_len=rule_len`` (the
        fallback's): every dense block; a sparse one when its selection
        keeps more than one row and the rule's count reaches 2."""
        return sum(blk.runs_body(t) and (not blk.is_sparse
                                         or blk.selected_count(rule_len) >= 2)
                   for blk in self.blocks)
