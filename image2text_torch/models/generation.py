"""Autoregressive generation (counterpart of
``image2text_tpu/models/generation.py``).

The cached branch: precompute the cross-attention K/V per cross depth,
prefill the prompt once on them, then one single-token cached decoder step
per new token.  The scratch decoder's prefill skips the soft-prompt prefix
(it is dead for text logits there) and starts at offset
``space_for_prompt``; a decoder with ``prefix_in_decode`` (the
plain-causal HF decoders) prefills ``[encoder output; prompt embeddings]``
at position 0 into a cache of ``space_for_prompt + total`` slots, as the
JAX package's prefix-in-decode branch does.  The sampler reads the last
logits cast to the compute dtype (the encoder output's), as in JAX.
``cross_kv_quant='int8'`` decodes against an int8 cross-attention memory
(``nn/modules.py::QuantizedKV``); the prefill reads the exact K/V, as
JAX's prefill, which projects them itself.

The other branches of JAX's ``generate``:

* the **full-reforward fallback**, for windows where a sparse layer's
  selected count crosses 2 inside the decode window (a cached prefix
  cannot reproduce the reference's global bypass rule there) or under
  ``force_no_cache``: the whole fixed-size id buffer is re-forwarded
  every step under ``sparse_rule_len = space_for_prompt + cur`` and the
  logits are read at ``cur - 1``;
* the **bidirectional-decoder branch**: the growing sequence is
  re-forwarded every step (every position sees the whole sequence, so a
  fixed buffer's unwritten slots would leak into the logits).

Each step samples as the JAX package's ``_sample_step``: the fused n-gram
ban + top-k sampler where it applies (greedy, or top-k without nucleus),
else the bans into the f32 logits, then greedy argmax or
``sampling.sample_logits`` (top-k, nucleus).  ``approx_top_k`` is passed
to the fused sampler, which takes it as exact (``models/sampling.py``).

Under a model split (``parallel/sharding_rules.py::place_params``) every
rank of a model group generates for the same rows and gets the same
tokens (JAX ``tests/test_generation.py:543``): the attention and MLP
projections compute on their shards with the model group's collectives,
the KV caches hold the rank's heads (``kv_shape``), and the eval kernels
(``sparse_block``/``fused_block``, ``moe_ffn``, the front), which read
whole operands, take the layers they read gathered whole (once per
parameter version, ``nn/modules.py::whole_param``) and run on every rank:
no eval kernel is bypassed.  Beam search under a mesh:
``models/generation_utils.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from image2text_torch.models.kv_cache import CacheRef, KVCache
from image2text_torch.models.sampling import (apply_no_repeat_ngram,
                                              sample_logits,
                                              sample_topk_with_ngram)
from image2text_torch.nn.modules import quantize_kv
from image2text_torch.models.encoder import PretrainedViT
from image2text_torch.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                             resize_normalize_on_device)


def decoder_step(model, tok_ids: Optional[torch.Tensor], cache: KVCache,
                 pos_offset: int, cross: Optional[torch.Tensor],
                 cross_kv=None, inputs_embeds: Optional[torch.Tensor] = None):
    """One cached decoder forward on a (B, t) chunk of ids (or directly on
    embeddings); returns (logits (B, t, V), cache) with the cache advanced
    in place."""
    ref = CacheRef(cache)
    logits, _ = model.decoder(idx=tok_ids, inputs_embeds=inputs_embeds,
                              cross_attn_embeds=None if cross_kv else cross,
                              kv_cache=ref, pos_offset=pos_offset,
                              cross_kv=cross_kv)
    return logits, cache


def prefill(model, encoder_output: torch.Tensor, prompt_ids: torch.Tensor,
            total: int, cross_kv=None):
    """The cache for ``total`` text positions, filled by the prompt:
    (logits of the prefill (B, t, V), cache).  ``cross_kv``, the
    precomputed cross K/V, spares the prefill its own projections."""
    dec, dev = model.decoder, encoder_output.device
    bs, cdt = encoder_output.shape[0], encoder_output.dtype
    cross = encoder_output if model.use_cross_attn else None
    off = model.space_for_prompt
    if getattr(dec, "prefix_in_decode", False) and model.use_soft_prompting:
        cache = dec.init_cache(bs, off + total, cdt, dev)
        embeds = torch.cat([encoder_output,
                            dec.get_inputs_embeds(prompt_ids).to(cdt)], dim=-2)
        return decoder_step(model, None, cache, 0, cross, cross_kv,
                            inputs_embeds=embeds)
    cache = dec.init_cache(bs, total, cdt, dev)
    return decoder_step(model, prompt_ids, cache, off, cross, cross_kv)


def precompute_cross_kv(model, cross: Optional[torch.Tensor]):
    if cross is None:
        return None
    return model.decoder.precompute_cross_kv(cross)


def quantize_cross_kv(cross_kv, quant: Optional[str]):
    """Exact per-depth cross K/V in the form of the cross-KV quant mode
    (what the decoder's ``precompute_cross_kv(quant=)`` returns, without
    projecting again)."""
    if cross_kv is None:
        return None
    return {depth: quantize_kv(kv, quant) for depth, kv in cross_kv.items()}


def sample_step(model, ids_buf: torch.Tensor, cur_len: int,
                last_logits: torch.Tensor, generator, temperature,
                top_k: Optional[int], nucleus_p: Optional[float],
                approx_top_k: bool = False):
    """The next ids (B,) from the last logits (JAX ``_sample_step``)."""
    greedy = temperature is None or temperature <= 0
    if nucleus_p is None and (greedy or top_k is not None):
        return sample_topk_with_ngram(last_logits, ids_buf, cur_len,
                                      model.no_repeat_n_grams, generator,
                                      temperature, top_k,
                                      approx=approx_top_k)
    logits = apply_no_repeat_ngram(last_logits.float(), ids_buf, cur_len,
                                   model.no_repeat_n_grams)
    if greedy:
        return logits.argmax(dim=-1)
    return sample_logits(logits, generator, temperature, top_k, nucleus_p)


@torch.no_grad()
def generate(model, images, prompt_ids: torch.Tensor,
             max_new_tokens: int = 128, temperature: float = 1.0,
             top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             encoder_output: Optional[torch.Tensor] = None,
             nucleus_p: Optional[float] = None, force_no_cache: bool = False,
             cross_kv_quant: Optional[str] = None,
             approx_top_k: bool = False) -> torch.Tensor:
    """Sample captions: (B, prompt_len + max_new_tokens) ids.  Runs on the
    model's device; inputs are moved there.  ``cross_kv_quant='int8'``
    (cached branch only) and ``approx_top_k`` are the serving modes of
    JAX's ``generate``; ``force_no_cache`` takes the full-reforward
    fallback."""
    dev = model.device
    prompt_ids = prompt_ids.to(dev)
    if prompt_ids.dim() == 1:
        prompt_ids = prompt_ids[None]
    t0 = prompt_ids.shape[-1]
    blk_size = model.decoder.block_size - model.space_for_prompt
    if max_new_tokens > blk_size - t0:
        raise ValueError(f"max_new_tokens={max_new_tokens} exceeds the "
                         f"decoder window ({blk_size} - prompt {t0})")
    if encoder_output is None:
        encoder_output = model.encoder(images.to(dev))
    bs = encoder_output.shape[0]
    prompt_ids = prompt_ids.expand(bs, t0)
    step = dict(generator=generator, temperature=temperature, top_k=top_k,
                nucleus_p=nucleus_p, approx_top_k=approx_top_k)
    if not getattr(model.decoder, "is_causal", True):
        return _generate_bidirectional(model, encoder_output, prompt_ids,
                                       max_new_tokens, blk_size, step)
    total = t0 + max_new_tokens
    ids_buf = torch.zeros((bs, total), dtype=torch.long, device=dev)
    ids_buf[:, :t0] = prompt_ids
    cdt = encoder_output.dtype
    cross = encoder_output if model.use_cross_attn else None
    off = model.space_for_prompt
    use_cache = (getattr(model.decoder, "supports_kv_cache", False)
                 and not force_no_cache)
    exact = getattr(model.decoder, "cache_exact_for_window", None)
    if use_cache and exact is not None:
        # a sparse layer whose global < 2-selected bypass rule flips inside
        # the window changes earlier hidden states: only the fallback
        # reproduces that
        use_cache = exact(off + t0, off + total)
    if not use_cache:
        for i in range(max_new_tokens):
            cur = t0 + i
            out = model(None, ids_buf, encoder_output=encoder_output,
                        sparse_rule_len=off + cur)
            last = out.logits[:, cur - 1].to(cdt)
            ids_buf[:, cur] = sample_step(model, ids_buf, cur, last, **step)
        return ids_buf
    cross_kv = precompute_cross_kv(model, cross)
    logits, cache = prefill(model, encoder_output, prompt_ids, total,
                            cross_kv)
    cross_kv = quantize_cross_kv(cross_kv, cross_kv_quant)
    last = logits[:, -1].to(cdt)
    for i in range(max_new_tokens):
        cur = t0 + i
        nxt = sample_step(model, ids_buf, cur, last, **step)
        ids_buf[:, cur] = nxt
        logits, cache = decoder_step(model, nxt[:, None], cache, off + cur,
                                     cross, cross_kv)
        last = logits[:, -1].to(cdt)
    return ids_buf


def _generate_bidirectional(model, encoder_output, prompt_ids,
                            max_new_tokens: int, blk_size: int, step):
    """JAX ``generate``'s bidirectional branch: the growing sequence (its
    last ``blk_size`` ids) re-forwarded every step, the next id drawn from
    the last row's logits."""
    ids = prompt_ids
    for _ in range(max_new_tokens):
        cond = ids if ids.shape[-1] <= blk_size else ids[..., -blk_size:]
        out = model(None, cond, encoder_output=encoder_output)
        nxt = sample_step(model, ids, ids.shape[-1], out.logits[:, -1],
                          **step)
        ids = torch.cat([ids, nxt[:, None]], dim=-1)
    return ids


def preprocess_frames(model, frames_u8: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """The encoder's input from raw uint8 frames: the scratch encoder's
    ``input.width`` with Flickr's statistics, or the pretrained ViT's
    ``image_size`` (224) with ImageNet's (JAX
    ``resize_normalize_on_device(raw, 224, IMAGENET_MEAN, IMAGENET_STD)``)."""
    enc = model.vision_encoder
    if isinstance(enc, PretrainedViT):
        return resize_normalize_on_device(
            frames_u8, enc.model.image_size, IMAGENET_MEAN, IMAGENET_STD,
            out_dtype=dtype)
    return resize_normalize_on_device(
        frames_u8, model.config.vision_encoder_config.input.width,
        out_dtype=dtype)


@torch.no_grad()
def caption(model, frames_u8: torch.Tensor, prompt_ids: torch.Tensor,
            max_new_tokens: int = 32, temperature: float = 0.7,
            top_k: Optional[int] = 16,
            generator: Optional[torch.Generator] = None,
            cross_kv_quant: Optional[str] = None,
            approx_top_k: bool = False) -> torch.Tensor:
    """The serving path: raw uint8 frames (B, H, W, 3) → resize/normalize
    on the model's device in the model's dtype (``preprocess_frames``) →
    encoder → generate, in
    the serving mode the last two arguments name (bench.py's modes; the
    W8A8 weights are the model's own, ``int8_serving_params``)."""
    images = preprocess_frames(model, frames_u8.to(model.device),
                               model.decoder.dtype)
    return generate(model, images, prompt_ids, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k,
                    generator=generator, cross_kv_quant=cross_kv_quant,
                    approx_top_k=approx_top_k)
