"""Composite vision-encoder → causal-decoder model (counterpart of
``image2text_tpu/models/vision_encoder_decoder.py``).

Soft prompting prepends the encoder's CLS outputs to the token
embeddings under the reference's additive bias: prefix query rows attend
everywhere (subject to the blocks' causality), text → prefix is blocked
(-inf), and the text block is open.  Cross-attention feeds the encoder
output to the decoder (the scratch decoder's even-depth blocks, every
GPT-2 block).  The encoder and the decoder are the ones the config's
types name (``models/encoder.py::encoder_from_config``,
``models/decoder.py::decoder_from_config``), bridged by a bias-free
Linear where their widths differ; a GPT-2 decoder ignores the
soft-prompt bias and its text rows attend the prefix through its causal
mask, as the JAX one does.  ``forward`` is differentiable;
a training forward passes a train ``Ctx`` (``training/wrapper.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from image2text_torch.configs.models import VisionEncoderDecoderConfig
from image2text_torch.models.decoder import (TransformerDecoder,
                                             decoder_from_config)
from image2text_torch.models.encoder import (VisionTransformerEncoder,
                                             encoder_from_config)
from image2text_torch.nn.core import EVAL_CTX, Ctx, init_parameters
from image2text_torch.nn.modules import Linear
from image2text_torch.object_models import VisionEncoderDecoderModelOutput
from image2text_torch.utils.device import resolve_device


class _EncoderWithBridge(nn.Module):
    """nn.Sequential(encoder, Linear) analog: children '0' and '1'."""

    def __init__(self, encoder, bridge):
        super().__init__()
        self.add_module("0", encoder)
        self.add_module("1", bridge)

    def forward(self, images, **kw):
        return self._modules["1"](self._modules["0"](images, **kw))


class VisionEncoderDecoder(nn.Module):
    """Caption model.  Built on ``device`` (default: the card; raises
    without one unless ``device='cpu'``); parameters are f32 and
    uninitialised until :meth:`init_weights` or a checkpoint load."""

    def __init__(self, config: VisionEncoderDecoderConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        encoder = encoder_from_config(config.vision_encoder_config, device)
        self.space_for_prompt = (encoder.num_outputs
                                 if config.use_soft_prompting else 0)
        self.decoder = decoder_from_config(
            config.decoder_config, self.space_for_prompt, device,
            loose=config.loose_match_decoder_state_dict)
        if encoder.output_embed_dim != self.decoder.n_embd:
            encoder = _EncoderWithBridge(encoder, Linear(
                encoder.output_embed_dim, self.decoder.n_embd, bias=False,
                device=device))
        self.encoder = encoder
        self.no_repeat_n_grams = tuple(config.no_repeat_n_grams)
        self.use_cross_attn = config.use_cross_attn
        self.use_soft_prompting = config.use_soft_prompting
        if not (self.use_cross_attn or self.use_soft_prompting):
            raise ValueError("Misconfigured!!! Need to either use cross attn "
                             "or soft prompting or both")

    @property
    def device(self) -> torch.device:
        """The device of the model's tensors (one device for all)."""
        return next(self.parameters()).device

    def init_weights(self, seed: int = 0,
                     gpt2_state_dict=None) -> "VisionEncoderDecoder":
        """Random weights from the port's own initialisers, seeded; a
        GPT-2-initialised scratch decoder then takes ``gpt2_state_dict``
        (an HF GPT-2 state dict, through ``import_gpt2_state_dict`` with the
        config's ``loose_match_decoder_state_dict``; without one it raises,
        where the JAX ``init`` downloads GPT-2); then, where the config
        names a ``chkpt_path``, that checkpoint's keys over them (the JAX
        ``init``'s partial restore)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_parameters(self, gen)
        dec = self.decoder
        if (isinstance(dec, TransformerDecoder)
                and dec.pretrained_model is not None):
            from image2text_torch.models import hf_import

            if gpt2_state_dict is None:
                hf_import.load_pretrained_gpt2_params(
                    dec, dec.pretrained_model, dec.config.vocab_size,
                    dec.loose)
            hf_import.import_gpt2_state_dict(dec, gpt2_state_dict,
                                             loose=dec.loose)
        if self.config.chkpt_path is not None:
            from image2text_torch.utils.checkpoint import (
                update_params_from_partial_checkpoint)

            update_params_from_partial_checkpoint(self,
                                                  self.config.chkpt_path)
        return self

    @property
    def vision_encoder(self) -> nn.Module:
        """The vision encoder, without the bridge to the decoder's width."""
        enc = self.encoder
        return (enc._modules["0"] if isinstance(enc, _EncoderWithBridge)
                else enc)

    def sdpa_calls(self, seq_len: int) -> int:
        """Attention calls (``ops.attention.sdpa``: in training each is one
        flash forward) of one non-cached forward over ``seq_len`` labels:
        the scratch encoder's blocks that run their body
        (``TransformerBlock.runs_body``) over its CLS and patch rows (the
        pretrained ViT's attention is ``MultiheadAttention``'s own), and
        the decoder's (``sdpa_calls``) over the soft prompt and labels cut
        at its block size, as :meth:`forward` builds them."""
        enc = self.vision_encoder
        t_dec = min(self.decoder.block_size, self.space_for_prompt + seq_len)
        n_enc = 0
        if isinstance(enc, VisionTransformerEncoder):
            t_enc = enc.n_cls + enc.n_patches ** 2
            n_enc = sum(blk.runs_body(t_enc) for blk in enc.blocks)
        return n_enc + self.decoder.sdpa_calls(t_dec)

    def forward(self, images, ids, encoder_output=None, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, sparse_rule_len=None):
        """``sparse_rule_len``: the valid length of the decoder's input in
        block coordinates (soft-prompt prefix included), which the
        generation fallbacks pass so that sparse blocks evaluate the
        global bypass rule at the generated length, not the buffer's."""
        if encoder_output is None:
            encoder_output = self.encoder(images, ctx=ctx.fold(1),
                                          use_flash=use_flash)
        s = ids.shape[-1]
        block_size = self.decoder.block_size
        if self.use_soft_prompting:
            inputs_embeds = torch.cat(
                [encoder_output,
                 self.decoder.get_inputs_embeds(ids).to(encoder_output.dtype)],
                dim=-2)[..., :block_size, :]
            ncls = encoder_output.shape[-2]
            total = ncls + s
            bias = torch.full((1, 1, total, total), float("-inf"),
                              device=ids.device)
            bias[..., :ncls, :] = 0.0
            bias[..., ncls:, ncls:] = 0.0
            attn_bias = bias[..., :block_size, :block_size]
            dec_ids, offset = None, ncls
        else:
            inputs_embeds, dec_ids, offset, attn_bias = None, ids, 0, None
        cross = encoder_output if self.use_cross_attn else None
        logits, hidden = self.decoder(idx=dec_ids, inputs_embeds=inputs_embeds,
                                      cross_attn_embeds=cross,
                                      attn_msk=attn_bias, ctx=ctx.fold(2),
                                      use_flash=use_flash,
                                      sparse_rule_len=sparse_rule_len)
        return VisionEncoderDecoderModelOutput(
            encoder_output=encoder_output, logits=logits[..., offset:, :],
            hidden_state=hidden)

    def generate(self, images, prompt_ids, max_new_tokens: int = 128,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """Autoregressive sampling; see models/generation.py."""
        from image2text_torch.models.generation import generate

        return generate(self, images, prompt_ids,
                        max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k,
                        generator=generator, **kwargs)
