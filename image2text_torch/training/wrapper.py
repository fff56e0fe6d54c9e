"""Trainer wrapper: the loss engine (counterpart of
``image2text_tpu/training/wrapper.py``).

The same loss semantics as the JAX package:

* input construction: labels → input ids with EOS fill, BERT-style mask
  corruption (``mask_fraction`` / ``random_mask_fraction``), BOS prepended
  and the sequence cut back to its length;
* ``get_weights``: 'constant' or 'inverse_sqrt_position', the
  ``eos_token_weight`` override, per-sequence and per-batch normalisation;
* ``compute_lm_loss``: weighted cross entropy at ``training_temperature``
  in f32, or with a momentum teacher the soft targets
  α·softmax(teacher/T) + (1 − α)·onehot;
* ``compute_contrastive_loss``: hidden states against the target tokens'
  embeddings, in-batch cross entropy over all positions.

The wrapper owns the student ``model`` and, with MoCo settings, the EMA
teacher ``model_m`` (no gradients).  The student's trainable parameters
have gradients on (the port's modules are created without them, for
serving); its frozen ones (``nn.core.frozen_param_paths``: a LoRA-wrapped
decoder's base, the int4 scales) stay off, so no gradient is computed for
them — the JAX step computes and discards theirs.

Under a mesh (``training/loop.py``) a rank holds rows ``rows = (first,
global batch)`` of each batch: the masked-LM corruption is drawn for the
global batch and sliced, every dropout likewise (``nn.core.Ctx``), and the
contrastive loss scores this rank's positions against the *global*
batch's targets, gathered over the data group (``data_axis``) with their
gradient.  The LM loss needs nothing: ``get_weights`` divides by the
rank's batch, so the mean of the ranks' equal-sized losses is the global
loss.  Its gradient is not DDP's mean of theirs: every block output
divides its gradient by the norm over the whole batch
(``normalize_gradients``), so the backward runs on the rank's share of
the global loss (``loss_scale = 1/data``) and the step sums the ranks'
gradients.

``forward`` is what the training step calls through
``torch.func.functional_call`` on bf16 copies of the f32 parameters
(``training/loop.py``).  With ``backward=True`` it also runs the backward
*inside* that call: per-block checkpointing recomputes each block during
the backward, and the recompute must see the same bf16 copies, which
``functional_call`` installs only for the duration of the call.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.configs.models import VisionEncoderDecoderConfig
from image2text_torch.configs.trainer import TrainerWrapperConfig
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.nn.core import (EVAL_CTX, Ctx, frozen_param_paths,
                                      generator)
from image2text_torch.parallel.collectives import LOCAL, gather_data


class TokenizerInfo:
    """The special-token ids the wrapper needs."""

    def __init__(self, eos_token_id: int, bos_token_id: int,
                 mask_token_id: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self.mask_token_id = mask_token_id
        self.vocab_size = vocab_size

    @classmethod
    def from_tokenizer(cls, tok) -> "TokenizerInfo":
        return cls(eos_token_id=tok.eos_token_id,
                   bos_token_id=tok.bos_token_id,
                   mask_token_id=getattr(tok, "mask_token_id", None),
                   vocab_size=tok.vocab_size)


class ModelTrainerWrapper(nn.Module):
    def __init__(self, model_config: VisionEncoderDecoderConfig,
                 tokenizer: TokenizerInfo,
                 trainer_config: TrainerWrapperConfig,
                 ignore_index: int = -100, device=None):
        super().__init__()
        self.model = VisionEncoderDecoder(model_config, device)
        self.model.requires_grad_(True)
        params = dict(self.model.named_parameters())
        for path in frozen_param_paths(self.model):
            if path in params:
                params[path].requires_grad_(False)
        self.is_momentum = (trainer_config.moco_momentum is not None
                            and trainer_config.moco_alpha is not None)
        self.model_m = (VisionEncoderDecoder(model_config, device)
                        if self.is_momentum else None)
        self.tokenizer = tokenizer
        self.ignore_index = ignore_index
        self.temperature = trainer_config.training_temperature
        self.contrastive_temperature = (
            trainer_config.training_contrastive_temperature)
        self.weight_fn = trainer_config.weight_fn
        self.mask_fraction = trainer_config.mask_fraction
        self.random_mask_fraction = trainer_config.random_mask_fraction
        self.eos_token_weight = trainer_config.eos_token_weight
        self.momentum = trainer_config.moco_momentum
        self.alpha = trainer_config.moco_alpha
        self.add_contrastive_loss = trainer_config.add_contrastive_loss
        self.data_axis = LOCAL   # the mesh's data axis (training/loop.py)

    # -- teacher state ------------------------------------------------------
    def init_weights(self, seed: int = 0) -> "ModelTrainerWrapper":
        self.model.init_weights(seed)
        if self.is_momentum:
            self.copy_momentum_params()
        return self

    @torch.no_grad()
    def copy_momentum_params(self) -> None:
        """Teacher ← student, a full copy."""
        for pm, ps in zip(self.model_m.parameters(), self.model.parameters()):
            pm.copy_(ps)

    @torch.no_grad()
    def momentum_update(self) -> None:
        """EMA teacher update ``m·teacher + (1 − m)·student`` (parameters
        only; the integer selection buffers stay as copied)."""
        m = self.momentum
        for pm, ps in zip(self.model_m.parameters(), self.model.parameters()):
            pm.copy_(pm * m + ps.to(pm.dtype) * (1.0 - m))

    # -- loss weights -------------------------------------------------------
    def get_weights(self, labels: torch.Tensor) -> torch.Tensor:
        bs, sl = labels.shape
        if self.weight_fn == "constant":
            weights = torch.ones(bs, sl, device=labels.device)
        elif self.weight_fn == "inverse_sqrt_position":
            pos = torch.arange(1, sl + 1, dtype=torch.float32,
                               device=labels.device)
            weights = (1.0 / torch.sqrt(pos))[None].expand(bs, sl)
        else:
            raise ValueError(f"unknown weight_fn: {self.weight_fn}")
        if self.eos_token_weight is not None:
            weights = torch.where(labels == self.tokenizer.eos_token_id,
                                  torch.full_like(weights,
                                                  self.eos_token_weight),
                                  weights)
        weights = torch.where(labels == self.ignore_index,
                              torch.zeros_like(weights), weights)
        return (weights / (1e-3 + weights.sum(-1, keepdim=True))) / bs

    # -- losses -------------------------------------------------------------
    def compute_lm_loss(self, lm_logits, labels, lm_logits_moco=None):
        labels = labels[..., :lm_logits.shape[-2]]
        if lm_logits.shape[-2] > labels.shape[-1]:
            lm_logits = lm_logits[..., :labels.shape[-1], :]
            if lm_logits_moco is not None:
                lm_logits_moco = lm_logits_moco[..., :labels.shape[-1], :]
        weights = self.get_weights(labels)
        ignore = labels == self.ignore_index
        safe = torch.where(ignore, torch.zeros_like(labels), labels)
        logp = F.log_softmax(lm_logits.float() / self.temperature, dim=-1)
        if lm_logits_moco is not None:
            onehot = F.one_hot(safe, logp.shape[-1]).float()
            onehot = torch.where(ignore[..., None], torch.zeros_like(onehot),
                                 onehot)
            soft = F.softmax(lm_logits_moco.float() / self.temperature,
                             dim=-1)
            targets = self.alpha * soft + (1.0 - self.alpha) * onehot
            return -torch.sum((logp * targets).sum(-1) * weights)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        nll = torch.where(ignore, torch.zeros_like(nll), nll)
        return torch.sum(nll * weights)

    def compute_contrastive_loss(self, hidden_state, labels):
        labels = labels[..., :hidden_state.shape[-2]]
        if hidden_state.shape[-2] > labels.shape[-1]:
            hidden_state = hidden_state[..., :labels.shape[-1], :]
        weights = self.get_weights(labels)
        attn_mask = labels != self.ignore_index
        target_ids = torch.where(attn_mask, labels, torch.zeros_like(labels))
        hidden_target = self.model.decoder.get_inputs_embeds(target_ids)
        d = hidden_state.shape[-1]
        h = hidden_state.reshape(-1, d).float()
        t = hidden_target.reshape(-1, d).float()
        mask = attn_mask.reshape(-1)
        first = 0
        if self.data_axis.size > 1:   # every data rank's targets
            t = gather_data(t, self.data_axis)
            mask = gather_data(mask.float(), self.data_axis) > 0
            first = self.data_axis.rank * h.shape[0]
        predictions = torch.where(mask.reshape(1, -1), h @ t.T,
                                  torch.full((), float("-inf"),
                                             device=h.device))
        logp = F.log_softmax(predictions / self.contrastive_temperature, -1)
        n = h.shape[0]
        losses = -logp[torch.arange(n, device=h.device),
                       torch.arange(first, first + n, device=h.device)]
        losses = torch.where(torch.isinf(losses), torch.zeros_like(losses),
                             losses)
        return torch.sum(losses * weights.reshape(-1))

    # -- step helpers -------------------------------------------------------
    def build_inputs(self, labels: torch.Tensor, is_train: bool,
                     seed: Optional[int] = None, noise=None,
                     rows: Tuple[int, int] = (0, 0)):
        """labels → (corrupted BOS-prepended input ids, bool mask).
        ``noise`` = (u1, u2, random_ids) replaces the draws from ``seed``
        (tests feed both packages the same numbers); under ``rows`` =
        (first, global batch) they are drawn for the global batch and this
        rank's rows kept."""
        tok = self.tokenizer
        keep = labels != self.ignore_index
        eos = torch.full_like(labels, tok.eos_token_id)
        input_ids = torch.where(keep, labels, eos)
        corrupted = input_ids
        if is_train and self.mask_fraction > 0:
            if noise is None:
                if seed is None or tok.mask_token_id is None:
                    raise ValueError("mask corruption needs a seed and a "
                                     "mask token")
                g = generator(Ctx(seed).fold(17).seed, labels.device)
                shape = ((rows[1], labels.shape[1]) if rows[1]
                         else labels.shape)
                u1 = torch.rand(shape, generator=g, device=labels.device)
                u2 = torch.rand(shape, generator=g, device=labels.device)
                random_ids = torch.randint(0, tok.vocab_size, shape,
                                           generator=g, device=labels.device)
                if rows[1]:
                    mine = slice(rows[0], rows[0] + labels.shape[0])
                    u1, u2, random_ids = u1[mine], u2[mine], random_ids[mine]
            else:
                u1, u2, random_ids = noise
            masked = torch.where(u2 <= self.random_mask_fraction,
                                 random_ids.to(labels.dtype),
                                 torch.full_like(labels, tok.mask_token_id))
            corrupted = torch.where(u1 <= self.mask_fraction, masked,
                                    input_ids)
            corrupted = torch.where(keep, corrupted, eos)
        bs, sl = corrupted.shape
        bos = torch.full((bs, 1), tok.bos_token_id, dtype=corrupted.dtype,
                         device=corrupted.device)
        corrupted = torch.cat([bos, corrupted], 1)[:, :sl]
        attn_msk = torch.cat([torch.ones(bs, 1, dtype=torch.bool,
                                         device=keep.device), keep], 1)[:, :sl]
        return corrupted, attn_msk

    def forward(self, images, labels, seed: Optional[int] = None,
                is_train: bool = True, use_flash: bool = True,
                backward: bool = False, noise=None,
                rows: Tuple[int, int] = (0, 0), loss_scale: float = 1.0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch; a train step passes ``seed`` (the
        dropout and corruption stream) and ``backward=True``, and under a
        mesh this rank's ``rows`` of the global batch."""
        corrupted, _ = self.build_inputs(labels, is_train, seed, noise, rows)
        train = is_train and seed is not None
        ctx = (Ctx(seed, True, rows, data_axis=self.data_axis).fold(23)
               if train else EVAL_CTX)
        out = self.model(images, corrupted, ctx=ctx, use_flash=use_flash)
        logits_moco = None
        if self.is_momentum and is_train:
            # the reference keeps the teacher in train mode: its dropout
            # stays on, on a stream of its own
            mctx = (Ctx(seed, True, rows, data_axis=self.data_axis).fold(29)
                    if train else EVAL_CTX)
            with torch.no_grad():
                logits_moco = self.model_m(images, corrupted, ctx=mctx,
                                           use_flash=use_flash).logits
        step = "train" if is_train else "val"
        loss = self.compute_lm_loss(out.logits, labels, logits_moco)
        metrics = {f"{step}_loss_lm": loss.detach()}
        if self.add_contrastive_loss:
            loss_c = self.compute_contrastive_loss(out.hidden_state, labels)
            metrics[f"{step}_loss_contrastive"] = loss_c.detach()
            loss = loss + loss_c
        if backward:
            (loss if loss_scale == 1.0 else loss * loss_scale).backward()
        return loss.detach(), metrics
