"""GPT-2 weight surgery for the scratch decoder (counterpart of
``image2text_tpu/models/hf_import.py``).

:func:`import_gpt2_state_dict` fills a :class:`TransformerDecoder` from an
HF ``GPT2LMHeadModel`` state dict (numpy or torch values by key): the
Conv1D weights are transposed into Linear layout, the causal-mask buffers
(``attn.bias``, ``attn.masked_bias``) skipped, ``lm_head.weight`` goes
into the tied ``transformer.wte.weight``, and a vocabulary grown by extra
tokens keeps its initialised rows past GPT-2's.  Strict mode raises on a
key the decoder lacks or a shape it does not take, and then checks the
reverse: every base GPT-2 parameter of the decoder was filled (its
cross-attention is the decoder's own addition).  Loose mode skips what does
not match, such as a 256-row ``wpe`` against GPT-2's 1,024.

The JAX package fetches the weights with ``transformers`` over the
network (``load_pretrained_gpt2_params``); the port takes them from a local
state dict only.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

GPT2_TRANSPOSED = ("attn.c_attn.weight", "attn.c_proj.weight",
                   "mlp.c_fc.weight", "mlp.c_proj.weight")
_BASE = ("transformer.wte.", "transformer.wpe.", "transformer.ln_f.",
         "transformer.h.")
_ADDED = (".crossattention.", ".ln_cross_attn.", ".cross_attn.", ".ln_3.",
          ".lora_A.", ".lora_B.")


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v)


@torch.no_grad()
def import_gpt2_state_dict(decoder: nn.Module, sd: Mapping[str, np.ndarray],
                           loose: bool = False) -> None:
    """Copy an HF GPT-2 state dict into ``decoder`` in place."""
    tensors = dict(decoder.named_parameters())
    consumed = set()
    for k, v in sd.items():
        if k.endswith((".attn.masked_bias", ".attn.bias")):
            continue
        v = _numpy(v)
        if k.endswith(GPT2_TRANSPOSED):
            v = v.T
        if k == "lm_head.weight":
            k = "transformer.wte.weight"
        if k not in tensors:
            if not loose:
                raise ValueError(f"{k} is not present in state dict!!!")
            continue
        dst = tensors[k]
        src = torch.from_numpy(np.array(v))
        if tuple(dst.shape) == tuple(v.shape):
            dst.copy_(src.to(dst.dtype))
            consumed.add(k)
        elif (k == "transformer.wte.weight" and dst.shape[0] > v.shape[0]
              and dst.shape[1] == v.shape[1]):
            dst[:v.shape[0]] = src.to(dst.dtype)
            consumed.add(k)
        elif not loose:
            raise ValueError(f"{k} is not the same shape in state dict!!!")
    if not loose:
        base = {p for p in tensors
                if p.startswith(_BASE) and not any(a in p for a in _ADDED)}
        missing = sorted(base - consumed)
        if missing:
            raise ValueError(
                f"{len(missing)} base params missing from the GPT-2 state "
                f"dict (first: {missing[:4]}); refusing a partial strict "
                "import")


def load_pretrained_gpt2_params(decoder: nn.Module, model_type, vocab_size,
                                loose: bool) -> None:
    """The JAX package downloads GPT-2 here; the port does not fetch
    weights."""
    raise RuntimeError(
        f"the port does not download {model_type.value} weights: build the "
        "model, then pass a local HF GPT-2 state dict to "
        "image2text_torch.models.hf_import.import_gpt2_state_dict "
        "(VisionEncoderDecoder.init_weights(gpt2_state_dict=...))")


__all__ = ["GPT2_TRANSPOSED", "import_gpt2_state_dict",
           "load_pretrained_gpt2_params"]
