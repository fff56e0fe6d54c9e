"""Primitive modules of the port (counterparts of ``image2text_tpu/nn/modules.py``).

Same parameter names and torch layouts as the JAX package, and the same
dtype chain: a product accumulates in f32 and is rounded once to the
activation (storage) dtype, a bias is added in that dtype afterwards, and
normalisation statistics run in f32.  ``F.linear``'s fused bias would add
the bias before the rounding, so products and bias adds stay separate.
Training dropout takes a ``Ctx`` (``nn/core.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      normal_init, ones_init,
                                      torch_linear_weight_init,
                                      xavier_uniform_init, zeros_init)
from image2text_torch.ops.functions import dot_f32


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], n_dims: int = 1,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``n_dims`` dims: f32 statistics
    (two-pass variance), f32 scale and shift, result in ``x``'s dtype."""
    x32 = x.float()
    dims = tuple(range(x.dim() - n_dims, x.dim()))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class Linear(nn.Module):
    """y = x @ W.T + b with torch layout W:(out, in); f32 accumulation,
    output and bias add in ``x``'s dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        init = torch_linear_weight_init(in_features)
        new_param(self, "weight", (out_features, in_features), init, device)
        if bias:
            new_param(self, "bias", (out_features,), init, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Embedding(nn.Module):
    """Token embedding, torch layout (num_embeddings, dim), init
    N(0, init_std²)."""

    def __init__(self, num_embeddings: int, dim: int, device=None,
                 init_std: float = 1.0):
        super().__init__()
        new_param(self, "weight", (num_embeddings, dim),
                  normal_init(std=init_std), device)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with optional bias."""

    def __init__(self, ndim: int, bias: bool, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        new_param(self, "weight", (ndim,), ones_init(), device)
        if bias:
            new_param(self, "bias", (ndim,), zeros_init(), device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, 1, self.eps)


class LayerNormND(nn.Module):
    """LayerNorm over the trailing ``len(shape)`` dims: the statistics run
    over the whole (tokens, features) slab, not per row."""

    def __init__(self, shape: Tuple[int, ...], bias: bool, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.shape = tuple(shape)
        self.eps = eps
        new_param(self, "weight", self.shape, ones_init(), device)
        if bias:
            new_param(self, "bias", self.shape, zeros_init(), device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, len(self.shape), self.eps)


class Conv2d(nn.Module):
    """NCHW conv, torch layout W:(out, in, kh, kw), XLA 'SAME' padding: an
    even kernel pads (k - 1) // 2 before and the rest after (6x6: 2 and 3),
    which torch's own ``padding='same'`` does the other way round."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], bias: bool = True,
                 device=None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        fan_in = in_channels * kh * kw
        init = torch_linear_weight_init(fan_in)
        new_param(self, "weight", (out_channels, in_channels, kh, kw), init,
                  device)
        if bias:
            new_param(self, "bias", (out_channels,), init, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        y = F.conv2d(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None, :, None, None]
        return y


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible attention (batch_first),
    used for the decoder's cross-attention: packed ``in_proj`` for q/k/v
    plus ``out_proj``.  Scores stay in f32 (no storage-dtype rounding, as
    in the JAX module) and probabilities drop to the storage dtype before
    the V product; in training they are dropped (plain PyTorch, as the JAX
    module leaves them to XLA)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        new_param(self, "in_proj_weight", (3 * embed_dim, embed_dim),
                  xavier_uniform_init(), device)
        new_param(self, "in_proj_bias", (3 * embed_dim,), zeros_init(), device)
        self.out_proj = Linear(embed_dim, embed_dim, bias=True, device=device)
        # torch._reset_parameters zeroes the out_proj bias
        self.out_proj._init_fns["bias"] = zeros_init()

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.num_heads,
                         self.head_dim).transpose(-3, -2)

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        e = self.embed_dim
        w = self.in_proj_weight[part * e:(part + 1) * e].to(x.dtype)
        b = self.in_proj_bias[part * e:(part + 1) * e].to(x.dtype)
        return torch.matmul(x, w.t()) + b

    def project_kv(self, key: torch.Tensor, value: torch.Tensor):
        """Split-head K/V of a fixed memory (decode-time cross-attention:
        computed once per sequence instead of once per token)."""
        return (self._split_heads(self._proj(key, 1)),
                self._split_heads(self._proj(value, 2)))

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                precomputed_kv=None, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        q = self._split_heads(self._proj(query, 0))
        if precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            k, v = self.project_kv(key, value)
        scores = dot_f32(q, k) / math.sqrt(self.head_dim)
        probs = torch.softmax(scores, dim=-1).to(query.dtype)
        probs, _ = dropout(probs, self.dropout_rate, ctx)
        y = torch.matmul(probs, v)
        y = y.transpose(-3, -2).reshape(*query.shape[:-1], self.embed_dim)
        return self.out_proj(y)
