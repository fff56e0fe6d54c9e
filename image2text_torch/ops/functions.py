"""Custom-gradient ops (counterpart of ``image2text_tpu/ops/functions.py``).

``normalize_gradients``: identity forward; the backward rescales the
incoming gradient by its global L2 norm (+ 1e-6).  Applied at every
TransformerBlock output, where it is the identity at eval time.
"""
from __future__ import annotations

import torch


class _NormalizeGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float()
        return (g32 / (torch.linalg.vector_norm(g32) + 1e-6)).to(g.dtype)


def normalize_gradients(x: torch.Tensor) -> torch.Tensor:
    return _NormalizeGradients.apply(x)
