"""KV cache for cached decoding (counterpart of ``image2text_tpu/models/kv_cache.py``).

:class:`KVCache` holds preallocated per-layer (k, v) buffers of shape
(b, n_kv_heads, slots, head_dim) and a fill index per layer.  Unlike the
JAX pytree, the port writes the buffers IN PLACE and advances the indices
(plain Python ints) as each layer writes: PyTorch runs eagerly, so no
functional successor cache is needed.  Beam search reorders the batch
axis with :meth:`KVCache.gather_batch`.  :class:`CacheRef` is the view one
decoder forward hands down its blocks; attention layers claim their layer
by call order, as in the JAX package.

Soft-prompt semantics (why caching is exact): text queries never attend
the soft-prompt prefix, so the cached path skips prefix positions and
offsets text positions by ``space_for_prompt``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


class KVCache:
    """Per-layer K/V buffers with per-layer fill indices.  Sparse layers
    advance only when a position in their selection is written (their
    buffers hold slots for selected text positions only)."""

    def __init__(self, layers: List[Tuple[torch.Tensor, torch.Tensor]]):
        self.layers = layers
        self.index = [0] * len(layers)
        self._spare: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    @staticmethod
    def create(layer_shapes, dtype=torch.float32, device=None) -> "KVCache":
        """layer_shapes: per layer (batch, n_kv_heads, slots, head_dim)."""
        return KVCache([(torch.zeros(s, dtype=dtype, device=device),
                         torch.zeros(s, dtype=dtype, device=device))
                        for s in layer_shapes])

    def gather_batch(self, order: torch.Tensor) -> "KVCache":
        """Reorder the batch axis of every layer's buffers (beam-search
        consolidation): new row i is old row ``order[i]``.  The rows are
        gathered into a second set of buffers, made at the first gather
        and kept, and the two sets swap, so a call's rounds allocate
        nothing past their first (a captured beam call's pool does not
        grow with its rounds); fill indices are unchanged."""
        if self._spare is None:
            self._spare = [(torch.empty_like(k), torch.empty_like(v))
                           for k, v in self.layers]
        for (k, v), (k2, v2) in zip(self.layers, self._spare):
            torch.index_select(k, 0, order, out=k2)
            torch.index_select(v, 0, order, out=v2)
        self.layers, self._spare = self._spare, self.layers
        return self


class CacheRef:
    """One decoder forward's view of a :class:`KVCache`; ``positions``
    (numpy, set by the decoder) carries the chunk's global positions so
    sparse blocks can resolve their static selections on the host."""

    def __init__(self, cache: KVCache):
        self._cache = cache
        self._layer = 0
        self.positions: Optional[np.ndarray] = None

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               mask: Optional[torch.Tensor]):
        """Write k/v rows at this layer's fill index (in place) and return
        (k, v, bias): ``bias`` is the additive causal mask over slots —
        query row i (slot index + i) attends slot j iff j <= index + i, so
        unfilled slots are masked too."""
        i = self._layer
        self._layer += 1
        k_buf, v_buf = self._cache.layers[i]
        idx = self._cache.index[i]
        t = k_new.shape[2]
        if idx + t > k_buf.shape[2]:
            raise ValueError(f"KV cache layer {i} is full")
        k_buf[:, :, idx:idx + t] = k_new
        v_buf[:, :, idx:idx + t] = v_new
        self._cache.index[i] = idx + t
        dev = k_buf.device
        row = idx + torch.arange(t, device=dev)[:, None]
        col = torch.arange(k_buf.shape[2], device=dev)[None, :]
        bias = torch.zeros(t, k_buf.shape[2], device=dev).masked_fill(
            col > row, float("-inf"))[None, None]
        if mask is not None:
            bias = bias + mask
        return k_buf, v_buf, bias

    def skip(self) -> None:
        """Claim this layer's slot without touching it (a sparse layer with
        no selected position in the chunk)."""
        self._layer += 1
