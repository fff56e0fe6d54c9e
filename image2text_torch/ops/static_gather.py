"""Row gathers under a static layout (counterpart of
``image2text_tpu/ops/static_gather.py``).

The TPU package wrote these as one-hot matmuls; on the GPU they are plain
index gathers and scatters, exact by construction.  Index tensors are
built on the data's device (a small host→device copy per call).
"""
from __future__ import annotations

import numpy as np
import torch


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def static_take(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[:, idx]`` for a static numpy ``idx`` over a (b, t, d) tensor."""
    return x.index_select(1, _index(idx, x.device))


def static_combine(x_sel: torch.Tensor, x_not: torch.Tensor, idx,
                   not_idx) -> torch.Tensor:
    """Reassemble (b, t, d) from the selected and bypass rows:
    ``out[:, idx] = x_sel; out[:, not_idx] = x_not``."""
    idx, not_idx = np.asarray(idx), np.asarray(not_idx)
    if not_idx.size == 0:
        cat, perm = x_sel, idx
    elif idx.size == 0:
        cat, perm = x_not, not_idx
    else:
        cat = torch.cat([x_sel, x_not], dim=1)
        perm = np.concatenate([idx, not_idx])
    return canonicalize(cat, perm)


def canonicalize(x: torch.Tensor, layout) -> torch.Tensor:
    """Undo a static row ``layout``: ``out[:, layout[j]] = x[:, j]``."""
    out = torch.empty_like(x)
    out[:, _index(layout, x.device)] = x
    return out


def layout_rows(layout, canonical_idx) -> np.ndarray:
    """Stream rows holding canonical positions ``canonical_idx`` under
    ``layout`` (identity when ``layout`` is None)."""
    canonical_idx = np.asarray(canonical_idx)
    if layout is None:
        return canonical_idx
    layout = np.asarray(layout)
    pos_of = np.empty(layout.size, np.int64)
    pos_of[layout] = np.arange(layout.size)
    return pos_of[canonical_idx]
