"""Row gathers under a static layout (counterpart of
``image2text_tpu/ops/static_gather.py``).

The TPU package wrote these as one-hot matmuls; on the GPU they are plain
index gathers and scatters, exact by construction.  Index tensors are
built on the data's device once per index set and kept: a host→device
copy at every call would synchronise the stream, and a captured call
(``models/graphs.py``) cannot contain one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_INDEX: Dict[Tuple[tuple, bytes, str], torch.Tensor] = {}


def _index(idx, device) -> torch.Tensor:
    idx = np.asarray(idx, np.int64)
    key = (idx.shape, idx.tobytes(), str(device))
    t = _INDEX.get(key)
    if t is None:
        t = _INDEX[key] = torch.as_tensor(idx, device=device)
    return t


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
