"""Train-state checkpoints for resume (counterpart of
``image2text_tpu/training/checkpoint.py``, which writes the JAX
TrainState with orbax): the wrapper's parameters and buffers (the EMA
teacher among them), the optimizer's state, the step and the seed every
step's randomness folds from, in one ``torch.save`` file in a directory.
Model-weight interchange (partial, pattern-filtered, the JAX export's
keys) stays in ``utils/checkpoint.py``."""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` into the directory ``path`` (replacing a previous
    one only once the new file is whole)."""
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, STATE_FILE)
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, dst)


def restore_train_state(path: str, device=None) -> Dict[str, Any]:
    """The state :func:`save_train_state` wrote into ``path``, its tensors
    on ``device``."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)
