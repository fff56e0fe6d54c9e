"""Device choice for the port's entry points: the card unless the caller
asks for the CPU.  Without a card and without an explicit CPU request an
entry point raises; it never moves to the CPU on its own."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "image2text_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
