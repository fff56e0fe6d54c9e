"""On-device image preprocessing (counterpart of
``image2text_tpu/ops/preprocess.py``): raw uint8 HWC frames → scaled,
bilinearly resized (half-pixel centres, no antialias), per-channel
normalised CHW tensors on the frames' device."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Flickr channel statistics (a copy of image2text_tpu/training/data.py's)
FLICKR_MEAN = (0.4274, 0.4218, 0.3878)
FLICKR_STD = (0.2754, 0.2705, 0.2874)


def resize_normalize_on_device(images_u8: torch.Tensor, size: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """(b, h, w, c) uint8 → (b, c, size, size) ``out_dtype``."""
    dev = images_u8.device
    mean = torch.tensor(FLICKR_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(FLICKR_STD, dtype=torch.float32, device=dev)
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.to(out_dtype)
