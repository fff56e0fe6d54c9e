"""On-device image preprocessing (counterpart of
``image2text_tpu/ops/preprocess.py``): raw uint8 HWC frames → scaled,
bilinearly resized (half-pixel centres, no antialias), per-channel
normalised CHW tensors on the frames' device.  The statistics are
Flickr's unless given (the pretrained ViT takes ImageNet's)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Flickr channel statistics (a copy of image2text_tpu/training/data.py's)
FLICKR_MEAN = (0.4274, 0.4218, 0.3878)
FLICKR_STD = (0.2754, 0.2705, 0.2874)
# the SWAG ViT-B/16's ImageNet statistics (a copy of the same file's)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_normalize_on_device(images_u8: torch.Tensor, size: int,
                               mean=None, std=None,
                               out_dtype=torch.float32) -> torch.Tensor:
    """(b, h, w, c) uint8 → (b, c, size, size) ``out_dtype``; ``mean`` and
    ``std`` per channel (Flickr's when None)."""
    dev = images_u8.device
    mean = torch.tensor(FLICKR_MEAN if mean is None else mean,
                        dtype=torch.float32, device=dev)
    std = torch.tensor(FLICKR_STD if std is None else std,
                       dtype=torch.float32, device=dev)
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.to(out_dtype)
