"""Output records (counterpart of ``image2text_tpu/object_models.py``)."""
from typing import NamedTuple

import torch


class VisionEncoderDecoderModelOutput(NamedTuple):
    encoder_output: torch.Tensor
    logits: torch.Tensor
    hidden_state: torch.Tensor
