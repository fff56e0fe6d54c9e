"""Device choice for the port's entry points: the card unless the caller
asks for the CPU.  Without a card and without an explicit CPU request an
entry point raises; it never moves to the CPU on its own."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "image2text_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (132 on an H100
    SXM): the one owner of the count that the kernels' launch plans fill
    (``flash_attention.fwd_plan``/``bwd_plan``, ``int4_matmul.int4_plan``,
    ``fused_moe.moe_slices``, ``fused_block._attn_blocks``)."""
    index = getattr(device, "index", None)
    if index is None:
        index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)
