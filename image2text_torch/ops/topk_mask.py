"""Fused n-gram ban + exact top-k threshold mask: the CUDA kernel
``csrc/topk_mask.cu`` and its reference.

Replaces ``image2text_tpu/ops/topk_mask.py::_topk_ban_mask_kernel``.  On a
(B, V) f32 row, banned ids and everything below the k-th largest unbanned
value become -inf; ties at the threshold are kept (the reference's
``logits < kth → -inf``).  ``banned_id`` is (B, M) int32 with -1 for empty
slots (ids outside [0, V) are dropped, as the JAX scatter drops them), or
None.

The JAX package keeps its kernel as a tested negative result (9x slower
than the full-row sort on a TPU) behind ``use_kernel=True``; nothing on a
serving path calls it, here either.  The port's wrapper has no switch: a
CPU tensor takes the reference and a CUDA tensor the kernel (or a raise),
like every other wrapper; callers that want the reference on the card call
``topk_ban_mask_reference``.  The JAX ``BAN_CAP`` compaction and its
``lax.cond`` fallback exist because Mosaic unrolls the ban loop
statically; the CUDA kernel loops over any M, so neither comes across.

The kernel finds the k-th key by a radix select (``csrc/topk_mask.cu``):
three digits of the monotone key, the first over the row, the next two
over a short list of the keys from the first digit's bin up.  It takes
any V.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from image2text_torch.ops import _build


def topk_ban_mask_reference(logits: torch.Tensor,
                            banned_id: Optional[torch.Tensor],
                            k: int) -> torch.Tensor:
    """The JAX reference's formulation: scatter-min the bans, threshold at
    the k-th value, keep ties."""
    b, v = logits.shape
    x = logits.float()
    if banned_id is not None and banned_id.shape[-1]:
        ban = banned_id.long()
        live = (ban >= 0) & (ban < v)
        rows = torch.arange(b, device=x.device)[:, None].expand_as(ban)
        x = x.index_put((rows[live], ban[live]),
                        torch.tensor(float("-inf"), device=x.device))
    kth = torch.topk(x, min(k, v), dim=-1).values[..., -1:]
    return torch.where(x < kth, torch.full_like(x, float("-inf")), x)


# topk_ban_mask_launch(x, ban, live, out, B, V, M, k, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def topk_ban_mask(logits: torch.Tensor, banned_id: Optional[torch.Tensor],
                  k: int) -> torch.Tensor:
    """(B, V) f32: ``logits`` with banned ids and everything below the k-th
    largest unbanned value set to -inf (ties at the threshold kept)."""
    b, v = logits.shape
    k = int(min(k, v))
    if logits.device.type == "cpu":
        return topk_ban_mask_reference(logits, banned_id, k)
    x = logits.float().contiguous()
    _build.check_operand("topk_ban_mask", "logits", x, torch.float32)
    if banned_id is not None and banned_id.shape[-1]:
        ban = banned_id.to(torch.int32).contiguous()
        _build.check_operand("topk_ban_mask", "banned_id", ban, torch.int32)
        if ban.dim() != 2 or ban.shape[0] != b:
            raise ValueError("topk_ban_mask kernel: banned_id must be (B, M)")
        m = ban.shape[1]
    else:
        ban, m = None, 0
    if k < 1:
        raise ValueError(f"topk_ban_mask kernel: unsupported k={k} (needs "
                         "k >= 1)")
    out = torch.empty_like(x)
    live = torch.empty_like(ban) if ban is not None else None
    fn = _build.entry_point("topk_mask", "topk_ban_mask_launch", _ARGTYPES)
    _build.check(fn(x.data_ptr(), _build.ptr(ban), _build.ptr(live),
                    out.data_ptr(), b, v, m, k, _build.stream(x.device)),
                 "topk_ban_mask_launch")
    topk_ban_mask.launches += 1
    return out


topk_ban_mask.launches = 0
