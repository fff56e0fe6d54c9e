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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from image2text_torch.ops import _build

# the kernel holds a row in one block's shared memory (227 KB, less 1 KB
# for its own scratch)
MAX_VOCAB = (227 * 1024 - 1024) // 4


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
        if ban.shape[0] != b:
            raise ValueError("topk_ban_mask kernel: banned_id must be (B, M)")
        m = ban.shape[1]
    else:
        ban, m = None, 0
    if k < 1 or v > MAX_VOCAB:
        raise ValueError(f"topk_ban_mask kernel: unsupported k={k} V={v} "
                         f"(needs k >= 1 and V <= {MAX_VOCAB}: a row lives "
                         "in one block's shared memory)")
    out = torch.empty_like(x)
    lib = _build.load("topk_mask")
    fn = lib.topk_ban_mask_launch
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(x), _build.ptr(ban), _build.ptr(out), ctypes.c_int(b),
             ctypes.c_int(v), ctypes.c_int(m), ctypes.c_int(k),
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "topk_ban_mask_launch")
    topk_ban_mask.launches += 1
    return out


topk_ban_mask.launches = 0
