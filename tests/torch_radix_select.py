"""The ban mask kernel's radix select (``csrc/topk_mask.cu``) step for
step in plain PyTorch, for the tests: the sampled guess of pass 0, the
three digit levels with the bans' corrections, the candidate list and the
route each row takes.  JAX-free: the card tests import it too."""
from typing import List, Optional, Tuple

import torch

from image2text_torch.ops import _build

# the kernel's digits (key bits 31..21, 20..10, 9..0), its candidate list
# and its sample, read from the source
RADIX_BITS, RADIX_LAST_BITS, CAND_CAP, SAMPLE_STRIDE, GUESS_MARGIN = (
    _build.kernel_constants("topk_mask", "RADIX_BITS", "RADIX_LAST_BITS",
                            "CAND_CAP", "SAMPLE_STRIDE", "GUESS_MARGIN"))


def ukey(x: torch.Tensor) -> torch.Tensor:
    """The kernel's unsigned key of f32 values, as int64: the monotone int32
    key (±0.0 share 0) plus 2**31."""
    i = x.float().contiguous().view(torch.int32).long()
    return torch.where(i >= 0, i, -(2 ** 31) - i) + 2 ** 31


def _select(hist: torch.Tensor, rank: int) -> Optional[Tuple[int, int]]:
    """The bin where the count from the top reaches ``rank``, and the count
    above it; None where the histogram holds fewer than ``rank`` keys."""
    above = hist.flip(0).cumsum(0).flip(0) - hist
    hit = torch.nonzero((above < rank) & (rank <= above + hist))
    return None if hit.numel() == 0 else (int(hit[0, 0]),
                                          int(above[hit[0, 0]]))


def _guess(row: torch.Tensor, head: int, k: int) -> int:
    """Pass 0: the first digit of the sample's k / SAMPLE_STRIDE +
    GUESS_MARGIN-th key, the sample being every SAMPLE_STRIDE-th 16-byte
    vector of the row's aligned body (which starts ``head`` values in);
    0 (every key) where the sample is shorter."""
    n4 = (row.numel() - head) // 4
    vec = torch.arange(0, n4, SAMPLE_STRIDE)
    idx = (head + 4 * vec[:, None] + torch.arange(4)).reshape(-1)
    hist = torch.bincount(row[idx] >> (32 - RADIX_BITS),
                          minlength=1 << RADIX_BITS)
    hit = _select(hist, k // SAMPLE_STRIDE + GUESS_MARGIN)
    return 0 if hit is None else hit[0]


def kth_key_radix(logits: torch.Tensor, banned_id: Optional[torch.Tensor],
                  k: int, cand_cap: int = CAND_CAP
                  ) -> Tuple[torch.Tensor, List[str]]:
    """Per row of a (B, V) f32 tensor that starts 16-byte aligned, as the
    kernel takes it: the exact k-th largest key after the bans, as the
    monotone int32 key, and the route the row takes:

    - ``"list"``: pass 1's list (the keys from the guessed first digit up)
      holds the chosen bin's keys and those above them;
    - ``"guess_high"``: the guess lay above the chosen bin, so pass 2 reads
      the row again for the list;
    - ``"reread"``: pass 1's list overflowed, pass 2's (from the chosen bin
      up) holds;
    - ``"overflow"``: the chosen bin's keys overflow the list too, so the
      later digits and the write read the row.

    Each level histograms the keys under the prefix fixed so far, moves
    each live ban's original key to -inf's bin, and takes the bin where
    the count from the top reaches k."""
    b, v = logits.shape
    k = min(int(k), v)
    keys = ukey(logits)
    inf_key = int(ukey(torch.tensor([float("-inf")]))[0])
    shifts = (32 - RADIX_BITS, RADIX_LAST_BITS, 0)
    widths = (RADIX_BITS, RADIX_BITS, RADIX_LAST_BITS)
    out = torch.empty(b, dtype=torch.int64)
    routes = []
    for r in range(b):
        ids = [] if banned_id is None else [int(i) for i in banned_id[r]]
        live = list(dict.fromkeys(i for i in ids if 0 <= i < v))
        ban_keys = keys[r, live]
        row = keys[r]
        head = min(v, (4 - r * v % 4) % 4)
        lowest = _guess(row, head, k)
        prefix, rank = 0, k
        for level, (sh, w) in enumerate(zip(shifts, widths)):
            hi = sh + w

            def under(u):
                return (torch.ones_like(u, dtype=torch.bool) if hi == 32
                        else (u >> hi) == prefix)

            def digit(u):
                return (u >> sh) & ((1 << w) - 1)

            hist = torch.bincount(digit(row[under(row)]), minlength=1 << w)
            hist -= torch.bincount(digit(ban_keys[under(ban_keys)]),
                                   minlength=1 << w)
            if live and bool(under(torch.tensor([inf_key]))[0]):
                hist[digit(torch.tensor(inf_key))] += len(live)
            bin_, above = _select(hist, rank)
            prefix, rank = (prefix << w) | bin_, rank - above
            if level == 0:   # the list: this bin's keys and those above
                cand = row[(row >> sh) >= bin_]
                if cand.numel() > cand_cap:
                    routes.append("overflow")
                else:
                    routes.append(
                        "guess_high" if lowest > bin_
                        else "reread" if int(((row >> sh) >= lowest).sum())
                        > cand_cap else "list")
                    row = cand
        out[r] = prefix - 2 ** 31
    return out.to(torch.int32), routes
