"""Tokenizers of the port (counterpart of
``image2text_tpu/training/tokenizer.py``): the :class:`SyntheticTokenizer`
of the offline configs (``tokenizer_str: synthetic``), a copy of the JAX
package's.  The HF tokenizers need vocab files that are not in the
repository and a network the port's machines lack: asked for one,
:func:`get_tokenizer` substitutes the synthetic tokenizer where the JAX
package does without an HF cache (a synthetic dataset, whose token ids
carry no language) and raises otherwise.
"""
from __future__ import annotations

import sys
from typing import List, Optional


class SyntheticTokenizer:
    """Integer-token tokenizer for network-free smoke runs and benchmarks."""

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.eos_token_id = 0
        self.bos_token_id = 1
        self.mask_token_id = 2
        self.eos_token = "<EOS>"
        self.bos_token = "<BOS>"
        self.mask_token = "<MSK>"
        self.pad_token = self.eos_token

    def __call__(self, text: str, max_length: Optional[int] = None,
                 truncation=None, padding=None, **kwargs):
        ids = [self._encode_tok(t) for t in text.split()]
        mask = [1] * len(ids)
        if max_length is not None and truncation:
            ids, mask = ids[:max_length], mask[:max_length]
        if padding == "max_length" and max_length is not None:
            pad = max_length - len(ids)
            ids = ids + [self.eos_token_id] * pad
            mask = mask + [0] * pad

        class Enc(dict):  # HF BatchEncoding duck-type: item + attr access
            pass

        enc = Enc(input_ids=ids, attention_mask=mask)
        enc.input_ids, enc.attention_mask = ids, mask
        return enc

    def _encode_tok(self, tok: str) -> int:
        import zlib

        specials = {self.eos_token: 0, self.bos_token: 1, self.mask_token: 2}
        if tok in specials:
            return specials[tok]
        try:
            return int(tok) % self.vocab_size
        except ValueError:
            # crc32, NOT hash(): the builtin is salted per process
            # (PYTHONHASHSEED), which would tokenize the same word
            # differently across runs and across hosts
            return (zlib.crc32(tok.encode()) % (self.vocab_size - 3)) + 3

    def decode(self, ids) -> str:
        names = {0: self.eos_token, 1: self.bos_token, 2: self.mask_token}
        return " ".join(names.get(int(i), str(int(i))) for i in ids)

    def batch_decode(self, batch) -> List[str]:
        return [self.decode(ids) for ids in batch]


def get_tokenizer(tokenizer_str: str, mask_fraction: float = 0.0,
                  synthetic_vocab: Optional[int] = None,
                  allow_fallback: bool = False):
    """The :class:`SyntheticTokenizer` for ``'synthetic'`` (``mask_fraction``
    is the JAX signature's: the synthetic tokenizer has its mask token
    always).  Any other name is an HF tokenizer: with ``allow_fallback``
    the synthetic one stands in, with a warning, as the JAX package's does
    when the HF files cannot be loaded; without, it raises."""
    if tokenizer_str == "synthetic":
        return SyntheticTokenizer(synthetic_vocab or 1024)
    if not allow_fallback:
        raise NotImplementedError(
            f"tokenizer {tokenizer_str!r}: the HF tokenizers are not ported "
            "(their vocab files are not in the repository; ROADMAP queue 1 "
            "item 1); use tokenizer_str: synthetic, or a synthetic dataset")
    print(f"WARNING: tokenizer {tokenizer_str!r} unavailable (the HF "
          "tokenizers are not ported); falling back to SyntheticTokenizer",
          file=sys.stderr)
    return SyntheticTokenizer(synthetic_vocab or 1024)


__all__ = ["SyntheticTokenizer", "get_tokenizer"]
