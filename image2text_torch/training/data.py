"""Data pipeline of the port, the offline part of
``image2text_tpu/training/data.py`` (copied: the synthetic streams are
numpy, so the same seed gives the same batches bit for bit):

* :func:`normalize_label` / :func:`unpack_batch` — the HF attention mask
  → labels with ``ignore_index`` beyond the attended length plus one
  trailing token;
* :class:`WrapperDataLoader` — 5 captions an image: images repeated 5×,
  captions joined, permuted, cut into ``batch_size`` chunks (a short tail
  wraps around the permutation);
* :class:`SyntheticFlickrDataset` and :class:`SyntheticCompositeDataset` —
  Flickr30K-shaped offline batches (``dataset: synthetic`` and
  ``synthetic-composite``);
* :class:`Prefetcher` — batches assembled on a background thread;
* :func:`process_index` — this process's rank in ``torch.distributed``
  (0 without a process group), where the JAX package reads
  ``jax.process_index()``.

Not ported (ROADMAP queue 1 item 1's remainder): ``RowBatcher``,
``get_local_dataloader`` and the Deep Lake loader.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def process_index() -> int:
    """This process's rank (0 without an initialised process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def normalize_label(input_ids: np.ndarray, attn_mask: np.ndarray,
                    ignore_index: int = -100) -> np.ndarray:
    """Keep attended tokens plus exactly one trailing EOS (the `<=`,
    reference training/utils.py:16-20); the rest become ignore_index."""
    to_attd = np.clip(attn_mask.sum(axis=-1), 0,
                      attn_mask.shape[-1] - 1)[..., None]
    linear = np.arange(attn_mask.shape[-1])[None, :]
    keep = linear <= to_attd
    return np.where(keep, input_ids, ignore_index)


def unpack_batch(batch: Dict[str, np.ndarray], ignore_index: int = -100):
    images = batch["image"]
    labels = [normalize_label(batch[f"input_ids_{k}"],
                              batch[f"attn_mask_{k}"], ignore_index)
              for k in range(5)]
    return (images, *labels)


class WrapperDataLoader:
    """5-caption expansion + shuffle + rechunk (training/utils.py:39-60)."""

    def __init__(self, dataloader, batch_size: int, ignore_idx: int,
                 epochs: int, seed: int = 0):
        self.dataloader = dataloader
        self.batch_size = batch_size
        self.ignore_idx = ignore_idx
        self.epochs = epochs
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return 5 * len(self.dataloader)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(self.epochs):
            for batch in self.dataloader:
                images, *labels = unpack_batch(batch, self.ignore_idx)
                images = np.concatenate([images] * 5, axis=0)
                lab = np.concatenate(labels, axis=0)
                perm = self.rng.permutation(images.shape[0])
                # as the JAX package (not the reference's torch.split,
                # which emits a short tail chunk): a short tail wraps
                # around the permuted pool up to batch_size, so every
                # batch has one shape
                n = images.shape[0]
                for i in range(0, n, self.batch_size):
                    idx = perm[i:i + self.batch_size]
                    if idx.shape[0] < self.batch_size:
                        extra = np.resize(perm, self.batch_size - idx.shape[0])
                        idx = np.concatenate([idx, extra])
                    yield images[idx], lab[idx]


class SyntheticFlickrDataset:
    """Deterministic Flickr30K-shaped batches for offline runs.

    Image-conditional by construction: each row draws a latent class whose
    visual signature (a fixed random pattern) is added to the image, and all
    5 captions come from that class's token template (with jitter) — so an
    encoder-decoder genuinely has to *look at the image* to caption it, and
    BLEU/CIDEr on held-out rows measure real learning.  Attn masks mimic HF
    padding (ones through the caption, then zeros)."""

    NUM_CLASSES = 16

    def __init__(self, num_rows: int, batch_size: int, image_size: int = 128,
                 seq_len: int = 256, vocab_size: int = 1024,
                 eos_token_id: int = 0, seed: int = 0,
                 caption_len_range: Tuple[int, int] = (6, 18),
                 class_signal: float = 1.5):
        self.num_rows = num_rows
        self.batch_size = batch_size
        self.image_size = image_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.eos = eos_token_id
        self.seed = seed
        self.caption_len_range = caption_len_range
        self.class_signal = class_signal
        # class-shared assets use a FIXED seed: train/val splits built with
        # different `seed`s must agree on what each class looks like
        rng = np.random.default_rng(12345)
        self.templates = rng.integers(
            1, vocab_size,
            (self.NUM_CLASSES, caption_len_range[1])).astype(np.int64)
        self.patterns = rng.standard_normal(
            (self.NUM_CLASSES, 3, image_size, image_size)).astype(np.float32)

    def __len__(self):
        return max(1, self.num_rows // self.batch_size)

    def _caption(self, rng, cls: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.caption_len_range
        n = int(rng.integers(lo, hi))
        t = self.templates[cls][:n].copy()
        # small jitter so captions vary
        flip = rng.random(n) < 0.1
        t[flip] = rng.integers(1, self.vocab_size, flip.sum())
        ids = np.full((self.seq_len,), self.eos, np.int64)
        ids[:n] = t
        mask = np.zeros((self.seq_len,), np.int64)
        mask[:n] = 1
        return ids, mask

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(len(self)):
            b = self.batch_size
            classes = rng.integers(0, self.NUM_CLASSES, b)
            images = rng.standard_normal(
                (b, 3, self.image_size, self.image_size)).astype(np.float32)
            images += self.class_signal * self.patterns[classes]
            batch = {"image": images}
            for k in range(5):
                ids, masks = zip(*(self._caption(rng, int(c))
                                   for c in classes))
                batch[f"input_ids_{k}"] = np.stack(ids)
                batch[f"attn_mask_{k}"] = np.stack(masks)
            yield batch


class SyntheticCompositeDataset(SyntheticFlickrDataset):
    """Harder synthetic captioning task for DISCRIMINATIVE quality
    measurement (round-5: the 16-class template task saturated BLEU-4 at
    ~0.88 on 40 images, too coarse to price serving modes —
    QUALITY_r04.json).

    Each image composes THREE latent factors — object (8), style (6),
    scene (6): 288 combinations — whose visual signatures sum into the
    image.  Every caption is multi-clause: the three factor phrases
    joined by fixed connector tokens, with the clause ORDER shuffled
    per caption (as real Flickr annotators describe in different orders)
    and 10% token jitter.  A model must recover all three factors AND
    their phrasing to score; BLEU sits mid-range and mode deltas
    resolve above image-resampling noise."""

    N_OBJ, N_STYLE, N_SCENE = 8, 6, 6

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.default_rng(54321)  # shared train/val assets
        v = self.vocab_size
        self.obj_phrases = rng.integers(1, v, (self.N_OBJ, 6)).astype(np.int64)
        self.style_phrases = rng.integers(1, v, (self.N_STYLE, 4)).astype(np.int64)
        self.scene_phrases = rng.integers(1, v, (self.N_SCENE, 6)).astype(np.int64)
        self.connectors = rng.integers(1, v, (2,)).astype(np.int64)
        size = self.image_size
        self.obj_patterns = rng.standard_normal(
            (self.N_OBJ, 3, size, size)).astype(np.float32)
        self.style_patterns = rng.standard_normal(
            (self.N_STYLE, 3, size, size)).astype(np.float32)
        self.scene_patterns = rng.standard_normal(
            (self.N_SCENE, 3, size, size)).astype(np.float32)

    def _composite_caption(self, rng, obj, style, scene):
        clauses = [self.obj_phrases[obj].copy(),
                   self.style_phrases[style].copy(),
                   self.scene_phrases[scene].copy()]
        order = rng.permutation(3)
        toks = []
        for j, ci in enumerate(order):
            if j:
                toks.append(self.connectors[j - 1:j])
            toks.append(clauses[ci])
        t = np.concatenate(toks)
        flip = rng.random(t.shape[0]) < 0.1
        t[flip] = rng.integers(1, self.vocab_size, flip.sum())
        ids = np.full((self.seq_len,), self.eos, np.int64)
        n = min(t.shape[0], self.seq_len - 1)
        ids[:n] = t[:n]
        mask = np.zeros((self.seq_len,), np.int64)
        mask[:n] = 1
        return ids, mask

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        sig = self.class_signal / np.sqrt(3.0)  # keep total signal power
        for _ in range(len(self)):
            b = self.batch_size
            objs = rng.integers(0, self.N_OBJ, b)
            styles = rng.integers(0, self.N_STYLE, b)
            scenes = rng.integers(0, self.N_SCENE, b)
            images = rng.standard_normal(
                (b, 3, self.image_size, self.image_size)).astype(np.float32)
            images += sig * (self.obj_patterns[objs]
                             + self.style_patterns[styles]
                             + self.scene_patterns[scenes])
            batch = {"image": images}
            for k in range(5):
                ids, masks = zip(*(self._composite_caption(
                    rng, int(o), int(st), int(sc))
                    for o, st, sc in zip(objs, styles, scenes)))
                batch[f"input_ids_{k}"] = np.stack(ids)
                batch[f"attn_mask_{k}"] = np.stack(masks)
            yield batch


class Prefetcher:
    """Background-thread batch prefetch: overlaps host-side batch assembly
    (5-caption expansion, tokenization, numpy shuffles) with device compute.
    Wraps any iterable of batches; ``depth`` bounds host memory."""

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None
        self._done = False

        def run():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:  # propagate to the consumer
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            # the sentinel is consumed exactly once; keep honouring the
            # iterator contract instead of blocking on the empty queue
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._sentinel:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
