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
* :func:`process_index` / :func:`process_count` — this process's rank and
  the world size in ``torch.distributed`` (0 and 1 without a process
  group), where the JAX package reads ``jax.process_index()`` /
  ``jax.process_count()``; :func:`data_shard` — the (data index, data
  size) of this process, which the trainer passes from its mesh and by
  which a loader strides its rows (model peers read the same rows);
* the local image-directory loader (``dataset: local``):
  :func:`preprocess_image` (the Flickr resize through the C++ core,
  ``training/native.py``, for uint8 frames), :func:`preprocess_image_vit`
  (the SWAG ViT's bicubic resize and centre crop through PIL where PIL is
  importable, else the bilinear host resize, as JAX),
  :func:`make_row_transform`, :class:`RowBatcher`, :class:`_StridedRows`,
  :func:`_host_shard`, :class:`_LocalRows` and
  :func:`get_local_dataloader`.

Not ported: the Deep Lake loader (``get_flickr30k_dataloader``: it needs
the network and the ``deeplake`` package).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from image2text_torch.ops.preprocess import (FLICKR_MEAN as _FLICKR_MEAN,
                                             FLICKR_STD as _FLICKR_STD,
                                             IMAGENET_MEAN as _IMAGENET_MEAN,
                                             IMAGENET_STD as _IMAGENET_STD)

FLICKR_MEAN = np.asarray(_FLICKR_MEAN, np.float32)
FLICKR_STD = np.asarray(_FLICKR_STD, np.float32)
# SWAG ViT-B/16 eval transforms normalise with ImageNet statistics
IMAGENET_MEAN = np.asarray(_IMAGENET_MEAN, np.float32)
IMAGENET_STD = np.asarray(_IMAGENET_STD, np.float32)


def process_index() -> int:
    """This process's rank (0 without an initialised process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The world size (1 without an initialised process group)."""
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


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


# -- the local image-directory loader ---------------------------------------

def _resize_bilinear(img: np.ndarray, size: int,
                     size_w: int = None) -> np.ndarray:
    """Host bilinear resize with half-pixel centres (HWC uint8/float → CHW
    float): the plain version of the C++ core's resize."""
    h, w = img.shape[:2]
    size_w = size if size_w is None else size_w
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size_w) + 0.5) * w / size_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = img.astype(np.float32)
    out = (im[y0][:, x0] * (1 - wy) * (1 - wx) + im[y0][:, x1] * (1 - wy) * wx
           + im[y1][:, x0] * wy * (1 - wx) + im[y1][:, x1] * wy * wx)
    return out.transpose(2, 0, 1)


def preprocess_image(img: np.ndarray, size: int = 128) -> np.ndarray:
    """ToTensor + Resize + Normalize with the Flickr statistics: uint8 HWC
    frames through the C++ core (``training/native.py``, which raises
    where it cannot be built), anything else through the numpy resize."""
    if img.dtype == np.uint8 and img.ndim == 3:
        from image2text_torch.training.native import resize_normalize_batch

        return resize_normalize_batch(img[None], size, FLICKR_MEAN,
                                      FLICKR_STD)[0]
    chw = _resize_bilinear(img, size) / 255.0
    return ((chw - FLICKR_MEAN[:, None, None]) / FLICKR_STD[:, None, None]
            ).astype(np.float32)


def preprocess_image_vit(img: np.ndarray, size: int = 224) -> np.ndarray:
    """The pretrained ViT's eval transforms (the SWAG checkpoint's): the
    shorter side resized to ``size`` bicubic (PIL's, antialiased), a
    centre crop of ``size``, ImageNet normalisation.  Where PIL is not
    importable the bilinear host resize takes its place, as in the JAX
    package."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh = max(size, int(round(h * scale)))
    nw = max(size, int(round(w * scale)))
    try:
        from PIL import Image

        pil = Image.fromarray(img.astype(np.uint8))
        chw = (np.asarray(pil.resize((nw, nh), Image.BICUBIC),
                          np.float32).transpose(2, 0, 1)) / 255.0
    except ImportError:
        chw = _resize_bilinear(img, nh, nw) / 255.0
    top, left = (nh - size) // 2, (nw - size) // 2
    chw = chw[:, top:top + size, left:left + size]
    return ((chw - IMAGENET_MEAN[:, None, None])
            / IMAGENET_STD[:, None, None]).astype(np.float32)


def make_row_transform(tokenizer, is_vit: bool, max_length: int = 256):
    """A row's transform: the image preprocessed (128 px with the Flickr
    statistics, or the ViT's transforms) and its 5 captions tokenized to
    ``max_length``, padded.  A row is ``{"image": (H, W, 3) uint8,
    "caption_k": [text, ...]}``; element 0 of each caption entry is
    tokenized."""
    def _transform(row):
        img = np.asarray(row["image"])
        out = {"image": preprocess_image_vit(img) if is_vit
               else preprocess_image(img, 128)}
        for k in range(5):
            tokenized = tokenizer(
                text=row[f"caption_{k}"][0], max_length=max_length,
                truncation="longest_first", padding="max_length")
            out[f"input_ids_{k}"] = np.asarray(tokenized["input_ids"])
            out[f"attn_mask_{k}"] = np.asarray(tokenized["attention_mask"])
        return out

    return _transform


class RowBatcher:
    """Shuffle, transform and stack a row-indexable dataset into batch
    dicts; with ``workers`` > 1 the rows are fetched and transformed on a
    thread pool with a bounded window, in order."""

    def __init__(self, rows, transform, batch_size: int, shuffle: bool,
                 seed: int, workers: int = 1):
        self.rows = rows
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.workers = workers
        self._epoch = 0

    def __len__(self):
        # every batch is full: a short tail wraps around the epoch's row
        # order, as in the JAX package (one batch shape)
        return -(-len(self.rows) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.rows))
        if self.shuffle:
            # a fresh permutation per pass, seeded
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
            self._epoch += 1
        tail = len(order) % self.batch_size
        if tail and len(order) >= self.batch_size:
            order = np.concatenate([order, order[:self.batch_size - tail]])
        elif tail:  # fewer rows than one batch: cycle up to batch_size
            order = np.resize(order, self.batch_size)
        if self.workers <= 1:
            buf = []
            for i in order:
                buf.append(self.transform(self.rows[int(i)]))
                if len(buf) == self.batch_size:
                    yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}
                    buf = []
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from itertools import islice

        def fetch(i):
            return self.transform(self.rows[int(i)])

        with ThreadPoolExecutor(self.workers) as ex:
            it = iter(order.tolist())
            window = self.workers * 4
            pending = deque(ex.submit(fetch, i) for i in islice(it, window))
            buf = []
            while pending:
                buf.append(pending.popleft().result())
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(fetch, nxt))
                if len(buf) == self.batch_size:
                    yield {k: np.stack([r[k] for r in buf])
                           for k in buf[0]}
                    buf = []


class _StridedRows:
    """Every ``count``-th row from ``offset``: each process of a group
    reads its own disjoint rows.  The length is the common
    ``len(rows) // count``, so every process yields as many batches."""

    def __init__(self, rows, offset: int, count: int):
        self.rows = rows
        self.offset = offset
        self.count = count

    def __len__(self):
        return len(self.rows) // self.count

    def __getitem__(self, i):
        return self.rows[self.offset + int(i) * self.count]


def data_shard(shard=None) -> Tuple[int, int]:
    """(data index, data size) of this process: ``shard`` where the caller
    gives it (the trainer, from its mesh), else (process index, process
    count)."""
    return tuple(shard) if shard is not None else (process_index(),
                                                   process_count())


def _host_shard(rows, shard=None):
    """This data rank's rows (all of them with one data rank): every
    ``count``-th from its index of ``data_shard(shard)``, the same for the
    model peers of a mesh."""
    index, count = data_shard(shard)
    if count == 1:
        return rows
    return _StridedRows(rows, index, count)


class _LocalRows:
    """Rows of an image directory: ``(relative path, captions)`` entries,
    ``.npy`` arrays or image files (read with PIL), the captions cycled
    to 5."""

    def __init__(self, entries, root):
        self.entries = entries  # list of (image_path, [captions])
        self.root = root

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        import os

        path, captions = self.entries[i]
        full = os.path.join(self.root, path)
        if full.endswith(".npy"):
            img = np.load(full)
        else:
            from PIL import Image

            img = np.asarray(Image.open(full).convert("RGB"))
        row = {"image": img}
        for k in range(5):
            row[f"caption_{k}"] = [captions[k % len(captions)]]
        return row


def get_local_dataloader(tokenizer, batch_size: int, shuffle: bool,
                         is_vit: bool, dataset_dir: str,
                         max_length: int = 256,
                         val_fraction: float = 0.1, shard=None):
    """(train, val) :class:`RowBatcher` s over a directory of images and a
    ``captions.json`` mapping each relative image path to its captions
    (1–5, cycled to 5): the entries sorted by path, the last
    ``val_fraction`` of them (at least one) the validation rows; each
    loader this data rank's rows of them (``shard``: :func:`data_shard`)."""
    import json
    import os

    if not dataset_dir:
        raise ValueError(
            "dataset: local requires dataset_dir to point at a directory "
            "containing images and a captions.json")
    with open(os.path.join(dataset_dir, "captions.json")) as f:
        mapping = json.load(f)
    entries = sorted((path, caps if isinstance(caps, list) else [caps])
                     for path, caps in mapping.items())
    if not entries:
        raise ValueError(f"no rows in {dataset_dir}/captions.json")
    n_val = (max(1, int(len(entries) * val_fraction))
             if val_fraction > 0 and len(entries) > 1 else 0)
    n_train = len(entries) - n_val
    tokenizer.pad_token = tokenizer.eos_token
    transform = make_row_transform(tokenizer, is_vit, max_length)
    train = _LocalRows(entries[:n_train], dataset_dir)
    val = _LocalRows(entries[n_train:] if n_val else entries[:], dataset_dir)
    return (RowBatcher(_host_shard(train, shard), transform, batch_size,
                       shuffle, 0),
            RowBatcher(_host_shard(val, shard), transform, batch_size,
                       shuffle, 1))
