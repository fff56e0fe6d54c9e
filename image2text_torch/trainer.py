"""Training CLI of the port, the twin of the repository's ``trainer.py``:
the same flags, the same YAML schema (read by ``configs/reader.py``) and
the same epoch loop (train → qualitative eval → val).

    python -m image2text_torch.trainer \\
        --config_file training_configs/local/synthetic-smoke.yaml \\
        [--chkpt_file out.npz] [--resume_dir state_dir]

It runs on the card.  A caller may pass ``device='cpu'`` to :func:`main`
(the tests do); there is no flag for it.

On a mesh: ``torchrun --nproc_per_node N -m image2text_torch.trainer
--config_file ...`` (the YAML's ``mesh``, ``zero_sharded_optimizer``,
``sequence_parallel``).  Each rank joins the process group
(``parallel/mesh.py::maybe_initialize_distributed``: NCCL, device
``cuda:LOCAL_RANK``), its loaders read its data rank's rows (seeded by
the data index, so model peers read the same) and yield its share of
each global batch (``batch_size / data`` rows); rank 0 prints and
writes.  One process without torchrun's environment runs as before.

The datasets are the offline ones (``dataset: synthetic`` and ``synthetic-composite``) and a local
image directory (``dataset: local`` with ``dataset_dir``: images and a
``captions.json``, ``training/data.py::get_local_dataloader``); the Deep
Lake loader (``flickr30k``) is not ported and raises.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from image2text_torch.configs.models import PretrainedViTConfig
from image2text_torch.configs.reader import load_training_config
from image2text_torch.configs.trainer import TrainingConfig
from image2text_torch.parallel.mesh import (make_mesh,
                                            maybe_initialize_distributed)
from image2text_torch.training.data import (Prefetcher,
                                            SyntheticCompositeDataset,
                                            SyntheticFlickrDataset,
                                            WrapperDataLoader, data_shard,
                                            get_local_dataloader,
                                            process_index)
from image2text_torch.training.loop import Trainer
from image2text_torch.training.tokenizer import get_tokenizer
from image2text_torch.training.wrapper import ModelTrainerWrapper, TokenizerInfo
from image2text_torch.utils.device import resolve_device


def eval_model(trainer: Trainer, tokenizer, val_iter, epoch: int,
               ignore_index: int, prompt=None, num_candidates: int = 4):
    """Qualitative val-time generation: ``num_candidates`` captions of one
    val image at temperature 0.7, nucleus 0.6, printed beside its truth."""
    say = print if trainer.rank0 else (lambda *a, **k: None)
    say(f"Model perf at the end of the {epoch}-th epoch")
    say("Val:")
    images, labels = next(val_iter)
    model = trainer.wrapper.model
    dev = model.device
    x = torch.as_tensor(np.asarray(images[:1]), device=dev).expand(
        num_candidates, *images.shape[1:])
    label_ = np.asarray(labels[0])
    prompt = tokenizer.bos_token if prompt is None \
        else " ".join([tokenizer.bos_token, prompt])
    decoded_ids = torch.tensor(tokenizer(text=prompt).input_ids)[None]
    decoded_ids = decoded_ids.expand(num_candidates, decoded_ids.shape[-1])
    window = model.decoder.block_size - model.space_for_prompt
    max_new = min(128, window - decoded_ids.shape[-1])
    gen = torch.Generator(device=dev).manual_seed(
        trainer.seed * 1_000_003 + epoch)
    # eager: every optimizer step writes the weights, so a captured call
    # of this epoch would never be replayed
    result = model.generate(x, decoded_ids, temperature=0.7,
                            max_new_tokens=max_new, nucleus_p=0.6,
                            generator=gen, graphs=False)
    result_txt = tokenizer.batch_decode(result.cpu().numpy()[:, 1:])
    reference = tokenizer.batch_decode([label_[label_ != ignore_index]])[0]
    say("truth", reference, "\n")
    for text in result_txt:
        i = text.find(tokenizer.eos_token)
        say(text[:i] if i >= 0 else text)


def local_batch(config: TrainingConfig, shard=None) -> int:
    """Rows of a batch this process's loaders yield: its data rank's
    share of ``batch_size`` (``shard``: ``training/data.py::data_shard``)."""
    return config.batch_size // data_shard(shard)[1]


def build_inner_datasets(config: TrainingConfig, tokenizer, shard=None):
    """(train, val) inner datasets yielding raw 5-caption batch dicts; each
    data rank of a mesh (``shard`` = (data index, data size)) draws its own
    stream (its seed offset by its data index), its model peers the
    same."""
    seed = config.seed + data_shard(shard)[0] * 1_000_003
    inner_bs = config.dataloader_buffer_size * local_batch(config, shard)
    enc = config.model.vision_encoder_config
    is_vit = isinstance(enc, PretrainedViTConfig)
    if config.dataset == "local":
        return get_local_dataloader(tokenizer, inner_bs, config.shuffle,
                                    is_vit, dataset_dir=config.dataset_dir,
                                    shard=shard)
    if config.dataset not in ("synthetic", "synthetic-composite"):
        raise NotImplementedError(
            f"dataset {config.dataset!r}: the Deep Lake loader is not ported "
            "(it needs the network); use dataset: synthetic, "
            "synthetic-composite or local")
    image_size = 224 if is_vit else enc.input.width
    vocab = config.model.decoder_config.vocab_size
    cls = (SyntheticCompositeDataset if config.dataset == "synthetic-composite"
           else SyntheticFlickrDataset)
    train_ds = cls(27000, inner_bs, image_size=image_size, vocab_size=vocab,
                   eos_token_id=tokenizer.eos_token_id, seed=seed)
    val_ds = cls(4000, inner_bs, image_size=image_size, vocab_size=vocab,
                 eos_token_id=tokenizer.eos_token_id, seed=seed + 1)
    return train_ds, val_ds


def build_dataloaders(config: TrainingConfig, tokenizer, shard=None):
    """train/val WrapperDataLoaders from the configured dataset, yielding
    this data rank's rows (``shard``, as :func:`build_inner_datasets`)."""
    seed = config.seed + data_shard(shard)[0] * 1_000_003
    train_ds, val_ds = build_inner_datasets(config, tokenizer, shard)
    train_dl = WrapperDataLoader(train_ds,
                                 batch_size=local_batch(config, shard),
                                 ignore_idx=config.ignore_index,
                                 epochs=config.epochs, seed=seed)
    val_dl = WrapperDataLoader(val_ds, batch_size=local_batch(config, shard),
                               ignore_idx=config.ignore_index, epochs=100000,
                               seed=seed + 1)
    return train_dl, val_dl


def config_tokenizer(config: TrainingConfig):
    return get_tokenizer(
        config.tokenizer_str, config.trainer.mask_fraction,
        synthetic_vocab=config.model.decoder_config.vocab_size,
        allow_fallback=config.dataset.startswith("synthetic"))


def main(args, device=None) -> Trainer:
    """Train as ``args`` say, on the card (``device`` None) or on
    ``device``; returns the Trainer (its ``history`` holds every step's
    metrics)."""
    config = load_training_config(args.config_file)
    if maybe_initialize_distributed(device) and device is None:
        device = f"cuda:{torch.cuda.current_device()}"
    dev = resolve_device(device)
    mesh = make_mesh(config.mesh, dev.type)
    shard = (mesh.data.rank, mesh.shape["data"])
    if process_index() == 0:
        print(config)
    tokenizer = config_tokenizer(config)
    train_dl, val_dl = build_dataloaders(config, tokenizer, shard)
    wrapper = ModelTrainerWrapper(config.model,
                                  TokenizerInfo.from_tokenizer(tokenizer),
                                  config.trainer,
                                  ignore_index=config.ignore_index,
                                  device=dev).init_weights(config.seed)
    trainer = Trainer(config, wrapper, mesh=mesh)
    if args.resume_dir and os.path.isdir(args.resume_dir):
        trainer.restore_state(args.resume_dir)
        if trainer.rank0:
            print(f"resumed train state from {args.resume_dir} (step "
                  f"{trainer.step})")

    train_iter, val_iter = Prefetcher(train_dl), Prefetcher(val_dl)
    n_loop = 10000 if config.max_loop_epochs is None else config.max_loop_epochs
    for epoch in range(n_loop):
        stop = trainer.train_loop(train_iter, epoch,
                                  chkpt_fname=args.chkpt_file)
        if args.resume_dir:
            trainer.save_state(args.resume_dir)
        if stop:
            break
        eval_model(trainer, tokenizer, val_iter, epoch, config.ignore_index)
        loss, metrics = trainer.val_loop(val_iter, epoch)
        if process_index() == 0:
            print(f"Epoch: {epoch}, loss: {loss}, metrics: {metrics}")
    return trainer


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--config_file", required=True, type=str)
    parser.add_argument("--chkpt_file", required=False, type=str, default=None)
    parser.add_argument("--resume_dir", required=False, type=str, default=None,
                        help="directory for full-train-state save/resume")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
