"""Trainer configuration for the PyTorch port: plain dataclasses.

The fields of ``image2text_tpu/configs/trainer.py`` under the same names,
the mesh (:class:`MeshConfig`), ``zero_sharded_optimizer`` and
``sequence_parallel`` among them (``parallel/``; a run without a
``torch.distributed`` group is one device whatever they say).
``configs/reader.py`` reads a
``training_configs/`` YAML file into :class:`TrainingConfig`;
:data:`FLAGSHIP_TRAINING` transcribes
``training_configs/tpu/nano-mini.yaml`` and :data:`GPT2_MEDIUM_TRAINING`
``training_configs/tpu/gpt2-medium.yaml``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from image2text_torch.configs.models import (VisionEncoderDecoderConfig,
                                             flagship_config,
                                             gpt2_medium_config)


@dataclass
class TrainerWrapperConfig:
    moco_momentum: Optional[float] = None  # e.g. 0.995
    moco_alpha: Optional[float] = None  # e.g. 0.4
    training_temperature: float = 1.0
    weight_fn: str = "constant"
    mask_fraction: float = 0.0  # e.g. 0.15
    random_mask_fraction: float = 0.0  # e.g. 0.2
    eos_token_weight: Optional[float] = None
    add_contrastive_loss: bool = False
    training_contrastive_temperature: float = 1.0


@dataclass
class OptimizerConfig:
    lr: float
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    target_modules: Optional[List[str]] = None


@dataclass
class MeshConfig:
    """The device mesh of a run: ``data`` × ``model`` ranks, ``-1`` on the
    data axis meaning every remaining rank (``parallel/mesh.py``)."""

    data: int = -1
    model: int = 1


@dataclass
class TrainingConfig:
    model: VisionEncoderDecoderConfig
    batch_size: int
    tokenizer_str: str
    trainer: TrainerWrapperConfig
    optimizers: List[OptimizerConfig]
    disable_flash: bool = False
    ignore_index: int = -100
    dataloader_buffer_size: int = 5
    shuffle: bool = True
    gradient_accumulation_steps: int = 1
    epochs: int = 1
    num_steps: Optional[int] = None
    num_val_steps: Optional[int] = None
    precision: str = "no"
    reset_moco_after_k_epochs: Optional[List[int]] = None
    use_snr_optim: bool = False
    seed: int = 0
    dataset: str = "flickr30k"  # or "synthetic" / "synthetic-composite"
    dataset_dir: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    remat_policy: Optional[str] = None
    max_loop_epochs: Optional[int] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # ZeRO-1: the optimizer's moments split over the mesh's data axis
    zero_sharded_optimizer: bool = False
    # the residual stream's sequence axis split over the model axis at the
    # blocks' boundaries in training (needs mesh.model > 1)
    sequence_parallel: bool = False


FLAGSHIP_TRAINING = TrainingConfig(
    model=flagship_config(), tokenizer_str="gpt2",
    trainer=TrainerWrapperConfig(), optimizers=[OptimizerConfig(lr=6e-4)],
    disable_flash=False, batch_size=48, num_steps=200, num_val_steps=20,
    gradient_accumulation_steps=1, precision="bf16")


def flagship_training_config(tiny: bool = False) -> TrainingConfig:
    """A fresh copy of :data:`FLAGSHIP_TRAINING`; ``tiny`` cuts the model
    as ``configs.models.flagship_config(tiny=True)`` does."""
    cfg = copy.deepcopy(FLAGSHIP_TRAINING)
    cfg.model = flagship_config(tiny=tiny)
    return cfg


# The YAML as written: gradient_accumulation_steps is its 8, which its
# batch of 12 does not divide, so the step refuses it (as the JAX step
# does); gpt2_medium_training_config gives the form that runs.
GPT2_MEDIUM_TRAINING = TrainingConfig(
    model=gpt2_medium_config(), tokenizer_str="gpt2-medium",
    trainer=TrainerWrapperConfig(),
    optimizers=[OptimizerConfig(lr=6e-4)], batch_size=12,
    gradient_accumulation_steps=8, precision="bf16")


def gpt2_medium_training_config(tiny: bool = False) -> TrainingConfig:
    """A fresh copy of :data:`GPT2_MEDIUM_TRAINING` in the form that runs:
    gradient accumulation 1 (as ``tools/bench_gpt2_medium_int4.py`` sets
    it) and SNRAdam (as ``bench_train.py`` sets it for the flagship step).
    ``tiny`` cuts the model as
    ``configs.models.gpt2_medium_config(tiny=True)`` does."""
    cfg = copy.deepcopy(GPT2_MEDIUM_TRAINING)
    cfg.model = gpt2_medium_config(tiny=tiny)
    cfg.gradient_accumulation_steps = 1
    cfg.use_snr_optim = True
    return cfg


__all__ = ["FLAGSHIP_TRAINING", "GPT2_MEDIUM_TRAINING", "MeshConfig",
           "OptimizerConfig",
           "TrainerWrapperConfig", "TrainingConfig",
           "flagship_training_config", "gpt2_medium_training_config"]
