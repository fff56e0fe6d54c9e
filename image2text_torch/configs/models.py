"""Model configuration for the PyTorch port: plain dataclasses.

Same class and field names as ``image2text_tpu/configs/models.py``, so a
reader can hold one against the other, and the YAML reader
(``configs/reader.py``) fills them from ``training_configs/``.  The machine with the card has neither pydantic nor PyYAML, so
the reader is the port's own, and three configurations are also
transcribed here as Python constants: the flagship
(``training_configs/tpu/nano-mini.yaml``; :func:`flagship_config` mirrors
the JAX package's ``__graft_entry__._flagship_config``, including its tiny
form), its dense-encoder twin (:func:`flagship_dense_config`) and the int4
+ LoRA GPT-2-medium captioner (``training_configs/tpu/gpt2-medium.yaml``,
:func:`gpt2_medium_config`).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple, Union


@dataclass
class LoraSpec:
    r: int = 16
    lora_alpha: int = 64
    lora_dropout: float = 0.1
    target_modules: Optional[List[str]] = None
    force_enable_update_modules: Optional[List[str]] = None


@dataclass
class MLPConfig:
    ff_mult: float


@dataclass
class MoEConfig:
    num_experts: int
    proj_features: int
    ff_mult_factor: float
    gate_sizes: Optional[Tuple[int, ...]] = None
    top_k: int = 1


class SelfAttentionType(Enum):
    MULTI_HEAD = "multi_head"
    MULTI_QUERY = "multi_query"


@dataclass
class SelfAttentionConfig:
    attn_type: SelfAttentionType
    attn_dropout: float = 0.1
    bias: bool = True
    dropout: float = 0.1
    n_head: int = 12
    n_embd: int = 768


@dataclass
class TransformerConfig:
    rotator_config: Union[MoEConfig, MLPConfig]
    attn_config: SelfAttentionConfig
    is_causal: bool = False
    is_cross_attn: bool = False
    max_block_size: Optional[int] = None
    is_sparse_attn: bool = False
    sparsity_factor: float = 0.5


@dataclass
class ImageInputSpec:
    width: int
    height: int
    n_channels: int = 3


@dataclass
class LshConfig:
    num_bins: Tuple[int, ...]
    num_proj: int
    learnable: bool


@dataclass
class PeerConfig:
    num_units_sqrt: int
    topk: int
    nhead: int
    query_dim: Optional[int] = None


@dataclass
class VisionTransformerEncoderConfig:
    n_cls: int
    transformer_config: TransformerConfig
    input: ImageInputSpec
    num_patches: int
    n_channels: int
    n_layer: int = 12
    enable_gradient_checkpointing: bool = False
    feature_extractor_gate_sizes: Optional[Tuple[int, ...]] = None
    feature_extractor_kernel_size: Tuple[int, int] = (4, 4)
    lora_spec: Optional[LoraSpec] = None


@dataclass
class PretrainedViTConfig:
    """The pretrained ViT-B/16 encoder with one of its three heads: the
    positional MLP (``gate_sizes``), PEER (``peer_config``) or LSH
    (``lsh_config``, which forces the backbone frozen)."""

    n_cls: int
    n_embd_out_vit: int
    refine_base_model: bool = True
    peer_config: Optional[PeerConfig] = None
    lsh_config: Optional[LshConfig] = None
    gate_sizes: Optional[Tuple[int, ...]] = None
    lora_spec: Optional[LoraSpec] = None


class ModelType(Enum):
    GPT2 = "gpt2"
    GPT2_MEDIUM = "gpt2-medium"
    GPT2_LARGE = "gpt2-large"
    GPT2_XL = "gpt2-xl"


# GPT-2 sizes the scratch decoder may be initialised from (a copy of
# image2text_tpu/models/decoder.py's GPT2_MODEL_TABLE)
GPT2_MODEL_TABLE = {
    ModelType.GPT2: dict(n_layer=12, n_head=12, n_embd=768),
    ModelType.GPT2_MEDIUM: dict(n_layer=24, n_head=16, n_embd=1024),
    ModelType.GPT2_LARGE: dict(n_layer=36, n_head=20, n_embd=1280),
    ModelType.GPT2_XL: dict(n_layer=48, n_head=25, n_embd=1600),
}


@dataclass
class TransformerDecoderConfig:
    vocab_size: int
    transformer_config: TransformerConfig
    n_layer: int
    block_size: int
    enable_gradient_checkpointing: bool = False
    use_advanced_pos_emb: bool = False
    skip_alternate_cross_attn: bool = True
    advanced_pos_emb_gate_sizes: Optional[Tuple[int, ...]] = None
    pretrained_model: Optional[ModelType] = None
    lora_spec: Optional[LoraSpec] = None


@dataclass
class HuggingfaceDecoderConfig:
    """A decoder of the HF family by ``model_str``: a GPT-2, Llama-2, Qwen-2
    or Falcon id of the tables in ``models/hf_decoders/factory.py``, or a
    local HF checkpoint directory or ``config.json`` of one of those
    families."""

    use_cross_attn: bool
    model_str: str
    extra_tokens: int
    load_in_4bit: bool
    prepare_for_kbit_training: bool
    vocab_size: int
    lora_spec: Optional[LoraSpec] = None
    enable_gradient_checkpointing: bool = False
    use_auth_token: bool = False


@dataclass
class VisionEncoderDecoderConfig:
    vision_encoder_config: Union[VisionTransformerEncoderConfig,
                                 PretrainedViTConfig]
    decoder_config: Union[TransformerDecoderConfig, HuggingfaceDecoderConfig]
    use_cross_attn: bool = False
    use_soft_prompting: bool = True
    no_repeat_n_grams: Tuple[int, ...] = (2, 3, 4, 5)
    loose_match_decoder_state_dict: bool = False
    chkpt_path: Optional[str] = None


def _flagship() -> VisionEncoderDecoderConfig:
    """``training_configs/tpu/nano-mini.yaml``'s ``model`` section."""
    mq = SelfAttentionType.MULTI_QUERY
    enc = VisionTransformerEncoderConfig(
        enable_gradient_checkpointing=True,
        input=ImageInputSpec(n_channels=3, width=128, height=128),
        n_layer=12, n_cls=64, num_patches=16, n_channels=32,
        feature_extractor_gate_sizes=(8, 16),
        feature_extractor_kernel_size=(6, 6),
        transformer_config=TransformerConfig(
            is_sparse_attn=True, max_block_size=320, sparsity_factor=0.5,
            attn_config=SelfAttentionConfig(
                attn_dropout=0.1, bias=False, dropout=0.1, n_head=8,
                n_embd=1024, attn_type=mq),
            rotator_config=MoEConfig(
                num_experts=4, proj_features=16, gate_sizes=(32,),
                ff_mult_factor=2.0, top_k=2)))
    dec = TransformerDecoderConfig(
        enable_gradient_checkpointing=True, n_layer=12, block_size=256,
        vocab_size=50258,
        transformer_config=TransformerConfig(
            is_cross_attn=True, is_causal=True, is_sparse_attn=True,
            max_block_size=320, sparsity_factor=0.5,
            attn_config=SelfAttentionConfig(
                attn_dropout=0.1, bias=True, dropout=0.1, n_head=8,
                n_embd=1024, attn_type=mq),
            rotator_config=MoEConfig(
                num_experts=4, proj_features=16, gate_sizes=(32,),
                ff_mult_factor=4.0)))
    return VisionEncoderDecoderConfig(
        vision_encoder_config=enc, decoder_config=dec, use_cross_attn=True,
        use_soft_prompting=True, no_repeat_n_grams=(2, 3, 4, 5))


FLAGSHIP = _flagship()


def flagship_config(tiny: bool = False) -> VisionEncoderDecoderConfig:
    """A fresh copy of the flagship config; ``tiny`` cuts it to test size
    exactly as ``__graft_entry__._flagship_config`` does."""
    cfg = copy.deepcopy(FLAGSHIP)
    if tiny:
        enc, dec = cfg.vision_encoder_config, cfg.decoder_config
        enc.n_layer, dec.n_layer = 2, 2
        enc.n_cls = 8
        enc.input.width = enc.input.height = 64
        enc.num_patches = 8
        enc.transformer_config.attn_config.n_embd = 64
        enc.transformer_config.attn_config.n_head = 4
        enc.transformer_config.max_block_size = 80
        dec.transformer_config.attn_config.n_embd = 64
        dec.transformer_config.attn_config.n_head = 4
        dec.block_size = 64
        dec.transformer_config.max_block_size = 80
        dec.vocab_size = 512
        dec.enable_gradient_checkpointing = False
        enc.enable_gradient_checkpointing = False
    return cfg


def flagship_dense_config(tiny: bool = False) -> VisionEncoderDecoderConfig:
    """The flagship with a dense encoder (every encoder block runs every
    token), derived as ``tools/encoder_phase_probe.py`` derives its
    dense-attention twin: the encoder's ``transformer_config.is_sparse_attn``
    False, nothing else changed; the decoder stays the flagship's sparse
    one.  ``tiny`` cuts it as :func:`flagship_config` does."""
    cfg = flagship_config(tiny)
    cfg.vision_encoder_config.transformer_config.is_sparse_attn = False
    return cfg


FLAGSHIP_DENSE = flagship_dense_config()


def _gpt2_medium() -> VisionEncoderDecoderConfig:
    """``training_configs/tpu/gpt2-medium.yaml``'s ``model`` section."""
    enc = VisionTransformerEncoderConfig(
        enable_gradient_checkpointing=True,
        input=ImageInputSpec(n_channels=3, width=128, height=128),
        n_layer=6, n_cls=64, num_patches=16, n_channels=32,
        feature_extractor_gate_sizes=(8, 16),
        feature_extractor_kernel_size=(6, 6),
        transformer_config=TransformerConfig(
            is_sparse_attn=True, max_block_size=320, sparsity_factor=0.25,
            attn_config=SelfAttentionConfig(
                attn_dropout=0.1, bias=False, dropout=0.1, n_head=8,
                n_embd=512, attn_type=SelfAttentionType.MULTI_QUERY),
            rotator_config=MoEConfig(
                num_experts=4, proj_features=16, gate_sizes=(32,),
                ff_mult_factor=2.0, top_k=2)))
    dec = HuggingfaceDecoderConfig(
        model_str="gpt2-medium", use_cross_attn=True, vocab_size=50257,
        extra_tokens=2, load_in_4bit=True, prepare_for_kbit_training=True,
        enable_gradient_checkpointing=True,
        lora_spec=LoraSpec(
            r=16, lora_alpha=64, lora_dropout=0.1,
            target_modules=["c_attn", "mlp.c_fc", "mlp.c_proj"],
            force_enable_update_modules=["*.wpe.*", "*.wte.*",
                                         "*.crossattention.*",
                                         "*.ln_cross_attn.*"]))
    return VisionEncoderDecoderConfig(
        vision_encoder_config=enc, decoder_config=dec, use_cross_attn=True,
        use_soft_prompting=True, no_repeat_n_grams=(2, 3, 4, 5))


GPT2_MEDIUM = _gpt2_medium()


def gpt2_medium_config(tiny: bool = False) -> VisionEncoderDecoderConfig:
    """A fresh copy of :data:`GPT2_MEDIUM`; ``tiny`` cuts the encoder as
    :func:`flagship_config` does and turns checkpointing off.  The GPT-2
    decoder's depth and widths come from ``models/hf_decoders/factory.py``'s
    ``GPT2_TABLE`` by ``model_str``, as in the JAX package: a test cuts them
    by patching that table."""
    cfg = copy.deepcopy(GPT2_MEDIUM)
    if tiny:
        enc = cfg.vision_encoder_config
        enc.n_layer, enc.n_cls = 2, 8
        enc.input.width = enc.input.height = 64
        enc.num_patches = 8
        enc.transformer_config.attn_config.n_embd = 64
        enc.transformer_config.attn_config.n_head = 4
        enc.transformer_config.max_block_size = 80
        enc.enable_gradient_checkpointing = False
        cfg.decoder_config.enable_gradient_checkpointing = False
    return cfg


__all__ = [
    "FLAGSHIP", "FLAGSHIP_DENSE", "GPT2_MEDIUM", "GPT2_MODEL_TABLE",
    "HuggingfaceDecoderConfig", "ImageInputSpec",
    "LoraSpec", "LshConfig", "MLPConfig", "ModelType", "MoEConfig",
    "PeerConfig", "PretrainedViTConfig", "SelfAttentionConfig",
    "SelfAttentionType",
    "TransformerConfig", "TransformerDecoderConfig",
    "VisionEncoderDecoderConfig", "VisionTransformerEncoderConfig",
    "flagship_config", "flagship_dense_config", "gpt2_medium_config",
]
