"""Parameter placement over the mesh: tensor and expert parallelism on the
'model' axis, sequence parallelism, ZeRO-1 on the 'data' axis
(counterpart of ``image2text_tpu/parallel/sharding_rules.py``).

The rule table :data:`TP_RULES` is JAX's, by fnmatch on a parameter's
path, Linear weights in torch layout (out, in):

* 'col' splits the out dim: each model rank computes its slice of heads
  or neurons (Megatron's column-parallel Linear, entered through
  ``collectives.copy_to``);
* 'row' splits the in dim: each rank's partial product is summed over the
  model group (``collectives.reduce_from``), the bias added once after;
* 'expert' splits the leading expert axis of the stacked MoE tensors:
  each rank evaluates its experts on every token and the top-k combine
  is a partial sum over the model group;
* everything else is replicated, and so is a tensor whose split dim the
  model size does not divide (:func:`spec_for`, JAX's ``_spec_for``); a
  column-parallel bias follows its weight.

The rules match by path, so the encoder's blocks are split as the
decoder's are (JAX's ``_spec_for`` does the same, whatever its module
docstring says).

GSPMD may place a tensor anywhere and still compute the right numbers;
here the placement *is* the computation, so the port differs from JAX's
specs where a legal placement is not a head-aligned computation:

1. Packed projections are split section by section: the scratch
   attention's and GPT-2's ``c_attn`` and the cross-attention's
   ``in_proj_weight`` hold ``[q; k; v]``, and a rank keeps its heads'
   rows of each of the three (:func:`shard`, ``sections`` 3).  JAX's
   contiguous half would hand one rank all of q and half of k.
2. An attention projection whose heads the model size does not divide
   is replicated (its row-split output projection then takes its own
   slice of the replicated heads' output): Llama's and Qwen's K/V when
   their K/V heads do not divide (then their queries too, unless there
   is one K/V head, which every query head reads), and Falcon's fused
   ``query_key_value`` always — its ``[71 query heads | k | v]`` rows
   (4,672 in Falcon-7B) have no even sections, where JAX splits them in
   two.
3. LoRA-wrapped and int4 Linears stay replicated (JAX splits their base
   weights; the port's adapters and packed int4 rows have no split form).

The eval kernels (``sparse_block``, ``fused_block``, ``moe_ffn``, the
front) read whole operands: they take the layers they read gathered
(``Linear.whole``, ``MoELinear.packed``; once per parameter version), so
an eval forward under a mesh runs those kernels on every rank, as an
opaque ``pallas_call``'s operands are gathered under GSPMD.

:func:`set_sequence_parallel` tags the four block classes (JAX's count);
a tagged model's block loop keeps the residual stream, and with it every
remat-saved block input, as this rank's chunk of the sequence between
blocks (``nn.core.SequenceParallel``).  :class:`ZeroOptimizer` is ZeRO-1:
moments of float tensors of at least ``min_size`` elements whose leading
axis the data size divides (JAX's rule), and that no model split already
placed, live as 1/data slices; every rank updates its slice and the
slices are all-gathered over the data group.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from image2text_torch.parallel.collectives import (Axis, chunk_of,
                                                   gather_whole)

# fnmatch pattern → 'col' (shard out dim) | 'row' (shard in dim) | 'expert'
TP_RULES = (
    # scratch decoder / HF GPT-2
    ("*attn.c_attn.weight", "col"),
    ("*attn.q_attn.weight", "col"),
    ("*attn.c_proj.weight", "row"),
    ("*mlp.c_fc.weight", "col"),
    ("*mlp.c_proj.weight", "row"),
    # scratch MQA
    ("*attn.q_proj.weight", "col"),
    ("*attn.out_proj.weight", "row"),
    # cross-attention (torch MultiheadAttention layout): packed qkv in_proj
    # column-split; out_proj covered by the *attn.out_proj.weight row rule
    ("*attn.in_proj_weight", "col"),
    # Llama/Qwen
    ("*self_attn.q_proj.weight", "col"),
    ("*self_attn.k_proj.weight", "col"),
    ("*self_attn.v_proj.weight", "col"),
    ("*self_attn.o_proj.weight", "row"),
    ("*mlp.gate_proj.weight", "col"),
    ("*mlp.up_proj.weight", "col"),
    ("*mlp.down_proj.weight", "row"),
    # Falcon
    ("*self_attention.query_key_value.weight", "col"),
    ("*self_attention.dense.weight", "row"),
    ("*mlp.dense_h_to_4h.weight", "col"),
    ("*mlp.dense_4h_to_h.weight", "row"),
    # MoE stacked experts: shard the expert axis — expert parallelism
    ("*.l1_weight", "expert"),
    ("*.l1_bias", "expert"),
    ("*.l2_weight", "expert"),
    ("*.l2_bias", "expert"),
)

# packed [q; k; v] projections: split section by section
PACKED = (("*attn.c_attn.weight", 3), ("*attn.in_proj_weight", 3))
# fused projections with no even sections: replicated
UNSECTIONED = ("*self_attention.query_key_value.weight",)

REPLICATED: Tuple = ()
COL: Tuple = ("model",)
ROW: Tuple = (None, "model")


def _rule(path: str) -> Optional[str]:
    for pattern, kind in TP_RULES:
        if fnmatch.fnmatch(path, pattern):
            return kind
    return None


def jax_spec(path: str, shape, model_size: int) -> Tuple:
    """JAX's ``_spec_for`` as a tuple (``P()`` → ``()``, ``P('model')`` →
    ``('model',)``, ``P(None, 'model')`` → ``(None, 'model')``)."""
    kind = _rule(path)
    if kind is not None:
        if kind == "col" and len(shape) == 2 and shape[0] % model_size == 0:
            return COL
        if kind == "row" and len(shape) == 2 and shape[1] % model_size == 0:
            return ROW
        if kind == "expert" and shape[0] % model_size == 0:
            return COL
        return REPLICATED
    if path.endswith("bias"):
        wpath = path[: -len("bias")] + "weight"
        if (_rule(wpath) == "col" and len(shape) == 1
                and shape[0] % model_size == 0):
            return COL
    return REPLICATED


def sections_of(path: str) -> int:
    """Packed sections of a weight (or of the weight a bias follows)."""
    wpath = path[: -len("bias")] + "weight" if path.endswith("bias") \
        else path
    for pattern, n in PACKED:
        if fnmatch.fnmatch(wpath, pattern):
            return n
    return 1


def spec_for(path: str, shape, model_size: int,
             head_dim: Optional[int] = None) -> Tuple:
    """The port's placement: :func:`jax_spec` but for the differences of
    the module docstring.  ``head_dim``, given for an attention
    projection, replicates a column split that would not keep whole
    heads in each packed section."""
    wpath = path[: -len("bias")] + "weight" if path.endswith("bias") \
        else path
    if any(fnmatch.fnmatch(wpath, p) for p in UNSECTIONED):
        return REPLICATED
    spec = jax_spec(path, shape, model_size)
    if spec == COL and _rule(wpath) == "col":
        rows = shape[0] // sections_of(path)
        if rows * sections_of(path) != shape[0] or rows % model_size:
            return REPLICATED
        if head_dim is not None and (rows // model_size) % head_dim:
            return REPLICATED
    return spec


def shard(t: torch.Tensor, dim: int, sections: int, rank: int,
          size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t`` along ``dim``: of each of the
    ``sections`` equal sections, its ``1/size`` chunk, concatenated."""
    axis = Axis(None, size, rank)
    parts = [chunk_of(s, axis, dim) for s in t.chunk(sections, dim=dim)]
    return torch.cat(parts, dim=dim) if sections > 1 else parts[0]


# -- module-aware placement ---------------------------------------------------

def _head_dim(module: nn.Module) -> Optional[int]:
    """The head dim of an attention module (None for anything else)."""
    hd = getattr(module, "head_dim", None)
    if isinstance(hd, int):
        return hd
    arch = getattr(module, "arch", None)
    if arch is not None and isinstance(getattr(arch, "head_dim", None), int):
        return arch.head_dim
    if isinstance(getattr(module, "n_head", None), int) and isinstance(
            getattr(module, "n_embd", None), int):
        return module.n_embd // module.n_head
    return None


def _unsplittable(module: nn.Module) -> bool:
    """LoRA-wrapped and int4 Linears: replicated (module docstring, 3)."""
    from image2text_torch.models.lora import LoRALinear
    from image2text_torch.models.quantization import QuantizedLinear

    return isinstance(module, (LoRALinear, QuantizedLinear)) or hasattr(
        module, "lora_A")


def _grouped_kv_replicated(owner: nn.Module, model_size: int) -> bool:
    """Llama/Qwen attention whose K/V heads the model size does not divide
    (and more than one): q, k and v all stay whole."""
    arch = getattr(owner, "arch", None)
    n_kv = getattr(arch, "n_kv_head", None)
    return n_kv is not None and n_kv > 1 and n_kv % model_size != 0


def tp_param_shardings(module: nn.Module, model_size: int
                       ) -> Dict[str, Tuple]:
    """{parameter path: spec} of ``module`` over a model axis of
    ``model_size`` (every spec replicated for size 1)."""
    mods = dict(module.named_modules())
    out = {}
    for path, p in module.named_parameters():
        owner_path, _, name = path.rpartition(".")
        owner = mods[owner_path]
        if model_size == 1 or _unsplittable(owner):
            out[path] = REPLICATED
            continue
        attn_path = owner_path.rpartition(".")[0]
        attn = owner if name == "in_proj_weight" or name == "in_proj_bias" \
            else mods.get(attn_path)
        hd = _head_dim(attn) if attn is not None else None
        spec = spec_for(path, tuple(p.shape), model_size, hd)
        if (spec == COL and attn is not None and hd is not None
                and _grouped_kv_replicated(attn, model_size)):
            spec = REPLICATED
        out[path] = spec
    return out


@torch.no_grad()
def place_params(module: nn.Module, mesh) -> int:
    """Split ``module``'s parameters over the mesh's model axis in place
    (each rank keeps its shard in the same ``nn.Parameter``) and tell the
    modules that compute with them.  Returns how many were split."""
    from image2text_torch.models.layers import MoELinear
    from image2text_torch.nn.modules import Linear, MultiheadAttention

    axis = mesh.model
    if axis.size == 1:
        return 0
    specs = tp_param_shardings(module, axis.size)
    mods = dict(module.named_modules())
    n = 0
    for path, p in module.named_parameters():
        spec = specs[path]
        if spec == REPLICATED:
            continue
        owner_path, _, name = path.rpartition(".")
        owner = mods[owner_path]
        dim = 0 if spec == COL else 1
        sections = sections_of(path)
        p.data = shard(p.data, dim, sections, axis.rank, axis.size)
        p._tp, p._tp_axis = (dim, sections), axis
        owner._tp_place = {**getattr(owner, "_tp_place", {}),
                           name: (dim, sections)}
        owner._tp_axis = axis
        n += 1
        if isinstance(owner, Linear) and name == "weight":
            owner.tp = ("col" if dim == 0 else "row", axis)
        elif isinstance(owner, MultiheadAttention):
            owner.tp = axis
        elif isinstance(owner, MoELinear):
            owner.tp = axis
    for m in module.modules():
        if isinstance(m, Linear) and m.tp is not None and m.tp[0] == "col" \
                and m.bias is not None and not hasattr(m.bias, "_tp"):
            raise ValueError("a column-split Linear kept its bias whole")
    return n


def set_sequence_parallel(model: nn.Module, mesh) -> int:
    """Tag every transformer block for sequence parallelism (training
    only); the number tagged (0 when the mesh has no model axis)."""
    from image2text_torch.models.hf_decoders.falcon import _FalconBlock
    from image2text_torch.models.hf_decoders.gpt2 import _GPT2Block
    from image2text_torch.models.hf_decoders.llama import _LlamaBlock
    from image2text_torch.models.layers import TransformerBlock

    if mesh.shape.get("model", 1) <= 1:
        return 0
    n = 0
    for m in model.modules():
        if isinstance(m, (TransformerBlock, _GPT2Block, _LlamaBlock,
                          _FalconBlock)):
            m._sp_axis = mesh.model
            n += 1
    return n


# -- whole tensors ------------------------------------------------------------

def whole(t: torch.Tensor, placement, axis: Axis) -> torch.Tensor:
    """The whole tensor of a shard placed as ``placement`` ((dim,
    sections) or None for a replicated one)."""
    if placement is None or axis.size == 1:
        return t
    dim, sections = placement
    return gather_whole(t, axis, dim, sections)


def whole_state(module: nn.Module, mesh, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``state`` (a ``module.state_dict()``) with every split parameter
    gathered whole; a collective: every rank calls it."""
    params = dict(module.named_parameters())
    out = {}
    for k, v in state.items():
        p = params.get(k)
        out[k] = whole(v, getattr(p, "_tp", None), mesh.model) \
            if p is not None else v
    return out


def local_state(module: nn.Module, mesh, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`whole_state`: each split parameter's shard."""
    params = dict(module.named_parameters())
    out = {}
    for k, v in state.items():
        p = params.get(k)
        tp = getattr(p, "_tp", None) if p is not None else None
        out[k] = v if tp is None else shard(v, tp[0], tp[1], mesh.model.rank,
                                            mesh.model.size)
    return out


# -- ZeRO-1 -------------------------------------------------------------------

def zero_shardable(p: torch.Tensor, data: int, min_size: int = 16384) -> bool:
    """JAX's rule: a float tensor of at least ``min_size`` elements whose
    leading axis ``data`` divides, not already split over 'model'."""
    return (p.is_floating_point() and p.dim() >= 1 and p.numel() >= min_size
            and p.shape[0] % data == 0 and getattr(p, "_tp", None) is None)


class ZeroOptimizer:
    """ZeRO-1 over an elementwise optimizer (SNRAdam, AdamW): the inner
    optimizer sees, for each shardable parameter, a leaf holding this data
    rank's slice of its leading axis (moments 1/data the size); after its
    step the slices are all-gathered into the parameters.  The numbers are
    those of the unsplit optimizer: every formula is elementwise."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh,
                 min_size: int = 16384):
        self.inner = optimizer
        self.axis = mesh.data
        self.slices: List[Tuple[torch.Tensor, torch.Tensor]] = []
        data = self.axis.size
        for group in optimizer.param_groups:
            for i, p in enumerate(group["params"]):
                if not zero_shardable(p, data, min_size):
                    continue
                s = chunk_of(p.detach(), self.axis, 0).clone()
                group["params"][i] = s
                self.slices.append((s, p))

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @torch.no_grad()
    def step(self) -> None:
        for s, p in self.slices:
            s.grad = chunk_of(p.grad, self.axis, 0)
        self.inner.step()
        for s, p in self.slices:
            s.grad = None
            if dist.is_initialized() and self.axis.group is not None:
                dist.all_gather_into_tensor(p.data, s.to(p.dtype),
                                            group=self.axis.group)
            else:
                p.data.copy_(s)

    def moment_bytes(self) -> int:
        """Bytes of the optimizer state tensors this rank holds."""
        return sum(t.numel() * t.element_size()
                   for st in self.inner.state.values() for t in st.values()
                   if torch.is_tensor(t))


__all__ = ["COL", "PACKED", "REPLICATED", "ROW", "TP_RULES", "ZeroOptimizer",
           "jax_spec", "local_state", "place_params", "sections_of",
           "set_sequence_parallel", "shard", "spec_for", "tp_param_shardings",
           "whole", "whole_state", "zero_shardable"]
