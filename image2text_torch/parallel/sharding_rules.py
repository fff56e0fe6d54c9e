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
   ``in_proj_weight`` hold ``[q; k; v]`` (GPT-2's cross-attention
   ``c_attn`` ``[k; v]``), and a rank keeps its heads' rows of each
   section (:func:`shard`, ``sections`` 3 or 2).  JAX's contiguous half
   would hand one rank all of q and half of k.
2. An attention projection whose heads the model size does not divide
   is replicated (its row-split output projection then takes its own
   slice of the replicated heads' output): Llama's and Qwen's K/V when
   their K/V heads do not divide (then their queries too, unless there
   is one K/V head, which every query head reads), and Falcon's fused
   ``query_key_value`` always — its ``[71 query heads | k | v]`` rows
   (4,672 in Falcon-7B) have no even sections, where JAX splits them in
   two.
3. Int4 and LoRA-wrapped Linears split as their base weights do
   (:func:`tp_placements`), every part carried with its base:

   * a column split keeps this rank's rows of the packed bytes, of
     ``weight_scales``, of the bias and of ``lora_B``; ``lora_A`` stays
     whole, its output entering the split through ``copy_to`` (its
     gradient summed over the model group);
   * a row split of an int4 Linear keeps packed byte columns
     ``[r·P/m, (r+1)·P/m)`` (``P = in_pad/2``, ``m`` ranks) and their
     scale columns: bytes and scales stay whole, never re-quantised, and
     the shard reads inputs ``[r·P/m, …) ∪ [P + r·P/m, …)``, because
     byte column c packs inputs c and P + c.  So the column splits
     before it (its group's: the same attention or MLP) take their rows
     in two halves (``pairs`` 2: q/k/v keep heads ``[r·n/2m, …) ∪
     [n/2 + r·n/2m, …)``), and the row split's ``lora_A`` its two halves
     of input columns;  its summed output gets ``B(A·x)`` once, ``A·x``
     summed over the model group first;
   * the shard exists where the input is unpadded and ``P/m`` is whole
     32-column strips (one scale a strip pair); elsewhere the row
     Linear stays whole and so does its whole group
     (:func:`int4_splits_exactly`).  At tp2 that keeps whole:
     GPT-2-xl's attention (25 heads: its ``c_attn`` is head-indivisible
     anyway, and ``c_proj``'s ``P/2`` = 400 is not whole strips) and
     Falcon-7B's (``dense``'s ``P/2`` = 1,136, and the fused
     ``query_key_value`` of point 2).  Llama-2-13B splits everywhere
     (``o_proj``: ``P/2`` = 1,280 = 10 heads of 128; ``down_proj``:
     3,456 = 108 strips), and so do GPT-2-medium and the MLPs of
     GPT-2-xl and Falcon-7B;
   * grouped K/V under pairs split ``2m`` ways or stay whole (point 2);
   * a shard computes the unsplit product up to summation order: an int4
     row shard's partial product and a row-split ``A·x`` stay f32 until
     the model group has summed them, and in training an int4 column
     shard's dx does too (``models/quantization.py``), each rounded once
     as the unsplit one is.

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
                                                   gather_whole, shard_of)

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

# packed [q; k; v] (or GPT-2 cross-attention's [k; v]) projections: split
# section by section; the first match wins
PACKED = (("*crossattention.c_attn.weight", 2), ("*attn.c_attn.weight", 3),
          ("*attn.in_proj_weight", 3))
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
    wpath = _weight_path(path)
    for pattern, n in PACKED:
        if fnmatch.fnmatch(wpath, pattern):
            return n
    return 1


def spec_for(path: str, shape, model_size: int,
             head_dim: Optional[int] = None, pairs: int = 1) -> Tuple:
    """The port's placement: :func:`jax_spec` but for the differences of
    the module docstring.  ``head_dim``, given for an attention
    projection, replicates a column split that would not keep whole
    heads in each packed section; ``pairs`` 2 cuts each section in two
    halves first (the column splits before an int4 row split)."""
    wpath = _weight_path(path)
    if any(fnmatch.fnmatch(wpath, p) for p in UNSECTIONED):
        return REPLICATED
    spec = jax_spec(path, shape, model_size)
    if spec == COL and _rule(wpath) == "col":
        sections = sections_of(path) * pairs
        rows = shape[0] // sections
        if rows * sections != shape[0] or rows % model_size:
            return REPLICATED
        if head_dim is not None and (rows // model_size) % head_dim:
            return REPLICATED
    return spec


def shard(t: torch.Tensor, dim: int, sections: int, rank: int,
          size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t`` along ``dim``: of each of the
    ``sections`` equal sections, its ``1/size`` chunk, concatenated."""
    return shard_of(t, Axis(None, size, rank), dim, sections)


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


def _grouped_kv_replicated(owner: nn.Module, ways: int) -> bool:
    """Llama/Qwen attention whose K/V heads do not split ``ways`` ways
    (and more than one): q, k and v all stay whole."""
    arch = getattr(owner, "arch", None)
    n_kv = getattr(arch, "n_kv_head", None)
    return n_kv is not None and n_kv > 1 and n_kv % ways != 0


def _is_int4(module: nn.Module) -> bool:
    from image2text_torch.models.quantization import QuantizedLinear

    return isinstance(module, QuantizedLinear)


def int4_splits_exactly(lin: nn.Module, model_size: int) -> bool:
    """Whether a row-split int4 Linear has an exact shard over
    ``model_size`` ranks (module docstring, 3): an unpadded input whose
    packed width P = in_pad/2 splits into whole 32-column strips."""
    from image2text_torch.ops.int4_matmul import STRIP

    half = lin.in_pad // 2
    return (lin.in_features == lin.in_pad and half % model_size == 0
            and (half // model_size) % STRIP == 0)


def _tensors_of(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of the parameters and of the buffers the modules
    declare as parameters (the int4 packed weights)."""
    out = list(module.named_parameters())
    for mpath, mod in module.named_modules():
        for name in getattr(mod, "_param_buffers", ()):
            t = getattr(mod, name, None)
            if t is not None:
                out.append((f"{mpath}.{name}" if mpath else name, t))
    return out


def _group_of(owner_path: str, name: str) -> str:
    """The module whose column- and row-split Linears work together (an
    attention or an MLP): a Linear's parent, or the owner of a packed
    ``in_proj``."""
    if name.startswith("in_proj"):
        return owner_path
    return owner_path.rpartition(".")[0]


def _adapter(path: str) -> Optional[Tuple[str, str]]:
    """(LoRA-wrapped module path, 'A' | 'B') of an adapter's weight."""
    for side in ("A", "B"):
        tag = f".lora_{side}."
        if tag in path:
            return path[: path.index(tag)], side
    return None


Placement = Optional[Tuple[int, int]]   # (dim, sections); None: whole


def tp_placements(module: nn.Module, model_size: int
                  ) -> Dict[str, Placement]:
    """{tensor path: (dim, sections) or None} of ``module``'s parameters
    and int4 packed buffers over a model axis of ``model_size``: this
    rank keeps, of each of ``sections`` equal sections of dim ``dim``,
    its ``1/model_size`` chunk.  The port's rules of the module
    docstring on top of JAX's spec (:func:`spec_for`)."""
    mods = dict(module.named_modules())
    tensors = _tensors_of(module)
    if model_size == 1:
        return {path: None for path, _ in tensors}
    pairs: Dict[str, int] = {}     # group → 2 where an int4 row pairs
    whole_groups = set()
    for mpath, mod in mods.items():
        if _rule(f"{mpath}.weight") == "row" and _is_int4(mod):
            group = mpath.rpartition(".")[0]
            if int4_splits_exactly(mod, model_size):
                pairs[group] = 2
            else:
                whole_groups.add(group)

    out: Dict[str, Placement] = {}
    for path, t in tensors:
        if _adapter(path) is not None:
            continue
        owner_path, _, name = path.rpartition(".")
        owner = mods[owner_path]
        group = _group_of(owner_path, name)
        if group in whole_groups:
            out[path] = None
            continue
        factor = pairs.get(group, 1)
        if name == "weight_scales" and _is_int4(owner):
            continue    # follows its packed weight, below
        attn = mods.get(group)
        hd = _head_dim(attn) if attn is not None else None
        spec = spec_for(path, tuple(t.shape), model_size, hd, factor)
        if (spec == COL and hd is not None
                and _grouped_kv_replicated(attn, model_size * factor)):
            spec = REPLICATED
        if spec == REPLICATED:
            out[path] = None
        elif spec == ROW:
            out[path] = (1, 1)
        else:
            out[path] = (0, (sections_of(path) * factor
                             if _rule(_weight_path(path)) == "col"
                             else 1))
    for path, t in tensors:
        owner_path, _, name = path.rpartition(".")
        if name == "weight_scales" and _is_int4(mods[owner_path]):
            out[path] = out.get(f"{owner_path}.weight")
    for path, t in tensors:
        a = _adapter(path)
        if a is None:
            continue
        base, side = a
        place = out.get(f"{base}.weight")
        out[path] = None
        if place is None:
            continue
        if side == "B" and place[0] == 0:
            out[path] = place
        elif side == "A" and place[0] == 1:
            out[path] = (1, input_sections(mods[base]))
    return out


def input_sections(lin: nn.Module) -> int:
    """The sections of the input features a row-split Linear's shard
    reads: one, or for an int4 Linear the two halves of its input (byte
    column c packs inputs c and in_pad/2 + c)."""
    return 2 if _is_int4(lin) else 1


def _weight_path(path: str) -> str:
    return path[: -len("bias")] + "weight" if path.endswith("bias") \
        else path


def tp_param_shardings(module: nn.Module, model_size: int
                       ) -> Dict[str, Tuple]:
    """{tensor path: spec} of ``module`` over a model axis of
    ``model_size`` (:func:`tp_placements` as JAX-style tuples: dim 0
    ``COL``, dim 1 ``ROW``; every spec replicated for size 1)."""
    return {path: (REPLICATED if place is None else
                   COL if place[0] == 0 else ROW)
            for path, place in tp_placements(module, model_size).items()}


def _set_tensor(mod: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """Replace ``mod.<name>`` by ``t`` in place: a parameter keeps its
    ``nn.Parameter`` (new data), a buffer is re-registered."""
    cur = getattr(mod, name)
    if isinstance(cur, nn.Parameter):
        cur.data = t
        return cur
    mod._buffers[name] = t
    return t


@torch.no_grad()
def place_params(module: nn.Module, mesh) -> int:
    """Split ``module``'s parameters (and int4 packed buffers) over the
    mesh's model axis in place (each rank keeps its shard in the same
    tensor slot) and tell the modules that compute with them.  Returns
    how many were split."""
    from image2text_torch.models.layers import MoELinear
    from image2text_torch.nn.modules import Linear, MultiheadAttention

    axis = mesh.model
    if axis.size == 1:
        return 0
    places = tp_placements(module, axis.size)
    mods = dict(module.named_modules())
    n = 0
    for path, t in _tensors_of(module):
        place = places[path]
        if place is None:
            continue
        owner_path, _, name = path.rpartition(".")
        owner = mods[owner_path]
        dim, sections = place
        t = _set_tensor(owner, name, shard(t.data, dim, sections, axis.rank,
                                           axis.size))
        t._tp, t._tp_axis = place, axis
        owner._tp_place = {**getattr(owner, "_tp_place", {}), name: place}
        owner._tp_axis = axis
        n += 1
        if isinstance(owner, Linear) or _is_int4(owner):
            if name == "weight":
                owner.tp = (("col", axis, sections) if dim == 0 else
                            ("row", axis, input_sections(owner)))
                # heads in two halves: the column split before an int4
                # row split (nn/modules.py::tp_heads)
                owner._tp_halves = dim == 0 and sections != sections_of(path)
        elif isinstance(owner, (MultiheadAttention, MoELinear)):
            owner.tp = axis
    for m in module.modules():
        tp = getattr(m, "tp", None)
        if (isinstance(m, Linear) or _is_int4(m)) and tp is not None \
                and tp[0] == "col" and m.bias is not None \
                and not hasattr(m.bias, "_tp"):
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
    """``state`` (a ``module.state_dict()``) with every split tensor (int4
    packed buffers included) gathered whole; a collective: every rank
    calls it."""
    tensors = dict(_tensors_of(module))
    out = {}
    for k, v in state.items():
        t = tensors.get(k)
        out[k] = whole(v, getattr(t, "_tp", None), mesh.model) \
            if t is not None else v
    return out


def local_state(module: nn.Module, mesh, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`whole_state`: each split tensor's shard."""
    tensors = dict(_tensors_of(module))
    out = {}
    for k, v in state.items():
        t = tensors.get(k)
        tp = getattr(t, "_tp", None) if t is not None else None
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
           "input_sections", "int4_splits_exactly", "jax_spec",
           "local_state", "place_params", "sections_of",
           "set_sequence_parallel", "shard", "spec_for", "tp_param_shardings",
           "tp_placements", "whole", "whole_state", "zero_shardable"]
