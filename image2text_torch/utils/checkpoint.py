"""Weight bridge between the JAX package's flat state dict and the port,
and the port's weight checkpoints (counterpart of
``image2text_tpu/utils/checkpoint.py``).

``image2text_tpu/utils/checkpoint.py::export_state_dict`` writes torch
state-dict names: stacked MoE experts split into
``experts.{i}.l1/l2.weight/bias`` keys and the tied ``lm_head.weight``
alias materialised.  :func:`load_jax_state_dict` joins the experts back,
resolves the alias and fills the port's parameters and buffers (the
packed uint8 int4 weights among them); :func:`state_dict_numpy` produces
the same key set, shapes and dtypes from the port, and with ``grads=True``
the parameters' gradients under the same keys (to hold them against the
JAX gradient tree's export).  The sparse-selection index buffers are the
port's own, derived from the config: they are compared, never copied.
The int8 serving forms (``models/quantization.py::int8_serving_params``)
cross both ways as JAX's tree holds them: ``qweight`` int8, ``qscale``
f32 and the zero-length ``qdtype`` marker, whose dtype (float32, float16
or bfloat16) is what it carries; a tied alias whose source is an int8
form is not written, as in JAX's export.  The port's modules must already
hold the int8 form (the transform is a function of shapes and
``min_elems``) before such a tree loads into them.

Under a mesh (``parallel/sharding_rules.py::place_params``) the tensors
a rank holds are shards: :func:`state_dict_numpy` gathers them whole (a
collective: every rank calls it), so a file written from a mesh run is
the one-device run's.

:func:`save_checkpoint` writes that key set as the ``.npz`` the JAX
package's ``load_state_dict`` reads (optionally only the parameters the
optimizer's ``target_modules`` patterns name, and the buffers), and
:func:`update_params_from_partial_checkpoint` is the JAX package's
tolerant restore: the keys a checkpoint has overwrite the model's, the
rest keep their values.  So a checkpoint goes both ways.
"""
from __future__ import annotations

import io
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

SELECTION_BUFFERS = ("input_mask_idx", "input_mask_not_idx")
QDTYPE = "qdtype"   # the int8 forms' zero-length storage-dtype marker
_MARKER_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16}


def _marker_numpy(t: torch.Tensor) -> np.ndarray:
    """The zero-length marker as numpy in its own dtype (bfloat16 through
    ``ml_dtypes``, the numpy extension that defines it)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return np.zeros((0,), ml_dtypes.bfloat16)
    return np.zeros((0,), str(t.dtype).split(".")[-1])


def _marker_dtype(value: np.ndarray) -> torch.dtype:
    name = np.dtype(value.dtype).name
    if name not in _MARKER_DTYPES:
        raise ValueError(f"qdtype marker of dtype {name!r}")
    return _MARKER_DTYPES[name]


def split_specs(model: nn.Module) -> Dict[str, str]:
    """{stacked parameter path: per-expert key template}."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, template in getattr(mod, "split_specs", {}).items():
            p = f"{prefix}.{name}" if prefix else name
            out[p] = f"{prefix}.{template}" if prefix else template
    return out


def _tied_aliases(model: nn.Module) -> Dict[str, str]:
    """{alias key: source key}."""
    out = {}
    for prefix, mod in model.named_modules():
        for alias, source in getattr(mod, "tied_aliases", {}).items():
            pre = f"{prefix}." if prefix else ""
            out[pre + alias] = pre + source
    return out


def _tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def _whole(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (``p`` or its gradient) whole when the placement split ``p``
    over the model axis."""
    place = getattr(p, "_tp", None)
    if place is None:
        return t
    from image2text_torch.parallel.collectives import gather_whole

    return gather_whole(t, p._tp_axis, *place)


def state_dict_numpy(model: nn.Module,
                     grads: bool = False) -> Dict[str, np.ndarray]:
    """The port's weights under the JAX export's keys (float tensors as
    f32 numpy arrays, integer ones unchanged); with ``grads``, the
    parameters' gradients instead (zeros for a parameter without one, such
    as a frozen one; no buffers, so no integer tensor)."""
    flat = {}
    tensors = (dict(model.named_parameters()) if grads
               else _tensors(model))
    for k, p in tensors.items():
        t = p
        if grads:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        t = _whole(p, t.detach()).cpu()
        if k.rsplit(".", 1)[-1] == QDTYPE:
            flat[k] = _marker_numpy(t)
            continue
        flat[k] = (t.float() if t.is_floating_point() else t).numpy()
    for stacked, template in split_specs(model).items():
        arr = flat.pop(stacked)
        for i in range(arr.shape[0]):
            flat[template.format(i=i)] = arr[i]
    for alias, source in _tied_aliases(model).items():
        if source in flat:
            flat[alias] = flat[source]
    return flat


@torch.no_grad()
def _assign(model: nn.Module, sd: Dict[str, np.ndarray]) -> set:
    """Copy every key of ``sd`` into ``model`` (an alias into its source
    where the source is absent); returns what was filled.  Unknown keys
    and shape mismatches raise; the sparse-selection buffers must equal
    the port's own."""
    tensors = _tensors(model)
    aliases = _tied_aliases(model)
    joins = {}
    for stacked, template in split_specs(model).items():
        for i in range(tensors[stacked].shape[0]):
            joins[template.format(i=i)] = (stacked, i)
    filled = set()
    for key, value in sd.items():
        if key in aliases:
            if aliases[key] not in sd:
                key = aliases[key]
            elif not np.array_equal(value, sd[aliases[key]]):
                raise ValueError(f"tied alias {key} differs from "
                                 f"{aliases[key]}")
            else:
                continue
        if key in joins:
            stacked, i = joins[key]
            dst = tensors[stacked][i]
            filled.add((stacked, i))
        elif key in tensors:
            dst = tensors[key]
            filled.add(key)
        else:
            raise KeyError(f"checkpoint key {key!r} not present in the port")
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(dst.shape)} "
                             f"vs {value.shape}")
        if key.rsplit(".", 1)[-1] == QDTYPE:
            path, name = key.rsplit(".", 1)
            model.get_submodule(path).register_buffer(name, torch.zeros(
                0, dtype=_marker_dtype(value), device=dst.device))
            continue
        value = np.asarray(value)
        if value.dtype.name == "bfloat16":   # a bf16 JAX tree: exact in f32
            value = value.astype(np.float32)
        src = torch.from_numpy(np.array(value))
        if key.rsplit(".", 1)[-1] in SELECTION_BUFFERS:
            if not torch.equal(dst.cpu(), src.to(dst.dtype)):
                raise ValueError(f"buffer {key} differs from the port's")
            continue
        dst.copy_(src.to(dst.dtype))
    return filled


def load_jax_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> None:
    """Fill every parameter and buffer of ``model`` from the JAX export
    ``sd`` ({key: ndarray}).  Unknown keys, shape mismatches and missing
    keys raise; the sparse-selection buffers must equal the port's own."""
    filled = _assign(model, sd)
    tensors = _tensors(model)
    missing = [k for k, t in tensors.items()
               if k not in filled and k not in split_specs(model)]
    missing += [f"{s}[{i}]" for s in split_specs(model)
                for i in range(tensors[s].shape[0]) if (s, i) not in filled]
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]} "
                       f"({len(missing)} in all)")


def save_checkpoint(model: nn.Module, path: str,
                    matchers: Optional[List] = None) -> None:
    """Write ``model``'s weights as the JAX export's ``.npz``; with
    ``matchers`` (``utils/patterns.PatternMatcher``s) only the keys one of
    them matches, and every buffer.  Every process of a process group calls
    it (a split weight is gathered whole); only process 0 writes."""
    import torch.distributed as dist

    sd = state_dict_numpy(model)
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    if matchers:
        buffers = {k for k, _ in model.named_buffers()}
        sd = {k: v for k, v in sd.items()
              if k in buffers or any(m.match(k) for m in matchers)}
    buf = io.BytesIO()
    np.savez(buf, **sd)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{key: ndarray} of a ``.npz`` checkpoint."""
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def update_params_from_partial_checkpoint(model: nn.Module,
                                          path: str) -> None:
    """The checkpoint's keys overwrite ``model``'s weights in place; every
    other weight keeps its value (tied aliases resolve to their source;
    an unknown key or a shape mismatch raises)."""
    _assign(model, load_state_dict(path))
