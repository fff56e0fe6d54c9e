"""bitsandbytes NF4 checkpoint import, numpy only (the port's own copy of
``image2text_tpu/models/nf4.py``: the port imports nothing of the JAX
package).

A checkpoint saved with bitsandbytes 4-bit tensors (``load_in_4bit``,
``bnb_4bit_quant_type='nf4'``, ``bnb_4bit_use_double_quant=True``) becomes
plain f32 weights that the ordinary importers (``gpt2.import_hf_gpt2``,
``llama.import_hf_llama``, ``falcon.import_hf_falcon``) take, quantizing
them to the port's blockwise int4 where the destination is int4.  The
bnb on-disk layout:

* ``weight``: uint8 tensor of packed 4-bit codes, two per byte, HIGH
  nibble first, flattened row-major over the original (out, in) shape;
* ``weight.absmax``: per-64-element block scale — either f32 directly,
  or (double quantization) uint8 codes with ``weight.nested_absmax``
  (f32 per-256 block scales), ``weight.nested_quant_map`` (the 256-entry
  code) and the float ``offset`` (mean of the pre-quant absmax);
* ``weight.quant_map``: the 16-entry NF4 codebook (also hardcoded here —
  the table is fixed in bitsandbytes' functional.py).

Known quirk, kept as the JAX module has it: the double-quantization
offset is read from a separate ``offset`` key, where real bitsandbytes
checkpoints pack ``nested_offset`` into the ``quant_state`` JSON; such a
checkpoint's offset is not found here (it raises a ``KeyError``).  The
functions are bit-equal to the JAX module's on the same arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# bitsandbytes functional.py NF4 data type table (fixed constants)
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)

BLOCK = 64          # bnb default 4-bit blocksize
NESTED_BLOCK = 256  # bnb double-quant blocksize for absmax


def _dequant_absmax(group: Mapping[str, np.ndarray]) -> np.ndarray:
    """absmax as f32, undoing double quantization when present."""
    absmax = np.asarray(group["absmax"])
    if absmax.dtype != np.uint8:
        return absmax.astype(np.float32).ravel()
    nested_absmax = np.asarray(group["nested_absmax"], np.float32).ravel()
    code = np.asarray(group["nested_quant_map"], np.float32).ravel()
    offset = float(np.asarray(group["offset"]).ravel()[0])
    vals = code[absmax.ravel().astype(np.int64)]
    n = vals.shape[0]
    scales = np.repeat(nested_absmax, NESTED_BLOCK)[:n]
    return vals * scales + offset


def dequantize_nf4(packed: np.ndarray, group: Mapping[str, np.ndarray],
                   shape) -> np.ndarray:
    """packed uint8 codes + quant-state group -> f32 tensor of ``shape``."""
    packed = np.asarray(packed, np.uint8).ravel()
    codes = np.empty(packed.shape[0] * 2, np.uint8)
    codes[0::2] = packed >> 4          # high nibble first (bnb layout)
    codes[1::2] = packed & 0x0F
    code = (np.asarray(group["quant_map"], np.float32).ravel()
            if "quant_map" in group else NF4_CODE)
    vals = code[codes.astype(np.int64)]
    absmax = _dequant_absmax(group)
    n = int(np.prod(shape))
    scales = np.repeat(absmax, BLOCK)[:vals.shape[0]]
    return (vals * scales)[:n].astype(np.float32).reshape(shape)


def quantize_nf4(w: np.ndarray, double_quant: bool = False
                 ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`dequantize_nf4` (testing + checkpoint export):
    returns the bnb-layout group {'weight', 'absmax', ...}."""
    flat = np.asarray(w, np.float32).ravel()
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, BLOCK)
    absmax = np.maximum(np.abs(blocks).max(axis=1), 1e-12).astype(np.float32)
    scaled = blocks / absmax[:, None]
    codes = np.abs(scaled[..., None] - NF4_CODE).argmin(-1).astype(np.uint8)
    flat_codes = codes.ravel()
    packed = ((flat_codes[0::2] << 4) | flat_codes[1::2]).astype(np.uint8)
    out = {"weight": packed, "quant_map": NF4_CODE.copy()}
    if not double_quant:
        out["absmax"] = absmax
        return out
    offset = float(absmax.mean())
    centered = absmax - offset
    npad = (-centered.shape[0]) % NESTED_BLOCK
    cpad = np.concatenate([centered, np.zeros(npad, np.float32)]) \
        .reshape(-1, NESTED_BLOCK)
    nested_absmax = np.maximum(np.abs(cpad).max(axis=1), 1e-12) \
        .astype(np.float32)
    # bnb quantizes the centered absmax against the dynamic 8-bit code;
    # a 256-entry linear code keeps this self-contained and round-trips
    # through the same dequant path (code values in [-1, 1])
    code8 = np.linspace(-1.0, 1.0, 256).astype(np.float32)
    scaled8 = cpad / nested_absmax[:, None]
    codes8 = np.abs(scaled8[..., None] - code8).argmin(-1) \
        .astype(np.uint8).ravel()[:absmax.shape[0]]
    out.update(absmax=codes8, nested_absmax=nested_absmax,
               nested_quant_map=code8,
               offset=np.asarray([offset], np.float32))
    return out


def convert_bnb_nf4_state_dict(sd: Mapping[str, np.ndarray],
                               shapes: Mapping[str, tuple] = None
                               ) -> Dict[str, np.ndarray]:
    """Rewrite a bitsandbytes-4bit state dict into plain f32 weights.

    Quantized entries are detected by the ``<name>.absmax`` companion key
    (the layout ``save_pretrained`` emits for Linear4bit modules).  The
    original (out, in) shape must come from ``shapes[<name>]`` (bnb
    flattens row-major, so the codes alone cannot recover it) — a
    missing shape raises.  Non-quantized entries pass through
    untouched."""
    out: Dict[str, np.ndarray] = {}
    quantized = {k[:-len(".absmax")] for k in sd if k.endswith(".absmax")}
    for k, v in sd.items():
        base = None
        for q in quantized:
            if k == q or (k.startswith(q + ".")
                          and k[len(q) + 1:].split(".")[0] in
                          ("absmax", "quant_map", "nested_absmax",
                           "nested_quant_map", "quant_state", "offset")):
                base = q
                break
        if base is None:
            out[k] = v
        elif k == base:
            group = {c: sd[f"{base}.{c}"] for c in
                     ("absmax", "quant_map", "nested_absmax",
                      "nested_quant_map", "offset") if f"{base}.{c}" in sd}
            if shapes and base in shapes:
                shape = shapes[base]
            else:
                raise ValueError(
                    f"quantized tensor {base!r} needs its original shape: "
                    "pass shapes={name: (out, in)} (bnb packs row-major, "
                    "so the flat codes alone cannot recover it)")
            out[k] = dequantize_nf4(v, group, shape)
        # companion keys are consumed silently
    return out
