"""Ablations of the encoder-block chain on the card: where does its time go?

Counterpart of ``tools/block_ablate_probe.py`` (the TPU probe,
``_make_kernel``).  The dense chain (LN1 → q/kv → MQA → Wo + residual →
LN2 → MoE FFN + residual, :func:`image2text_torch.ops.fused_block.run_chain`)
runs on a (b, 160, 1024) bf16 stream with the probe's own block config
(MQA, 8 heads; MoE e 4, r 16, gate 32, ff_mult 2, top-k 2), once with the
shipping kernels and once with each ablated build: the same CUDA sources
compiled with the ``I2T_*`` switches of ``csrc/common.cuh``, one library
per set of defines (``ops/_build.py``):

* ``full``        the shipping chain;
* ``no_gelu``     every GELU of the MoE FFN replaced by 0.5·x;
* ``no_softmax``  probabilities 0.01·s (the score products kept);
* ``no_ln``       LN1 and the FFN's LN2 prologue replaced by identity;
* ``dots_only``   the three ablations together;
* ``exp2``        the softmax's exp as exp2(x·log2 e);
* ``glu_sig``     GELU as x·sigmoid(1.702 x).

Each variant is held against :func:`chain_plain` with the same
substitutions, forced onto the kernel's expert routes, at
``utils/kernel_check.py``'s limits.

    python -m image2text_torch.probes.block_ablate [batch]   # on the card
"""
from __future__ import annotations

import json
import math
import sys
from typing import Dict, Optional, Tuple

import torch

from image2text_torch.configs.models import (MoEConfig, SelfAttentionConfig,
                                             SelfAttentionType,
                                             TransformerConfig)
from image2text_torch.nn.core import init_parameters
from image2text_torch.nn.modules import gelu_tanh, layer_norm
from image2text_torch.ops.fused_block import BlockWeights
from image2text_torch.ops.fused_moe import (MoELinearWeights, pack_mask,
                                            topk_mask, unpack_mask)

LOG2E = 1.4426950408889634
T_SEL = 160   # the probe's stream length: the flagship's selected rows

# name: (plain modes (gelu, softmax, ln), the kernels' defines)
VARIANTS: Dict[str, Tuple[Tuple[str, str, str], Tuple[str, ...]]] = {
    "full": (("on", "on", "on"), ()),
    "no_gelu": (("off", "on", "on"), ("I2T_GELU=1",)),
    "no_softmax": (("on", "off", "on"), ("I2T_SOFTMAX=1",)),
    "no_ln": (("on", "on", "off"), ("I2T_LN=1",)),
    "dots_only": (("off", "off", "off"),
                  ("I2T_GELU=1", "I2T_SOFTMAX=1", "I2T_LN=1")),
    "exp2": (("on", "exp2", "on"), ("I2T_SOFTMAX=2",)),
    "glu_sig": (("sig", "on", "on"), ("I2T_GELU=2",)),
}


def build_units():
    """Every library the port builds: each source as shipped, and
    ``fused_block.cu`` and ``fused_moe.cu`` once per probe variant's
    defines (``ops/_build.py::build_all`` takes the list)."""
    from image2text_torch.ops import _build

    return list(_build.SOURCES) + [
        (src, defines) for _, defines in VARIANTS.values() if defines
        for src in ("fused_block", "fused_moe")]


def probe_config(d: int = 1024, n_head: int = 8) -> TransformerConfig:
    """``tools/block_ablate_probe.py:147-156``'s block config."""
    return TransformerConfig(
        is_causal=False, is_cross_attn=False, is_sparse_attn=False,
        attn_config=SelfAttentionConfig(
            attn_type=SelfAttentionType.MULTI_QUERY, attn_dropout=0.1,
            bias=False, dropout=0.1, n_head=n_head, n_embd=d),
        rotator_config=MoEConfig(num_experts=4, proj_features=16,
                                 gate_sizes=(32,), ff_mult_factor=2.0,
                                 top_k=2))


def probe_block(batch: int, device, seed: int = 0, d: int = 1024,
                n_head: int = 8, t: int = T_SEL):
    """(x, w): a (batch, t, d) bf16 stream 0.3·N(0, 1) and the dense
    block's bf16 kernel operands, random from ``seed``."""
    from image2text_torch.models.layers import TransformerBlock

    blk = TransformerBlock(probe_config(d, n_head), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_parameters(blk, gen)
    w = blk.block_weights(torch.bfloat16)
    x = 0.3 * torch.randn(batch, t, d, device=device, generator=gen)
    return x.to(torch.bfloat16), w


def activation(mode: str):
    if mode == "on":
        return gelu_tanh
    if mode == "off":
        return lambda x: x * 0.5
    return lambda x: x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def _ln(mode: str, x, w, b):
    return x if mode == "off" else layer_norm(x, w, b)


def attention(q, k, v, mode: str):
    """Multi-query attention with the heads folded into the rows; q
    (b, h, t, hd), k/v (b, 1, t, hd).  ``mode`` on: scores scaled in f32,
    rounded to bf16, exact f32 softmax; exp2: the same through exp2;
    off: probabilities 0.01·s."""
    b, h, t, hd = q.shape
    s = torch.matmul(q.reshape(b, 1, h * t, hd).float(),
                     k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if mode == "off":
        p = (s * 0.01).to(q.dtype)
    else:
        s = s.to(q.dtype).float()
        m = s.amax(-1, keepdim=True)
        e = (torch.exp2((s - m) * LOG2E) if mode == "exp2"
             else torch.exp(s - m))
        p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return torch.matmul(p, v).reshape(b, h, t, hd)


def moe_linear(x, w: MoELinearWeights, act, force_mask=None):
    """``ops/fused_moe.py::moe_linear_plain`` with ``act`` for its GELUs;
    returns (y, bit masks, f32 gate values)."""
    fin = x.shape[-1]
    pa = torch.matmul(x, w.wa)
    a = act(pa[..., :w.g] + w.ba[:w.g])
    lg = torch.matmul(a, w.g1w) + w.g1b
    gv = torch.softmax(lg.float() / math.sqrt(fin), dim=-1)
    keep = (topk_mask(gv, w.k) if force_mask is None
            else unpack_mask(force_mask, w.e))
    c = torch.where(keep, gv, torch.zeros_like(gv)).to(x.dtype)
    z = act(pa[..., w.g:] + w.ba[w.g:])
    hw = z * c.repeat_interleave(w.r, dim=-1)
    return (torch.matmul(hw, w.l2w) + torch.matmul(c, w.l2b),
            pack_mask(keep), gv)


def chain_plain(x: torch.Tensor, w: BlockWeights,
                modes: Tuple[str, str, str] = ("on", "on", "on"),
                routes: Optional[torch.Tensor] = None,
                force_routes: Optional[torch.Tensor] = None,
                gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense chain in plain PyTorch, step for step as
    ``ops/fused_block.py::fused_block_plain``, with ``modes`` = (gelu,
    softmax, ln) substituted; ``routes``, ``force_routes`` and ``gates``
    as :func:`image2text_torch.ops.fused_moe.moe_ffn_plain`'s."""
    gelu, softmax, ln = modes
    act = activation(gelu)
    b, t, d = x.shape
    hd = d // w.n_head
    xn = _ln(ln, x, w.ln1_w, w.ln1_b)
    qkv = torch.matmul(xn, w.w_qkv)
    if w.b_qkv is not None:
        qkv = qkv + w.b_qkv
    q = qkv[..., :d].reshape(b, t, w.n_head, hd).transpose(1, 2)
    k = qkv[..., None, d:d + hd].transpose(1, 2)
    v = qkv[..., None, d + hd:].transpose(1, 2)
    o = attention(q, k, v, softmax).transpose(1, 2).reshape(b, t, d)
    y = torch.matmul(o, w.w_o)
    x1 = x + (y if w.b_o is None else y + w.b_o)
    h = _ln(ln, x1, w.ln2_w, w.ln2_b)
    f1 = f2 = None
    if force_routes is not None:
        f1, f2 = force_routes.reshape(b, t, 2).unbind(-1)
    h, m1, g1 = moe_linear(h, w.fc, act, f1)
    y, m2, g2 = moe_linear(act(h), w.proj, act, f2)
    if routes is not None:
        routes.copy_(torch.stack([m1, m2], -1).reshape(-1, 2))
    if gates is not None:
        gates.copy_(torch.stack([g1, g2], -2).reshape(-1, 2, w.fc.e))
    return x1 + y


def check_variant(name: str, x: torch.Tensor, w: BlockWeights) -> dict:
    """One variant's kernels against :func:`chain_plain` on the kernels'
    routes (``utils/kernel_check.py``); raises on disagreement."""
    from image2text_torch.ops.fused_block import run_chain
    from image2text_torch.utils import kernel_check

    modes, defines = VARIANTS[name]
    n, e = x.shape[0] * x.shape[1], w.fc.e
    routes = torch.zeros(n, 2, dtype=torch.uint8, device=x.device)
    gates = torch.zeros(n, 2, e, dtype=torch.float32, device=x.device)
    got = run_chain(x, w, routes, defines)
    want = chain_plain(x, w, modes, force_routes=routes, gates=gates)
    st = kernel_check.check_output(f"block_ablate {name}", got, want)
    st.update(kernel_check.check_routes(f"block_ablate {name}", routes, gates,
                                        w.fc.k))
    return st


def main(batch: int = 64) -> dict:
    """Every variant checked, then timed (CUDA events, median of 10)."""
    from image2text_torch.ops.fused_block import run_chain
    from image2text_torch.probes import time_ms

    x, w = probe_block(batch, "cuda")
    out = {"batch": batch, "t_sel": T_SEL,
           "device": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        for name, (_, defines) in VARIANTS.items():
            st = check_variant(name, x, w)
            out[f"{name}_max_abs_err"] = st["max_abs_err"]
            out[f"{name}_ms"] = time_ms(lambda d=defines: run_chain(
                x, w, None, d))
    return out


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:]))))
