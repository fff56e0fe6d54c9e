"""Layers of the port (counterpart of ``image2text_tpu/models/layers.py``):
MLP, ConvMLP, MoELinear, _MoEMLP, _MLP, multi-query and multi-head
self-attention (``self_attention_from_config``), the TransformerBlock:
sparse, with its lazy layout path and its cached decode, or dense, with
its cached decode; and the pretrained ViT's heads and the decoder's
positional MLP: AdvancedPositionalBiasMLP, PEER (PeerLookup) and the LSH
embeddings.

Parameter and buffer names reproduce the JAX package's (torch state-dict
names), so one exported ``.npz`` feeds both packages.

At eval (``ctx.train`` False) the flagship blocks run through the serving
kernels (``sparse_block``, ``fused_block`` for a dense block, ``moe_ffn``),
which have no backward.  In
training every block computes from its parameters directly, with the
dropout sites of the JAX package, and its self-attention goes through the
flash kernels (``ops/attention.py::sdpa``).  The heads and the positional
MLP run no kernel (JAX computes them outside any Pallas kernel).

Under a model split (``parallel/sharding_rules.py``) the attentions
compute their rank's heads (column-split projections, the shared K/V of
multi-query attention replicated with its gradient summed over the model
group), the MLPs their rank's neurons and the MoE linears their rank's
experts (``MoELinear.tp``); the output projections' partial sums are
reduced over the model group.  The dropout of an attention's
probabilities hashes the global (batch, head) planes (``Ctx.rows``,
``Ctx.heads``).  The eval kernels read the whole block
(``block_weights``, ``MoELinear.packed`` gather split tensors).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from image2text_torch.configs.models import (MLPConfig, MoEConfig,
                                             SelfAttentionConfig,
                                             SelfAttentionType,
                                             TransformerConfig)
from image2text_torch.models.sampling import topk as tie_exact_topk
from image2text_torch.nn.core import (EVAL_CTX, Ctx, dropout, new_param,
                                      normal_init, uniform_init)
from image2text_torch.nn.modules import (Conv2d, Embedding, LayerNorm,
                                         Linear, MultiheadAttention,
                                         gelu_tanh, local_heads, tp_heads,
                                         whole_param)
from image2text_torch.ops.attention import sdpa
from image2text_torch.ops.functions import normalize_gradients
from image2text_torch.ops.fused_block import (BlockWeights, chain_takes,
                                              fused_block, sparse_block)
from image2text_torch.ops.fused_moe import (MoELinearWeights, moe_ffn,
                                            pack_moe_linear, topk_mask)
from image2text_torch.ops.static_gather import (canonicalize, layout_rows,
                                                static_combine, static_take)
from image2text_torch.parallel.collectives import (copy_to, reduce_from,
                                                   scatter_to)


class _Cached:
    """Recompute a derived value only when the parameters it reads change
    (another tensor, new storage, an in-place write, or another dtype).

    Only a module's own ``nn.Parameter``s are cached, and the cache holds
    them and their storages, so no freed tensor's address can alias a
    key.  Any other tensors — the transient casts that
    ``torch.func.functional_call`` swaps in (the val step) — are packed on
    every call.  The value is built without autograd, so no graph outlives
    the call that built it: it serves the eval kernels, which have no
    backward."""

    def __init__(self):
        self.clear()

    def clear(self):
        self._key = None
        self._held = None
        self._value = None

    def get(self, params, extra, make):
        if not all(isinstance(p, nn.Parameter) for p in params):
            with torch.no_grad():
                return make()
        key = (extra,) + tuple((p.data_ptr(), p._version) for p in params)
        held = self._held
        if (key != self._key or len(held) != len(params)
                or any(a is not b for (a, _), b in zip(held, params))):
            with torch.no_grad():
                self._value, self._key = make(), key
            self._held = [(p, p.untyped_storage()) for p in params]
        return self._value


class MLP(nn.Module):
    """Linears with GELU gates between them; children 'model.0', 'model.2',
    ... mirror torch Sequential indices (odd slots are the GELUs)."""

    def __init__(self, in_features: int, out_features: int,
                 gate_sizes: Optional[Tuple[int, ...]] = None,
                 bias: bool = True, device=None):
        super().__init__()
        sizes = (in_features,) + tuple(gate_sizes or ()) + (out_features,)
        self.model = nn.ModuleDict({
            str(2 * i): Linear(sizes[i], sizes[i + 1], bias=bias, device=device)
            for i in range(len(sizes) - 1)})

    @property
    def linears(self):
        return list(self.model.values())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lins = self.linears
        for i, lin in enumerate(lins):
            x = lin(x)
            if i < len(lins) - 1:
                x = gelu_tanh(x)
        return x


class ConvMLP(nn.Module):
    """Stack of 'SAME'-padded convs with GELU gates."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Tuple[int, int],
                 gate_sizes: Optional[Tuple[int, ...]] = None, device=None):
        super().__init__()
        sizes = (in_features,) + tuple(gate_sizes or ()) + (out_features,)
        self.model = nn.ModuleDict({
            str(2 * i): Conv2d(sizes[i], sizes[i + 1], kernel_size,
                               device=device)
            for i in range(len(sizes) - 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.model.values())
        for i, conv in enumerate(convs):
            x = conv(x)
            if i < len(convs) - 1:
                x = gelu_tanh(x)
        return x


class MoELinear(nn.Module):
    """Top-k MoE over low-rank experts, every expert on every token and a
    dense combine of the *unnormalised* top-k gate values (lowest-index
    ties).  Experts are stored stacked; the checkpoint bridge splits them
    into ``experts.{i}.l1/l2.weight/bias`` keys (``split_specs``).

    Expert-parallel under a model split (``tp``, the model Axis): this
    rank holds a contiguous slice of the experts, the gate stays whole
    (every rank routes every token the same way), the combine weights are
    cut to the rank's experts and the output is a partial sum over the
    model group."""

    tp = None

    def __init__(self, in_features: int, out_features: int,
                 proj_features: int, num_experts: int, bias: bool = True,
                 top_k: int = 1, gate_sizes: Optional[Tuple[int, ...]] = None,
                 device=None):
        super().__init__()
        self.top_k = top_k
        self.expert_gates = MLP(in_features, num_experts, gate_sizes, bias,
                                device)
        e = num_experts
        b_in = uniform_init(1.0 / math.sqrt(in_features))
        b_pr = uniform_init(1.0 / math.sqrt(proj_features))
        new_param(self, "l1_weight", (e, proj_features, in_features), b_in,
                  device)
        new_param(self, "l1_bias", (e, proj_features), b_in, device)
        new_param(self, "l2_weight", (e, out_features, proj_features), b_pr,
                  device)
        new_param(self, "l2_bias", (e, out_features), b_pr, device)
        self.split_specs = {name: f"experts.{{i}}.{name[:2]}.{name[3:]}"
                            for name in ("l1_weight", "l1_bias", "l2_weight",
                                         "l2_bias")}
        self._packed = _Cached()

    @property
    def plain_gates(self) -> bool:
        """Whether ``moe_ffn`` takes this gate (JAX ``ops/fused_moe.py::
        _supported``): one hidden layer, and both Linears plain — no int8
        serving form, no LoRA adapters, which the kernel would drop.  A
        gate of another depth (none, or two hidden layers) runs the
        module path."""
        lins = self.expert_gates.linears
        return len(lins) == 2 and not any(
            lin.is_int8 or hasattr(lin, "lora_A") for lin in lins)

    def packed(self, dtype) -> MoELinearWeights:
        """The ``moe_ffn`` operands: every expert (gathered under a model
        split: the kernel reads them whole).  Only for a gate that
        :attr:`plain_gates` takes."""
        if not self.plain_gates:
            raise ValueError("moe_ffn takes a plain gate of one hidden "
                             "layer only")
        g0, g1 = self.expert_gates.linears
        return self._packed.get(
            list(self.parameters()), dtype,
            lambda: pack_moe_linear(
                *(whole_param(self, n) for n in ("l1_weight", "l1_bias",
                                                 "l2_weight", "l2_bias")),
                g0.weight, g0.bias, g1.weight, g1.bias, self.top_k, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """From the parameters, as the JAX module: the top-k gate values
        combine the experts, and gradients reach them through it."""
        e, r, fin = self.l1_weight.shape
        dt = x.dtype
        gv = torch.softmax(self.expert_gates(x).float() / math.sqrt(fin),
                           dim=-1)
        combine = torch.where(topk_mask(gv.detach(), self.top_k), gv,
                              torch.zeros_like(gv))
        if self.tp is not None:
            combine = scatter_to(combine, self.tp, -1)
            x = copy_to(x, self.tp)
        h = torch.matmul(x, self.l1_weight.reshape(e * r, fin).t().to(dt))
        h = gelu_tanh(h + self.l1_bias.reshape(e * r).to(dt))
        c = combine.to(dt)
        hw = h * c.repeat_interleave(r, dim=-1)
        w2 = self.l2_weight.permute(0, 2, 1).reshape(e * r, -1).to(dt)
        y = torch.matmul(hw, w2) + torch.matmul(c, self.l2_bias.to(dt))
        return y if self.tp is None else reduce_from(y, self.tp)


class _MoEMLP(nn.Module):
    """Transformer-block FFN of two MoELinears around a GELU.  At eval it
    is one ``ops.fused_moe.moe_ffn`` call: the CUDA kernel on the card.
    In training it runs the MoELinears from their parameters and drops
    its output."""

    def __init__(self, n_embd: int, bias: bool, config: MoEConfig,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        hidden = int(config.ff_mult_factor * n_embd)
        kw = dict(proj_features=config.proj_features,
                  num_experts=config.num_experts, bias=bias,
                  top_k=config.top_k, gate_sizes=config.gate_sizes,
                  device=device)
        self.c_fc = MoELinear(n_embd, hidden, **kw)
        self.c_proj = MoELinear(hidden, n_embd, **kw)

    @property
    def plain_weights(self) -> bool:
        """Whether ``moe_ffn`` takes this FFN's weights: both gates
        plain and of one hidden layer (:attr:`MoELinear.plain_gates`, JAX
        ``ops/fused_moe.py:_supported``)."""
        return self.c_fc.plain_gates and self.c_proj.plain_gates

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        if not ctx.train and self.plain_weights:
            return moe_ffn(x, self.c_fc.packed(x.dtype),
                           self.c_proj.packed(x.dtype))
        h = self.c_proj(gelu_tanh(self.c_fc(x)))
        return dropout(h, self.dropout_rate, ctx)[0]


class _MLP(nn.Module):
    """Transformer-block FFN with GPT-2 naming (c_fc/c_proj): two Linears
    around a tanh GELU, the output dropped in training.  No kernel: as in
    the JAX package, whose eval block kernels take MoE blocks only."""

    def __init__(self, n_embd: int, bias: bool, config: MLPConfig,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        hidden = int(config.ff_mult * n_embd)
        self.c_fc = Linear(n_embd, hidden, bias, device)
        self.c_proj = Linear(hidden, n_embd, bias, device)

    def forward(self, x: torch.Tensor, ctx: Ctx = EVAL_CTX) -> torch.Tensor:
        h = gelu_tanh(self.c_fc(x, ctx=ctx.fold(11)))
        h = self.c_proj(h, ctx=ctx.fold(12))
        return dropout(h, self.dropout_rate, ctx)[0]


class _SelfAttention(nn.Module):
    """What the two self-attentions share: their dropout sites and the
    attention over their heads; a subclass gives its q, k, v
    (``_heads``) and its output projection (``_out``)."""

    def __init__(self, config: SelfAttentionConfig):
        super().__init__()
        self.n_head = config.n_head
        self.n_embd = config.n_embd
        self.attn_dropout = config.attn_dropout
        self.resid_dropout = config.dropout

    def forward(self, x: torch.Tensor, mask=None, kv_cache=None,
                causal: bool = False, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True) -> torch.Tensor:
        """In training: the reference's per-token q/k/v dropout masks
        (rate ``attn_dropout``, drawn for k, q, v in that order),
        probability dropout inside ``sdpa`` at the *resid* rate (a quirk
        of the reference, kept) and resid dropout after the output
        projection."""
        b, t, c = x.shape
        q, k, v = self._heads(x, ctx)
        if ctx.train and self.attn_dropout > 0.0:
            ones = torch.ones(b, 1, t, 1, device=x.device)
            k_do, ctx = dropout(ones, self.attn_dropout, ctx)
            q_do, ctx = dropout(ones, self.attn_dropout, ctx)
            v_do, ctx = dropout(ones, self.attn_dropout, ctx)
            q, k, v = (m.to(x.dtype) * z for m, z in ((q_do, q), (k_do, k),
                                                     (v_do, v)))
        if kv_cache is not None:
            k, v, mask = kv_cache.update(k, v, mask)
        hctx = ctx.fold(3).with_heads(
            *tp_heads(self._q_linear, q.shape[1], self.n_head))
        y = sdpa(q, k, v, mask=mask, causal=causal,
                 dropout_rate=self.resid_dropout, ctx=hctx,
                 use_flash=use_flash)
        y = self._out(y.transpose(1, 2).reshape(b, t, -1), ctx)
        return dropout(y, self.resid_dropout, ctx.fold(4))[0]


def self_attention_from_config(config: SelfAttentionConfig, device=None):
    """The self-attention a config's ``attn_type`` names (JAX
    ``SelfAttention.from_config``)."""
    if config.n_embd % config.n_head:
        raise ValueError("n_embd must be a multiple of n_head")
    if config.attn_type == SelfAttentionType.MULTI_HEAD:
        return MultiHeadAttention(config, device)
    if config.attn_type == SelfAttentionType.MULTI_QUERY:
        return MultiQueryAttention(config, device)
    raise ValueError("unknown self attn implementation!")


class MultiHeadAttention(_SelfAttention):
    """A fused ``c_attn`` (q, k, v of every head) and ``c_proj``; full-head
    K/V, so its cache is (b, h, L, hd)."""

    def __init__(self, config: SelfAttentionConfig, device=None):
        super().__init__(config)
        self.c_attn = Linear(config.n_embd, 3 * config.n_embd, config.bias,
                             device)
        self.c_proj = Linear(config.n_embd, config.n_embd, config.bias,
                             device)

    @property
    def _q_linear(self):
        return self.c_attn

    def kv_shape(self, batch: int, max_len: int):
        return (batch, local_heads(self.c_attn, self.n_head), max_len,
                self.n_embd // self.n_head)

    def _heads(self, x, ctx: Ctx = EVAL_CTX):
        b, t, c = x.shape
        hd = c // self.n_head
        return tuple(z.reshape(b, t, -1, hd).transpose(1, 2)
                     for z in self.c_attn(x, ctx=ctx.fold(11)).chunk(3, -1))

    def _out(self, y, ctx: Ctx = EVAL_CTX):
        return self.c_proj(y, ctx=ctx.fold(12))


class MultiQueryAttention(_SelfAttention):
    """Multi-query attention: one shared K/V head."""

    def __init__(self, config: SelfAttentionConfig, device=None):
        super().__init__(config)
        hd = config.n_embd // config.n_head
        self.q_proj = Linear(config.n_embd, config.n_embd, config.bias, device)
        self.kv_proj = Linear(config.n_embd, 2 * hd, config.bias, device)
        self.out_proj = Linear(config.n_embd, config.n_embd, config.bias,
                               device)

    @property
    def _q_linear(self):
        return self.q_proj

    def kv_shape(self, batch: int, max_len: int):
        return (batch, 1, max_len, self.n_embd // self.n_head)

    def _heads(self, x, ctx: Ctx = EVAL_CTX):
        b, t, c = x.shape
        hd = c // self.n_head
        q = self.q_proj(x, ctx=ctx.fold(11)).reshape(b, t, -1, hd)
        q = q.transpose(1, 2)
        kv = self.kv_proj(x, ctx=ctx.fold(13))
        if self.q_proj.tp is not None:
            # this rank's query heads on the shared K/V head: its K/V
            # gradient is a partial sum over the model group
            kv = copy_to(kv, self.q_proj.tp[1])
        k = kv[..., :hd].reshape(b, t, 1, hd).transpose(1, 2)
        v = kv[..., hd:].reshape(b, t, 1, hd).transpose(1, 2)
        return q, k, v

    def _out(self, y, ctx: Ctx = EVAL_CTX):
        return self.out_proj(y, ctx=ctx.fold(12))


def sparse_attention_indices(max_block_size: int, sparsity_factor: float,
                             n_cls: int, seed: Optional[int]):
    """Per-depth random token subset (a copy of the JAX package's): a
    PCG64(seed) permutation of the non-CLS positions, CLS positions always
    kept, selections sorted."""
    n_non_zeros = int(sparsity_factor * max_block_size)
    gen = np.random.Generator(np.random.PCG64(seed=seed)) \
        if seed is not None else np.random.default_rng()
    full_mask = np.concatenate([
        np.arange(0, n_cls, dtype=np.int64),
        gen.permutation(max_block_size - n_cls).astype(np.int64) + n_cls,
    ])
    idx = np.sort(full_mask[:n_non_zeros])
    not_idx = np.sort(full_mask[n_non_zeros:])
    return idx, not_idx


class TransformerBlock(nn.Module):
    """Pre-LN block: self-attention → optional cross-attention → MoE FFN.
    A sparse block keeps a static random token selection and sends the
    other tokens through the null-connector bypass; a dense block runs
    every token through the body."""

    def __init__(self, config: TransformerConfig, seed: Optional[int] = None,
                 n_cls: int = 0, device=None):
        super().__init__()
        acfg = config.attn_config
        self.is_causal = config.is_causal
        self.ln_1 = LayerNorm(acfg.n_embd, acfg.bias, device=device)
        self.attn = self_attention_from_config(acfg, device)
        self.ln_2 = LayerNorm(acfg.n_embd, acfg.bias, device=device)
        ffn = (_MoEMLP if isinstance(config.rotator_config, MoEConfig)
               else _MLP)
        self.mlp = ffn(acfg.n_embd, acfg.bias, config.rotator_config, device,
                       dropout_rate=acfg.dropout)
        self.is_cross_attn = config.is_cross_attn
        if config.is_cross_attn:
            self.cross_attn = MultiheadAttention(
                acfg.n_embd, acfg.n_head, dropout=acfg.dropout, device=device)
            self.ln_3 = LayerNorm(acfg.n_embd, acfg.bias, device=device)
        else:
            self.cross_attn = self.ln_3 = None
        self.is_sparse = config.is_sparse_attn
        self.n_cls = n_cls
        self._weights = _Cached()
        if not self.is_sparse:
            self.null_connector = None
            return
        idx, not_idx = sparse_attention_indices(
            config.max_block_size, config.sparsity_factor, n_cls, seed)
        self.idx_np, self.not_idx_np = idx, not_idx
        sel = np.zeros(config.max_block_size, bool)
        sel[idx] = True
        self._sel_mask_np = sel
        # running count of selected positions ≤ i: the bypass rule is
        # global per forward (all positions take the null path while < 2
        # are selected)
        self._cum_sel_np = np.cumsum(sel)
        self.register_buffer("input_mask_idx", torch.as_tensor(idx, device=device))
        self.register_buffer("input_mask_not_idx",
                             torch.as_tensor(not_idx, device=device))
        self.null_connector = Linear(acfg.n_embd, acfg.n_embd, acfg.bias,
                                     device)
        self._rows: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def cache_shape(self, batch: int, max_len: int):
        """Dense layers hold ``max_len`` slots; sparse layers only their
        selected TEXT positions within the decode window
        [n_cls, n_cls + max_len)."""
        if not self.is_sparse:
            return self.attn.kv_shape(batch, max_len)
        n_sel = int(((self.idx_np >= self.n_cls)
                     & (self.idx_np < self.n_cls + max_len)).sum())
        return self.attn.kv_shape(batch, max(n_sel, 1))

    def runs_body(self, t: int) -> bool:
        """Whether a non-cached forward over a ``t``-row stream runs the
        block body (attention and FFN): always for a dense block; for a
        sparse one, when its selection keeps more than one row of the
        stream (otherwise every row takes the null path)."""
        return not self.is_sparse or int((self.idx_np < t).sum()) > 1

    def next_layout(self, layout, t: int):
        """Row layout the lazy path emits for a ``t``-row stream entering
        under ``layout`` (None = canonical; a dense block emits canonical
        order)."""
        if not self.is_sparse:
            return None
        if not self.runs_body(t):
            return layout
        return np.concatenate([self.idx_np[self.idx_np < t],
                               self.not_idx_np[self.not_idx_np < t]])

    def selected_count(self, length: int) -> int:
        """Selected positions among the first ``length`` (the count the
        global bypass rule reads; JAX clips the index into the table)."""
        c = self._cum_sel_np
        return int(c[min(max(length - 1, 0), len(c) - 1)])

    def runs_body_at(self, positions: np.ndarray) -> bool:
        """Whether a cached forward over ``positions`` runs the block body
        (attention and FFN) — the port's bookkeeping of FFN launches."""
        if not self.is_sparse:
            return True
        return any(p < len(self._sel_mask_np) and self._sel_mask_np[p]
                   for p in positions)

    # -- kernel operands ----------------------------------------------------
    def block_weights(self, dtype) -> BlockWeights:
        """The block's operands of ``fused_block`` (dense) or
        ``sparse_block`` (sparse: with the null connector's)."""
        def wt(*lins):      # (in, out) weight of one or more Linears
            return torch.cat([whole_param(lin, "weight") for lin in lins]) \
                .t().to(dtype).contiguous()

        def make():
            a, dt, nc = self.attn, dtype, self.null_connector
            b_qkv = None if a.q_proj.bias is None else torch.cat(
                [whole_param(a.q_proj, "bias"), a.kv_proj.bias])
            return BlockWeights(
                ln1_w=self.ln_1.weight.to(dt), ln1_b=_opt(self.ln_1.bias, dt),
                w_qkv=wt(a.q_proj, a.kv_proj), b_qkv=_opt(b_qkv, dt),
                w_o=wt(a.out_proj), b_o=_opt(a.out_proj.bias, dt),
                ln2_w=self.ln_2.weight.to(dt), ln2_b=_opt(self.ln_2.bias, dt),
                fc=self.mlp.c_fc.packed(dt), proj=self.mlp.c_proj.packed(dt),
                n_head=a.n_head, w_n=None if nc is None else wt(nc),
                b_n=None if nc is None else _opt(nc.bias, dt))
        return self._weights.get(list(self.parameters()), dtype, make)

    def layout_rows(self, layout, t: int, device):
        """(rows_sel, rows_byp) int32 on ``device`` for a ``t``-row stream
        under ``layout``, cached per block."""
        key = (None if layout is None else np.asarray(layout).tobytes(), t,
               str(device))
        rows = self._rows.get(key)
        if rows is None:
            idx = self.idx_np[self.idx_np < t]
            not_idx = self.not_idx_np[self.not_idx_np < t]
            rows = tuple(torch.as_tensor(layout_rows(layout, i).astype(np.int32),
                                         device=device)
                         for i in (idx, not_idx))
            self._rows[key] = rows
        return rows

    # -- forward ------------------------------------------------------------
    def _body(self, x, cross_attn_inputs, cross_kv, mask=None, kv_cache=None,
              causal=False, ctx: Ctx = EVAL_CTX, use_flash: bool = True):
        x = x + self.attn(self.ln_1(x), mask=mask, kv_cache=kv_cache,
                          causal=causal, ctx=ctx.fold(1), use_flash=use_flash)
        if cross_attn_inputs is not None or cross_kv is not None:
            if not self.is_cross_attn:
                raise ValueError("Model not configured for cross attn inputs!!!")
            x = x + self.cross_attn(self.ln_3(x), cross_attn_inputs,
                                    cross_attn_inputs, precomputed_kv=cross_kv,
                                    ctx=ctx.fold(2))
        x = x + self.mlp(self.ln_2(x), ctx=ctx.fold(3))
        return normalize_gradients(x, ctx.data_axis)

    def _null_path(self, z):
        return z + self.null_connector(z)

    def forward(self, x_orig: torch.Tensor, cross_attn_inputs=None,
                attn_mask=None, kv_cache=None, cross_kv=None, layout=None,
                want_lazy: bool = False, ctx: Ctx = EVAL_CTX,
                use_flash: bool = True, sparse_rule_len=None):
        """``layout``/``want_lazy``: a lazy call composes the block's
        static gathers with the incoming row ``layout`` and returns
        ``(stream, new_layout)`` without reassembling canonical order (a
        dense block canonicalises first and returns ``(out, None)``).
        At eval, a non-causal, unmasked block without cross-attention —
        every flagship encoder block — runs as one ``sparse_block`` call
        (lazy sparse) or one ``fused_block`` call (dense); ``use_flash``
        False, the parity mode, keeps the plain block, as in the JAX
        package, and so do int8 serving forms in the block.  Training
        never takes them.

        ``sparse_rule_len`` (a host int; the full-reforward fallback of
        generation): a sparse block evaluates the global "< 2 selected →
        every row takes the null path" rule at that length, not at the
        padded buffer's (JAX layers.py:610-621).  Where it holds the body
        is not run: JAX computes it and discards it."""
        if not self.is_sparse:
            return self._dense_forward(x_orig, cross_attn_inputs, attn_mask,
                                       kv_cache, cross_kv, layout, want_lazy,
                                       ctx, use_flash)
        if kv_cache is not None:
            if layout is not None or want_lazy:
                raise ValueError("the lazy layout is a non-cached path")
            return self._sparse_cached_forward(x_orig, cross_attn_inputs,
                                               attn_mask, kv_cache, cross_kv)
        if sparse_rule_len is not None:
            if layout is not None or want_lazy:
                raise ValueError("the generation fallback runs blocks in "
                                 "canonical order")
            if self.selected_count(sparse_rule_len) < 2:
                return self._null_path(x_orig)
        t = x_orig.shape[1]
        if not self.runs_body(t):
            out = self._null_path(x_orig)
            if want_lazy:
                return out, layout
            return out if layout is None else canonicalize(out, layout)
        idx = self.idx_np[self.idx_np < t]
        not_idx = self.not_idx_np[self.not_idx_np < t]
        new_layout = np.concatenate([idx, not_idx])
        # index tensors cached on the device: a fresh host→device copy
        # would synchronise the stream at every block
        rows_sel, rows_byp = self.layout_rows(layout, t, x_orig.device)
        if (want_lazy and self._serving(x_orig, attn_mask, cross_attn_inputs,
                                        cross_kv, ctx, use_flash)):
            return (sparse_block(x_orig, rows_sel, rows_byp,
                                 self.block_weights(x_orig.dtype)),
                    new_layout)
        x = x_orig.index_select(1, rows_sel)
        if attn_mask is not None:
            i = self.input_mask_idx[:idx.shape[0]]   # idx is sorted
            attn_mask = attn_mask.index_select(-2, i).index_select(-1, i)
        x = self._body(x, cross_attn_inputs, cross_kv, mask=attn_mask,
                       causal=self.is_causal, ctx=ctx, use_flash=use_flash)
        bypass = self._null_path(x_orig.index_select(1, rows_byp))
        if want_lazy:
            return torch.cat([x.to(x_orig.dtype), bypass], dim=1), new_layout
        return static_combine(x.to(x_orig.dtype), bypass, idx, not_idx)

    def _serving(self, x, attn_mask, cross_attn_inputs, cross_kv, ctx,
                 use_flash) -> bool:
        """Whether a non-cached forward takes the eval block kernel: eval,
        no mask, no cross-attention, not causal (JAX layers.py:569-571),
        multi-query attention and an MoE FFN (the JAX gates take such
        blocks only, behind ``_gate_and_weights``; an ``_MLP`` or
        multi-head block runs the plain body).  On the card, as JAX's
        gate on hardware (``ops/fused_block.py:219-224``), bf16 only and
        the head dims the chain takes: an f32 block runs its composed
        forward, whose MoE FFN is ``moe_ffn``'s f32 kernel.  A CPU tensor
        takes the chain's plain version in either dtype, as JAX's
        interpret mode does."""
        a = self.attn
        return (use_flash and not ctx.train and attn_mask is None
                and cross_attn_inputs is None and cross_kv is None
                and not self.is_causal and isinstance(self.mlp, _MoEMLP)
                and isinstance(a, MultiQueryAttention)
                and self.plain_weights
                and (x.device.type == "cpu"
                     or (x.dtype == torch.bfloat16
                         and chain_takes(a.n_embd, a.n_head))))

    @property
    def plain_weights(self) -> bool:
        """Whether every Linear the block kernels read is plain: an int8
        serving form or LoRA adapters (which the kernels would drop) take
        the module path, as JAX ``ops/fused_block.py:232-233`` and
        ``:316-318`` decline them to XLA; so does an FFN whose gates
        ``moe_ffn`` declines."""
        a = self.attn
        lins = [a.q_proj, a.kv_proj, a.out_proj]
        if self.null_connector is not None:
            lins.append(self.null_connector)
        return (not any(lin.is_int8 or hasattr(lin, "lora_A")
                        for lin in lins)
                and (not isinstance(self.mlp, _MoEMLP)
                     or self.mlp.plain_weights))

    def _dense_forward(self, x, cross_attn_inputs, attn_mask, kv_cache,
                       cross_kv, layout, want_lazy, ctx, use_flash):
        if kv_cache is not None:
            # cached decode (JAX layers.py:567): the causal bias over the
            # cache's slots comes from CacheRef.update, which sees the true
            # key length, so the body runs without the causal flag
            if layout is not None or want_lazy:
                raise ValueError("the lazy layout is a non-cached path")
            return self._body(x, cross_attn_inputs, cross_kv, mask=attn_mask,
                              kv_cache=kv_cache, ctx=ctx,
                              use_flash=use_flash)
        if layout is not None:
            x = canonicalize(x, layout)
        if self._serving(x, attn_mask, cross_attn_inputs, cross_kv, ctx,
                         use_flash):
            out = fused_block(x, self.block_weights(x.dtype))
        else:
            out = self._body(x, cross_attn_inputs, cross_kv, mask=attn_mask,
                             causal=self.is_causal, ctx=ctx,
                             use_flash=use_flash)
        return (out, None) if want_lazy else out

    def _sparse_cached_forward(self, x_orig, cross_attn_inputs, attn_mask,
                               kv_cache, cross_kv):
        """Cached forward at host-known positions (prefill and eager
        decode alike): cache slots are ranks among the selected text
        positions.  A chunk with no selected position skips the body and
        the cache; otherwise the body writes the selected rows' K/V, and
        the global < 2-selected bypass rule picks the null path for every
        row — the JAX decode's ``where(active, body, null_path)``."""
        if attn_mask is not None:
            raise ValueError("sparse cached decode takes no padding masks")
        positions = kv_cache.positions
        t = x_orig.shape[1]
        local = [i for i in range(t)
                 if positions[i] < len(self._sel_mask_np)
                 and self._sel_mask_np[positions[i]]]
        if not local:
            kv_cache.skip()
            return self._null_path(x_orig)
        not_local = sorted(set(range(t)) - set(local))
        x = x_orig if len(local) == t else static_take(x_orig, local)
        x = self._body(x, cross_attn_inputs, cross_kv, kv_cache=kv_cache)
        last = min(int(positions[-1]), len(self._cum_sel_np) - 1)
        if int(self._cum_sel_np[last]) < 2:
            return self._null_path(x_orig)
        if not not_local:
            return x.to(x_orig.dtype)
        bypass = self._null_path(static_take(x_orig, not_local))
        return static_combine(x.to(x_orig.dtype), bypass, local, not_local)


def _opt(t, dtype):
    return None if t is None else t.to(dtype)


# -- the pretrained-ViT heads and the decoder's positional MLP ----------------

def _per_position(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (..., p, in) against one (out, in) matrix per position, w
    (p, out, in): products of h's dtype summed in f32, rounded once."""
    return torch.einsum("...pi,poi->...po", h, w.to(h.dtype))


class AdvancedPositionalBiasMLP(nn.Module):
    """One residual MLP per position (GELU-tanh between its layers), the
    positions' weights stacked along a leading axis: ``w{lid}`` (P, out,
    in), ``b{lid}`` (P, out) and, where the widths differ, ``w_res`` /
    ``b_res``.  The checkpoint bridge splits them into the reference's
    ``models.{i}.model.{lid}.weight`` and ``models.{i}.residual_connector.*``
    keys (``split_specs``)."""

    def __init__(self, context_width: int, in_features: int,
                 out_features: int,
                 gate_sizes: Optional[Tuple[int, ...]] = None,
                 add_residual_connection: bool = True, device=None):
        super().__init__()
        self.context_width = context_width
        self.add_residual = add_residual_connection
        self.needs_res_proj = (add_residual_connection
                               and in_features != out_features)
        sizes = (in_features,) + tuple(gate_sizes or ()) + (out_features,)
        self.layer_ids = [str(2 * i) for i in range(len(sizes) - 1)]
        self.split_specs = {}
        P = context_width
        for j, lid in enumerate(self.layer_ids):
            fi, fo = sizes[j], sizes[j + 1]
            init = uniform_init(1.0 / math.sqrt(fi))
            new_param(self, f"w{lid}", (P, fo, fi), init, device)
            new_param(self, f"b{lid}", (P, fo), init, device)
            self.split_specs[f"w{lid}"] = f"models.{{i}}.model.{lid}.weight"
            self.split_specs[f"b{lid}"] = f"models.{{i}}.model.{lid}.bias"
        if self.needs_res_proj:
            init = uniform_init(1.0 / math.sqrt(in_features))
            new_param(self, "w_res", (P, out_features, in_features), init,
                      device)
            new_param(self, "b_res", (P, out_features), init, device)
            self.split_specs["w_res"] = "models.{i}.residual_connector.weight"
            self.split_specs["b_res"] = "models.{i}.residual_connector.bias"

    def _mlp(self, x: torch.Tensor, pick) -> torch.Tensor:
        """``pick(stacked)`` selects the positions' slices of this call."""
        dt = x.dtype
        h = x
        for j, lid in enumerate(self.layer_ids):
            h = (_per_position(h, pick(getattr(self, f"w{lid}")))
                 + pick(getattr(self, f"b{lid}")).to(dt))
            if j < len(self.layer_ids) - 1:
                h = gelu_tanh(h)
        if not self.add_residual:
            return h
        if self.needs_res_proj:
            return h + (_per_position(x, pick(self.w_res))
                        + pick(self.b_res).to(dt))
        return h + x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., t, in): position i's MLP on row i, t ≤ the context."""
        t = x.shape[-2]
        if t > self.context_width:
            raise ValueError(f"{t} positions, context is {self.context_width}")
        return self._mlp(x, lambda arr: arr[:t])

    def forward_at(self, x: torch.Tensor, positions) -> torch.Tensor:
        """x (..., t, in) at the global ``positions`` (t,): a host array
        (a contiguous run is a slice, with no index copied to the device)
        or an index tensor — the cached decode's rows."""
        if isinstance(positions, np.ndarray):
            start = int(positions[0])
            if np.array_equal(positions, start + np.arange(len(positions))):
                if start + len(positions) > self.context_width:
                    raise ValueError("positions past the context")
                return self._mlp(
                    x, lambda arr: arr[start:start + len(positions)])
            positions = torch.as_tensor(positions, device=x.device)
        return self._mlp(x, lambda arr: arr.index_select(0, positions))


class PeerLookupQueryUnit(nn.Module):
    """A bias-free scorer and its top-k (``lax.top_k``'s lowest-index
    ties, through ``models/sampling.py::topk``)."""

    def __init__(self, num_embed: int, emb_dim: int, topk: int, device=None):
        super().__init__()
        self.linear = Linear(emb_dim, num_embed, bias=False, device=device)
        self.topk = topk

    def forward(self, x: torch.Tensor):
        return tie_exact_topk(self.linear(x), self.topk)


class PeerLookup(nn.Module):
    """Product-key memory: left and right top-k scores summed over their
    Cartesian product and cut to k again (lowest-index ties: in bf16 the
    scores of 256 query units tie often, and another tie-break gathers
    other expert rows); the composite index gathers rows of the in and
    out tables; GELU(input · in-row) times the softmax of the scores
    weights the out-rows; plus a linear residual.  The composite index is
    the reference's ``left * topk + right`` (radix ``topk``, not the
    number of query units), a quirk kept on purpose."""

    def __init__(self, in_features: int, out_features: int, num_units: int,
                 topk: int, nhead: int = 1, query_dim: Optional[int] = None,
                 device=None):
        super().__init__()
        self.query_dim = query_dim or in_features // 2
        self.num_query_units = int(math.isqrt(num_units))
        if self.num_query_units ** 2 != num_units:
            raise ValueError(f"num_units must be a perfect square but "
                             f"{num_units} was not")
        self.nhead, self.in_features, self.topk = nhead, in_features, topk
        self.residual = Linear(in_features, out_features, False, device)
        self.query_linear = Linear(in_features, self.query_dim * nhead,
                                   False, device)
        self.key_linear = Linear(in_features, in_features * nhead, False,
                                 device)
        self.query_left = PeerLookupQueryUnit(self.num_query_units,
                                              self.query_dim, topk, device)
        self.query_right = PeerLookupQueryUnit(self.num_query_units,
                                               self.query_dim, topk, device)
        self.emb_in = Embedding(num_units, in_features, device)
        self.emb_out = Embedding(num_units, out_features, device)

    def expert_indices(self, x: torch.Tensor):
        """(softmax weights in x's dtype, composite indices) (b, s, h, k)
        of the queries x (b, s, h, query_dim)."""
        k = self.topk
        left_v, left_i = self.query_left(x)
        right_v, right_i = self.query_right(x)
        cross = (left_v[..., :, None] + right_v[..., None, :]).reshape(
            *x.shape[:-1], k * k)
        dot, idx = tie_exact_topk(cross, k)
        scores = torch.softmax(dot.float(), dim=-1).to(x.dtype)
        left = left_i.gather(-1, torch.div(idx, k, rounding_mode="floor"))
        right = right_i.gather(-1, idx % k)
        return scores, left * k + right

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        bs, s, _ = inp.shape
        dt = inp.dtype
        x = self.query_linear(inp).reshape(bs, s, self.nhead, self.query_dim)
        inp_proj = self.key_linear(inp).reshape(bs, s, self.nhead,
                                                self.in_features)
        residual = self.residual(inp)
        scores, final = self.expert_indices(x)
        inp_expert = self.emb_in(final).to(dt)        # (b, s, h, k, in)
        out_expert = self.emb_out(final).to(dt)       # (b, s, h, k, out)
        in_dot = torch.matmul(inp_expert, inp_proj[..., None])[..., 0]
        weight = scores * gelu_tanh(in_dot)           # (b, s, h, k)
        hk = self.nhead * self.topk
        out = torch.matmul(weight.reshape(bs, s, 1, hk),
                           out_expert.reshape(bs, s, hk, -1))[:, :, 0]
        return out + residual


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class CosineVectorEmbedding(nn.Module):
    """Frozen random projections of the unit input, binned on a uniform
    grid of [-1, 1] (``searchsorted``, left side, on the f32 grid), one
    table row per (projection, bin), the mean of the projections' rows
    (``EmbeddingBag(mode='mean')``).  The buffers ``projection_mat``
    (numpy ``PCG64(seed)`` normals, unit columns), ``grid`` and the unused
    ``pos_offset`` are the JAX package's, bit for bit."""

    def __init__(self, inp_dim: int, emb_dim: int, n_proj: int = 16,
                 num_bins: int = 20, seed: int = 0, device=None):
        super().__init__()
        gen = np.random.Generator(np.random.PCG64(seed=seed))
        proj = gen.standard_normal((inp_dim, n_proj)).astype(np.float32)
        proj = proj / np.linalg.norm(proj, axis=0, keepdims=True)
        resolution = 2.0 / num_bins
        grid = np.linspace(-1, 1, num_bins + 1)[:-1] + 0.5 * resolution
        pos_offset = ((num_bins + 1) * np.arange(n_proj, dtype=np.int64)
                      ).reshape(-1, 1, 1)
        for name, value in (("projection_mat", proj),
                            ("grid", grid.astype(np.float32)),
                            ("pos_offset", pos_offset)):
            self.register_buffer(name, torch.as_tensor(value, device=device))
        self.emb = Embedding((num_bins + 1) * n_proj, emb_dim, device)
        self.n_proj = n_proj

    def bins(self, x: torch.Tensor) -> torch.Tensor:
        """The table rows (b, s, n_proj) that x (b, s, d) selects."""
        z = torch.matmul(_unit_rows(x), self.projection_mat.to(x.dtype))
        bins = torch.searchsorted(self.grid.float(), z.float().contiguous())
        step = self.grid.shape[0] + 1
        return bins + torch.arange(self.n_proj, device=x.device) * step

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.emb(self.bins(x)).mean(dim=-2)


class CosineLinear(nn.Module):
    """Cosine similarity of the unit input and the unit weight rows."""

    def __init__(self, inp_dim: int, out_dim: int, device=None):
        super().__init__()
        new_param(self, "weight", (out_dim, inp_dim),
                  normal_init(std=1.0 / math.sqrt(inp_dim)), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _unit_rows(self.weight.to(x.dtype))
        return torch.matmul(_unit_rows(x), w.t())


class LearnableCosineVectorEmbedding(nn.Module):
    """Learnable LSH: Gaussian soft-binning of the cosine projections
    around learned centres (``mean``), optionally cut to the top ``top_k``
    bins, unit-normalised and mapped by a bias-free Linear."""

    def __init__(self, inp_dim: int, emb_dim: int, n_proj: int = 16,
                 num_bins: int = 20, sigma_inflation_factor: float = 1.0,
                 top_k: Optional[int] = None, device=None):
        super().__init__()
        self.n_proj, self.num_bins = n_proj, num_bins
        self.top_k = None if top_k is None else min(top_k, num_bins)
        self.sigma2 = (sigma_inflation_factor * 2.0 / num_bins) ** 2
        self.proj = CosineLinear(inp_dim, n_proj, device)
        new_param(self, "mean", (1, 1, n_proj, num_bins), uniform_init(1.0),
                  device)
        self.emb = Linear(n_proj * num_bins, emb_dim, bias=False,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, s, _ = x.shape
        z = self.proj(x)
        diff = z[..., None] - self.mean.to(z.dtype)
        act = torch.exp(-0.5 * diff * diff / self.sigma2)
        if self.top_k is not None:
            kth = tie_exact_topk(act, self.top_k)[0][..., -1:]
            act = torch.where(act < kth, torch.zeros_like(act), act)
        act = _unit_rows(act)
        return self.emb(act.reshape(bs, s, self.n_proj * self.num_bins))


class CompositeCosineVectorEmbedding(nn.Module):
    """The sum of LSH embeddings at several bin counts; the fixed ones'
    projections are seeded ``seed * 1000 + j``."""

    def __init__(self, inp_dim: int, emb_dim: int, num_bins: Tuple[int, ...],
                 n_proj: int, learnable: bool, seed: int = 0, device=None):
        super().__init__()
        self.emb = nn.ModuleList([
            LearnableCosineVectorEmbedding(inp_dim, emb_dim, n_proj, k,
                                           device=device) if learnable
            else CosineVectorEmbedding(inp_dim, emb_dim, n_proj, k,
                                       seed=seed * 1000 + j, device=device)
            for j, k in enumerate(num_bins)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, d) → (b, emb_dim)."""
        x = x[:, None, :]
        out = None
        for mod in self.emb:
            y = mod(x)
            out = y if out is None else out + y
        return out[:, 0, :]
