"""The caption call as one captured CUDA graph: the port's counterpart of
the ``jax.jit`` around ``generate`` (``bench.py:243-273``; the decode a
``lax.fori_loop``, ``image2text_tpu/models/generation.py:199-217``).

:func:`graph_plan` chooses the route of a ``generate`` call from the
model's structure, before any work: the graph route on the card for a
one-device scratch ``TransformerDecoder`` of multi-query blocks on the
cached branch (the flagship, its dense twin, nano-mini; every serving
mode: int8 cross-KV, approximate top-k, the W8A8 weights), the eager
route everywhere else (the CPU, where the plain versions run; a model
split; the full-reforward fallback; a bidirectional decoder; the HF
decoders and the multi-head nano decoders, later slices).  Nothing turns
a failed capture or replay into the eager route: it raises.

:func:`graphed_call` captures ``generation.cached_call`` (encoder, cross
K/V, prefill, then 32 rounds of sample, write, decoder step) once per
:func:`graph_key` and replays it after:

* **key**: the call's shapes, dtype, device and sampling settings, and
  the ``(data_ptr, _version)`` of every parameter and buffer of the
  model (``models/layers.py::_Cached``'s test).  A graph replays the
  packed operands the warm-up cached, so a weight written in place, or
  a tensor replaced, captures anew; the graphs of older weights are
  dropped, and their tensors are held until then, so no freed address
  can alias a key.  Each graph also holds the derived tensors its
  warm-up left in the model's caches (:func:`cached_operands`): a cache
  that rebuilds its value for another call cannot free what a graph
  reads.
* **static buffers**: the input (images or encoder output), the prompt
  and the ids; a replay copies the caller's inputs in and returns a copy
  of the ids.  The KV cache and every intermediate live in the graph's
  pool; the cache's Python fill indices advance during the capture only,
  and a replay zeroes the id buffer and writes every slot it reads (the
  cache's bias masks the others).
* **memory**: a model's graphs share one pool: each leaves nothing alive
  in it when its capture ends (its outputs are the static buffers,
  allocated outside), and every capture and replay runs on one stream a
  device, one at a time, so one graph's intermediates may reuse
  another's blocks.  The pool then holds about the largest call's
  intermediates, not their sum; a model holds at most
  :data:`MAX_GRAPHS` graphs, the least recently used dropped first.
* **generator**: the graph draws from its own generator, registered with
  the graph (``CUDAGraph.register_generator_state``).  Before a replay
  it takes the caller's state (the caller's generator, or the card's
  default one), after it the caller takes its advanced state
  (:func:`handed_over`): a run of calls draws what the eager route draws.
* **the first call of a key** runs ``cached_call`` eagerly on the capture
  stream, with the caller's generator (it builds the kernels, fills the
  ``_Cached`` operands, the index tensors and the cuDNN and cuBLAS plans),
  then captures; it returns the eager ids, which a replay from the same
  generator state reproduces bit for bit.
* **launch counts**: each counted wrapper's increments over the capture
  are recorded and taken back, and added at every replay; a capturing
  call counts as one call (its eager run).

What capture allows was checked for each host call the path makes:
``cudaFuncSetAttribute`` before a launch is a host-side attribute set
that capture permits; ``cudaOccupancyMaxActiveClusters`` runs once, at
the warm-up (``ops/fused_frontend.py::resident_clusters`` is cached);
the GEMM's TMA descriptors (``csrc/gemm.cuh``) are encoded on the host
and passed by value, so the graph keeps the addresses of the static
buffers, the weights and its pool, which stay put while it lives; the
static gathers' index tensors are cached on the device
(``ops/static_gather.py``), as ``layout_rows`` caches the sparse blocks';
the positional MLP's index copy (``models/layers.py``'s ``forward_at``)
runs only for positions that are not a contiguous run, which no cached
forward passes.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import OrderedDict
from typing import List, Optional, Tuple

import torch

from image2text_torch.models.decoder import TransformerDecoder
from image2text_torch.models.generation import cached_call
from image2text_torch.models.layers import MultiQueryAttention, _Cached
from image2text_torch.nn.modules import model_axis
from image2text_torch.ops import flash_attention as fa
from image2text_torch.ops.functions import int8_mm
from image2text_torch.ops.fused_block import fused_block, sparse_block
from image2text_torch.ops.fused_frontend import fused_frontend
from image2text_torch.ops.fused_moe import moe_ffn
from image2text_torch.ops.int4_matmul import int4_matmul
from image2text_torch.ops.topk_mask import topk_ban_mask

GRAPH, EAGER = "graph", "eager"
MAX_GRAPHS = 8      # captured calls a model holds, least recently used out


def graph_plan(model, device, *, prompt_len: int, max_new_tokens: int,
               graphs: bool = True,
               force_no_cache: bool = False) -> Tuple[str, str]:
    """(route, reason) of a ``generate`` call on ``device``: ``"graph"``
    or ``"eager"``, from the model's structure and the call's branch."""
    if not graphs:
        return EAGER, "graphs=False: the eager route, asked for"
    if torch.device(device).type != "cuda":
        return EAGER, "a CPU call: the plain versions, run eagerly"
    if model_axis(model) is not None:
        return EAGER, "a model split: the mesh's route is a later slice"
    dec = model.decoder
    if type(dec) is not TransformerDecoder:
        return EAGER, (f"{type(dec).__name__}: the HF decoders' route is a "
                       f"later slice")
    if not dec.is_causal:
        return EAGER, ("a bidirectional decoder: its branch re-forwards a "
                       "growing sequence")
    if force_no_cache:
        return EAGER, "force_no_cache: the full-reforward fallback"
    off = model.space_for_prompt
    if not dec.cache_exact_for_window(off + prompt_len,
                                      off + prompt_len + max_new_tokens):
        return EAGER, ("a sparse layer's bypass rule flips inside the "
                       "window: the full-reforward fallback")
    if not all(isinstance(blk.attn, MultiQueryAttention)
               for blk in dec.blocks):
        return EAGER, ("multi-head attention blocks (the nano decoders): a "
                       "later slice")
    return GRAPH, "a one-device scratch decoder on the cached branch"


def counted_wrappers() -> tuple:
    """Every wrapper of the port that counts its launches (``launches``):
    the kernels' and the W8A8 product's."""
    return (sparse_block, moe_ffn, fa.flash_fwd, fa.flash_bwd, int4_matmul,
            fused_frontend, fused_block, topk_ban_mask, int8_mm)


def weights_signature(model) -> tuple:
    """``(data_ptr, _version)`` of every parameter and buffer of
    ``model``: it changes with a tensor's storage and with an in-place
    write."""
    return tuple((t.data_ptr(), t._version)
                 for t in (*model.parameters(), *model.buffers()))


def cached_operands(model) -> list:
    """The derived tensors the model's caches hold now: every ``_Cached``
    value (the eval kernels' packed operands) and the sparse blocks' row
    index tensors (``layout_rows``)."""
    held = []
    for mod in model.modules():
        for name, value in vars(mod).items():
            if isinstance(value, _Cached) and value._value is not None:
                held.append(value._value)
            elif name == "_rows":
                held.extend(value.values())
    return held


def graph_key(model, x: torch.Tensor, from_encoder: bool,
              prompt_ids: torch.Tensor, total: int, step: dict,
              cross_kv_quant: Optional[str]) -> tuple:
    """The key of a captured call: the input's (images, or the encoder
    output when ``from_encoder``) shape, strides, dtype and device, the
    prompt's shape, ``total`` ids a row, the sampling settings (``step``
    without its generator), the cross-KV mode and
    :func:`weights_signature`."""
    settings = tuple(sorted((k, v) for k, v in step.items()
                            if k != "generator"))
    return (from_encoder, tuple(x.shape), x.stride(), x.dtype,
            str(x.device), tuple(prompt_ids.shape), total, settings,
            cross_kv_quant, weights_signature(model))


@contextlib.contextmanager
def handed_over(own: torch.Generator, caller: torch.Generator):
    """Draws from ``own`` inside the block continue ``caller``'s stream:
    ``own`` takes ``caller``'s state on entry, ``caller`` takes ``own``'s
    on exit."""
    own.set_state(caller.get_state())
    yield own
    caller.set_state(own.get_state())


class CallBuffers:
    """The static buffers of a captured call (input, prompt, ids) and the
    captured function over them: ``generation.cached_call`` with the
    call's sampling settings and cross-KV mode."""

    def __init__(self, x: torch.Tensor, prompt_ids: torch.Tensor,
                 total: int, from_encoder: bool, step: dict,
                 cross_kv_quant: Optional[str]):
        dev = x.device
        # the input's own layout (the preprocessed frames are channels
        # last): the encoder's convolution then runs as the eager call's
        self.x = torch.empty_like(x)
        self.prompt = torch.empty(prompt_ids.shape, dtype=torch.long,
                                  device=dev)
        self.ids = torch.empty((x.shape[0], total), dtype=torch.long,
                               device=dev)
        self.from_encoder = from_encoder
        self.step = {k: v for k, v in step.items() if k != "generator"}
        self.cross_kv_quant = cross_kv_quant

    def load(self, x: torch.Tensor, prompt_ids: torch.Tensor) -> None:
        """Copy a call's input and prompt into the static buffers."""
        self.x.copy_(x)
        self.prompt.copy_(prompt_ids)

    def run(self, model, generator) -> torch.Tensor:
        """The captured function, eagerly: the ids buffer, written."""
        x = None if self.from_encoder else self.x
        enc = self.x if self.from_encoder else None
        return cached_call(model, x, enc, self.prompt, self.ids,
                           dict(self.step, generator=generator),
                           self.cross_kv_quant)


class GraphedCall(CallBuffers):
    """A captured caption call: its buffers, the graph, the generator the
    graph draws from, the cached operands it reads, and each counted
    wrapper's launches in one call."""

    def __init__(self, *args):
        super().__init__(*args)
        self.own = torch.Generator(device=self.x.device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.own)
        self.launches: List[Tuple[object, int]] = []
        self.operands: list = []

    def capture(self, model, caller: torch.Generator, pool) -> torch.Tensor:
        """Warm up eagerly with ``caller``'s draws, then capture into
        ``pool`` with the graph's own generator; returns the warm-up's
        ids."""
        dev = self.x.device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.run(model, caller)
        self.operands = cached_operands(model)
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.run(model, self.own)
        self.launches = [(w, w.launches - n)
                         for w, n in zip(wrappers, before)]
        for w, n in zip(wrappers, before):
            w.launches = n
        torch.cuda.current_stream(dev).wait_stream(stream)
        return self.ids.clone()

    def replay(self, caller: torch.Generator) -> torch.Tensor:
        """One replay on the capture stream, drawing from ``caller``'s
        stream; a copy of the ids."""
        dev = self.x.device
        stream, current = _capture_stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), handed_over(self.own, caller):
            self.graph.replay()
        current.wait_stream(stream)
        for w, n in self.launches:
            w.launches += n
        return self.ids.clone()


class _Held:
    """A model's graphs under one set of weights, holding those tensors
    (and their storages) so that no freed address can alias the key, and
    the pool the graphs share; at most :data:`MAX_GRAPHS` calls, the least
    recently used dropped first."""

    def __init__(self, model, signature: tuple, pool=None):
        self.tensors = [(t, t.untyped_storage())
                        for t in (*model.parameters(), *model.buffers())]
        self.signature = signature
        self.pool = pool
        self.calls: "OrderedDict[tuple, GraphedCall]" = OrderedDict()

    def holds(self, model, signature: tuple) -> bool:
        ts = (*model.parameters(), *model.buffers())
        return (signature == self.signature
                and all(a is b for a, (b, _) in zip(ts, self.tensors)))

    def get(self, key: tuple) -> Optional[GraphedCall]:
        call = self.calls.get(key)
        if call is not None:
            self.calls.move_to_end(key)
        return call

    def add(self, key: tuple, call) -> None:
        self.calls[key] = call
        while len(self.calls) > MAX_GRAPHS:
            self.calls.popitem(last=False)


# held beside each model, not on it: a deep copy of a model (the W8A8
# serving form is one) must not copy its graphs
_HELD: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STREAMS: dict = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    s = _STREAMS.get(str(dev))
    if s is None:
        s = _STREAMS[str(dev)] = torch.cuda.Stream(device=dev)
    return s


def held_graphs(model) -> int:
    """How many captured calls ``model`` holds."""
    held = _HELD.get(model)
    return 0 if held is None else len(held.calls)


def release(model) -> None:
    """Drop ``model``'s captured calls (their pool returns to the
    allocator's cache)."""
    _HELD.pop(model, None)


def graphed_call(model, images: Optional[torch.Tensor],
                 encoder_output: Optional[torch.Tensor],
                 prompt_ids: torch.Tensor, total: int, step: dict,
                 cross_kv_quant: Optional[str]) -> torch.Tensor:
    """``generate``'s graph route: the ids (B, total) of
    ``generation.cached_call``, replayed from the captured call of its
    key, captured first where there is none."""
    dev = model.device
    from_encoder = encoder_output is not None
    x = (encoder_output if from_encoder else images).to(dev)
    prompt_ids = prompt_ids.expand(x.shape[0], prompt_ids.shape[-1])
    caller = step["generator"]
    if caller is None:
        caller = torch.cuda.default_generators[dev.index]
    key = graph_key(model, x, from_encoder, prompt_ids, total, step,
                    cross_kv_quant)
    held = _HELD.get(model)
    if held is None or not held.holds(model, key[-1]):
        held = _HELD[model] = _Held(model, key[-1],
                                    torch.cuda.graph_pool_handle())
    call = held.get(key)
    if call is None:
        call = GraphedCall(x, prompt_ids, total, from_encoder, step,
                           cross_kv_quant)
        call.load(x, prompt_ids)
        ids = call.capture(model, caller, held.pool)
        held.add(key, call)
        return ids
    call.load(x, prompt_ids)
    return call.replay(caller)
