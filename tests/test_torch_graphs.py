"""The graph route of the port's caption and beam-search calls
(``models/graphs.py``) on the CPU: the route plan as a table over the
families, branches, serving modes and both kinds of call; the key of a
captured call; the generator hand-off; and the captured function
(``generation.cached_call`` over one set of static buffers) run eagerly
twice in a row, each call's greedy tokens those of the JAX package's
``generate`` at the tiny flagship and its dense twin (f32, JAX at full
matmul precision, inputs from numpy seeds).  The beam function:
``tests/test_torch_beam_graph.py``.  Capture and replay themselves need
the card (``tests/test_torch_cuda.py``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch.configs import models as tcm
from image2text_torch.configs.reader import load_training_config
from image2text_torch.models import graphs
from image2text_torch.models.generation import generate
from image2text_torch.models.hf_decoders import factory
from image2text_torch.models.quantization import int8_serving_params
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.parallel.collectives import Axis
from image2text_torch.parallel.sharding_rules import place_params
from image2text_torch.utils.checkpoint import load_jax_state_dict

import torch_hf_pairs
import torch_nano_pairs

CUDA = torch.device("cuda")
CALL = dict(prompt_len=1, max_new_tokens=8)
BEAM = dict(beam=True)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's CPU products on one torch thread (restored after), so
    that their sums run in one order in every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flagship(edit=None):
    cfg = tcm.flagship_config(tiny=True)
    if edit is not None:
        edit(cfg)
    return VisionEncoderDecoder(cfg, device="cpu")


def _no_prefix(cfg):
    cfg.use_soft_prompting = False


def _bidirectional(cfg):
    cfg.decoder_config.transformer_config.is_causal = False


def _nano(name):
    with torch_nano_pairs.patched():
        cfg = torch_nano_pairs.cut(
            load_training_config(torch_nano_pairs.CONFIGS[name]), name)
        return VisionEncoderDecoder(cfg, device="cpu")


def _gpt2_medium():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.GPT2_TABLE, "gpt2-medium",
                   dict(n_layer=2, n_embd=128, n_head=4))
        return VisionEncoderDecoder(tcm.gpt2_medium_config(tiny=True),
                                    device="cpu")


def _hf(name):
    with torch_hf_pairs.patched():
        cfg = torch_hf_pairs.cut(
            load_training_config(torch_hf_pairs.CONFIGS[name]), name)
        return VisionEncoderDecoder(cfg, device="cpu")


def _split():
    model = _flagship()
    place_params(model, SimpleNamespace(model=Axis(None, 2, 0)))
    return model


def _w8a8():
    model = _flagship()
    int8_serving_params(model.decoder, min_elems=10000)
    assert model.decoder.transformer.wte.is_int8
    return model


BUILDERS = {
    "flagship": _flagship, "dense": lambda: VisionEncoderDecoder(
        tcm.flagship_dense_config(tiny=True), device="cpu"),
    "nano-mini": lambda: _nano("nano-mini"), "nano": lambda: _nano("nano"),
    "gpt2-medium": _gpt2_medium, "split": _split,
    **{name: (lambda name=name: _hf(name)) for name in (
        "falcon7b", "llama13b", "llama7b", "qwen", "gpt2xl")},
    "no-prefix": lambda: _flagship(_no_prefix),
    "bidirectional": lambda: _flagship(_bidirectional), "w8a8": _w8a8,
}

# (case, model, device, call, route, words of the reason)
PLAN = [
    ("flagship", "flagship", CUDA, {}, "graph", "scratch decoder"),
    ("dense", "dense", CUDA, {}, "graph", "scratch decoder"),
    ("nano-mini", "nano-mini", CUDA, {}, "graph", "scratch decoder"),
    # the HF decoders (prefix in the decode cache) since beam search and
    # they became graphs; each family's form
    ("gpt2-medium", "gpt2-medium", CUDA, {}, "graph", "HF decoder"),
    ("hf-falcon", "falcon7b", CUDA, {}, "graph", "HF decoder"),
    ("hf-llama13b", "llama13b", CUDA, {}, "graph", "HF decoder"),
    ("hf-llama7b", "llama7b", CUDA, {}, "graph", "HF decoder"),
    ("hf-qwen", "qwen", CUDA, {}, "graph", "HF decoder"),
    ("hf-gpt2xl", "gpt2xl", CUDA, {}, "graph", "HF decoder"),
    ("nano", "nano", CUDA, {}, "eager", "multi-head"),
    ("model-split", "split", CUDA, {}, "eager", "model split"),
    ("fallback-window", "no-prefix", CUDA, {}, "eager", "bypass rule"),
    ("force-no-cache", "flagship", CUDA, dict(force_no_cache=True), "eager",
     "force_no_cache"),
    ("bidirectional", "bidirectional", CUDA, {}, "eager", "bidirectional"),
    ("cpu", "flagship", torch.device("cpu"), {}, "eager", "CPU"),
    ("graphs-false", "flagship", CUDA, dict(graphs=False), "eager",
     "graphs=False"),
    # the serving modes: int8 cross-KV and approximate top-k are the
    # call's settings (the plan routes them as exact); W8A8 is the model's
    # int8 form, alone and under "all"
    ("mode-exact", "flagship", CUDA, {}, "graph", "scratch decoder"),
    ("mode-int8_kv", "flagship", CUDA, {}, "graph", "scratch decoder"),
    ("mode-approx", "flagship", CUDA, {}, "graph", "scratch decoder"),
    ("mode-w8a8", "w8a8", CUDA, {}, "graph", "scratch decoder"),
    ("mode-all", "w8a8", CUDA, {}, "graph", "scratch decoder"),
    # beam search: the same tests in the same order, its window one id
    # shorter; its serving modes (exact, int8 cross-KV, W8A8 + int8
    # cross-KV) as the sampler's
    ("beam-flagship", "flagship", CUDA, BEAM, "graph", "scratch decoder"),
    ("beam-dense", "dense", CUDA, BEAM, "graph", "scratch decoder"),
    ("beam-nano-mini", "nano-mini", CUDA, BEAM, "graph", "scratch decoder"),
    ("beam-w8a8", "w8a8", CUDA, BEAM, "graph", "scratch decoder"),
    ("beam-gpt2-medium", "gpt2-medium", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-falcon", "falcon7b", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-llama13b", "llama13b", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-llama7b", "llama7b", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-qwen", "qwen", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-gpt2xl", "gpt2xl", CUDA, BEAM, "graph", "HF decoder"),
    ("beam-nano", "nano", CUDA, BEAM, "eager", "multi-head"),
    ("beam-model-split", "split", CUDA, BEAM, "eager", "model split"),
    ("beam-fallback-window", "no-prefix", CUDA, BEAM, "eager",
     "bypass rule"),
    ("beam-bidirectional", "bidirectional", CUDA, BEAM, "eager",
     "bidirectional"),
    ("beam-cpu", "flagship", torch.device("cpu"), BEAM, "eager", "CPU"),
    ("beam-graphs-false", "flagship", CUDA, dict(BEAM, graphs=False),
     "eager", "graphs=False"),
]


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            built[name] = BUILDERS[name]()
        return built[name]
    return get


@pytest.mark.parametrize("case,name,device,call,route,why", PLAN,
                         ids=[p[0] for p in PLAN])
def test_graph_plan(models, case, name, device, call, route, why):
    got, reason = graphs.graph_plan(models(name), device, **CALL, **call)
    assert got == route, (case, reason)
    assert why in reason


def test_fallback_window_is_the_plans_only_difference():
    """The no-prefix flagship's window crosses the bypass rule at 8 new
    tokens, not at 2: the plan follows ``cache_exact_for_window``."""
    model = _flagship(_no_prefix)
    assert graphs.graph_plan(model, CUDA, prompt_len=1,
                             max_new_tokens=2)[0] == "graph"
    assert graphs.graph_plan(model, CUDA, **CALL)[0] == "eager"


def _key(model, b=2, step=None, quant=None, gen=None):
    x = torch.zeros(b, 3, 64, 64)
    prompt = torch.ones(b, 1, dtype=torch.long)
    step = dict(dict(generator=gen, temperature=0.7, top_k=16,
                     nucleus_p=None, approx_top_k=False), **(step or {}))
    return graphs.graph_key(model, x, False, prompt, 9, step, quant)


def test_key_changes_with_weights_batch_and_mode_only():
    model = _flagship().init_weights(0).eval()
    key = _key(model)
    assert _key(model) == key
    assert _key(model, gen=torch.Generator().manual_seed(3)) == key
    img = torch.from_numpy(_images(seed=3))
    generate(model, img, torch.ones(2, 1, dtype=torch.long),
             max_new_tokens=8, temperature=0.7, top_k=16,
             generator=torch.Generator().manual_seed(0))
    assert _key(model) == key          # a call writes no weight
    assert _key(model, b=4) != key
    assert _key(model, quant="int8") != key
    assert _key(model, step=dict(approx_top_k=True)) != key
    assert _key(model, step=dict(temperature=0.0)) != key
    with torch.no_grad():
        model.decoder.transformer.ln_f.weight.mul_(1.0)
    moved = _key(model)
    assert moved != key and moved[:-1] == key[:-1]


def test_held_graphs_follow_the_weights_tensors():
    """A model's graphs stay only while its weights are the same tensors,
    unwritten: an in-place write or a replaced tensor drops them."""
    model = _flagship().init_weights(0)
    sig = graphs.weights_signature(model)
    held = graphs._Held(model, sig)
    assert held.holds(model, graphs.weights_signature(model))
    with torch.no_grad():
        model.decoder.transformer.ln_f.bias.add_(0.0)
    assert not held.holds(model, graphs.weights_signature(model))
    held = graphs._Held(model, graphs.weights_signature(model))
    model.decoder.transformer.ln_f.bias = torch.nn.Parameter(
        model.decoder.transformer.ln_f.bias.detach().clone())
    assert not held.holds(model, graphs.weights_signature(model))


def test_held_calls_are_bounded_least_recently_used_out():
    model = _flagship()
    held = graphs._Held(model, graphs.weights_signature(model))
    for k in range(graphs.MAX_GRAPHS):
        held.add(k, f"call {k}")
    assert held.get(0) == "call 0"      # now the most recently used
    held.add("new", "call new")
    assert len(held.calls) == graphs.MAX_GRAPHS
    assert held.get(1) is None and held.get(0) == "call 0"
    assert held.get("new") == "call new"


def test_cached_operands_are_every_value_the_call_left_cached():
    """What a capture holds: after a call, every ``_Cached`` value of the
    model (the front's, each block's, each MoE FFN's packed operands) and
    the sparse blocks' row tensors, the objects themselves."""
    from image2text_torch.models.layers import _Cached

    model = _flagship().init_weights(0).eval()
    assert graphs.cached_operands(model) == []
    generate(model, torch.from_numpy(_images(seed=4)),
             torch.ones(2, 1, dtype=torch.long), max_new_tokens=4,
             temperature=0.0)
    values = [v._value for m in model.modules() for v in vars(m).values()
              if isinstance(v, _Cached) and v._value is not None]
    rows = [t for m in model.modules() for t in
            getattr(m, "_rows", {}).values()]
    assert values and rows
    got = graphs.cached_operands(model)
    assert len(got) == len(values) + len(rows)
    assert all(any(g is v for g in got) for v in values + rows)


def test_generator_hand_off_draws_the_callers_stream():
    own = torch.Generator()
    caller = torch.Generator().manual_seed(11)
    direct = torch.Generator().manual_seed(11)
    with graphs.handed_over(own, caller) as g:
        got = torch.rand(5, 7, generator=g)
    assert torch.equal(got, torch.rand(5, 7, generator=direct))
    assert torch.equal(torch.rand(3, generator=caller),
                       torch.rand(3, generator=direct))


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32)


def _pair(dense):
    jcfg = _flagship_config(tiny=True).model
    if dense:
        jcfg.vision_encoder_config.transformer_config.is_sparse_attn = False
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = VisionEncoderDecoder(
        (tcm.flagship_dense_config if dense else tcm.flagship_config)(
            tiny=True), device="cpu")
    load_jax_state_dict(tm, export_state_dict(jm, params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("dense", [False, True], ids=["flagship", "dense"])
def test_captured_function_twice_through_one_set_of_buffers(dense):
    """``CallBuffers.run`` (the function a capture records) twice in a row
    on other images through the same buffers: greedy, n-grams 2–5, 8 new
    tokens, each call JAX ``generate``'s ids exactly (state left over
    from the first call would part them)."""
    jm, params, tm = _pair(dense)
    imgs = [_images(seed=s) for s in (20, 21)]
    prompt = np.ones((2, 1), np.int32)
    with jax.default_matmul_precision("highest"):
        both = np.asarray(jax.jit(lambda p, i, d: jm.generate(
            p, i, d, max_new_tokens=8, temperature=0.0,
            rng=jax.random.PRNGKey(0)))(params, jnp.asarray(np.concatenate(
                imgs)), jnp.asarray(np.concatenate([prompt, prompt]))))
    tprompt = torch.from_numpy(prompt).long()
    step = dict(generator=None, temperature=0.0, top_k=None, nucleus_p=None,
                approx_top_k=False)
    bufs = graphs.CallBuffers(torch.from_numpy(imgs[0]), tprompt, 9, False,
                              step, None)
    for i, img in enumerate(imgs):
        bufs.load(torch.from_numpy(img), tprompt)
        with torch.no_grad():
            out = bufs.run(tm, None)
        assert out is bufs.ids and out.shape == (2, 9)
        np.testing.assert_array_equal(out.numpy(), both[2 * i:2 * i + 2])
    # the eager route of generate agrees on the CPU, where the plan sends
    # every call
    again = generate(tm, torch.from_numpy(imgs[1]), tprompt,
                     max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(again.numpy(), both[2:])

