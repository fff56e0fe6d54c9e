"""Beam search's captured function on the CPU
(``BeamSearchTokenGenerator.cached_rounds`` through ``graphs.BeamBuffers``,
the function a capture records: every round of the window, the done flag
on the device) against the eager loop that reads the flag and stops
(``graphs=False``, JAX's early exit): ids, scores and the rounds taken
equal bit for bit, greedy, sampled from one generator seed, in int8
cross-KV, without an EOS id, and where every beam finishes early (the
logits pushed to EOS past a position by a hook on the decoder); and a
generator's state after two calls in a row the same on both routes (the
eager route draws the noise of the rounds it skipped).  The tiny
flagship and the tiny int4 + LoRA GPT-2-medium, one torch thread; the
JAX package's beam search is held to the eager loop in
``tests/test_torch_beam.py`` and ``tests/test_torch_hf_beam.py``.
Capture and replay need the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from image2text_torch.configs import models as tcm
from image2text_torch.models import graphs
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.hf_decoders import factory
from image2text_torch.models.quantization import fill_random_int4
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder

EOS = 0
NEW = 8      # 7 rounds
CASES = {
    "greedy": dict(temperature=0.0, consolidation_temperature=0.0),
    "sampled": dict(temperature=0.7, consolidation_temperature=1.0),
    "int8_kv": dict(temperature=0.7, consolidation_temperature=1.0,
                    cross_kv_quant="int8"),
    "no_eos": dict(temperature=0.7, consolidation_temperature=1.0,
                   eos_token_id=None),
}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flagship():
    return VisionEncoderDecoder(tcm.flagship_config(tiny=True),
                                device="cpu").init_weights(0).eval()


def _gpt2_medium():
    """The tiny int4 + LoRA GPT-2-medium captioner with weights that make
    every stage work (the initialisers leave the int4 weights and LoRA B
    zero)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.GPT2_TABLE, "gpt2-medium",
                   dict(n_layer=2, n_embd=128, n_head=4))
        model = VisionEncoderDecoder(tcm.gpt2_medium_config(tiny=True),
                                     device="cpu").init_weights(0)
    gen = torch.Generator().manual_seed(1)
    fill_random_int4(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".lora_B." in name:
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()


BUILDERS = {"flagship": _flagship, "gpt2-medium": _gpt2_medium}


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            built[name] = BUILDERS[name]()
        return built[name]
    return get


def _images(b=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 3, 64, 64)).astype(np.float32))


def _prompt(model, b=2):
    """The one-token prompt: GPT-2's <|endoftext|>, the flagship's 1."""
    hf = getattr(model.decoder, "prefix_in_decode", False)
    return torch.full((b, 1), 50256 if hf else 1, dtype=torch.long)


def _beam(model, **kw):
    args = dict(beam_width=3, beam_expansion_factor=4, top_k=16,
                max_new_tokens=NEW, eos_token_id=EOS,
                no_repeat_n_grams=(2, 3, 4, 5))
    return BeamSearchTokenGenerator(model, **(args | kw))


def _captured(model, beam, images, prompt, gen):
    """The captured function, eagerly, on one set of static buffers."""
    bufs = graphs.BeamBuffers(images, prompt, False, beam.settings())
    bufs.load(images, prompt)
    with torch.no_grad():
        out = bufs.run(model, gen)
    assert out[0] is bufs.ids
    return bufs.result()


def _eager(beam, images, prompt, gen):
    ids, scores = beam(images, prompt, generator=gen, graphs=False)
    return ids, scores, beam.rounds_taken


def _push_to_eos(model, after: int):
    """A hook that raises EOS's logit far above the rest at every decoder
    position from ``space_for_prompt + after`` on: every beam holds an
    EOS a few rounds in.  Returns the hook's handle."""
    def hook(module, args, kwargs, out):
        if kwargs.get("pos_offset", 0) < model.space_for_prompt + after:
            return out
        logits, hidden = out
        return logits.index_add(-1, torch.tensor([EOS]),
                                torch.full((*logits.shape[:-1], 1), 1e3)
                                ), hidden
    return model.decoder.register_forward_hook(hook, with_kwargs=True)


def _assert_same(got, want, rounds=None):
    ids, scores, taken = got
    assert torch.equal(ids, want[0]) and torch.equal(scores, want[1])
    assert int(taken) == int(want[2])
    if rounds is not None:
        assert int(taken) == rounds


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_captured_beam_function_equals_the_eager_loop(models, name, case):
    model = models(name)
    assert model.use_cross_attn      # the int8 case reads a cross memory
    beam = _beam(model, **CASES[case])
    images, prompt = _images(seed=3), _prompt(model)
    want = _eager(beam, images, prompt, torch.Generator().manual_seed(5))
    assert beam.rounds == NEW - 1 and tuple(want[0].shape) == (2, 3, NEW)
    got = _captured(model, beam, images, prompt,
                    torch.Generator().manual_seed(5))
    _assert_same(got, want, NEW - 1)


@pytest.mark.parametrize("case", ["greedy", "sampled"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_captured_beam_function_when_every_beam_finishes_early(models, name,
                                                               case):
    """The logits pushed to EOS from the fourth decode position on: every
    beam ends in EOS and the eager loop stops rounds before the window's
    end; the captured function runs them all, frozen, with the same ids
    (the tail EOS), scores and rounds taken.  Length boost 1.5: a round
    run past the stop would add its log to the scores."""
    model = models(name)
    beam = _beam(model, **CASES[case], length_boost=1.5)
    images, prompt = _images(seed=4), _prompt(model)
    handle = _push_to_eos(model, 4)
    try:
        want = _eager(beam, images, prompt, torch.Generator().manual_seed(6))
        got = _captured(model, beam, images, prompt,
                        torch.Generator().manual_seed(6))
    finally:
        handle.remove()
    assert beam.rounds < NEW - 1
    assert bool((want[0][:, :, -1] == EOS).all())
    _assert_same(got, want, beam.rounds)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_generator_state_after_two_calls_is_the_same_on_both_routes(models,
                                                                    name):
    """Sampled, every beam finishing early: two calls in a row from one
    generator on each route give the same ids and scores, and leave the
    two generators in the same state (the eager loop drew the noise of
    the rounds it skipped; without that the second calls would part)."""
    model = models(name)
    beam = _beam(model, **CASES["sampled"])
    prompt = _prompt(model)
    g_eager, g_graph = (torch.Generator().manual_seed(7) for _ in range(2))
    handle = _push_to_eos(model, 3)
    try:
        for seed in (8, 9):
            images = _images(seed=seed)
            want = _eager(beam, images, prompt, g_eager)
            assert beam.rounds < NEW - 1
            _assert_same(_captured(model, beam, images, prompt, g_graph),
                         want)
    finally:
        handle.remove()
    assert torch.equal(g_eager.get_state(), g_graph.get_state())
    assert torch.equal(torch.rand(4, generator=g_eager),
                       torch.rand(4, generator=g_graph))


def test_skipped_draws_are_one_rounds_draws():
    """``_skip_draws`` draws what a round draws: a generator that ran the
    eager loop through the whole window ends where one that stopped early
    and drew the skipped rounds ends (no EOS in the first, an early EOS
    in the second; the same shapes either way)."""
    model = _flagship()
    beam = _beam(model, **CASES["sampled"], eos_token_id=None)
    images, prompt = _images(seed=10), _prompt(model)
    full = torch.Generator().manual_seed(11)
    beam(images, prompt, generator=full)
    early = torch.Generator().manual_seed(11)
    handle = _push_to_eos(model, 2)
    try:
        stop = _beam(model, **CASES["sampled"])
        stop(images, prompt, generator=early)
    finally:
        handle.remove()
    assert stop.rounds < NEW - 1
    assert torch.equal(full.get_state(), early.get_state())


def test_gather_batch_reuses_its_twin():
    """The KV cache's beam gather writes into a kept second set of
    buffers: after the first gather no round allocates, and the rows are
    ``index_select``'s."""
    from image2text_torch.models.kv_cache import KVCache

    cache = KVCache.create([(6, 1, 5, 4), (6, 1, 3, 4)])
    for k, v in cache.layers:
        k.copy_(torch.randn(k.shape))
        v.copy_(torch.randn(v.shape))
    first = [(k.clone(), v.clone()) for k, v in cache.layers]
    order = torch.tensor([2, 0, 1, 5, 3, 3])
    cache.gather_batch(order)
    ptrs = {t.data_ptr() for kv in cache.layers for t in kv}
    for (k, v), (k0, v0) in zip(cache.layers, first):
        assert torch.equal(k, k0[order]) and torch.equal(v, v0[order])
    cache.gather_batch(order)
    cache.gather_batch(order)
    assert {t.data_ptr() for kv in cache.layers for t in kv} == ptrs
    for (k, v), (k0, v0) in zip(cache.layers, first):
        assert torch.equal(k, k0[order][order][order])
