"""The port's beam search against the JAX package's on the tiny HF forms
(``tests/torch_hf_pairs.py``: shared weights, f32 on the CPU, JAX at full
matmul precision): greedy (width 3, expansion 4, top-k 16, n-grams 2–5,
consolidation 0) on the int4 + LoRA GPT-2-xl, Llama-2-13B and Falcon-7B
forms and the f32 Llama-2-7B one, ids equal and scores within 1e-4; and
sampled (temperature 0.7, consolidation 1.0) on the Llama-2-13B form with
JAX's noise fed to the port, round by round in JAX's order (each round's
key split in three: the candidates' Gumbel noise over the top-k head, then
the consolidation's).  Qwen-2: ``tests/test_torch_hf_models.py``; the
tiny int4 + LoRA GPT-2-medium: ``tests/test_torch_beam.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image2text_tpu.models.generation_utils import (
    BeamSearchTokenGenerator as JaxBeam)

from image2text_torch.models import sampling as ts
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator

from torch_hf_pairs import BOS, build_pair, images

NEW = 6      # 5 rounds
BEAM = dict(beam_width=3, beam_expansion_factor=4, top_k=16,
            no_repeat_n_grams=(2, 3, 4, 5), max_new_tokens=NEW)
GREEDY = dict(BEAM, temperature=0.0, consolidation_temperature=0.0)
SAMPLED = dict(BEAM, temperature=0.7, consolidation_temperature=1.0)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_beam(jm, params, img, prompt, kw, seed=0):
    gen = JaxBeam(jm, **kw)
    with jax.default_matmul_precision("highest"):
        ids, sc = jax.jit(lambda p, i, d: gen(
            p, i, d, rng=jax.random.PRNGKey(seed)))(
                params, jnp.asarray(img), jnp.asarray(prompt))
    return np.asarray(ids), np.asarray(sc)


@pytest.mark.parametrize("name", ["gpt2xl", "llama13b", "llama7b",
                                  "falcon7b"])
def test_greedy_beam_search_matches_jax_hf(name):
    jm, params, _, tm = build_pair(name)
    img = images(name, seed=22)
    prompt = np.full((2, 1), BOS[name], np.int32)
    jids, jsc = _jax_beam(jm, params, img, prompt, GREEDY)
    ids, sc = BeamSearchTokenGenerator(tm, **GREEDY)(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    assert tuple(ids.shape) == (2, 3, NEW)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(sc.numpy(), jsc, atol=1e-4, rtol=0)


def _jax_noise(seed: int, rounds: int, rows: int, k: int, bs: int,
               width: int) -> list:
    """The Gumbel noise JAX's beam search draws, in its order: per round
    ``rng, k_samp, k_cons = split(rng, 3)``, the candidates' noise
    (rows, k) from ``k_samp``, the consolidation's (bs, width) from
    ``k_cons``."""
    rng, noise = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        rng, k_samp, k_cons = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.gumbel(k_samp, (rows, k),
                                                  jnp.float32)))
        noise.append(np.asarray(jax.random.gumbel(k_cons, (bs, width),
                                                  jnp.float32)))
    return noise


def test_sampled_beam_search_on_jax_noise_matches_jax_llama(monkeypatch):
    """Stochastic candidates and consolidation on the int4 + LoRA
    Llama-2-13B form, the port's every noise draw replaced by JAX's
    (shape-checked, all of them used): ids equal, scores within 1e-4."""
    name = "llama13b"
    jm, params, _, tm = build_pair(name)
    img = images(name, seed=23)
    bs, bw, bef = 2, BEAM["beam_width"], BEAM["beam_expansion_factor"]
    prompt = np.full((bs, 1), BOS[name], np.int32)
    jids, jsc = _jax_beam(jm, params, img, prompt, SAMPLED, seed=4)
    noise = _jax_noise(4, NEW - 1, bw * bs, BEAM["top_k"], bs, bw * bef)
    fed = iter(noise)

    def jax_gumbel(shape, generator, device):
        g = next(fed)
        assert tuple(shape) == g.shape
        return torch.from_numpy(np.array(g)).to(device)

    monkeypatch.setattr(ts, "gumbel_noise", jax_gumbel)
    ids, sc = BeamSearchTokenGenerator(tm, **SAMPLED)(
        torch.from_numpy(img), torch.from_numpy(prompt).long())
    assert next(fed, None) is None
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(sc.numpy(), jsc, atol=1e-4, rtol=0)
