"""The offline slice on ``artifacts/quality2_ck.npz`` (the trained weights of
``training_configs/local/synthetic-quality2.yaml``), the port on the CPU
against the JAX package: logits (the f32 front and the ``_MLP`` dense
blocks), the dense block's cached decode against the full forward, greedy
tokens and the evaluate twin's greedy BLEU-4 and CIDEr-D against JAX's
``evaluate.py`` logic on a fixed image set (exact, ``--int8_serving`` and
``--approx_topk``), and checkpoints written by the port and read by
JAX.  f32 at ``jax.default_matmul_precision("highest")``."""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.eval.metrics import cider_d, corpus_bleu
from image2text_tpu.models.vision_encoder_decoder import (
    VisionEncoderDecoder as JaxModel)
from image2text_tpu.training.data import (SyntheticCompositeDataset,
                                          normalize_label)
from image2text_tpu.utils.checkpoint import (
    update_params_from_partial_checkpoint as jax_partial_restore)

from image2text_torch import evaluate as twin_eval
from image2text_torch.configs.reader import load_training_config
from image2text_torch.models.generation import decoder_step, prefill
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.ops.fused_frontend import (fused_frontend,
                                                 fused_frontend_plain)
from image2text_torch.utils.checkpoint import (
    load_jax_state_dict, load_state_dict, save_checkpoint,
    update_params_from_partial_checkpoint)
from image2text_torch.utils.patterns import PatternMatcher

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "training_configs/local/synthetic-quality2.yaml"
CK = REPO / "artifacts/quality2_ck.npz"
N_IMAGES = 8          # the fixed image set: the first val images
MAX_NEW = 64          # evaluate.py's default --max_new_tokens


@pytest.fixture(scope="module")
def q2():
    """(JAX model, its params, the port's CPU model, the val rows) on the
    checkpoint."""
    jcfg = JTrainingConfig.model_validate(yaml.safe_load(YAML.read_text()))
    jm = JaxModel(jcfg.model)
    params = jax_partial_restore(jm, jm.init(jax.random.PRNGKey(0)), str(CK))
    tm = VisionEncoderDecoder(load_training_config(YAML).model, device="cpu")
    load_jax_state_dict(tm, load_state_dict(str(CK)))
    # evaluate.py's val stream: build_inner_datasets' seed + 1, 5 x batch
    val = next(iter(SyntheticCompositeDataset(
        4000, 5 * jcfg.batch_size, image_size=64, vocab_size=1024,
        eos_token_id=0, seed=jcfg.seed + 1)))
    return jm, params, tm, val


def _ids(b, t, seed=0):
    return np.random.default_rng(seed).integers(3, 1024, (b, t))


def test_quality2_logits_match_jax(q2):
    """Full forward logits, within 1e-4 of the largest logit (f32 sums in
    another order through 4 blocks and the tied lm_head)."""
    jm, params, tm, val = q2
    images, ids = val["image"][:3], _ids(3, 24)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(params, jnp.asarray(images),
                             jnp.asarray(ids)).logits)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids)).logits
    assert got.shape == want.shape == (3, 24, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_quality2_front_matches_jax_module_chain(q2):
    """The f32 encoder front (``fused_frontend``'s CPU route) against the
    JAX encoder's module chain: projector → LayerNormND → + wpe →
    LayerNormND, CLS rows in front."""
    jm, params, tm, val = q2
    jenc, p = jm.encoder, params["encoder"]
    enc = tm.vision_encoder
    with torch.no_grad():
        feats = enc.feature_extractor(torch.from_numpy(val["image"][:2]))
        x = feats.reshape(2, enc.n_patches ** 2, enc.input_d)
        w = enc.frontend_weights(torch.float32)
        got = fused_frontend(x, w)
        assert torch.equal(got, fused_frontend_plain(x, w))
    xj = jnp.asarray(x.numpy())
    with jax.default_matmul_precision("highest"):
        z = jenc.ln_input(p["ln_input"], jenc.projector(p["projector"], xj))
        pos = jenc.transformer._children["wpe"](p["transformer"]["wpe"],
                                                jnp.arange(256))[None]
        chain = jnp.concatenate(
            [jnp.broadcast_to(p["cls_token"], (2, 8, 64)),
             jenc.ln_input(p["ln_input"], z + pos)], axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(chain), rtol=3e-5,
                               atol=3e-5)


def test_quality2_cached_decode_equals_full_forward(q2):
    """The dense blocks' cached decode (prefill of the prompt, then one
    token a step through the KV cache) gives the full forward's logits at
    every text position (JAX's test of the same: 2e-4)."""
    _, _, tm, val = q2
    images, ids = torch.from_numpy(val["image"][:2]), torch.from_numpy(
        _ids(2, 20, seed=1))
    with torch.no_grad():
        full = tm(images, ids).logits
        enc = tm.encoder(images)
        kv = tm.decoder.precompute_cross_kv(enc)
        logits, cache = prefill(tm, enc, ids[:, :5], ids.shape[1], kv)
        steps = [logits]
        for i in range(5, ids.shape[1]):
            logits, cache = decoder_step(tm, ids[:, i:i + 1], cache,
                                         tm.space_for_prompt + i, None, kv)
            steps.append(logits)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=0, atol=2e-4)


def test_quality2_greedy_tokens_and_evaluate_metrics_match_jax(q2):
    """The evaluate twin (greedy, one candidate an image, on the CPU) on the
    first N_IMAGES val images against JAX's evaluate.py logic: the same
    rows, labels and EOS cut, JAX's cached greedy generate (all the images
    in one call: greedy rows are independent), JAX's metrics.  Equal
    tokens, equal floats."""
    jm, params, _, val = q2
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jm.generate(
            params, jnp.asarray(val["image"][:N_IMAGES]), jnp.asarray([[1]]),
            max_new_tokens=MAX_NEW, temperature=0.0, top_k=16))
    cands = [twin_eval._strip(row[1:], 0) for row in out]
    refs = []
    for r in range(N_IMAGES):
        truths = []
        for c in range(5):
            lab = normalize_label(val[f"input_ids_{c}"][r:r + 1],
                                  val[f"attn_mask_{c}"][r:r + 1])[0]
            truths.append(twin_eval._strip(lab[lab != -100], 0))
        refs.append(truths)
    args = twin_eval.parse_args([
        "--config_file", str(YAML), "--chkpt_file", str(CK), "--num_images",
        str(N_IMAGES), "--num_candidates", "1", "--temperature", "0"])
    got = twin_eval.main(args, device="cpu")
    assert got["references"] == refs
    assert got["candidates"] == cands
    assert got["bleu"] == corpus_bleu(cands, refs) > 0.5
    assert got["cider"] == cider_d(cands, refs) > 1.0


def _jax_evaluate_greedy(q2, **generate_kw):
    """JAX's evaluate.py logic, greedy, on the first N_IMAGES val images:
    (candidates, references)."""
    jm, params, _, val = q2
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jax.jit(lambda p, i: jm.generate(
            p, i, jnp.asarray([[1]]), max_new_tokens=MAX_NEW,
            temperature=0.0, top_k=16, **generate_kw))(
                params, jnp.asarray(val["image"][:N_IMAGES])))
    refs = []
    for r in range(N_IMAGES):
        truths = []
        for c in range(5):
            lab = normalize_label(val[f"input_ids_{c}"][r:r + 1],
                                  val[f"attn_mask_{c}"][r:r + 1])[0]
            truths.append(twin_eval._strip(lab[lab != -100], 0))
        refs.append(truths)
    return [twin_eval._strip(row[1:], 0) for row in out], refs


def _twin(*flags):
    return twin_eval.main(twin_eval.parse_args([
        "--config_file", str(YAML), "--chkpt_file", str(CK), "--num_images",
        str(N_IMAGES), "--num_candidates", "1", *flags]), device="cpu")


def test_evaluate_twin_int8_serving_matches_jax(q2):
    """``--int8_serving`` (greedy): JAX's evaluate.py applies
    ``int8_serving_params`` to the decoder at its default min_elems
    (2^18) and decodes with int8 cross-KV.  At d 64 no weight of this
    checkpoint reaches 2^18 elements (the largest, wte, is 1,024 x 64), so
    the mode is int8 cross-KV alone in both packages; the twin's
    candidates, BLEU-4 and CIDEr-D equal JAX's."""
    jm, params, _, _ = q2
    from image2text_tpu.models.quantization import (
        int8_serving_params as jax_int8_serving_params)
    from image2text_tpu.utils.tree import flatten

    pq = dict(params)
    pq["decoder"] = jax_int8_serving_params(jm.decoder, params["decoder"])
    assert not any(k.endswith("qweight") for k in flatten(pq["decoder"]))
    cands, refs = _jax_evaluate_greedy((jm, pq, None, q2[3]),
                                       cross_kv_quant="int8")
    got = _twin("--temperature", "0", "--int8_serving")
    assert got["references"] == refs
    assert got["candidates"] == cands
    assert got["bleu"] == corpus_bleu(cands, refs) > 0.5
    assert got["cider"] == cider_d(cands, refs) > 1.0


def test_evaluate_twin_approx_topk_matches_jax(q2):
    """``--approx_topk``: greedy, the twin's candidates and metrics equal
    JAX's approx-mode ones (greedy never reads the flag in either
    package); sampled (temperature 1.0, top-k 16), the twin's run equals
    its own run without the flag, the same generator draws for both: the
    port takes the flag as exact."""
    cands, refs = _jax_evaluate_greedy(q2, approx_top_k=True)
    got = _twin("--temperature", "0", "--approx_topk")
    assert got["candidates"] == cands
    assert got["bleu"] == corpus_bleu(cands, refs) > 0.5
    assert got["cider"] == cider_d(cands, refs) > 1.0
    sampled = _twin("--approx_topk")
    assert sampled == _twin()


def test_port_checkpoint_loads_in_jax_with_the_same_logits(q2, tmp_path):
    """The port's ``save_checkpoint`` (perturbed weights) read by JAX's
    partial restore gives JAX the port's logits; a pattern-filtered save
    holds only the matched keys and the buffers, and the port's partial
    restore of it changes only those."""
    jm, params, tm, val = q2
    model = VisionEncoderDecoder(load_training_config(YAML).model,
                                 device="cpu")
    model.load_state_dict(tm.state_dict())
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    path = str(tmp_path / "port.npz")
    save_checkpoint(model, path)
    jparams = jax_partial_restore(jm, params, path)
    images, ids = val["image"][:2], _ids(2, 10, seed=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(jparams, jnp.asarray(images),
                             jnp.asarray(ids)).logits)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))

    part = str(tmp_path / "part.npz")
    matcher = PatternMatcher(["decoder.transformer.wte*", "*.ln_f.*"])
    save_checkpoint(model, part, [matcher])
    keys = set(load_state_dict(part))
    assert keys == {"decoder.transformer.wte.weight",
                    "decoder.transformer.ln_f.weight",
                    "decoder.transformer.ln_f.bias",
                    "encoder.transformer.ln_f.weight",
                    "encoder.transformer.ln_f.bias"}
    fresh = VisionEncoderDecoder(load_training_config(YAML).model,
                                 device="cpu")
    fresh.load_state_dict(tm.state_dict())
    update_params_from_partial_checkpoint(fresh, part)
    for name, p in fresh.named_parameters():
        src = model if matcher.match(name) else tm
        assert torch.equal(p, dict(src.named_parameters())[name]), name


def test_checkpoint_in_the_config_overrides_the_initialisation():
    cfg = load_training_config(YAML)
    cfg.model.chkpt_path = str(CK)
    model = VisionEncoderDecoder(cfg.model, device="cpu").init_weights(5)
    sd = load_state_dict(str(CK))
    assert torch.equal(model.decoder.transformer.wte.weight,
                       torch.from_numpy(sd["decoder.transformer.wte.weight"]))
