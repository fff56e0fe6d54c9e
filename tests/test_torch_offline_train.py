"""The offline slice's training on the CPU: one step of
``training_configs/local/synthetic-smoke.yaml``'s model against the JAX
package's step (loss within 1e-2, gradients within 2e-2, the slice's
tolerances), train-state resume (2 + 2 steps equal 4 straight ones, bit
for bit), and the trainer twin's ``main`` end to end: training,
checkpoint, resume, then the evaluate twin on its checkpoint."""
import copy
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from image2text_tpu.configs.trainer import TrainingConfig as JTrainingConfig
from image2text_tpu.training.loop import _value_and_grad_float
from image2text_tpu.training.wrapper import (
    ModelTrainerWrapper as JaxWrapper, TokenizerInfo as JaxTok)
from image2text_tpu.utils.checkpoint import export_state_dict

from image2text_torch import evaluate as twin_eval
from image2text_torch import trainer as twin
from image2text_torch.configs.reader import load_training_config
from image2text_torch.training.loop import Trainer
from image2text_torch.training.wrapper import ModelTrainerWrapper, TokenizerInfo
from image2text_torch.utils.checkpoint import (load_jax_state_dict,
                                               load_state_dict,
                                               state_dict_numpy)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
SMOKE = REPO / "training_configs/local/synthetic-smoke.yaml"


def _tok(cls):
    return cls(eos_token_id=0, bos_token_id=1, mask_token_id=2,
               vocab_size=1024)


def _batches(cfg, n, batch):
    """``n`` training batches of ``batch`` rows from the config's stream."""
    cfg = copy.deepcopy(cfg)
    cfg.batch_size = batch
    train_dl, _ = twin.build_dataloaders(cfg, twin.config_tokenizer(cfg))
    it = iter(train_dl)
    return [next(it) for _ in range(n)]


def test_one_training_step_matches_jax():
    """Dropout and mask corruption off (the two packages draw them from
    different generators); f32, as the config's precision 'no'."""
    raw = yaml.safe_load(SMOKE.read_text())
    jcfg = JTrainingConfig.model_validate(raw)
    tcfg = load_training_config(SMOKE)
    for cfg in (jcfg, tcfg):
        for sub in (cfg.model.vision_encoder_config,
                    cfg.model.decoder_config):
            a = sub.transformer_config.attn_config
            a.dropout = a.attn_dropout = 0.0
        cfg.trainer.mask_fraction = cfg.trainer.random_mask_fraction = 0.0
    jw = JaxWrapper(jcfg.model, _tok(JaxTok), jcfg.trainer)
    params = jw.init(jax.random.PRNGKey(0))
    tw = ModelTrainerWrapper(tcfg.model, _tok(TokenizerInfo), tcfg.trainer,
                             device="cpu")
    load_jax_state_dict(tw.model, export_state_dict(jw.model, params["model"]))
    (images, labels), = _batches(tcfg, 1, 2)
    with jax.default_matmul_precision("highest"):
        (loss, _), grads = jax.jit(_value_and_grad_float(
            lambda p: jw.train_step(p, jnp.asarray(images),
                                    jnp.asarray(labels),
                                    jax.random.PRNGKey(1))))(params)
    want = export_state_dict(jw.model, grads["model"])
    trainer = Trainer(tcfg, tw)
    metrics = trainer._train_step(torch.from_numpy(images),
                                  torch.from_numpy(labels), 0, 0)
    assert abs(float(metrics["train_loss_lm"]) - float(loss)) <= 1e-2 * abs(
        float(loss))
    got = state_dict_numpy(tw.model, grads=True)
    num = sum(float(np.square(got[k] - want[k]).sum()) for k in got)
    den = sum(float(np.square(want[k]).sum()) for k in got)
    assert math.sqrt(num / den) <= 2e-2
    for k, g in got.items():
        scale = float(np.abs(want[k]).max()) or 1.0
        np.testing.assert_allclose(g, want[k], rtol=0, atol=2e-2 * scale,
                                   err_msg=k)


def _trainer(cfg):
    tw = ModelTrainerWrapper(cfg.model, _tok(TokenizerInfo), cfg.trainer,
                             device="cpu").init_weights(cfg.seed)
    return Trainer(cfg, tw)


def test_resume_two_plus_two_steps_equal_four(tmp_path):
    """Dropout and corruption on: each step folds its randomness from the
    seed and the restored step count, so the resumed run is bitwise the
    straight one; the weights checkpoint follows the trainer's steps."""
    cfg = load_training_config(SMOKE)
    cfg.num_steps = 2
    batches = _batches(cfg, 4, 2)
    straight = _trainer(cfg)
    straight.train_loop(iter(batches), 0)
    straight.train_loop(iter(batches[2:]), 1)
    first = _trainer(cfg)
    first.train_loop(iter(batches[:2]), 0,
                     chkpt_fname=str(tmp_path / "ck.npz"))
    first.save_state(str(tmp_path / "state"))
    resumed = _trainer(cfg)
    resumed.restore_state(str(tmp_path / "state"))
    assert resumed.step == 2
    resumed.train_loop(iter(batches[2:]), 1)
    a, b = straight.wrapper.state_dict(), resumed.wrapper.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    losses = [float(m["train_loss_lm"]) for m in resumed.history]
    assert losses == [float(m["train_loss_lm"])
                      for m in straight.history[2:]]
    sd = load_state_dict(str(tmp_path / "ck.npz"))
    np.testing.assert_array_equal(
        sd["decoder.transformer.wte.weight"],
        state_dict_numpy(first.wrapper.model)["decoder.transformer.wte.weight"])


def test_trainer_and_evaluate_twins_end_to_end_on_cpu(tmp_path, capsys):
    """synthetic-smoke.yaml cut to 2 steps x 2 loop epochs, batch 4, one val
    step: train (eval_model and val included), checkpoint and train state;
    a second run resumes at step 4; the evaluate twin reads the
    checkpoint."""
    raw = yaml.safe_load(SMOKE.read_text())
    raw.update(batch_size=4, num_steps=2, num_val_steps=1)
    cfg_file = tmp_path / "smoke.yaml"
    cfg_file.write_text(yaml.safe_dump(raw))
    ck, state = tmp_path / "ck.npz", tmp_path / "state"
    args = twin.parse_args(["--config_file", str(cfg_file), "--chkpt_file",
                            str(ck), "--resume_dir", str(state)])
    trainer = twin.main(args, device="cpu")
    assert trainer.step == 4 and len(trainer.history) == 4
    assert all(math.isfinite(float(m["train_loss_lm"]))
               for m in trainer.history)
    assert (state / "train_state.pt").exists() and len(
        load_state_dict(str(ck))) == 79
    again = twin.main(args, device="cpu")
    assert again.step == 8
    out = capsys.readouterr().out
    assert "resumed train state" in out and "Epoch: 1, loss:" in out
    result = twin_eval.main(twin_eval.parse_args([
        "--config_file", str(cfg_file), "--chkpt_file", str(ck),
        "--num_images", "2", "--num_candidates", "2", "--max_new_tokens",
        "8"]), device="cpu")
    assert len(result["candidates"]) == 2 and 0.0 <= result["bleu"] <= 1.0
    with pytest.raises(NotImplementedError,
                       match="Deep Lake loader is not ported"):
        cfg = load_training_config(cfg_file)
        cfg.dataset = "flickr30k"
        twin.build_inner_datasets(cfg, twin.config_tokenizer(cfg))
