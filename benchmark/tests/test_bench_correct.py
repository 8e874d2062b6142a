"""``correct`` on the CPU at tiny widths: the port's CPU path agrees with
the plain reference through the whole run (scoring batches from the
window, the first three training steps), and a run whose timed path is
broken underneath comes out not correct, once for each fault a cell can
have: an answer altered where it is produced, half of the batch left out,
a step that returns its state unchanged; and a fault that shows only in
the window's steps, past the set-up's.  (One card: no exchange between
chips to leave out.)"""

import pytest
import torch

from conftest import tiny_cell
from harness import runner
from harness.train import CHECKED_STEPS

SCORE_LIMITS = {"lp_err": 1e-4, "token_gap": 1e-4, "score_err": 1e-5}
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.05,
                "w_loss_gap": 1e-5, "w_grad_gap": 1e-3, "w_change_gap": 0.05}
SEED = 2 ** 31 + 12345
CONFIGS = ["conformer_flagship", "wavlm_base_plus"]


def _run(name, mode, limits):
    """A run on the CPU; training's window is long enough to reach the step
    it keeps for the check (after the loader's first cycle)."""
    torch.manual_seed(0)
    return runner.run(tiny_cell(name, mode, limits), SEED, 0.3 if mode == "score" else 4.0,
                      False, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_scoring_agrees(name):
    result = _run(name, "score", SCORE_LIMITS)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", CONFIGS)
def test_training_agrees(name):
    result = _run(name, "train", TRAIN_LIMITS)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", CONFIGS)
def test_altered_answer_is_caught(name, monkeypatch):
    from speechlid_tpu_torch.models import multilang

    original = multilang.lang_confidence_scores

    def altered(*args, **kwargs):
        scores = original(*args, **kwargs).clone()
        scores[0, 0] += 0.01
        return scores

    monkeypatch.setattr(multilang, "lang_confidence_scores", altered)
    result = _run(name, "score", SCORE_LIMITS)
    assert not result["correct"]
    assert result["checks"]["score_err"]["value"] > SCORE_LIMITS["score_err"]


@pytest.mark.parametrize("name", CONFIGS)
def test_half_batch_scored_is_caught(name, monkeypatch):
    from speechlid_tpu_torch.models.multilang import MutiLangModel

    original = MutiLangModel.forward

    def half(self, x, lengths=None, only=None):
        logits, feat = original(self, x, lengths, only)
        n = logits.shape[1] // 2
        return torch.cat([logits[:, :n], logits[:, :logits.shape[1] - n]], dim=1), feat

    monkeypatch.setattr(MutiLangModel, "forward", half)
    result = _run(name, "score", SCORE_LIMITS)
    assert not result["correct"]


@pytest.mark.parametrize("name", CONFIGS)
def test_unchanged_state_is_caught(name, monkeypatch):
    from speechlid_tpu_torch.core.optim.factory import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)
    result = _run(name, "train", TRAIN_LIMITS)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CONFIGS)
def test_half_batch_loss_is_caught(name, monkeypatch):
    from speechlid_tpu_torch.tasks import lid_asr

    original = lid_asr.ctc_loss

    def half(log_probs, labels, input_lengths, label_lengths, **kwargs):
        n = log_probs.shape[0] // 2
        return original(log_probs[:n], labels[:n], input_lengths[:n], label_lengths[:n],
                        **kwargs)

    monkeypatch.setattr(lid_asr, "ctc_loss", half)
    result = _run(name, "train", TRAIN_LIMITS)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > TRAIN_LIMITS["loss_gap"]


@pytest.mark.parametrize("name", CONFIGS)
def test_fault_in_later_steps_is_caught(name, monkeypatch):
    """A learning rate doubled from the fourth step on: the set-up's checked
    steps are sound, the window's kept step is not."""
    from speechlid_tpu_torch.core.optim.factory import Optimizer

    original = Optimizer.lr_at

    def later(self, count):
        return original(self, count) * (2.0 if count >= CHECKED_STEPS else 1.0)

    monkeypatch.setattr(Optimizer, "lr_at", later)
    result = _run(name, "train", TRAIN_LIMITS)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["change_gap"]["value"] <= TRAIN_LIMITS["change_gap"]
    assert checks["w_change_gap"]["value"] > TRAIN_LIMITS["w_change_gap"]
