"""The XLS-R 300M configuration (``configs/xlsr_300m.json``) on the CPU at
tiny widths: a training run through the harness comes out ``correct``
against ``reference/wav2vec2.py``, a program whose conv extractor trains
against the recipe's freeze does not, and the encoder and attention
readers say nothing for scoring and read the spans in training."""

import pytest
import torch

from conftest import tiny_cell
from harness import runner, spec

TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.05,
                "w_loss_gap": 1e-5, "w_grad_gap": 1e-3, "w_change_gap": 0.05}
SEED = 2 ** 31 + 4242
READERS = ("device_ms.encoder.train", "device_ms.attention.train")


@pytest.fixture
def one_thread():
    """One intra-op thread, so that test workers sharing the machine leave
    the window time to reach the step it keeps."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train():
    """A run on the CPU whose window reaches the step it keeps (after the
    loader's first cycle: about a dozen tiny batches)."""
    torch.manual_seed(0)
    return runner.run(tiny_cell("xlsr_300m", "train", TRAIN_LIMITS), SEED, 6.0, False, "cpu")


def test_training_agrees(one_thread):
    result = _train()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_trainable_extractor_is_caught(one_thread, monkeypatch):
    """The extractor left out of the freeze: its gradients and steps have
    no counterpart in the reference, which holds it still."""
    from speechlid_tpu_torch.tasks import lid_asr

    monkeypatch.setattr(lid_asr, "SSL_EXTRACTOR_PARTS", ())
    result = _train()
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] > TRAIN_LIMITS["grad_gap"]


def test_readers_say_nothing_for_scoring():
    cell = tiny_cell("xlsr_300m", "score", {"lp_err": 1.0})
    readers = spec.load_readers(list(READERS))
    for name in READERS:
        assert readers[name](runner.Run(cell, "score")) is None, name


def test_readers_in_training(one_thread, monkeypatch):
    """Off the card the spans have no device time and the readers say
    nothing; with the host time standing in for it, the encoder reader gives
    its spans' mean and the attention reader its spans' sum a forward."""
    from speechlid_tpu_torch.core import profile

    recoder = profile._time_cost_recoder
    cell = tiny_cell("xlsr_300m", "train", {"loss_gap": 1.0})
    torch.manual_seed(0)
    state = runner.mode_class(cell)(cell, SEED, "cpu")
    recoder.remove_recoder()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            window = state.loop(0.5)
        run = runner.Run(cell, "train", window=window)
        readers = spec.load_readers(list(READERS))
        assert all(readers[name](run) is None for name in READERS)
        monkeypatch.setattr(profile.Span, "device_ms", property(lambda s: s.host_ms))
        spans = recoder.spans()
        forwards = sum(s.name == "trainer.forward" for s in spans)
        encoders = [s.host_ms for s in spans if s.name == "model.encoder"]
        attention = [s.host_ms for s in spans if s.name == "model.attention"]
        layers = cell.config["ssl_config"]["encoder_layers"]
        assert forwards == window.steps == len(encoders) and len(attention) == layers * forwards
        assert readers["device_ms.encoder.train"](run) == pytest.approx(
            sum(encoders) / forwards, rel=1e-12)
        assert readers["device_ms.attention.train"](run) == pytest.approx(
            sum(attention) / forwards, rel=1e-12)
    finally:
        recoder.remove_recoder()
