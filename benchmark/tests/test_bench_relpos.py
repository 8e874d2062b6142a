"""The rel-pos attention readers (``device_ms.relpos_attn.{score,train}``)
on the CPU at tiny widths: each says nothing for the other mode, for a
registry without the spans and off the card; with the host time standing
in for the device's, each gives the sum of the ``model.relpos_attn`` spans
a batch (scoring) or a forward (training), in the Conformer (encoder and
heads) and in an SSL model (its Conformer heads)."""

import pytest
import torch

from conftest import tiny_cell
from harness import runner, spec

SEED = 2 ** 31 + 2222
READERS = {"device_ms.relpos_attn.score": ("score", "task.infer"),
           "device_ms.relpos_attn.train": ("train", "trainer.forward")}
LIMITS = {"score": {"lp_err": 1.0}, "train": {"loss_gap": 1.0}}


@pytest.fixture
def recoder():
    from speechlid_tpu_torch.core.profile import _time_cost_recoder

    _time_cost_recoder.remove_recoder()
    yield _time_cost_recoder
    _time_cost_recoder.remove_recoder()


@pytest.mark.parametrize("metric", list(READERS))
def test_nothing_for_the_other_mode_or_without_spans(metric, recoder, monkeypatch):
    mode, _ = READERS[metric]
    other = "score" if mode == "train" else "train"
    read = spec.load_readers([metric])[metric]
    cell = tiny_cell("conformer_flagship", mode, LIMITS[mode])
    assert read(runner.Run(cell, other)) is None
    assert read(runner.Run(cell, mode)) is None  # an empty registry
    from speechlid_tpu_torch.core import profile

    monkeypatch.setattr(profile, "_time_cost_recoder", object())  # a program without spans
    assert read(runner.Run(cell, mode)) is None


@pytest.mark.parametrize("config", ["conformer_flagship", "wavlm_base_plus"])
@pytest.mark.parametrize("metric", list(READERS))
def test_the_spans_summed_a_batch_or_a_forward(metric, config, recoder, monkeypatch):
    """The Conformer's encoder blocks and heads; an SSL model's heads alone."""
    from speechlid_tpu_torch.core import profile

    mode, root = READERS[metric]
    cell = tiny_cell(config, mode, LIMITS[mode])
    torch.manual_seed(0)
    state = runner.mode_class(cell)(cell, SEED, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        window = state.loop(0.5)
    run = runner.Run(cell, mode, window=window)
    read = spec.load_readers([metric])[metric]
    assert read(run) is None  # off the card a span has no device time
    monkeypatch.setattr(profile.Span, "device_ms", property(lambda s: s.host_ms))
    spans = recoder.spans()
    roots = sum(s.name == root for s in spans)
    attn = [s.host_ms for s in spans if s.name == "model.relpos_attn"]
    blocks = cell.config["task"]["n_blocks"] if config == "conformer_flagship" else 1
    assert roots > 0 and len(attn) >= blocks * roots
    assert read(run) == pytest.approx(sum(attn) / roots, rel=1e-12)
