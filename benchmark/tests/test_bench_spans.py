"""The readers of the program's spans (``device_ms.*``, ``launches.*``) on
the CPU: a tiny cell's loop under a CPU profiler fills the program's
registry, and each reader gives the mean its spans give; each says nothing
for the other mode, for a registry without spans, and for a program that
records none."""

import pytest
import torch

from conftest import REPO, load_json, tiny_cell
from harness import runner, spec
from harness.trace import Trace

SEED = 2 ** 31 + 777
READERS = {  # metric → (mode, span)
    "device_ms.forward.train": ("train", "trainer.forward"),
    "device_ms.backward.train": ("train", "trainer.backward"),
    "device_ms.optimizer.train": ("train", "trainer.optimizer"),
    "device_ms.featurizer.score": ("score", "model.featurizer"),
    "device_ms.extractor.score": ("score", "model.extractor"),
    "device_ms.heads.score": ("score", "model.heads"),
    "launches.score": ("score", "task.infer"),
    "launches.train": ("train", "trainer.step"),
}
LIMITS = {"score": {"lp_err": 1.0}, "train": {"loss_gap": 1.0}}


@pytest.fixture
def recoder():
    from speechlid_tpu_torch.core.profile import _time_cost_recoder

    _time_cost_recoder.remove_recoder()
    yield _time_cost_recoder
    _time_cost_recoder.remove_recoder()


@pytest.fixture(scope="module")
def readers():
    return spec.load_readers(list(READERS))


def fake_trace(kernels: int) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, kernels=[("k", 1e-5)] * kernels)


def test_entries_name_the_readers():
    bench = load_json(REPO / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, (mode, _) in READERS.items():
        m = entries[name]
        assert m["better"] == "lower"
        assert m["source"] == ("device_trace" if name.startswith("launches") else "program_span")
        assert m["moves"] == f"{mode}_utt_per_s"
        assert all(w.endswith("bucket13s" if mode == "train" else "score_crop3s")
                   for w in m["workloads"]) and len(m["workloads"]) == 2


def test_nothing_without_spans_or_for_the_other_mode(recoder, readers, monkeypatch):
    cell = tiny_cell("conformer_flagship", "score", LIMITS["score"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("task.infer", "trainer.step", "trainer.forward", "model.heads"):
            with recoder.span(name):
                pass
    for name, (mode, _) in READERS.items():
        other = "score" if mode == "train" else "train"
        assert readers[name](runner.Run(cell, other, trace=fake_trace(10))) is None, name
    recoder.remove_recoder()
    for name, (mode, _) in READERS.items():
        assert readers[name](runner.Run(cell, mode, trace=fake_trace(10))) is None, name
    # a program that records no span (the registry has no span_summary)
    from speechlid_tpu_torch.core import profile

    monkeypatch.setattr(profile, "_time_cost_recoder", object())
    for name, (mode, _) in READERS.items():
        assert readers[name](runner.Run(cell, mode, trace=fake_trace(10))) is None, name


@pytest.mark.parametrize("name, mode", [("conformer_flagship", "score"),
                                        ("wavlm_base_plus", "score"),
                                        ("conformer_flagship", "train")])
def test_readers_give_the_mean_of_the_spans(name, mode, recoder, readers, monkeypatch):
    """Off the card a span has no device time (the readers then say
    nothing); with the host time standing in for it, each reader gives the
    mean over its spans, and ``launches.*`` the trace's kernels over them."""
    from speechlid_tpu_torch.core import profile

    cell = tiny_cell(name, mode, LIMITS[mode])
    torch.manual_seed(0)
    state = runner.mode_class(cell)(cell, SEED, "cpu")
    assert recoder.spans() == []  # set-up runs no profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        window = state.loop(0.5)
    run = runner.Run(cell, mode, window=window, trace=fake_trace(1000))
    mine = {k: v for k, v in READERS.items() if v[0] == mode}
    for metric in mine:
        if metric.startswith("device_ms"):
            assert readers[metric](run) is None, metric

    monkeypatch.setattr(profile.Span, "device_ms", property(lambda s: s.host_ms))
    spans = recoder.spans()
    for metric, (_, span) in mine.items():
        items = [s for s in spans if s.name == span]
        assert items, span
        if metric.startswith("launches"):
            want = 1000 / len(items)
        else:
            want = sum(s.host_ms for s in items) / len(items)
        assert readers[metric](run) == pytest.approx(want, rel=1e-12), metric
    batches = window.steps if mode == "train" else window.batches
    root = "trainer.step" if mode == "train" else "task.infer"
    assert sum(s.name == root for s in spans) == batches
