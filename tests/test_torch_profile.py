"""The port's device trace (``speechlid_tpu_torch/core/profile.py``
``device_trace`` and ``Trainer(profile_dir=…, profile_epochs=…)``) on the
CPU: the first ``profile_epochs`` train epochs after the start epoch are
traced, one Chrome trace an epoch, as the JAX trainer traces them; without
``profile_dir`` no profiler runs.  And the program's spans: recorded only
under a profiler, in the tree of the trainer, task and model boundaries,
annotated in the trace, capped, without device times off the card."""

import json

import numpy as np
import pytest
import torch

from speechlid_tpu_torch.core import profile
from speechlid_tpu_torch.core.callbacks import CkptCallback
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.extras import SpecPredTask
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(4, 6, 3).astype(np.float32), "y": rng.randn(4, 3).astype(np.float32)}
            for _ in range(n)]


def fit(tmp_path, total_epoch, **kw):
    task = SpecPredTask(model_name="mlp", feat_dim=3, win_len=6, model_conf={"hidden": 8},
                        device="cpu")
    trainer = Trainer(total_epoch=total_epoch, use_progress_bar=False, device="cpu", **kw)
    trainer.fit(task, batches(), batches(1, 1))
    return trainer


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_dir_traces_the_first_epochs(tmp_path):
    fit(tmp_path, 3, profile_dir=str(tmp_path / "trace"), profile_epochs=2,
        callbacks=[CkptCallback(ckpt_path=str(tmp_path / "ckpt"))])
    traces = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert traces == ["epoch_0.pt.trace.json", "epoch_1.pt.trace.json"]
    names = {e.get("name", "") for e in _events(tmp_path / "trace" / traces[0])}
    assert any("addmm" in n or "linear" in n for n in names), sorted(names)[:20]
    # a resumed run traces its own first epochs
    fit(tmp_path, 4, profile_dir=str(tmp_path / "resumed"),
        checkpoint_path=str(tmp_path / "ckpt" / "last.ckpt"))
    assert sorted(p.name for p in (tmp_path / "resumed").iterdir()) == ["epoch_3.pt.trace.json"]


def test_no_profile_dir_runs_no_profiler(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler ran")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    trainer = fit(tmp_path, 1)
    assert trainer.profile_dir is None and trainer.global_step == 3
    with profile.device_trace(None) as prof:
        assert prof is None


# ----------------------------------------------------------------- spans

HP = dict(lang2vocab={"aa": 5, "bb": 9}, lang2index={"aa": 0, "bb": 1},
          n_blocks=2, encoder_dim=16, heads=2, dim_head=8, head_dim_head=4, head_num_head=2,
          dropout=0.0, pos_dropout=0.0, use_stochastic_depth=False, mask_times=0,
          t_stretch=False, lr=1e-3, schedule="tristage",
          schedule_conf=dict(warmup_steps=3, hold_steps=2, decay_steps=10))
TINY_WAVLM = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                  encoder_attention_heads=4, conv_feature_layers="[(16,10,5)] + [(16,3,2)] * 2",
                  conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64,
                  relative_position_embedding=True, gru_rel_pos=True)
TRAIN_TREE = {"trainer.forward": "trainer.step", "task.frontend": "trainer.forward",
              "model.featurizer": "trainer.forward", "model.extractor": "model.featurizer",
              "model.heads": "trainer.forward", "task.loss": "trainer.forward",
              "trainer.backward": "trainer.step", "trainer.optimizer": "trainer.step",
              "trainer.fetch": "trainer.step"}


def lid_batches(n, seed=0, b=2, t=8000):
    rng = np.random.RandomState(seed)
    return [{"wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
             "wav_lengths": np.array([t, 6000][:b], np.int32),
             "texts": rng.randint(0, 5, (b, 4)).astype(np.int32),
             "text_lengths": np.array([4, 3][:b], np.int32),
             "langs": np.full(b, i % 2, np.int32), "n_valid": np.int32(0)}
            for i in range(n)]


def lid_trainer(featurizer="conformer", **kw):
    extra = {"featurizer": "wavlm", "ssl_config": TINY_WAVLM} if featurizer == "wavlm" else {}
    task = LidASRTask(**HP, **extra, **kw, device="cpu")
    trainer = Trainer(total_epoch=1, accum_grad=2, use_progress_bar=False, device="cpu")
    trainer.trainer_prepare(task)
    return task, trainer


@pytest.fixture
def recoder():
    rec = profile._time_cost_recoder
    rec.remove_recoder()
    yield rec
    rec.remove_recoder()


def cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def lineage(span):
    """The spans from the root down to ``span``."""
    out = []
    while span is not None:
        out.append(span)
        span = span.parent
    return out[::-1]


def path(span):
    return [s.name for s in lineage(span)]


def test_spans_off_record_nothing_and_keep_the_host_totals(recoder):
    task, trainer = lid_trainer()
    trainer._run_train_epoch(0, lid_batches(4))
    assert recoder.spans() == [] and recoder.dropped == 0
    counts = {k: n for k, (_, n) in recoder.snapshot().items()}
    assert counts == {"get_batch": 4, "batch_to_device": 4, "train_step_dispatch": 4}
    with recoder.span("task.infer") as record:
        assert record is None
    recoder.remove_recoder()
    with cpu_profiler():  # the same host totals with spans on
        trainer._run_train_epoch(0, lid_batches(4))
    assert {k: n for k, (_, n) in recoder.snapshot().items()} == counts
    assert len(recoder.spans()) > 0


@pytest.mark.parametrize("featurizer", ["conformer", "wavlm"])
def test_train_step_span_tree(recoder, featurizer):
    task, trainer = lid_trainer(featurizer)
    with cpu_profiler():
        trainer._run_train_epoch(0, lid_batches(4))
    spans = recoder.spans()
    steps = [s for s in spans if s.name == "trainer.step"]
    assert [s.batch for s in steps] == [1, 2, 3, 4] and trainer.global_step == 4
    assert all(s.parent is None for s in steps)
    for step in steps:
        children = [s for s in spans if s.parent is step]
        want = ["trainer.forward", "trainer.backward"]
        want += ["trainer.optimizer"] * (step.batch % 2 == 0) + ["trainer.fetch"] * (step.batch > 1)
        assert [s.name for s in children] == want
        inside = [s for s in spans if step in lineage(s)[:-1]]
        assert {s.batch for s in inside} == {step.batch}
        for s in inside:
            assert s.parent.name == TRAIN_TREE[s.name], path(s)
        assert sorted(s.name for s in inside if s.parent.name == "trainer.forward") == sorted(
            ["task.frontend", "model.featurizer", "model.heads", "task.loss"])
        assert [s.name for s in inside if s.parent.name == "model.featurizer"] == [
            "model.extractor"]
    last = spans[-1]  # the last step's metrics, fetched after the loop
    assert last.name == "trainer.fetch" and last.parent is None
    assert "trainer.grad_sync" not in {s.name for s in spans}  # no mesh
    for s in spans:
        assert s.device_ms is None  # off the card
        assert s.host_ms >= 0
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns
    summary = recoder.span_summary()
    assert summary["trainer.optimizer"][0] == 2 and summary["trainer.step"][0] == 4
    assert summary["trainer.forward"][2] is None


def test_infer_span_tree(recoder):
    task, _ = lid_trainer()
    fn = task.infer_fn()
    batch = lid_batches(1)[0]
    with cpu_profiler():
        for _ in range(2):
            fn(torch.as_tensor(batch["wavs"]), torch.as_tensor(batch["wav_lengths"]))
    spans = recoder.spans()
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.batch) for s in roots] == [("task.infer", 1), ("task.infer", 2)]
    for root in roots:
        assert [s.name for s in spans if s.parent is root] == [
            "task.frontend", "model.featurizer", "model.heads", "model.scores"]
        assert [path(s) for s in spans if root in lineage(s) and len(path(s)) == 3] == [
            ["task.infer", "model.featurizer", "model.extractor"]]
        assert {s.batch for s in spans if root in lineage(s)} == {root.batch}


def test_device_trace_holds_every_span(tmp_path, recoder):
    task, trainer = lid_trainer()
    fn = task.infer_fn()
    batch = lid_batches(1)[0]
    with profile.device_trace(str(tmp_path), "spans"):
        trainer._run_train_epoch(0, lid_batches(2))
        fn(torch.as_tensor(batch["wavs"]), torch.as_tensor(batch["wav_lengths"]))
    names = {s.name for s in recoder.spans()}
    assert names == set(TRAIN_TREE) | {"trainer.step", "task.infer", "model.scores"}
    annotations = [e for e in _events(tmp_path / "spans.pt.trace.json")
                   if e.get("cat") == "user_annotation"]
    assert names <= {e["name"] for e in annotations}
    counts = {n: sum(e["name"] == n for e in annotations) for n in names}
    assert counts == {n: c for n, (c, _, _) in recoder.span_summary().items()}


def test_recomputed_block_spans_fall_under_the_backward(recoder, monkeypatch):
    task, trainer = lid_trainer(remat=True)
    for block in task.model.featurizer.blocks:  # the heads are not rematerialized
        def spanned(*args, _forward=block.forward, **kwargs):
            with recoder.span("test.block"):
                return _forward(*args, **kwargs)

        monkeypatch.setattr(block, "forward", spanned)
    with cpu_profiler():
        trainer._run_train_epoch(0, lid_batches(1))
    blocks = [s for s in recoder.spans() if s.name == "test.block"]
    parents = [path(s)[:-1] for s in blocks]
    n = len(task.model.featurizer.blocks)
    assert parents[:n] == [["trainer.step", "trainer.forward", "model.featurizer"]] * n
    assert parents[n:] == [["trainer.step", "trainer.backward"]] * n


def test_span_on_another_thread_during_recomputation_takes_the_backward(recoder, monkeypatch):
    """Autograd's device thread runs a recomputation with no span open on
    it: its spans take the open ``trainer.backward``; spans of another
    thread outside a recomputation are roots."""
    import threading

    from speechlid_tpu_torch.models import remat

    found = {}

    def worker(key):
        with recoder.span("test.worker") as record:
            found[key] = record

    with cpu_profiler():
        with recoder.span(profile.BACKWARD, batch=7) as backward:
            for key, depth in (("outside", 0), ("recomputing", 1)):
                monkeypatch.setattr(remat, "_depth", depth)
                thread = threading.Thread(target=worker, args=(key,))
                thread.start()
                thread.join(timeout=30)
                assert not thread.is_alive()
    assert found["outside"].parent is None and found["outside"].batch is None
    assert found["recomputing"].parent is backward and found["recomputing"].batch == 7


def test_span_records_are_capped(recoder, monkeypatch):
    monkeypatch.setattr(profile, "MAX_SPANS", 3)
    with cpu_profiler() as prof:
        for i in range(5):
            with recoder.span("test.capped", batch=i):
                pass
    assert [s.batch for s in recoder.spans()] == [0, 1, 2] and recoder.dropped == 2
    assert sum(e.name == "test.capped" for e in prof.events()) == 5  # all in the trace
    recoder.remove_recoder()
    assert recoder.spans() == [] and recoder.dropped == 0
