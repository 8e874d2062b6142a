"""The port's device trace (``speechlid_tpu_torch/core/profile.py``
``device_trace`` and ``Trainer(profile_dir=…, profile_epochs=…)``) on the
CPU: the first ``profile_epochs`` train epochs after the start epoch are
traced, one Chrome trace an epoch, as the JAX trainer traces them; without
``profile_dir`` no profiler runs."""

import json

import numpy as np
import pytest
import torch

from speechlid_tpu_torch.core import profile
from speechlid_tpu_torch.core.callbacks import CkptCallback
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.extras import SpecPredTask
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
