"""The port's sweep driver (``speechlid_tpu_torch/cli/sweep.py``) against the
JAX package's, exactly: the spec read by ``core/config.safe_load`` equals
PyYAML's, ``_sample`` / ``_grid`` draw the same values from the same
``random.Random``, ``TPESampler`` suggests the same trials from the same
history, and ``run_sweep_spec`` with the same objective returns and writes
the same results for every method.  A failing trial is logged with its
traceback and recorded as ``None``; one real trial trains through the
port's ``main_lid`` on the CPU on manifests that ``prepare_manifest``
wrote from a LibriSpeech-layout tree."""

import json
import logging
import math
import random

import numpy as np
import pytest
import yaml

from speechlid_tpu.cli import sweep as jsweep
from speechlid_tpu.data.audio_io import write_wav
from speechlid_tpu_torch.cli import prepare_manifest, sweep
from speechlid_tpu_torch.core.config import safe_load
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PARAMS = {
    "module.lr": {"distribution": "log_uniform", "min": 1e-4, "max": 5e-3},
    "module.dropout": {"values": [0.0, 0.1, 0.2]},
    "module.n_blocks": {"values": [8, 14]},
    "data.batch_size": {"distribution": "int_uniform", "min": 4, "max": 16},
    "module.t_mask_ratio": {"distribution": "uniform", "min": 0.0, "max": 0.1},
}


def test_sweep_yaml_reads_as_pyyaml_reads_it():
    with open("configs/sweep_lid.yaml") as f:
        body = f.read()
    assert safe_load(body) == yaml.safe_load(body)


def test_sample_and_grid_are_the_jax_draws():
    a, b = random.Random(3), random.Random(3)
    for _ in range(20):
        for spec in PARAMS.values():
            assert sweep._sample(spec, a) == jsweep._sample(spec, b)
    grid = {"x": {"values": [1, 2]}, "y": {"values": ["a", "b", "c"]}}
    assert sweep._grid(grid) == jsweep._grid(grid)


def objective(sample):
    """A smooth score of a sample, the same on both sides."""
    return (math.log(sample["module.lr"]) + 7.0) ** 2 + sample["module.dropout"] \
        + 0.01 * sample["data.batch_size"] + (sample["module.n_blocks"] == 14) \
        + sample["module.t_mask_ratio"]


@pytest.mark.parametrize("goal", ["minimize", "maximize"])
def test_tpe_suggests_the_jax_trials(goal):
    rng = np.random.RandomState(0)
    history = []
    for i in range(9):
        sample = {k: jsweep._sample(v, random.Random(int(rng.randint(1 << 30))))
                  for k, v in PARAMS.items()}
        history.append({"trial": i, **sample, "m": objective(sample)})
    history.append({"trial": 9, **history[0], "m": None})  # a failed trial
    port = sweep.TPESampler(PARAMS, random.Random(5), n_startup=4)
    ref = jsweep.TPESampler(PARAMS, random.Random(5), n_startup=4)
    for n in (2, 6, 10, 10, 10, 10):  # warm-up, then the model, ε draws among them
        assert port.suggest(history[:n], "m", goal) == ref.suggest(history[:n], "m", goal)


@pytest.mark.parametrize("method", ["random", "grid", "bayes"])
def test_run_sweep_spec_matches_jax(tmp_path, method):
    spec = {"method": method, "trials": 7, "n_startup": 3, "seed": 11,
            "metric": {"name": "score", "goal": "minimize"},
            "parameters": PARAMS if method != "grid" else
            {k: v for k, v in PARAMS.items() if "values" in v}}
    if method == "grid":
        grid_objective = lambda s: s["module.dropout"] - s["module.n_blocks"]
        got = sweep.run_sweep_spec(spec, out_root=str(tmp_path / "port"), objective=grid_objective)
        want = jsweep.run_sweep_spec(spec, out_root=str(tmp_path / "jax"),
                                     objective=grid_objective)
    else:
        got = sweep.run_sweep_spec(spec, out_root=str(tmp_path / "port"), objective=objective)
        want = jsweep.run_sweep_spec(spec, out_root=str(tmp_path / "jax"), objective=objective)
    assert got == want
    assert (tmp_path / "port" / "results.jsonl").read_text() \
        == (tmp_path / "jax" / "results.jsonl").read_text()


def test_failing_trial_is_logged_and_recorded_as_none(tmp_path, caplog):
    calls = []

    def flaky(sample):
        calls.append(sample)
        if len(calls) == 2:
            raise FloatingPointError("diverged")
        return objective(sample)

    spec = {"method": "random", "trials": 3, "metric": {"name": "score"}, "parameters": PARAMS}
    with caplog.at_level(logging.ERROR):
        results = sweep.run_sweep_spec(spec, out_root=str(tmp_path), objective=flaky)
    assert len(calls) == 3
    assert [r["score"] is None for r in results] == [False, False, True]
    assert results[-1]["trial"] == 1
    failed = [r for r in caplog.records if "trial 1 failed" in r.getMessage()]
    assert failed and failed[0].exc_info and "FloatingPointError" in caplog.text


TINY = ["module.n_blocks=1", "module.encoder_dim=32", "module.heads=2", "module.dim_head=16",
        "module.head_dim_head=8", "module.head_num_head=2", "data.buckets_s=[0.5, 1.0]",
        "trainer.total_epoch=1", "trainer.progress_bar=false", "module.schedule=null"]


def librispeech_tree(root, sr=16000):
    """<root>/<lang>/<speaker>/<chapter>/ with waves and a ``.trans.txt``."""
    rng = np.random.RandomState(0)
    for li, lang in enumerate(("aa", "bb")):
        chap = root / lang / "19" / "198"
        chap.mkdir(parents=True)
        lines = []
        for i in range(5):
            t = np.arange(int(sr * (0.4 + 0.1 * i))) / sr
            wav = 0.3 * np.sin(2 * np.pi * (150 + 200 * li) * t) + 0.01 * rng.randn(len(t))
            utt = f"19-198-{i:04d}"
            write_wav(str(chap / f"{utt}.wav"), wav.astype(np.float32), sr)
            lines.append(f"{utt} {'ab ba' if li == 0 else 'cd dc'}")
        (chap / "19-198.trans.txt").write_text("\n".join(lines))


def test_sweep_trains_through_main_lid_on_manifests(tmp_path, monkeypatch):
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    librispeech_tree(tmp_path / "corpus")
    prepare_manifest.main(["--root", str(tmp_path / "corpus"), "--out", str(tmp_path / "man"),
                           "--dev-ratio", "0.4"])
    langs = ", ".join("{manifest: %s, val_manifest: %s}" % (tmp_path / "man" / lang / "train.txt",
                                                           tmp_path / "man" / lang / "dev.txt")
                      for lang in ("aa", "bb"))
    spec = {"method": "grid", "metric": {"name": "avg_val_loss", "goal": "minimize"},
            "program_config": "lid_supervised",
            "base_overrides": TINY + [f"data.langs=[{langs}]"],
            "parameters": {"data.batch_size": {"values": [3]}}}
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(spec, width=1 << 20))
    results = sweep.main([str(path), "--out", str(tmp_path / "sweep"), "--device", "cpu"])
    assert len(results) == 1 and np.isfinite(results[0]["avg_val_loss"])
    lines = (tmp_path / "sweep" / "results.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == results
    metrics = (tmp_path / "sweep" / "trial_0" / "metrics.jsonl").read_text()
    assert "avg_val_loss" in metrics
