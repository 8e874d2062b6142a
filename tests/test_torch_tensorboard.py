"""``core/loggers/backends.TensorboardLogger`` against the JAX package's, and
the loggers' rank-0 gate.

- The same log calls through both packages' backends write event files
  with the same scalars at the same per-key steps (read back with
  tensorboard's ``EventAccumulator``); a non-scalar value takes a step and
  writes nothing, in both;
- the per-key step counters survive ``state_dict`` / ``load_state_dict``:
  a resumed logger goes on from the saved steps;
- when ``torch.utils.tensorboard`` cannot be imported (monkeypatched), the
  backend warns and logs nothing, as the JAX one;
- ``Logger(rank0_only=True)`` on a rank other than 0 neither initialises
  nor logs its backends, nor counts; with ``rank0_only=False`` it does."""

import builtins
import logging

import pytest

from speechlid_tpu.core.loggers.backends import TensorboardLogger as JaxTensorboardLogger
from speechlid_tpu_torch.core import loggers as ploggers
from speechlid_tpu_torch.core.loggers import BaseLogger, Logger, TensorboardLogger

CALLS = [({"loss": 2.5, "lr": 1e-3}, 0), ({"loss": 2.0, "hist": [1, 2]}, 1),
         ({"loss": 1.5, "eer": 0.25}, 2)]


def scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {tag: [(e.step, round(e.value, 6)) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def drive(logger, calls):
    for data, step in calls:
        logger.log(data, step)


def test_event_files_equal_the_jax_backend(tmp_path):
    port, jax_logger = TensorboardLogger(str(tmp_path / "port")), JaxTensorboardLogger(
        str(tmp_path / "jax"))
    for backend in (port, jax_logger):
        backend.init("run")
        drive(backend, CALLS)
        backend.finish()
    got, want = scalars(tmp_path / "port" / "run"), scalars(tmp_path / "jax" / "run")
    assert got == want
    assert got["loss"] == [(1, 2.5), (2, 2.0), (3, 1.5)] and got["eer"] == [(1, 0.25)]
    assert "hist" not in got
    assert port.state_dict() == jax_logger.state_dict() == {
        "steps": {"loss": 3, "lr": 1, "hist": 1, "eer": 1}}


def test_step_counters_survive_a_resume(tmp_path):
    first = TensorboardLogger(str(tmp_path))
    first.init("run")
    drive(first, CALLS[:2])
    first.finish()
    resumed = TensorboardLogger(str(tmp_path))
    resumed.load_state_dict(first.state_dict())
    resumed.init("run")
    drive(resumed, CALLS[2:])
    resumed.finish()
    assert resumed.state_dict()["steps"]["loss"] == 3
    assert scalars(tmp_path / "run")["loss"] == [(1, 2.5), (2, 2.0), (3, 1.5)]


def test_without_tensorboard_it_logs_nothing(tmp_path, monkeypatch, caplog):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    backend = TensorboardLogger(str(tmp_path / "tb"))
    with caplog.at_level(logging.WARNING):
        backend.init("run")
    assert "TensorboardLogger disabled" in caplog.text
    drive(backend, CALLS)
    backend.finish()
    assert not (tmp_path / "tb").exists() and backend.state_dict() == {"steps": {}}


class _Recording(BaseLogger):
    def __init__(self):
        self.inits, self.logs = [], []

    def init(self, run_name, config=None):
        self.inits.append(run_name)

    def log(self, data, step):
        self.logs.append((dict(data), step))


@pytest.mark.parametrize("rank", [0, 1])
def test_rank0_gate(monkeypatch, rank):
    monkeypatch.setattr(ploggers, "process_index", lambda: rank)
    gated, open_ = _Recording(), _Recording()
    for backend, rank0_only in ((gated, True), (open_, False)):
        logger = Logger([backend], rank0_only=rank0_only)
        logger.init("run")
        logger.log({"loss": 1.0}, step=3)
        assert logger.state_dict()["counts"] == ({"loss": 1} if rank == 0 or not rank0_only
                                                 else {})
    assert open_.logs == [({"loss": 1.0}, 3)]
    assert gated.logs == ([({"loss": 1.0}, 3)] if rank == 0 else [])
    assert gated.inits == (["run"] if rank == 0 else [])
