"""Async checkpoint writes (``speechlid_tpu_torch/core/checkpoint.py``
``save_checkpoint(…, async_write=True)`` and ``wait_for_checkpoints``,
``CkptCallback(async_write=True)``, the callback's default, and the
trainer's waits), on the CPU.

- A write started just before an in-place optimizer step saves the
  pre-step values: the state is copied to fresh host memory before
  ``save_checkpoint`` returns (on the CPU ``.cpu()`` would alias the live
  parameters), and the write thread is held until after the step.
- ``Trainer.fit`` with every write slowed: pruning never removes or meets
  a file that is still being written, ``fit`` returns with every file in
  place (``last.ckpt`` and the top-k, no temporary file), and the files
  hold the state of their epoch; the async run writes what the
  synchronous one writes, bit for bit.
- A write that fails on its thread is re-raised by
  ``wait_for_checkpoints``, and by ``fit``.
- Two gloo ranks of ``Trainer.fit`` under a data mesh: rank 0 writes every
  file, once each, rank 1 none.
- ``save_topk=0`` raises ``IndexError`` in both packages' callbacks (a
  fault of the JAX package, kept)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from speechlid_tpu_torch.core import checkpoint
from speechlid_tpu_torch.core.callbacks import Callback, CkptCallback
from speechlid_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint, wait_for_checkpoints
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_dist import VOCABS, global_batch, run_ranks
from tests.test_torch_trainer import DETERMINISTIC, HPARAMS, batches
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

HP = dict(HPARAMS, **DETERMINISTIC, n_blocks=1)


def test_an_async_write_saves_the_pre_step_values(tmp_path, monkeypatch):
    model = torch.nn.Linear(4, 3)
    optimizer, _ = make_optimizer(model.named_parameters(), "sgd", lr=0.5,
                                  optim_conf=dict(momentum=0.9))
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()  # a trace worth saving
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trace = [t.clone() for t in optimizer.mu]
    go = threading.Event()
    write = checkpoint._write
    monkeypatch.setattr(checkpoint, "_write", lambda paths, payload: (go.wait(10),
                                                                       write(paths, payload)))
    path = str(tmp_path / "last.ckpt")
    save_checkpoint(path, {"model": model.state_dict(), "optimizer": optimizer.state_dict()},
                    {"epoch": 0}, async_write=True)
    assert not os.path.exists(path)  # held on its thread
    for p in model.parameters():  # the next step, in place
        p.grad = torch.full_like(p, 3.0)
    optimizer.step()
    go.set()
    wait_for_checkpoints()
    state = load_checkpoint(path)["state"]
    for name, value in before.items():
        assert torch.equal(state["model"][name], value), name
        assert not torch.equal(model.state_dict()[name], value), name
    for name, t in zip(optimizer.names, trace):
        assert torch.equal(state["optimizer"]["mu"][name], t), name


def _fit(tmp_path, async_write):
    task = LidASRTask(**HP, device="cpu")
    train = batches(1, [0, 1, 2])
    cb = CkptCallback(str(tmp_path / "ckpt"), save_topk=2, async_write=async_write)
    snapshots = []

    class Snapshot(Callback):  # the state each epoch's files must hold
        def after_eval_epoch(self, epoch, metrics):
            snapshots.append({k: v.clone() for k, v in self.trainer.module.model.state_dict()
                              .items()})

    trainer = Trainer(total_epoch=4, use_progress_bar=False, device="cpu",
                      callbacks=[Snapshot(), cb])
    trainer.fit(task, train, train[:2])
    return cb, snapshots


def test_fit_returns_with_every_file_and_pruning_waits(tmp_path, monkeypatch):
    in_flight, log = set(), []
    write = checkpoint._write

    def slow_write(paths, payload):
        in_flight.update(paths)
        time.sleep(0.3)
        write(paths, payload)
        log.append((list(paths), payload["meta"]["epoch"]))
        in_flight.difference_update(paths)

    removed = []
    remove = os.remove

    def checked_remove(path):
        assert path not in in_flight, f"pruned {path} while it was written"
        removed.append(path)
        remove(path)

    monkeypatch.setattr(checkpoint, "_write", slow_write)
    monkeypatch.setattr(os, "remove", checked_remove)
    cb, snapshots = _fit(tmp_path / "async", True)
    monkeypatch.undo()
    assert not in_flight and len(log) == 4  # every epoch's write landed before fit returned
    ckpt_dir = tmp_path / "async" / "ckpt"
    files = sorted(os.listdir(ckpt_dir))
    assert "last.ckpt" in files and len(files) == 3 and not any(".tmp" in f for f in files), files
    assert len(removed) == 2  # top 2 of 4 epochs: two files pruned, none mid-write
    for name in files:
        saved = torch.load(ckpt_dir / name, weights_only=False)
        epoch = saved["meta"]["epoch"]
        for key, value in snapshots[epoch].items():
            assert torch.equal(saved["state"]["model"][key], value), (name, key)
    sync_cb, _ = _fit(tmp_path / "sync", False)
    assert sorted(os.listdir(tmp_path / "sync" / "ckpt")) == files
    for name in files:
        a = torch.load(ckpt_dir / name, weights_only=False)
        b = torch.load(tmp_path / "sync" / "ckpt" / name, weights_only=False)
        for key, value in a["state"]["model"].items():
            assert torch.equal(b["state"]["model"][key], value), (name, key)
    assert cb.best_path == sync_cb.best_path.replace("/sync/", "/async/")


def test_a_failing_write_is_re_raised(tmp_path, monkeypatch):
    def failing_save(obj, path, *args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    save_checkpoint(str(tmp_path / "a.ckpt"), {"x": torch.ones(2)}, async_write=True)
    with pytest.raises(RuntimeError, match="a.ckpt") as info:
        wait_for_checkpoints()
    assert isinstance(info.value.__cause__, OSError)
    wait_for_checkpoints()  # reported once
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        _fit(tmp_path, True)


def test_two_ranks_write_once_from_rank_0(tmp_path):
    hp = dict(HPARAMS, **DETERMINISTIC)
    rng = np.random.RandomState(3)
    train = [global_batch(rng, 0), global_batch(rng, 1)]
    task = LidASRTask(**hp, device="cpu")
    dirs = [str(tmp_path / f"ckpt{r}") for r in range(2)]
    ranks = run_ranks("ckpt_async", tmp_path / "ranks",
                      {"hparams": hp, "vocabs": VOCABS, "state": task.model.state_dict(),
                       "train": train, "val": train[:1], "ckpt_dirs": dirs})
    written = ranks[0]["written"]
    assert ranks[1]["written"] == [] and not os.path.exists(dirs[1])
    assert len(written) == len(set(written)) + 1  # last.ckpt twice, each top-k file once
    assert sorted(os.listdir(dirs[0])) == sorted({os.path.basename(p) for p in written})
    saved = load_checkpoint(os.path.join(dirs[0], "last.ckpt"))
    for name, value in ranks[0]["state"].items():
        assert torch.equal(saved["state"]["model"][name], value), name


def test_save_topk_zero_raises_index_error_in_both(tmp_path):
    """A fault of the JAX package's callback, kept in the port's copy
    (ROADMAP §3): ``save_topk=0`` reads the empty heap's root at the first
    finite metric and raises ``IndexError`` in both packages."""
    import types

    from speechlid_tpu.core.callbacks.ckpt import CkptCallback as JaxCkptCallback

    port = CkptCallback(str(tmp_path / "port"), save_topk=0, async_write=False)
    port.trainer = types.SimpleNamespace(checkpoint_state=lambda: {"x": torch.ones(1)},
                                         checkpoint_meta=lambda epoch, metrics: {})
    jax_cb = JaxCkptCallback(str(tmp_path / "jax"), save_topk=0, async_write=False)
    jax_cb.trainer = types.SimpleNamespace(state={"x": np.ones(1)},
                                           checkpoint_meta=lambda epoch, metrics: {})
    for cb in (port, jax_cb):
        with pytest.raises(IndexError):
            cb.after_eval_epoch(0, {"avg_val_loss": 1.0})
