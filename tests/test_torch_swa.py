"""SWA in the port's ``Trainer`` (``use_swa=True``) against the JAX
``Trainer`` on the same converted weights and batches, on the CPU.

Dropout 0, stochastic depth off, no SpecAugment or stretch (the packages'
random streams differ), SGD so that every leaf holds to 1e-4 (see
``tests/test_torch_trainer.py``: under Adam a zero-gradient leaf moves by
±lr on rounding noise); four epochs of three steps, ``swa_start_ratio``
0.5, so epochs 2 and 3 are averaged.

- the SWA average after every epoch, and the count, as the JAX
  ``TrainState``'s;
- after the fit, the parameters are the average (the mean of the two
  epochs' parameters), and the BatchNorm running statistics the JAX
  trainer's re-estimation gives (five passes of the three batches through
  ``bn_update_loop``), apart from the pre-swap ones; every leaf within
  1e-4;
- ``swa_final.ckpt`` loads into the port (``resume_from_checkpoint``) with
  those weights, and carries the average and its count;
- a run resumed from the ``last.ckpt`` of epoch 2 averages on to the same
  result;
- the cross-entropy task has no ``bn_update_loop`` in either package: in
  each, the average is swapped in and the statistics stay the last
  epoch's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.core import Trainer as JaxTrainer
from speechlid_tpu.core.callbacks import Callback as JaxCallback
from speechlid_tpu.tasks.lid_cross_entropy import LidCrossEntropyTask as JaxCETask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.core.callbacks import Callback, CkptCallback
from speechlid_tpu_torch.core.checkpoint import wait_for_checkpoints
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from speechlid_tpu_torch.tasks.lid_cross_entropy import LidCrossEntropyTask
from tests.test_torch_trainer import DETERMINISTIC, HPARAMS, assert_variables_close, batches
from tests.torch_parity import lid_pair, one_thread, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
EPOCHS = 4
SWA = dict(use_swa=True, swa_start_ratio=0.5)  # int(4 · 0.5) = 2: epochs 2 and 3
HP = dict(HPARAMS, **DETERMINISTIC, optimizer="sgd", lr=0.05)


class _Snapshots(Callback):
    """After each train epoch (once the epoch's average is taken):
    whatever ``take(trainer)`` returns."""

    def __init__(self, take):
        super().__init__()
        self.take, self.epochs = take, []

    def after_train_epoch(self, epoch, metrics):
        self.epochs.append(self.take(self.trainer))


class _JaxSnapshots(_Snapshots, JaxCallback):
    pass


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def run_jax(jtask, variables, train, epochs=EPOCHS):
    jtask.init_variables = lambda rng, sample: jax.tree_util.tree_map(jnp.asarray, variables)
    rec = _JaxSnapshots(lambda t: (_np(t.state.swa_params), int(t.state.swa_count),
                                   _np(t.state.model_state.get("batch_stats", {}))))
    trainer = JaxTrainer(total_epoch=epochs, use_progress_bar=False, callbacks=[rec], **SWA)
    trainer.fit(jtask, train)
    state = _np(trainer.state)
    return rec, {"params": state.params, "batch_stats": state.model_state.get("batch_stats", {})}


def _port_variables(model, params=None, to_variables=convert.lid_variables):
    sd = dict(model.state_dict())
    sd.update(params or {})
    return to_variables({k: v.detach().clone() for k, v in sd.items()})


def run_port(ptask, train, val=None, epochs=EPOCHS, to_variables=convert.lid_variables,
             **kw):
    ptask.init_parameters = lambda generator: None  # keep the weights it was given
    rec = _Snapshots(lambda t: (
        _port_variables(t.module.model, t.swa_params, to_variables), t.swa_count,
        _port_variables(t.module.model, None, to_variables)))
    trainer = Trainer(total_epoch=epochs, use_progress_bar=False, device="cpu",
                      callbacks=[rec, *kw.pop("callbacks", [])], **SWA, **kw)
    trainer.fit(ptask, train, val)
    return rec, trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # one thread, as the tests that compare with it bit for bit (the
    # module's fixture comes before the function-scoped ``one_thread``)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _runs(tmp_path_factory):
    jtask, variables, ptask = lid_pair(HP)
    # copies: the port's parameters and the JAX trainer's donated buffers
    # may share the numpy arrays' memory
    pristine = jax.tree_util.tree_map(np.array, variables)
    train = batches(1, [0, 1, 0])
    jrec, jfinal = run_jax(jtask, jax.tree_util.tree_map(np.array, variables), train)
    ckpt_dir = tmp_path_factory.mktemp("swa_ckpt")
    prec, ptrainer = run_port(ptask, train, callbacks=[CkptCallback(str(ckpt_dir))])
    return dict(variables=pristine, train=train, jrec=jrec, jfinal=jfinal, prec=prec,
                ptrainer=ptrainer, ptask=ptask, ckpt_dir=ckpt_dir)


def test_average_after_every_epoch_matches_jax(runs):
    jrec, prec = runs["jrec"], runs["prec"]
    assert [c for _, c, _ in jrec.epochs] == [c for _, c, _ in prec.epochs] == [0, 0, 1, 2]
    for (jswa, _, _), (pswa, _, _) in zip(jrec.epochs, prec.epochs):
        assert_variables_close({"params": pswa["params"], "batch_stats": {}},
                               {"params": jswa, "batch_stats": {}}, None)


def test_final_weights_are_the_average_and_statistics_reestimated(runs):
    prec, ptask = runs["prec"], runs["ptask"]
    final = convert.lid_variables(ptask.model.state_dict())
    assert_variables_close(final, runs["jfinal"], None)
    # the parameters: the mean of epochs 2 and 3
    (_, _, p2), (_, _, p3) = prec.epochs[2], prec.epochs[3]
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, p2["params"], p3["params"])
    jax.tree_util.tree_map(
        lambda got, want: np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6),
        final["params"], mean)
    # the statistics: re-estimated, not the last epoch's
    bn = lambda tree: tree["batch_stats"]["featurizer"]["block_0"]["conv"]["bn"]  # noqa: E731
    assert np.abs(bn(final)["mean"] - bn(p3)["mean"]).max() > 100 * TOL
    assert np.abs(bn(final)["var"] - bn(p3)["var"]).max() > 100 * TOL


def test_swa_checkpoint_loads_into_the_port(runs):
    path = str(runs["ckpt_dir"] / "swa_final.ckpt")
    module, ckpt = LidASRTask.resume_from_checkpoint(path, device="cpu")
    for name, value in runs["ptask"].model.state_dict().items():
        assert torch.equal(module.model.state_dict()[name], value), name
    assert ckpt["meta"]["epoch"] == EPOCHS and ckpt["state"]["swa"]["count"] == 2


def test_resumed_run_averages_on(runs, tmp_path):
    """The same four epochs cut after epoch 2 (its ``last.ckpt`` kept) and
    resumed: the same weights and statistics as the uninterrupted run, bit
    for bit (one process, the same arithmetic)."""
    import shutil

    class KeepEpoch2(Callback):
        def after_eval_epoch(self, epoch, metrics):
            if epoch == 2:
                wait_for_checkpoints()  # CkptCallback writes on a thread of its own
                shutil.copy(tmp_path / "ckpt" / "last.ckpt", tmp_path / "epoch2.ckpt")

    first = LidASRTask(**HP, device="cpu")
    convert.load_into(first.model, convert.lid_state(
        jax.tree_util.tree_map(np.array, runs["variables"])))
    run_port(first, runs["train"], val=runs["train"][:1],
             callbacks=[CkptCallback(str(tmp_path / "ckpt")), KeepEpoch2()])
    cut = torch.load(tmp_path / "epoch2.ckpt", weights_only=True)["state"]["swa"]
    assert cut["count"] == 1
    resumed = LidASRTask(**HP, device="cpu")
    _, trainer = run_port(resumed, runs["train"],
                          checkpoint_path=str(tmp_path / "epoch2.ckpt"))
    assert trainer.start_epoch == 3 and trainer.swa_count == 2
    for name, value in runs["ptask"].model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name


def test_cross_entropy_task_swaps_without_reestimation():
    """In each package on its own (the ResNet's ReLUs make float32 training
    of the two packages part, ``tests/test_torch_ce_task.py``): the final
    parameters are the average of epochs 2 and 3, the BatchNorm statistics
    the last epoch's, bit for bit."""
    hp = dict(num_classes=3, backend="resnet2", n_mels=16, mask_times=0, lr=0.05,
              optimizer="sgd", schedule=None)
    rng = np.random.RandomState(0)
    train = [{"wavs": (0.1 * rng.randn(3, 9600)).astype(np.float32),
              "wav_lengths": np.array([9600, 7001, 5000], np.int32),
              "langs": np.array([2, 0, 1], np.int32), "n_valid": np.int32(0),
              "texts": np.zeros((3, 4), np.int32), "text_lengths": np.ones(3, np.int32)}
             for _ in range(2)]
    jtask = JaxCETask(**hp)
    variables = random_batch_stats(jtask.init_variables(jax.random.PRNGKey(0), train[0]), 0)
    ptask = LidCrossEntropyTask(**hp, device="cpu")
    convert.load_into(ptask.model, convert.lid_ce_state(variables))
    assert not hasattr(ptask, "bn_update_loop") and not hasattr(jtask, "bn_update_loop")
    jrec, jfinal = run_jax(jtask, jax.tree_util.tree_map(np.array, variables), train)
    prec, _ = run_port(ptask, train, to_variables=convert.lid_ce_variables)
    final = convert.lid_ce_variables(ptask.model.state_dict())
    for got, avg, last_stats in ((final, prec.epochs[-1][0]["params"], prec.epochs[-1][2]),
                                 (jfinal, jrec.epochs[-1][0], {"batch_stats": jrec.epochs[-1][2]})):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got["params"], avg)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got["batch_stats"],
                               last_stats["batch_stats"])
    (_, _, p2), (_, _, p3) = prec.epochs[2], prec.epochs[3]
    jax.tree_util.tree_map(
        lambda got, a, b: np.testing.assert_allclose(got, (a + b) / 2, rtol=1e-6, atol=1e-6),
        final["params"], p2["params"], p3["params"])
