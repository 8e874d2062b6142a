"""The port's secondary tasks (``speechlid_tpu_torch/tasks/extras.py``) and
their CLI (``cli/main_extras.py lm | rml | spec_pred | image``) against the
JAX package's on the CPU.

Weights are drawn on the port's side and converted
(``torch_parity.port_drawn``, ``convert.extras_variables``).  Tolerances:
every loss and metric of ``val_loop`` (and of ``train_loop`` where the task
draws nothing: the LM and the MLP forecaster) within 1e-5 of JAX's,
relative (``ppl`` and ``bpc`` per utterance, averaged); ``acc`` exact;
``SpecPredTask.infer``'s autoregressive rollout within 1e-5 relative to its
largest entry; ``sliding_windows`` and the hyper-parameters exact.  Each
CLI subcommand trains one epoch with ``--device cpu`` and writes a
checkpoint from which the task rebuilds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks import extras as jtasks
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli import main_extras
from speechlid_tpu_torch.core.checkpoint import load_checkpoint
from speechlid_tpu_torch.tasks import extras as ptasks
from tests.torch_parity import one_thread, port_drawn  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REL = 1e-5


def pair(jcls, pcls, seed=0, **hp):
    ptask = pcls(**hp, device="cpu")
    model = ptask.model
    variables = port_drawn(model, seed, lambda sd: convert.extras_variables(sd, model),
                           lambda v: convert.extras_state(v, model))
    return jcls(**hp), variables, ptask


def lm_batch(seed=0, vocab=17):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (4, 9)).astype(np.int32)
    lengths = np.array([9, 6, 2, 1], np.int32)  # 1: no target at all
    ids[np.arange(9)[None, :] >= lengths[:, None]] = 0
    return {"ids": ids, "lengths": lengths}


def assert_metrics_close(got, want, keys):
    for key in keys:
        g = float(got[key].detach() if isinstance(got[key], torch.Tensor) else got[key])
        w = float(want[key])
        if key == "acc":
            assert g == w, key
        else:
            assert abs(g - w) <= REL * max(abs(w), 1e-30), (key, g, w)


def test_lm_task_nll_ppl_bpc_match_jax():
    jtask, variables, ptask = pair(jtasks.LMTask, ptasks.LMTask, vocab_size=17,
                                   embedding_dim=8, hidden_size=6)
    batch = lm_batch()
    want = jax.jit(jtask.val_loop)(variables, batch)
    got = ptask.val_loop(ptask.place_batch(batch))
    assert_metrics_close(got, want, ("loss", "ppl", "bpc"))
    loss, metrics = ptask.train_loop(ptask.place_batch(batch))
    jloss, jmetrics, _ = jax.jit(lambda v, b: jtask.train_loop(v, b, {}))(variables, batch)
    assert_metrics_close(dict(metrics, loss=loss), dict(jmetrics, loss=jloss),
                         ("loss", "ppl", "bpc"))
    assert ptask.hyper_parameters == jtask.hyper_parameters


@pytest.mark.parametrize("use_snr", [False, True])
def test_rml_task_matches_jax(use_snr):
    hp = dict(n_classes=4, base_filters=4, kernel_size=8, n_blocks=3, use_rnn=use_snr,
              use_snr_info=use_snr, snr_loss_weight=0.3)
    jtask, variables, ptask = pair(jtasks.RMLTask, ptasks.RMLTask, **hp)
    rng = np.random.RandomState(1)
    batch = {"iq": rng.randn(5, 32, 2).astype(np.float32),
             "label": rng.randint(0, 4, 5).astype(np.int32),
             "snr": rng.uniform(-10, 10, 5).astype(np.float32)}
    want = jax.jit(jtask.val_loop)(variables, batch)
    got = ptask.val_loop(ptask.place_batch(batch))
    assert_metrics_close(got, want, ("loss", "acc"))
    assert ptask.hyper_parameters == jtask.hyper_parameters


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_spec_pred_task_matches_jax(loss_type):
    hp = dict(model_name="mlp", feat_dim=3, win_len=6, loss_type=loss_type,
              model_conf={"hidden": 7})
    jtask, variables, ptask = pair(jtasks.SpecPredTask, ptasks.SpecPredTask, **hp)
    rng = np.random.RandomState(2)
    batch = {"x": rng.randn(5, 6, 3).astype(np.float32), "y": rng.randn(5, 3).astype(np.float32)}
    assert_metrics_close(ptask.val_loop(ptask.place_batch(batch)),
                         jax.jit(jtask.val_loop)(variables, batch), ("loss", "l1"))
    loss, _ = ptask.train_loop(ptask.place_batch(batch))
    jloss, _, _ = jax.jit(lambda v, b: jtask.train_loop(v, b, {}))(variables, batch)
    assert_metrics_close({"loss": loss}, {"loss": jloss}, ("loss",))
    assert ptask.hyper_parameters == jtask.hyper_parameters


@pytest.mark.parametrize("model_name, conf", [("mlp", {"hidden": 7}),
                                              ("transformer", {"d_model": 8, "heads": 2,
                                                               "layers": 1})])
def test_spec_pred_infer_rollout_matches_jax(model_name, conf):
    hp = dict(model_name=model_name, feat_dim=3, win_len=6, model_conf=conf)
    jtask, variables, ptask = pair(jtasks.SpecPredTask, ptasks.SpecPredTask, **hp)
    series = np.random.RandomState(3).randn(40, 3).astype(np.float32) * 5 + 2
    x, _, mean, std = ptasks.sliding_windows(series, 6)
    for task in (jtask, ptask):
        task.set_normalization(mean, std)
    want = jtask.infer(variables, x[:4, :, :], pred_len=5)
    got = ptask.infer(x[:4, :, :], pred_len=5)
    assert got.shape == want.shape == (4, 5, 3)
    assert float(np.abs(got - want).max()) <= REL * float(np.abs(want).max())


def test_image_task_matches_jax():
    jtask, variables, ptask = pair(jtasks.ImageClassificationTask,
                                   ptasks.ImageClassificationTask, num_classes=10)
    rng = np.random.RandomState(4)
    batch = (rng.rand(6, 8, 8, 1).astype(np.float32), rng.randint(0, 10, 6).astype(np.int32))
    assert_metrics_close(ptask.val_loop(ptask.place_batch(batch)),
                         jax.jit(jtask.val_loop)(variables, batch), ("loss", "acc"))
    hp = dict(ptask.hyper_parameters)
    assert {k: hp.pop(k) for k in ("height", "width", "in_channels")} == dict(
        height=8, width=8, in_channels=1)
    assert hp == jtask.hyper_parameters


def test_sliding_windows_are_the_jax_windows():
    series = np.random.RandomState(5).randn(30, 4).astype(np.float32)
    for normalize in (True, False):
        for g, w in zip(ptasks.sliding_windows(series, 7, normalize),
                        jtasks.sliding_windows(series, 7, normalize)):
            np.testing.assert_array_equal(g, w)


def write_text(path, n=60, seed=0):
    rng = np.random.RandomState(seed)
    words = "a b c d e f g h".split()
    path.write_text("\n".join(" ".join(rng.choice(words, rng.randint(4, 9)))
                              for _ in range(n)))
    return path


def _common(tmp_path, name):
    return ["--epochs", "1", "--device", "cpu", "--no-progress",
            "--ckpt-dir", str(tmp_path / name)]


def _rebuilds(trainer, cls, tmp_path, name):
    task, _ = cls.resume_from_checkpoint(str(tmp_path / name / "last.ckpt"), device="cpu")
    for key, p in trainer.module.model.state_dict().items():
        assert torch.equal(p, task.model.state_dict()[key]), key


def test_main_extras_lm_and_rml(tmp_path):
    corpus = write_text(tmp_path / "wiki.txt")
    trainer = main_extras.main(["lm", "--data", str(corpus), "--batch-size", "8",
                                "--embedding-dim", "8", "--hidden-size", "8", "--max-len", "12",
                                *_common(tmp_path, "lm")])
    assert trainer.global_step == 8 - 1  # 8 batches, one validates
    _rebuilds(trainer, ptasks.LMTask, tmp_path, "lm")
    rng = np.random.RandomState(1)
    data = tmp_path / "rml.npz"
    np.savez(data, iq=rng.randn(20, 64, 2).astype(np.float32),
             label=rng.randint(0, 3, 20), snr=rng.uniform(-5, 5, 20))
    trainer = main_extras.main(["rml", "--data", str(data), "--batch-size", "6", "--use-snr",
                                "--use-rnn", *_common(tmp_path, "rml")])
    assert trainer.global_step == 3 and trainer.module.use_snr_info
    assert load_checkpoint(str(tmp_path / "rml" / "last.ckpt"))["hyper_parameters"][
        "n_classes"] == 3
    _rebuilds(trainer, ptasks.RMLTask, tmp_path, "rml")


def test_main_extras_spec_pred_and_image(tmp_path):
    series = tmp_path / "spec.npy"
    np.save(series, np.random.RandomState(2).randn(60, 5).astype(np.int16))
    trainer = main_extras.main(["spec_pred", "--data", str(series), "--model", "causal_conv",
                                "--win-len", "8", "--batch-size", "16", "--loss", "l1",
                                *_common(tmp_path, "spec")])
    assert trainer.global_step == 3  # 52 windows: 46 train
    _rebuilds(trainer, ptasks.SpecPredTask, tmp_path, "spec")
    pytest.importorskip("sklearn")
    trainer = main_extras.main(["image", "--batch-size", "128", *_common(tmp_path, "image")])
    assert trainer.global_step == 13  # 1617 of sklearn's 1797 digits train
    _rebuilds(trainer, ptasks.ImageClassificationTask, tmp_path, "image")
