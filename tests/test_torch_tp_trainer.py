"""Tensor and expert parallelism in training (``Trainer(param_rules=…)``,
``main_lid trainer.model_parallel``), gloo ranks on the CPU, each a
subprocess of ``tests/torch_dist_ranks.py``.

- ``Trainer.fit`` of the tiny joint task with four languages (so the
  heads split one language axis over two ranks) and
  ``EP_RULES + CONFORMER_TP_RULES``, two steps on a (1, 2) mesh and two
  epochs on a (2, 2) mesh, against the JAX ``Trainer(mesh, param_rules)``
  on the same mesh and global batches: every parameter and BatchNorm
  statistic of the gathered state within 1e-4 with the Adam band of
  ``tests/test_torch_trainer.py``, every rank's logged loss within
  ``tests/test_multihost.py``'s bar (rtol 2e-4, atol 1e-5) of JAX's (the
  global batch's), the validation metrics equal (the loss within the same
  bar, since the state it reads differs within Adam's band; the rest
  1e-9), the layout reported alike on every rank;
- the (2, 2) run's checkpoint after its first epoch is the full state:
  one process resumes from it and takes the second epoch's steps within
  that bar of the four ranks' losses, its
  state within the Adam band of theirs;
- the control: on (2, 2) with tp alone, BatchNorm statistics reduced over
  the world (where a model group's ranks hold the same rows) instead of the
  data group miss 1e-4;
- Novograd under tp (its second moment a norm over each whole leaf) on a
  (1, 2) mesh against the port's one process within 1e-5 (atol and rtol),
  with ``assert_variables_close``'s exceptions: a leaf whose true gradient
  is zero (a depthwise bias before a train-mode BatchNorm) is normalised
  rounding noise, held to the most Novograd moves an element in either
  direction, 2 Σ_t lr Σ_{k≤t} 0.95^k;
- ``main_lid`` with ``trainer.model_parallel=2`` on two ranks (two
  languages: ep with one head a rank): it trains and validates, only rank 0
  writes, the checkpoint holds the full state the ranks gather, and
  ``cli/serve`` serves it in one process."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.core import Trainer as JaxTrainer
from speechlid_tpu.data.tokenizer import CTCTokenizer as JaxTokenizer
from speechlid_tpu.parallel import (
    CONFORMER_TP_RULES as JAX_TP_RULES,
    EP_RULES as JAX_EP_RULES,
    make_mesh as jax_make_mesh,
)
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli.serve import build_lid_fn
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.data.tokenizer import CTCTokenizer
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_dist import (
    _JaxRecorder,
    finish_ranks,
    run_ranks,
    start_ranks,
    write_corpus,
)
from tests.test_torch_trainer import DETERMINISTIC, HPARAMS, _Losses, assert_variables_close
from tests.torch_parity import one_thread, port_drawn, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5  # tests/test_multihost.py's bar for losses
VOCABS = {"aa": list("abcde"), "bb": list("abcdefghi"), "cc": list("abcdefg"),
          "dd": list("abcdef")}
HP4 = dict(HPARAMS, **DETERMINISTIC, lang2vocab={k: len(v) for k, v in VOCABS.items()},
           lang2index={k: i for i, k in enumerate(sorted(VOCABS))})


def global_batch(rng, lang, t=16000, s=6):
    vocab = len(VOCABS[sorted(VOCABS)[lang]])
    return {
        "wavs": (0.1 * rng.randn(4, t)).astype(np.float32),
        "wav_lengths": np.array([t, 12000, 9000, 14000], np.int32),
        "texts": rng.randint(0, vocab, (4, s)).astype(np.int32),
        "text_lengths": np.array([6, 4, 3, 5], np.int32),
        "langs": np.full(4, lang, np.int32),
        "n_valid": np.int32(0),
    }


def jax_fit(variables, train, val, data, model, epochs=1):
    jtask = JaxLidASRTask(**HP4, tokenizers={k: JaxTokenizer(v) for k, v in VOCABS.items()})
    jtask.init_variables = lambda key, sample: jax.tree_util.tree_map(jnp.asarray, variables)
    rec = _JaxRecorder()
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    trainer = JaxTrainer(total_epoch=epochs, use_progress_bar=False, callbacks=[rec], mesh=mesh,
                         param_rules=JAX_EP_RULES + JAX_TP_RULES)
    trainer.fit(jtask, train, val)
    state = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state))
    return rec, {"params": state.params, "batch_stats": state.model_state["batch_stats"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(23)
    train = [global_batch(rng, 0), global_batch(rng, 3)]
    val = [global_batch(rng, 1), global_batch(rng, 2)]
    ptask = LidASRTask(**HP4, device="cpu")
    variables = port_drawn(ptask.model, 9, convert.lid_variables, convert.lid_state,
                           adjust=random_batch_stats)
    inputs = {"hparams": HP4, "vocabs": VOCABS, "state": ptask.model.state_dict(),
              "train": train, "val": val, "model": 2}
    root = tmp_path_factory.mktemp("tp_fit")
    ckpt_dirs = [str(root / f"ckpt{r}") for r in range(4)]
    procs = {"1x2": start_ranks("tp_fit", root / "1x2", inputs, world=2),
             "2x2": start_ranks("tp_fit", root / "2x2", dict(
                 inputs, epochs=2, ckpt_dirs=ckpt_dirs, control=True), world=4)}
    try:
        jax_runs = {"1x2": jax_fit(variables, train, val, 1, 2),
                    "2x2": jax_fit(variables, train, val, 2, 2, epochs=2)}
    finally:
        ranks = {k: finish_ranks(p, root / k) for k, p in procs.items()}
    return {"train": train, "val": val, "state": inputs["state"], "jax": jax_runs,
            "ranks": ranks, "ckpt_dirs": ckpt_dirs}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_fit_matches_the_jax_mesh_trainer(runs, mesh):
    rec, want = runs["jax"][mesh]
    ranks = [out["run"] for out in runs["ranks"][mesh]]
    for out in ranks:  # every rank gathers the same whole state
        for name, value in ranks[0]["state"].items():
            assert torch.equal(out["state"][name], value), name
        assert out["report"] == ranks[0]["report"]
        np.testing.assert_allclose(out["losses"], rec.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert out["evals"] == ranks[0]["evals"]
    assert any(line.startswith("heads/heads/") for line in ranks[0]["report"])
    assert any("ff1/Dense_0/kernel" in line for line in ranks[0]["report"])
    assert_variables_close(convert.lid_variables(ranks[0]["state"]), want, ranks[0]["lr_sum"])
    assert len(ranks[0]["evals"]) == len(rec.evals)
    for got, exp in zip(ranks[0]["evals"], rec.evals):
        assert set(got) == set(exp)
        np.testing.assert_allclose(got["avg_val_loss"], exp["avg_val_loss"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        for key in ("val_acc", "val_wer", "eer", "cavg", "eer_true", "cavg_true"):
            assert abs(got[key] - exp[key]) <= 1e-9 or (np.isnan(got[key]) and np.isnan(exp[key]))


def test_world_statistics_control_misses(runs):
    """BatchNorm over the world counts a model group's rows twice: the
    one-epoch control misses the one-epoch run over the same global
    batches."""
    control = runs["ranks"]["2x2"][0]["control"]
    with pytest.raises(AssertionError):
        assert_variables_close(convert.lid_variables(control["state"]),
                               runs["jax"]["1x2"][1], control["lr_sum"])
    one_epoch = runs["ranks"]["1x2"][0]["run"]  # one epoch, the same global batches
    got = convert.lid_variables(control["state"])
    ref = convert.lid_variables(one_epoch["state"])
    bn_var = lambda tree: tree["batch_stats"]["featurizer"]["block_0"]["conv"]["bn"]["var"]  # noqa: E731
    assert np.abs(bn_var(got) - bn_var(ref)).max() > 10 * TOL


def test_checkpoint_at_2x2_resumes_in_one_process(runs, tmp_path):
    ranks = [out["run"] for out in runs["ranks"]["2x2"]]
    ckpt_dir = runs["ckpt_dirs"][0]
    assert not any(os.path.exists(d) for d in runs["ckpt_dirs"][1:])  # rank 0 writes
    (first,) = [f for f in os.listdir(ckpt_dir) if f.startswith("epoch_0_")]
    saved = torch.load(os.path.join(ckpt_dir, first), weights_only=False)["state"]
    assert saved["model"].keys() == runs["state"].keys()  # whole, not a rank's slices
    assert set(saved["optimizer"]["mu"]) == {n for n in runs["state"] if "running" not in n}
    task = LidASRTask(**HP4, tokenizers={k: CTCTokenizer(v) for k, v in VOCABS.items()},
                      device="cpu")
    rec = _Losses()
    trainer = Trainer(total_epoch=2, use_progress_bar=False, device="cpu", callbacks=[rec],
                      checkpoint_path=os.path.join(ckpt_dir, first))
    trainer.fit(task, runs["train"], runs["val"])
    assert trainer.start_epoch == 1 and len(rec.losses) == 2
    np.testing.assert_allclose(rec.losses, ranks[0]["losses"][2:], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert_variables_close(convert.lid_variables(convert.full_state(task.model)),
                           convert.lid_variables(ranks[0]["state"]), ranks[0]["lr_sum"])


# ----------------------------------------------------------------- novograd

def test_novograd_under_tp_matches_one_process(tmp_path):
    hp = dict(HP4, optimizer="novograd", schedule=None, lr=5e-3)
    rng = np.random.RandomState(29)
    train = [global_batch(rng, 1), global_batch(rng, 2), global_batch(rng, 1)]
    ptask = LidASRTask(**hp, device="cpu")
    port_drawn(ptask.model, 13, convert.lid_variables, convert.lid_state,
               adjust=random_batch_stats)
    state = {k: v.clone() for k, v in ptask.model.state_dict().items()}
    ranks = run_ranks("tp_fit", tmp_path / "ranks", {
        "hparams": hp, "vocabs": VOCABS, "state": state, "train": train, "val": [],
        "model": 2}, world=2)
    ptask.init_parameters = lambda generator: None
    Trainer(total_epoch=1, use_progress_bar=False, device="cpu").fit(ptask, train)
    want = ptask.model.state_dict()
    # a normalised element moves mu by at most 1 a step, so the update of step
    # t by at most lr · Σ_{k<=t} β1^k; two runs of opposite signs part by twice
    band = 2.0 * sum(5e-3 * sum(0.95 ** k for k in range(t + 1)) for t in range(len(train)))
    for out in ranks:
        assert_variables_close(convert.lid_variables(out["run"]["state"]),
                               convert.lid_variables(want), band, tol=1e-5)
    assert any(not torch.equal(state[n], want[n]) for n in want)  # it trained


# ---------------------------------------------------------------------- cli

def test_main_lid_model_parallel_two_ranks(tmp_path):
    from tests.test_torch_cli import TINY, _langs

    corpus_root = write_corpus(tmp_path / "corpus")
    exp = [tmp_path / "exp0", tmp_path / "exp1"]
    args = ["--config-dir", "configs", "--config-name", "lid_supervised", _langs(corpus_root),
            *TINY, "trainer.model_parallel=2"]
    ranks = run_ranks("cli", tmp_path / "ranks", {"args": args,
                                                  "exp_dirs": [str(p) for p in exp]})
    assert [out["mesh"] for out in ranks] == [{"data": 1, "model": 2}] * 2
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    assert ranks[0]["report"] == ranks[1]["report"]
    assert any(line.startswith("heads/heads/") for line in ranks[0]["report"])  # ep
    for name, value in ranks[0]["full_state"].items():
        assert torch.equal(value, ranks[1]["full_state"][name]), name
    assert (exp[0] / "ckpt" / "last.ckpt").exists() and (exp[0] / "metrics.jsonl").exists()
    assert not exp[1].exists() or sorted(os.listdir(exp[1])) == []
    saved = torch.load(exp[0] / "ckpt" / "last.ckpt", weights_only=True)["state"]
    assert saved["model"].keys() == ranks[0]["full_state"].keys()
    for name, value in saved["model"].items():
        assert torch.equal(value, ranks[0]["full_state"][name]), name
    with open(exp[0] / "metrics.jsonl") as f:
        lines = [line for line in f if '"eer"' in line]
    assert lines and '"cavg"' in lines[-1] and '"val_acc"' in lines[-1]
    lid_fn, index2lang = build_lid_fn(str(exp[0] / "ckpt" / "last.ckpt"), device="cpu")
    scores = lid_fn((0.01 * np.random.RandomState(0).randn(1, 8000)).astype(np.float32), 8000)
    assert set(index2lang.values()) == {"aa", "bb"}
    assert scores.shape == (1, 2) and np.isfinite(scores).all()
