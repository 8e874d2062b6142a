"""Data parallelism in the port (``speechlid_tpu_torch/parallel``,
``metrics/dist.py``, the global BatchNorm statistics, the trainer and the
CLI) on two gloo ranks on the CPU, each a subprocess of
``tests/torch_dist_ranks.py`` with a 60 s group timeout and a ``file://``
rendezvous under the test's own directory.

- ``allgather_rows`` over uneven rows and ``allreduce_sum_counts``; EER,
  Cavg, accuracy and WER after ``sync()`` equal one process over all the
  rows (1e-12);
- ``MaskedBatchNorm`` (with and without a mask) and ``flax_batch_norm``:
  each rank's output, running statistics and input gradient, and the sum of
  the ranks' parameter gradients, equal one process over the concatenated
  batch within 1e-6 (atol and rtol); the same layers with each rank's own statistics (the
  control) miss that bar;
- ``Trainer.fit`` with ``mesh=make_mesh()``: 2 ranks × 2 utterances for 2
  steps against the JAX ``Trainer(mesh=make_mesh(data=2))`` on the
  4-utterance global batches (the tiny joint task with dropout,
  stochastic depth, SpecAugment and stretch off, weights drawn on the
  port's side): every parameter and BatchNorm statistic within 1e-4 (the
  Adam band of ``tests/test_torch_trainer.py`` for the leaves whose true
  gradient is zero), the step losses within 2e-4 of JAX's global ones on
  average over the ranks and on each rank (every rank logs the global
  batch's loss), the validation metrics equal (the loss 1e-4,
  the rest 1e-9), and the ranks bit-equal; with each rank's own BatchNorm
  statistics (the control) the state misses 1e-4;
- ``main_lid`` with ``trainer.data_parallel=true`` at world size 2: equal
  parameters on both ranks, and only rank 0 writes ``ckpt/`` and
  ``metrics.jsonl`` (the world-1 run, bit-equal to the run without the key,
  is in ``tests/test_torch_cli.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.core import Trainer as JaxTrainer
from speechlid_tpu.core.callbacks import Callback as JaxCallback
from speechlid_tpu.data.tokenizer import CTCTokenizer as JaxTokenizer
from speechlid_tpu.parallel import make_mesh as jax_make_mesh
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.metrics import CAvg, EER, Accuracy, WordErrorRate
from speechlid_tpu_torch.models.batchnorm import flax_batch_norm
from speechlid_tpu_torch.models.conformer import MaskedBatchNorm
from speechlid_tpu_torch.parallel import make_mesh, process_count, process_index
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_trainer import DETERMINISTIC, HPARAMS, assert_variables_close
from tests.torch_parity import port_drawn, random_batch_stats

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
RANK_TIMEOUT = 240  # s: a rank that hangs fails the test
BN_TOL = 1e-6
TOL, LOSS_TOL = 1e-4, 2e-4
VOCABS = {"aa": list("abcde"), "bb": list("abcdefghi"), "cc": list("abcdefg")}


def start_ranks(job: str, root: Path, inputs: dict, world: int = WORLD) -> list:
    root.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, root / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "SPEECHLID_SHARD_ID", "SPEECHLID_NUM_SHARDS")}
    env.update(OMP_NUM_THREADS="1", SPEECHLID_CACHE_DIR=str(root / "cache"))
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_ranks", job, str(r),
                              str(world), str(root)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish_ranks(procs: list, root: Path) -> list:
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def run_ranks(job: str, root: Path, inputs: dict, world: int = WORLD) -> list:
    return finish_ranks(start_ranks(job, root, inputs, world), root)


# ---------------------------------------------------------------- collectives

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    rng = np.random.RandomState(0)
    b, t, c = 4, 10, 6
    lengths = np.array([10, 7, 4, 9])
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(0.3 * rng.randn(c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(0.2 * rng.randn(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    f32 = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))  # noqa: E731
    inputs = {
        # rows that differ by rank, so that local statistics are not global ones
        "bn_x": f32(b, t, c) * 2.0 + torch.arange(b, dtype=torch.float32)[:, None, None],
        "bn_mask": torch.from_numpy(np.arange(t)[None, :] < lengths[:, None]),
        "bn_cot": f32(b, t, c), "bn_state": bn.state_dict(),
        "fbn_x": f32(b, 5, 7) + torch.arange(b, dtype=torch.float32)[:, None, None],
        "fbn_cot": f32(b, 5, 7), "fbn_weight": 1.0 + 0.3 * f32(5), "fbn_bias": 0.3 * f32(5),
        "fbn_mean": 0.2 * f32(5), "fbn_var": 1.0 + 0.3 * f32(5).abs(),
        "scores": rng.rand(8, 3), "langs": rng.randint(0, 3, 8),
        "hyps": ["a b c", "a", "b b", "c a", "a b", "", "c", "a c b"],
        "refs": ["a b", "a c", "b b", "c", "a b b", "c c", "c", "a c"],
    }
    return inputs, run_ranks("collectives", tmp_path_factory.mktemp("collectives"), inputs)


def test_allgather_rows_and_sum_counts(collectives):
    _, ranks = collectives
    for out in ranks:
        np.testing.assert_array_equal(out["gathered"], np.array([[0.0] * 3, [1.0] * 3, [1.0] * 3]))
        np.testing.assert_array_equal(out["empty"], np.ones((2, 2)))
        assert out["counts"] == (3.0, 10.0)


@pytest.mark.parametrize("name", ["eer", "cavg", "acc", "wer"])
def test_metric_sync_equals_one_process(collectives, name):
    inputs, ranks = collectives
    metric = {"eer": EER(3), "cavg": CAvg(3), "acc": Accuracy(), "wer": WordErrorRate()}[name]
    if name == "wer":
        metric.update(inputs["hyps"], inputs["refs"])
    else:
        metric.update(inputs["scores"], inputs["langs"])
    want = metric.compute()
    for out in ranks:
        assert abs(out["metrics"][name] - want) <= 1e-12, (name, out["metrics"][name], want)
    assert 0.0 < want < 1.0


def one_process_masked_bn(inputs, case):
    x = inputs["bn_x"].clone().requires_grad_(True)
    bn = MaskedBatchNorm(x.shape[-1])
    bn.load_state_dict(inputs["bn_state"])
    bn.train()
    y = bn(x, inputs["bn_mask"] if case == "mask" else None)
    (y * inputs["bn_cot"]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def one_process_flax_bn(inputs):
    x = inputs["fbn_x"].clone().requires_grad_(True)
    weight = inputs["fbn_weight"].clone().requires_grad_(True)
    bias = inputs["fbn_bias"].clone().requires_grad_(True)
    mean, var = inputs["fbn_mean"].clone(), inputs["fbn_var"].clone()
    y = flax_batch_norm(x, mean, var, weight, bias, training=True, dim=1)
    (y * inputs["fbn_cot"]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": weight.grad, "dbias": bias.grad,
            "running_mean": mean, "running_var": var}


def bn_gap(ranks: list, key, want: dict) -> dict:
    """The largest |rank − one process| / (1 + |one process|) of each
    quantity (so a gap within 1e-6 is atol = rtol = 1e-6): the ranks' rows
    for the output and the input gradient, the ranks' sum for the parameter
    gradients, each rank's running statistics."""
    def gap(got, ref):
        return float(((got - ref).abs() / (1.0 + ref.abs())).max())

    gaps = {}
    for name, ref in want.items():
        if name in ("y", "dx"):
            gaps[name] = gap(torch.cat([key(out)[name] for out in ranks]), ref)
        elif name in ("dweight", "dbias"):
            gaps[name] = gap(sum(key(out)[name] for out in ranks), ref)
        else:
            gaps[name] = max(gap(key(out)[name], ref) for out in ranks)
    return gaps


@pytest.mark.parametrize("case", ["mask", "no_mask"])
def test_masked_batch_norm_synced_equals_concatenated_batch(collectives, case):
    inputs, ranks = collectives
    gaps = bn_gap(ranks, lambda out: out["masked_bn"][case], one_process_masked_bn(inputs, case))
    assert max(gaps.values()) <= BN_TOL, gaps


def test_flax_batch_norm_synced_equals_concatenated_batch(collectives):
    inputs, ranks = collectives
    gaps = bn_gap(ranks, lambda out: out["flax_bn"], one_process_flax_bn(inputs))
    assert max(gaps.values()) <= BN_TOL, gaps


def test_unsynced_statistics_miss_the_bar(collectives):
    """The control: each rank's own statistics are not the global batch's."""
    inputs, ranks = collectives
    for case in ("mask", "no_mask"):
        gaps = bn_gap(ranks, lambda out: out["masked_bn_local"][case],
                      one_process_masked_bn(inputs, case))
        assert min(gaps[k] for k in ("y", "dx", "running_mean", "running_var")) > 100 * BN_TOL, \
            (case, gaps)
    gaps = bn_gap(ranks, lambda out: out["flax_bn_local"], one_process_flax_bn(inputs))
    assert min(gaps[k] for k in ("y", "dx", "running_mean", "running_var")) > 100 * BN_TOL, gaps


def test_one_process_is_a_mesh_of_one():
    assert process_index() == 0 and process_count() == 1
    assert make_mesh().shape == {"data": 1, "model": 1}
    # the model axis is ported (tests/test_torch_tp_trainer.py): one process
    # cannot hold a model axis of two
    with pytest.raises(ValueError, match="multiple of 2 processes"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match="one process per card"):
        make_mesh(data=2)


# -------------------------------------------------------------------- trainer

def global_batch(rng, lang, t=16000, s=6):
    vocab = HPARAMS["lang2vocab"][sorted(HPARAMS["lang2index"])[lang]]
    return {
        "wavs": (0.1 * rng.randn(4, t)).astype(np.float32),
        "wav_lengths": np.array([t, 12000, 9000, 14000], np.int32),
        "texts": rng.randint(0, vocab, (4, s)).astype(np.int32),
        "text_lengths": np.array([6, 4, 3, 5], np.int32),
        "langs": np.full(4, lang, np.int32),
        "n_valid": np.int32(0),
    }


class _JaxRecorder(JaxCallback):
    def __init__(self):
        super().__init__()
        self.evals, self.losses = [], []

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])

    def after_eval_epoch(self, epoch, metrics):
        self.evals.append(dict(metrics))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    hp = dict(HPARAMS, **DETERMINISTIC)
    rng = np.random.RandomState(11)
    train = [global_batch(rng, 0), global_batch(rng, 1)]
    val = [global_batch(rng, 0), global_batch(rng, 2)]
    ptask = LidASRTask(**hp, device="cpu")
    variables = port_drawn(ptask.model, 5, convert.lid_variables, convert.lid_state,
                           adjust=random_batch_stats)
    root = tmp_path_factory.mktemp("trainer")
    procs = start_ranks("trainer", root, {"hparams": hp, "vocabs": VOCABS,
                                          "state": ptask.model.state_dict(),
                                          "train": train, "val": val})
    try:  # the JAX trainer on the global batches while the ranks run
        jtask = JaxLidASRTask(**hp, tokenizers={k: JaxTokenizer(v) for k, v in VOCABS.items()})
        jtask.init_variables = lambda key, sample: jax.tree_util.tree_map(jnp.asarray, variables)
        rec = _JaxRecorder()
        trainer = JaxTrainer(total_epoch=1, use_progress_bar=False, callbacks=[rec],
                             mesh=jax_make_mesh(data=WORLD, devices=jax.devices()[:WORLD]))
        trainer.fit(jtask, train, val)
        state = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state))
        jax_final = {"params": state.params, "batch_stats": state.model_state["batch_stats"]}
    finally:
        ranks = finish_ranks(procs, root)
    return rec, jax_final, ranks


def test_trainer_two_ranks_match_the_jax_mesh_trainer(trainer_runs):
    rec, jax_final, ranks = trainer_runs
    synced = [out["synced"] for out in ranks]
    assert [out["steps"] for out in synced] == [2, 2]
    # the ranks hold the same bits
    for name, value in synced[0]["state"].items():
        assert torch.equal(value, synced[1]["state"][name]), name
    got = convert.lid_variables(synced[0]["state"])
    assert_variables_close(got, jax_final, synced[0]["lr_sum"])
    # each rank's loss is its rows' mean: their average is the global batch's
    losses = np.mean([out["losses"] for out in synced], axis=0)
    assert np.abs(losses - np.array(rec.losses)).max() <= LOSS_TOL, (losses, rec.losses)
    (want,), (got_0,), (got_1,) = rec.evals, synced[0]["evals"], synced[1]["evals"]
    assert got_0 == got_1  # every rank computes the synced metrics
    assert set(got_0) == set(want)
    assert abs(got_0["avg_val_loss"] - want["avg_val_loss"]) <= TOL
    for key in ("val_acc", "val_wer", "eer", "cavg", "eer_true", "cavg_true"):
        assert abs(got_0[key] - want[key]) <= 1e-9, (key, got_0[key], want[key])


def test_logged_train_loss_is_the_global_batch(trainer_runs):
    """Every rank logs the global batch's loss, the mean of the data
    group's, as the JAX trainer logs it (not its own rows')."""
    rec, _, ranks = trainer_runs
    for out in ranks:
        got = np.asarray(out["synced"]["losses"])
        assert np.abs(got - np.array(rec.losses)).max() <= LOSS_TOL, (got, rec.losses)
    assert ranks[0]["synced"]["losses"] == ranks[1]["synced"]["losses"]


def test_trainer_with_unsynced_statistics_misses_jax(trainer_runs):
    """The control: the same run with each rank's own BatchNorm statistics
    leaves the running statistics well outside the bar."""
    _, jax_final, ranks = trainer_runs
    local = ranks[0]["local"]
    got = convert.lid_variables(local["state"])
    with pytest.raises(AssertionError):
        assert_variables_close(got, jax_final, local["lr_sum"])
    def bn_var(tree):
        return tree["batch_stats"]["featurizer"]["block_0"]["conv"]["bn"]["var"]

    assert np.abs(bn_var(got) - bn_var(jax_final)).max() > 10 * TOL


# ------------------------------------------------------------------------ cli

def write_corpus(root: Path) -> Path:
    """Two languages of five tones each, as ``tests/test_torch_cli.py``'s."""
    from speechlid_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(0)
    texts = {"aa": ["ba ba", "ab", "a b"], "bb": ["cd cd", "dc", "c"]}
    for li, (lang, txts) in enumerate(sorted(texts.items())):
        wav_dir = root / lang / "wav" / "train"
        wav_dir.mkdir(parents=True)
        lines = []
        for i in range(5):
            t = np.arange(int(16000 * (0.4 + 0.15 * i))) / 16000
            wav = (np.sin(2 * np.pi * (150 + 200 * li) * t)
                   + 0.01 * rng.randn(len(t))).astype(np.float32) * 0.3
            write_wav(str(wav_dir / f"u{i}.wav"), wav, 16000)
            lines.append(f"u{i}.wav\t{txts[i % len(txts)]}")
        (root / lang / "train.txt").write_text("\n".join(lines))
        (root / lang / "val.txt").write_text("\n".join(lines[:3]))
    return root


def test_main_lid_data_parallel_two_ranks(tmp_path):
    from tests.test_torch_cli import TINY, _langs

    corpus_root = write_corpus(tmp_path / "corpus")
    exp = [tmp_path / "exp0", tmp_path / "exp1"]
    args = ["--config-dir", "configs", "--config-name", "lid_supervised", _langs(corpus_root),
            *TINY, "trainer.data_parallel=true"]
    ranks = run_ranks("cli", tmp_path / "ranks", {"args": args,
                                                  "exp_dirs": [str(p) for p in exp]})
    assert [out["mesh"] for out in ranks] == [{"data": 2, "model": 1}] * 2
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name
    assert (exp[0] / "ckpt" / "last.ckpt").exists() and (exp[0] / "metrics.jsonl").exists()
    assert not exp[1].exists() or sorted(os.listdir(exp[1])) == []
    saved = torch.load(exp[0] / "ckpt" / "last.ckpt", weights_only=True)["state"]
    assert len(saved["device_generators"]) == 2
    assert not torch.equal(saved["device_generators"][0], saved["device_generators"][1])
    for name, value in saved["model"].items():
        assert torch.equal(value, ranks[0]["state"][name]), name
