"""The port's offline eval CLI (``speechlid_tpu_torch/cli/test_lid.py``)
against the JAX package's, on a tiny 2-language corpus on the CPU, from one
checkpoint written by the JAX package (seeded ``init_variables`` with random
BatchNorm statistics, 1 block × 32-d).

- one clean cell with ``--csv`` and ``--submission``, and ``--sweep`` with
  ``--noise-dir`` (white, babble): the printed results, the sweep rows, the
  CSV records and the submission file agree: ``pred_lang``, ``hyp``,
  ``acc``, ``cer`` and ``lm_arbitrated`` equal, ``eer``, ``cavg``,
  ``eer_true``, ``cavg_true`` and scores within 1e-4;
- with ``--lm-dir``, ``--kenlm-threshold`` is taken from the JAX CLI's
  margins of every cell, in a gap that leaves each at least 1e-3 away (see
  ``tests/test_torch_eval.py``), and the gap is asserted;
- ``--quant int8`` scores one clean cell through the int8 engine as the
  JAX CLI does: ``pred_lang`` and ``acc`` equal, the scores within
  ``QUANT_TOL`` (an int8 code that one float32 ulp upstream flips moves a
  score by a step of its scale; ``tests/test_torch_quant_task.py`` counts
  the flips); a bad ``--factor-sweep`` exits in argparse, and without ``--device`` on a
  machine with no card the run fails and writes nothing; ``--se-ckpt`` and
  the factor sweep are held in ``tests/test_torch_se.py``."""

import contextlib
import csv
import io
import json

import jax
import numpy as np
import pytest
import torch

import speechlid_tpu.eval.harness as jax_harness
from speechlid_tpu.cli import main_lid as jax_main_lid
from speechlid_tpu.cli import test_lid as jax_test_lid
from speechlid_tpu.core.checkpoint import save_checkpoint
from speechlid_tpu.core.config import load_config as jax_load_config
from speechlid_tpu_torch.cli import test_lid
from speechlid_tpu_torch.data import write_wav
from tests.torch_parity import one_thread, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
TOL = 1e-4
GAP = 1e-3
WORDS = {"aa": ["ab", "ba", "a", "bab"], "bb": ["cd", "dc", "d", "cdc"]}
TINY = ["module.n_blocks=1", "module.encoder_dim=32", "module.heads=2", "module.dim_head=16",
        "module.head_dim_head=8", "module.head_num_head=2", "data.batch_size=3",
        "data.buckets_s=[0.5, 1.0]", "module.schedule=null"]
# |Δscore| between the two CLIs' int8 runs (measured 6.5e-4, against 1.6e-3
# between the port's int8 and exact runs: at 32-d one flipped code is a large step)
QUANT_TOL = 2e-3
EQUAL = ("acc", "cer", "n_utts", "lm_arbitrated", "snr", "noise")
CLOSE = ("eer", "cavg", "eer_true", "cavg_true")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus, noises, LMs, config overrides and the JAX checkpoint."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch_test_lid")
    mp.setenv("SPEECHLID_CACHE_DIR", str(root / "cache"))
    rng = np.random.RandomState(0)
    langs = []
    for li, (lang, words) in enumerate(sorted(WORDS.items())):
        wav_dir = root / lang / "wav" / "train"
        wav_dir.mkdir(parents=True)
        lines = []
        for i in range(7):
            t = np.arange(int(SR * (0.3 + 0.1 * i))) / SR
            wav = 0.4 * np.sin(2 * np.pi * (180 + 170 * li) * t) + 0.05 * rng.randn(len(t))
            write_wav(str(wav_dir / f"u{i}.wav"), wav.astype(np.float32), SR)
            lines.append(f"u{i}.wav\t{words[i % 4]} {words[(i + 2) % 4]}")
        (root / lang / "train.txt").write_text("\n".join(lines))
        (root / lang / "val.txt").write_text("\n".join(lines[1:]))
        langs.append(f"{{manifest: {root / lang / 'train.txt'}, "
                     f"val_manifest: {root / lang / 'val.txt'}}}")
        logp = np.log10(1.0 / (len(words) + 1))
        (root / "lms").mkdir(exist_ok=True)
        (root / "lms" / f"{lang}.arpa").write_text("\n".join(
            ["\\data\\", f"ngram 1={len(words) + 3}", "", "\\1-grams:", "-3.00\t<unk>",
             f"{logp:.4f}\t<s>", f"{logp:.4f}\t</s>", *[f"{logp:.4f}\t{w}" for w in words],
             "", "\\end\\", ""]))
    (root / "noise").mkdir()
    for name in ("white", "babble"):
        write_wav(str(root / "noise" / f"{name}.wav"), (0.2 * rng.randn(SR)).astype(np.float32), SR)
    overrides = [*TINY, "data.langs=[" + ", ".join(langs) + "]"]

    jconf = jax_load_config("configs", "lid_supervised", overrides)
    jdata = jax_main_lid.build_data(jconf)
    jtask = jax_main_lid.build_task(jconf, jdata)
    sample = next(iter(jax_main_lid.build_feeder(jconf, jdata["val_dataset"], train=False)))
    variables = random_batch_stats(jtask.init_variables(jax.random.PRNGKey(3), sample), 3)
    ckpt = str(root / "jax.ckpt")
    save_checkpoint(ckpt, {"params": variables["params"],
                           "model_state": {"batch_stats": variables["batch_stats"]}},
                    {"hyper_parameters": jtask.hyper_parameters, "epoch": 0})
    yield dict(root=root, overrides=overrides, ckpt=ckpt)
    mp.undo()


def _base(world, *extra):
    return ["--ckpt", world["ckpt"], "--config-dir", "configs", "--config-name",
            "lid_supervised", *extra, *world["overrides"]]


@pytest.fixture(scope="module")
def runs(world):
    """Both CLIs: the sweep and one clean cell, with LM arbitration at a
    threshold clear of the JAX CLI's margins."""
    root, mp = world["root"], pytest.MonkeyPatch()
    margins = []

    def recording(scores):
        prob = jax_harness_normalize(scores)
        top = np.sort(prob, axis=-1)
        margins.extend((top[:, -1] - top[:, -2]).tolist())
        return prob

    jax_harness_normalize = jax_harness.normalize_scores
    mp.setattr(jax_harness, "normalize_scores", recording)
    noise = ["--noise-dir", str(root / "noise")]
    jax_test_lid.main(_base(world, "--sweep", *noise, "--csv", str(root / "m.jsonl")))
    mp.undo()
    clean = np.median(margins[:12])  # the sweep's first cell: 12 clips, no padded rows
    margins = np.unique(margins)
    mids = [(a + b) / 2 for a, b in zip(margins[:-1], margins[1:]) if b - a > 2 * GAP]
    threshold = min(mids, key=lambda m: abs(m - clean))
    lm = ["--lm-dir", str(root / "lms"), "--kenlm-threshold", repr(float(threshold))]

    out = {"threshold": threshold, "margins": margins}
    for side, main, extra in (("jax", jax_test_lid.main, []),
                              ("port", test_lid.main, ["--device", "cpu"])):
        sweep_path, cell_csv, sub = (str(root / f"{side}{x}")
                                     for x in (".jsonl", ".csv", ".sub"))
        printed_sweep = _run_printing(main, _base(world, "--sweep", *noise, *lm, "--csv",
                                                  sweep_path, *extra))
        printed_cell = _run_printing(main, _base(world, *lm, "--csv", cell_csv,
                                                 "--submission", sub, *extra))
        with open(sweep_path) as f:
            rows = [json.loads(line) for line in f]
        with open(cell_csv) as f:
            records = list(csv.DictReader(f))
        with open(sub) as f:
            submission = f.read()
        out[side] = dict(printed_sweep=printed_sweep, printed_cell=printed_cell, rows=rows,
                         records=records, submission=submission)
    return out


def _run_printing(main, argv):
    """``main(argv)`` → the JSON lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def _same(got, want, what):
    for key in EQUAL:
        if key in want:
            assert got[key] == want[key], (what, key, got[key], want[key])
    for key in CLOSE:
        assert abs(got[key] - want[key]) <= TOL, (what, key, got[key], want[key])


def test_threshold_is_clear_of_every_margin(runs):
    assert np.abs(runs["margins"] - runs["threshold"]).min() >= GAP
    assert 0 < int((runs["margins"] < runs["threshold"]).sum()) < len(runs["margins"])


def test_sweep_rows_equal_jax(runs):
    got, want = runs["port"], runs["jax"]
    assert got["printed_sweep"] == got["rows"]
    assert len(got["rows"]) == len(want["rows"]) == 1 + 2 * 4  # clean + 2 noises × 4 SNRs
    assert [(r["noise"], r["snr"]) for r in got["rows"]] == [
        (r["noise"], r["snr"]) for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        _same(g, w, (g["noise"], g["snr"]))
        assert g["n_utts"] == 12
    assert sum(r["lm_arbitrated"] for r in got["rows"]) > 0


def test_cell_result_records_and_submission_equal_jax(runs):
    got, want = runs["port"], runs["jax"]
    (g,), (w,) = got["printed_cell"], want["printed_cell"]
    _same(g, w, "clean cell")
    assert g["acc"] == got["rows"][0]["acc"] and g["lm_arbitrated"] > 0
    assert len(got["records"]) == len(want["records"]) == 12
    for gr, wr in zip(got["records"], want["records"]):
        assert abs(float(gr.pop("score")) - float(wr.pop("score"))) <= TOL
        assert gr == wr
    assert got["submission"] == want["submission"]
    assert len(got["submission"].splitlines()) == 12


@pytest.mark.parametrize("extra", [["--quant", "int8"]], ids=["quant"])
def test_unported_options_raise(world, extra):
    """Ported: ``--quant int8`` scores the clean cell as the JAX CLI's
    ``--quant int8`` does, and apart from the exact run."""
    root = world["root"]
    got, want, exact = ({r["path"]: r for r in _cell_records(
        main, _base(world, *flags, "--csv", str(root / f"quant_{name}.csv")))}
        for name, main, flags in (("port", test_lid.main, [*extra, "--device", "cpu"]),
                                  ("jax", jax_test_lid.main, extra),
                                  ("exact", test_lid.main, ["--device", "cpu"])))
    assert sorted(got) == sorted(want) and len(got) == 12
    jax_gap = quant_gap = 0.0
    for key, w in want.items():
        g = got[key]
        assert g["pred_lang"] == w["pred_lang"], key
        jax_gap = max(jax_gap, abs(float(g["score"]) - float(w["score"])))
        quant_gap = max(quant_gap, abs(float(g["score"]) - float(exact[key]["score"])))
    # nearer JAX's int8 run than its own exact one: the int8 engine ran
    assert jax_gap <= QUANT_TOL and jax_gap < quant_gap, (jax_gap, quant_gap)


def _cell_records(main, argv):
    """One clean cell through ``main``: its CSV records."""
    _run_printing(main, argv)
    with open(argv[argv.index("--csv") + 1]) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("spec", ["0:1", "0:1:0", "a:b:c", None])
def test_factor_sweep_arguments_checked_before_any_load(spec):
    argv = ["--ckpt", "absent.ckpt", "--config-name", "absent", "--factor-sweep"]
    argv += ["0:1:0.5"] if spec is None else [spec, "--se-ckpt", "se.ckpt"]
    with pytest.raises(SystemExit):  # spec None: --se-ckpt missing
        test_lid.main(argv)


def test_device_defaults_to_the_card(world, tmp_path):
    """Without ``--device`` the task is built on ``cuda``: on a machine
    without a card that fails before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    outs = [tmp_path / "cell.csv", tmp_path / "cell.sub", tmp_path / "sweep.jsonl"]
    with pytest.raises((AssertionError, RuntimeError)):
        test_lid.main(_base(world, "--csv", str(outs[0]), "--submission", str(outs[1])))
    with pytest.raises((AssertionError, RuntimeError)):
        test_lid.main(_base(world, "--sweep", "--csv", str(outs[2])))
    assert not any(p.exists() for p in outs)
