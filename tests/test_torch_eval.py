"""The port's evaluator and sweeps (``speechlid_tpu_torch/eval``) against the
JAX package's, on one tiny task (1 block × 32-d, 2 languages) whose JAX
variables (random BatchNorm statistics) are converted into the port.

Both consume the same feeder and a ``NoiseBank`` of the same seed, so they
hear the same noise.  Clean, at 5 dB of white noise, in a blend-factor
sweep and through ``run_sweep``: ``pred_lang``, ``hyp`` and
``lm_arbitrated`` are identical, ``acc`` and ``cer`` equal, ``eer``,
``cavg``, ``eer_true``, ``cavg_true`` and each record's score within 1e-4.

A random-weight model has top-2 margins near any threshold, and the two
float implementations differ by ~1e-6 there.  So ``kenlm_threshold`` is
taken from the JAX margins of every cell, in a gap that leaves every margin
at least 1e-3 away, and the test asserts that gap: a margin at the
threshold would make arbitration a coin toss between the two, which says
nothing of either."""

import csv

import jax
import numpy as np
import pytest

from speechlid_tpu.data import CTCTokenizer as JaxCTCTokenizer
from speechlid_tpu.decode import NgramLM as JaxNgramLM
from speechlid_tpu.eval import LidEvaluator as JaxLidEvaluator
from speechlid_tpu.eval import NoiseBank as JaxNoiseBank
from speechlid_tpu.eval import run_factor_sweep as jax_run_factor_sweep
from speechlid_tpu.eval import run_sweep as jax_run_sweep
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu.tasks.lid_asr import normalize_scores
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.data import (BucketFeeder, CTCTokenizer, MergedDataset,
                                      MultiBatchSampler, RawManifest, write_wav)
from speechlid_tpu_torch.decode import NgramLM
from speechlid_tpu_torch.eval import LidEvaluator, NoiseBank, run_factor_sweep, run_sweep
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import one_thread, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
TOL = 1e-4
GAP = 1e-3
WORDS = {"aa": ["ab", "ba", "a", "bab"], "bb": ["cd", "dc", "d", "cdc"]}
HPARAMS = dict(n_blocks=1, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
               head_dim_head=8, head_num_head=2, lr=1e-3, schedule=None)
METRICS_EQUAL = ("acc", "cer", "n_utts", "lm_arbitrated")
METRICS_CLOSE = ("eer", "cavg", "eer_true", "cavg_true")
SWEEP_SNRS, SWEEP_NOISES = (0.0, 10.0), ("white", "babble", "factory9")


def _arpa(words):
    logp = np.log10(1.0 / (len(words) + 1))
    lines = ["\\data\\", f"ngram 1={len(words) + 3}", "", "\\1-grams:", "-3.00\t<unk>",
             f"{logp:.4f}\t<s>", f"{logp:.4f}\t</s>", *[f"{logp:.4f}\t{w}" for w in words],
             "", "\\end\\", ""]
    return "\n".join(lines)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SPEECHLID_CACHE_DISABLE", "1")
    root = tmp_path_factory.mktemp("torch_eval_corpus")
    rng = np.random.RandomState(0)
    manifests = []
    for li, (lang, words) in enumerate(sorted(WORDS.items())):
        wav_dir = root / lang / "wav" / "train"
        wav_dir.mkdir(parents=True)
        lines = []
        for i in range(6):
            t = np.arange(int(SR * (0.3 + 0.12 * i))) / SR
            wav = (0.4 * np.sin(2 * np.pi * (200 + 150 * li) * t) + 0.05 * rng.randn(len(t)))
            write_wav(str(wav_dir / f"u{i}.wav"), wav.astype(np.float32), SR)
            lines.append(f"u{i}.wav\t{words[i % 4]} {words[(i + 1) % 4]}")
        (root / lang / "train.txt").write_text("\n".join(lines))
        manifests.append(str(root / lang / "train.txt"))
        (root / f"{lang}.arpa").write_text(_arpa(words))
    noise_dir = root / "noise"
    noise_dir.mkdir()
    for name in ("white", "babble"):
        write_wav(str(noise_dir / f"{name}.wav"), (0.1 * rng.randn(SR)).astype(np.float32), SR)
    noises = {name: str(noise_dir / f"{name}.wav") for name in ("white", "babble")}

    ms = [RawManifest(p, max_duration=2.0, source="xf") for p in manifests]
    vocabs = {m.lang(): m.export_vocab() for m in ms}
    lang2index = {lang: i for i, lang in enumerate(sorted(vocabs))}
    lang2vocab = {lang: len(v) for lang, v in vocabs.items()}
    toks = {lang: CTCTokenizer(v) for lang, v in vocabs.items()}
    ds = MergedDataset(ms, toks, lang2index)

    def feeder_factory():
        return BucketFeeder(ds, MultiBatchSampler(ds, 4, seed=1), buckets_s=(0.5, 1.0),
                            max_text_len=16, arrays_only=False)

    jtask = JaxLidASRTask(lang2vocab=lang2vocab, lang2index=lang2index,
                          tokenizers={k: JaxCTCTokenizer(v) for k, v in vocabs.items()},
                          **HPARAMS)
    sample = next(iter(BucketFeeder(ds, MultiBatchSampler(ds, 4, seed=0), buckets_s=(0.5, 1.0),
                                    max_text_len=16)))
    variables = random_batch_stats(jtask.init_variables(jax.random.PRNGKey(0), sample), 0)
    ptask = LidASRTask(lang2vocab=lang2vocab, lang2index=lang2index, tokenizers=toks,
                       device="cpu", **HPARAMS)
    convert.load_into(ptask.model, convert.lid_state(variables))
    yield dict(root=root, noises=noises, feeder_factory=feeder_factory, jtask=jtask,
               variables=variables, ptask=ptask)
    mp.undo()


def run_all(ev, bank_cls, sweep, factor_sweep, setup, tmp_path, tag):
    """Every cell of the comparison on one evaluator, its noise bank fresh
    from seed 3: clean (with a CSV), 5 dB white, a blend-factor sweep at
    0 dB white, and the sweep (clean + 2 noises × 2 SNRs; factory9 is not in
    the bank)."""
    ev.noise_bank = bank_cls(setup["noises"], seed=3)
    factory = setup["feeder_factory"]
    csv_path = str(tmp_path / f"{tag}.csv")
    cells = {"clean": ev.evaluate(factory(), csv_path=csv_path),
             "white5": ev.evaluate(factory(), snr_db=5.0, noise="white")}
    ev.enhance_fn = lambda w: 0.5 * w
    factor_rows = factor_sweep(ev, factory, factors=(0.0, 0.5), snr=0.0, noise="white")
    ev.enhance_fn = None
    rows = sweep(ev, factory, snrs=SWEEP_SNRS, noises=SWEEP_NOISES)
    with open(csv_path) as f:
        csv_rows = list(csv.DictReader(f))
    return cells, factor_rows, rows, csv_rows


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval_runs")
    jev = JaxLidEvaluator(setup["jtask"], setup["variables"])
    margins = []
    infer = jev._infer

    def recording_infer(variables, wavs, lengths):
        out = infer(variables, wavs, lengths)
        prob = np.sort(normalize_scores(np.asarray(out["scores"])), axis=-1)
        margins.extend((prob[:, -1] - prob[:, -2]).tolist())
        return out

    # pass 1: the JAX margins of every cell (arbitration does not change them)
    jev._infer = recording_infer
    run_all(jev, JaxNoiseBank, jax_run_sweep, jax_run_factor_sweep, setup, tmp, "margins")
    jev._infer = infer
    margins = np.unique(margins)
    mids = [(a + b) / 2 for a, b in zip(margins[:-1], margins[1:]) if b - a > 2 * GAP]
    threshold = min(mids, key=lambda m: abs(m - np.median(margins)))

    root = setup["root"]
    jev.lms = {lang: JaxNgramLM(str(root / f"{lang}.arpa")) for lang in WORDS}
    jev.kenlm_threshold = threshold
    want = run_all(jev, JaxNoiseBank, jax_run_sweep, jax_run_factor_sweep, setup, tmp, "jax")
    pev = LidEvaluator(setup["ptask"], lms={lang: NgramLM(str(root / f"{lang}.arpa"))
                                             for lang in WORDS},
                       kenlm_threshold=threshold)
    got = run_all(pev, NoiseBank, run_sweep, run_factor_sweep, setup, tmp, "port")
    return dict(threshold=threshold, margins=margins, want=want, got=got)


def _same_result(got: dict, want: dict, what: str) -> None:
    for key in METRICS_EQUAL:
        assert got[key] == want[key], (what, key)
    for key in METRICS_CLOSE:
        assert abs(got[key] - want[key]) <= TOL, (what, key, got[key], want[key])


def test_threshold_is_clear_of_every_margin(runs):
    assert np.abs(runs["margins"] - runs["threshold"]).min() >= GAP
    below = int((runs["margins"] < runs["threshold"]).sum())
    assert 0 < below < len(runs["margins"])  # some calls arbitrated, some not


@pytest.mark.parametrize("cell", ["clean", "white5"])
def test_evaluate_equals_jax(runs, cell):
    got, want = runs["got"][0][cell], runs["want"][0][cell]
    _same_result(got.as_dict(), want.as_dict(), cell)
    assert got.n_utts == 12 and got.lm_arbitrated > 0
    assert len(got.records) == len(want.records) == 12
    for g, w in zip(got.records, want.records):
        assert {k: g[k] for k in ("path", "true_lang", "pred_lang", "hyp", "ref")} == \
               {k: w[k] for k in ("path", "true_lang", "pred_lang", "hyp", "ref")}
        assert abs(g["score"] - w["score"]) <= TOL


def test_csv_equals_jax(runs):
    got, want = runs["got"][3], runs["want"][3]
    assert len(got) == len(want) == 12 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        assert abs(float(g.pop("score")) - float(w.pop("score"))) <= TOL
        assert g == w


def test_sweeps_equal_jax(runs):
    for got_rows, want_rows in ((runs["got"][2], runs["want"][2]),
                                (runs["got"][1], runs["want"][1])):
        assert len(got_rows) == len(want_rows)
        for g, w in zip(got_rows, want_rows):
            assert ({k: g[k] for k in ("snr", "noise", "factor") if k in g}
                    == {k: w[k] for k in ("snr", "noise", "factor") if k in w})
            _same_result(g, w, (g["noise"], g["snr"]))
    rows = runs["got"][2]
    assert [(r["noise"], r["snr"]) for r in rows] == [("clean", None)] + [
        (n, s) for n in ("white", "babble") for s in SWEEP_SNRS]
    assert rows[0]["acc"] == runs["got"][0]["clean"].acc


def test_snr_without_noise_raises(setup):
    ev = LidEvaluator(setup["ptask"])
    with pytest.raises(ValueError, match="no noise bank"):
        ev.evaluate(setup["feeder_factory"](), snr_db=5.0, noise="white")
    ev.noise_bank = NoiseBank(setup["noises"])
    with pytest.raises(ValueError, match="no noise name"):
        ev.evaluate(setup["feeder_factory"](), snr_db=5.0)
    with pytest.raises(ValueError, match="arrays_only"):
        ev.evaluate(BucketFeeder(setup["feeder_factory"]().dataset,
                                 MultiBatchSampler(setup["feeder_factory"]().dataset, 4)))


def test_noise_bank_equals_jax(setup):
    got, want = NoiseBank(setup["noises"], seed=5), JaxNoiseBank(setup["noises"], seed=5)
    for name, length, batch in (("white", 3 * SR, 2), ("babble", 4000, 3), ("white", 100, 1)):
        np.testing.assert_array_equal(got.sample(name, length, batch),
                                      want.sample(name, length, batch))
    with pytest.raises(KeyError, match="unknown noise"):
        got.sample("pink", 10, 1)


class _LM:
    def __init__(self, ppl):
        self.ppl = ppl

    def perplexity(self, text):
        return self.ppl


def _logits(task, speak: bool):
    """(L, T, V) logits whose greedy decode is a letter in every head (or
    all blank)."""
    out = np.zeros((task.n_lang, 10, max(task.vocab_sizes) + 1), np.float32)
    if speak:
        tok = next(iter(task.tokenizers.values()))
        out[..., next(i for i, c in tok.labels_map.items() if c.strip())] = 5.0
    else:
        out[..., -1] = 5.0
    return out


@pytest.mark.parametrize("ppls,speak,default,want", [
    ((float("inf"), float("inf")), True, 1, 1),   # no finite perplexity: the argmax
    ((5.0, 5.0), False, 1, 1),                    # empty decodes: infinite, the argmax
    ((42.0, 42.0), True, 1, 1),                   # a tie keeps the argmax
    ((42.0, 42.0 * (1 + 1e-10)), True, 1, 1),     # a tie within 1e-9 relative too
    ((5.0, 50.0), True, 1, 0),                    # a unique minimum wins
    ((50.0, 5.0), True, 0, 1),
])
def test_lm_select_rules(setup, ppls, speak, default, want):
    task = setup["ptask"]
    langs = sorted(task.lang2index, key=task.lang2index.get)
    ev = LidEvaluator(task, lms={lang: _LM(p) for lang, p in zip(langs, ppls)})
    jev = JaxLidEvaluator(setup["jtask"], setup["variables"],
                          lms={lang: _LM(p) for lang, p in zip(langs, ppls)})
    logits = _logits(task, speak)
    assert ev._lm_select(logits, 10, default=default) == want
    assert jev._lm_select(logits, 10, default=default) == want
