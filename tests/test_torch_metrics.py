"""The port's copies of the host metrics (EER, Cavg, CER/WER, accuracy)
against the JAX package's on seeded scores.  Both are numpy code doing the
same arithmetic: equal to 1e-12."""

import numpy as np
import pytest

from speechlid_tpu import metrics as jm
from speechlid_tpu_torch import metrics as pm

TOL = 1e-12


def _scores(seed, n=60, n_lang=3):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, n_lang, n)
    scores = rng.rand(n, n_lang)
    scores[np.arange(n), target] += 0.4  # informative, not perfect
    return scores / scores.sum(-1, keepdims=True), target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eer_and_cavg(seed):
    scores, target = _scores(seed)
    for cls in ("EER", "CAvg"):
        ref, got = getattr(jm, cls)(num_class=3), getattr(pm, cls)(num_class=3)
        for lo in range(0, len(target), 20):  # streaming updates
            ref.update(scores[lo : lo + 20], target[lo : lo + 20])
            got.update(scores[lo : lo + 20], target[lo : lo + 20])
        assert abs(got.compute() - ref.compute()) <= TOL
        ref.reset()
        got.reset()  # nothing of the first stream is left
        ref.update(scores[:20], target[:20])
        got.update(scores[:20], target[:20])
        assert abs(got.compute() - ref.compute()) <= TOL


def test_roc_curve_and_compute_functions():
    scores, target = _scores(3)
    labels = (target == 0).astype(int)
    for a, b in zip(pm.roc_curve(labels, scores[:, 0]), jm.roc_curve(labels, scores[:, 0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert pm.compute_eer(labels, scores[:, 0]) == jm.compute_eer(labels, scores[:, 0])
    pairs = [(j, int(t), float(s)) for row, t in zip(scores, target) for j, s in enumerate(row)]
    assert pm.compute_cavg(pairs, 3) == jm.compute_cavg(pairs, 3)
    assert pm.compute_cavg(pairs, 1) == 0.0


@pytest.mark.parametrize("cls", ["CharErrorRate", "WordErrorRate"])
def test_error_rates(cls):
    rng = np.random.RandomState(4)
    words = ["ab", "cde", "f", "ghij", "k"]
    refs = [" ".join(rng.choice(words, rng.randint(1, 6))) for _ in range(20)]
    hyps = [" ".join(rng.choice(words, rng.randint(0, 6))) for _ in range(20)]
    ref, got = getattr(jm, cls)(), getattr(pm, cls)()
    ref.update(hyps, refs)
    got.update(hyps, refs)
    assert got.errors == ref.errors and got.total == ref.total
    assert abs(got.compute() - ref.compute()) <= TOL
    assert pm.edit_distance("kitten", "sitting") == jm.edit_distance("kitten", "sitting") == 3


def test_accuracy():
    scores, target = _scores(5)
    ref, got = jm.Accuracy(), pm.Accuracy()
    ref.update(scores, target)
    got.update(scores, target)
    assert got.compute() == ref.compute()
