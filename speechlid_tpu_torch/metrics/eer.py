"""Equal error rate (the port's copy of ``speechlid_tpu/metrics/eer.py``,
numpy only).

EER is the root of ``1 - x - tpr(x)`` on the piecewise-linear ROC
interpolant (sklearn's ``roc_curve`` with ``drop_intermediate``, found by
bisection).  Scoring convention: the caller pushes one score *per language*
per utterance; the positive label marks the target language.  The
multi-process ``sync`` waits for the distributed slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def roc_curve(
    labels: np.ndarray, scores: np.ndarray, drop_intermediate: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary ROC matching sklearn.metrics.roc_curve (pos_label=1)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]

    distinct = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct, labels.size - 1]

    tps = np.cumsum(labels)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs) - tps

    if drop_intermediate and len(fps) > 2:
        # keep only corner points of the ROC (sklearn's optimal_idxs)
        optimal = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps = fps[optimal], tps[optimal]
        threshold_idxs = threshold_idxs[optimal]

    thresholds = scores[threshold_idxs]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan)
    return fpr, tpr, thresholds


def _interp(x: float, xs: np.ndarray, ys: np.ndarray) -> float:
    """Piecewise-linear interpolation, scipy.interp1d semantics on sorted xs."""
    return float(np.interp(x, xs, ys))


def compute_eer(labels: Sequence[int], scores: Sequence[float]) -> float:
    """EER = x such that 1 - x == tpr(x) on the linear ROC interpolant —
    found by bisection on [0, 1] (brentq-equivalent root of a monotone fn)."""
    fpr, tpr, _ = roc_curve(np.asarray(labels), np.asarray(scores))

    def f(x: float) -> float:
        return 1.0 - x - _interp(x, fpr, tpr)

    lo, hi = 0.0, 1.0
    flo = f(lo)
    if flo == 0.0:
        return 0.0
    for _ in range(200):  # bisection to ~1e-60 — exceeds brentq's xtol
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        if fm == 0.0:
            return mid
        if (fm > 0) == (flo > 0):
            lo, flo = mid, fm
        else:
            hi = mid
    return 0.5 * (lo + hi)


class EER:
    """Streaming EER accumulator.

    update(predict, target): ``predict`` is (B, num_class) scores,
    ``target`` (B,) int class ids; one binary trial per (utt, class).
    """

    def __init__(self, num_class: int = 3):
        self.num_class = num_class
        self.reset()

    def reset(self) -> None:
        self._labels: List[int] = []
        self._scores: List[float] = []

    def update(self, predict, target) -> None:
        predict = np.asarray(predict, dtype=np.float64)
        target = np.asarray(target).astype(int)
        for row, tgt in zip(predict, target):
            for j, s in enumerate(row):
                self._scores.append(float(s))
                self._labels.append(int(j == tgt))


    def compute(self) -> float:
        return compute_eer(self._labels, self._scores)
