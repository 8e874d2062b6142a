"""Cavg (NIST LRE average detection cost), vectorized (the port's copy of
``speechlid_tpu/metrics/cavg.py``, numpy only).

Threshold sweep over ``bins+1`` points between
the min and max observed score; per language, p_miss on target trials below
threshold plus (1-p_target)/(L-1)-weighted false alarms per non-target
language at/above threshold; report the minimum over thresholds, rounded to
4 decimals.

One pass over a (trial, threshold) boolean matrix.  The multi-process
``sync`` waits for the distributed slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compute_cavg(
    pairs: Sequence[Tuple[int, int, float]],
    lang_num: int,
    bins: int = 20,
    p_target: float = 0.5,
) -> float:
    """pairs: (claimed_lang, true_lang, score) per trial."""
    if lang_num < 2:
        return 0.0  # detection cost undefined with a single language
    arr = np.asarray([(p[0], p[1], p[2]) for p in pairs], dtype=np.float64)
    claimed = arr[:, 0].astype(int)
    true = arr[:, 1].astype(int)
    scores = arr[:, 2]
    thresholds = np.linspace(scores.min(), scores.max(), bins + 1)

    below = scores[:, None] < thresholds[None, :]  # (N, bins+1)

    # per (claimed, true) trial counts and below-threshold counts
    cnt = np.zeros((lang_num, lang_num), dtype=np.float64)
    np.add.at(cnt, (claimed, true), 1.0)
    below_cnt = np.zeros((lang_num, lang_num, bins + 1), dtype=np.float64)
    np.add.at(below_cnt, (claimed, true), below.astype(np.float64))

    diag = np.arange(lang_num)
    lta = cnt[diag, diag]  # target trials per lang
    ltm = below_cnt[diag, diag, :]  # missed targets per threshold
    p_miss = np.divide(
        ltm, lta[:, None], out=np.zeros_like(ltm), where=lta[:, None] != 0
    )  # (L, bins+1)

    lna = cnt.copy()
    lna[diag, diag] = 0.0
    lnf = cnt[:, :, None] - below_cnt  # trials at/above threshold
    p_fa = np.divide(
        lnf, cnt[:, :, None], out=np.zeros_like(lnf), where=cnt[:, :, None] != 0
    )
    p_fa[diag, diag, :] = 0.0  # only non-target languages count

    p_nontarget = (1.0 - p_target) / (lang_num - 1)
    target_cavg = p_target * p_miss + p_nontarget * p_fa.sum(axis=1)  # (L, bins+1)
    cavgs = target_cavg.mean(axis=0)  # (bins+1,)
    return round(float(cavgs.min()), 4)


class CAvg:
    """Streaming accumulator: update((B, L) scores, (B,) targets)."""

    def __init__(self, num_class: int = 3, bins: int = 20, p_target: float = 0.5):
        self.num_class = num_class
        self.bins = bins
        self.p_target = p_target
        self.reset()

    def reset(self) -> None:
        self._pairs: List[Tuple[int, int, float]] = []

    def update(self, predict, target) -> None:
        predict = np.asarray(predict, dtype=np.float64)
        target = np.asarray(target).astype(int)
        for row, tgt in zip(predict, target):
            for j, s in enumerate(row):
                self._pairs.append((j, int(tgt), float(s)))


    def compute(self) -> float:
        return compute_cavg(self._pairs, self.num_class, self.bins, self.p_target)
