"""CER / WER / accuracy (the port's copy of
``speechlid_tpu/metrics/error_rate.py``, numpy only).

Corpus-level torchmetrics semantics: sum of edit distances / sum of
reference lengths — NOT a mean of per-utterance rates.  Under data
parallelism ``sync`` sums every rank's counts before ``compute``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from speechlid_tpu_torch.metrics.dist import allreduce_sum_counts


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min) rolling rows (host-side; decode
    output is short)."""
    if len(ref) == 0:
        return len(hyp)
    if len(hyp) == 0:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


class _ErrorRate:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.errors = 0
        self.total = 0

    def _tokenize(self, s):
        raise NotImplementedError

    def update(self, preds, targets) -> None:
        if isinstance(preds, str):
            preds, targets = [preds], [targets]
        for p, t in zip(preds, targets):
            pt, tt = self._tokenize(p), self._tokenize(t)
            self.errors += edit_distance(tt, pt)
            self.total += len(tt)

    def merge_state(self, errors: int, total: int) -> None:
        self.errors += int(errors)
        self.total += int(total)

    def sync(self) -> None:
        """Sum the counts over the ranks.  Call once before ``compute``."""
        self.errors, self.total = (int(x) for x in allreduce_sum_counts(self.errors, self.total))

    def compute(self) -> float:
        return self.errors / self.total if self.total else 0.0


class CharErrorRate(_ErrorRate):
    def _tokenize(self, s):
        return list(s)


class WordErrorRate(_ErrorRate):
    def _tokenize(self, s):
        return s.split()


class Accuracy:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.correct = 0
        self.total = 0

    def update(self, preds, targets) -> None:
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        if preds.ndim > targets.ndim:  # logits/scores → argmax
            preds = preds.argmax(axis=-1)
        self.correct += int((preds == targets).sum())
        self.total += int(targets.size)

    def merge_state(self, correct: int, total: int) -> None:
        self.correct += int(correct)
        self.total += int(total)

    def sync(self) -> None:
        """Sum the counts over the ranks.  Call once before ``compute``."""
        self.correct, self.total = (int(x) for x in
                                    allreduce_sum_counts(self.correct, self.total))

    def compute(self) -> float:
        return self.correct / self.total if self.total else 0.0
