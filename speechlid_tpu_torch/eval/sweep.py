"""SNR × noise-type robustness sweep (port of ``speechlid_tpu/eval/sweep.py``).

One Python entry for the reference's shell grids (SNR ∈ {0, 5, 10, 15} dB ×
{white, factory1, factory2, babble} NOISEX-92, and the SE blend-factor
sweep), reusing one evaluator, and so one model on the card, across cells.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

from speechlid_tpu_torch.eval.harness import LidEvaluator

DEFAULT_SNRS = (0.0, 5.0, 10.0, 15.0)
DEFAULT_NOISES = ("white", "factory1", "factory2", "babble")


def _write_rows(out_path: str, rows: List[Dict]) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def run_sweep(
    evaluator: LidEvaluator,
    feeder_factory,
    snrs: Sequence[float] = DEFAULT_SNRS,
    noises: Sequence[str] = DEFAULT_NOISES,
    include_clean: bool = True,
    out_path: Optional[str] = None,
    max_batches: Optional[int] = None,
) -> List[Dict]:
    """The clean row first, then every SNR of every noise in the bank (a
    noise not in the bank is skipped with a warning).  ``feeder_factory()``
    gives a fresh feeder a cell."""
    rows: List[Dict] = []
    if include_clean:
        res = evaluator.evaluate(feeder_factory(), None, None, max_batches=max_batches)
        rows.append({"snr": None, "noise": "clean", **res.as_dict()})
    available = set(evaluator.noise_bank.noises) if evaluator.noise_bank else set()
    for noise in noises:
        if noise not in available:
            logging.warning("noise %r not in bank — skipped", noise)
            continue
        for snr in snrs:
            res = evaluator.evaluate(feeder_factory(), snr, noise, max_batches=max_batches)
            rows.append({"snr": snr, "noise": noise, **res.as_dict()})
    if out_path:
        _write_rows(out_path, rows)
    return rows


def run_factor_sweep(
    evaluator: LidEvaluator,
    feeder_factory,
    factors: Sequence[float],
    snr: Optional[float] = None,
    noise: Optional[str] = None,
    out_path: Optional[str] = None,
    max_batches: Optional[int] = None,
) -> List[Dict]:
    """The SE blend-factor sweep at one noise cell: the evaluator's
    ``enhance_factor`` is set in place for each point and restored after."""
    if evaluator.enhance_fn is None:
        raise ValueError("factor sweep needs an SE model (--se-ckpt)")
    rows: List[Dict] = []
    saved = evaluator.enhance_factor
    try:
        for factor in factors:
            evaluator.enhance_factor = float(factor)
            res = evaluator.evaluate(feeder_factory(), snr, noise, max_batches=max_batches)
            rows.append({"factor": float(factor), "snr": snr, "noise": noise or "clean",
                         **res.as_dict()})
    finally:
        evaluator.enhance_factor = saved
    if out_path:
        _write_rows(out_path, rows)
    return rows
