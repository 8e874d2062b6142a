"""Scoring cells: a closed loop over the pool through the task's
``infer_fn()``, each batch's scores fetched to the host as a scorer does.

Set-up builds the task, loads the weights, makes the pool and runs each
kind of batch twice.  The window hands batch after batch to ``infer`` and
waits for its scores; ``score_p95_ms`` is the 95th percentile of those
latencies, ``score_utt_per_s`` the rows over the window's seconds.  A
reservoir, drawn from the seed, keeps ``sample_per_kind`` outputs of each
kind for the check.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from harness import check, counters, program, traffic
from harness.traffic import sub_seed
from reference.model import vocab_sizes


@dataclass
class Window:
    seconds: float = 0.0
    rows: int = 0
    failed: int = 0
    batches: int = 0
    infer_s: float = 0.0
    flops: float = 0.0
    latencies: List[float] = field(default_factory=list)


class Reservoir:
    """``k`` items of each kind, uniformly from all offered, by the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(sub_seed(seed, "sample"))
        self.items: Dict[int, list] = {}
        self.seen: Dict[int, int] = {}

    def offer(self, kind: int, item) -> None:
        n = self.seen.get(kind, 0) + 1
        self.seen[kind] = n
        slots = self.items.setdefault(kind, [])
        if len(slots) < self.k:
            slots.append(item)
        else:
            j = int(self.rng.integers(n))
            if j < self.k:
                slots[j] = item

    def all(self) -> list:
        return [item for kind in sorted(self.items) for item in self.items[kind]]


class ScoreCell:
    train = False

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg = cell.config
        clock = program.Phases()
        self.task = program.build_task(cfg, self.device)
        clock("build")
        self.shapes = program.load_weights(self.task, seed, self.device)
        self.fn = self.task.infer_fn()
        clock("weights")
        self.pool = traffic.make_pool(cell.traffic, cell.params["batch"], vocab_sizes(cfg), seed,
                                      self.device, cfg["data"]["sample_rate"],
                                      pin=self.device.type == "cuda")
        clock("pool")
        self.flops = [counters.model_flops(cfg, b.wav_lengths.tolist(), train=False)
                      for b in self.pool]
        self.reservoir = Reservoir(int(cell.params["sample_per_kind"]), seed)
        self.next = 0
        first = {}
        for b in self.pool:
            first.setdefault(b.kind, b)
        for b in first.values():  # every shape the window will see, twice
            for _ in range(2):
                self.fn(b.wavs, b.wav_lengths)["scores"].cpu()
        clock("warm")
        self.setup_phases = clock.seconds

    def loop(self, seconds: float) -> Window:
        """Batches until ``seconds`` have passed; the window ends when the
        last batch's scores are on the host."""
        w = Window()
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            b = self.pool[self.next % len(self.pool)]
            flops = self.flops[self.next % len(self.pool)]
            self.next += 1
            t0 = time.perf_counter()
            out = self.fn(b.wavs, b.wav_lengths)
            t1 = time.perf_counter()
            scores = out["scores"].cpu()
            t2 = time.perf_counter()
            w.latencies.append(t2 - t0)
            w.infer_s += t1 - t0
            w.batches += 1
            w.rows += b.rows
            w.flops += flops
            w.failed += int((~torch.isfinite(scores).all(dim=-1)).sum())
            self.reservoir.offer(b.kind, (b, out["logits"], out["feat_lengths"], scores))
            if t2 >= deadline:
                w.seconds = t2 - start
                return w

    def end_to_end(self, w: Window) -> Dict[str, float]:
        return {"score_utt_per_s": w.rows / w.seconds,
                "score_p95_ms": 1e3 * float(np.percentile(w.latencies, 95))}

    def free(self) -> None:
        del self.fn, self.task

    def check(self, programs=None) -> Dict[str, float]:
        """The scoring numbers over the sample, against the reference made
        again from the seed.  ``programs``: (batch, logits, lengths, scores)
        items to judge instead of the program's (the control's)."""
        from harness import weights

        cfg = self.cell.config
        params = weights.make_weights(self.shapes, self.seed, self.device)
        readings = []
        with check.precision(False):
            for b, logits, lengths, scores in (programs or self.reservoir.all()):
                ref_logits, ref_len = check.reference_logits(cfg, params, b.to(self.device))
                readings.append(check.score_readings(cfg, logits, lengths, scores,
                                                     ref_logits, ref_len))
        return check.worst(readings)

    def control(self) -> Dict[str, float]:
        """The reference in TF32 put in the program's place, on the same
        sample."""
        from harness import weights
        from reference import model as ref

        cfg = self.cell.config
        params = weights.make_weights(self.shapes, self.seed, self.device)
        items = []
        with check.precision(True):
            for b, _, _, _ in self.reservoir.all():
                logits, lengths = check.reference_logits(cfg, params, b.to(self.device))
                scores = ref.scores(logits, ref.vocab_sizes(cfg), lengths)
                items.append((b, logits, lengths, scores))
        return self.check(programs=items)
