"""Training cells: the port's ``Trainer`` epoch loop
(``Trainer._run_train_epoch``, after ``trainer_prepare``) over the
benchmark's loader, the progress bar off, the freeze schedule at its
steady epoch.

Set-up makes one trainer and drives it through its first three optimizer
steps on the pool's first batches, through the same loop and loader as the
window: their losses, the first gradient (from Adam's first moment) and
each parameter's change are kept for the check.  Then one step on each
kind of batch the first steps did not reach warms every shape.  The window
pulls batches until ``seconds`` have passed; ``train_step_p95_ms`` is the
95th percentile of the intervals between consecutive pulls (the loop
fetches step i − 1's loss while step i runs, so in steady state the
interval is the step), ``train_utt_per_s`` the rows over the window's
seconds, which end when the last step's work is done.

The window's first part also keeps one optimizer step for the check (the
:class:`Probe`): a step drawn from the seed after the loader has wrapped
into its second cycle.  At the pull that starts it, the parameters, Adam's
moments and count and the generators' states are copied on the card (about
a millisecond of copies, stream-ordered, no wait); at the pull after its
last batch, the parameters and the first moment again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import check, counters, program, traffic, weights
from harness.traffic import sub_seed
from reference.model import vocab_sizes

CHECKED_STEPS = 3


class Probe:
    """One optimizer step of the window kept for the check: the one whose
    first batch is the window's ``at``-th, ``accum`` batches long."""

    def __init__(self, at: int, accum: int, take):
        self.at, self.accum, self.take = at, accum, take
        self.before: Optional[dict] = None
        self.after: Optional[dict] = None
        self.batches: List[int] = []   # pool indices of its batches

    def pull(self, served: int, index: int) -> None:
        """At the pull of the window's ``served``-th batch (pool ``index``)."""
        if served == self.at:
            self.before = self.take(full=True)
        if self.at <= served < self.at + self.accum:
            self.batches.append(index)
        if served == self.at + self.accum:
            self.after = self.take(full=False)

    def close(self, served: int) -> None:
        """At the window's end: the step just ended it."""
        if self.after is None and served == self.at + self.accum:
            self.after = self.take(full=False)

    @property
    def done(self) -> bool:
        return self.after is not None


class PoolLoader:
    """Cycles the pool; stops after ``limit`` batches served or at
    ``deadline``, and notes the time of every pull."""

    def __init__(self, pool):
        self.pool = pool
        self.next = 0
        self.served = 0
        self.rows = 0
        self.flops = 0.0
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.pulls: List[float] = []
        self.flops_of: List[float] = []
        self.probe: Optional[Probe] = None

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        self.pulls.append(now)
        if ((self.limit is not None and self.served >= self.limit)
                or (self.deadline is not None and now >= self.deadline)):
            raise StopIteration
        i = self.next % len(self.pool)
        if self.probe is not None:
            self.probe.pull(self.served, i)
        self.next += 1
        self.served += 1
        self.rows += self.pool[i].rows
        if self.flops_of:
            self.flops += self.flops_of[i]
        return self.pool[i].host_dict()


class LossLog:
    """A trainer callback keeping each batch's loss."""

    interval = 1

    def __init__(self):
        self.losses: List[float] = []
        self.trainer = None

    def add_trainer(self, trainer) -> None:
        self.trainer = trainer

    def after_train_loop(self, step: int, metrics: Dict) -> None:
        self.losses.append(float(metrics["loss"]))


@dataclass
class Window:
    seconds: float = 0.0
    rows: int = 0
    failed: int = 0
    steps: int = 0
    dispatch_s: float = 0.0
    flops: float = 0.0
    intervals: List[float] = field(default_factory=list)


class TrainCell:
    train = True

    def __init__(self, cell, seed: int, device):
        from speechlid_tpu_torch.core.profile import _time_cost_recoder

        self.recoder = _time_cost_recoder
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg = cell.config
        self.accum = int(cfg["trainer"]["accum_grad"])
        self.trainer_seed = sub_seed(seed, "trainer") % (2 ** 32 - 2)  # numpy takes < 2**32
        self.log = LossLog()
        clock = program.Phases()
        self.task = program.build_task(cfg, self.device)
        self.trainer = program.build_trainer(cfg, self.trainer_seed, self.device, [self.log])
        self.trainer.trainer_prepare(self.task)
        clock("build")
        self.shapes = program.load_weights(self.task, seed, self.device)
        self.param_names = [n for n, _ in self.task.model.named_parameters()]
        self.epoch = int(cfg["trainer"]["steady_epoch"])
        self.task.before_train_loop(self.epoch)
        self.pool = traffic.make_pool(cell.traffic, cell.params["batch"], vocab_sizes(cfg), seed,
                                      self.device, cfg["data"]["sample_rate"],
                                      pin=self.device.type == "cuda")
        self.loader = PoolLoader(self.pool)
        self.loader.flops_of = [3.0 * counters.model_flops(cfg, b.wav_lengths.tolist(), True)
                                for b in self.pool]
        clock("weights and pool")
        self.program = self._checked_steps()
        cycle = -(-len(self.pool) // self.accum)  # optimizer steps a cycle
        step = int(np.random.default_rng(sub_seed(seed, "probe")).integers(
            cycle, cycle + -(-cycle // 2)))
        self.probe: Optional[Probe] = Probe(step * self.accum, self.accum, self._state)
        self.probed: tuple = (None, [])  # (the probe, its batches' losses) once the window ran
        clock("checked steps")
        seen = {b.kind for b in self.pool[:CHECKED_STEPS * self.accum]}
        for kind in sorted({b.kind for b in self.pool} - seen):
            batch = next(b for b in self.pool if b.kind == kind)
            self.trainer._run_train_epoch(self.epoch, [batch.host_dict()] * self.accum)
        clock("warm")
        self.setup_phases = clock.seconds

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _state(self, full: bool) -> dict:
        """Copies, on the card, of the parameters and Adam's first moment;
        ``full``: also its second moment, its count and the generators'
        states."""
        opt = self.trainer.optimizer
        out = {"params": {n: p.detach().clone() for n, p in self.task.model.named_parameters()},
               "mu": {n: m.clone() for n, m in zip(opt.names, opt.mu)}}
        if full:
            gens = self.trainer.generators
            out.update(nu={n: v.clone() for n, v in zip(opt.names, opt.nu)}, count=opt.count,
                       gens=(gens["device"].get_state(), gens["host"].get_state()))
        return out

    def _checked_steps(self) -> dict:
        model, opt = self.task.model, self.trainer.optimizer
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.loader.limit = self.accum
        self.trainer._run_train_epoch(self.epoch, self.loader)
        grad1 = {n: float(m.norm()) / (1.0 - check.B1) for n, m in zip(opt.names, opt.mu)}
        self.loader.limit = CHECKED_STEPS * self.accum
        self.trainer._run_train_epoch(self.epoch, self.loader)
        change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
        self.loader.limit = None
        return {"losses": list(self.log.losses), "grad1": grad1, "change": change}

    def loop(self, seconds: float) -> Window:
        loader = self.loader
        loader.next, loader.served, loader.rows, loader.flops = 0, 0, 0, 0.0
        loader.pulls = []
        self.log.losses.clear()
        self.recoder.remove_recoder()
        probe, loader.probe = self.probe, self.probe  # the first window only
        start = time.perf_counter()
        loader.deadline = start + seconds
        self.trainer._run_train_epoch(self.epoch, loader)
        if probe is not None:
            probe.close(loader.served)
        self._sync()
        end = time.perf_counter()
        loader.deadline, loader.probe = None, None
        if probe is not None:
            self.probe = None
            self.probed = (probe, list(self.log.losses[probe.at:probe.at + probe.accum]))
        took = self.recoder.snapshot()
        w = Window(seconds=end - start, rows=loader.rows, steps=loader.served,
                   flops=loader.flops, intervals=list(np.diff(loader.pulls)))
        w.dispatch_s = sum(took.get(k, (0.0, 0))[0]
                           for k in ("batch_to_device", "train_step_dispatch"))
        rows_each = loader.rows / max(loader.served, 1)
        w.failed = int(round(rows_each * sum(not np.isfinite(x) for x in self.log.losses)))
        return w

    def end_to_end(self, w: Window) -> Dict[str, float]:
        return {"train_utt_per_s": w.rows / w.seconds,
                "train_step_p95_ms": 1e3 * float(np.percentile(w.intervals, 95))}

    def free(self) -> None:
        del self.trainer, self.task

    def _first_batches(self) -> List[dict]:
        return [b.host_dict() for b in self.pool[:CHECKED_STEPS * self.accum]]

    def _reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        params = weights.make_weights(self.shapes, self.seed, self.device)
        with check.precision(tf32):
            return check.reference_steps(self.cell.config, params, self.param_names,
                                         self._first_batches(), self.trainer_seed,
                                         CHECKED_STEPS, half_batch=half_batch)

    def _window_program(self) -> Optional[dict]:
        """The window's kept step as the program took it, or None where the
        window ended before it did."""
        probe, losses = self.probed
        if probe is None or not probe.done:
            return None
        before, after = probe.before, probe.after
        return {"losses": losses,
                "grad1": check.first_gradient(before["mu"], after["mu"]),
                "change": {n: float((after["params"][n] - before["params"][n]).norm())
                           for n in self.param_names}}

    def _window_reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The reference's step from the program's state before the kept
        step, over its batches (the first batches' where the window never
        reached it: its readings are then infinite anyway)."""
        probe = self.probed[0]
        if probe is None or not probe.done:
            return self._reference(tf32, half_batch)
        batches = [self.pool[i].host_dict() for i in probe.batches]
        params = weights.make_weights(self.shapes, self.seed, self.device)  # buffers: unused
        params.update(probe.before["params"])  # in training
        with check.precision(tf32):
            return check.reference_steps(self.cell.config, params,
                                         self.param_names, batches, self.trainer_seed, 1,
                                         half_batch=half_batch, state=probe.before)

    def check(self) -> Dict[str, float]:
        return {**check.train_readings(self.program, self._reference()),
                **check.train_readings(self._window_program(), self._window_reference(),
                                       "w_")}

    def look(self) -> dict:
        """The leaves behind the widest gaps, with their norms (program,
        reference) and the reference's largest gradient."""
        want = self._reference()
        out = {}
        for key, leaves in (("grad1", want["grad1"]), ("change", check.moved(want))):
            out[key] = [(gap, leaf, self.program[key][leaf], want[key][leaf],
                         want["grad_max"][leaf])
                        for gap, leaf in check.leaf_gaps(self.program[key], want[key], leaves)[:5]]
        return out

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place."""
        return {**check.train_readings(self._reference(tf32=True), self._reference()),
                **check.train_readings(self._window_reference(tf32=True),
                                       self._window_reference(), "w_")}

    def half_batch(self) -> Dict[str, float]:
        """The fault of a loss over half of each batch, planted in the
        reference in the program's place."""
        return {**check.train_readings(self._reference(half_batch=True), self._reference()),
                **check.train_readings(self._window_reference(half_batch=True),
                                       self._window_reference(), "w_")}
