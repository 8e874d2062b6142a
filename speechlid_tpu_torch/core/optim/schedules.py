"""LR schedules (port of ``speechlid_tpu/core/optim/schedules.py``).

Tri-stage and cosine-with-restarts are pure ``step → lr`` host functions of
a Python number; ``ReduceLROnPlateau`` is a host class driven by eval
metrics.  The JAX package evaluates its schedules in float32 inside the
jitted step; here they run in Python floats, and the two agree to about
1e-7 relative (``tests/test_torch_optim.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

Schedule = Callable[[float], float]


def tristage_schedule(
    lr: float = 1e-4,
    warmup_steps: int = 0,
    hold_steps: int = 0,
    decay_steps: int = 0,
    phase_ratio: Optional[Tuple[float, float, float]] = None,
    max_update: int = 1000,
    init_lr_scale: float = 0.01,
    final_lr_scale: float = 0.01,
) -> Schedule:
    """SpecAugment-paper tri-stage schedule: linear warmup init→peak, hold,
    exponential decay to final, then flat."""
    if phase_ratio is not None:
        if abs(sum(phase_ratio) - 1.0) >= 1e-6:
            raise ValueError("phase ratios must sum to 1")
        warmup_steps = int(max_update * phase_ratio[0])
        hold_steps = int(max_update * phase_ratio[1])
        decay_steps = int(max_update * phase_ratio[2])
    if warmup_steps + hold_steps + decay_steps <= 0:
        raise ValueError("tristage needs at least one step in some phase")
    init_lr = init_lr_scale * lr
    final_lr = final_lr_scale * lr
    warmup_rate = (lr - init_lr) / warmup_steps if warmup_steps else 0.0
    decay_factor = -math.log(final_lr_scale) / decay_steps if decay_steps else 0.0

    def schedule(step: float) -> float:
        step = float(step)
        w, h, d = float(warmup_steps), float(hold_steps), float(decay_steps)
        if step < w:
            return init_lr + warmup_rate * step
        if step < w + h:
            return lr
        if step <= w + h + d:
            return lr * math.exp(-decay_factor * (step - w - h))
        return final_lr

    return schedule


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    max_lr: float = 0.1,
    min_lr: float = 0.001,
    warmup_steps: int = 0,
    gamma: float = 1.0,
) -> Schedule:
    """Cosine annealing with warmup and restarts: per cycle, linear warmup
    min→max then cosine to min; the cycle length grows by ``cycle_mult`` and
    the peak shrinks by ``gamma`` at each restart."""
    if warmup_steps >= first_cycle_steps:
        raise ValueError("warmup_steps must be below first_cycle_steps")

    def schedule(step: float) -> float:
        step = float(step)
        if cycle_mult == 1.0:
            cycle = math.floor(step / first_cycle_steps)
            step_in_cycle = step - cycle * first_cycle_steps
            cur_cycle_steps = float(first_cycle_steps)
        else:
            cycle = math.floor(
                math.log(step / first_cycle_steps * (cycle_mult - 1.0) + 1.0)
                / math.log(cycle_mult)
            )
            start = first_cycle_steps * (cycle_mult ** cycle - 1.0) / (cycle_mult - 1.0)
            step_in_cycle = step - start
            cur_cycle_steps = first_cycle_steps * cycle_mult ** cycle
        cur_max = min_lr + (max_lr - min_lr) * gamma ** cycle
        if step_in_cycle < warmup_steps:
            return min_lr + (cur_max - min_lr) * step_in_cycle / warmup_steps
        return min_lr + 0.5 * (cur_max - min_lr) * (
            1.0 + math.cos(math.pi * (step_in_cycle - warmup_steps)
                           / (cur_cycle_steps - warmup_steps))
        )

    return schedule


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics), fed the eval
    moving-average loss by the trainer's epoch lr mode."""

    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
        cooldown: int = 0,
    ):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed an epoch metric; returns the (possibly reduced) current lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr, "best": self.best, "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.cooldown_counter = d["cooldown_counter"]
