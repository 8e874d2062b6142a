"""Host-side wall-clock profiler registry (port of
``speechlid_tpu/core/profile.py``, the reference's singleton
``TimeCostRecoder``, ccml/utils/profile.py:8-68): accumulates wall time and
call counts per key, with a decorator for instrumenting hot host functions.

:func:`device_trace` is the JAX package's ``device_trace`` (a
``jax.profiler`` trace around a region) over ``torch.profiler``: the host's
and, on the card, CUDA's activity, written as one Chrome trace
(``<log_dir>/<name>.pt.trace.json``, viewable in Perfetto or
``chrome://tracing``).  ``torch.profiler`` may drop kernel records late in
a long process, so a trace is a report, not a count.

Device time is *not* measured here: CUDA launches return before the card
finishes, so a caller that times device work synchronises first.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from functools import wraps
from typing import Callable, Dict, Optional, Tuple


class TimeCostRecoder:
    """Thread-safe accumulator of wall-clock cost per named key.

    (Name keeps the reference's spelling for API familiarity.)
    """

    _instance: Optional["TimeCostRecoder"] = None
    _lock = threading.Lock()

    def __new__(cls):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    inst = super().__new__(cls)
                    inst._init_once()
                    cls._instance = inst
        return cls._instance

    def _init_once(self) -> None:
        self._data_lock = threading.Lock()
        self.recorder: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update_recoder(self, key: str, cost: float) -> None:
        with self._data_lock:
            self.recorder[key] = self.recorder.get(key, 0.0) + cost
            self.counts[key] = self.counts.get(key, 0) + 1

    def remove_recoder(self) -> None:
        with self._data_lock:
            self.recorder.clear()
            self.counts.clear()

    def pretty_table(self) -> str:
        with self._data_lock:
            rows = sorted(self.recorder.items(), key=lambda kv: -kv[1])
            lines = [f"{'key':<42}{'total_s':>12}{'count':>9}{'avg_ms':>11}"]
            for key, total in rows:
                n = max(self.counts.get(key, 1), 1)
                lines.append(f"{key:<42}{total:>12.4f}{n:>9}{1e3 * total / n:>11.3f}")
        return "\n".join(lines)

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._data_lock:
            return {k: (v, self.counts.get(k, 0)) for k, v in self.recorder.items()}

    @contextlib.contextmanager
    def measure(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.update_recoder(key, time.perf_counter() - t0)


_time_cost_recoder = TimeCostRecoder()


def register_cost_statistic(need_return: bool = True) -> Callable:
    """Decorator accumulating wall time of the wrapped fn into the registry."""

    def decorate(fn: Callable) -> Callable:
        key = f"{fn.__module__}.{fn.__qualname__}"

        @wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:  # record even when fn raises (measure() semantics)
                result = fn(*args, **kwargs)
            finally:
                _time_cost_recoder.update_recoder(
                    key, time.perf_counter() - t0
                )
            if need_return:
                return result
            return None

        return wrapper

    return decorate


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, name: str = "trace", cuda: bool = False):
    """Profile the region with ``torch.profiler`` (the CPU, and CUDA when
    ``cuda``) and write ``<log_dir>/<name>.pt.trace.json``; with no
    ``log_dir``, run no profiler at all.  Yields the profiler or None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))
