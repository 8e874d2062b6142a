"""The port's profiler registry (port of ``speechlid_tpu/core/profile.py``,
the reference's singleton ``TimeCostRecoder``, ccml/utils/profile.py:8-68)
and its device trace.

One registry, :data:`_time_cost_recoder`, holds two kinds of record:

- ``measure(key)``: host seconds and calls per key, always on.  The
  trainer keeps three: ``get_batch`` (the loader's ``next``),
  ``batch_to_device`` and ``train_step_dispatch`` (the host's time to
  launch a batch's work); :meth:`TimeCostRecoder.snapshot` reads them.
- ``span(name)``: a span at a layer boundary, recorded only while a
  ``torch.profiler`` runs (``torch.autograd.profiler._is_profiler_enabled``:
  :func:`device_trace`, ``Trainer(profile_dir=…)``, a benchmark's traced
  part).  Otherwise a span costs one flag check and records nothing.  A
  recorded span (:class:`Span`) keeps its name, its parent (the span open
  around it on its thread), the step or batch id it belongs to (its own
  ``batch=``, else its parent's), its host start and end
  (``time.perf_counter_ns``) and, where CUDA is initialised, a pair of
  timing events on the current stream, resolved into ``device_ms`` when the
  records are read, never on the hot path.  It also enters
  ``torch.profiler.record_function(name)``, so it lands in the profiler's
  Chrome trace as a ``user_annotation`` beside the device's activity, on the
  profiler's clock.  A span opened while a rematerialized block runs again
  for its backward (``models/remat.recomputing()``) with no span open on
  its thread (autograd's device thread) takes the open ``trainer.backward``
  as its parent: it is the backward's work.  Records stay in memory until
  :meth:`TimeCostRecoder.remove_recoder`, at most :data:`MAX_SPANS` of them;
  a span past the cap still annotates the trace and is counted in
  ``dropped``.  :meth:`TimeCostRecoder.spans` and
  :meth:`TimeCostRecoder.span_summary` read them.

The program's spans, each a layer boundary of PERF.md §3:

- ``trainer.step`` (id ``global_step``) ⊃ ``trainer.forward``
  (``module.train_loop``), ``trainer.backward``, ``trainer.optimizer`` (at
  the accumulation boundary only; ⊃ ``trainer.grad_sync`` under a mesh) and
  ``trainer.fetch`` (the previous step's metrics to the host, where the host
  waits for the card);
- ``task.infer`` (id: the batch's number through one ``infer_fn()``),
  ``task.frontend`` (the featurizer's input), ``task.loss`` (CTC);
- ``model.featurizer`` ⊃ ``model.extractor`` (its convolutional front),
  ``model.heads``, ``model.scores`` (the confidences and discriminator).

``device_ms`` is the time between the span's two events on the stream, so
it holds any time the card waited for the host inside the span.

:func:`device_trace` is the JAX package's ``device_trace`` (a
``jax.profiler`` trace around a region) over ``torch.profiler``: the host's
and, on the card, CUDA's activity, written as one Chrome trace
(``<log_dir>/<name>.pt.trace.json``, viewable in Perfetto or
``chrome://tracing``), the spans among it.  ``torch.profiler`` may drop
kernel records late in a long process, so a trace is a report, not a
count.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from speechlid_tpu_torch.models.remat import recomputing

MAX_SPANS = 1 << 16
BACKWARD = "trainer.backward"


class Span:
    """One recorded span; ``parent`` is a :class:`Span` or None."""

    __slots__ = ("name", "parent", "batch", "start_ns", "end_ns", "_events", "_device_ms")

    def __init__(self, name: str, parent: Optional["Span"], batch: Optional[int]):
        self.name, self.parent, self.batch = name, parent, batch
        self.start_ns = self.end_ns = None
        self._events = None
        self._device_ms: Optional[float] = None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else 1e-6 * (self.end_ns - self.start_ns)

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on its stream; None
        without CUDA or while the span is open."""
        if self._events is not None and self.end_ns is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


_OFF = contextlib.nullcontext()  # the span of a process that no profiler watches


class _On:
    def __init__(self, recoder: "TimeCostRecoder", name: str, batch: Optional[int]):
        self.recoder, self.name, self.batch = recoder, name, batch
        self.record: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        rec = self.recoder
        self.annotation = _autograd_profiler.record_function(self.name)
        self.annotation.__enter__()
        stack = rec._stack()
        parent = stack[-1] if stack else None
        if parent is None and recomputing() and rec._backward:
            parent = rec._backward[-1]
        batch = self.batch if self.batch is not None else getattr(parent, "batch", None)
        with rec._data_lock:
            if len(rec._spans) >= MAX_SPANS:
                rec.dropped += 1
                return None
            record = Span(self.name, parent, batch)
            rec._spans.append(record)
        if torch.cuda.is_initialized():
            record._events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
            record._events[0].record()
        stack.append(record)
        if self.name == BACKWARD:
            rec._backward.append(record)
        self.record = record
        record.start_ns = time.perf_counter_ns()
        return record

    def __exit__(self, *exc):
        record = self.record
        if record is not None:
            record.end_ns = time.perf_counter_ns()
            if record._events is not None:
                record._events[1].record()
            self.recoder._stack().pop()
            if self.name == BACKWARD:
                self.recoder._backward.pop()
        self.annotation.__exit__(*exc)
        return False


class TimeCostRecoder:
    """Thread-safe registry of host costs per key and of spans (the module
    docstring says what records when).

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
        self._spans: List[Span] = []
        self.dropped = 0
        self._local = threading.local()
        self._backward: List[Span] = []

    def update_recoder(self, key: str, cost: float) -> None:
        with self._data_lock:
            self.recorder[key] = self.recorder.get(key, 0.0) + cost
            self.counts[key] = self.counts.get(key, 0) + 1

    def remove_recoder(self) -> None:
        with self._data_lock:
            self.recorder.clear()
            self.counts.clear()
            self._spans.clear()
            self.dropped = 0

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

    # ------------------------------------------------------------------ spans
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, batch: Optional[int] = None):
        """A context recording the span ``name`` while a profiler runs;
        ``batch``: the step or batch id (default: the parent's)."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _On(self, name, batch)

    def spans(self) -> List[Span]:
        """The recorded spans in the order they opened."""
        with self._data_lock:
            return list(self._spans)

    def span_summary(self) -> Dict[str, Tuple[int, float, Optional[float]]]:
        """name → (closed spans, mean host ms, mean device ms; None where a
        span has no device time)."""
        by_name: Dict[str, List[Span]] = {}
        for s in self.spans():
            if s.end_ns is not None:
                by_name.setdefault(s.name, []).append(s)
        out = {}
        for name, items in by_name.items():
            device = [s.device_ms for s in items]
            out[name] = (len(items), sum(s.host_ms for s in items) / len(items),
                         None if None in device else sum(device) / len(items))
        return out


_time_cost_recoder = TimeCostRecoder()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, name: str = "trace", cuda: bool = False):
    """Profile the region with ``torch.profiler`` (the CPU, and CUDA when
    ``cuda``) and write ``<log_dir>/<name>.pt.trace.json``; the program's
    spans record meanwhile.  With no ``log_dir``, run no profiler at all.
    Yields the profiler or None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))
