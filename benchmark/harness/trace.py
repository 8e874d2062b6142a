"""The device trace of a span: ``torch.profiler`` with CUDA activity only
(recording every host operator as well slows a launch-bound loop, and so
would swell the idle share it reports), exported as a Chrome trace into
the run's ``TMPDIR``, read back and deleted.

From it: the span's length (its ``bench.traced`` annotation where the trace
has it, else from the first to the last CUDA event), the device's busy
seconds (the union of every kernel, copy and set interval inside it), the
kernels in start order, the ten device operations that took most time and
the ten largest idle totals, each gap named by what the host was doing at
its middle: the CUDA runtime call it was in, else ``host: between CUDA
calls`` (Python and the operators' own host work).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "bench.traced"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def profile(fn: Callable[[], None]) -> Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def read(events: List[dict]) -> Trace:
    """Chrome-trace events (times in µs) → :class:`Trace` (seconds)."""
    spans = [e for e in events if e.get("name") == SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    timed = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + HOST_CATS]
    if spans:
        t0 = float(spans[0]["ts"])
        t1 = t0 + float(spans[0]["dur"])
    elif timed:
        t0 = min(float(e["ts"]) for e in timed)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
    else:
        return Trace()
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                     e.get("cat")) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    device = [d for d in device if d[0] < t1 and d[1] > t0]
    busy = _union([(max(s, t0), min(e, t1)) for s, e, _, _ in device])
    trace = Trace(window_s=(t1 - t0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6)
    trace.kernels = [(name, (e - s) * 1e-6) for s, e, name, cat in device if cat == "kernel"]
    totals = {}
    for s, e, name, _ in device:
        totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
    trace.device_ops = [[n, v] for n, v in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        name = "host: between CUDA calls"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 200, -1), -1):  # the latest-starting call around mid
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    trace.idle_gaps = [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
    return trace
