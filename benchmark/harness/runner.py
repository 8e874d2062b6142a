"""One run of one cell: set-up, the window (untraced, or a host-clock part
then a profiled part), the check against the reference, the result line.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1``
measures the first ``1 - TRACED_SHARE`` of the window on the host clock
(``dispatch_ms``, ``mfu``) and profiles the rest (rooflines, idle share,
``busy_s``, the breakdown), and reports the per-layer metrics.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from harness import counters, launches, program, spec
from harness import trace as trace_mod

TRACED_SHARE = 0.25
# what the check may not find in the process once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speechlid_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, as a whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: spec.Cell
    mode: str
    window: object = None                    # the host-clock part's Window
    trace: Optional[trace_mod.Trace] = None  # the profiled part
    paired: Optional[list] = None            # (launch, device seconds)


def mode_class(cell: spec.Cell):
    if cell.mode == "score":
        from harness.score import ScoreCell
        return ScoreCell
    if cell.mode == "train":
        from harness.train import TrainCell
        return TrainCell
    raise ValueError(f"unknown mode {cell.mode!r}")


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
        started: Optional[float] = None) -> dict:
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    on_card = device.type == "cuda"
    before = time.perf_counter() - started
    state = mode_class(cell)(cell, seed, device)
    setup_s = time.perf_counter() - started
    phases = {"imports": before, **state.setup_phases}
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in phases.items()), file=sys.stderr)

    r = Run(cell, cell.mode)
    if not traced:
        window = state.loop(seconds)
    else:
        window = state.loop(seconds * (1.0 - TRACED_SHARE))
        library = program.kernel_library()
        if library is not None:
            holder = {}
            with launches.LaunchRecorder(library) as rec:
                r.trace = trace_mod.profile(
                    lambda: holder.setdefault("w", state.loop(seconds * TRACED_SHARE)))
            r.paired = launches.pair(rec.launches, r.trace.kernels)
    r.window = window
    attempted, failed = window.rows, window.failed
    if traced and r.trace is not None:
        attempted += holder["w"].rows
        failed += holder["w"].failed
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    state.free()
    if on_card:
        torch.cuda.empty_cache()
    numbers = {k: (v if math.isfinite(v) else float("inf")) for k, v in state.check().items()}
    limits = cell.params["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits) and failed == 0

    metrics: Dict[str, dict] = {}
    if not traced:
        values = dict(state.end_to_end(window), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        readers = spec.load_readers([m["name"] for m in cell.per_layer])
        for m in cell.per_layer:
            value = readers[m["name"]](r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced and r.trace is not None:
        result["device"]["busy_s"] = r.trace.busy_s
        result["device"]["window_s"] = r.trace.window_s
        result["breakdown"] = {"device_ops": r.trace.device_ops,
                               "idle_gaps": r.trace.idle_gaps}
    result["checks"] = checks
    return result


def mfu(r: Run, train: bool) -> Optional[float]:
    """The window's model FLOPs over its seconds and the float32 peak, %."""
    w = r.window
    if w is None or r.mode != ("train" if train else "score") or not w.seconds:
        return None
    return 100.0 * w.flops / (w.seconds * counters.PEAK_FP32_FLOPS)


def roofline(r: Run, layer: str, train: bool) -> Optional[float]:
    if r.mode != ("train" if train else "score"):
        return None
    return launches.roofline_share(r.paired, layer)


def idle_share(r: Run, train: bool) -> Optional[float]:
    if r.mode != ("train" if train else "score") or r.trace is None or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def dispatch_ms(r: Run, train: bool) -> Optional[float]:
    w = r.window
    if w is None or r.mode != ("train" if train else "score"):
        return None
    if train:
        return 1e3 * w.dispatch_s / max(w.steps, 1)
    return 1e3 * w.infer_s / max(w.batches, 1)
