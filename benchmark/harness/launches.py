"""What each hand-kernel launch was given, recorded at the port's C
interface while the profiler runs, and paired with the launch's kernel in
the device trace.

The port calls its kernels through a ``ctypes`` library
(``speechlid_tpu_torch/ops/cuda/_build.lib()``).  :class:`LaunchRecorder`
puts a recording wrapper in front of each entry point for the traced span
and takes them away after: each call appends (entry, mode, sizes).  The
i-th recorded launch of a kernel family is the i-th kernel of that family
in the trace (one stream, so the order is kept); where the counts differ,
nothing is paired and the readers say nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from harness import counters

# entry point → (kernel family, a function of its arguments → (mode, sizes))
FAMILIES = {
    "depthwise_conv1d_fwd": "depthwise_conv1d_kernel",
    "depthwise_conv1d_glu_fwd": "depthwise_conv1d_kernel",
    "depthwise_conv1d_glu_bwd": "depthwise_conv1d_kernel",
    "depthwise_conv1d_bwd_w": "depthwise_bwd_w_kernel",
    "fbank_log_mel_f32": "fbank_log_mel_kernel",
}


@dataclass
class Launch:
    entry: str
    mode: str
    cost: Tuple[float, float]  # (bytes, operations)

    @property
    def family(self) -> str:
        return FAMILIES[self.entry]

    @property
    def layer(self) -> str:
        return "fbank" if self.entry.startswith("fbank") else "depthwise"

    @property
    def bound_s(self) -> float:
        return counters.bound_s(*self.cost)


def describe(entry: str, args: tuple) -> Launch:
    """Mode and (bytes, operations) of a call with these C arguments (the
    order of ``_build._SIGNATURES``)."""
    if entry == "depthwise_conv1d_fwd":
        b, t, c, k, _, flip, dtype = args[4:11]
        mode = "plain_dx" if flip else "plain"
        return Launch(entry, mode, counters.depthwise_cost(mode, b, t, c, k,
                                                           counters.DTYPE_BYTES[dtype]))
    if entry == "depthwise_conv1d_glu_fwd":
        mask, mean = args[1], args[4]
        b, t, c, k, _, dtype = args[12:18]
        mode = "glu" if mean is None else "glu_bn_act"
        return Launch(entry, mode, counters.depthwise_cost(
            mode, b, t, c, k, counters.DTYPE_BYTES[dtype], mask is not None))
    if entry == "depthwise_conv1d_glu_bwd":
        mask = args[3]
        b, t, c, k, _, dtype = args[5:11]
        return Launch(entry, "glu_dx", counters.depthwise_cost(
            "glu_dx", b, t, c, k, counters.DTYPE_BYTES[dtype], mask is not None))
    if entry == "depthwise_conv1d_bwd_w":
        b, t, c, k, _, dtype = args[4:10]
        return Launch(entry, "bwd_w", counters.depthwise_cost("bwd_w", b, t, c, k,
                                                              counters.DTYPE_BYTES[dtype]))
    if entry == "fbank_log_mel_f32":
        b, t, n_mels = args[1], args[2], args[10]
        return Launch(entry, "log_mel", counters.fbank_cost(b, t, n_mels))
    raise KeyError(entry)


class LaunchRecorder:
    """Records every hand-kernel launch made inside the ``with`` block."""

    def __init__(self, library):
        self.library = library
        self.launches: List[Launch] = []
        self._saved: Dict[str, object] = {}

    def __enter__(self):
        for entry in FAMILIES:
            original = getattr(self.library, entry)
            self._saved[entry] = original

            def wrapper(*args, _entry=entry, _original=original):
                self.launches.append(describe(_entry, args))
                return _original(*args)

            setattr(self.library, entry, wrapper)
        return self

    def __exit__(self, *exc):
        for entry, original in self._saved.items():
            setattr(self.library, entry, original)
        self._saved.clear()
        return False


def pair(launches: List[Launch], kernels: List[Tuple[str, float]]
         ) -> Optional[List[Tuple[Launch, float]]]:
    """(launch, its device seconds) for every recorded launch, or None when
    a family's counts in the trace and in the record differ.  ``kernels``:
    (name, seconds) of the trace's kernels in start order."""
    by_family: Dict[str, List[float]] = {}
    for name, seconds in kernels:
        for family in set(FAMILIES.values()):
            if family in name:
                by_family.setdefault(family, []).append(seconds)
    recorded: Dict[str, List[Launch]] = {}
    for launch in launches:
        recorded.setdefault(launch.family, []).append(launch)
    out = []
    for family, items in recorded.items():
        times = by_family.get(family, [])
        if len(times) != len(items):
            return None
        out.extend(zip(items, times))
    return out


def roofline_share(paired, layer: str) -> Optional[float]:
    """Σ least time over Σ device time of the layer's launches, in %."""
    if not paired:
        return None
    rows = [(launch.bound_s, seconds) for launch, seconds in paired if launch.layer == layer]
    if not rows:
        return None
    return 100.0 * sum(b for b, _ in rows) / sum(s for _, s in rows)
