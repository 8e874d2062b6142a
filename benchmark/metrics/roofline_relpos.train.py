"""roofline_relpos.train: Σ least time over Σ device time of the rel-pos attention kernels
in the profiled part: every kernel of the device trace whose name holds ``relpos_`` (the
forward, the backward's tiles and its sums; Shaw's form and the Transformer-XL form).

A launch's least time is its products over float32's peak outside the tensor cores
(``harness/counters.PEAK_FP32_FLOPS``), its sizes from the program's ``relpos_attn``
counter, which holds each launch's (direction, b, h, n, d, mask) while a profiler runs
(``speechlid_tpu_torch/core/profile.py``, ``counted``).  The products
(:func:`relpos_flops`) are those PERF.md §6 note 7 and ``chip_smoke.py``'s ``relpos_flops``
count, at the valid pairs: one FMA a valid query, valid key and channel for each of q·k, the
relative-position term and p·v in the forward, twice as many in the backward.  A pair is
valid where the launch's mask holds both its query and its key (every pair without a mask):
the kernels skip the tiles where no valid query meets a valid key, and a padded row only
takes its uniform weights.  A counter whose launches carry no mask (b, h, n, d alone)
counts every pair.  None for scoring, without a trace, where the program keeps no such
counter or counted no launch, or where the trace holds none of the kernels."""

from harness.counters import PEAK_FP32_FLOPS


def valid_pairs(b: int, n: int, mask=None) -> float:
    """Query-key pairs of one head whose query and key are both valid."""
    if mask is None:
        return float(b * n * n)
    rows = mask.reshape(b, n).sum(1).double()
    return float((rows * rows).sum())


def relpos_flops(direction: str, b: int, h: int, n: int, d: int, mask=None) -> float:
    forward = 3 * 2.0 * h * valid_pairs(b, n, mask) * d
    return forward if direction == "forward" else 2.0 * forward


def read(run):
    if run.mode != "train" or run.trace is None:
        return None
    from speechlid_tpu_torch.core import profile

    counted = getattr(profile._time_cost_recoder, "counted", None)
    launches = counted("relpos_attn") if counted else []
    device_s = sum(seconds for name, seconds in run.trace.kernels if "relpos_" in name)
    if not launches or not device_s:
        return None
    return 100.0 * sum(relpos_flops(*launch) for launch in launches) / PEAK_FP32_FLOPS / device_s
