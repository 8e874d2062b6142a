"""launches.score: the kernels in the profiled part's device trace over the
program's ``task.infer`` spans (one a batch) in it
(``speechlid_tpu_torch/core/profile.py``, ``span_summary``); None where
the program records no such span."""


def read(run):
    if run.mode != "score" or run.trace is None:
        return None
    from speechlid_tpu_torch.core import profile

    summary = getattr(profile._time_cost_recoder, "span_summary", None)
    count = (summary() if summary else {}).get("task.infer", (0, 0.0, None))[0]
    return len(run.trace.kernels) / count if count else None
