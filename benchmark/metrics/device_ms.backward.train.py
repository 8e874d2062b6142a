"""device_ms.backward.train: the mean milliseconds, on the card's stream, of the program's
``trainer.backward`` span (one a batch) over the profiled part
(``speechlid_tpu_torch/core/profile.py``, ``span_summary``); None where
the program records no such span."""


def read(run):
    if run.mode != "train":
        return None
    from speechlid_tpu_torch.core import profile

    summary = getattr(profile._time_cost_recoder, "span_summary", None)
    count, _, device_ms = (summary() if summary else {}).get("trainer.backward", (0, 0.0, None))
    return device_ms if count else None
