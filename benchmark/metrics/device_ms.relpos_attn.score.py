"""device_ms.relpos_attn.score: the milliseconds, on the card's stream, of the program's
``model.relpos_attn`` spans (the rel-pos attention core of every Conformer block, encoder
and heads) summed over a batch: their mean times their count over the ``task.infer`` spans,
over the profiled part (``speechlid_tpu_torch/core/profile.py``, ``span_summary``); None
where the program records no such span."""


def read(run):
    if run.mode != "score":
        return None
    from speechlid_tpu_torch.core import profile

    summary = getattr(profile._time_cost_recoder, "span_summary", None)
    summary = summary() if summary else {}
    count, _, device_ms = summary.get("model.relpos_attn", (0, 0.0, None))
    batches = summary.get("task.infer", (0, 0.0, None))[0]
    return device_ms * count / batches if count and batches and device_ms is not None else None
