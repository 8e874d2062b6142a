"""device_ms.conv_module.train: the milliseconds, on the card's stream, of the program's
``model.conv_module`` spans (every Conformer conv module the forward runs, encoder and own
head: its LayerNorm, both pointwise GEMMs and the depthwise kernel between them; its forward
only) summed over a forward: their mean times their count over the ``trainer.forward`` spans,
over the profiled part (``speechlid_tpu_torch/core/profile.py``, ``span_summary``); None where
the program records no such span."""


def read(run):
    if run.mode != "train":
        return None
    from speechlid_tpu_torch.core import profile

    summary = getattr(profile._time_cost_recoder, "span_summary", None)
    summary = summary() if summary else {}
    count, _, device_ms = summary.get("model.conv_module", (0, 0.0, None))
    forwards = summary.get("trainer.forward", (0, 0.0, None))[0]
    return device_ms * count / forwards if count and forwards and device_ms is not None else None
