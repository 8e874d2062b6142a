"""Evaluation metrics on the host, in numpy: scores stream off the device
per eval batch and the metric state lives here."""

from speechlid_tpu_torch.metrics.cavg import CAvg, compute_cavg
from speechlid_tpu_torch.metrics.eer import EER, compute_eer, roc_curve
from speechlid_tpu_torch.metrics.error_rate import (
    Accuracy,
    CharErrorRate,
    WordErrorRate,
    edit_distance,
)
