"""Optimizers and LR schedules of the port."""

from speechlid_tpu_torch.core.optim.factory import Optimizer, make_optimizer
from speechlid_tpu_torch.core.optim.schedules import (
    ReduceLROnPlateau,
    cosine_annealing_warmup_restarts,
    tristage_schedule,
)
