"""Print accumulated host timing table each train epoch (port of
``speechlid_tpu/core/callbacks/profiler.py``; reference:
ccml/callbacks/profile_callback.py)."""

from __future__ import annotations

import logging

from speechlid_tpu_torch.core.callbacks.base import Callback
from speechlid_tpu_torch.core.profile import _time_cost_recoder


class ProfileCallback(Callback):
    def after_train_epoch(self, epoch: int, metrics) -> None:
        logging.info("\n%s", _time_cost_recoder.pretty_table())
        _time_cost_recoder.remove_recoder()
