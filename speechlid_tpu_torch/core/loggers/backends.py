"""Logger backends that need a package beyond torch (port of
``speechlid_tpu/core/loggers/backends.py``): ``TensorboardLogger`` over
``torch.utils.tensorboard``.  Without the ``tensorboard`` package it warns
once and logs nothing, as the JAX backend does.  The wandb and comet
backends are not ported (their packages are not installed)."""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

from speechlid_tpu_torch.core.loggers import BaseLogger


class TensorboardLogger(BaseLogger):
    """One event-file directory a run (``<log_dir>/<run_name>``); each
    metric key keeps its own step counter, which ``state_dict`` carries
    across a resume (the reference's ``tensorboard_logger.py``)."""

    def __init__(self, log_dir: str = "exp/tb") -> None:
        self.log_dir = log_dir
        self._writer = None
        self._steps: Dict[str, int] = {}

    def init(self, run_name: str, config: Optional[Dict] = None) -> None:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logging.warning("TensorboardLogger disabled: %s", e)
            return
        self._writer = SummaryWriter(os.path.join(self.log_dir, run_name))

    def log(self, data: Dict[str, Any], step: int) -> None:
        if self._writer is None:
            return
        for k, v in data.items():
            self._steps[k] = self._steps.get(k, 0) + 1
            try:
                value = float(v)
            except (TypeError, ValueError):  # an array or a string: not a scalar
                continue
            self._writer.add_scalar(k, value, self._steps[k])

    def state_dict(self) -> Dict:
        return {"steps": dict(self._steps)}

    def load_state_dict(self, state: Dict) -> None:
        self._steps = dict(state.get("steps", {}))

    def finish(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
