"""Callback base (the port's copy of ``speechlid_tpu/core/callbacks/base.py``).

Hooks fire on the host at step/epoch boundaries with materialized metric
dicts; the Trainer dispatches by direct method call."""

from __future__ import annotations

from typing import Dict


class Callback:
    interval: int = 1  # epochs between activations

    def __init__(self, interval: int = 1) -> None:
        self.interval = interval
        self.trainer = None

    def add_trainer(self, trainer) -> None:
        self.trainer = trainer

    # lifecycle hooks
    def before_train_epoch(self, epoch: int) -> None: ...

    def after_train_loop(self, step: int, metrics: Dict) -> None: ...

    def after_train_epoch(self, epoch: int, metrics: Dict) -> None: ...

    def after_eval_loop(self, metrics: Dict) -> None: ...

    def after_eval_epoch(self, epoch: int, metrics: Dict) -> None: ...

    def test_loop_end(self, metrics: Dict) -> None: ...
