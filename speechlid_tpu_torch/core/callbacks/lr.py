"""Log the current lr each epoch."""

from __future__ import annotations

from speechlid_tpu_torch.core.callbacks.base import Callback


class LrCallback(Callback):
    def after_train_epoch(self, epoch: int, metrics) -> None:
        if self.trainer is not None:
            self.trainer.logger.log(
                {"lr": self.trainer.current_lr()}, step=self.trainer.global_step
            )
