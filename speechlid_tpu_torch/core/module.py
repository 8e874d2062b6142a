"""TaskModule — the user contract (port of ``speechlid_tpu/core/module.py``).

A task binds model + loss + metrics + optimizer.  The JAX contract is pure
device functions over a variables pytree; here the task owns an
``nn.Module`` (``self.model``) that the trainer steps in place:

- **device loops** (``train_loop`` / ``val_loop`` / ``test_loop``) take a
  batch of tensors on the task's device; ``train_loop`` returns ``(loss,
  metrics)`` with the loss still attached to the graph, and the trainer
  calls ``backward`` and the optimizer;
- **host hooks** (``*_loop_end``, ``before_train_loop``) run on materialized
  numpy metric dicts at epoch boundaries: streaming metrics accumulate and
  freeze schedules change there.

Hyper-parameters passed to ``save_hyper_parameters`` are stored in every
checkpoint so that ``resume_from_checkpoint`` and the server can
re-instantiate the task.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def _scalar_means(outputs: List[Dict], prefix: str) -> Dict[str, float]:
    agg: Dict[str, float] = {}
    if outputs:
        for k in outputs[0].keys():
            vals = [o[k] for o in outputs
                    if k in o and np.isscalar(o[k]) and np.isfinite(o[k])]
            if vals:
                agg[f"{prefix}{k}"] = float(np.mean(vals))
    return agg


class TaskModule:
    def __init__(self) -> None:
        self.hyper_parameters: Dict[str, Any] = {}
        self.trainer = None  # set by Trainer
        self.model: Optional[torch.nn.Module] = None
        self.device = torch.device("cpu")

    def save_hyper_parameters(self, ignore: Iterable[str] = (), **kwargs) -> None:
        self.hyper_parameters = {k: v for k, v in kwargs.items() if k not in set(ignore)}

    def set_generators(self, device_generator: torch.Generator,
                       host_generator: torch.Generator) -> None:
        """Take the run's explicit random streams: one on the task's device,
        one on the CPU for draws whose value the host needs."""
        raise NotImplementedError

    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw the model's fresh parameters from ``generator`` (on the CPU;
        the trainer's ``seed`` determines it): the counterpart of the JAX
        ``init_variables``.  The trainer calls it before the optimizer takes
        the parameters and before a resume overwrites them.  A caller that
        brings its own weights overrides it."""
        raise NotImplementedError

    def config_optim(self) -> Tuple[Any, Any]:
        """→ (optimizer, plateau_scheduler_or_None)."""
        raise NotImplementedError

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch (a dict of numpy arrays) → tensors on the task's
        device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # ----------------------------------------------------------- device loops
    def train_loop(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """→ (loss attached to the graph, metric dict)."""
        raise NotImplementedError

    def val_loop(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def test_loop(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.val_loop(batch)

    # ------------------------------------------------------------- host hooks
    def before_train_loop(self, epoch: int) -> None:
        """Change which parameters train this epoch (``requires_grad``)."""

    def train_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        """Aggregate per-step host metric dicts → epoch metrics."""
        return _scalar_means(outputs, "avg_train_")

    def val_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        return _scalar_means(outputs, "avg_val_")

    def test_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        return self.val_loop_end(outputs)

    # ------------------------------------------------------------- resumption
    @classmethod
    def resume_from_checkpoint(cls, ckpt_path: str, **override):
        """Re-instantiate from the saved hyper-parameters, then load the
        weights.  Returns (module, checkpoint)."""
        from speechlid_tpu_torch.core.checkpoint import load_checkpoint

        ckpt = load_checkpoint(ckpt_path)
        hparams = dict(ckpt["hyper_parameters"])
        hparams.update(override)
        module = cls(**hparams)
        module.model.load_state_dict(ckpt["state"]["model"])
        return module, ckpt
