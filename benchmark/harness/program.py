"""The system under test, built from a configuration file: the port's
``LidASRTask`` (and for training its ``Trainer``), with the benchmark's
weights loaded over whatever the program drew.  Nothing else of the
program is used."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from harness import weights as weights_mod


def build_task(config: dict, device):
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

    task_kwargs = dict(config["task"])
    if task_kwargs.get("featurizer") in ("wavlm", "wav2vec2"):
        task_kwargs["ssl_config"] = dict(config["ssl_config"])
    langs = config["langs"]
    return LidASRTask(lang2vocab=dict(langs), lang2index={k: i for i, k in enumerate(langs)},
                      device=device, **task_kwargs)


def build_trainer(config: dict, seed: int, device, callbacks):
    from speechlid_tpu_torch.core.trainer import Trainer

    return Trainer(accum_grad=config["trainer"]["accum_grad"], seed=seed,
                   callbacks=callbacks, use_progress_bar=False, device=device)


def load_weights(task, seed: int, device) -> list:
    """The benchmark's weights into the task's model; → the (name, shape)
    list they were made for, from which the reference makes them again."""
    shapes = weights_mod.float_entries(task.model)
    made = weights_mod.make_weights(shapes, seed, device)
    weights_mod.load_into(task.model, made)
    return shapes


def kernel_library() -> Optional[object]:
    """The port's CUDA kernel library (built on first use), or None off the
    card."""
    if not torch.cuda.is_available():
        return None
    from speechlid_tpu_torch.ops.cuda import _build

    return _build.lib()


class Phases:
    """Seconds of each named phase of the set-up, each call closing one
    (the card synchronised first, so that its work counts where it ran)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def __call__(self, name: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now
