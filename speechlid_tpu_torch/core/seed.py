"""Deterministic seeding (port of ``speechlid_tpu/core/seed.py``).

Host RNGs (python, numpy: manifest shuffling, samplers) are seeded here.
The device randomness of a training run is carried explicitly: this returns
the ``torch.Generator``s the trainer hands to the task, one on the training
device (dropout, stochastic depth, SpecAugment masks) and one on the CPU
(draws whose value the host needs, such as the stretch rate).  The global
torch generator is left alone.
"""

from __future__ import annotations

import os
import random
from typing import Tuple, Union

import numpy as np
import torch


def seed_everything(
    seed: int, device: Union[str, torch.device] = "cpu"
) -> Tuple[torch.Generator, torch.Generator]:
    """Seed host RNGs and return (device generator, host generator)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    device_gen = torch.Generator(device=device).manual_seed(seed)
    host_gen = torch.Generator().manual_seed(seed + 1)
    return device_gen, host_gen
