"""Train-time waveform augmentation at batch assembly (port of
``speechlid_tpu/data/augmentor.py``).

The reference's ``wav_augment`` chain: dither → preemphasis → speed
{0.9, 1, 1.1} → pitch ±{20..80} cents → reverb.  Each call draws the
batch's variant (speed, then cents, then whether to reverberate) from a
``random.Random(seed)`` in the JAX augmentor's order, so the same seed picks
the same variants; the dither and the room impulse response come from a
``torch.Generator`` seeded with ``seed`` on the augmentor's device.

It runs where ``device`` says, the host by default: the feeder calls it in
its prefetch thread, ahead of the step on the card.  On ``cuda`` the wavs
go to the card and back.
"""

from __future__ import annotations

import random
from typing import Tuple, Union

import numpy as np
import torch

from speechlid_tpu_torch.core.precision import strict_float32
from speechlid_tpu_torch.ops.augment import dither, fir_reverb, pitch_shift, synthetic_rir
from speechlid_tpu_torch.ops.frontend import preemphasis
from speechlid_tpu_torch.ops.resample import speed_perturb

SPEEDS = (0.9, 1.0, 1.1)
PITCH_CENTS = (-80, -60, -40, -20, 0, 0, 20, 40, 60, 80)


class WavAugmentor:
    def __init__(
        self,
        sample_rate: int = 16000,
        speed: bool = False,
        pitch: bool = False,
        reverb: bool = False,
        use_dither: bool = True,
        use_preemphasis: bool = True,
        reverb_prob: float = 0.5,
        seed: int = 0,
        device: Union[str, torch.device] = "cpu",
    ):
        self.device = torch.device(device)
        strict_float32(self.device)  # the resample and reverb convolutions
        self.sample_rate = sample_rate
        self.speed = speed
        self.pitch = pitch
        self.reverb = reverb
        self.use_dither = use_dither
        self.use_preemphasis = use_preemphasis
        self.reverb_prob = reverb_prob
        self.rng = random.Random(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def apply(self, wavs: torch.Tensor, speed: float, cents: int, reverb: bool) -> torch.Tensor:
        """One variant of the chain on (B, T) ``wavs`` on the augmentor's
        device; the output keeps T."""
        x = wavs
        if self.use_dither:
            x = dither(self.generator, x)
        if self.use_preemphasis:
            x = preemphasis(x)
        if speed != 1.0:
            x = speed_perturb(x, self.sample_rate, speed, output_len=wavs.shape[1])
        if cents != 0:
            x = pitch_shift(x, self.sample_rate, float(cents))
        if reverb:
            x = fir_reverb(x, synthetic_rir(self.generator, self.sample_rate, rt60=0.3))
        return x

    def __call__(self, wavs: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        t = wavs.shape[1]
        speed = self.rng.choice(SPEEDS) if self.speed else 1.0
        cents = self.rng.choice(PITCH_CENTS) if self.pitch else 0
        use_reverb = self.reverb and self.rng.random() < self.reverb_prob
        out = self.apply(torch.from_numpy(wavs).to(self.device), speed, int(cents),
                         bool(use_reverb)).cpu().numpy()
        if speed != 1.0:
            lengths = np.minimum((lengths / speed).astype(np.int32), t)
        return out, lengths
