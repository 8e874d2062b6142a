"""Sinc-interpolation resampling as a strided polyphase convolution (port of
``speechlid_tpu/ops/resample.py``).

The same filter bank as torchaudio's ``resample`` (``sinc_interp_hann``,
``lowpass_filter_width`` 6, ``rolloff`` 0.99), built in float64 on the host
and cast to float32.  :func:`speed_perturb` is sox's ``speed``: resample
rate → rate/s and play at the rate.  Both run on the device of their input.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    """(new_freq, kernel_width) polyphase bank + one-sided pad width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (-idx[None, :] + np.arange(new_freq)[:, None] / new_freq) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    sinc = np.where(t == 0.0, 1.0, np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
    kernels = sinc * window * (base_freq / orig_freq)
    return kernels.astype(np.float32), width


def resample(
    wav: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """(B, T) at orig_freq → (B, ceil(T·new/orig)) at new_freq: one conv of
    stride ``orig`` with ``new`` output channels, one per phase, the phases
    then interleaved."""
    if orig_freq == new_freq:
        return wav
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // gcd, int(new_freq) // gcd
    kernels, width = _sinc_kernel(orig, new, lowpass_filter_width, rolloff)
    b, t = wav.shape
    target_len = -(-t * new // orig)  # ceil
    x = F.pad(wav.to(torch.float32)[:, None, :], (width, width + orig))
    weight = torch.from_numpy(kernels).to(wav.device)[:, None, :]  # (new, 1, K)
    out = F.conv1d(x, weight, stride=orig)  # (B, new, ceil((T + orig) / orig))
    return out.transpose(1, 2).reshape(b, -1)[:, :target_len]


def _fit(wav: torch.Tensor, length: int) -> torch.Tensor:
    """Cut or zero-pad the last axis to ``length``."""
    if wav.shape[-1] >= length:
        return wav[..., :length]
    return F.pad(wav, (0, length - wav.shape[-1]))


def speed_perturb(
    wav: torch.Tensor, sample_rate: int, speed: float, output_len: int
) -> torch.Tensor:
    """sox ``speed s``: the speed as n/100 reduced (0.9 → 9/10, 1.1 → 11/10),
    resampled by it and cut or zero-padded to ``output_len``.  The true new
    length is ``ceil(T / s)``; the caller tracks it."""
    if speed == 1.0:
        return _fit(wav, output_len)
    frac_num = int(round(speed * 100))
    g = math.gcd(frac_num, 100)
    return _fit(resample(wav, frac_num // g, 100 // g), output_len)
