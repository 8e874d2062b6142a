"""Waveform-domain augmentation and corruption, batched (port of
``speechlid_tpu/ops/augment.py``).

- dither and additive white gaussian noise at a target SNR;
- eval-time mixing of a noise recording at a target SNR (:func:`mix_at_snr`);
- pitch shift by resampling (``ops/resample.py``) and linear
  re-interpolation to the original length;
- reverb as an FIR convolution with a synthetic room impulse response.

Everything runs on the device of its input.  Where the JAX function takes a
PRNG key, this one takes a ``torch.Generator`` on that device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.ops.resample import resample


def dither(generator: torch.Generator, wav: torch.Tensor, amount: float = 1e-5) -> torch.Tensor:
    """wav + amount · U[0, 1) (uniform, as the reference's ``rand_like``)."""
    noise = torch.rand(wav.shape, generator=generator, dtype=wav.dtype, device=wav.device)
    return wav + amount * noise


def _signal_power(x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean power per utterance over the valid prefix. (..., T) → (...,)."""
    if lengths is None:
        return (x ** 2).mean(dim=-1)
    mask = (torch.arange(x.shape[-1], device=x.device) < lengths[..., None]).to(x.dtype)
    n = lengths.to(x.dtype).clamp_min(1.0)
    return ((x * mask) ** 2).sum(dim=-1) / n


def _snr_factor(snr_db) -> torch.Tensor:
    """10^(snr/10) in float32."""
    return 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)


def awgn(
    generator: torch.Generator,
    wav: torch.Tensor,
    snr_db,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Additive white gaussian noise at the target SNR over the valid
    prefix's power."""
    pn = _signal_power(wav, lengths) / _snr_factor(snr_db).to(wav.device)
    noise = torch.randn(wav.shape, generator=generator, dtype=wav.dtype, device=wav.device)
    return wav + pn.sqrt()[..., None] * noise


def mix_at_snr(
    wav: torch.Tensor,
    noise: torch.Tensor,
    snr_db,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mix a noise recording into ``wav`` so that 10·log10(Ps / Pn) equals
    ``snr_db`` over the valid prefix: ``noise`` (B, T), already cropped or
    tiled to the wav's length on the host, is scaled by
    √(Ps / max(Pn, 1e-12) / 10^(snr/10)).  The JAX function's unused key
    has no counterpart here."""
    ps = _signal_power(wav, lengths)
    pn = _signal_power(noise, lengths)
    scale = (ps / pn.clamp_min(1e-12) / _snr_factor(snr_db).to(wav.device)).sqrt()
    return wav + scale[..., None] * noise


def pitch_shift(wav: torch.Tensor, sample_rate: int, n_cents: float) -> torch.Tensor:
    """Duration-preserving pitch shift by ``n_cents``: resample by
    r = 2^(cents/1200) as ``num/1000`` reduced by their gcd (length ≈ T/r),
    then re-interpolate linearly at ``linspace(0, src_len - 1, T)``.

    The positions are computed as XLA evaluates the JAX function's
    ``jnp.linspace`` (i · ((src_len - 1) · (1/(T - 1))) in float32, the last
    exactly src_len - 1): at 4 s a float32 ulp of a position is 0.004
    samples, so another rounding would move the output by more than the
    parity tests allow."""
    if n_cents == 0:
        return wav
    r = 2.0 ** (n_cents / 1200.0)
    num = int(round(r * 1000))
    g = math.gcd(num, 1000)
    shifted = resample(wav, num // g, 1000 // g)
    t = wav.shape[-1]
    src_len = shifted.shape[-1]
    step = np.float32(src_len - 1) * (np.float32(1.0) / np.float32(max(t - 1, 1)))
    pos = torch.arange(t, dtype=torch.float32, device=wav.device) * float(step)
    if t > 1:
        pos[-1] = src_len - 1
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(src_len - 1)
    frac = pos - lo.to(torch.float32)
    return shifted[..., lo] * (1.0 - frac) + shifted[..., hi] * frac


def synthetic_rir(
    generator: torch.Generator,
    sample_rate: int = 16000,
    rt60: float = 0.3,
    length: int = 2048,
) -> torch.Tensor:
    """Exponentially decaying gaussian noise, −60 dB at ``rt60``, unit norm:
    the statistical stand-in for sox's ``reverb``.  On the generator's
    device."""
    t = torch.arange(length, device=generator.device) / sample_rate
    envelope = torch.exp(-6.908 * t / rt60)
    h = envelope * torch.randn(length, generator=generator, device=generator.device)
    return h / torch.linalg.vector_norm(h).clamp_min(1e-9)


def fir_reverb(wav: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """Causal convolution of (B, T) with an RIR (K,), keeping length T (the
    direct path at t = 0): a cross-correlation with the flipped RIR over
    k − 1 samples of left padding."""
    k = rir.shape[0]
    out = F.conv1d(F.pad(wav[:, None, :], (k - 1, 0)), rir.flip(0)[None, None, :])
    return out[:, 0, :]
