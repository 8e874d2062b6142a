"""Plain float32 audio frontend of the benchmark's reference.

Written from the equations, not from the program: per-utterance wave
normalisation, a centred reflect-padded STFT (Hann window of 400 taps,
n_fft 512, hop 160) as a product of the frames with a windowed DFT basis,
an HTK mel filterbank without norm, power to dB (amin 1e-10) and the
per-utterance 80 dB floor over the valid frames; in training the time
stretch (one rate a batch) and SpecAugment, whose random draws are made in
the same order and shapes as the program makes them, from the generators
the benchmark hands to both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_FFT, WIN, HOP = 512, 400, 160
TOP_DB = 80.0


def normalize_wav(wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-6) over each row's valid prefix (unbiased
    std); padded samples 0."""
    valid = torch.arange(wav.shape[-1], device=wav.device)[None, :] < lengths[:, None]
    n = lengths.to(wav.dtype)[:, None].clamp_min(1.0)
    mean = torch.where(valid, wav, 0.0).sum(-1, keepdim=True) / n
    centred = torch.where(valid, wav - mean, 0.0)
    std = (centred.square().sum(-1, keepdim=True) / (n - 1.0).clamp_min(1.0)).sqrt()
    return torch.where(valid, (wav - mean) / (std + 1e-6), 0.0)


def least_flops(frames: int, n_mels: int) -> float:
    """Products the log-mel of ``frames`` frames needs at the least: a
    real-input FFT of N_FFT points a frame (2.5 N log2 N, half of a complex
    FFT's 5 N log2 N) and the mel projection over the filterbank's nonzeros
    (each bin lies in at most two triangles: two multiply-adds a bin).  The
    reference's own dense DFT product costs about 36 times more; this count
    does not depend on how the STFT is computed."""
    bins = N_FFT // 2 + 1
    return float(frames) * (2.5 * N_FFT * math.log2(N_FFT) + 4.0 * bins)


def frame_lengths(lengths: torch.Tensor) -> torch.Tensor:
    return 1 + torch.div(lengths, HOP, rounding_mode="floor")


def dft_basis(device) -> torch.Tensor:
    """(WIN, 2·bins) [hann·cos | hann·sin] over the window's 400 taps (the
    window centred in n_fft: taps outside it are zero and left out)."""
    bins = N_FFT // 2 + 1
    n = torch.arange(WIN, dtype=torch.float64) + (N_FFT - WIN) // 2
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(WIN, dtype=torch.float64) / WIN)
    ang = 2 * math.pi * n[:, None] * torch.arange(bins, dtype=torch.float64)[None, :] / N_FFT
    basis = torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1) * hann[:, None]
    return basis.float().to(device)


def mel_fb(n_mels: int, sample_rate: int, device) -> torch.Tensor:
    """(bins, n_mels) HTK triangles from 0 Hz to Nyquist, no norm."""
    bins = N_FFT // 2 + 1
    freqs = torch.linspace(0.0, sample_rate // 2, bins, dtype=torch.float64)
    hi = 2595.0 * math.log10(1.0 + (sample_rate / 2) / 700.0)
    mels = torch.linspace(0.0, hi, n_mels + 2, dtype=torch.float64)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    lo_edge, centre, hi_edge = hz[:-2], hz[1:-1], hz[2:]
    up = (freqs[:, None] - lo_edge[None, :]) / (centre - lo_edge)[None, :]
    down = (hi_edge[None, :] - freqs[:, None]) / (hi_edge - centre)[None, :]
    return torch.clamp(torch.minimum(up, down), min=0.0).float().to(device)


def log_mel(wav: torch.Tensor, lengths: torch.Tensor, n_mels: int,
            sample_rate: int) -> torch.Tensor:
    """(B, T) normalised wave → (B, n_mels, 1 + T // hop) dB mel with the
    80 dB floor under each row's peak over its valid frames."""
    pad = N_FFT // 2
    x = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    lo = (N_FFT - WIN) // 2
    frames = x.unfold(-1, N_FFT, HOP)[..., lo:lo + WIN]  # (B, F, WIN)
    spec = frames @ dft_basis(wav.device)
    bins = N_FFT // 2 + 1
    power = spec[..., :bins].square() + spec[..., bins:].square()
    mel = power @ mel_fb(n_mels, sample_rate, wav.device)  # (B, F, n_mels)
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    f_len = frame_lengths(lengths)
    valid = torch.arange(db.shape[1], device=db.device)[None, :] < f_len[:, None]
    peak = db.masked_fill(~valid[:, :, None], -math.inf).amax(dim=(1, 2), keepdim=True)
    return torch.maximum(db, peak - TOP_DB).transpose(1, 2)


def time_stretch(host_gen: torch.Generator, spec: torch.Tensor, f_len: torch.Tensor):
    """One rate of (0.9, 1.0, 1.1) drawn on the host generator; linear
    interpolation at steps 0, rate, 2·rate, … cropped or zero-padded back to
    the input width; the lengths ceil(len / rate), at most the width."""
    rate = (0.9, 1.0, 1.1)[int(torch.randint(3, (1,), generator=host_gen))]
    if rate == 1.0:
        return spec, f_len
    t = spec.shape[-1]
    steps = torch.arange(math.ceil(t / rate), device=spec.device, dtype=torch.float32) * rate
    low = steps.floor().long()
    high = (low + 1).clamp_max(t - 1)
    frac = torch.remainder(steps, 1.0)
    out = (1.0 - frac) * spec[..., low] + frac * spec[..., high]
    out = out[..., :t] if out.shape[-1] >= t else F.pad(out, (0, t - out.shape[-1]))
    new_len = torch.ceil(f_len.to(torch.float32) / rate).to(f_len.dtype).clamp_max(t)
    return out, new_len


def _keep(gen, batch: int, axis: int, bound, n: int, device) -> torch.Tensor:
    width = torch.rand(n, batch, generator=gen, device=device) * bound
    start = torch.rand(n, batch, generator=gen, device=device) * (axis - width)
    idx = torch.arange(axis, device=device, dtype=torch.float32)
    hit = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    return ~hit.any(dim=0)  # (B, axis)


def spec_augment(gen: torch.Generator, spec: torch.Tensor, f_len: torch.Tensor,
                 times: int, f_mask: int, t_ratio: float) -> torch.Tensor:
    """``times`` frequency masks of width < f_mask, then ``times`` time
    masks of width < t_ratio · the row's valid frames; masked cells 0."""
    b, n_mels, t = spec.shape
    keep_f = _keep(gen, b, n_mels, float(f_mask), times, spec.device)
    keep_t = _keep(gen, b, t, f_len.to(torch.float32) * t_ratio, times, spec.device)
    return torch.where(keep_f[:, :, None] & keep_t[:, None, :], spec, 0.0)
