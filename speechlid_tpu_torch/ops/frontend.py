"""Batched audio frontend: wav → dB log-mel, eval and training path.

Port of ``speechlid_tpu/ops/frontend.py`` (torchaudio ``MelSpectrogram`` +
``AmplitudeToDB(top_db=80)`` semantics, HTK mel, n_fft 512, win 400,
hop 160).  The numpy bases are copied here, not imported, so the port
stands alone.

``wav2mel`` goes through the fbank kernel wrapper
(``ops/cuda/fbank_kernel.log_mel``): the CUDA kernel for a tensor on the
card, the plain :func:`mel_spectrogram` formulation for one on the CPU.
In training :func:`fused_frontend` adds the time stretch and SpecAugment of
``ops/specaugment.py``.  Kaldi fbank is not ported yet.  The fbank kernel
has no backward (neither has the TPU kernel): call the frontend under
``torch.no_grad``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Waveform-domain pieces
# ---------------------------------------------------------------------------


def normalize_wav(
    wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-utterance (x - mean) / (std + 1e-6), unbiased std.

    ``wav``: (..., T).  With ``lengths`` the statistics cover the valid
    prefix only and padded samples come out as zeros.
    """
    if lengths is None:
        mean = wav.mean(dim=-1, keepdim=True)
        n = wav.shape[-1]
        var = ((wav - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
        return (wav - mean) / (var.sqrt() + 1e-6)
    valid = torch.arange(wav.shape[-1], device=wav.device) < lengths[..., None]
    mask = valid.to(wav.dtype)
    n = lengths[..., None].to(wav.dtype).clamp_min(1.0)
    mean = (wav * mask).sum(dim=-1, keepdim=True) / n
    var = (((wav - mean) * mask) ** 2).sum(dim=-1, keepdim=True) / (
        n - 1.0
    ).clamp_min(1.0)
    out = (wav - mean) / (var.sqrt() + 1e-6)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def preemphasis(wav: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[0] = x[0]; y[t] = x[t] - coeff·x[t-1] along the last axis."""
    return torch.cat([wav[..., :1], wav[..., 1:] - coeff * wav[..., :-1]], dim=-1)


# ---------------------------------------------------------------------------
# Window / DFT / mel bases (host-side numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hann_window(win_length: int) -> np.ndarray:
    # torch.hann_window(periodic=True)
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag rows of the onesided DFT: each (n_fft//2+1, n_fft) f32."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = -2.0 * np.pi * k * n / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """HTK-scale triangular mel filterbank, (n_freqs, n_mels), matching
    torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk')."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def windowed_dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2·bins) ``[win·cos | win·sin]``: the Hann window zero-padded
    to n_fft and centred (torch.stft), folded into the onesided DFT."""
    pad_left = (n_fft - win_length) // 2
    w = np.zeros(n_fft, dtype=np.float32)
    w[pad_left : pad_left + win_length] = _hann_window(win_length)
    cos_b, sin_b = _dft_basis(n_fft)
    return np.ascontiguousarray(
        np.concatenate([cos_b, sin_b], axis=0).T * w[:, None]
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_bases(
    n_fft: int, win_length: int, n_mels: int, sample_rate: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windowed DFT basis (n_fft, 2·bins) and the mel filterbank
    (bins, n_mels) as float32 tensors on ``device``, made once per device."""
    basis = torch.from_numpy(windowed_dft_basis(n_fft, win_length))
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate))
    return basis.to(device), fb.to(device)


# ---------------------------------------------------------------------------
# STFT → mel (torchaudio MelSpectrogram semantics)
# ---------------------------------------------------------------------------


def _reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """torch 'reflect' padding of a (B, T) batch along T."""
    return F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def mel_spectrogram(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> torch.Tensor:
    """(B, T) → (B, n_mels, F) power mel spectrogram, F = 1 + T // hop:
    centred reflect-padded frames @ windowed DFT basis, |·|², @ HTK mel."""
    x = _reflect_pad(wav.to(torch.float32), n_fft // 2)
    frames = x.unfold(-1, n_fft, hop_length)  # (B, F, n_fft)
    basis, fb = mel_bases(n_fft, win_length, n_mels, sample_rate, wav.device)
    bins = n_fft // 2 + 1
    proj = frames @ basis  # (B, F, 2·bins)
    re, im = proj[..., :bins], proj[..., bins:]
    mel = (re * re + im * im) @ fb  # (B, F, n_mels)
    return mel.transpose(1, 2)


def _clamp_top_db(
    x_db: torch.Tensor, top_db: float, lengths: Optional[torch.Tensor]
) -> torch.Tensor:
    """max(x_db, peak - top_db), the peak taken per utterance over its
    valid frames (the last axis) when ``lengths`` is given."""
    if lengths is not None:
        valid = (
            torch.arange(x_db.shape[-1], device=x_db.device)[None, None, :]
            < lengths[:, None, None]
        )
        masked = x_db.masked_fill(~valid, -math.inf)
        peak = masked.amax(dim=(-2, -1), keepdim=True)
    else:
        peak = x_db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(x_db, peak - top_db)


def amplitude_to_db(
    x: torch.Tensor,
    top_db: Optional[float] = 80.0,
    amin: float = 1e-10,
    ref_value: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Power → dB (torchaudio AmplitudeToDB(stype='power')); the top_db
    clamp is relative to the per-utterance max over ``lengths`` frames."""
    x_db = 10.0 * torch.log10(x.clamp_min(amin))
    x_db = x_db - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        x_db = _clamp_top_db(x_db, top_db, lengths)
    return x_db


def wav2mel(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    win_length: float = 0.025,
    hop_length: float = 0.01,
    n_mels: int = 80,
    n_fft: int = 512,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) → (B, n_mels, F) dB mel with the per-utterance top_db=80
    clamp over valid frames.  The log-mel itself is the fbank kernel on the
    card and its plain version on the CPU."""
    # lazy import: fbank_kernel imports this module for its bases
    from speechlid_tpu_torch.ops.cuda.fbank_kernel import log_mel

    win = int(sample_rate * win_length)
    hop = int(sample_rate * hop_length)
    mel_db = log_mel(
        wav, sample_rate=sample_rate, n_fft=n_fft, win_length=win,
        hop_length=hop, n_mels=n_mels,
    )
    f_len = None if lengths is None else frame_lengths(lengths, hop)
    return _clamp_top_db(mel_db, 80.0, f_len)


def fused_frontend(
    wav: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    sample_rate: int = 16000,
    n_mels: int = 80,
    win_length: float = 0.025,
    hop_length: float = 0.01,
    normalize: bool = True,
    generator: Optional[torch.Generator] = None,
    t_stretch: bool = False,
    stretch_generator: Optional[torch.Generator] = None,
    mask_times: int = 0,
    t_mask_ratio: float = 0.05,
    f_mask: int = 27,
):
    """normalize → dB mel → [time stretch] → [SpecAugment] → transpose.
    Returns ((B, F, n_mels) features, frame lengths or None).

    ``generator=None`` is the eval frontend.  Given a generator (on the
    wav's device; it takes the place of the JAX function's ``key``) the
    stretch comes before the masks: one rate per batch from
    ``stretch_generator`` (a CPU generator, since the rate sets a shape on
    the host; ``generator`` itself if none is given), the output cropped or
    padded to the input width; then ``mask_times`` frequency and time masks
    drawn from ``generator``, the time spans scaled by each utterance's
    valid, stretched frame count."""
    from speechlid_tpu_torch.ops.specaugment import random_time_stretch, spec_augment

    if normalize:
        wav = normalize_wav(wav, lengths)
    mel = wav2mel(
        wav, sample_rate=sample_rate, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels, lengths=lengths,
    )  # (B, n_mels, F)
    hop = int(sample_rate * hop_length)
    f_len = None if lengths is None else frame_lengths(lengths, hop)
    if generator is not None and t_stretch:
        mel, new_len = random_time_stretch(stretch_generator or generator, mel,
                                           lengths=f_len)
        f_len = new_len if new_len is not None else f_len
    if generator is not None and mask_times > 0:
        mel = spec_augment(
            generator, mel, time_mask_ratio=t_mask_ratio, freq_mask_param=f_mask,
            n_time_masks=mask_times, n_freq_masks=mask_times, lengths=f_len,
        )
    return mel.transpose(1, 2), f_len


# ---------------------------------------------------------------------------
# Length bookkeeping
# ---------------------------------------------------------------------------


def frame_lengths(sample_lengths: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Samples → frames of a centred STFT (torch.stft): 1 + len // hop.
    (The kaldi snip_edges count, ``center=False`` in the JAX package, comes
    with the kaldi frontend.)"""
    return 1 + torch.div(sample_lengths, hop_length, rounding_mode="floor")
