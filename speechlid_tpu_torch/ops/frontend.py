"""Batched audio frontend: wav → dB log-mel, eval and training path.

Port of ``speechlid_tpu/ops/frontend.py`` (torchaudio ``MelSpectrogram`` +
``AmplitudeToDB(top_db=80)`` semantics, HTK mel, n_fft 512, win 400,
hop 160).  The numpy bases are copied here, not imported, so the port
stands alone.

``wav2mel`` goes through the fbank kernel wrapper
(``ops/cuda/fbank_kernel.log_mel``): the CUDA kernel for a tensor on the
card, the plain :func:`mel_spectrogram` formulation for one on the CPU.
In training :func:`fused_frontend` adds the time stretch and SpecAugment of
``ops/specaugment.py``.  The fbank kernel has no backward (neither has the
TPU kernel): call the frontend under ``torch.no_grad``.

Kaldi fbank (:func:`kaldi_fbank`, ``wav2mel(use_kaldi=True)``,
``fused_frontend(use_kaldi=True)``) is plain PyTorch on every device, as it
is XLA in the JAX package (which sends kaldi to its ``dft_conv``
formulation even where the Pallas kernel runs): ``frames @ basis``
(``method="dft_conv"``) or ``torch.fft.rfft`` (``method="fft"``).  It keeps
kaldi's semantics as the JAX function does: snip-edges framing, per-frame
DC removal, preemphasis with the first sample duplicated, the povey window,
zero padding on the right to the next power of two, no Nyquist bin, the
natural log floored at float32's eps.  It computes in float64 for a float64
wave, in float32 otherwise.
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
def _povey_window(win_length: int, dtype=np.float32) -> np.ndarray:
    # kaldi's default window: hann^0.85 with denominator N-1 (symmetric)
    n = np.arange(win_length)
    return (
        (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))) ** 0.85
    ).astype(dtype)


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
def _kaldi_mel_banks(
    n_mels: int,
    padded_window_size: int,
    sample_rate: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Kaldi-style mel banks, (n_mels, n_fft//2): kaldi drops the Nyquist
    bin.  torchaudio.compliance.kaldi.get_mel_banks: mel scale
    1127·ln(1 + f/700), triangles in the mel domain over the FFT bins."""
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq

    def hz2mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    fft_bin_width = sample_rate / padded_window_size
    mel_low = hz2mel(low_freq)
    mel_high = hz2mel(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    bins = np.arange(n_mels)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1.0) * mel_delta
    right_mel = mel_low + (bins + 2.0) * mel_delta

    mel = hz2mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    fb = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return fb.astype(dtype)


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
    use_kaldi: bool = False,
    win_length: float = 0.025,
    hop_length: float = 0.01,
    n_mels: int = 80,
    n_fft: int = 512,
    lengths: Optional[torch.Tensor] = None,
    method: str = "dft_conv",
) -> torch.Tensor:
    """(B, T) → (B, n_mels, F) dB mel with the per-utterance top_db=80
    clamp over valid frames.  The log-mel itself is the fbank kernel on the
    card and its plain version on the CPU.  ``use_kaldi``: the kaldi fbank
    of :func:`kaldi_fbank` (``method`` its formulation), transposed, with no
    clamp (``lengths`` unused, as in the JAX function)."""
    # lazy import: fbank_kernel imports this module for its bases
    from speechlid_tpu_torch.ops.cuda.fbank_kernel import log_mel

    if use_kaldi:
        feats = kaldi_fbank(
            wav, sample_rate=sample_rate, frame_length_ms=win_length * 1000.0,
            frame_shift_ms=hop_length * 1000.0, n_mels=n_mels, method=method,
        )
        return feats.transpose(1, 2)
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
    use_kaldi: bool = False,
    normalize: bool = True,
    generator: Optional[torch.Generator] = None,
    t_stretch: bool = False,
    stretch_generator: Optional[torch.Generator] = None,
    mask_times: int = 0,
    t_mask_ratio: float = 0.05,
    f_mask: int = 27,
):
    """normalize → dB mel (or kaldi fbank, ``use_kaldi``) → [time stretch]
    → [SpecAugment] → transpose.  Returns ((B, F, n_mels) features, frame
    lengths or None; kaldi counts snip-edges frames).

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
        wav, sample_rate=sample_rate, use_kaldi=use_kaldi, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels, lengths=lengths,
    )  # (B, n_mels, F)
    hop = int(sample_rate * hop_length)
    f_len = None if lengths is None else frame_lengths(
        lengths, hop, center=not use_kaldi, win_length=int(sample_rate * win_length))
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
# Kaldi-compliance fbank (torchaudio.compliance.kaldi.fbank with dither 0 and
# preemphasis_coefficient 1.0)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def kaldi_bases(win_length: int, n_fft: int, n_mels: int, sample_rate: int, low_freq: float,
                high_freq: float, dtype: torch.dtype, device: torch.device):
    """The povey window (win,), the onesided DFT basis without the Nyquist
    bin (n_fft, 2·(n_fft//2)) ``[cos | sin]`` and the mel banks transposed
    (n_fft//2, n_mels), as ``dtype`` tensors on ``device``, made once per
    device: in float32 the JAX function's float32 bases, in float64 the
    same sums in float64."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    half = n_fft // 2
    k = np.arange(half)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = -2.0 * np.pi * k * n / n_fft
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=0).T.astype(np_dtype)
    fb = _kaldi_mel_banks(n_mels, n_fft, sample_rate, low_freq, high_freq, np_dtype).T
    return (torch.from_numpy(_povey_window(win_length, np_dtype)).to(device),
            torch.from_numpy(np.ascontiguousarray(basis)).to(device),
            torch.from_numpy(np.ascontiguousarray(fb)).to(device))


def kaldi_fbank(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    n_mels: int = 80,
    preemphasis_coefficient: float = 1.0,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    method: str = "dft_conv",
) -> torch.Tensor:
    """(B, T) → (B, F, n_mels) natural-log mel with kaldi's semantics (module
    docstring); F = 1 + (T − win) // hop, 0 when T < win."""
    if method not in ("dft_conv", "fft"):
        raise ValueError(f"unknown kaldi fbank method: {method}")
    win = int(sample_rate * frame_length_ms / 1000.0)
    hop = int(sample_rate * frame_shift_ms / 1000.0)
    n_fft = 1 << (win - 1).bit_length()  # round up to a power of two
    dtype = torch.float64 if wav.dtype == torch.float64 else torch.float32
    window, basis, fb = kaldi_bases(win, n_fft, n_mels, sample_rate, low_freq, high_freq, dtype,
                                    wav.device)
    wav = wav.to(dtype)
    if wav.shape[-1] >= win:
        frames = wav.unfold(-1, win, hop)  # (B, F, win): snip_edges
    else:
        frames = wav.new_zeros(wav.shape[0], 0, win)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis_coefficient != 0.0:
        first = frames[..., :1]
        frames = torch.cat([first - preemphasis_coefficient * first,
                            frames[..., 1:] - preemphasis_coefficient * frames[..., :-1]],
                           dim=-1)
    frames = F.pad(frames * window, (0, n_fft - win))  # zero-pad on the right
    half = n_fft // 2
    if method == "fft":
        pow_spec = torch.fft.rfft(frames, dim=-1).abs().square()[..., :half]  # no Nyquist
    else:
        proj = frames @ basis
        re, im = proj[..., :half], proj[..., half:]
        pow_spec = re * re + im * im
    mel = pow_spec @ fb
    return torch.log(mel.clamp_min(float(np.finfo(np.float32).eps)))


# ---------------------------------------------------------------------------
# Length bookkeeping
# ---------------------------------------------------------------------------


def frame_lengths(sample_lengths: torch.Tensor, hop_length: int, center: bool = True,
                  win_length: int = 400) -> torch.Tensor:
    """Samples → frames.  ``center=True`` (torch.stft): 1 + len // hop;
    ``center=False`` (kaldi snip_edges): 1 + (len − win) // hop, and 0 for
    a wave shorter than the window."""
    if center:
        return 1 + torch.div(sample_lengths, hop_length, rounding_mode="floor")
    snipped = 1 + torch.div(sample_lengths - win_length, hop_length, rounding_mode="floor")
    return torch.where(sample_lengths < win_length, torch.zeros_like(snipped), snipped)
