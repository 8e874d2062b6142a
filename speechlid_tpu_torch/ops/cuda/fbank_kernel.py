"""Fused log-mel kernel (``csrc/fbank.cu``) and its plain PyTorch version.

Replaces ``speechlid_tpu/ops/pallas/fbank_kernel.py`` (``pallas_log_mel``,
body ``_fbank_kernel``): (B, T) wav → (B, n_mels, 1 + T // hop) power-dB
mel, ``10·log10(max(mel, 1e-10))`` without the top_db clamp, which the
caller (``frontend.wav2mel``) applies over valid frames.

On the card the work is two FP32 matrix products per frame tile (windowed
DFT, then mel), so the kernel is bound by FP32 operations; it keeps the
power spectrum in shared memory and never writes it to device memory.  Its
design notes are at the top of the CUDA source.

:func:`log_mel` takes :func:`log_mel_plain` for a tensor on the CPU and
launches the kernel for one on the card; there is no other path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import _build

_KC = 16  # basis rows per chunk in the kernel: the basis is padded to it


def log_mel_plain(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> torch.Tensor:
    """Plain PyTorch version: ``frontend.mel_spectrogram`` to dB, unclamped."""
    mel = frontend.mel_spectrogram(
        wav, sample_rate, n_fft=n_fft, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels,
    )
    return frontend.amplitude_to_db(mel, top_db=None)


@functools.lru_cache(maxsize=None)
def _kernel_bases(n_fft, win_length, n_mels, sample_rate, device):
    """On ``device``: the basis rows of the window's nonzero span, zero rows
    up to a multiple of the kernel's chunk, (win_pad, 2·bins); the mel
    filterbank (bins, n_mels); and each filter's nonzero bin range
    [first, last + 1) as int32 (n_mels, 2)."""
    basis, fb = frontend.mel_bases(n_fft, win_length, n_mels, sample_rate, device)
    pad_left = (n_fft - win_length) // 2
    win_pad = -(-win_length // _KC) * _KC
    basis = F.pad(basis[pad_left : pad_left + win_length], (0, 0, 0, win_pad - win_length))
    nz = frontend.mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate) > 0
    mel_range = np.stack([nz.argmax(axis=0), len(nz) - nz[::-1].argmax(axis=0)], axis=1)
    mel_range[~nz.any(axis=0)] = 0  # an empty filter sums nothing
    return (basis.contiguous(), fb.contiguous(),
            torch.from_numpy(mel_range.astype(np.int32)).to(device))


def log_mel(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> torch.Tensor:
    """(B, T) float32 wav → (B, n_mels, 1 + T // hop) dB mel (no clamp).

    CPU tensor: :func:`log_mel_plain`.  CUDA tensor: the kernel, counted in
    ``log_mel.launches``.  Anything else raises."""
    if wav.dim() != 2:
        raise ValueError(f"log_mel expects (B, T) audio, got {tuple(wav.shape)}")
    if wav.device.type == "cpu":
        return log_mel_plain(wav, sample_rate, n_fft, win_length, hop_length, n_mels)
    if wav.device.type != "cuda":
        raise ValueError(f"log_mel runs on cpu or cuda, not {wav.device}")
    if wav.dtype != torch.float32:
        raise TypeError(f"log_mel kernel takes float32 audio, got {wav.dtype}")
    if hop_length % 4 or n_fft // 2 + 1 > 1024 or not 0 < win_length <= n_fft:
        raise ValueError(
            f"log_mel kernel needs hop % 4 == 0, n_fft <= 2046 and "
            f"0 < win <= n_fft (hop={hop_length}, n_fft={n_fft}, win={win_length})"
        )
    b, t = wav.shape
    pad = n_fft // 2
    if t <= pad:
        raise ValueError(f"reflect padding by {pad} needs more than {pad} samples, got {t}")
    xp = frontend._reflect_pad(wav, pad).contiguous()
    n_frames = 1 + t // hop_length
    basis, fb, mel_range = _kernel_bases(n_fft, win_length, n_mels, sample_rate, wav.device)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=wav.device)
    with torch.cuda.device(wav.device):
        err = _build.lib().fbank_log_mel_f32(
            xp.data_ptr(), b, xp.shape[1], n_frames,
            basis.data_ptr(), basis.shape[0], n_fft // 2 + 1,
            fb.data_ptr(), mel_range.data_ptr(), n_mels, hop_length,
            (n_fft - win_length) // 2,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fbank_log_mel_f32")
    log_mel.launches += 1
    return out.transpose(1, 2)


log_mel.launches = 0
