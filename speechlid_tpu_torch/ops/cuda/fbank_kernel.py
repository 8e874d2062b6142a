"""Fused log-mel kernel (``csrc/fbank.cu``), its plain PyTorch version and
an emulation of the kernel's tiling.

Replaces ``speechlid_tpu/ops/pallas/fbank_kernel.py`` (``pallas_log_mel``,
body ``_fbank_kernel``): (B, T) wav → (B, n_mels, 1 + T // hop) power-dB
mel, ``10·log10(max(mel, 1e-10))`` without the top_db clamp, which the
caller (``frontend.wav2mel``) applies over valid frames.

On the card the work is two FP32 matrix products per frame tile (windowed
DFT, then mel), so the kernel is bound by FP32 operations; one utterance is
little work for 132 SMs, so the grid's shape decides at B = 1.  The kernel
tiles over bins as well as frames: a block owns 16 frames × 32 packed bins
and keeps its slab of the basis in shared memory for all the frame tiles it
walks over (the taps split over four groups of its 256 threads); the
blocks of one frame tile form a thread-block cluster and apply the mel
filters to each other's power tiles through distributed shared memory, so
the power spectrum never reaches device memory.  It takes the raw wav and
reflects the sample index while it stages a tile's span: the wrapper
launches no pad kernel.  Design notes are at the top of the
CUDA source.

What the kernel and this module share is written here as small pure
functions (:func:`reflect_index`, :func:`tiled_basis`, :func:`bin_location`,
:func:`mel_ranges`), and :func:`log_mel_tiled_plain` follows the kernel's
tiling and summation order with them, so that the CPU tests reach the index
arithmetic the kernel depends on.

:func:`log_mel` takes :func:`log_mel_plain` for a tensor on the CPU and
launches the kernel for one on the card; there is no other path.  What a
card grants the kernel (:func:`kernel_occupancy`) is asked once per device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import _build

# the kernel is compiled with the same values (_build.TILING)
TILE_FRAMES = _build.TILING["FBANK_TILE_FRAMES"]  # frames per block tile
TILE_BINS = _build.TILING["FBANK_TILE_BINS"]  # packed bins per block, twice as many columns
TAP_PARTS = _build.TILING["FBANK_TAP_PARTS"]  # parts of the taps, summed (p0 + p2) + (p1 + p3)
MAX_TILES = _build.TILING["FBANK_MAX_TILES"]  # blocks of a cluster: n_fft <= 2·TILE_BINS·MAX_TILES


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


# ---------------------------------------------------------------------------
# What the kernel and its emulation share
# ---------------------------------------------------------------------------


def reflect_index(i, t: int):
    """Index into a length-``t`` wav of position ``i`` of its reflect-padded
    extension (``i`` may be negative or ≥ t; an int or an integer array):
    ``i < 0 → -i``, ``i ≥ t → 2(t-1) - i``.  One reflection, so it is valid
    for ``-t < i < 2t - 1``; beyond that the result lies outside [0, t)."""
    i = np.where(np.asarray(i) < 0, -np.asarray(i), i)
    return np.where(i >= t, 2 * (t - 1) - i, i)


def n_bin_tiles(n_fft: int) -> int:
    """Bin tiles (blocks of a cluster) for the n_fft/2 packed bins."""
    return -(-(n_fft // 2) // TILE_BINS)


def bin_location(k: int, n_fft: int) -> Tuple[int, int]:
    """(tile, slot) of bin ``k``'s power in the tiles' (frames, TILE_BINS + 1)
    power arrays.  Bins 0 … n_fft/2 - 1 lie in order, TILE_BINS a tile; the
    Nyquist bin n_fft/2, packed into bin 0's imaginary column, takes the
    extra slot of tile 0."""
    if k == n_fft // 2:
        return 0, TILE_BINS
    return k // TILE_BINS, k % TILE_BINS


@functools.lru_cache(maxsize=None)
def tiled_basis(n_fft: int, win_length: int) -> np.ndarray:
    """The windowed DFT basis re-laid for the kernel, (tiles, win_pad,
    2·TILE_BINS) float32: only the window's nonzero span of taps, zero rows
    up to a multiple of 4; tile r holds packed bins TILE_BINS·r …, column
    2j the real and 2j + 1 the imaginary part of packed bin j.  DC and
    Nyquist have no imaginary part (their sine columns are rounding noise
    under 1e-12), so Nyquist's real column stands in packed bin 0's
    imaginary column.  Packed bins past n_fft/2 are zero columns."""
    bins = n_fft // 2 + 1
    pad_left = (n_fft - win_length) // 2
    full = frontend.windowed_dft_basis(n_fft, win_length)[pad_left : pad_left + win_length]
    win_pad = -(-win_length // 4) * 4
    tiles = n_bin_tiles(n_fft)
    out = np.zeros((tiles, win_pad, 2 * TILE_BINS), np.float32)
    for k in range(n_fft // 2):
        tile, slot = bin_location(k, n_fft)
        out[tile, :win_length, 2 * slot] = full[:, k]
        out[tile, :win_length, 2 * slot + 1] = full[:, bins + k]
    out[0, :win_length, 1] = full[:, n_fft // 2]  # Nyquist, real
    return out


@functools.lru_cache(maxsize=None)
def mel_ranges(n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Each filter's nonzero bin range [first, last + 1), int32 (n_mels, 2);
    (0, 0) for a filter without a nonzero bin."""
    nz = frontend.mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate) > 0
    ranges = np.stack([nz.argmax(axis=0), len(nz) - nz[::-1].argmax(axis=0)], axis=1)
    ranges[~nz.any(axis=0)] = 0  # an empty filter sums nothing
    return ranges.astype(np.int32)


def log_mel_tiled_plain(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> torch.Tensor:
    """The kernel's tiling and summation order in plain PyTorch, from the
    raw wav: frame tiles of TILE_FRAMES whose span is gathered through
    :func:`reflect_index` (zeros where the kernel stages zeros); per bin tile
    the product with its slab of :func:`tiled_basis`, the taps in
    TAP_PARTS parts added pairwise; power with the packed DC/Nyquist pair
    taken apart; each filter summed over :func:`mel_ranges` in ascending
    bin order, every bin fetched from :func:`bin_location`."""
    b, t = wav.shape
    n_frames = 1 + t // hop_length
    tiles = n_bin_tiles(n_fft)
    slabs = torch.from_numpy(tiled_basis(n_fft, win_length)).to(wav.device)
    win_pad = slabs.shape[1]
    rows = -(-(-(-win_pad // TAP_PARTS)) // 4) * 4  # taps of one part: ceil(win_pad / parts), to a multiple of 4
    cuts = [min(p * rows, win_pad) for p in range(TAP_PARTS + 1)]
    frame_offset = (n_fft - win_length) // 2 - n_fft // 2
    fb = frontend.mel_bases(n_fft, win_length, n_mels, sample_rate, wav.device)[1]
    ranges = mel_ranges(n_fft, n_mels, sample_rate)
    wav = wav.to(torch.float32)
    out = wav.new_empty((b, n_frames, n_mels))
    for f0 in range(0, n_frames, TILE_FRAMES):
        taps = (f0 + np.arange(TILE_FRAMES))[:, None] * hop_length + frame_offset \
            + np.arange(win_pad)[None, :]
        src = reflect_index(taps, t)
        inside = torch.from_numpy((src >= 0) & (src < t)).to(wav.device)
        src = torch.from_numpy(np.clip(src, 0, t - 1)).to(wav.device)
        frames = wav[:, src] * inside  # (B, TILE_FRAMES, win_pad)
        power = []  # per bin tile: (B, TILE_FRAMES, TILE_BINS + 1)
        for r in range(tiles):
            p0, p1, p2, p3 = (frames[..., a:e] @ slabs[r, a:e] for a, e in zip(cuts, cuts[1:]))
            proj = (p0 + p2) + (p1 + p3)
            re, im = proj[..., 0::2], proj[..., 1::2]
            p = torch.zeros((b, TILE_FRAMES, TILE_BINS + 1), device=wav.device)
            p[..., :TILE_BINS] = re * re + im * im
            if r == 0:  # packed bin 0: DC in the real column, Nyquist in the imaginary
                p[..., 0] = re[..., 0] * re[..., 0]
                p[..., TILE_BINS] = im[..., 0] * im[..., 0]
            power.append(p)
        mel = wav.new_zeros((b, TILE_FRAMES, n_mels))
        for m, (first, last) in enumerate(ranges):
            for k in range(first, last):
                tile, slot = bin_location(k, n_fft)
                mel[..., m] = mel[..., m] + power[tile][..., slot] * fb[k, m]
        n = min(TILE_FRAMES, n_frames - f0)
        out[:, f0 : f0 + n] = 10.0 * torch.log10(mel[:, :n].clamp_min(1e-10))
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_bases(n_fft, win_length, n_mels, sample_rate, device):
    """On ``device``, made once (outside any graph capture): the re-laid
    basis (tiles, win_pad, 2·TILE_BINS), the mel filterbank (bins, n_mels)
    and the filters' nonzero bin ranges (n_mels, 2) int32."""
    fb = frontend.mel_bases(n_fft, win_length, n_mels, sample_rate, device)[1]
    return (torch.from_numpy(tiled_basis(n_fft, win_length)).to(device), fb.contiguous(),
            torch.from_numpy(mel_ranges(n_fft, n_mels, sample_rate)).to(device))


@functools.lru_cache(maxsize=None)
def kernel_occupancy(hop_length: int, win_pad: int, n_tiles: int, device) -> Tuple[int, int]:
    """(blocks per SM, clusters resident at once) that the card ``device``
    grants the kernel at these sizes.  Asked once per device and sizes
    (outside any graph capture); the first call on a device also allows
    the kernel its shared memory there."""
    blocks_per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.call("fbank_log_mel_setup", hop_length, win_pad, n_tiles,
                    ctypes.addressof(blocks_per_sm), ctypes.addressof(clusters))
    return blocks_per_sm.value, clusters.value


def log_mel(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
) -> torch.Tensor:
    """(B, T) float32 wav → (B, n_mels, 1 + T // hop) dB mel (no clamp).

    CPU tensor: :func:`log_mel_plain`.  CUDA tensor: the kernel, one launch
    and no other device work, counted in ``_build.launches``.  Anything
    else raises."""
    if wav.dim() != 2:
        raise ValueError(f"log_mel expects (B, T) audio, got {tuple(wav.shape)}")
    if wav.device.type == "cpu":
        return log_mel_plain(wav, sample_rate, n_fft, win_length, hop_length, n_mels)
    if wav.device.type != "cuda":
        raise ValueError(f"log_mel runs on cpu or cuda, not {wav.device}")
    if wav.dtype != torch.float32:
        raise TypeError(f"log_mel kernel takes float32 audio, got {wav.dtype}")
    if (hop_length <= 0 or hop_length % 4 or n_fft % 2 or n_bin_tiles(n_fft) > MAX_TILES
            or not 0 < win_length <= n_fft):
        raise ValueError(
            f"log_mel kernel needs hop % 4 == 0, an even n_fft <= "
            f"{2 * TILE_BINS * MAX_TILES} and 0 < win <= n_fft "
            f"(hop={hop_length}, n_fft={n_fft}, win={win_length})"
        )
    b, t = wav.shape
    pad = n_fft // 2
    if t <= pad:
        raise ValueError(f"reflect padding by {pad} needs more than {pad} samples, got {t}")
    wav = wav.contiguous()
    n_frames = 1 + t // hop_length
    basis, fb, ranges = _kernel_bases(n_fft, win_length, n_mels, sample_rate, wav.device)
    resident = kernel_occupancy(hop_length, basis.shape[1], basis.shape[0], wav.device)[1]
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=wav.device)
    with torch.cuda.device(wav.device):
        _build.launch(
            "fbank_log_mel_f32",
            wav.data_ptr(), b, t, n_frames,
            basis.data_ptr(), basis.shape[1], basis.shape[0], n_fft // 2 + 1,
            fb.data_ptr(), ranges.data_ptr(), n_mels, hop_length,
            (n_fft - win_length) // 2 - pad, resident,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    return out.transpose(1, 2)
