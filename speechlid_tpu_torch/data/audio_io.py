"""Audio file I/O on the host (port of ``speechlid_tpu/data/audio_io.py``).

The decoder is the repository's native ``csrc/wavio/wavio.cc`` (C++17,
``ctypes``), reused as it is: single-file decode plus a multithreaded
padded-batch API (:func:`read_wav_batch`) that writes straight into the
(N, T_max) float32 batch buffer with the GIL released.  It is built at
first use into ``build/libwavio_<hash>.so`` (``core/native.py``); a failed
build raises.

The per-file scipy reader decodes what the native one cannot (an encoding
it does not take) and gives the same float32 values; other codecs can be
plugged in with ``register_reader``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import wave
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.io import wavfile

from speechlid_tpu_torch.core import native

_READERS: Dict[str, Callable[[str], Tuple[np.ndarray, int]]] = {}

WAVIO_SOURCE = native.ROOT / "csrc" / "wavio" / "wavio.cc"
BUILD_DIR = native.BUILD_DIR


def register_reader(ext: str, fn: Callable[[str], Tuple[np.ndarray, int]]):
    _READERS[ext.lower()] = fn


def _read_wav_scipy(path: str) -> Tuple[np.ndarray, int]:
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:  # (T, C) → mono first channel (torchaudio loads (C, T))
        data = data[:, 0]
    return data, int(sr)


# ---------------------------------------------------------------------------
# native decoder (csrc/wavio)
# ---------------------------------------------------------------------------


def wavio_library_path() -> Path:
    """Where the library built from the current source lies."""
    return native.library_path(WAVIO_SOURCE, "libwavio")


@functools.lru_cache(maxsize=None)
def wavio() -> ctypes.CDLL:
    """The native decoder, built first if its source changed."""
    lib = ctypes.CDLL(str(native.build_library(WAVIO_SOURCE, "libwavio")))
    lib.wavio_info.restype = ctypes.c_int
    lib.wavio_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.wavio_read.restype = ctypes.c_long
    lib.wavio_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.wavio_read_batch.restype = ctypes.c_int
    lib.wavio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    return lib


def _read_wav_native(path: str) -> Tuple[np.ndarray, int]:
    """Native decode; raises ``OSError`` when the library cannot decode the
    file (the caller falls back to scipy)."""
    lib = wavio()
    frames = ctypes.c_long()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.wavio_info(path.encode(), ctypes.byref(frames),
                        ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise OSError(f"wavio_info({path}) rc={rc}")
    out = np.empty(max(int(frames.value), 1), np.float32)
    n = lib.wavio_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.shape[0], ctypes.byref(sr),
    )
    if n < 0:
        raise OSError(f"wavio_read({path}) rc={n}")
    return out[:n], int(sr.value)


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Native decode, scipy for what it cannot decode — both give
    torchaudio's float32 [-1, 1] channel 0."""
    try:
        return _read_wav_native(path)
    except OSError:
        return _read_wav_scipy(path)


register_reader(".wav", _read_wav)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (float32 mono waveform (T,), sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    reader = _READERS.get(ext)
    if reader is None:
        raise ValueError(
            f"no reader registered for {ext!r} (have {sorted(_READERS)})"
        )
    return reader(path)


def read_wav_batch(
    paths: Sequence[str],
    capacity: int,
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
    truncate: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode ``paths`` into one zero-padded (N, capacity) float32 buffer.

    The native multithreaded path releases the GIL for the whole batch;
    items it cannot decode go through the per-item reader.  Waveforms
    longer than ``capacity`` raise unless ``truncate`` (the feeder
    truncates to its largest duration bucket, matching the per-item
    ``wav[:t_bucket]``).

    → (batch (N, capacity) float32, lengths (N,) int64, sample_rates (N,))
    """
    n = len(paths)
    if out is None:
        out = np.zeros((n, capacity), np.float32)
    elif out.shape != (n, capacity) or out.dtype != np.float32:
        raise ValueError(f"out must be ({n}, {capacity}) float32, got {out.shape} {out.dtype}")
    lengths = np.zeros((n,), np.int64)
    srs = np.zeros((n,), np.int32)
    failed = []
    if n:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        wavio().wavio_read_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            capacity, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads,
        )
        failed = [i for i in range(n) if lengths[i] < 0]
    for i in failed:
        # per-item fallback: full decode (the native path errors with -5
        # when a file exceeds capacity, so the truncating read happens here)
        wav, sr = _read_wav(paths[i])
        if len(wav) > capacity:
            if not truncate:
                raise ValueError(
                    f"{paths[i]}: {len(wav)} frames exceeds capacity "
                    f"{capacity}"
                )
            wav = wav[:capacity]
        out[i, : len(wav)] = wav
        out[i, len(wav):] = 0.0
        lengths[i] = len(wav)
        srs[i] = sr
    return out, lengths, srs


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write PCM16 (the stdlib ``wave`` header reader can't parse IEEE-float
    WAVs, and PCM16 is what the reference corpora use)."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sr, pcm)


def wav_duration(path: str) -> float:
    """Duration in seconds; header-only for PCM, full decode for
    float-format WAVs."""
    try:
        with wave.open(path, "rb") as f:
            return f.getnframes() / f.getframerate()
    except wave.Error:
        data, sr = read_wav(path)
        return len(data) / sr
