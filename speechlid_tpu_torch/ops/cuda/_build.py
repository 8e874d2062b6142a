"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source of this package is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).  The
library lands in ``build/`` at the root of the checkout, named by a hash of
the sources and flags, so a changed source is rebuilt at its first use and
an unchanged one is loaded as it is.  The sources compile in parallel, one
``nvcc`` each, and link once.

Nothing here runs at import: :func:`lib` builds on its first call, which a
kernel wrapper makes only for a tensor on the card.

The kernels' tile sizes are set here and nowhere else (:data:`TILING`):
``nvcc`` gets them as ``-D`` definitions, and the wrappers' index functions
and plain-PyTorch emulations import them from here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("fbank.cu", "depthwise.cu", "subsample.cu")
BUILD_DIR = _PKG.parent / "build"
TILING = {
    "FBANK_TILE_FRAMES": 16,   # frames of a block's tile
    "FBANK_TILE_BINS": 32,     # packed bins of a block: twice as many basis columns
    "FBANK_TAP_PARTS": 4,      # parts the taps are split into, added (p0 + p2) + (p1 + p3)
    "FBANK_MAX_TILES": 8,      # blocks of a cluster (the portable limit): bin tiles
    "DW_MAX_KERNEL_SIZE": 64,  # taps: the staging stays under 48 KB of shared memory
    "DW_FWD_TIME_TILE": 24,    # frames of a forward block of 32 channels
    "DW_FWD_THREAD_FRAMES": 2,  # consecutive frames a forward thread sums: 96 threads a block
    "DW_BWD_TIME_CHUNK": 64,   # frames of one utterance per time chunk of bwd_w
    "DW_BWD_QUARTERS": 4,      # runs a chunk's frames are summed in
    "DW_BWD_MAX_CLUSTER": 8,   # blocks that share one channel tile's chunks
    "SUB_BK": 16,              # K rows of a subsampling chunk (wgrad: positions)
    "SUB_WGRAD_SPLITS": 29,    # position ranges of dW1: 9 taps × 29 = 261 blocks, two an SM
    "SUB_DGRAD_BLOCKS": 264,   # blocks that share the dgrad tiles: two an SM
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    *(f"-D{name}={value}" for name, value in TILING.items()),
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # wav, batch, T, n_frames, basis, win_pad, n_tiles, bins, fb, mel_range,
    # n_mels, hop, frame_offset, resident_clusters, out, stream
    "fbank_log_mel_f32": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P),
    # hop, win_pad, n_tiles, blocks_per_sm (int*), clusters (int*)
    "fbank_log_mel_setup": (_I, _I, _I, _P, _P),
    # x, w, bias (or null), y, B, T, C, K, pad_l, flip, dtype, stream
    "depthwise_conv1d_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # h, mask (or null), w, bias, bn mean, var, weight, bias (or all null), eps, act,
    # u (or null), y, B, T, C, K, pad_l, dtype, stream
    "depthwise_conv1d_glu_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P),
    # g, w, h, mask (or null), dh, B, T, C, K, pad_l, dtype, stream
    "depthwise_conv1d_glu_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, g, dw, db, B, T, C, K, pad_l, dtype, stream
    "depthwise_conv1d_bwd_w": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w0 rows, w1 (tap, ci, co), b1, y, B, T, F, C, stream
    "subsample_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w0 rows, w1 (tap, co, ci), y, dy, scratch, dw0, db0, dw1, db1, B, T, F, C, stream
    "subsample_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}")
    return str(path)


def library_path(flags=None) -> Path:
    """Where the library built with ``flags`` (default ``NVCC_FLAGS``) lies."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS if flags is None else flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libspeechlid_kernels_{h.hexdigest()[:16]}.so"


def build(target: Path, flags=None) -> None:
    """Compile every source with ``flags`` (default ``NVCC_FLAGS``) and link
    them into ``target``."""
    flags = NVCC_FLAGS if flags is None else flags
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *flags, "-c", str(CSRC / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, log) for s, p, log in zip(SOURCES, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(f"--- {s}\n{log}" for s, log in failed)
            )
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_so)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        target.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp_so, target)  # atomic: a concurrent loader sees all or nothing


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The kernels' library, built first if its sources changed."""
    target = library_path()
    if not target.exists():
        build(target)
    so = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    so.speechlid_cuda_error_string.argtypes = [ctypes.c_int]
    so.speechlid_cuda_error_string.restype = ctypes.c_char_p
    return so


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib().speechlid_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
