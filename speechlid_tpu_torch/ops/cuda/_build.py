"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source of this package is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).  The
library lands in ``build/`` at the root of the checkout, named by a hash of
the sources and flags, so a changed source is rebuilt at its first use and
an unchanged one is loaded as it is.  The objects (:data:`UNITS`: a source
and the flags it adds; ``relpos_attn.cu`` twice, its Transformer-XL
instantiation beside Shaw's) compile in parallel, one ``nvcc`` each, and
link once.

Nothing here runs at import: :func:`lib` builds on its first call, which a
kernel wrapper makes only for a tensor on the card.

Every wrapper launches through :func:`launch`, which counts the kernels it
launched in :data:`launches` under (entry point, mode, dtype, width);
:func:`launched` sums them and ``launches.clear()`` resets them.

The kernels' tile sizes are set here and nowhere else (:data:`TILING`):
``nvcc`` gets them as ``-D`` definitions, and the wrappers' index functions
and plain-PyTorch emulations import them from here.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("fbank.cu", "depthwise.cu", "subsample.cu", "relpos_attn.cu")
# object → (source, the flags it adds): every source once, and the rel-pos
# attention's Transformer-XL instantiation (entries relpos_attn_xl_*)
UNITS = {**{Path(src).stem: (src, ()) for src in SOURCES},
         "relpos_attn_xl": ("relpos_attn.cu", ("-DRPA_XL=1",))}
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
    "RPA_TILE": 32,            # queries and keys of a rel-pos attention tile
    "RPA_BWD_KEYS": 64,        # keys of a rel-pos attention backward block
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
    # q, kv, table, mask (or null), o, lse, B, N, H, D, P, scale, stream
    "relpos_attn_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # q, kv, table, mask (or null), o, lse, dout, dq, dkv, dtable, part_dq, part_de,
    # B, N, H, D, P, G, scale, stream
    "relpos_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _F, _P),
    # q + u, kv, tables (H, 2P + 1, D), beta (H, 2P + 1), mask (or null), o, lse,
    # B, N, H, D, P, scale, stream
    "relpos_attn_xl_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # q + u, kv, tables, beta, mask (or null), o, lse, dout, dq, dkv, dtable, dbeta,
    # part_dq, part_de, part_db, B, N, H, D, P, scale, stream
    "relpos_attn_xl_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _F, _P),
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
    h.update(repr(sorted(UNITS.items())).encode())
    return BUILD_DIR / f"libspeechlid_kernels_{h.hexdigest()[:16]}.so"


def build(target: Path, flags=None) -> None:
    """Compile every unit with ``flags`` (default ``NVCC_FLAGS``) and its
    own, and link them into ``target``."""
    flags = NVCC_FLAGS if flags is None else flags
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in UNITS]
        procs = [
            subprocess.Popen(
                [nvcc, *flags, *own, "-c", str(CSRC / src), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for (src, own), o in zip(UNITS.values(), objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(name, log) for name, p, log in zip(UNITS, procs, logs) if p.returncode]
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


class LaunchKey(NamedTuple):
    """What :data:`launches` tells launches apart by: the C entry point, the
    wrapper's mode (``""`` where an entry has only one), the tensors' dtype
    (``None`` for the float32-only entries) and the channel count (0 where
    the wrapper does not count by width)."""

    entry: str
    mode: str = ""
    dtype: Any = None
    width: int = 0


launches: collections.Counter = collections.Counter()


def call(entry: str, *args) -> None:
    """Call the library's ``entry`` with ``args`` and raise if it returned a
    CUDA error.  The entry point is looked up on :func:`lib` at every call,
    never kept: a tracer may put a wrapper in its place for a while."""
    err = getattr(lib(), entry)(*args)
    if err:
        msg = lib().speechlid_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")


def launch(entry: str, *args, mode: str = "", dtype: Any = None, width: int = 0,
           kernels: int = 1) -> None:
    """:func:`call`, then add the ``kernels`` it launched to
    :data:`launches` under their :class:`LaunchKey`."""
    call(entry, *args)
    launches[LaunchKey(entry, mode, dtype, width)] += kernels


def launched(**fields) -> int:
    """Kernels launched, summed over the keys whose fields equal ``fields``
    (``launched(mode="glu", width=144)``; no fields: every launch)."""
    return sum(n for key, n in launches.items()
               if all(getattr(key, f) == v for f, v in fields.items()))
