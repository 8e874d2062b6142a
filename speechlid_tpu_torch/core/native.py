"""Build the repository's host C++ libraries for the port.

``csrc/wavio/wavio.cc`` (the audio decoder) and
``csrc/ctc_decoder/ctc_decoder.cc`` (CTC beam search and the n-gram LM) are
compiled at first use with ``g++ -O3 -std=c++17 -fPIC -pthread -shared``
into ``build/<stem>_<hash>.so`` at the root of the checkout, named by a hash
of the source and flags, so that a changed source is rebuilt and an
unchanged one is loaded as it is.  ``csrc/`` is never written.  A failed
build raises.

The compiler is the ``g++`` on ``PATH``, whatever ``$CXX`` says: the
library is loaded into a process that has the system's ``libstdc++``
already (numpy and torch link it), so it must be built against that one.
A toolchain named by ``$CXX`` that links its own ``libstdc++`` statically
into the library exports a second copy of it, and the decoder's first
``std::ifstream`` then crashes the process.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


def library_path(source: Path, stem: str) -> Path:
    """Where the library built from the current ``source`` lies."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(source: Path, stem: str) -> Path:
    """The path of the library built from ``source``, compiled first if
    there is none for the current source."""
    target = library_path(source, stem)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / target.name
        try:
            done = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp_so), str(source)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"{stem} build: no C++ compiler ({CXX})") from e
        if done.returncode:
            raise RuntimeError(f"{stem} build failed:\n{done.stdout}{done.stderr}")
        os.replace(tmp_so, target)  # atomic: a concurrent loader sees all or nothing
    return target
