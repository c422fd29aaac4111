"""nvcc builds of the port's CUDA sources (`diffsound_torch/csrc/*.cu`).

Each source has a plain C interface and is built with one nvcc call for
sm_90a into a shared library under `diffsound_torch/build/`, named by a
hash of the source and the flags, so a build of the same source is reused
and an edited source is rebuilt.  nvcc's `-Xptxas -v` report (registers and
spills of each kernel) is kept beside the library as `*.so.log`.  The
caller loads the library with ctypes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: cannot build the port's CUDA sources")
    return path


def library_path(source: str) -> str:
    """Where the build of `source` (a path) lives."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(source: str) -> Tuple[str, Optional[float]]:
    """Compile `source` unless a build of this exact source exists.
    Returns (the shared library's path, nvcc's wall seconds or None when
    the build was there).  Raises if nvcc fails."""
    so = library_path(source)
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}")
    os.replace(tmp, so)
    with open(so + ".log", "w") as f:
        f.write(proc.stderr)
    return so, time.perf_counter() - t0
