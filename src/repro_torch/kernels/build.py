"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``repro_torch/kernels/*/csrc/`` is compiled on first use
into a shared library with a plain C interface, for ``sm_90a`` (Hopper),
under ``build/repro_torch/`` at the repository root.  The library's file
name carries a digest of its source and flags, so an edited source is
rebuilt and a stale library is never loaded (the shared headers under
``kernels/csrc/`` enter every digest).  Nothing is downloaded: the
build uses only the sources in the repository and the CUDA toolkit.  A
missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"

#: headers that every source includes (part of each library's digest)
HEADERS = (KERNELS_DIR / "csrc" / "device_scope.h",)

#: sources by library name
SOURCES = {
    "fragscore": KERNELS_DIR / "fragscore" / "csrc" / "fragscore.cu",
    "decode_attention": KERNELS_DIR / "decode_attention" / "csrc" / "decode_attention.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path       # the shared library
    seconds: float   # compile time (0.0 when an up-to-date library existed)
    log: str         # nvcc's output (ptxas register/shared-memory report)


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
        "the CUDA kernels cannot be built"
    )


def build(name: str) -> BuildResult:
    """Compile library ``name`` unless an up-to-date build exists."""
    src = SOURCES[name]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in (src, *HEADERS))
                            + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return BuildResult(out, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; cached per process."""
    return ctypes.CDLL(str(build(name).path))
