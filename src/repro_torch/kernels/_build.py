"""Build and load the port's CUDA sources.

Each kernel source has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with :mod:`ctypes`. The build runs at first
use, never at import, and is keyed by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one loads in milliseconds.
Different sources build in parallel when loaded from several threads. The
libraries go to ``build/repro_torch_kernels/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load_library", "build_seconds"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks_lock = threading.Lock()
_locks: dict[Path, threading.Lock] = {}     # one per library: sources build in parallel
_loaded: dict[Path, ctypes.CDLL] = {}
# seconds nvcc took for each library this process built (absent when the
# library was already on disk)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return found


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (if its build is not on disk yet) and load it.

    nvcc's ptxas report (registers, spills per kernel) is kept beside the
    library as ``<name>-<key>.log``.
    """
    source = Path(source)
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}-{key}.so"
    with _locks_lock:
        lock = _locks.setdefault(lib_path, threading.Lock())
    with lock:
        lib = _loaded.get(lib_path)
        if lib is not None:
            return lib
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name}:\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)   # atomic: a racing loader sees all or nothing
            build_seconds[source.stem] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        _loaded[lib_path] = lib
        return lib
