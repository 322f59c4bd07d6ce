"""Build and load the hand-written CUDA kernels of csrc/.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from ``_build/``. Nothing here
runs at import time; the first launch of a kernel builds its library.
``build_all`` starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# never --use_fast_math: the trajectory kernel's freeze and selection logic
# relies on IEEE inf/NaN semantics and an accurate exp
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("quad", "traj")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument types of each library's C entry points, <symbol>_f32 and
# <symbol>_f64 alike; every entry returns its cudaError_t as an int
SIGNATURES = {
    "quad": {"drt_quad": [_P] * 3 + [_I] * 3 + [_P] * 2},
    "traj": {"traj": [_P] * 13 + [_I] * 3 + [_D] + [_P] * 4},
}

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` into a temporary file; None if built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=KERNELS) -> dict:
    """Compile every missing library in parallel; returns the nvcc logs
    (register and shared-memory use from -Xptxas -v) by kernel name."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, j) for n, j in jobs.items() if j is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    its entry points' argument and return types set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for sym, argtypes in SIGNATURES[name].items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, sym + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
