"""Native (C++) batched spectrum loader, built at first use, with a
pandas fallback (port of bayes_drt_tpu/native).

``load_spectra(paths)`` parses CSV and Gamry files through the C++ loader
(``loader.cpp``, built with g++ into ``bayes_drt_tpu_torch/_build/`` on
first use; the library's name carries a hash of the source) and buckets
them by frequency grid, so each bucket feeds fit_spectra_batch directly.
Without a C++ toolchain it warns and falls back to the pandas parsers of
``io/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_MAX_ROWS = 100_000

_lib = None
_build_failed = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libloader-{h.hexdigest()[:16]}.so")


def _ensure_built():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        # build to a private name and rename: concurrent first uses (one
        # process a test worker) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, path)
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            os.unlink(tmp)
            warnings.warn(f"native loader build failed ({exc}); falling back "
                          "to the pandas parsers")
            _build_failed = True
            return None
    lib = ctypes.CDLL(path)
    for fn in (lib.load_eis_csv, lib.load_eis_gamry):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def _load_one_native(lib, path):
    freq = np.empty(_MAX_ROWS)
    zre = np.empty(_MAX_ROWS)
    zim = np.empty(_MAX_ROWS)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    fn = lib.load_eis_gamry if _looks_gamry(path) else lib.load_eis_csv
    n = fn(os.fsencode(path), ptr(freq), ptr(zre), ptr(zim), _MAX_ROWS)
    if n < 0:
        raise ValueError(f"native loader failed on {path} (code {n})")
    return freq[:n].copy(), zre[:n] + 1j * zim[:n]


def _looks_gamry(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8).startswith(b"EXPLAIN")


def _load_one_fallback(path):
    import pandas as pd

    from ..io.file_load import get_fZ, read_eis
    if _looks_gamry(path):
        return get_fZ(read_eis(path, warn=False))
    df = pd.read_csv(path)
    return df["Freq"].values, df["Zreal"].values + 1j * df["Zimag"].values


def load_eis_file(path):
    """(frequencies, complex Z) from a CSV or Gamry .DTA file."""
    lib = _ensure_built()
    if lib is None:
        return _load_one_fallback(path)
    return _load_one_native(lib, path)


def load_spectra(paths, rel_tol: float = 1e-8, skip_errors: bool = False,
                 failed=None):
    """Load many spectra and bucket them by (rounded) frequency grid.

    Returns a list of buckets, largest first: dicts with keys ``freq``
    (N,), ``Z`` (B, N) and ``paths``, each ready for fit_spectra_batch.

    ``skip_errors``: skip files that fail to parse instead of raising (a
    directory sweep should not die on one corrupt export); each skipped
    (path, error-string) pair is appended to the ``failed`` list if given.
    """
    buckets = {}
    for path in paths:
        try:
            freq, Z = load_eis_file(path)
            if len(freq) == 0:
                raise ValueError("no data rows parsed")
        except Exception as e:              # noqa: BLE001 (reported per file)
            if not skip_errors:
                raise
            if failed is not None:
                failed.append((path, f"{type(e).__name__}: {e}"))
            continue
        key = (len(freq), tuple(np.round(np.log10(np.abs(freq) + 1e-300), 8)))
        b = buckets.setdefault(key, {"freq": freq, "Z": [], "paths": []})
        b["Z"].append(Z)
        b["paths"].append(path)
    out = []
    for b in buckets.values():
        out.append({"freq": b["freq"], "Z": np.stack(b["Z"]),
                    "paths": b["paths"]})
    out.sort(key=lambda d: -d["Z"].shape[0])
    return out
