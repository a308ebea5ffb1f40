"""PESQ wideband MOS-LQO: a ctypes binding to ``native/pesq.cc``.

Counterpart of ``speech_enhancement_clskd_tpu/metrics/pesq.py``, on the same
C++ source (P.862 pipeline with computed Bark tables; P.862-like, monotone,
MOS-scaled, not bit-exact against the ITU reference).  The library is built
at first use with ``g++`` and the flags of ``native/Makefile``, called
directly, into the port's ``kernels/build/`` under a name that carries a
hash of the source and the flags (as ``kernels/_build.py`` names its
libraries), so an edited source is rebuilt.  A failed build raises: the
caller skips PESQ only by asking (``compute_pesq=False``, ``--no-pesq``).

``pesq_wb`` is host code on numpy arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pesq.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")  # native/Makefile's
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpesq-{h.hexdigest()[:12]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.pesq_mos.restype = ctypes.c_double
        lib.pesq_mos.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sample_rate: int = 16000) -> float:
    """Wideband PESQ MOS-LQO of degraded vs reference ([T] float arrays)."""
    lib = _load()
    n = int(min(len(ref), len(deg)))
    r = np.ascontiguousarray(ref[:n], dtype=np.float32)
    d = np.ascontiguousarray(deg[:n], dtype=np.float32)
    return float(lib.pesq_mos(r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              n, int(sample_rate)))
