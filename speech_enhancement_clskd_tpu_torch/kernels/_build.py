"""Building the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
with ``nvcc`` for Hopper (``sm_90a``) into ``kernels/build/``, then loaded
with ``ctypes``.  The library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited source is rebuilt and a
stale library is never loaded.  ``nvcc``'s output, including ``-Xptxas -v``'s
register and shared-memory report, is kept beside the library as
``<name>.log``.  ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def log_path(source: str) -> Path:
    return library_path(source).with_suffix(".log")


def build_all(sources: Sequence[str]) -> List[Path]:
    """The libraries built from ``csrc/<source>`` for each source, compiling
    the missing ones with one ``nvcc`` each, all started together."""
    outs = [library_path(s) for s in sources]
    todo = [(s, out) for s, out in zip(sources, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for source, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            procs.append((source, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for source, out, tmp, proc in procs:
            try:
                log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s on {source}") from e
            log_path(source).write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {source}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def build(source: str) -> Path:
    """The library built from ``csrc/<source>``, compiled first if need be."""
    return build_all([source])[0]


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built first if need be."""
    path = build(source)
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(str(path))
    return _loaded[path]
