"""Expensive test oracles computed once per test session, shared across
pytest-xdist workers.

Under ``--dist load`` the tests of one file go to several workers, and each
worker that draws a test builds the file's module-scoped fixtures anew: the
JAX training steps behind ``tests/test_torch_trainer.py`` and
``tests/test_torch_strategies.py`` were computed by up to six workers at
once.  ``once_per_session`` computes such a value in the first worker that
asks for it, under an exclusive lock on a file in the session's shared
temporary directory, pickles it there, and lets every later worker load it.
A worker that asks while the value is being computed waits for it.  Without
xdist the value is computed in the process, as before.

The value must pickle: numpy arrays, floats and containers of them (not
torch modules).  A compute that raises leaves no file, so the next worker
computes it again and raises in its own tests.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
from typing import Any, Callable, Dict, Iterator, Sequence

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The importing module's tests on one CPU thread: torch's intra-op
    pool, and numpy's BLAS and any OpenMP pool (``threadpoolctl``), the
    caller's counts given back after.  The suite runs several workers at
    once, and a pool of one thread per core in each of them oversubscribes
    the cores: beside eight busy processes a test that builds two models
    (numpy's ``pinv`` of the STFT basis on eight BLAS threads) took 17.6 s
    against 0.2 s alone.  One thread also makes the port's float32 sums, and
    so the errors the tests quote, independent of the machine's core count.
    Import it into a test module to use it."""
    import torch
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def once_per_session(tmp_path_factory, key: str, compute: Callable[[], Any]) -> Any:
    """``compute()``, computed once per test session across xdist workers
    and cached under ``key`` in the session's shared temporary directory."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    # each worker's base temporary directory lies in the session's
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"oracle-{key}.pkl"
    with open(root / f"oracle-{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def each_once_per_session(tmp_path_factory, prefix: str, keys: Sequence[str],
                          compute: Callable[[str], Any]) -> Dict[str, Any]:
    """``{key: compute(key)}``, each value ``once_per_session`` under
    ``prefix.key``.  Each xdist worker takes the keys in its own rotation
    (by its number), so workers that ask at the same time compute different
    values side by side instead of waiting on one."""
    keys = list(keys)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    start = int(worker[2:] or 0) % max(1, len(keys))
    out = {}
    for key in keys[start:] + keys[:start]:
        out[key] = once_per_session(tmp_path_factory, f"{prefix}.{key}", lambda k=key: compute(k))
    return {key: out[key] for key in keys}


@contextlib.contextmanager
def jitted_jax_stoi() -> Iterator[None]:
    """Inside the block the JAX metric bundle (``metrics/bss.py``) calls its
    STOI jitted.  It calls ``stoi_batch`` eagerly, which compiles each of
    its operations anew for every utterance length; jitted, it compiles once
    a length.  The same function either way (the port's tests hold STOI to
    1e-5)."""
    import jax

    from speech_enhancement_clskd_tpu.metrics import bss

    eager = bss.stoi_batch
    bss.stoi_batch = jax.jit(eager, static_argnames="fs")
    try:
        yield
    finally:
        bss.stoi_batch = eager
