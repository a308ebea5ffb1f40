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

import fcntl
import os
import pickle
from typing import Any, Callable, Dict, Sequence


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
