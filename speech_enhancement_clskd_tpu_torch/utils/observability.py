"""Observability: metric logging, step timing and profiler traces.

Port of ``speech_enhancement_clskd_tpu/utils/observability.py``:

- ``MetricWriter``: one JSONL line per (step, scope) with a timestamp, the
  same records, greppable and mergeable; the fit loop writes its train logs
  (scope ``train``) and each epoch's validation metrics (scope ``val``);
- ``StepTimer``: wall-clock step times and their percentiles, with the JAX
  class's semantics and summary keys.  The clock is the host's: the caller
  fences the device (``torch.cuda.synchronize()``) before ``stop``, as the
  JAX caller blocks on its result;
- ``trace``: ``torch.profiler`` around a block (the host, and the card
  where there is one), written as a Chrome trace under ``log_dir``, where
  the JAX package writes its ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricWriter:
    """JSONL scalar writer: one line per (step, scope) with a timestamp."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, scalars: Dict[str, float], scope: str = "train"):
        rec = {
            "step": int(step),
            "scope": scope,
            "time": time.time(),
            **{k: float(v) for k, v in scalars.items()},
        }
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


class StepTimer:
    """Wall-clock step timing with percentile summary."""

    def __init__(self):
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        """``steps``, ``mean_s`` and the 50th, 90th and 99th percentiles
        (``p50_s``, ``p90_s``, ``p99_s``; numpy's linear interpolation);
        empty before the first step."""
        import numpy as np

        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "p99_s": float(np.percentile(t, 99)),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block: the host's operations, and the
    card's kernels where CUDA is available; on exit a Chrome trace
    ``trace-<pid>-<ns>.json`` is written under ``log_dir`` (open it in
    Perfetto or ``chrome://tracing``).  Yields the profiler, whose
    ``key_averages()`` sums the block by operation and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
