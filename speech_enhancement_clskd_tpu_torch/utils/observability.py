"""Metric logging: an append-only JSONL scalar writer and its reader.

Port of ``MetricWriter`` from
``speech_enhancement_clskd_tpu/utils/observability.py``: one line per
(step, scope) with a timestamp, the same records, greppable and mergeable.
The fit loop writes its train logs (scope ``train``) and each epoch's
validation metrics (scope ``val``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List


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
