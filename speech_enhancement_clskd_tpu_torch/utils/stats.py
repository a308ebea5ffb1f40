"""Data-normalization statistics + small array pickers.

Behavioural equivalents of reference ``tools_for_model.py:531-581`` (mu/sigma
per utterance list with unit-variance flooring) and the run.py index helpers
(``tools_for_model.py:711-741``).  The port's copy of
``speech_enhancement_clskd_tpu/utils/stats.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def get_mu_sig(data: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-utterance mean/std vectors; std floored to 1.0 below 1e-5
    (tools_for_model.py:531-565)."""
    mu = [np.mean(d, axis=0) for d in data]
    sig = [np.sqrt(np.mean(np.square(d - m), axis=0)) for d, m in zip(data, mu)]
    sig = [np.where(s < 1e-5, 1.0, s) for s in sig]
    return np.float16(np.asarray(mu, dtype=object) if len(mu) > 1 else mu[0]), \
        np.float16(np.asarray(sig, dtype=object) if len(sig) > 1 else sig[0])


def get_statistics_inp(inp: Sequence[np.ndarray]):
    return get_mu_sig(inp)


def near_avg_index(array: Sequence[float]) -> int:
    """Index of the element closest to the mean (tools_for_model.py:711-721)."""
    a = np.asarray(array, dtype=np.float64)
    return int(np.argmin(np.abs(a - a.mean())))


def max_index(array: Sequence[float]) -> int:
    a = np.asarray(array, dtype=np.float64)
    return int(len(a) - 1 - np.argmax(a[::-1]))  # last max, like the reference


def min_index(array: Sequence[float]) -> int:
    a = np.asarray(array, dtype=np.float64)
    return int(len(a) - 1 - np.argmin(a[::-1]))
