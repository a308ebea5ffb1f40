"""WER tracking interface (reference: asteroid MockWERTracker, distill.py:154).

Copy of ``speech_enhancement_clskd_tpu/metrics/wer.py``.  The reference only
ever used the no-op mock (a real ASR-based tracker needs a downloaded ASR
model).  Same contract: ``tracker(mix=..., clean=..., estimate=...,
sample_rate=...)`` returns a dict merged into the per-utterance metrics, and
``final_report_as_markdown`` summarises.

``WERTracker`` accepts any callable ASR (waveform [T] -> str); WER is a
Levenshtein distance over words.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class MockWERTracker:
    def __call__(self, **kwargs) -> Dict:
        return {}

    def final_report_as_markdown(self) -> str:
        return ""


def word_error_rate(ref: str, hyp: str) -> float:
    """Levenshtein word distance / reference length."""
    r, h = ref.split(), hyp.split()
    if not r:
        return 0.0 if not h else 1.0
    d = np.zeros((len(r) + 1, len(h) + 1), dtype=np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    return float(d[len(r), len(h)]) / len(r)


class WERTracker:
    """ASR-backed WER tracker; asr_fn: waveform [T] float32, sr -> text."""

    def __init__(self, asr_fn: Callable[[np.ndarray, int], str],
                 annotations: Optional[Dict[str, str]] = None):
        self.asr_fn = asr_fn
        self.annotations = annotations or {}
        self.rows: List[Dict[str, float]] = []

    def __call__(self, *, mix, clean, estimate, sample_rate,
                 wav_id: Optional[str] = None, **_) -> Dict[str, float]:
        est = np.atleast_2d(np.asarray(estimate))[0]
        cln = np.atleast_2d(np.asarray(clean))[0]
        truth = self.annotations.get(wav_id) if wav_id else None
        if truth is None:
            truth = self.asr_fn(cln, sample_rate)
        hyp = self.asr_fn(est, sample_rate)
        row = {"wer": word_error_rate(truth.lower(), hyp.lower())}
        self.rows.append(row)
        return row

    def final_report_as_markdown(self) -> str:
        if not self.rows:
            return ""
        mean = float(np.mean([r["wer"] for r in self.rows]))
        return f"| metric | value |\n|---|---|\n| WER | {mean:.4f} |"
