"""Multi-scale log-mel perceptual distance.

Port of ``speech_enhancement_clskd_tpu/losses/mel.py`` (the reference's
``tools_for_loss.py:124-252``): triangular mel filterbanks built on the host
in numpy, with the reference's floor-to-bin centres, and the distance as two
matmuls and an elementwise log-RMSE per scale.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

MEL_SCALES = (16, 32, 64)


def _freq_to_mel(freq: float) -> float:
    return 1127.01048 * math.log(1 + freq / 700.0)


def _mel_to_freq(mel: float) -> float:
    return 700 * (math.exp(mel / 1127.01048) - 1)


@functools.lru_cache(maxsize=16)
def mel_filterbank(num_coeffs: int, fft_size: int, sample_rate: int = 16000) -> np.ndarray:
    """Triangular mel filters, one per row: ``[num_coeffs, fft_size//2 + 1]``,
    each centre floored to its bin as the reference's ``melFilterBank``
    does."""
    max_hz = sample_rate / 2
    n_bins = fft_size // 2 + 1
    max_mel = _freq_to_mel(max_hz)
    centers = np.arange(num_coeffs + 2, dtype=np.float64) * max_mel / (num_coeffs + 1)
    bins = np.array([math.floor(n_bins * _mel_to_freq(m) / max_hz) for m in centers],
                    dtype=np.int64)
    fb = np.zeros((num_coeffs, n_bins), dtype=np.float32)
    for i in range(1, num_coeffs + 1):
        lo, mid, hi = bins[i - 1], bins[i], bins[i + 1]
        for j in range(lo, mid):
            fb[i - 1, j] = (j - lo) / (mid - lo)
        for j in range(mid, hi):
            fb[i - 1, j] = 1 - (j - mid) / (hi - mid)
    return fb


@functools.lru_cache(maxsize=16)
def _filterbank_t(num_coeffs: int, fft_size: int, sample_rate: int,
                  device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(num_coeffs, fft_size, sample_rate)
    return torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)


def _distances(y_true: torch.Tensor, y_pred: torch.Tensor, fft_size: int,
               sample_rate: int, scales: Sequence[int]) -> torch.Tensor:
    """Each utterance's distance: ``y_true``/``y_pred`` ``[B, ..., F]``
    flattened to ``[B, rows, F]`` -> ``[B]``."""
    F = fft_size // 2 + 1
    B = y_true.shape[0]
    pt = y_true.reshape(B, -1, F) / fft_size
    pp = y_pred.reshape(B, -1, F) / fft_size
    dists = []
    for scale in scales:
        fb = _filterbank_t(scale, fft_size, sample_rate, y_true.device)
        lt = torch.log(pt @ fb + 1e-7)
        lp = torch.log(pp @ fb + 1e-7)
        mse = torch.mean((lp - lt) ** 2, dim=-1)
        dists.append(torch.mean(torch.sqrt(mse + 1e-7), dim=-1))
    return torch.mean(torch.stack(dists, dim=-1), dim=-1)


def perceptual_distance(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    fft_size: int = 512,
    sample_rate: int = 16000,
    scales: Sequence[int] = MEL_SCALES,
) -> torch.Tensor:
    """Multi-scale log-mel RMSE between magnitude spectra ``[..., F]`` (any
    leading shape, read as rows of F in row-major order, as the JAX
    ``reshape(-1, F)`` does)."""
    return _distances(y_true[None], y_pred[None], fft_size, sample_rate, scales)[0]


def array_mel_loss(clean_mags: torch.Tensor, est_mags: torch.Tensor, fft_size: int = 512,
                   sample_rate: int = 16000, scales: Sequence[int] = MEL_SCALES) -> torch.Tensor:
    """The mean over the batch of each utterance's ``perceptual_distance``
    (``clean_mags[i]`` against ``est_mags[i]``), in one batched pass."""
    return torch.mean(_distances(clean_mags, est_mags, fft_size, sample_rate, scales))
