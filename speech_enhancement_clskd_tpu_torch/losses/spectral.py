"""Spectral losses: spectral convergence + log-STFT magnitude + MRSTFT.

Port of ``speech_enhancement_clskd_tpu/losses/spectral.py``.  The
distillation step uses the single-resolution [512/100/400] configuration and
consumes only the magnitude term.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.stft import stft_magnitude


def spectral_convergence(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """||Y - X||_F / ||Y||_F."""
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """L1 between log magnitudes."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


def stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    fft_size: int = 1024,
    hop_size: int = 120,
    win_length: int = 600,
    window: str = "hann",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-resolution (sc, mag) pair."""
    x_mag = stft_magnitude(x, fft_size, hop_size, win_length, window)
    y_mag = stft_magnitude(y, fft_size, hop_size, win_length, window)
    return spectral_convergence(x_mag, y_mag), log_stft_magnitude(x_mag, y_mag)


def multi_resolution_stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Sequence[int] = (120, 240, 50),
    win_lengths: Sequence[int] = (600, 1200, 240),
    window: str = "hann",
    factor_sc: float = 0.1,
    factor_mag: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Averaged multi-resolution (sc, mag)."""
    if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
        raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
    sc = 0.0
    mag = 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        s, m = stft_loss(x, y, fs, hs, wl, window)
        sc = sc + s
        mag = mag + m
    n = len(fft_sizes)
    return factor_sc * sc / n, factor_mag * mag / n
