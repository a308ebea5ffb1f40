"""PMSQE, the Perceptual Metric for Speech Quality Evaluation, as a
training loss.

Port of ``speech_enhancement_clskd_tpu/losses/pmsqe.py``: the PESQ-derived
differentiable loss of Martin-Donas et al. 2018, the behavioural equivalent
of the asteroid ``SingleSrcPMSQE`` that the reference's default loss mode
``SDR+PMSQE`` uses.  Per frame of power spectra:

1. bark-band integration of the 512-bin power spectrum (49 bands at 16 kHz,
   42 at 8 kHz);
2. P.862 level alignment: each signal's band powers scaled to the standard
   listening level (79 dB SPL, a mean band power of ``level_target`` = 1e7)
   from its own mean band power;
3. gain equalization of the degraded spectrum against the reference, by the
   ratio of their audible powers (bands above the hearing threshold) plus
   5e3 each;
4. Zwicker-law loudness;
5. the symmetric disturbance (the absolute loudness difference less a
   masking dead zone of a quarter of the smaller loudness) and the
   asymmetric one (the symmetric one weighted by the power ratio to the
   1.2, clipped to [0, 12] and zeroed below 3);
6. their sum, the asymmetric one weighted by ``alpha`` = 0.1, averaged over
   frames.

The bark decomposition matrix is computed from the Zwicker bark scale, not
copied from the ITU tables, as in the JAX package; the numpy tables are the
port's own copy of that construction.  The front end is
``ops.stft.stft_magnitude`` at 512/256/512 with a Hann window.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.stft import stft_magnitude


def _bark(f: np.ndarray) -> np.ndarray:
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@functools.lru_cache(maxsize=4)
def bark_matrix(fft_size: int = 512, sample_rate: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """[n_bands, F] band-integration matrix and the bands' centre
    frequencies."""
    n_bands = 49 if sample_rate == 16000 else 42
    F = fft_size // 2 + 1
    freqs = np.arange(F) * sample_rate / fft_size
    z = _bark(freqs)
    z_max = _bark(np.array([sample_rate / 2.0]))[0]
    edges = np.linspace(0.0, z_max, n_bands + 1)
    mat = np.zeros((n_bands, F), dtype=np.float32)
    centers = np.zeros(n_bands, dtype=np.float32)
    for b in range(n_bands):
        m = (z >= edges[b]) & (z < edges[b + 1])
        if not m.any():  # every band gets at least its nearest bin
            idx = np.argmin(np.abs(z - 0.5 * (edges[b] + edges[b + 1])))
            m = np.zeros(F, bool)
            m[idx] = True
        mat[b, m] = 1.0
        centers[b] = freqs[m].mean()
    return mat, centers


# Zwicker loudness: S_l * (P0/0.5)^0.23 * [(0.5 + 0.5*P/P0)^0.23 - 1]
_SL = 1.866055e-1  # loudness scaling (PESQ Sl)
_ZWICKER_POWER = 0.23


@functools.lru_cache(maxsize=4)
def _abs_thresh_power(sample_rate: int, fft_size: int) -> np.ndarray:
    """Absolute hearing threshold per bark band (Terhardt's approximation)."""
    _, centers = bark_matrix(fft_size, sample_rate)
    f = np.maximum(centers, 20.0) / 1000.0
    thr_db = 3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f ** 4
    thr_db = np.clip(thr_db, -10.0, 96.0)
    return (10.0 ** (thr_db / 10.0)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(fft_size: int, sample_rate: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The band matrix transposed ``[F, n_bands]`` and the thresholds on
    ``device``."""
    mat, _ = bark_matrix(fft_size, sample_rate)
    return (torch.from_numpy(np.ascontiguousarray(mat.T)).to(device),
            torch.from_numpy(_abs_thresh_power(sample_rate, fft_size)).to(device))


def pmsqe(
    ref_mag: torch.Tensor,
    deg_mag: torch.Tensor,
    sample_rate: int = 16000,
    fft_size: int = 512,
    alpha: float = 0.1,
    eps: float = 1e-8,
    level_target: float = 1e7,
) -> torch.Tensor:
    """PMSQE from magnitude spectrograms ``[..., T, F]`` (lower is better):
    a 0-d tensor.  Both signals are level-aligned independently, so the
    loss is scale-invariant per utterance."""
    mat_t, p0 = _tables(fft_size, sample_rate, ref_mag.device)
    ref_p = (ref_mag**2) @ mat_t  # bark band powers [..., T, n_bands]
    deg_p = (deg_mag**2) @ mat_t

    c_ref = level_target / (torch.mean(ref_p, dim=(-1, -2), keepdim=True) + eps)
    c_deg = level_target / (torch.mean(deg_p, dim=(-1, -2), keepdim=True) + eps)
    ref_p = ref_p * c_ref
    deg_p = deg_p * c_deg

    zero = ref_p.new_zeros(())
    aud_r = torch.sum(torch.where(ref_p > p0, ref_p, zero), dim=(-1, -2), keepdim=True)
    aud_d = torch.sum(torch.where(deg_p > p0, deg_p, zero), dim=(-1, -2), keepdim=True)
    gain = (aud_r + 5e3) / (aud_d + 5e3)
    deg_p = deg_p * gain

    def loudness(p):
        return _SL * (p0 / 0.5) ** _ZWICKER_POWER * ((0.5 + 0.5 * p / p0) ** _ZWICKER_POWER - 1.0)

    l_ref = loudness(ref_p)
    l_deg = loudness(deg_p)

    m = 0.25 * torch.minimum(l_ref, l_deg)
    d = torch.abs(l_deg - l_ref)
    d_sym = torch.maximum(d - m, zero)  # a tie splits the gradient, as jnp.maximum

    ratio = (deg_p + 50.0) / (ref_p + 50.0)
    asym = torch.clamp(ratio**1.2, 0.0, 12.0)
    asym = torch.where(asym < 3.0, zero, asym)
    d_asym = d_sym * asym

    per_frame = torch.mean(d_sym, dim=-1) + alpha * torch.mean(d_asym, dim=-1)
    return torch.mean(per_frame)


def pmsqe_from_wav(ref_wav: torch.Tensor, deg_wav: torch.Tensor,
                   sample_rate: int = 16000) -> torch.Tensor:
    """Waveform front end: 512-point STFT magnitudes at hop 256 with a
    Hann window, then PMSQE."""
    ref_mag = stft_magnitude(ref_wav, 512, 256, 512, "hann")
    deg_mag = stft_magnitude(deg_wav, 512, 256, 512, "hann")
    return pmsqe(ref_mag, deg_mag, sample_rate=sample_rate)
