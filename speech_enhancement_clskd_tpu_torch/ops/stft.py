"""Framed STFT / iSTFT as matmuls onto a precomputed real-DFT basis.

Port of ``speech_enhancement_clskd_tpu/ops/stft.py`` (the DCCRN frontend):

- analysis pads ``win_len - hop`` on both sides, frames at ``hop``, and
  projects each frame onto the windowed real-DFT basis, giving a packed
  ``[B, 2F, T']`` spectrum (first F rows real, last F imaginary,
  F = fft_len//2 + 1);
- synthesis projects back with the pseudo-inverse basis, overlap-adds,
  divides by the overlap-added squared window (+1e-8) and trims
  ``win_len - hop`` from both ends.

The projections are plain matmuls, as they are outside any kernel in the JAX
package.  Framing is ``Tensor.unfold`` (a view) and overlap-add is
``F.fold``.

``stft_magnitude`` is the loss-side magnitude with ``torch.stft`` semantics
(centered frames, reflect pad), used by ``losses.spectral``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window
from torch import nn

_MAX_ENVELOPES = 16


class STFTKernels(nn.Module):
    """Analysis/synthesis bases as non-persistent buffers, so ``.to(device)``
    moves them and a state_dict does not carry them."""

    def __init__(self, win_len: int, hop: int, fft_len: int, fwd: np.ndarray,
                 inv: np.ndarray, window: np.ndarray):
        super().__init__()
        self.win_len = win_len
        self.hop = hop
        self.fft_len = fft_len
        self.window_np = window
        self.register_buffer("fwd", torch.from_numpy(fwd), persistent=False)  # [win, 2F]
        self.register_buffer("inv", torch.from_numpy(inv), persistent=False)  # [2F, win]
        self._envelopes: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def ola_envelope(self, n_frames: int, device: torch.device) -> torch.Tensor:
        """Overlap-added squared window for ``n_frames``, kept on ``device``
        for the last few frame counts (streaming uses one; offline eval
        sees many lengths)."""
        key = (n_frames, device)
        if key not in self._envelopes:
            if len(self._envelopes) >= _MAX_ENVELOPES:
                self._envelopes.pop(next(iter(self._envelopes)))
            env = _ola_window_sq(self.window_np, self.hop, n_frames)
            self._envelopes[key] = torch.from_numpy(env).to(device)
        return self._envelopes[key]


def make_kernels(
    win_len: int = 400,
    hop: int = 100,
    fft_len: int = 512,
    window: Optional[str] = "hamming",
) -> STFTKernels:
    """DFT bases matching the reference frontend, built in float64 numpy."""
    if window is None or window == "None":
        win = np.ones(win_len)
    else:
        win = get_window(window, win_len, fftbins=True)
    # row n holds [cos(2 pi n k/N) for k<=N/2] ++ [-sin(2 pi n k/N) for k<=N/2]
    basis = np.fft.rfft(np.eye(fft_len))[:win_len]  # [win, F] complex
    fwd = np.concatenate([basis.real, basis.imag], axis=1)  # [win, 2F]
    inv = (np.linalg.pinv(fwd.T).T * win[None, :]).astype(np.float32)  # [2F, win]
    fwd = (fwd * win[:, None]).astype(np.float32)
    return STFTKernels(win_len, hop, fft_len, fwd, inv, win.astype(np.float32))


def frame(x: torch.Tensor, win_len: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, win_len] with stride ``hop`` (a view)."""
    return x.unfold(-1, win_len, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., n_frames, win] -> [..., (n_frames-1)*hop + win] by OLA."""
    *lead, n_frames, win_len = frames.shape
    out_len = (n_frames - 1) * hop + win_len
    cols = frames.reshape(-1, n_frames, win_len).transpose(1, 2)  # [N, win, n]
    y = F.fold(cols, output_size=(1, out_len), kernel_size=(1, win_len),
               stride=(1, hop))
    return y.reshape(*lead, out_len)


def _ola_window_sq(win: np.ndarray, hop: int, n_frames: int) -> np.ndarray:
    """Overlap-added squared window envelope (static; computed on host)."""
    win = np.asarray(win, dtype=np.float64)
    win_len = win.shape[0]
    out = np.zeros((n_frames - 1) * hop + win_len)
    w2 = win * win
    for t in range(n_frames):
        out[t * hop : t * hop + win_len] += w2
    return out.astype(np.float32)


def stft(x: torch.Tensor, k: STFTKernels) -> torch.Tensor:
    """Packed STFT.  [B, T] (or [B, 1, T]) -> [B, 2F, n_frames]."""
    if x.ndim == 3:
        x = x[:, 0]
    pad = k.win_len - k.hop
    frames = frame(F.pad(x, (pad, pad)), k.win_len, k.hop)  # [B, T', win]
    return torch.matmul(frames, k.fwd.to(frames.dtype)).transpose(1, 2)


def safe_magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2) with a finite gradient at exactly (0, 0).

    The double ``where`` keeps the forward bit-identical to plain sqrt; the
    inner one keeps the untaken branch's NaN gradient out."""
    m2 = re * re + im * im
    nz = m2 > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, m2, torch.ones_like(m2))),
                       torch.zeros_like(m2))


def safe_arctan2(im: torch.Tensor, re: torch.Tensor) -> torch.Tensor:
    """arctan2 with a finite gradient at exactly (0, 0); forward unchanged
    (atan2(0, 1) == atan2(0, 0) == 0)."""
    zero = (im == 0) & (re == 0)
    return torch.atan2(torch.where(zero, torch.zeros_like(im), im),
                       torch.where(zero, torch.ones_like(re), re))


def istft(spec: torch.Tensor, k: STFTKernels) -> torch.Tensor:
    """Packed iSTFT.  [B, 2F, n_frames] -> [B, T]."""
    n_frames = spec.shape[-1]
    frames = torch.matmul(spec.transpose(1, 2), k.inv.to(spec.dtype))  # [B, T', win]
    y = overlap_add(frames, k.hop)
    y = y / (k.ola_envelope(n_frames, y.device).to(y.dtype) + 1e-8)
    trim = k.win_len - k.hop
    return y[..., trim:-trim] if trim else y


# ---------------------------------------------------------------------------
# torch.stft-compatible magnitude (for the spectral losses)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _centered_window(win_length: int, fft_size: int, kind: str) -> np.ndarray:
    """Periodic ``kind`` window of ``win_length`` zero-padded to ``fft_size``
    on both sides, as ``torch.stft`` centres a shorter window."""
    w = get_window(kind, win_length, fftbins=True)
    lpad = (fft_size - win_length) // 2
    return np.pad(w, (lpad, fft_size - win_length - lpad)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _magnitude_basis(fft_size: int, win_length: int, window: str,
                     device: torch.device) -> torch.Tensor:
    """[fft_size, 2F] windowed real-DFT basis (real columns, then imaginary)."""
    win = _centered_window(win_length, fft_size, window)
    basis = np.fft.rfft(np.eye(fft_size)).astype(np.complex64)  # [fft, F]
    fwd = np.concatenate([basis.real, basis.imag], axis=1) * win[:, None]
    return torch.from_numpy(fwd.astype(np.float32)).to(device)


def stft_magnitude(
    x: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_length: int,
    window: str = "hann",
    eps: float = 1e-7,
) -> torch.Tensor:
    """Magnitude spectrogram with torch.stft semantics (center=True, reflect
    pad): ``sqrt(clamp(re^2 + im^2, eps))``, [B, n_frames, F]."""
    if x.ndim == 1:
        x = x[None]
    pad = fft_size // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame(xp, fft_size, hop_size)  # [B, T', fft]
    spec = torch.matmul(frames, _magnitude_basis(fft_size, win_length, window,
                                                 x.device).to(frames.dtype))
    n_bins = fft_size // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return torch.sqrt(torch.clamp(re**2 + im**2, min=eps))
