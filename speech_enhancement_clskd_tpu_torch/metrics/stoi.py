"""STOI — short-time objective intelligibility (Taal et al. 2011), in PyTorch.

Port of ``speech_enhancement_clskd_tpu/metrics/stoi.py``, batched on the
device so that validation never moves a waveform to the host:

1. polyphase resample to 10 kHz (a kaiser FIR designed on the host by
   scipy's ``firwin``, imported on first use; the zero-stuffed signal is
   filtered by one strided ``conv1d``, which computes only the kept
   outputs),
2. 256-sample hann frames, hop 128, zero-padded 512-pt FFT (a matmul against
   a real-DFT basis),
3. silent-frame removal at 40 dB dynamic range relative to the loudest clean
   frame, without a host sync: the kept frames' indices come from a stable
   sort of the silence mask, and the slots past the M kept frames hold frame
   ``N - 1``, as the JAX ``jnp.nonzero(mask, size=N, fill_value=N - 1)``
   fills them (the segments that reach into them are weighted by 0, so they
   must hold the same finite values),
4. 15 one-third-octave bands from 150 Hz,
5. 30-frame segments, per-band normalization + (-15 dB) clipping,
6. mean of band/segment correlations over the segments inside the kept
   frames.

Runs in full float32 (``utils.device.float32_math``): cuDNN would otherwise
run the resampling filter in TF32.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import float32_math

FS = 10000  # STOI operating rate
N_FRAME = 256
NFFT = 512
HOP = 128
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # analysis window of 384 ms
BETA = -15.0  # lower SDR bound (clip)
DYN_RANGE = 40.0


@functools.lru_cache(maxsize=8)
def _resample_fir(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed low-pass FIR for polyphase resampling (scipy-design)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    cutoff = 1.0 / max_rate  # relative to Nyquist of the upsampled rate
    taps = firwin(2 * half_len + 1, cutoff, window=("kaiser", 5.0))
    return (taps * up).astype(np.float32)


def resample(x: torch.Tensor, fs_in: int, fs_out: int = FS) -> torch.Tensor:
    """Polyphase resample [..., T] -> [..., T*up//down]."""
    if fs_in == fs_out:
        return x
    g = gcd(fs_in, fs_out)
    up, down = fs_out // g, fs_in // g
    taps = _resample_fir(up, down)
    lead, T = x.shape[:-1], x.shape[-1]
    xz = x.new_zeros(lead + (T, up))
    xz[..., 0] = x
    xz = xz.reshape(-1, 1, T * up)
    pad = len(taps) // 2
    k = torch.from_numpy(taps[::-1].copy()).to(x.device)[None, None, :]
    # output j of the strided filter is sample j * down of the full one
    y = F.conv1d(F.pad(xz, (pad, pad)), k, stride=down)
    return y.reshape(lead + (-1,))[..., : (T * up) // down]


@functools.lru_cache(maxsize=4)
def _third_octave_matrix() -> np.ndarray:
    """[NUM_BANDS, NFFT//2+1] one-third-octave band selection matrix."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * MIN_FREQ
    lo = cf * 2 ** (-1.0 / 6.0)
    hi = cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)), dtype=np.float32)
    for i in range(NUM_BANDS):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_i:hi_i] = 1.0
    return obm


@functools.lru_cache(maxsize=4)
def _dft_basis() -> np.ndarray:
    """[N_FRAME, 2*(NFFT//2+1)] windowed real-DFT basis (hann, zero-pad 512)."""
    win = np.hanning(N_FRAME + 2)[1:-1]
    basis = np.fft.rfft(np.eye(NFFT))[:N_FRAME]  # [256, 257]
    fwd = np.concatenate([basis.real, basis.imag], axis=1)
    return (fwd * win[:, None]).astype(np.float32)


def _frame(x: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, n_frames, N_FRAME] at hop 128."""
    n = (x.shape[-1] - N_FRAME) // HOP + 1
    blocks = x[:, : (n + 1) * HOP].reshape(x.shape[0], -1, HOP)
    return torch.cat([blocks[:, :n], blocks[:, 1 : n + 1]], dim=-1)


def _stoi_10k(x10: torch.Tensor, y10: torch.Tensor) -> torch.Tensor:
    """STOI of each (clean x, degraded y) pair [B, T], both at 10 kHz -> [B]."""
    dev = x10.device
    xf = _frame(x10)  # [B, N, 256]
    yf = _frame(y10)
    B, N = xf.shape[:2]

    win = torch.from_numpy(np.hanning(N_FRAME + 2)[1:-1].astype(np.float32)).to(dev)
    energy = 20 * torch.log10(torch.linalg.vector_norm(xf * win, dim=-1) + 1e-10)
    mask = energy > (energy.max(dim=-1, keepdim=True).values - DYN_RANGE)
    M = mask.sum(dim=-1)  # number of valid frames [B]
    # the kept frames in order, then frame N - 1 (jnp.nonzero's fill)
    order = torch.sort((~mask).to(torch.int32), dim=-1, stable=True).indices
    slots = torch.arange(N, device=dev)
    keep = torch.where(slots < M[:, None], order, N - 1)[..., None]
    xf = torch.take_along_dim(xf, keep, dim=1)
    yf = torch.take_along_dim(yf, keep, dim=1)

    fwd = torch.from_numpy(_dft_basis()).to(dev)
    Fq = NFFT // 2 + 1
    xs = xf @ fwd
    ys = yf @ fwd
    xp = xs[..., :Fq] ** 2 + xs[..., Fq:] ** 2  # power spectra [B, N, 257]
    yp = ys[..., :Fq] ** 2 + ys[..., Fq:] ** 2

    obm = torch.from_numpy(_third_octave_matrix()).to(dev)
    X = torch.sqrt(xp @ obm.T)  # band envelopes [B, N, 15]
    Y = torch.sqrt(yp @ obm.T)

    n_seg = N - N_SEG + 1
    if n_seg <= 0:  # shorter than one segment: no segment counts
        return x10.new_zeros(B)
    idx = torch.arange(n_seg, device=dev)[:, None] + torch.arange(N_SEG, device=dev)[None, :]
    Xseg = X[:, idx]  # [B, S, 30, 15]
    Yseg = Y[:, idx]

    # per-segment, per-band normalization + clipping of the degraded envelope
    alpha = torch.sqrt(torch.sum(Xseg**2, dim=2, keepdim=True)
                       / (torch.sum(Yseg**2, dim=2, keepdim=True) + 1e-10))
    clip_c = 10 ** (-BETA / 20.0)
    Yn = torch.minimum(alpha * Yseg, Xseg * (1 + clip_c))

    xm = Xseg - torch.mean(Xseg, dim=2, keepdim=True)
    ym = Yn - torch.mean(Yn, dim=2, keepdim=True)
    corr = torch.sum(xm * ym, dim=2) / (
        torch.linalg.vector_norm(xm, dim=2) * torch.linalg.vector_norm(ym, dim=2) + 1e-10
    )  # [B, S, 15]

    # only segments fully inside the valid (non-silent) frame range count
    valid = (torch.arange(n_seg, device=dev) + N_SEG)[None, :] <= M[:, None]
    n_valid = torch.clamp(valid.sum(dim=-1), min=1)
    return torch.sum(torch.mean(corr, dim=-1) * valid, dim=-1) / n_valid


def stoi_batch(x: torch.Tensor, y: torch.Tensor, fs: int = 16000) -> torch.Tensor:
    """Batched on-device STOI: [B, T] x [B, T] -> [B]."""
    with float32_math():
        x10 = resample(x.float(), fs)
        y10 = resample(y.float(), fs)
        return _stoi_10k(x10, y10)


def stoi(x: torch.Tensor, y: torch.Tensor, fs: int = 16000) -> torch.Tensor:
    """STOI(clean x, degraded y), a 0-d tensor in ~[0, 1].  [T] inputs."""
    return stoi_batch(x[None], y[None], fs)[0]
