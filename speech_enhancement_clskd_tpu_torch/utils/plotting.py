"""Spectrogram / mask / error visualization to numpy RGB arrays.

Equivalent of reference ``tools_for_model.py:606-705`` (matplotlib specgram
figures rendered to HxWx3 uint8 for TensorBoard-style image logging).
Matplotlib is imported inside each function (the card's machine has none);
headless Agg backend.  The port's copy of
``speech_enhancement_clskd_tpu/utils/plotting.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _fig_to_np(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def plot_spectrogram_to_numpy(
    wav: np.ndarray,
    fs: int = 16000,
    n_fft: int = 512,
    n_overlap: int = 400,
    mode: Optional[str] = None,
    clim=(-120, 0),
    label: Optional[str] = None,
) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    kw = dict(NFFT=int(n_fft), Fs=int(fs), noverlap=n_overlap, cmap="jet")
    if mode:
        kw["mode"] = mode
    _, _, _, cax = ax.specgram(np.asarray(wav), **kw)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    fig.tight_layout()
    cax.set_clim(*clim)
    fig.colorbar(cax, label=label)
    data = _fig_to_np(fig)
    plt.close(fig)
    return data


def plot_mask_to_numpy(
    mask: np.ndarray,
    clim=(0, 1),
    cmap: str = "viridis",
) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(np.asarray(mask).T, aspect="auto", origin="lower",
                   interpolation="none", cmap=cmap)
    ax.set_xlabel("Frame")
    ax.set_ylabel("Frequency bin")
    fig.tight_layout()
    fig.colorbar(im, ax=ax)
    im.set_clim(*clim)
    data = _fig_to_np(fig)
    plt.close(fig)
    return data


def plot_error_to_numpy(
    estimated: np.ndarray,
    target: np.ndarray,
    fs: int = 16000,
    n_fft: int = 512,
    n_overlap: int = 400,
    clim=(-20, 20),
    label: Optional[str] = None,
) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import mlab

    p1, _, _ = mlab.specgram(np.asarray(estimated), NFFT=n_fft, Fs=fs,
                             noverlap=n_overlap)
    p2, _, _ = mlab.specgram(np.asarray(target), NFFT=n_fft, Fs=fs,
                             noverlap=n_overlap)
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(
        10 * np.log10(p1 + 1e-12) - 10 * np.log10(p2 + 1e-12),
        aspect="auto", origin="lower", interpolation="none", cmap="jet",
    )
    ax.set_xlabel("Frame")
    ax.set_ylabel("Frequency bin")
    fig.tight_layout()
    fig.colorbar(im, ax=ax, label=label)
    im.set_clim(*clim)
    data = _fig_to_np(fig)
    plt.close(fig)
    return data
