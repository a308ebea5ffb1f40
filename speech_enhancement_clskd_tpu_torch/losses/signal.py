"""Time-domain signal losses (parity with reference tools_for_loss.py:16-108).

Port of ``speech_enhancement_clskd_tpu/losses/signal.py``: pure functions
over ``[..., T]`` waveform tensors, with the reference quirks kept
knowingly (documented per function) so loss values are comparable across
frameworks.
"""

from __future__ import annotations

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def sdr(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Reference ``sdr`` (tools_for_loss.py:30-34).

    Note the reference squares the energies once more inside the log (sn**2 /
    (e**2)), i.e. it returns 20*log10 of the energy ratio; kept for parity.
    """
    sn = _dot(s1, s1)
    err = _dot(s1 - s2, s1 - s2)
    return torch.mean(10 * torch.log10(sn**2 / (err**2 + eps)))


def si_snr(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR of estimate s1 against reference s2
    (tools_for_loss.py:37-47)."""
    s_target = _dot(s1, s2) / (_dot(s2, s2) + eps) * s2
    e_noise = s1 - s_target
    return torch.mean(
        10 * torch.log10(_dot(s_target, s_target) / (_dot(e_noise, e_noise) + eps) + eps))


def si_sdr(reference: torch.Tensor, estimation: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SI-SDR per Le Roux et al. (tools_for_loss.py:50-97): mean over the batch
    of the power ratio, in dB (the reference averages ratios, not dB)."""
    ref_energy = torch.sum(reference**2, dim=-1, keepdim=True)
    scale = torch.sum(reference * estimation, dim=-1, keepdim=True) / ref_energy + eps
    projection = scale * reference
    noise = estimation - projection
    ratio = torch.sum(projection**2, dim=-1) / torch.sum(noise**2, dim=-1) + eps
    return 10 * torch.log10(torch.mean(ratio) + eps)


def rmse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error (tools_for_loss.py:100-108)."""
    mse = torch.mean((y_pred - y_true) ** 2, dim=-1)
    return torch.mean(torch.sqrt(mse + 1e-7))
