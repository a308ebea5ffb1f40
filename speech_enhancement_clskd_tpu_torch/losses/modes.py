"""The 12-mode combined loss of standalone DCCRN training.

Port of ``speech_enhancement_clskd_tpu/losses/modes.py``, the behavioural
equivalent of the reference's ``DCCRN.loss``: each mode blends time-domain,
log-mel and PMSQE terms with the reference's fixed ratios.  The JAX weights
and quirks are kept as they are: ``MSE+PMSQE`` returns the PMSQE term alone,
``SI-SNR+SI-SDR`` calls ``si_sdr(inputs, labels)`` with its arguments the
other way round from the ``SI-SDR`` mode, and ``SDR+PMSQE`` (the default)
weighs SDR and PMSQE 1:15.

Every term runs in float32 whatever the model's compute dtype: the log,
division and bark terms (PMSQE above all) overflow in bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import stft as stft_ops
from .mel import array_mel_loss
from .pmsqe import pmsqe_from_wav
from .signal import sdr, si_sdr, si_snr

LOSS_MODES = ("MSE", "SDR", "SI-SNR", "SI-SDR", "MSE+LMS", "MSE+SI-SNR", "MSE+PMSQE",
              "SI-SNR+SI-SDR", "SDR+LMS", "SDR+PMSQE", "SI-SNR+LMS", "SI-SNR+PMSQE")


def _mel_term(labels, est_real, est_imag, k: stft_ops.STFTKernels) -> torch.Tensor:
    clean = stft_ops.stft(labels, k)
    F = k.fft_len // 2 + 1
    cr, ci = clean[:, :F], clean[:, F:]
    clean_mags = torch.sqrt(cr**2 + ci**2 + 1e-7)
    est_mags = torch.sqrt(est_real**2 + est_imag**2 + 1e-7)
    return array_mel_loss(clean_mags, est_mags, fft_size=k.fft_len)


def mean_over_rows(loss_mode: str) -> bool:
    """Whether every term of ``loss_mode`` is a mean over the batch's rows
    (of per-utterance or per-element values), so that the mean of the
    ranks' losses on equal shares of a batch is the batch's loss: all but
    the modes with SI-SDR, a ratio of batch means."""
    return "SI-SDR" not in loss_mode


def dccrn_loss(
    inputs: torch.Tensor,
    labels: torch.Tensor,
    est_real: Optional[torch.Tensor] = None,
    est_imag: Optional[torch.Tensor] = None,
    loss_mode: str = "SDR+PMSQE",
    stft_kernels: Optional[stft_ops.STFTKernels] = None,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """``inputs`` the enhanced waveform [B, T], ``labels`` the clean one.

    ``est_real``/``est_imag``: the masked spectrum [B, F, T'] (the ``*+LMS``
    modes); ``stft_kernels``: the analysis bases of the mel terms (the
    model's; the default frontend's otherwise, on the inputs' device).  An
    unknown mode raises ``ValueError``."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    k = stft_kernels if stft_kernels is not None else stft_ops.make_kernels().to(inputs.device)
    inputs = inputs.float()
    labels = labels.float()
    if est_real is not None:
        est_real = est_real.float()
    if est_imag is not None:
        est_imag = est_imag.float()

    def mse():
        return torch.mean((inputs - labels) ** 2)

    def mel():
        return _mel_term(labels, est_real, est_imag, k)

    def pmsqe():
        return pmsqe_from_wav(labels, inputs, sample_rate)

    if loss_mode == "MSE":
        return mse()
    if loss_mode == "SDR":
        return -sdr(labels, inputs)
    if loss_mode == "SI-SNR":
        return -si_snr(inputs, labels)
    if loss_mode == "SI-SDR":
        return -si_sdr(labels, inputs)
    if loss_mode == "MSE+LMS":
        return (1e3 * mse() + mel()) / (1e3 + 1)
    if loss_mode == "MSE+SI-SNR":
        return (-si_snr(inputs, labels) + 100 * mse()) / 101
    if loss_mode == "MSE+PMSQE":
        return pmsqe()
    if loss_mode == "SI-SNR+SI-SDR":
        return (-si_snr(inputs, labels) - si_sdr(inputs, labels)) / 2
    if loss_mode == "SDR+LMS":
        return (-sdr(labels, inputs) + 2 * mel()) / 3
    if loss_mode == "SDR+PMSQE":
        return (-sdr(labels, inputs) + 15 * pmsqe()) / 16
    if loss_mode == "SI-SNR+LMS":
        return (-si_snr(inputs, labels) + 2 * mel()) / 3
    return (8 * pmsqe() - si_snr(inputs, labels)) / 9  # SI-SNR+PMSQE
