"""DCCRN model family: one parameterized module covering teacher and student.

Port of ``speech_enhancement_clskd_tpu/models/dccrn.py``:

STFT -> 6 causal complex convs, each with BN and PReLU -> 2 complex LSTM
layers (the sequence kernels) -> 6 complex transpose convs with skip
``complex_cat`` -> mask (E, C or R) -> iSTFT.

``forward(wav)`` serves (BN on running statistics);
``forward(wav, training=True)`` trains (BN on batch statistics, running
statistics updated, the LSTM backward kernel under autograd).

Feature taps are explicit outputs (``FeatureTaps``) in the JAX layouts:
encoder/decoder taps channels-last packed complex ``[B, D, T, 2C]``, LSTM taps
``[T, B, F]``.

``cfg.compute_dtype="bfloat16"`` follows the JAX model's dtype flow: the
STFT runs in float32 and its packed spectrum is cast to bf16; the convs,
BN (statistics in float32), PReLU and LSTM layers compute in bf16 with
float32 parameters, so every tap is bf16; the decoder's output goes back to
float32 before the mask (bf16 near-silence rounds to 0, ``ops/stft.py``'s
safe forms), and the mask, the iSTFT and the waveform are float32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DCCRNConfig
from ..ops import stft as stft_ops
from ..ops.complex_layers import (
    BatchNorm,
    ComplexConv2d,
    ComplexConvTranspose2d,
    PReLU,
    complex_cat,
)
from ..ops.complex_lstm import NaiveComplexLSTM
from ..utils.device import float32_math, resolve_device


class FeatureTaps(NamedTuple):
    """Cross-layer activations for distillation.

    encoder/decoder entries are packed-complex ``[B, D, T, 2C]``;
    lstm_real/lstm_imag are the last bottleneck layer's outputs ``[T, B, F]``.
    """

    encoder: List[torch.Tensor]
    decoder: List[torch.Tensor]
    lstm_real: torch.Tensor
    lstm_imag: torch.Tensor


class DCCRNOutput(NamedTuple):
    wav: torch.Tensor  # [B, T] enhanced waveform, clamped to [-1, 1]
    mask_real: torch.Tensor  # [B, F, T']
    mask_imag: torch.Tensor
    est_real: torch.Tensor  # masked spectrum
    est_imag: torch.Tensor
    taps: FeatureTaps


def _check_supported(cfg: DCCRNConfig) -> None:
    if cfg.family != "dccrn":
        raise ValueError(
            f"DCCRN is family 'dccrn', not {cfg.family!r} (make_model builds the "
            "asteroid DCCRNet for 'dccrnet')")
    if cfg.use_cbn:
        raise NotImplementedError(
            "use_cbn: complex batchnorm (ops/complex_bn.py) is ROADMAP queue 1 item 7")
    if not cfg.use_clstm:
        raise NotImplementedError(
            "use_clstm=False: the real-LSTM bottleneck is ROADMAP queue 1 item 7")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port computes in float32 or bfloat16")
    if cfg.masking_mode not in ("E", "C", "R"):
        raise ValueError(f"unknown masking_mode {cfg.masking_mode!r}")


class DCCRN(nn.Module):
    """Deep complex conv recurrent net."""

    def __init__(self, cfg: DCCRNConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        s = cfg.stft
        self.stft_kernels = stft_ops.make_kernels(s.win_len, s.hop, s.fft_len, s.window)
        ks = cfg.kernel_size
        channels = (2,) + tuple(cfg.kernel_num)
        n = len(cfg.kernel_num)
        D = s.fft_len // 2  # the DC bin is dropped
        for i in range(n):
            self.add_module(f"enc{i}_conv", ComplexConv2d(
                channels[i], channels[i + 1], kernel_size=(ks, 2), strides=(2, 1),
                padding=(ks // 2, 1)))
            self.add_module(f"enc{i}_bn", BatchNorm(channels[i + 1]))
            self.add_module(f"enc{i}_prelu", PReLU())
            D = (D + 2 * (ks // 2) - ks) // 2 + 1
        feat = channels[-1] // 2 * D  # per-part LSTM input width
        for li in range(cfg.rnn_layers):
            last = li == cfg.rnn_layers - 1
            self.add_module(f"clstm{li}", NaiveComplexLSTM(
                feat if li == 0 else cfg.rnn_units // 2, cfg.rnn_units,
                projection_dim=feat * 2 if last else None))
        for i in range(n):
            j = n - 1 - i  # decoder mirrors encoder
            self.add_module(f"dec{i}_conv", ComplexConvTranspose2d(
                2 * channels[j + 1], channels[j], kernel_size=(ks, 2), strides=(2, 1),
                padding=(ks // 2, 0), output_padding=(1, 0),
                # drop the first time step of each decoder layer
                time_crop_left=1))
            if j != 0:
                self.add_module(f"dec{i}_bn", BatchNorm(channels[j]))
                self.add_module(f"dec{i}_prelu", PReLU())

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """normal(0.05) conv weights, uniform +-1/sqrt(H) LSTM weights, unit BN,
        PReLU 0.25, all drawn from ``generator`` in module order."""
        for m in self.children():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    @float32_math()
    def forward(
        self,
        wav: torch.Tensor,
        training: bool = False,
        bn_batch_stats: Optional[bool] = None,
    ) -> DCCRNOutput:
        """``training=True`` normalizes with batch statistics and updates
        the BN running statistics.  ``bn_batch_stats`` overrides which
        statistics normalize (None follows ``training``): ``True`` with
        ``training=False`` uses per-batch statistics and leaves the running
        ones as they are (the reference's eval quirk, and the frozen teacher
        of a training step).

        Computes in full float32 whatever the global TF32 settings: cuDNN's
        default TF32 convolutions are off inside the forward.  A caller that
        runs the backward runs it under ``utils.device.float32_math`` too.

        ``training=True`` needs the module in train mode (``.train()``): a
        serving model from ``make_model`` is in eval mode, and a training
        forward would move its running statistics."""
        if training and not self.training:
            raise RuntimeError(
                "training=True on a model in eval mode (make_model builds a serving "
                "model); call .train() first")
        cfg = self.cfg
        k = self.stft_kernels
        n = len(cfg.kernel_num)
        Fq = cfg.stft.fft_len // 2 + 1
        bn = dict(training=training, use_batch_stats=bn_batch_stats)

        spec = stft_ops.stft(wav, k)  # [B, 2F, T']
        re, im = spec[:, :Fq], spec[:, Fq:]
        spec_mags = torch.sqrt(re**2 + im**2 + 1e-8)
        spec_phase = stft_ops.safe_arctan2(im, re)

        # drop the DC bin, go channels-last packed complex: [B, D, T, 2]
        x = torch.stack([re[:, 1:], im[:, 1:]], dim=-1).to(getattr(torch, cfg.compute_dtype))

        enc_taps: List[torch.Tensor] = []
        for i in range(n):
            x = getattr(self, f"enc{i}_conv")(x)
            x = getattr(self, f"enc{i}_bn")(x, **bn)
            x = getattr(self, f"enc{i}_prelu")(x)
            enc_taps.append(x)

        B, D, T, C = x.shape
        half = C // 2
        # [B, D, T, C] -> [T, B, C/2*D] per part, channel-major flattening
        hr = x[..., :half].permute(2, 0, 3, 1).reshape(T, B, half * D)
        hi = x[..., half:].permute(2, 0, 3, 1).reshape(T, B, half * D)
        for li in range(cfg.rnn_layers):
            hr, hi = getattr(self, f"clstm{li}")(hr, hi)
        lstm_r_tap, lstm_i_tap = hr, hi
        x = torch.cat([h.reshape(T, B, half, D).permute(1, 3, 0, 2) for h in (hr, hi)],
                      dim=-1)

        dec_taps: List[torch.Tensor] = []
        for i in range(n):
            j = n - 1 - i
            x = complex_cat([x, enc_taps[j]], dim=-1)
            x = getattr(self, f"dec{i}_conv")(x)
            if j != 0:
                x = getattr(self, f"dec{i}_bn")(x, **bn)
                x = getattr(self, f"dec{i}_prelu")(x)
            dec_taps.append(x)

        # x: [B, D=F-1, T, 2] -> masks [B, F, T] (pad the DC bin back), in float32
        xf = x.float()
        mask_real = F.pad(xf[..., 0], (0, 0, 1, 0))
        mask_imag = F.pad(xf[..., 1], (0, 0, 1, 0))

        mode = cfg.masking_mode
        if mode == "E":
            mask_mags = stft_ops.safe_magnitude(mask_real, mask_imag)
            real_phase = mask_real / (mask_mags + 1e-8)
            imag_phase = mask_imag / (mask_mags + 1e-8)
            mask_phase = stft_ops.safe_arctan2(imag_phase, real_phase)
            est_mags = torch.tanh(mask_mags) * spec_mags
            est_phase = spec_phase + mask_phase
            est_real = est_mags * torch.cos(est_phase)
            est_imag = est_mags * torch.sin(est_phase)
        elif mode == "C":
            est_real = re * mask_real - im * mask_imag
            est_imag = re * mask_imag + im * mask_real
        else:  # "R"
            est_real = re * mask_real
            est_imag = im * mask_imag

        out_spec = torch.cat([est_real, est_imag], dim=1)
        out_wav = torch.clamp(stft_ops.istft(out_spec, k), -1.0, 1.0)
        taps = FeatureTaps(encoder=enc_taps, decoder=dec_taps,
                           lstm_real=lstm_r_tap, lstm_imag=lstm_i_tap)
        return DCCRNOutput(out_wav, mask_real, mask_imag, est_real, est_imag, taps)


def build_model(cfg: DCCRNConfig) -> nn.Module:
    """The module of ``cfg.family`` on the CPU, its parameters not drawn
    yet (``reset_parameters``): ``DCCRN``, or the asteroid
    ``models.dccrnet.DCCRNet`` for ``family="dccrnet"`` (the JAX
    ``make_model``'s dispatch)."""
    if cfg.family == "dccrnet":
        from .dccrnet import DCCRNet

        return DCCRNet(cfg)
    return DCCRN(cfg)


def make_model(cfg: DCCRNConfig, device: Union[str, torch.device] = "cuda",
               seed: int = 0) -> nn.Module:
    """A serving model on ``device`` with seeded random weights: ``DCCRN``,
    or the asteroid ``models.dccrnet.DCCRNet`` for ``cfg.family="dccrnet"``.

    The weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and moved to ``device``; load trained ones with ``load_state_dict`` (see
    ``utils.bridge``).  The model is in eval mode with gradients off, for
    serving; ``train.trainer.Trainer`` builds its own models for training.
    ``device="cuda"`` with no GPU raises.
    """
    dev = resolve_device(device)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.requires_grad_(False).eval().to(dev)
