"""The asteroid DCCRNet family (the reference's serving architecture).

Port of ``speech_enhancement_clskd_tpu/models/dccrnet.py``: the forked
asteroid ``DCCRNet``/``DCCRNet_mini`` (architectures ``DCCRN-CL`` and
``DCCRN-CL-test``), so that an asteroid publishable ``.pth`` loads and serves
unchanged (``load_reference_bundle``).

- STFT frontend: 512-filter real-DFT basis, kernel 400, stride 100,
  sqrt-Hann(400, periodic) window, rows scaled 1/sqrt(512) with DC and
  Nyquist x 1/sqrt(2), phase origin at sample -56; no padding.  Synthesis
  is the plain transpose (overlap-add with no window-envelope division).
- The masker drops the **Nyquist** bin (256 freqs; DCCRN drops DC), runs 6
  complex conv encoders (kernel (5, 2), stride (2, 1), freq pad 2, time pad
  0 on both sides, no bias: T shrinks by one frame a layer), real BN and a
  per-part PReLU (``CPReLU``), a 2-layer complex LSTM bottleneck on the
  sequence kernel (C-major ``[T, B, C*D]`` flatten) and a complex dense back,
  5 complex transpose-conv decoders (T grows back by one frame a layer) on
  ``[out, skip]``, and a biased transpose conv giving a tanh-bounded complex
  mask (``safe_magnitude``), zero-padded at Nyquist and multiplied into the
  spectrum.  The waveform is not clamped.

Feature taps follow the JAX module: the 6 encoder outputs, the decoders'
``[rnn_out] + 5`` (the reference hooks its Identity decoder too), and the
second LSTM layer's output.  So the decoder taps' channels are ``(kn[-1],
kn[n-2], ..., kn[0])`` (``tap_channels``), not DCCRN's.  State-dict keys
follow the flax tree (``utils.bridge``; ``out_conv`` is a transposed conv).

``forward(wav)`` serves (BN on running statistics);
``forward(wav, training=True)`` trains, as ``models.dccrn.DCCRN`` does: BN
on batch statistics with the running statistics moved, the LSTM backward
kernel under autograd, gradients through the filterbank's synthesis and
the mask's ``safe_magnitude`` (finite at an exact complex zero).

``cfg.compute_dtype="bfloat16"`` casts where the JAX module casts: the
packed spectrum after the float32 STFT goes to bf16, the convs, BN
(statistics in float32), PReLU, the LSTM layers (their recurrence in
float32) and the dense layer compute in bf16 with float32 parameters, so
every tap is bf16; the output conv's mask goes back to float32, and the
mask, the iSTFT and the waveform are float32.

``params_from_asteroid_state_dict`` maps an asteroid state_dict onto the
flax-layout tree (numpy), which ``utils.bridge.torch_state_from_flax`` turns
into this module's state_dict.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import DCCRNConfig, STFTConfig
from ..ops.complex_layers import (
    BatchNorm,
    ComplexConv2d,
    ComplexConvTranspose2d,
    ComplexDense,
    CPReLU,
    complex_cat,
)
from ..ops.complex_lstm import NaiveComplexLSTM
from ..ops.stft import frame, overlap_add, safe_magnitude
from ..utils.device import float32_math, resolve_device
from .dccrn import DCCRNOutput, FeatureTaps


@functools.lru_cache(maxsize=8)
def asteroid_filterbank(n_filters: int = 512, kernel_size: int = 400) -> np.ndarray:
    """[kernel, n_filters + 2] analysis basis, equal to an asteroid
    bundle's ``encoder.filterbank._filters`` (transposed)."""
    n = np.arange(kernel_size)
    win = np.sin(np.pi * n / kernel_size)  # sqrt-Hann, periodic
    k = np.arange(n_filters // 2 + 1)
    off = (n_filters - kernel_size) // 2
    phase = 2 * np.pi * k[None, :] * (n[:, None] + off) / n_filters
    scale = np.full(n_filters // 2 + 1, 1.0 / np.sqrt(n_filters))
    scale[0] /= np.sqrt(2.0)
    scale[-1] /= np.sqrt(2.0)
    cos_rows = np.cos(phase) * scale[None, :] * win[:, None]
    sin_rows = -np.sin(phase) * scale[None, :] * win[:, None]
    return np.concatenate([cos_rows, sin_rows], axis=1).astype(np.float32)


def asteroid_stft(wav: torch.Tensor, fb: torch.Tensor, stride: int = 100) -> torch.Tensor:
    """[B, L] -> packed [B, 2F, T] on the basis ``fb`` [kernel, 2F]; no
    padding or centering."""
    frames = frame(wav, fb.shape[0], stride)  # [B, T, kernel]
    return torch.matmul(frames, fb.to(wav.dtype)).transpose(1, 2)


def asteroid_istft(spec: torch.Tensor, fb: torch.Tensor, length: int,
                   stride: int = 100) -> torch.Tensor:
    """Packed [B, 2F, T] -> [B, length]: the plain transpose of
    ``asteroid_stft`` (no envelope division; the edges taper)."""
    frames = torch.matmul(spec.transpose(1, 2), fb.t().to(spec.dtype))  # [B, T, kernel]
    wav = overlap_add(frames, stride)
    out_len = wav.shape[-1]
    if out_len >= length:
        return wav[..., :length]
    return F.pad(wav, (0, length - out_len))


def tap_channels(cfg: DCCRNConfig):
    """The channel counts of a DCCRNet's encoder and decoder taps, in tap
    order: ``kn`` and ``(kn[-1], kn[n-2], ..., kn[0])``."""
    kn = tuple(cfg.kernel_num)
    return kn, (kn[-1],) + kn[-2::-1]


class DCCRNet(nn.Module):
    """DCCRNet/DCCRNet_mini.  ``cfg.kernel_num``/``rnn_units`` count the
    packed (re+im) width, half per part: the ``DCCRN-CL-test`` student is
    kernel_num (8, 16, 32, 64, 64, 64), rnn_units 64 (H = 32 a part)."""

    def __init__(self, cfg: DCCRNConfig):
        super().__init__()
        if cfg.family != "dccrnet":
            raise ValueError(f"DCCRNet is family 'dccrnet', not {cfg.family!r}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: the port computes in float32 or bfloat16")
        self.cfg = cfg
        s = cfg.stft
        self.register_buffer(
            "filterbank", torch.from_numpy(asteroid_filterbank(s.fft_len, s.win_len)),
            persistent=False)
        ks = cfg.kernel_size
        kn = tuple(cfg.kernel_num)
        n = len(kn)
        channels = (2,) + kn
        D = s.fft_len // 2  # the Nyquist bin is dropped
        for i in range(n):
            self.add_module(f"enc{i}_conv", ComplexConv2d(
                channels[i], kn[i], kernel_size=(ks, 2), strides=(2, 1),
                padding=(ks // 2, 0), causal=False, use_bias=False))
            self.add_module(f"enc{i}_bn", BatchNorm(kn[i]))
            self.add_module(f"enc{i}_prelu", CPReLU())
            D = (D + 2 * (ks // 2) - ks) // 2 + 1
        feat = kn[-1] // 2 * D  # per-part LSTM input width, C * D
        units = cfg.rnn_units // 2
        for li in range(cfg.rnn_layers):
            self.add_module(f"clstm{li}", NaiveComplexLSTM(
                feat if li == 0 else units, cfg.rnn_units))
        self.rnn_linear = ComplexDense(units, feat)
        for i in range(1, n):
            self.add_module(f"dec{i}_conv", ComplexConvTranspose2d(
                2 * kn[n - i], kn[n - 1 - i], kernel_size=(ks, 2), strides=(2, 1),
                padding=(ks // 2, 0), output_padding=(1, 0), use_bias=False))
            self.add_module(f"dec{i}_bn", BatchNorm(kn[n - 1 - i]))
            self.add_module(f"dec{i}_prelu", CPReLU())
        self.out_conv = ComplexConvTranspose2d(
            2 * kn[0], 2, kernel_size=(ks, 2), strides=(2, 1), padding=(ks // 2, 0),
            output_padding=(1, 0), use_bias=True)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """normal(0.05) conv weights, uniform +-1/sqrt(fan) LSTM and dense
        weights, unit BN, PReLU 0.25, all drawn from ``generator`` in module
        order."""
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
        """``training=True`` normalizes with batch statistics and moves the
        running ones.  ``bn_batch_stats=True`` normalizes with per-utterance
        batch statistics and leaves the running ones alone (the reference's
        eval, which never calls ``model.eval()``, and the frozen teacher of
        a training step).  ``training=True`` needs ``.train()``, as
        ``DCCRN.forward``."""
        if training and not self.training:
            raise RuntimeError(
                "training=True on a model in eval mode (make_model builds a serving "
                "model); call .train() first")
        cfg = self.cfg
        s = cfg.stft
        Fq = s.fft_len // 2 + 1
        n = len(cfg.kernel_num)
        bn = dict(training=training, use_batch_stats=bn_batch_stats)
        L = wav.shape[-1]

        spec = asteroid_stft(wav, self.filterbank, s.hop)
        re, im = spec[:, :Fq], spec[:, Fq:]  # [B, 257, T]
        # drop Nyquist, packed channels-last [B, D=256, T, 2], in the compute dtype
        x = torch.stack([re[:, :-1], im[:, :-1]], dim=-1).to(getattr(torch, cfg.compute_dtype))

        enc_taps: List[torch.Tensor] = []
        for i in range(n):
            x = getattr(self, f"enc{i}_conv")(x)
            x = getattr(self, f"enc{i}_bn")(x, **bn)
            x = getattr(self, f"enc{i}_prelu")(x)
            enc_taps.append(x)

        B, D, T, C2 = x.shape
        C = C2 // 2
        # [B, D, T, C] -> [T, B, C*D] per part, C-major as torch flattens
        hr = x[..., :C].permute(2, 0, 3, 1).reshape(T, B, C * D)
        hi = x[..., C:].permute(2, 0, 3, 1).reshape(T, B, C * D)
        for li in range(cfg.rnn_layers):
            hr, hi = getattr(self, f"clstm{li}")(hr, hi)
        lstm_r_tap, lstm_i_tap = hr, hi
        h = self.rnn_linear(torch.cat([hr, hi], dim=-1))
        x = torch.cat([p.reshape(T, B, C, D).permute(1, 3, 0, 2)
                       for p in (h[..., :C * D], h[..., C * D:])], dim=-1)

        # decoders: [rnn_out (the Identity tap), dec1..dec(n-1)]; cat [out, skip]
        dec_taps: List[torch.Tensor] = [x]
        for i in range(1, n):
            x = complex_cat([x, enc_taps[n - i]], dim=-1)
            x = getattr(self, f"dec{i}_conv")(x)
            x = getattr(self, f"dec{i}_bn")(x, **bn)
            x = getattr(self, f"dec{i}_prelu")(x)
            dec_taps.append(x)

        m = self.out_conv(complex_cat([x, enc_taps[0]], dim=-1)).float()
        mr, mi = m[..., 0], m[..., 1]  # [B, 256, T]
        # tanh-bounded complex mask (asteroid BoundComplexMask('tanh'))
        mag = safe_magnitude(mr, mi)
        scale = torch.tanh(mag) / torch.clamp(mag, min=1e-12)
        # pad Nyquist back with zeros -> [B, 257, T]
        mask_real = F.pad(mr * scale, (0, 0, 0, 1))
        mask_imag = F.pad(mi * scale, (0, 0, 0, 1))

        est_real = mask_real * re - mask_imag * im
        est_imag = mask_real * im + mask_imag * re
        out_wav = asteroid_istft(torch.cat([est_real, est_imag], dim=1), self.filterbank,
                                 L, s.hop)
        taps = FeatureTaps(encoder=enc_taps, decoder=dec_taps,
                           lstm_real=lstm_r_tap, lstm_imag=lstm_i_tap)
        return DCCRNOutput(out_wav, mask_real, mask_imag, est_real, est_imag, taps)


# ---------------------------------------------------------------------------
# asteroid publishable bundle (.pth) -> flax-layout variables
# ---------------------------------------------------------------------------

ARCHITECTURES = {
    # packed (re+im) widths; per part is half of these
    "DCCRN-CL": dict(kernel_num=(32, 64, 128, 256, 256, 256), rnn_units=256),
    "DCCRN-CL-mini": dict(kernel_num=(16, 32, 64, 128, 128, 128), rnn_units=64),
    "DCCRN-CL-test": dict(kernel_num=(8, 16, 32, 64, 64, 64), rnn_units=64),
}


def config_from_model_args(model_args: dict) -> DCCRNConfig:
    """A ``DCCRNConfig`` from an asteroid bundle's ``model_args`` (the
    schema of reference ``distill.py:280-294``)."""
    arch = model_args.get("architecture", "DCCRN-CL-test")
    if arch not in ARCHITECTURES:
        raise ValueError(f"unknown DCCRN architecture {arch!r}")
    geom = ARCHITECTURES[arch]
    return DCCRNConfig(
        name=arch.lower(),
        family="dccrnet",
        stft=STFTConfig(
            sample_rate=int(model_args.get("sample_rate", 16000)),
            win_len=int(model_args.get("stft_kernel_size", 400)),
            hop=int(model_args.get("stft_stride", 100)),
            fft_len=int(model_args.get("stft_n_filters", 512)),
            window="sqrthann",
        ),
        kernel_num=tuple(geom["kernel_num"]),
        rnn_units=geom["rnn_units"],
    )


def params_from_asteroid_state_dict(sd: dict, cfg: DCCRNConfig) -> Dict[str, Any]:
    """Map an asteroid state_dict (numpy or torch leaves) onto the flax
    tree ``{"params", "batch_stats"}`` of float32 numpy arrays.

    - conv weight ``(O, I, kh, kw)`` -> HWIO ``(kh, kw, I, O)``; transposed
      conv ``(I, O, kh, kw)`` -> ``(kh, kw, I, O)``;
    - LSTM ``w_ih (4H, F)`` -> ``(F, 4H)``, gate order (i, f, g, o) as torch;
    - a complex bias pair combines as ``(br - bi, br + bi)``: asteroid's
      ComplexMultiplicationWrapper adds each part's bias before the cross
      combination, the fused layers after it.
    """
    def a(key):
        t = sd[key]
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
        return np.asarray(t, dtype=np.float32)

    params: dict = {}
    stats: dict = {}

    def pair(src, leaf):
        return np.concatenate([a(f"{src}.re_module.{leaf}"), a(f"{src}.im_module.{leaf}")])

    def bn(dst, src):
        params[dst] = {"scale": pair(src, "weight"), "bias": pair(src, "bias")}
        stats[dst] = {"mean": pair(src, "running_mean"), "var": pair(src, "running_var")}

    def prelu(dst, src):
        params[dst] = {"alpha_r": a(f"{src}.re_module.weight"),
                       "alpha_i": a(f"{src}.im_module.weight")}

    def combined_bias(src):
        br, bi = a(f"{src}.re_module.bias"), a(f"{src}.im_module.bias")
        return {"br": br - bi, "bi": br + bi}

    n = len(cfg.kernel_num)
    for i in range(n):
        pre = f"masker.encoders.{i}"
        params[f"enc{i}_conv"] = {
            part: a(f"{pre}.conv.{m}.weight").transpose(2, 3, 1, 0)
            for part, m in (("wr", "re_module"), ("wi", "im_module"))}
        bn(f"enc{i}_bn", f"{pre}.norm")
        prelu(f"enc{i}_prelu", f"{pre}.activation")

    for li in range(cfg.rnn_layers):
        pre = f"masker.encoders.{n}.rnn.rnns.{li}"
        params[f"clstm{li}"] = {
            part: {
                "w_ih": a(f"{pre}.{m}.rnn.weight_ih_l0").T,
                "w_hh": a(f"{pre}.{m}.rnn.weight_hh_l0").T,
                "b_ih": a(f"{pre}.{m}.rnn.bias_ih_l0"),
                "b_hh": a(f"{pre}.{m}.rnn.bias_hh_l0"),
            } for part, m in (("real_lstm", "re_module"), ("imag_lstm", "im_module"))}

    lin = f"masker.encoders.{n}.linear"
    params["rnn_linear"] = {"wr": a(f"{lin}.re_module.weight").T,
                            "wi": a(f"{lin}.im_module.weight").T,
                            **combined_bias(lin)}

    for i in range(1, n):
        pre = f"masker.decoders.{i}"
        params[f"dec{i}_conv"] = {
            part: a(f"{pre}.deconv.{m}.weight").transpose(2, 3, 0, 1)
            for part, m in (("wr", "re_module"), ("wi", "im_module"))}
        bn(f"dec{i}_bn", f"{pre}.norm")
        prelu(f"dec{i}_prelu", f"{pre}.activation")

    out = "masker.output_layer.0"
    params["out_conv"] = {"wr": a(f"{out}.re_module.weight").transpose(2, 3, 0, 1),
                          "wi": a(f"{out}.im_module.weight").transpose(2, 3, 0, 1),
                          **combined_bias(out)}
    copy = lambda tree: {k: copy(v) if isinstance(v, dict) else np.ascontiguousarray(v)
                         for k, v in tree.items()}
    return {"params": copy(params), "batch_stats": copy(stats)}


def read_reference_bundle(path: str):
    """An asteroid publishable ``.pth`` -> ``(cfg, variables, checkpoint)``:
    its config, its flax-layout tree and the whole checkpoint read by
    ``utils.torch_zip.load_torch_checkpoint``."""
    from ..utils.torch_zip import load_torch_checkpoint

    ck = load_torch_checkpoint(path)
    cfg = config_from_model_args(ck.get("model_args", {}))
    return cfg, params_from_asteroid_state_dict(ck["state_dict"], cfg), ck


def load_reference_bundle(path: str, device: Union[str, torch.device] = "cuda"):
    """An asteroid publishable ``.pth`` -> ``(model, variables)``: the
    ``DCCRNet`` on ``device`` in eval mode with the bundle's weights, and
    the flax-layout tree it was loaded from.  ``device="cuda"`` with no GPU
    raises."""
    from ..utils.bridge import torch_state_from_flax

    dev = resolve_device(device)
    cfg, variables, _ = read_reference_bundle(path)
    model = DCCRNet(cfg)
    model.load_state_dict(torch_state_from_flax(variables), strict=True)
    return model.requires_grad_(False).eval().to(dev), variables
