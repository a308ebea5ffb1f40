"""DCCRN model family: one parameterized module covering teacher and student.

Port of ``speech_enhancement_clskd_tpu/models/dccrn.py``:

STFT -> 6 causal complex convs, each with BN and PReLU -> 2 complex LSTM
layers (the sequence kernels) -> 6 complex transpose convs with skip
``complex_cat`` -> mask (E, C or R) -> iSTFT.

``use_cbn=True`` puts ``ops.complex_bn.ComplexBatchNorm`` where the real BN
stands (each encoder block, each decoder block but the last), as the JAX
model does; it follows ``training`` alone and ignores ``bn_batch_stats``
(the JAX quirk: a frozen teacher with complex BN in a distillation step
normalizes with its running statistics).  ``use_clstm=False`` takes the
real-LSTM bottleneck: the full packed map flattened to ``[T, B, C*D]``,
``rnn_layers`` flax-named ``LSTMCell_{i}`` layers on the same sequence
kernels (``ops.complex_lstm.LSTMCell``), then ``lstm_proj`` back to C*D;
both LSTM taps are that projected map.  The real LSTM computes in float32
under bf16 compute (flax promotes its bf16 input to the float32
parameters), so the decoder after it does too, as in the JAX model.
``DCCRNConfig.bidirectional`` is ignored, as the JAX model ignores it.

``forward(wav)`` serves (BN on running statistics);
``forward(wav, training=True)`` trains (BN on batch statistics, running
statistics updated, the LSTM backward kernel under autograd).

Feature taps are explicit outputs (``FeatureTaps``) in the JAX layouts:
encoder/decoder taps channels-last packed complex ``[B, D, T, 2C]``, LSTM taps
``[T, B, F]``.

Tensor parallelism: ``shard_model`` cuts a built model (either family) over
the model ranks of a process group, ``full_state_dict``/``full_tensors``
gather its leaves back whole, ``load_full_state_dict`` loads whole tensors
into it, and ``gather_model`` undoes the cut (``parallel.mesh``).

``cfg.compute_dtype="bfloat16"`` follows the JAX model's dtype flow: the
STFT runs in float32 and its packed spectrum is cast to bf16; the convs,
BN (statistics in float32), PReLU and LSTM layers compute in bf16 with
float32 parameters, so every tap is bf16; the decoder's output goes back to
float32 before the mask (bf16 near-silence rounds to 0, ``ops/stft.py``'s
safe forms), and the mask, the iSTFT and the waveform are float32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Union

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
from ..ops.complex_bn import ComplexBatchNorm
from ..ops.complex_layers import TensorParallel
from ..ops.complex_lstm import Dense, LSTMCell, NaiveComplexLSTM
from ..parallel import distributed
from ..parallel.mesh import torch_shard_dims
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
            self.add_module(f"enc{i}_bn", self._bn(channels[i + 1]))
            self.add_module(f"enc{i}_prelu", PReLU())
            D = (D + 2 * (ks // 2) - ks) // 2 + 1
        feat = channels[-1] // 2 * D  # per-part LSTM input width
        for li in range(cfg.rnn_layers):
            if cfg.use_clstm:
                last = li == cfg.rnn_layers - 1
                self.add_module(f"clstm{li}", NaiveComplexLSTM(
                    feat if li == 0 else cfg.rnn_units // 2, cfg.rnn_units,
                    projection_dim=feat * 2 if last else None))
            else:  # the real LSTM over the full packed width
                self.add_module(f"LSTMCell_{li}", LSTMCell(
                    2 * feat if li == 0 else cfg.rnn_units, cfg.rnn_units))
        if not cfg.use_clstm:
            self.lstm_proj = Dense(cfg.rnn_units, 2 * feat)
        for i in range(n):
            j = n - 1 - i  # decoder mirrors encoder
            self.add_module(f"dec{i}_conv", ComplexConvTranspose2d(
                2 * channels[j + 1], channels[j], kernel_size=(ks, 2), strides=(2, 1),
                padding=(ks // 2, 0), output_padding=(1, 0),
                # drop the first time step of each decoder layer
                time_crop_left=1))
            if j != 0:
                self.add_module(f"dec{i}_bn", self._bn(channels[j]))
                self.add_module(f"dec{i}_prelu", PReLU())

    def _bn(self, channels: int) -> nn.Module:
        """A block's BN over ``channels`` packed channels: real, or complex
        over ``channels // 2`` complex ones with ``use_cbn``."""
        return ComplexBatchNorm(channels // 2) if self.cfg.use_cbn else BatchNorm(channels)

    def _norm(self, name: str, x: torch.Tensor, training: bool,
              bn_batch_stats: Optional[bool]) -> torch.Tensor:
        bn = getattr(self, name)
        if self.cfg.use_cbn:
            return bn(x, training=training)  # no bn_batch_stats, as in JAX
        return bn(x, training=training, use_batch_stats=bn_batch_stats)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """normal(0.05) conv weights, uniform +-1/sqrt(H) complex-LSTM
        weights (the real LSTM's and ``lstm_proj``'s as flax draws them:
        lecun-normal input kernels, orthogonal recurrent kernels, zero
        biases), unit BN (complex BN's ``Wri`` uniform in [-0.9, 0.9]),
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

        spec = stft_ops.stft(wav, k)  # [B, 2F, T']
        re, im = spec[:, :Fq], spec[:, Fq:]
        spec_mags = torch.sqrt(re**2 + im**2 + 1e-8)
        spec_phase = stft_ops.safe_arctan2(im, re)

        # drop the DC bin, go channels-last packed complex: [B, D, T, 2]
        x = torch.stack([re[:, 1:], im[:, 1:]], dim=-1).to(getattr(torch, cfg.compute_dtype))

        enc_taps: List[torch.Tensor] = []
        for i in range(n):
            x = getattr(self, f"enc{i}_conv")(x)
            x = self._norm(f"enc{i}_bn", x, training, bn_batch_stats)
            x = getattr(self, f"enc{i}_prelu")(x)
            enc_taps.append(x)

        B, D, T, C = x.shape
        half = C // 2
        if cfg.use_clstm:
            # [B, D, T, C] -> [T, B, C/2*D] per part, channel-major flattening
            hr = x[..., :half].permute(2, 0, 3, 1).reshape(T, B, half * D)
            hi = x[..., half:].permute(2, 0, 3, 1).reshape(T, B, half * D)
            for li in range(cfg.rnn_layers):
                hr, hi = getattr(self, f"clstm{li}")(hr, hi)
            lstm_r_tap, lstm_i_tap = hr, hi
            x = torch.cat([h.reshape(T, B, half, D).permute(1, 3, 0, 2) for h in (hr, hi)],
                          dim=-1)
        else:
            # the full packed map [B, D, T, C] -> [T, B, C*D], and back
            h = x.permute(2, 0, 3, 1).reshape(T, B, C * D)
            for li in range(cfg.rnn_layers):
                h = getattr(self, f"LSTMCell_{li}")(h)
            h = self.lstm_proj(h)
            lstm_r_tap = lstm_i_tap = h
            x = h.reshape(T, B, C, D).permute(1, 3, 0, 2)

        dec_taps: List[torch.Tensor] = []
        for i in range(n):
            j = n - 1 - i
            x = complex_cat([x, enc_taps[j]], dim=-1)
            x = getattr(self, f"dec{i}_conv")(x)
            if j != 0:
                x = self._norm(f"dec{i}_bn", x, training, bn_batch_stats)
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


# ----------------------------------------------------------------- tensor parallelism


def shard_model(model: nn.Module, group) -> Dict[str, int]:
    """Tensor parallelism over the model ranks of ``group``, in place, for
    either family (DCCRN and the asteroid DCCRNet are built from the same
    layers): every parameter the JAX rule shards
    (``parallel.mesh.torch_shard_dims``) is replaced by a new
    ``nn.Parameter`` holding this rank's slice along its torch dim (so an
    optimizer is made after), and its layer is told the group and the dim
    (``ops.complex_layers.TensorParallel``): it then runs column-parallel,
    or gathers the leaf whole where a split would cut the LSTM recurrence.
    Returns ``{name: dim}`` of the sliced leaves, kept as
    ``model.tp_shards`` beside ``model.tp_group``.  A leaf the rule shards
    in a layer that cannot run sharded raises; a leaf it leaves alone stays
    whole on every rank."""
    if getattr(model, "tp_shards", None):
        raise ValueError("the model is sharded already")
    n, r = distributed.world_size(group), distributed.rank(group)
    shards: Dict[str, int] = {}
    for name, dim in torch_shard_dims(model.named_parameters(), n).items():
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        layer = model.get_submodule(owner)
        if not isinstance(layer, TensorParallel):
            raise NotImplementedError(
                f"{name}: the rule shards it, and {type(layer).__name__} cannot run sharded")
        p = getattr(layer, leaf)
        size = p.shape[dim] // n
        setattr(layer, leaf, nn.Parameter(p.detach().narrow(dim, r * size, size).clone(),
                                          requires_grad=p.requires_grad))
        layer.tp_group = group
        layer.tp_dims = {**layer.tp_dims, leaf: dim}
        shards[name] = dim
    model.tp_group, model.tp_shards = group, shards
    return shards


def model_shards(model: nn.Module) -> Dict[str, int]:
    """``{name: dim}`` of the leaves ``shard_model`` sliced (empty for a
    whole model)."""
    return getattr(model, "tp_shards", None) or {}


@torch.no_grad()
def full_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by the model's parameter names: its state_dict, the
    gradients, an optimizer's moments) with each sliced leaf gathered
    whole over the model ranks, the others as they are.  A collective:
    every model rank calls it with the same names in the same order."""
    shards = model_shards(model)
    return {k: distributed.gather_out(v.detach(), shards[k], model.tp_group) if k in shards
            else v for k, v in tensors.items()}


def local_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole ``tensors`` (by parameter name) cut to this rank's slice of
    each sliced leaf (views), the others as they are."""
    shards = model_shards(model)
    if not shards:
        return dict(tensors)
    n, r = distributed.world_size(model.tp_group), distributed.rank(model.tp_group)
    out = {}
    for k, v in tensors.items():
        if k in shards:
            size = v.shape[shards[k]] // n
            v = v.narrow(shards[k], r * size, size)
        out[k] = v
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict with every leaf whole (``full_tensors``; the
    state_dict itself for a whole model)."""
    return full_tensors(model, model.state_dict())


def load_full_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                         strict: bool = True) -> None:
    """``load_state_dict`` of a whole state (a one-process model's, a
    checkpoint's) into a model whole or sharded: each sliced leaf takes its
    slice."""
    model.load_state_dict(local_tensors(model, state), strict=strict)


def gather_model(model: nn.Module) -> None:
    """Undo ``shard_model`` in place: every sliced leaf gathered whole into
    a new ``nn.Parameter`` and every layer's group forgotten (a collective,
    as ``full_tensors``)."""
    shards = model_shards(model)
    if not shards:
        return
    whole = full_tensors(model, dict(model.named_parameters()))
    for name in shards:
        owner, _, leaf = name.rpartition(".")
        layer = model.get_submodule(owner)
        p = getattr(layer, leaf)
        setattr(layer, leaf, nn.Parameter(whole[name], requires_grad=p.requires_grad))
        layer.tp_group, layer.tp_dims = None, {}
    model.tp_group, model.tp_shards = None, {}
