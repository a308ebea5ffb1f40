"""The distillation strategies as loss functions.

Port of ``speech_enhancement_clskd_tpu/distill/strategies.py``, its five
strategies:

- ``clskd``: SPKD between the ReviewKD-fused student taps and the teacher's
  encoder/decoder taps, plus SPKD on the complex-LSTM real/imaginary states
  (a fused map given as ``(raw, a, b)``, bn2's affine unapplied, takes
  ``spkd_loss_affine``);
- ``reviewkd``: HCL between the same fused taps and the teacher's, both as
  ``[B, C, D, T]``; on the LSTM states HCL where the student's and the
  teacher's widths are equal, SPKD where they differ;
- ``spkd``: SPKD between the output waveforms ``[B, samples]`` (from clips of
  32.8 s on, through the fused Gram pair K2: ``losses/kd.py``);
- ``mse``: the mean squared difference of the output waveforms;
- ``stft``: the base loss's STFT-magnitude term between the outputs.

Every strategy adds the base loss, the single-resolution log-STFT-magnitude
L1 of the student output against the clean target.

Under data parallelism (``group``) the SPKD Grams are those of the global
batch (``spkd_term``); every other term is a mean over the rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import DistillConfig
from ..losses.kd import hcl, spkd_loss, spkd_loss_affine
from ..losses.spectral import multi_resolution_stft_loss
from ..models.dccrn import DCCRNOutput
from ..parallel import distributed

STRATEGIES = ("clskd", "reviewkd", "spkd", "mse", "stft")


def base_loss(student_wav: torch.Tensor, clean: torch.Tensor, dcfg: DistillConfig) -> torch.Tensor:
    """MRSTFT magnitude term against the clean target, in float32."""
    _, mag = multi_resolution_stft_loss(
        student_wav.float(),
        clean.float(),
        fft_sizes=dcfg.mrstft_fft_sizes,
        hop_sizes=dcfg.mrstft_hop_sizes,
        win_lengths=dcfg.mrstft_win_lengths,
        factor_sc=dcfg.mrstft_factor_sc,
        factor_mag=dcfg.mrstft_factor_mag,
    )
    return mag


def distill_loss(
    strategy: str,
    s_out: DCCRNOutput,
    t_out: DCCRNOutput,
    clean: torch.Tensor,
    dcfg: DistillConfig,
    fused_encoder: Optional[list] = None,
    fused_decoder: Optional[list] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss + per-term logs (``loss_keys(strategy)``) for one strategy.
    ``fused_encoder`` and ``fused_decoder`` are the ReviewKD outputs over the
    student's taps (``clskd`` and ``reviewkd``; the other strategies take
    none).

    ``group``: the data-parallel group whose ranks' rows form the batch
    (``None``: one process).  Each rank's loss is then its share of the
    global loss times the group's size, as the trainer's gradient average
    wants it: a term that is a mean over the rows (the base loss, ``mse``,
    ``stft``, HCL) is the rank's own mean, and an SPKD term is computed
    alike on every rank over the global batch (``spkd_term``)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown distill strategy {strategy!r}")
    logs: Dict[str, torch.Tensor] = {}
    base = base_loss(s_out.wav, clean, dcfg)
    logs["base_loss"] = base
    gg = dcfg.spkd_gram_groups

    def _sp(sf, tf, batch_axis=0, groups=gg):
        return spkd_term(sf, tf, groups, group, batch_axis)

    if strategy == "clskd":
        enc = sum(_sp(sf, tf) for sf, tf in zip(fused_encoder, t_out.taps.encoder))
        dec = sum(_sp(sf, tf) for sf, tf in zip(fused_decoder, t_out.taps.decoder))
        # LSTM taps are [T, B, F]: the Gram runs over batch axis 1
        lr = _sp(s_out.taps.lstm_real, t_out.taps.lstm_real, batch_axis=1)
        li = _sp(s_out.taps.lstm_imag, t_out.taps.lstm_imag, batch_axis=1)
        logs.update(enc_loss=enc, dec_loss=dec, clstm_real_loss=lr, clstm_imag_loss=li)
        distill = enc + dec + lr + li
    elif strategy == "reviewkd":
        def nchw(ts):
            return [t.permute(0, 3, 1, 2) for t in ts]

        enc = hcl(nchw(fused_encoder), nchw(t_out.taps.encoder))
        dec = hcl(nchw(fused_decoder), nchw(t_out.taps.decoder))

        def lstm_term(s_tap, t_tap):
            # [T, B, F] -> [B, T, F]; the JAX defaults of spkd_loss (batch
            # axis 0, one Gram) where the widths differ
            s_b, t_b = s_tap.transpose(0, 1), t_tap.transpose(0, 1)
            if s_b.shape == t_b.shape:
                return hcl([s_b], [t_b])
            return _sp(s_b, t_b, groups=1)

        lr = lstm_term(s_out.taps.lstm_real, t_out.taps.lstm_real)
        li = lstm_term(s_out.taps.lstm_imag, t_out.taps.lstm_imag)
        logs.update(enc_loss=enc, dec_loss=dec, clstm_real_loss=lr, clstm_imag_loss=li)
        distill = enc + dec + lr + li
    elif strategy == "spkd":
        distill = _sp(s_out.wav, t_out.wav)
        logs["spkd_loss"] = distill
    elif strategy == "mse":
        distill = torch.mean((s_out.wav - t_out.wav) ** 2)
        logs["mse_loss"] = distill
    else:  # "stft"
        distill = base_loss(s_out.wav, t_out.wav, dcfg)
        logs["stft_loss"] = distill
    total = base + dcfg.distill_weight * distill
    logs["train_loss"] = total
    return total, logs


def spkd_term(student, teacher, groups: int, group: Optional[dist.ProcessGroup] = None,
              batch_axis: int = 0) -> torch.Tensor:
    """The ``batchmean`` SPKD loss of ``student`` (a map, or ``(raw conv2
    map, a, b)`` with bn2's affine folded into the Grams) against
    ``teacher`` in ``groups`` Gram groups along ``batch_axis``, over the
    global batch of ``group``'s ranks.  Where ``groups`` is a multiple of
    the group's size each rank's rows hold whole groups, and the rank takes
    the Grams of its own ``groups / N`` (the mean over the ranks is the
    global mean); otherwise both maps are gathered along their batch axis
    first (``parallel.distributed.all_gather``) and every rank computes the
    global loss alike, the Gram gate (``kernels.gram``) seeing the same
    ``[B, D]`` as in one process."""
    n = distributed.world_size(group)
    if groups % n:
        if isinstance(student, tuple):
            student = (distributed.all_gather(student[0], batch_axis, group),) + student[1:]
        else:
            student = distributed.all_gather(student, batch_axis, group)
        teacher = distributed.all_gather(teacher, batch_axis, group)
        n = 1
    if isinstance(student, tuple):  # (raw conv2 map, a, b): bn2 folded into the Grams
        if groups > 1:  # as spkd_loss_affine takes groups > 1
            raw, a, b = student
            student = raw * a.to(raw.dtype) + b.to(raw.dtype)
        else:
            return spkd_loss_affine(student[0], student[1], student[2], teacher, "batchmean")
    # the fused Gram pair only for one global group, as in one process
    return spkd_loss(student, teacher, "batchmean", use_pallas=None if groups == 1 else False,
                     batch_axis=batch_axis, groups=groups // n)


def loss_keys(strategy: str) -> Tuple[str, ...]:
    """The loss logs ``distill_loss`` returns for ``strategy``."""
    fused = ("enc_loss", "dec_loss", "clstm_real_loss", "clstm_imag_loss")
    terms = {"clskd": fused, "reviewkd": fused,
             "spkd": ("spkd_loss",), "mse": ("mse_loss",), "stft": ("stft_loss",)}
    return ("base_loss",) + terms[strategy] + ("train_loss",)


def needs_fusion(strategy: str) -> bool:
    """Whether the strategy distills through the ReviewKD-fused student taps
    (and so trains the ABF chains)."""
    return strategy in ("clskd", "reviewkd")


def needs_teacher_taps(strategy: str) -> bool:
    """Whether the strategy reads the teacher's feature taps, not only its
    output waveform."""
    return strategy in ("clskd", "reviewkd")
