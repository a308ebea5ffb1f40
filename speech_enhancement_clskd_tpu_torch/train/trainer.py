"""The distillation trainer's optimizer step.

Port of ``speech_enhancement_clskd_tpu/train/trainer.py``, the step of the
``clskd``, ``spkd``, ``mse`` and ``stft`` strategies.  One ``train_step`` runs

1. the frozen teacher forward under ``torch.no_grad()``, BN on batch
   statistics with its running statistics left as they are (the JAX step
   computes and then discards them); a strategy that reads only its output
   waveform (``needs_teacher_taps``) drops its feature taps here, before
   the student runs;
2. the student forward in training mode (BN on batch statistics, running
   statistics updated);
3. for ``clskd`` (``needs_fusion``), two ReviewKD chains of ABF blocks over
   the student's encoder and decoder taps (with ``distill.abf_conv_pallas``
   and ``distill.abf_attfuse_pallas`` their 3x3 convs and attention fuses
   go through the K3 and K4 kernels; with ``distill.abf_block_pallas`` each
   block but its bn2 goes through the whole-block kernel K5, and a block its
   gate refuses takes the path of the other two flags); the other
   strategies build no ABF chains, as the JAX trainer does;
4. the strategy's loss (``distill.strategies``): for ``clskd`` the SPKD Gram
   losses against the teacher's taps and LSTM taps, for ``spkd`` the SPKD
   loss between the output waveforms (the fused Gram pair K2 once a clip
   reaches 32.8 s), for ``mse`` and ``stft`` the waveforms' squared error
   or STFT-magnitude distance; plus the log-STFT-magnitude base loss;
5. the backward (on CUDA tensors the LSTM backward kernel, and with the ABF
   flags the conv's dx and weight-gradient kernels and the fuse's backward,
   or the whole block's backward);
6. Adam on the student and, with fusion, both ABF chains (optax ``adam`` and
   torch ``Adam`` apply the same update, ``m_hat / (sqrt(v_hat) + 1e-8)``).

The whole step runs in full float32 (``utils.device.float32_math``).  The
fit loop, validation and checkpoints are ROADMAP queue 1 item 3; every option
this step does not port, the ``reviewkd`` strategy among them, raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..config import DCCRNConfig, TrainConfig
from ..distill.abf import ReviewKD
from ..distill.strategies import (
    STRATEGIES,
    distill_loss,
    loss_keys,
    needs_fusion,
    needs_teacher_taps,
)
from ..models.dccrn import DCCRN
from ..utils.device import float32_math, resolve_device


def log_keys(strategy: str) -> Tuple[str, ...]:
    """The keys of ``Trainer.train_step``'s logs for ``strategy``, as the JAX
    step returns them: the strategy's losses, the global gradient norm and
    the student's per-part norms, and ``gn_abf`` with fusion."""
    return (loss_keys(strategy) + ("grad_norm", "gn_enc", "gn_lstm", "gn_dec")
            + (("gn_abf",) if needs_fusion(strategy) else ()))


def _teacher_tap_channels(cfg: DCCRNConfig) -> Tuple[tuple, tuple]:
    """Channel counts of a model's encoder and decoder taps, in tap order."""
    ch = (2,) + tuple(cfg.kernel_num)
    enc = tuple(cfg.kernel_num)
    dec = tuple(ch[j] for j in range(len(cfg.kernel_num) - 1, -1, -1))
    return enc, dec


def _check_supported(cfg: TrainConfig) -> None:
    d, o = cfg.distill, cfg.optim
    if d.strategy not in STRATEGIES:
        raise ValueError(f"unknown distill strategy {d.strategy!r}")
    item4 = "ROADMAP queue 1 item 4 (the rest of training)"
    unported = [
        (d.strategy == "reviewkd", f"distill.strategy={d.strategy!r}: {item4}"),
        (d.abf_reinit_each_step, f"distill.abf_reinit_each_step: {item4}"),
        (d.taps_dtype != "float32", f"distill.taps_dtype={d.taps_dtype!r}: {item4}"),
        (d.abf_remat, f"distill.abf_remat: {item4}"),
        (d.abf_conv_ninedot, f"distill.abf_conv_ninedot: {item4}"),
        (d.spkd_bn2_fold, f"distill.spkd_bn2_fold: {item4}"),
        (o.optimizer != "adam" or bool(o.weight_decay),
         f"optim.optimizer={o.optimizer!r}, weight_decay={o.weight_decay}: {item4}"),
        (o.grad_clip is not None, f"optim.grad_clip: {item4}"),
        (o.lr_schedule != "constant", f"optim.lr_schedule={o.lr_schedule!r}: {item4}"),
        (cfg.scan_steps > 1, "scan_steps > 1: ROADMAP queue 1 item 3 (the fit loop)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")


def _global_norm(params: Iterable[nn.Parameter]) -> torch.Tensor:
    """sqrt of the summed squares of every gradient (optax ``global_norm``);
    a parameter without a gradient counts as zeros."""
    squares = [p.grad.float().square().sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(squares).sum())


class Trainer:
    """The distillation optimizer step on ``device`` (the card unless the
    caller asks for the CPU; ``device="cuda"`` with no GPU raises).

    ``init_state(seed)`` draws seeded weights and makes the optimizer;
    ``train_step(mix, clean)`` runs one step and returns its logs.  The
    modules are ``student``, ``teacher``, ``abf_enc`` and ``abf_dec``, the
    last two ``None`` for a strategy without fusion
    (``utils.bridge.load_train_state`` loads a JAX ``TrainState`` into them).
    """

    def __init__(self, cfg: TrainConfig = TrainConfig(),
                 device: Union[str, torch.device] = "cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = cfg.distill.strategy
        self.use_fusion = needs_fusion(self.strategy)
        self.student = DCCRN(cfg.student)
        self.teacher = DCCRN(cfg.teacher)
        self.abf_enc: Optional[ReviewKD] = None
        self.abf_dec: Optional[ReviewKD] = None
        if self.use_fusion:
            t_enc, t_dec = _teacher_tap_channels(cfg.teacher)
            s_enc, s_dec = _teacher_tap_channels(cfg.student)
            d = cfg.distill
            kernels = dict(conv_pallas=d.abf_conv_pallas, attfuse_pallas=d.abf_attfuse_pallas,
                           block_pallas=d.abf_block_pallas)
            self.abf_enc = ReviewKD(s_enc, t_enc, d.abf_mid_channels, reverse=True, **kernels)
            self.abf_dec = ReviewKD(s_dec, t_dec, d.abf_mid_channels, reverse=False, **kernels)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def trainable(self) -> Dict[str, nn.Module]:
        """The modules Adam trains: the student, and the ABF chains with fusion."""
        parts = {"student": self.student}
        if self.use_fusion:
            parts.update(abf_enc=self.abf_enc, abf_dec=self.abf_dec)
        return parts

    def init_state(self, seed: Optional[int] = None) -> "Trainer":
        """Seeded weights for the student, the teacher and the ABF chains
        (drawn on the CPU from one ``torch.Generator``, then moved to the
        device), and a fresh Adam over the trainable modules."""
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        for m in (self.student, self.teacher, self.abf_enc, self.abf_dec):
            if m is not None:
                m.cpu().reset_parameters(g)
                m.to(self.device)
        self.teacher.requires_grad_(False).eval()
        for m in self.trainable().values():
            m.requires_grad_(True).train()
        params = [p for m in self.trainable().values() for p in m.parameters()]
        self.optimizer = torch.optim.Adam(params, lr=self.cfg.optim.lr)
        self.step = 0
        return self

    def train_step(self, mix, clean) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``mix``/``clean`` ([B, T] float32, numpy or
        tensors).  Returns the logs as 0-d tensors on the device, with the
        keys of the JAX step (``log_keys(strategy)``)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        mix = torch.as_tensor(mix, dtype=torch.float32).to(self.device)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(self.device)
        with float32_math():
            with torch.no_grad():
                t_out = self.teacher(mix, bn_batch_stats=True)
            if not needs_teacher_taps(self.strategy):
                t_out = t_out._replace(taps=None)  # free them before the student runs
            s_out = self.student(mix, training=True)
            fused_enc = fused_dec = None
            if self.use_fusion:
                fused_enc = self.abf_enc(list(s_out.taps.encoder), training=True)
                fused_dec = self.abf_dec(list(s_out.taps.decoder), training=True)
            loss, logs = distill_loss(self.strategy, s_out, t_out, clean, self.cfg.distill,
                                      fused_enc, fused_dec)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            logs.update(self._grad_norms())
            self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in logs.items()}

    def _grad_norms(self) -> Dict[str, torch.Tensor]:
        student = list(self.student.named_parameters())
        abf = [p for name, m in self.trainable().items() if name != "student"
               for p in m.parameters()]
        norms = {
            "grad_norm": _global_norm([p for _, p in student] + abf),
            "gn_enc": _global_norm(p for n, p in student if n.startswith("enc")),
            "gn_lstm": _global_norm(p for n, p in student
                                    if n.startswith(("clstm", "rnn", "lstm"))),
            "gn_dec": _global_norm(p for n, p in student if n.startswith("dec")),
        }
        if self.use_fusion:
            norms["gn_abf"] = _global_norm(abf)
        return norms
