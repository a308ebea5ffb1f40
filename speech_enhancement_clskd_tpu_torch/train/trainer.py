"""The distillation trainer's optimizer step.

Port of ``speech_enhancement_clskd_tpu/train/trainer.py``, the default
``clskd`` step (``TrainConfig()``).  One ``train_step`` runs

1. the student forward in training mode (BN on batch statistics, running
   statistics updated);
2. the frozen teacher forward under ``torch.no_grad()``, BN on batch
   statistics with its running statistics left as they are (the JAX step
   computes and then discards them);
3. two ReviewKD chains of ABF blocks over the student's encoder and decoder
   taps (with ``distill.abf_conv_pallas`` and ``distill.abf_attfuse_pallas``
   their 3x3 convs and attention fuses go through the K3 and K4 kernels;
   with ``distill.abf_block_pallas`` each block but its bn2 goes through the
   whole-block kernel K5, and a block its gate refuses takes the path of
   the other two flags);
4. the SPKD Gram losses against the teacher's taps and LSTM taps, plus the
   log-STFT-magnitude base loss;
5. the backward (on CUDA tensors the LSTM backward kernel, and with those
   flags the conv's dx and weight-gradient kernels and the fuse's backward,
   or the whole block's backward);
6. Adam on the student and both ABF chains (optax ``adam`` and torch
   ``Adam`` apply the same update, ``m_hat / (sqrt(v_hat) + 1e-8)``).

The whole step runs in full float32 (``utils.device.float32_math``).  The
fit loop, validation and checkpoints are ROADMAP queue 1 item 3; every option
this step does not port raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..config import DCCRNConfig, TrainConfig
from ..distill.abf import ReviewKD
from ..distill.strategies import STRATEGIES, distill_loss
from ..models.dccrn import DCCRN
from ..utils.device import float32_math, resolve_device

LOG_KEYS = ("base_loss", "enc_loss", "dec_loss", "clstm_real_loss", "clstm_imag_loss",
            "train_loss", "grad_norm", "gn_enc", "gn_lstm", "gn_dec", "gn_abf")


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
        (d.strategy != "clskd", f"distill.strategy={d.strategy!r}: {item4}"),
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
    """The CLSKD optimizer step on ``device`` (the card unless the caller
    asks for the CPU; ``device="cuda"`` with no GPU raises).

    ``init_state(seed)`` draws seeded weights and makes the optimizer;
    ``train_step(mix, clean)`` runs one step and returns its logs.  The
    modules are ``student``, ``teacher``, ``abf_enc`` and ``abf_dec``
    (``utils.bridge.load_train_state`` loads a JAX ``TrainState`` into them).
    """

    def __init__(self, cfg: TrainConfig = TrainConfig(),
                 device: Union[str, torch.device] = "cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = cfg.distill.strategy
        self.student = DCCRN(cfg.student)
        self.teacher = DCCRN(cfg.teacher)
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
        return {"student": self.student, "abf_enc": self.abf_enc, "abf_dec": self.abf_dec}

    def init_state(self, seed: Optional[int] = None) -> "Trainer":
        """Seeded weights for the student, the teacher and both ABF chains
        (drawn on the CPU from one ``torch.Generator``, then moved to the
        device), and a fresh Adam over the student and the ABF chains."""
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        for m in (self.student, self.teacher, self.abf_enc, self.abf_dec):
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
        keys of the JAX step (``LOG_KEYS``)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        mix = torch.as_tensor(mix, dtype=torch.float32).to(self.device)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(self.device)
        with float32_math():
            s_out = self.student(mix, training=True)
            with torch.no_grad():
                t_out = self.teacher(mix, bn_batch_stats=True)
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
        abf = list(self.abf_enc.parameters()) + list(self.abf_dec.parameters())
        return {
            "grad_norm": _global_norm([p for _, p in student] + abf),
            "gn_enc": _global_norm(p for n, p in student if n.startswith("enc")),
            "gn_lstm": _global_norm(p for n, p in student
                                    if n.startswith(("clstm", "rnn", "lstm"))),
            "gn_dec": _global_norm(p for n, p in student if n.startswith("dec")),
            "gn_abf": _global_norm(abf),
        }
