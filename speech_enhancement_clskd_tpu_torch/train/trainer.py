"""The distillation trainer's optimizer step.

Port of ``speech_enhancement_clskd_tpu/train/trainer.py``, the step of all
five strategies.  Both models come from ``models.dccrn.build_model``, the
module of each config's ``family`` (DCCRN, or the asteroid DCCRNet), as the
JAX ``make_model`` dispatches; the ABF chains take the student's real tap
widths in (``tap_channels``) and the JAX trainer's family-blind widths out
(``_teacher_tap_channels`` of the teacher).  One ``train_step`` runs

1. the frozen teacher forward under ``torch.no_grad()``, BN on batch
   statistics with its running statistics left as they are (the JAX step
   computes and then discards them); a strategy that reads only its output
   waveform (``needs_teacher_taps``) drops its feature taps here, before
   the student runs;
2. the student forward in training mode (BN on batch statistics, running
   statistics updated);
3. for ``clskd`` and ``reviewkd`` (``needs_fusion``), two ReviewKD chains of
   ABF blocks over the student's encoder and decoder taps (with
   ``distill.abf_conv_pallas`` and ``distill.abf_attfuse_pallas`` their 3x3
   convs and attention fuses go through the K3 and K4 kernels; with
   ``distill.abf_block_pallas`` each block but its bn2 goes through the
   whole-block kernel K5, and a block its gate refuses takes the path of the
   other two flags; ``distill.abf_conv_ninedot`` takes the per-op 3x3 conv
   as nine matmuls, ``distill.abf_remat`` recomputes each block in the
   backward, and ``distill.spkd_bn2_fold`` under ``clskd`` folds bn2's affine
   into the SPKD Grams); the other strategies build no ABF chains, as the
   JAX trainer does.  With ``distill.abf_reinit_each_step`` the chains take
   fresh weights every step (the reference's quirk), drawn from a
   ``torch.Generator`` seeded from ``(cfg.seed, step)``, and are neither
   trained nor keep their running statistics;
4. the strategy's loss (``distill.strategies``): for ``clskd`` the SPKD Gram
   losses against the teacher's taps and LSTM taps, for ``reviewkd`` HCL
   against them (SPKD on LSTM taps of other widths), for ``spkd`` the SPKD
   loss between the output waveforms (the fused Gram pair K2 once a clip
   reaches 32.8 s), for ``mse`` and ``stft`` the waveforms' squared error
   or STFT-magnitude distance; plus the log-STFT-magnitude base loss;
5. the backward (on CUDA tensors the LSTM backward kernel, and with the ABF
   flags the conv's dx and weight-gradient kernels and the fuse's backward,
   or the whole block's backward);
6. the optimizer on the student and, with fusion, both ABF chains, as the
   JAX ``_make_optimizer`` builds it: Adam (optax ``adam`` and torch
   ``Adam`` apply the same update, ``m_hat / (sqrt(v_hat) + 1e-8)``), or
   with ``optim.optimizer="adamw"`` or a ``weight_decay`` torch ``AdamW``,
   whose decay is decoupled, ``p -= lr * (adam + wd * p)``, as optax's
   ``adamw`` (not ``Adam``'s L2 term); ``optim.grad_clip`` scales the
   gradients by ``clip / ||g||`` where ``||g|| >= clip`` (optax
   ``clip_by_global_norm``, no epsilon), after the logs have read the raw
   norms; the learning rate of update k (from 0) is ``lr_at(k)``, constant
   or optax's ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
   total_steps(), lr / 100)``, set from ``step`` each step, so a restored
   checkpoint continues the schedule.

The step's float32 work runs in full float32 (``utils.device.float32_math``).
bf16 follows the JAX step's casts: a model with ``compute_dtype="bfloat16"``
computes in bf16 (``models.dccrn``), and ``distill.taps_dtype="bfloat16"``
casts both models' feature taps to bf16 after the forwards, so the ABF
chains run in bf16 (their BN statistics and folded affines in float32; with
``abf_conv_pallas`` and ``abf_attfuse_pallas`` the bf16 instantiations of K3
and K4, with ``abf_block_pallas`` that of K5, whose maps, ``xf`` and conv2
output are bf16) and the KD losses take bf16 taps, their Grams float32
(summed in float32, on K2's bf16 instantiation where the fused pair is
taken).  The losses are float32, and the parameters, gradients and optimizer
state stay float32.

Around the step, the fit loop of the JAX trainer (``fit``, ``validate``,
``eval_step``, ``make_datasets``): epochs over the seeded loader
(``data.loader.make_loader``), logs every ``log_every`` steps, validation
with SI-SDR and STOI computed on the device (PIT-reordered where the model
has ``n_src`` outputs) and read to the host once an epoch, top-k
checkpoints (``utils.serialization.CheckpointManager``) and JSONL metrics
(``utils.observability.MetricWriter``).  The trainer counts its completed
epochs (``epoch``), which a checkpoint keeps: a resumed ``fit`` starts at
that epoch, with that epoch's shuffle.

Data and tensor parallelism (``parallel.mesh``): the JAX trainer's step and
fit loop run sharded over ``cfg.mesh``'s data axis and its large weights over
the model axis under GSPMD; the port runs a process a device, each on its
rows of the same global batch and its slice of the student's and the
teacher's large weights, with the collectives of ``parallel.distributed``
where the one-process step reduces over the batch or needs a whole weight
(``Trainer``'s docstring).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import DCCRNConfig, TrainConfig
from ..data.dns import DNSDataset
from ..data.librimix import LibriMixDataset
from ..data.loader import make_loader
from ..data.synthetic import SyntheticEnhancementDataset
from ..distill.abf import ReviewKD
from ..distill.strategies import (
    STRATEGIES,
    distill_loss,
    loss_keys,
    needs_fusion,
    needs_teacher_taps,
)
from ..losses.pit import pit_reorder
from ..losses.signal import si_sdr
from ..metrics.stoi import stoi_batch
from ..models import dccrnet
from ..models.dccrn import (
    FeatureTaps,
    build_model,
    gather_model,
    model_shards,
    shard_model,
)
from ..parallel import distributed
from ..parallel.mesh import Mesh, model_axis_group, trainer_mesh
from ..utils.bridge import torch_state_from_flax
from ..utils.device import float32_math, resolve_device


def log_keys(strategy: str, abf_reinit_each_step: bool = False) -> Tuple[str, ...]:
    """The keys of ``Trainer.train_step``'s logs for ``strategy``, as the JAX
    step returns them: the strategy's losses, the global gradient norm and
    the student's per-part norms, and ``gn_abf`` where the ABF chains train
    (fusion without ``abf_reinit_each_step``)."""
    trained_abf = needs_fusion(strategy) and not abf_reinit_each_step
    return (loss_keys(strategy) + ("grad_norm", "gn_enc", "gn_lstm", "gn_dec")
            + (("gn_abf",) if trained_abf else ()))


def broadcast_from_rank_0(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Every rank's ``tensors`` set to rank 0's: over the data group (each
    model column takes its first row's), then over the model group (each
    row takes its first column's, which now holds rank 0's)."""
    distributed.broadcast_tensors(tensors, 0, mesh.data_group)
    if mesh.shape["model"] > 1:
        distributed.broadcast_tensors(tensors, 0, mesh.model_group)


def _teacher_tap_channels(cfg: DCCRNConfig) -> Tuple[tuple, tuple]:
    """Channel counts of a DCCRN's encoder and decoder taps, in tap order,
    whatever ``cfg.family`` says: the ABF chains' output widths, as the JAX
    trainer gives them (``train/trainer.py:69-73, 88-100``).  For a DCCRNet
    teacher they are not its taps' widths (``tap_channels``): its decoder
    chain's outputs are ``(kn[n-1], ..., kn[0], 2)`` against taps of
    ``(kn[-1], kn[n-2], ..., kn[0])`` channels, which SPKD's batch Grams
    take and HCL refuses."""
    ch = (2,) + tuple(cfg.kernel_num)
    enc = tuple(cfg.kernel_num)
    dec = tuple(ch[j] for j in range(len(cfg.kernel_num) - 1, -1, -1))
    return enc, dec


def tap_channels(cfg: DCCRNConfig) -> Tuple[tuple, tuple]:
    """Channel counts of the encoder and decoder taps that the model of
    ``cfg.family`` gives, in tap order: the ABF chains' input widths (the
    JAX chains infer them from the student's taps)."""
    if cfg.family == "dccrnet":
        return dccrnet.tap_channels(cfg)
    return _teacher_tap_channels(cfg)


def _check_supported(cfg: TrainConfig) -> None:
    d = cfg.distill
    if d.strategy not in STRATEGIES:
        raise ValueError(f"unknown distill strategy {d.strategy!r}")
    if d.taps_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"distill.taps_dtype={d.taps_dtype!r}: the port casts taps to bfloat16 or "
            "leaves them")


def _taps_dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    """The dtype the step casts both models' taps to, or None (taps left in
    their models' compute dtype), as the JAX step casts for a taps_dtype
    other than float32."""
    return None if cfg.distill.taps_dtype == "float32" else getattr(torch, cfg.distill.taps_dtype)


def _cast_taps(taps: FeatureTaps, dtype: torch.dtype) -> FeatureTaps:
    return FeatureTaps(encoder=[t.to(dtype) for t in taps.encoder],
                       decoder=[t.to(dtype) for t in taps.decoder],
                       lstm_real=taps.lstm_real.to(dtype), lstm_imag=taps.lstm_imag.to(dtype))


def warmup_cosine(step: int, peak: float, warmup_steps: int, decay_steps: int,
                  end: float) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end)`` at ``step``: linear from 0 to ``peak`` over the
    warmup, then a cosine from ``peak`` to ``end`` over the remaining
    ``decay_steps - warmup_steps`` steps, ``end`` after them."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(
            f"the cosine schedule needs total steps ({decay_steps}) above the warmup "
            f"({warmup_steps})")
    if step < warmup_steps:
        return peak * step / warmup_steps
    count = min(step - warmup_steps, decay_steps - warmup_steps)
    alpha = 0.0 if peak == 0.0 else end / peak
    cosine = 0.5 * (1 + math.cos(math.pi * count / (decay_steps - warmup_steps)))
    return peak * ((1 - alpha) * cosine + alpha)


def _global_norm(params: Iterable[nn.Parameter]) -> torch.Tensor:
    """sqrt of the summed squares of every gradient (optax ``global_norm``);
    a parameter without a gradient counts as zeros."""
    squares = [p.grad.float().square().sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(squares).sum())


def sharded_params(*models: Optional[nn.Module]) -> set:
    """The ids of the parameters that hold a model rank's slice
    (``models.dccrn.shard_model``) in ``models``."""
    return {id(p) for m in models if m is not None
            for n, p in m.named_parameters() if n in model_shards(m)}


def global_norms(params: Dict[str, List[nn.Parameter]], sharded: set,
                 model_group=None) -> Dict[str, torch.Tensor]:
    """``_global_norm`` of each list of ``params`` under tensor
    parallelism: the squares of a sliced parameter (its id in ``sharded``)
    summed over the model ranks, those of a whole one counted once, so
    every rank gets the norm of the whole gradient (one all-reduce for
    every list).  ``_global_norm`` itself without a model group."""
    if model_group is None:
        return {k: _global_norm(ps) for k, ps in params.items()}
    sums = []
    for ps in params.values():
        for part in (True, False):
            sq = [p.grad.float().square().sum() for p in ps
                  if p.grad is not None and (id(p) in sharded) == part]
            sums.append(torch.stack(sq).sum() if sq else torch.zeros((), device=ps[0].device))
    sums = torch.stack(sums).view(-1, 2)
    sliced = sums[:, 0].clone()
    torch.distributed.all_reduce(sliced, group=model_group)
    norms = torch.sqrt(sliced + sums[:, 1])
    return dict(zip(params, norms.unbind(0)))


class Trainer:
    """The distillation optimizer step on ``device`` (the card unless the
    caller asks for the CPU; ``device="cuda"`` with no GPU raises).

    ``init_state(seed)`` draws seeded weights and makes the optimizer;
    ``train_step(mix, clean)`` runs one step and returns its logs;
    ``fit()`` trains, validates and checkpoints epoch by epoch.  The
    modules are ``student``, ``teacher``, ``abf_enc`` and ``abf_dec``, the
    last two ``None`` for a strategy without fusion
    (``utils.bridge.load_train_state`` loads a JAX ``TrainState`` into them).
    ``step`` counts optimizer steps and ``epoch`` completed epochs.  Under
    ``abf_reinit_each_step`` the chains hold the last step's drawn weights
    (``draw_abf``), which no optimizer moves.

    Data parallelism: ``mesh`` (``parallel.mesh.make_mesh(cfg.mesh)`` by
    default: the process group's ranks where one is up, else a world of 1)
    gives the data group.  With one, every rank holds the same weights
    (broadcast from rank 0 by ``init_state``), ``train_step`` and
    ``eval_step`` take the global batch and run on the rank's rows
    (``parallel.distributed.local_rows``), every batch norm takes the global
    batch's moments, the SPKD Grams span the global batch
    (``distill.strategies.spkd_term``), the gradients are averaged over the
    ranks (one all-reduce of a flat buffer) and the logs, norms, clip and
    validation metrics are the global ones, as the JAX step's are under
    GSPMD.  Checkpoints are written by rank 0.

    Tensor parallelism: with ``mesh.model > 1`` the model group's ranks
    take the same rows (the data group's), and ``init_state`` cuts the
    student and the teacher over it (``models.dccrn.shard_model``: the
    leaves of at least 2^14 elements whose last JAX axis divides), so each
    rank holds its slice of each such leaf and, Adam being elementwise, of
    its moments.  The layers run column-parallel, gathering the outputs
    (and the LSTM's ``W_hh`` whole, for the K1f/K1b recurrence on every
    rank).  Every collective of data parallelism runs over the data group;
    ``grad_norm``, the ``gn_*`` logs and ``grad_clip`` sum a sliced leaf's
    squares over the model ranks and count a whole leaf once.  The whole
    leaves, the BN statistics and the ABF chains are computed alike on the
    model ranks from the same inputs, and stay bit-identical across them.
    Checkpoints, bundles and ``utils.bridge``'s states hold whole tensors
    at any ``mesh.model``.
    """

    def __init__(self, cfg: TrainConfig = TrainConfig(),
                 device: Union[str, torch.device] = "cuda", mesh: Optional[Mesh] = None):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(cfg.mesh, mesh, self.device.type)
        self.group = self.mesh.data_group
        self.model_group = model_axis_group(self.mesh)
        if self.group is not None or self.model_group is not None:
            self.device = distributed.local_device(self.device)
        self.strategy = cfg.distill.strategy
        self.use_fusion = needs_fusion(self.strategy)
        self.reinit_abf = self.use_fusion and cfg.distill.abf_reinit_each_step
        self.student = build_model(cfg.student)
        self.teacher = build_model(cfg.teacher)
        self.abf_enc: Optional[ReviewKD] = None
        self.abf_dec: Optional[ReviewKD] = None
        if self.use_fusion:
            t_enc, t_dec = _teacher_tap_channels(cfg.teacher)
            s_enc, s_dec = tap_channels(cfg.student)
            d = cfg.distill
            kernels = dict(conv_pallas=d.abf_conv_pallas, attfuse_pallas=d.abf_attfuse_pallas,
                           block_pallas=d.abf_block_pallas, conv_ninedot=d.abf_conv_ninedot,
                           bn2_affine_out=d.spkd_bn2_fold and self.strategy == "clskd",
                           remat=d.abf_remat)
            self.abf_enc = ReviewKD(s_enc, t_enc, d.abf_mid_channels, reverse=True, **kernels)
            self.abf_dec = ReviewKD(s_dec, t_dec, d.abf_mid_channels, reverse=False, **kernels)
        for m in (self.student, self.teacher, self.abf_enc, self.abf_dec):
            if m is not None:
                distributed.sync_batch_stats(m, self.group)
        self.taps_dtype = _taps_dtype(cfg)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.epoch = 0
        self._total_steps: Optional[int] = None

    def trainable(self) -> Dict[str, nn.Module]:
        """The modules the optimizer trains: the student, and the ABF chains
        with fusion unless they are drawn afresh each step."""
        parts = {"student": self.student}
        if self.use_fusion and not self.reinit_abf:
            parts.update(abf_enc=self.abf_enc, abf_dec=self.abf_dec)
        return parts

    def total_steps(self) -> int:
        """Optimizer steps of the whole run, the cosine schedule's length:
        ``max(1, len(train) // batch_size) * max_epochs`` (the loader drops
        the last partial batch), the synthetic set's size for a synthetic
        set, 20000 clips when the training set cannot be read."""
        if self._total_steps is None:
            d = self.cfg.data
            if d.synthetic:
                n = d.synthetic_size
            else:
                try:
                    n = len(self.make_datasets()[0])
                except Exception:
                    n = 20000  # no manifest (e.g. a schedule preview)
            self._total_steps = max(1, n // d.batch_size) * self.cfg.max_epochs
        return self._total_steps

    def lr_at(self, step: int) -> float:
        """The learning rate of update ``step`` (counted from 0)."""
        o = self.cfg.optim
        if o.lr_schedule != "cosine":
            return o.lr
        return warmup_cosine(step, o.lr, o.warmup_steps, max(1, self.total_steps()),
                             o.lr * 0.01)

    def _make_optimizer(self, params: List[nn.Parameter]) -> torch.optim.Optimizer:
        o = self.cfg.optim
        if o.optimizer == "adamw" or o.weight_decay:
            return torch.optim.AdamW(params, lr=o.lr, weight_decay=o.weight_decay)
        return torch.optim.Adam(params, lr=o.lr)

    @torch.no_grad()
    def draw_abf(self, step: int) -> None:
        """Fresh ABF weights and running statistics, drawn on the CPU from a
        ``torch.Generator`` seeded from ``(cfg.seed, step)`` with the
        initializers of ``init_state``."""
        seed = int(np.random.SeedSequence([self.cfg.seed, step]).generate_state(1)[0])
        g = torch.Generator().manual_seed(seed)
        for m in (self.abf_enc, self.abf_dec):
            m.cpu().reset_parameters(g)
            m.to(self.device)

    def init_state(self, seed: Optional[int] = None,
                   teacher_variables: Optional[Dict[str, Any]] = None) -> "Trainer":
        """Seeded weights for the student, the teacher and the ABF chains
        (drawn on the CPU from one ``torch.Generator``, then moved to the
        device), and a fresh optimizer over the trainable modules.
        ``teacher_variables``: a pretrained teacher's flax ``{params,
        batch_stats}`` tree (e.g. from ``utils.serialization.load_bundle``),
        loaded over the seeded teacher.  Under data or tensor parallelism
        every rank then takes rank 0's weights and statistics, and with a
        model group the student and the teacher are cut over it."""
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        modules = [m for m in (self.student, self.teacher, self.abf_enc, self.abf_dec)
                   if m is not None]
        for m in (self.student, self.teacher):
            gather_model(m)  # a second init_state draws whole weights again
        for m in modules:
            m.cpu().reset_parameters(g)
            m.to(self.device)
        if teacher_variables is not None:
            self.teacher.load_state_dict(torch_state_from_flax(teacher_variables), strict=True)
        broadcast_from_rank_0([t for m in modules for t in m.state_dict().values()], self.mesh)
        if self.model_group is not None:
            shard_model(self.student, self.model_group)
            shard_model(self.teacher, self.model_group)
        self.teacher.requires_grad_(False).eval()
        if self.reinit_abf:
            for m in (self.abf_enc, self.abf_dec):
                m.requires_grad_(False).train()
        for m in self.trainable().values():
            m.requires_grad_(True).train()
        params = [p for m in self.trainable().values() for p in m.parameters()]
        self.optimizer = self._make_optimizer(params)
        if self.cfg.optim.lr_schedule == "cosine":
            self.lr_at(0)  # a schedule the run cannot take raises here, as in JAX
        self.step = 0
        self.epoch = 0
        return self

    def train_step(self, mix, clean) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``mix``/``clean`` ([B, T] float32, numpy or
        tensors; the global batch, of which a data-parallel rank takes its
        rows).  Returns the logs as 0-d tensors on the device, with the keys
        of the JAX step (``log_keys(strategy)``), global under data
        parallelism."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        mix = distributed.local_rows(mix, 0, self.group, self.device)
        clean = distributed.local_rows(clean, 0, self.group, self.device)
        with float32_math():
            with torch.no_grad():
                t_out = self.teacher(mix, bn_batch_stats=True)
            if not needs_teacher_taps(self.strategy):
                t_out = t_out._replace(taps=None)  # free them before the student runs
            s_out = self.student(mix, training=True)
            if self.taps_dtype is not None:
                # the big cross-layer activations (and so their gradients) in bf16
                s_out = s_out._replace(taps=_cast_taps(s_out.taps, self.taps_dtype))
                if t_out.taps is not None:
                    t_out = t_out._replace(taps=_cast_taps(t_out.taps, self.taps_dtype))
            fused_enc = fused_dec = None
            if self.reinit_abf:
                self.draw_abf(self.step)
            if self.use_fusion:
                fused_enc = self.abf_enc(list(s_out.taps.encoder), training=True)
                fused_dec = self.abf_dec(list(s_out.taps.decoder), training=True)
            loss, logs = distill_loss(self.strategy, s_out, t_out, clean, self.cfg.distill,
                                      fused_enc, fused_dec, group=self.group)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            distributed.average_gradients(
                [p for m in self.trainable().values() for p in m.parameters()], self.group)
            logs = dict(zip(logs, distributed.mean_over_ranks(list(logs.values()), self.group)))
            logs.update(self._grad_norms())
            if self.cfg.optim.grad_clip:
                self._clip(logs["grad_norm"], self.cfg.optim.grad_clip)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_at(self.step)
            self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in logs.items()}

    def _grad_norms(self) -> Dict[str, torch.Tensor]:
        student = list(self.student.named_parameters())
        abf = [p for name, m in self.trainable().items() if name != "student"
               for p in m.parameters()]
        params = {
            "grad_norm": [p for _, p in student] + abf,
            "gn_enc": [p for n, p in student if n.startswith("enc")],
            "gn_lstm": [p for n, p in student if n.startswith(("clstm", "rnn", "lstm"))],
            "gn_dec": [p for n, p in student if n.startswith("dec")],
        }
        if abf:
            params["gn_abf"] = abf
        return global_norms(params, sharded_params(self.student), self.model_group)

    def _clip(self, norm: torch.Tensor, max_norm: float) -> None:
        """optax ``clip_by_global_norm``: every gradient times ``max_norm /
        norm`` unless ``norm < max_norm``, with no host sync."""
        keep = norm < max_norm
        for m in self.trainable().values():
            for p in m.parameters():
                if p.grad is not None:
                    p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * max_norm))

    # ------------------------------------------------------------- evaluation

    @torch.no_grad()
    def eval_step(self, mix, sources) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The student's forward with BN on running statistics on ``mix``
        [B, T] and its metrics against ``sources`` [B, n_src, T] (numpy or
        tensors): ``si_sdr``, ``input_si_sdr``, ``stoi``, ``input_stoi``,
        ``si_sdr_imp`` and ``stoi_imp``, 0-d tensors on the device, and the
        estimate.  Estimates are PIT-reordered against the sources when the
        model has ``n_src`` outputs, as the reference's validation_step does
        (distill.py:164-174); a single-output model on a multi-source task is
        scored against the first source (the offline eval's fallback).

        Under data parallelism the batch is the global one: the rank runs
        the student on its rows, the estimates are gathered, SI-SDR (a
        ratio of batch means) is taken over the global batch on every rank
        and STOI on the rank's rows, averaged over the ranks."""
        mix = torch.as_tensor(mix, dtype=torch.float32).to(self.device)
        local_mix = distributed.local_rows(mix, 0, self.group)
        sources = torch.as_tensor(sources, dtype=torch.float32).to(self.device)
        lo, hi = distributed.host_local_batch_slice(mix.shape[0], self.group)
        sr = self.cfg.data.sample_rate
        with float32_math():
            est = distributed.all_gather(self.student(local_mix, training=False).wav, 0,
                                         self.group)
            est_s = est if est.ndim == 3 else est[:, None, :]  # [B, n_est, T]
            n_src = sources.shape[1]
            if n_src > 1 and est_s.shape[1] == n_src:
                est_s, _ = pit_reorder(est_s, sources)
            elif n_src > 1:
                sources = sources[:, :1]
                n_src = 1
            T = sources.shape[-1]
            est_f = est_s[:, :n_src].reshape(-1, T)
            src_f = sources.reshape(-1, T)
            mix_f = torch.repeat_interleave(mix, n_src, dim=0) if n_src > 1 else mix
            rows = slice(lo * n_src, hi * n_src)  # this rank's rows, for STOI
            m = {
                "si_sdr": si_sdr(src_f, est_f),
                "input_si_sdr": si_sdr(src_f, mix_f),
                "stoi": torch.mean(stoi_batch(src_f[rows], est_f[rows], fs=sr)),
                "input_stoi": torch.mean(stoi_batch(src_f[rows], mix_f[rows], fs=sr)),
            }
            m["stoi"], m["input_stoi"] = distributed.mean_over_ranks(
                [m["stoi"], m["input_stoi"]], self.group)
        m["si_sdr_imp"] = m["si_sdr"] - m["input_si_sdr"]
        m["stoi_imp"] = m["stoi"] - m["input_stoi"]
        return m, est

    # -------------------------------------------------------------- fit loop

    def make_datasets(self):
        """(train, validation) datasets of ``cfg.data``: the synthetic set
        (validation ``max(8, size // 16)`` clips, seed ``seed + 10_000``), a
        DNS directory, or LibriMix manifests."""
        d = self.cfg.data
        if d.synthetic:
            train = SyntheticEnhancementDataset(
                size=d.synthetic_size, segment=d.segment or 3.0,
                sample_rate=d.sample_rate, seed=self.cfg.seed,
                profile=d.synthetic_profile)
            val = SyntheticEnhancementDataset(
                size=max(8, d.synthetic_size // 16), segment=d.segment or 3.0,
                sample_rate=d.sample_rate, seed=self.cfg.seed + 10_000,
                profile=d.synthetic_profile)
        elif d.dataset == "dns":
            train = DNSDataset(d.train_dir, d.sample_rate, d.segment, seed=self.cfg.seed)
            val = DNSDataset(d.valid_dir, d.sample_rate, d.segment, seed=self.cfg.seed)
        else:
            train = LibriMixDataset(d.train_dir, d.task, d.sample_rate, d.n_src, d.segment)
            val = LibriMixDataset(d.valid_dir, d.task, d.sample_rate, d.n_src, d.segment)
        return train, val

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        epochs: Optional[int] = None,
        log_fn: Callable[[str], Any] = print,
        checkpoint_manager=None,
        metric_writer=None,
    ) -> Dict[str, float]:
        """Train from epoch ``self.epoch`` up to ``epochs`` (default
        ``cfg.max_epochs``), validating after each epoch, and return the last
        epoch's metrics (``validate``'s, ``epoch_time_s`` and
        ``audio_s_per_s``).  A trainer whose ``init_state`` has not run is
        initialized first (``init_state`` takes a pretrained teacher).

        Epoch ``e`` shuffles with ``(cfg.seed, e)``, so a trainer restored
        from a checkpoint continues the run it was cut from.  With
        ``scan_steps`` K > 1, batches are gathered K at a time and run as K
        steps, logging the window's last step, as the JAX fit's scan does; a
        window that an epoch leaves incomplete carries into the next epoch,
        and the one left at the end of ``fit`` is dropped (a checkpoint does
        not hold it).  ``checkpoint_manager.save(self, metrics)`` runs after
        each validation and ``metric_writer`` takes the train logs (scope
        ``train``) and each epoch's metrics (scope ``val``).  Under data or
        tensor parallelism every rank iterates the same seeded batches and
        calls ``save`` (the same top-k decision on every rank; a sharded
        state is gathered by all); rank 0 alone logs, writes metrics and
        the checkpoint, and every rank waits at a barrier after each save.
        """
        cfg = self.cfg
        if self.optimizer is None:
            self.init_state()
        train_ds, val_ds = self.make_datasets()
        loader = make_loader(train_ds, cfg.data.batch_size, shuffle=True, seed=cfg.seed)
        total_epochs = epochs or cfg.max_epochs
        loader.epoch = start_epoch = min(self.epoch, total_epochs)
        K = max(1, cfg.scan_steps)
        history: Dict[str, float] = {}
        pending: List[Tuple[np.ndarray, np.ndarray]] = []
        for epoch in range(start_epoch, total_epochs):
            self._sync()
            t0 = time.time()
            n = 0
            for mix, src in loader:
                pending.append((np.asarray(mix), np.asarray(src[:, 0])))
                if len(pending) < K:
                    continue
                n_before = n
                for mix_b, clean_b in pending:
                    logs = self.train_step(mix_b, clean_b)
                    n += 1
                pending = []
                if n_before // cfg.log_every != n // cfg.log_every and self.mesh.is_main:
                    vals = {k: float(v) for k, v in logs.items()}
                    log_fn(f"epoch {epoch} step {n}: "
                           + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
                    if metric_writer is not None:
                        metric_writer.write(self.step, vals, scope="train")
            self._sync()  # the steps' work, not their launches
            dt = time.time() - t0
            self.epoch = epoch + 1
            metrics = self.validate(val_ds)
            metrics["epoch_time_s"] = dt
            seg = cfg.data.segment or 3.0
            metrics["audio_s_per_s"] = n * cfg.data.batch_size * seg / dt
            if self.mesh.is_main:
                log_fn(f"epoch {epoch} done: "
                       + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if metric_writer is not None:
                    metric_writer.write(self.step, metrics, scope="val")
            if checkpoint_manager is not None:
                # top-k retention on the monitored metric (reference
                # ModelCheckpoint(monitor='stoi'), distill.py:252-258); every
                # rank takes the decision and gathers a sharded state, rank 0
                # writes
                checkpoint_manager.save(self, metrics)
                distributed.barrier(self.mesh.world_group)
            history = metrics
        return history

    def validate(self, val_ds) -> Dict[str, float]:
        """Mean of ``eval_step``'s metrics over ``val_ds`` in order, in
        batches of ``min(batch_size, len(val_ds))``.  As in the JAX trainer,
        the loader drops the last partial batch, so a set that is not a
        multiple of the batch leaves its tail unscored.  The per-batch
        metrics stay on the device and are read to the host once, at the
        end."""
        loader = make_loader(val_ds, min(self.cfg.data.batch_size, len(val_ds)), shuffle=False)
        agg: Dict[str, List[torch.Tensor]] = {}
        for mix, src in loader:
            m, _ = self.eval_step(mix, src)
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        keys = list(agg)
        host = torch.stack([torch.stack(agg[k]) for k in keys]).cpu().numpy()  # one read
        return {k: float(np.mean(host[i])) for i, k in enumerate(keys)}
