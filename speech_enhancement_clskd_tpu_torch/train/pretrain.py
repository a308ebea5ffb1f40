"""Standalone supervised training of one DCCRN: how a teacher is made when
no pretrained weights exist.

Port of ``speech_enhancement_clskd_tpu/train/pretrain.py`` (the reference's
teacher-training workflow, ``DCCRN.py`` with the ``config.py`` loss zoo).
``PretrainTrainer`` trains the model of ``model_cfg`` (the config's teacher
by default), built by ``models.dccrn.build_model`` so a ``family="dccrnet"``
config pretrains the asteroid DCCRNet, on ``model(mix)`` against the clean
source with ``losses.modes.dccrn_loss`` in ``cfg.loss_mode`` (``SDR+PMSQE``
by default), the mel terms of the ``*+LMS`` modes on the bases of the
model's STFT config (``ops.stft.make_kernels``); the optimizer is plain
Adam at ``optim.lr`` (optax ``adam``; no decay, clip or schedule, as the
JAX trainer builds it).

One ``train_step`` is the model's forward in training mode (BN on batch
statistics, running statistics updated), the float32 loss, the backward (on
CUDA tensors the LSTM layers' forward and backward kernels, K1f and K1b) and
Adam, all under ``utils.device.float32_math``.  A model with
``compute_dtype="bfloat16"`` computes in bf16 as in the distillation step
(``models.dccrn``); the loss, the parameters and Adam stay float32.

Around it the JAX trainer's loop: ``make_datasets`` (the synthetic set with
its ``synthetic_profile``, or LibriMix), ``fit`` (epochs over the seeded
loader, each shuffled by ``(cfg.seed, epoch)``, logs every ``log_every``
steps, ``validate`` after each epoch, top-k checkpoints through
``utils.serialization.CheckpointManager``) and ``validate`` (SI-SDR and STOI
of the model on running statistics, no PIT, on the device, read once).

Data parallelism as in ``train.trainer.Trainer``: with a data group
(``mesh``) each rank trains on its rows of the global batch, BN (real or
complex) on the global batch's moments, the gradients averaged over the
ranks; a loss mode whose terms are all means over the rows
(``losses.modes.mean_over_rows``) is taken on the rank's rows, the others
(``SI-SDR``, a ratio of batch means) on the gathered global batch.  Tensor
parallelism as there too: with ``mesh.model > 1`` the model is cut over the
model group (``models.dccrn.shard_model``) after rank 0's weights are
broadcast, so the K1b backward runs on the gathered ``W_hh`` and each rank
keeps its slice of that gradient and of Adam's moments; ``grad_norm`` is the
whole gradient's, and the whole leaves and the BN statistics stay
bit-identical across the model ranks.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import DCCRNConfig, TrainConfig
from ..data.librimix import LibriMixDataset
from ..data.loader import make_loader
from ..data.synthetic import SyntheticEnhancementDataset
from ..losses.modes import LOSS_MODES, dccrn_loss, mean_over_rows
from ..losses.signal import si_sdr
from ..metrics.stoi import stoi_batch
from ..models.dccrn import build_model, gather_model, shard_model
from ..ops import stft as stft_ops
from ..parallel import distributed
from ..parallel.mesh import Mesh, model_axis_group, trainer_mesh
from ..utils.device import float32_math, resolve_device
from .trainer import broadcast_from_rank_0, global_norms, sharded_params


class PretrainTrainer:
    """Supervised enhancement training of one DCCRN on ``device`` (the card
    unless the caller asks for the CPU; ``device="cuda"`` with no GPU
    raises).

    ``init_state(seed)`` draws seeded weights and makes Adam;
    ``train_step(mix, clean)`` runs one step and returns its logs; ``fit()``
    trains, validates and checkpoints epoch by epoch.  The one module is
    ``model`` (``STATE_PARTS``; ``utils.bridge.load_pretrain_state`` loads a
    JAX pretraining state into it); ``step`` counts optimizer steps and
    ``epoch`` completed epochs.  ``mesh``: as ``Trainer`` takes it (data
    parallel over its data group, the model cut over its model group).
    """

    STATE_PARTS = ("model",)

    def __init__(self, cfg: TrainConfig = TrainConfig(),
                 model_cfg: Optional[DCCRNConfig] = None,
                 device: Union[str, torch.device] = "cuda", mesh: Optional[Mesh] = None):
        if cfg.loss_mode not in LOSS_MODES:
            raise ValueError(f"unknown loss_mode {cfg.loss_mode!r}")
        self.cfg = cfg
        self.model_cfg = model_cfg or cfg.teacher
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(cfg.mesh, mesh, self.device.type)
        self.group = self.mesh.data_group
        self.model_group = model_axis_group(self.mesh)
        if self.group is not None or self.model_group is not None:
            self.device = distributed.local_device(self.device)
        self.model = build_model(self.model_cfg)
        distributed.sync_batch_stats(self.model, self.group)
        self.loss_mode = cfg.loss_mode
        # the mel terms' analysis bases, for the modes that read them (the
        # JAX trainer builds them for every mode, so a config whose window
        # they cannot take, the DCCRNet presets' sqrthann, raises there)
        self.stft_kernels = None
        if self.loss_mode.endswith("+LMS"):
            s = self.model_cfg.stft
            self.stft_kernels = stft_ops.make_kernels(s.win_len, s.hop, s.fft_len,
                                                      s.window).to(self.device)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.epoch = 0

    def init_state(self, seed: Optional[int] = None) -> "PretrainTrainer":
        """Seeded weights (drawn on the CPU from one ``torch.Generator``,
        then moved to the device; under data or tensor parallelism rank
        0's, then cut over the model group), the model in training mode,
        and a fresh Adam."""
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        gather_model(self.model)  # a second init_state draws whole weights again
        self.model.cpu().reset_parameters(g)
        self.model.to(self.device)
        broadcast_from_rank_0(list(self.model.state_dict().values()), self.mesh)
        if self.model_group is not None:
            shard_model(self.model, self.model_group)
        self.model.requires_grad_(True).train()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.cfg.optim.lr)
        self.step = 0
        self.epoch = 0
        return self

    def trainable(self) -> Dict[str, torch.nn.Module]:
        """The modules Adam trains: the one model (``Trainer.trainable``'s
        form)."""
        return {"model": self.model}

    def loss(self, mix: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """The training forward and ``dccrn_loss`` of ``cfg.loss_mode`` (of
        this rank's rows ``mix``/``clean``: under data parallelism the
        rank's share of the global loss times the group's size, as
        ``average_gradients`` wants it)."""
        out = self.model(mix, training=True)
        wav, est_real, est_imag = out.wav, out.est_real, out.est_imag
        if not mean_over_rows(self.loss_mode):
            wav, clean, est_real, est_imag = (
                None if t is None else distributed.all_gather(t, 0, self.group)
                for t in (wav, clean, est_real, est_imag))
        return dccrn_loss(wav, clean, est_real, est_imag,
                          loss_mode=self.loss_mode, stft_kernels=self.stft_kernels,
                          sample_rate=self.cfg.data.sample_rate)

    def train_step(self, mix, clean) -> Dict[str, torch.Tensor]:
        """One Adam step on ``mix``/``clean`` ([B, T] float32, numpy or
        tensors; the global batch, of which a data-parallel rank takes its
        rows).  Returns ``train_loss`` and ``grad_norm`` (the global norm
        of the gradients) as 0-d tensors on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        mix = distributed.local_rows(mix, 0, self.group, self.device)
        clean = distributed.local_rows(clean, 0, self.group, self.device)
        with float32_math():
            loss = self.loss(mix, clean)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            distributed.average_gradients(list(self.model.parameters()), self.group)
            grad_norm, = global_norms({"grad_norm": list(self.model.parameters())},
                                      sharded_params(self.model), self.model_group).values()
            self.optimizer.step()
        self.step += 1
        loss, = distributed.mean_over_ranks([loss], self.group)
        return {"train_loss": loss.detach(), "grad_norm": grad_norm.detach()}

    def make_datasets(self):
        """(train, validation) datasets of ``cfg.data``, as the JAX
        pretraining builds them: the synthetic set with its
        ``synthetic_profile`` (validation ``max(8, size // 16)`` clips, seed
        ``seed + 10_000``), or LibriMix manifests."""
        cfg, d = self.cfg, self.cfg.data
        if d.synthetic:
            train = SyntheticEnhancementDataset(
                size=d.synthetic_size, segment=d.segment or 3.0,
                sample_rate=d.sample_rate, seed=cfg.seed, profile=d.synthetic_profile)
            val = SyntheticEnhancementDataset(
                size=max(8, d.synthetic_size // 16), segment=d.segment or 3.0,
                sample_rate=d.sample_rate, seed=cfg.seed + 10_000,
                profile=d.synthetic_profile)
        else:
            train = LibriMixDataset(d.train_dir, d.task, d.sample_rate, d.n_src, d.segment)
            val = LibriMixDataset(d.valid_dir, d.task, d.sample_rate, d.n_src, d.segment)
        return train, val

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, epochs: Optional[int] = None, log_fn: Callable[[str], Any] = print,
            checkpoint_manager=None) -> Dict[str, float]:
        """Train from epoch ``self.epoch`` up to ``epochs`` (default
        ``cfg.max_epochs``), validating after each epoch, and return the
        last epoch's metrics (``validate``'s, ``epoch_time_s`` and
        ``audio_s_per_s``).  A trainer whose ``init_state`` has not run is
        initialized first.  Epoch ``e`` shuffles with ``(cfg.seed, e)``;
        ``checkpoint_manager.save(self, metrics)`` runs after each
        validation on every rank (rank 0 alone logs and writes, every rank
        waiting at a barrier after it)."""
        cfg = self.cfg
        if self.optimizer is None:
            self.init_state()
        train_ds, val_ds = self.make_datasets()
        loader = make_loader(train_ds, cfg.data.batch_size, shuffle=True, seed=cfg.seed)
        total_epochs = epochs or cfg.max_epochs
        loader.epoch = start_epoch = min(self.epoch, total_epochs)
        history: Dict[str, float] = {}
        for epoch in range(start_epoch, total_epochs):
            self._sync()
            t0 = time.time()
            n = 0
            for mix, src in loader:
                logs = self.train_step(mix, src[:, 0])
                n += 1
                if n % cfg.log_every == 0 and self.mesh.is_main:
                    log_fn(f"epoch {epoch} step {n}: "
                           + " ".join(f"{k}={float(v):.4f}" for k, v in logs.items()))
            self._sync()
            dt = time.time() - t0
            self.epoch = epoch + 1
            metrics = self.validate(val_ds)
            metrics["epoch_time_s"] = dt
            metrics["audio_s_per_s"] = n * cfg.data.batch_size * (cfg.data.segment or 3.0) / dt
            if self.mesh.is_main:
                log_fn(f"epoch {epoch} done: "
                       + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            if checkpoint_manager is not None:
                checkpoint_manager.save(self, metrics)  # every rank; rank 0 writes
                distributed.barrier(self.mesh.world_group)
            history = metrics
        return history

    @torch.no_grad()
    def validate(self, val_ds) -> Dict[str, float]:
        """Mean SI-SDR and STOI of the model on running statistics over
        ``val_ds`` in order, against the first source (no PIT), in batches
        of ``min(batch_size, len(val_ds))`` (the last partial batch
        dropped, as in JAX); read to the host once, at the end.  Under data
        parallelism each rank runs its rows: SI-SDR (a ratio of batch
        means) on the gathered estimates, STOI averaged over the ranks."""
        sr = self.cfg.data.sample_rate
        loader = make_loader(val_ds, min(self.cfg.data.batch_size, len(val_ds)), shuffle=False)
        agg: Dict[str, List[torch.Tensor]] = {}
        for mix, src in loader:
            mix = distributed.local_rows(mix, 0, self.group, self.device)
            clean = torch.as_tensor(src[:, 0], dtype=torch.float32).to(self.device)
            local_clean = distributed.local_rows(clean, 0, self.group)
            with float32_math():
                local_est = self.model(mix, training=False).wav
                est = distributed.all_gather(local_est, 0, self.group)
                stoi, = distributed.mean_over_ranks(
                    [torch.mean(stoi_batch(local_clean, local_est, fs=sr))], self.group)
                m = {"si_sdr": si_sdr(clean, est), "stoi": stoi}
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        keys = list(agg)
        host = torch.stack([torch.stack(agg[k]) for k in keys]).cpu().numpy()  # one read
        return {k: float(np.mean(host[i])) for i, k in enumerate(keys)}
