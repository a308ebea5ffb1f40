"""Checkpoints and the publishable inference bundle (``.npz``).

Two artifact roles, as in ``speech_enhancement_clskd_tpu/utils/serialization.py``:

1. **Publishable bundle**: the flax variable tree flattened to ``|``-joined
   paths (``params|enc0_conv|wr``, ``batch_stats|enc0_bn|mean``) plus one
   JSON ``__meta__`` entry (``model_name``, ``model_args``, ``config``,
   ``infos``), numpy alone, no pickle.  ``save_bundle`` writes the JAX
   package's schema, so the JAX ``load_bundle`` reads a port bundle and
   ``load_bundle`` here reads a JAX one; ``student_from_state`` takes the
   student's variables out of a ``train.trainer.Trainer`` in flax layouts
   (``utils.bridge.flax_from_torch_state``), and
   ``utils.bridge.torch_state_from_flax`` carries a bundle's tree back.
2. **Training checkpoints**: ``CheckpointManager`` keeps the JAX manager's
   contract without orbax: ``torch.save`` of a trainer's modules (a
   distillation ``Trainer``'s, or a ``PretrainTrainer``'s one ``model``),
   Adam state, step and epoch counter into ``step_%08d/``, top-k retention on a
   monitored metric (the reference's ``ModelCheckpoint(save_top_k=3,
   monitor='stoi', mode='max')``), and restore.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DCCRNConfig, STFTConfig
from .bridge import flax_from_torch_state, trainer_parts

_SEP = "|"


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, prefix + str(key) + _SEP))
        else:
            out[prefix + str(key)] = np.asarray(val)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return tree


def load_bundle(path: str) -> Tuple[DCCRNConfig, Dict[str, Any], Dict[str, Any]]:
    """Returns (model config, variables {params, batch_stats} as numpy, meta)."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {
            coll: {
                key[len(coll + _SEP):]: z[key]
                for key in z.files
                if key.startswith(coll + _SEP)
            }
            for coll in ("params", "batch_stats")
        }
    variables = {"params": _unflatten(flat["params"])}
    if flat["batch_stats"]:
        variables["batch_stats"] = _unflatten(flat["batch_stats"])
    c = meta["config"]
    cfg = DCCRNConfig(
        name=c["name"],
        family=c.get("family", "dccrn"),
        stft=STFTConfig(**c["stft"]),
        kernel_num=tuple(c["kernel_num"]),
        kernel_size=c["kernel_size"],
        rnn_layers=c["rnn_layers"],
        rnn_units=c["rnn_units"],
        masking_mode=c["masking_mode"],
        use_clstm=c["use_clstm"],
        use_cbn=c["use_cbn"],
        bidirectional=c["bidirectional"],
        compute_dtype=c["compute_dtype"],
    )
    return cfg, variables, meta


def save_bundle(
    path: str,
    params: Any,
    batch_stats: Any,
    cfg: DCCRNConfig,
    infos: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a publishable inference bundle (.npz) from flax-layout numpy
    trees (``student_from_state``)."""
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten(params, "params" + _SEP))
    if batch_stats:
        arrays.update(_flatten(batch_stats, "batch_stats" + _SEP))
    meta = {
        "model_name": "DCCRNet" if getattr(cfg, "family", "dccrn") == "dccrnet" else "DCCRN",
        "model_args": {
            "architecture": cfg.name,
            "stft_n_filters": cfg.stft.fft_len,
            "stft_kernel_size": cfg.stft.win_len,
            "stft_stride": cfg.stft.hop,
            "sample_rate": cfg.stft.sample_rate,
            "n_freqs": cfg.stft.fft_len // 2 + 1,
        },
        "config": dataclasses.asdict(cfg),
        "infos": {
            "software_versions": {
                "torch_version": torch.__version__,
                "framework": "speech_enhancement_clskd_tpu_torch",
            },
            **(infos or {}),
        },
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def student_from_state(trainer, cfg: DCCRNConfig) -> Dict[str, Any]:
    """The student's inference variables ``{params, batch_stats}`` of a
    ``Trainer`` as numpy trees in flax layouts (the reference's 'strip the
    student. prefix' step, distill.py:280-290).  ``cfg`` is the student's
    config, as the JAX function takes it."""
    variables = flax_from_torch_state(trainer.student.state_dict())
    return {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}


def trainer_state(trainer) -> Dict[str, Any]:
    """What a checkpoint holds: the step, the completed epochs, every
    module's state_dict (``utils.bridge.trainer_parts``: student, teacher
    and, with fusion, both ABF chains; a ``PretrainTrainer``'s ``model``)
    and Adam's state.  The tensors are the trainer's own; ``torch.save``
    copies them."""
    if trainer.optimizer is None:
        raise RuntimeError("call trainer.init_state() before saving or restoring")
    return {"step": trainer.step, "epoch": trainer.epoch,
            "modules": {part: getattr(trainer, part).state_dict()
                        for part in trainer_parts(trainer)},
            "optimizer": trainer.optimizer.state_dict()}


class CheckpointManager:
    """Trainer checkpointing with top-k metric retention.

    ``save(trainer, metrics)`` keeps the checkpoint while fewer than
    ``keep_top_k`` are kept, else only if its score beats the worst kept one
    strictly (a tie is not kept), and then deletes that worst one.  The
    scores (negated for ``mode="min"``) and the monitor live in
    ``index.json``, which a new manager on the same directory reads.
    """

    _FILE = "state.pt"

    def __init__(self, directory: str, monitor: str = "stoi", mode: str = "max",
                 keep_top_k: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.keep_top_k = keep_top_k
        self._scores: Dict[int, float] = {}
        self._load_index()

    def _index_path(self) -> str:
        return os.path.join(self.directory, "index.json")

    def _load_index(self) -> None:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                data = json.load(f)
            self._scores = {int(k): v for k, v in data.get("scores", {}).items()}

    def _save_index(self) -> None:
        with open(self._index_path(), "w") as f:
            json.dump({"scores": self._scores, "monitor": self.monitor}, f)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, trainer, metrics: Dict[str, float]) -> bool:
        """Save ``trainer`` (``trainer_state``) if the metric makes top-k;
        prune the worst.  Returns whether it was kept."""
        step = int(trainer.step)
        score = float(metrics.get(self.monitor, float("-inf")))
        key = score if self.mode == "max" else -score
        if len(self._scores) >= self.keep_top_k:
            worst = min(self._scores, key=self._scores.get)
            if key <= self._scores[worst]:
                return False
            shutil.rmtree(self._step_dir(worst), ignore_errors=True)
            del self._scores[worst]
        os.makedirs(self._step_dir(step), exist_ok=True)
        torch.save(trainer_state(trainer), os.path.join(self._step_dir(step), self._FILE))
        self._scores[step] = key
        self._save_index()
        return True

    def best_step(self) -> Optional[int]:
        if not self._scores:
            return None
        return max(self._scores, key=self._scores.get)

    def best_score(self) -> Optional[float]:
        b = self.best_step()
        return None if b is None else float(self._scores[b])

    def restore(self, trainer, step: Optional[int] = None):
        """Load checkpoint ``step`` (the best by default) into ``trainer``,
        whose ``init_state()`` has run: every module strictly, Adam's state,
        the step and the epoch counter.  Returns the trainer."""
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if trainer.optimizer is None:
            raise RuntimeError("call trainer.init_state() before restoring")
        ckpt = torch.load(os.path.join(self._step_dir(step), self._FILE),
                          map_location=trainer.device, weights_only=True)
        parts = trainer_parts(trainer)
        if tuple(ckpt["modules"]) != parts:
            raise ValueError(f"the checkpoint holds {tuple(ckpt['modules'])}, the trainer {parts}")
        for part in parts:
            getattr(trainer, part).load_state_dict(ckpt["modules"][part], strict=True)
        trainer.optimizer.load_state_dict(ckpt["optimizer"])
        trainer.step = int(ckpt["step"])
        trainer.epoch = int(ckpt["epoch"])
        return trainer
