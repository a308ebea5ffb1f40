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

Under tensor parallelism (``models.dccrn.shard_model``) both hold whole
tensors: the leaves and Adam's moments of a sharded model are gathered over
its model ranks (a collective, so every rank calls ``trainer_state``,
``student_from_state`` and ``CheckpointManager.save``; rank 0 writes), and
``restore`` gives each rank its slice.  A checkpoint written at
``mesh.model=2`` has the keys, shapes and values of one written at
``mesh.model=1`` from the same state, and restores at either.
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
from ..models.dccrn import full_state_dict, full_tensors, load_full_state_dict, local_tensors
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
    config, as the JAX function takes it.  A sharded student is gathered
    whole (every model rank calls it)."""
    variables = flax_from_torch_state(full_state_dict(trainer.student))
    return {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}


def _optimizer_leaves(trainer):
    """``(module, name)`` of each parameter the optimizer holds, in its
    order (the trainable modules' ``named_parameters``, as the trainers
    make the optimizer)."""
    leaves = [(m, n) for m in trainer.trainable().values() for n, _ in m.named_parameters()]
    if len(leaves) != sum(len(g["params"]) for g in trainer.optimizer.param_groups):
        raise RuntimeError("the optimizer does not hold the trainable modules' parameters")
    return leaves


def _leaf_state(module, name: str, st: Dict[str, Any], whole: bool) -> Dict[str, Any]:
    """One parameter's optimizer state with its tensors of the parameter's
    shape (Adam's moments; not its 0-d step) gathered whole (``whole``, a
    collective) or cut to this rank's slice (a copy: ``Optimizer.load_state_dict``
    keeps the tensors it is given, and a view would keep the whole moment)."""
    def convert(v):
        if whole:
            return full_tensors(module, {name: v})[name]
        return local_tensors(module, {name: v})[name].clone(memory_format=torch.contiguous_format)

    return {k: convert(v) if torch.is_tensor(v) and v.ndim > 0 else v for k, v in st.items()}


def _optimizer_state(trainer, state: Dict[Any, Any], whole: bool) -> Dict[Any, Any]:
    """An optimizer state_dict's ``state`` with every sliced leaf's
    tensors whole or cut (``_leaf_state``)."""
    state = dict(state)
    for i, (module, name) in enumerate(_optimizer_leaves(trainer)):
        if i in state:
            state[i] = _leaf_state(module, name, state[i], whole)
    return state


def trainer_state(trainer) -> Dict[str, Any]:
    """What a checkpoint holds: the step, the completed epochs, every
    module's state_dict (``utils.bridge.trainer_parts``: student, teacher
    and, with fusion, both ABF chains; a ``PretrainTrainer``'s ``model``)
    and Adam's state, every tensor whole.  The tensors of a whole model are
    the trainer's own (``torch.save`` copies them); a sharded model's are
    gathered (a collective: every model rank calls it)."""
    if trainer.optimizer is None:
        raise RuntimeError("call trainer.init_state() before saving or restoring")
    opt = trainer.optimizer.state_dict()
    return {"step": trainer.step, "epoch": trainer.epoch,
            "modules": {part: full_state_dict(getattr(trainer, part))
                        for part in trainer_parts(trainer)},
            "optimizer": {**opt, "state": _optimizer_state(trainer, opt["state"], whole=True)}}


def load_trainer_state(trainer, ckpt: Dict[str, Any]) -> None:
    """``trainer_state``'s inverse: every module strictly (a sharded one
    takes its slices), the optimizer's state cut alike, the step and the
    epoch counter."""
    parts = trainer_parts(trainer)
    if tuple(ckpt["modules"]) != parts:
        raise ValueError(f"the checkpoint holds {tuple(ckpt['modules'])}, the trainer {parts}")
    for part in parts:
        load_full_state_dict(getattr(trainer, part), ckpt["modules"][part])
    opt = ckpt["optimizer"]
    trainer.optimizer.load_state_dict(
        {**opt, "state": _optimizer_state(trainer, opt["state"], whole=False)})
    trainer.step = int(ckpt["step"])
    trainer.epoch = int(ckpt["epoch"])


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
        prune the worst.  Returns whether it was kept.  Under data or
        tensor parallelism every rank calls it with the same (global)
        metrics and takes the same decision, a sharded state is gathered
        by all, and only the trainer's main rank (``trainer.mesh.is_main``)
        writes and deletes files."""
        step = int(trainer.step)
        score = float(metrics.get(self.monitor, float("-inf")))
        key = score if self.mode == "max" else -score
        mesh = getattr(trainer, "mesh", None)
        writes = mesh is None or mesh.is_main
        if len(self._scores) >= self.keep_top_k:
            worst = min(self._scores, key=self._scores.get)
            if key <= self._scores[worst]:
                return False
            if writes:
                shutil.rmtree(self._step_dir(worst), ignore_errors=True)
            del self._scores[worst]
        state = trainer_state(trainer)
        self._scores[step] = key
        if writes:
            os.makedirs(self._step_dir(step), exist_ok=True)
            torch.save(state, os.path.join(self._step_dir(step), self._FILE))
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
        the step and the epoch counter (``load_trainer_state``; a sharded
        trainer takes its slices, whatever ``mesh.model`` wrote the
        checkpoint).  Returns the trainer."""
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if trainer.optimizer is None:
            raise RuntimeError("call trainer.init_state() before restoring")
        ckpt = torch.load(os.path.join(self._step_dir(step), self._FILE),
                          map_location=trainer.device, weights_only=True)
        load_trainer_state(trainer, ckpt)
        return trainer
