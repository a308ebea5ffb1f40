"""A rank of the port's data-parallel and sequence-parallel runs on the CPU.

    python tests/torch_dp_worker.py RANK WORLD PORT OUT JOB [JOB ...]

Imports torch and the port, nothing of JAX.  Joins a gloo group of WORLD
processes at ``tcp://127.0.0.1:PORT`` (``parallel.distributed.initialize``),
runs on one CPU thread, runs the JOBs in order and writes their results
under OUT:

- ``steps=CASE,CASE,...``: for each CASE (``CASES``) a trainer on the tiny
  geometry takes the case's steps on the global batches of ``batches()``;
  the rank writes ``CASE.rRANK.npz`` (``run_steps``: the logs of every
  step, the gradients of step 1, the parameters and statistics after the
  last step);
- ``sequence``: ``sharded_utterance_forward`` of ``SEQ_CFG``'s seeded model
  on the rank's span of ``sequence_signal()``, written as
  ``sequence.rRANK.npy``, and a span of a bad length must raise;
- ``mesh``: ``make_mesh`` over the world, its shape written as
  ``mesh.rRANK.json``.

The tests (``tests/test_torch_distributed.py``) start the ranks with
``subprocess`` and read the files; the same module gives them the configs
and the batches, so both sides build the same runs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
BATCH, SAMPLES = 8, 8000
SEED = 3
# name: (trainer, strategy or loss mode, distill fields, model fields, steps)
CASES = {
    "clskd_g1": ("distill", "clskd", dict(spkd_gram_groups=1), {}, 2),
    "clskd_g2": ("distill", "clskd", dict(spkd_gram_groups=2), {}, 2),
    "clskd_g4": ("distill", "clskd", dict(spkd_gram_groups=4), {}, 2),
    "clskd_remat_fold_g1": ("distill", "clskd",
                            dict(spkd_gram_groups=1, abf_remat=True, spkd_bn2_fold=True), {}, 2),
    "mse": ("distill", "mse", {}, {}, 1),
    "pretrain": ("pretrain", "SDR+PMSQE", {}, {}, 1),
    "pretrain_cbn": ("pretrain", "SDR+PMSQE", {}, dict(use_cbn=True), 1),
    "pretrain_si_sdr": ("pretrain", "SI-SDR", {}, {}, 1),
}
SEQ_CFG = dict(name="sp", kernel_num=(4, 8, 8), rnn_units=16)
SEQ_SAMPLES = 64000


def config(case: str):
    """The port's ``TrainConfig`` of ``case``."""
    from speech_enhancement_clskd_tpu_torch.config import (
        DataConfig,
        DCCRNConfig,
        DistillConfig,
        TrainConfig,
    )

    kind, mode, distill, model, _ = CASES[case]
    data = DataConfig(synthetic=True, synthetic_size=2 * BATCH, segment=SAMPLES / 16000,
                      batch_size=BATCH)
    if kind == "pretrain":
        return TrainConfig(teacher=DCCRNConfig(**TINY_T, **model), data=data, loss_mode=mode)
    return TrainConfig(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**TINY_S),
                       data=data, distill=DistillConfig(strategy=mode, **distill))


def trainer(case: str, **kw):
    """A seeded trainer of ``case`` on the CPU (``kw``: ``mesh=``)."""
    if CASES[case][0] == "pretrain":
        from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer

        return PretrainTrainer(config(case), device="cpu", **kw).init_state(SEED)
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    return Trainer(config(case), device="cpu", **kw).init_state(SEED)


def batches(steps: int = 2):
    """White-noise (mixture, clean) global batches [BATCH, SAMPLES]."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(steps):
        clean = (0.1 * rng.standard_normal((BATCH, SAMPLES))).astype(np.float32)
        out.append((clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32),
                    clean))
    return out


def run_steps(case: str, rounding=None, **kw) -> dict:
    """A seeded trainer of ``case`` (``kw``: ``mesh=``) takes the case's
    steps on ``batches()`` (the first mixture moved to float32 neighbours by
    ``rounding(mix)`` where given): flat arrays ``log.K.name``,
    ``grad.name`` (step 1) and ``state.name`` (the parameters and
    statistics after the last step)."""
    t = trainer(case, **kw)
    out = {}
    for k, (mix, clean) in enumerate(batches(CASES[case][4]), start=1):
        if k == 1 and rounding is not None:
            mix = rounding(mix)
        logs = t.train_step(mix, clean)
        out.update({f"log.{k}.{n}": np.float64(v) for n, v in logs.items()})
        if k == 1:
            out.update({f"grad.{part}.{n}": p.grad.detach().numpy().copy()
                        for part, m in t.trainable().items() for n, p in m.named_parameters()})
    out.update({f"state.{part}.{n}": v.detach().numpy().copy()
                for part, m in t.trainable().items() for n, v in m.state_dict().items()})
    return out


def sequence_signal() -> np.ndarray:
    """The JAX test's utterance pair [2, SEQ_SAMPLES]: a 220 Hz tone in
    noise and 0.8 times it."""
    rng = np.random.default_rng(0)
    t = np.arange(SEQ_SAMPLES) / 16000
    sig = (0.4 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.standard_normal(SEQ_SAMPLES)).astype(np.float32)
    return np.stack([sig, 0.8 * sig])


def sequence_model():
    """``SEQ_CFG``'s DCCRN with seeded weights, on the CPU."""
    from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model

    return make_model(DCCRNConfig(**SEQ_CFG), device="cpu", seed=0)


def main(argv) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.parallel import distributed

    rank, world, port, out = argv[:4]
    rank, world, out = int(rank), int(world), Path(out)
    torch.set_num_threads(1)
    assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        for job in argv[4:]:
            run_job(job, rank, world, out)
        distributed.barrier(torch.distributed.group.WORLD)
    finally:
        distributed.leave()
    print(f"RANK_{rank}_OK", flush=True)


def run_job(job: str, rank: int, world: int, out: Path) -> None:
    import torch

    if job.startswith("steps="):
        for case in job[len("steps="):].split(","):
            np.savez(out / f"{case}.r{rank}.npz", **run_steps(case))
    elif job == "sequence":
        from speech_enhancement_clskd_tpu_torch.parallel.sequence import (
            sharded_utterance_forward,
        )

        model = sequence_model()
        span = SEQ_SAMPLES // world
        wav = torch.from_numpy(sequence_signal()[:, rank * span:(rank + 1) * span])
        np.save(out / f"sequence.r{rank}.npy", sharded_utterance_forward(model, wav).numpy())
        try:
            sharded_utterance_forward(model, wav[:, :span - 7])
        except ValueError:
            pass
        else:
            raise AssertionError("a span of a bad length did not raise")
    elif job == "mesh":
        from speech_enhancement_clskd_tpu_torch.config import MeshConfig
        from speech_enhancement_clskd_tpu_torch.parallel.mesh import make_mesh

        shapes = {f"{d}x{m}": make_mesh(MeshConfig(data=d, model=m), "cpu").shape
                  for d, m in ((-1, 1), (-1, 2), (world // 2, 2))}
        (out / f"mesh.r{rank}.json").write_text(json.dumps(shapes))
    else:
        raise ValueError(f"unknown job {job!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
