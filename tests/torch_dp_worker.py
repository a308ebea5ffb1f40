"""A rank of the port's data-, tensor- and sequence-parallel runs on the CPU.

    python tests/torch_dp_worker.py RANK WORLD PORT OUT JOB [JOB ...]

Imports torch and the port, nothing of JAX.  Joins a gloo group of WORLD
processes at ``tcp://127.0.0.1:PORT`` (``parallel.distributed.initialize``),
runs on one CPU thread, runs the JOBs in order and writes their results
under OUT:

- ``steps=CASE,CASE,...``: for each CASE (``CASES``) a trainer on the
  case's geometry and mesh layout takes the case's steps on the global
  batches of ``batches()``; the rank writes ``CASE.rRANK.npz``
  (``run_steps``: the logs of every step, the gradients of step 1, the
  parameters and statistics after the last step, all whole, and for each
  leaf sliced over the model ranks its sizes here and whole);
- ``checkpoint``: a ``model=2`` trainer's checkpoint restored by a
  one-process trainer, and a one-process checkpoint restored by the
  ``model=2`` trainer (``checkpoint_round_trip``), the results in
  ``checkpoint.rRANK.json``;
- ``collectives``: ``copy_in`` and ``gather_out`` around column-parallel
  products, their values and gradients against the one-process products
  (``collective_checks``), in ``collectives.rRANK.json``;
- ``layers``: each layer that runs sharded (``tp_layers``), cut by
  ``shard_model`` over the world, against the whole layer on the same
  inputs (``layer_checks``), in ``layers.rRANK.json``;
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
from typing import NamedTuple, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
# the JAX tensor-parallel tests' geometries (tests/test_parallel.py), where
# the rule shards: the LSTMs' w_ih (both models), w_hh and convs (teacher)
TP_T = dict(name="tp-teacher", kernel_num=(8, 16, 32), rnn_units=64)
TP_S = dict(name="tp-student", kernel_num=(4, 8, 16), rnn_units=32)
DCCRNET_T = dict(name="tp-teacher", family="dccrnet", kernel_num=(8, 16, 16), rnn_units=32)
DCCRNET_S = dict(name="tp-student", family="dccrnet", kernel_num=(4, 8, 8), rnn_units=16)
GEOMETRIES = {"tiny": (TINY_T, TINY_S), "tp": (TP_T, TP_S), "dccrnet": (DCCRNET_T, DCCRNET_S)}
BATCH, SAMPLES = 8, 8000
SEED = 3


class Case(NamedTuple):
    """A run: the trainer (``distill`` or ``pretrain``), the strategy or
    loss mode, distill fields, model fields (both models'; the pretrained
    teacher's), steps, geometry (``GEOMETRIES``) and the mesh layout
    ``(data, model)`` (``data=-1``: the world)."""

    kind: str
    mode: str
    distill: dict
    model: dict
    steps: int
    geometry: str = "tiny"
    mesh: Tuple[int, int] = (-1, 1)


BF16 = dict(compute_dtype="bfloat16")
CASES = {
    "clskd_g1": Case("distill", "clskd", dict(spkd_gram_groups=1), {}, 2),
    "clskd_g2": Case("distill", "clskd", dict(spkd_gram_groups=2), {}, 2),
    "clskd_g4": Case("distill", "clskd", dict(spkd_gram_groups=4), {}, 2),
    "clskd_remat_fold_g1": Case("distill", "clskd",
                                dict(spkd_gram_groups=1, abf_remat=True, spkd_bn2_fold=True),
                                {}, 2),
    "mse": Case("distill", "mse", {}, {}, 1),
    "pretrain": Case("pretrain", "SDR+PMSQE", {}, {}, 1),
    "pretrain_cbn": Case("pretrain", "SDR+PMSQE", {}, dict(use_cbn=True), 1),
    "pretrain_si_sdr": Case("pretrain", "SI-SDR", {}, {}, 1),
    # tensor parallelism over mesh.model
    "tp_clskd_1x2": Case("distill", "clskd", {}, {}, 2, "tp", (1, 2)),
    "tp_clskd_2x2": Case("distill", "clskd", {}, {}, 2, "tp", (2, 2)),
    "tp_block_1x2": Case("distill", "clskd", dict(abf_block_pallas=True), {}, 1, "tp", (1, 2)),
    "tp_bf16_1x2": Case("distill", "clskd", dict(taps_dtype="bfloat16"), BF16, 1, "tp", (1, 2)),
    "tp_pretrain_1x2": Case("pretrain", "SDR+PMSQE", {}, {}, 1, "tp", (1, 2)),
    "tp_dccrnet_2x2": Case("distill", "clskd", {}, {}, 1, "dccrnet", (2, 2)),
    # the 2x2 cases' rows split over two data ranks without tensor parallelism
    "dp_tp_2x1": Case("distill", "clskd", {}, {}, 2, "tp", (2, 1)),
    "dp_dccrnet_2x1": Case("distill", "clskd", {}, {}, 1, "dccrnet", (2, 1)),
}
SEQ_CFG = dict(name="sp", kernel_num=(4, 8, 8), rnn_units=16)
SEQ_SAMPLES = 64000


def model_config(fields: dict, case: Case):
    """A ``DCCRNConfig`` of ``fields`` with the case's model fields (the
    DCCRNet presets' sqrthann window for that family)."""
    from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig, STFTConfig

    extra = dict(stft=STFTConfig(window="sqrthann")) if fields.get("family") == "dccrnet" else {}
    return DCCRNConfig(**fields, **extra, **case.model)


def config(case: str):
    """The port's ``TrainConfig`` of ``case``, its mesh the case's layout."""
    from speech_enhancement_clskd_tpu_torch.config import (
        DataConfig,
        DistillConfig,
        MeshConfig,
        TrainConfig,
    )

    c = CASES[case]
    teacher, student = GEOMETRIES[c.geometry]
    data = DataConfig(synthetic=True, synthetic_size=2 * BATCH, segment=SAMPLES / 16000,
                      batch_size=BATCH)
    mesh = MeshConfig(data=c.mesh[0], model=c.mesh[1])
    if c.kind == "pretrain":
        return TrainConfig(teacher=model_config(teacher, c), data=data, loss_mode=c.mode,
                           mesh=mesh)
    return TrainConfig(teacher=model_config(teacher, c), student=model_config(student, c),
                       data=data, distill=DistillConfig(strategy=c.mode, **c.distill), mesh=mesh)


def one_process():
    """The mesh of the one-process runs the groups are held against."""
    from speech_enhancement_clskd_tpu_torch.parallel.mesh import Mesh

    return Mesh({"data": 1, "model": 1})


def trainer(case: str, **kw):
    """A seeded trainer of ``case`` on the CPU (``kw``: ``mesh=``; the
    case's layout over the process group by default)."""
    if CASES[case].kind == "pretrain":
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
    statistics after the last step), whole where the model ranks hold
    slices, and for each sliced leaf ``shard.name``: its elements here and
    whole, and those of its Adam moments here (``shard_sizes``)."""
    from speech_enhancement_clskd_tpu_torch.models.dccrn import full_state_dict, full_tensors

    t = trainer(case, **kw)
    out = {}
    for k, (mix, clean) in enumerate(batches(CASES[case].steps), start=1):
        if k == 1 and rounding is not None:
            mix = rounding(mix)
        logs = t.train_step(mix, clean)
        out.update({f"log.{k}.{n}": np.float64(v) for n, v in logs.items()})
        if k == 1:
            out.update({f"grad.{part}.{n}": g.numpy().copy()
                        for part, m in t.trainable().items()
                        for n, g in full_tensors(m, {n: p.grad for n, p in
                                                     m.named_parameters()}).items()})
    out.update({f"state.{part}.{n}": v.detach().numpy().copy()
                for part, m in t.trainable().items() for n, v in full_state_dict(m).items()})
    out.update(shard_sizes(t))
    return out


def shard_sizes(t) -> dict:
    """``shard.part.name``: [elements here, elements whole, elements of
    each Adam moment here (0 where there is none)] for each leaf the
    trainer's models hold sliced."""
    from speech_enhancement_clskd_tpu_torch.models.dccrn import full_tensors, model_shards
    from speech_enhancement_clskd_tpu_torch.utils.bridge import trainer_parts

    out = {}
    for part in trainer_parts(t):
        m = getattr(t, part)
        params = dict(m.named_parameters())
        sliced = {n: params[n] for n in model_shards(m)}
        whole = full_tensors(m, sliced)
        for n, p in sliced.items():
            st = t.optimizer.state.get(p, {})
            moments = [st[k].numel() if k in st else 0 for k in ("exp_avg", "exp_avg_sq")]
            out[f"shard.{part}.{n}"] = np.array([p.numel(), whole[n].numel(), *moments])
    return out


def checkpoint_round_trip(out: Path, rank: int) -> dict:
    """``tp_clskd_1x2`` after a step saves a checkpoint (every rank calls
    ``save``, rank 0 writes); a one-process trainer restores it and must
    hold the same whole state, bit for bit, with the keys and shapes of
    its own checkpoint; that trainer takes a step and saves (rank 0
    writes), and the ``model=2`` trainer restores it and must hold that
    state whole.  Returns the checks' results."""
    import torch

    from speech_enhancement_clskd_tpu_torch.utils.serialization import (
        CheckpointManager,
        trainer_state,
    )

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if torch.is_tensor(a):
            return a.shape == b.shape and torch.equal(a, b)
        return a == b

    world = torch.distributed.group.WORLD
    (mix, clean), = batches(1)
    tp = trainer("tp_clskd_1x2")
    tp.train_step(mix, clean)
    wide = CheckpointManager(str(out / "ck_model2"), keep_top_k=1)
    wide.save(tp, {"stoi": 0.5})
    written = trainer_state(tp)
    torch.distributed.barrier(world)
    one = trainer("tp_clskd_1x2", mesh=one_process())
    wide.restore(one)
    res = {"model2_to_model1": same(trainer_state(one), written),
           "sharded": bool(tp.student.tp_shards) and bool(tp.teacher.tp_shards)}
    one.train_step(mix, clean)
    narrow = CheckpointManager(str(out / "ck_model1"), keep_top_k=1)
    narrow.save(one, {"stoi": 0.6})
    torch.distributed.barrier(world)
    narrow.restore(tp)
    res["model1_to_model2"] = same(trainer_state(tp), trainer_state(one))
    res["step"] = tp.step
    return res


def tp_layers():
    """One of each layer that runs sharded, each at a width the rule cuts,
    named as the models name them (the bridge's layouts follow the names),
    seeded; and a function giving each its seeded inputs."""
    import torch

    from speech_enhancement_clskd_tpu_torch.ops.complex_layers import (
        ComplexConv2d,
        ComplexConvTranspose2d,
        ComplexDense,
    )
    from speech_enhancement_clskd_tpu_torch.ops.complex_lstm import (
        Dense,
        LSTMCell,
        NaiveComplexLSTM,
    )

    layers = torch.nn.Module()
    layers.enc0_conv = ComplexConv2d(64, 128)  # JAX [5, 2, 32, 64]
    layers.dec0_conv = ComplexConvTranspose2d(128, 128, time_crop_left=1)  # [5, 2, 64, 64]
    layers.rnn_linear = ComplexDense(128, 256)
    layers.clstm1 = NaiveComplexLSTM(64, 256, projection_dim=256)  # w_ih, w_hh, proj_w*
    layers.LSTMCell_0 = LSTMCell(128, 128)  # the input and recurrent kernels
    layers.lstm_proj = Dense(128, 256)
    g = torch.Generator().manual_seed(SEED)
    for m in layers.children():
        m.reset_parameters(g)
        for p in m.parameters():  # biases the init leaves at zero
            p.data.add_(0.01 * torch.randn(p.shape, generator=g))

    def inputs(name):
        g = torch.Generator().manual_seed(len(name))
        shapes = {"enc0_conv": [(2, 16, 6, 64)], "dec0_conv": [(2, 8, 6, 128)],
                  "rnn_linear": [(5, 2, 256)], "clstm1": [(5, 2, 64), (5, 2, 64)],
                  "LSTMCell_0": [(5, 2, 128)], "lstm_proj": [(5, 2, 128)]}[name]
        return [torch.randn(sh, generator=g) for sh in shapes]

    return layers, inputs


def layer_checks(rank: int, world: int) -> dict:
    """Each of ``tp_layers`` whole and cut over the world (``shard_model``):
    the outputs, the inputs' gradients and the parameters' gradients
    (gathered whole) of a seeded output gradient, as the largest
    difference relative to the largest whole value; and the leaves cut."""
    import copy

    import torch

    from speech_enhancement_clskd_tpu_torch.models.dccrn import full_tensors, shard_model

    whole, inputs = tp_layers()
    cut = copy.deepcopy(whole)
    shards = shard_model(cut, torch.distributed.group.WORLD)
    res = {"shards": sorted(shards)}

    def run(model, name):
        xs = [x.clone().requires_grad_(True) for x in inputs(name)]
        ys = getattr(model, name)(*xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        g = torch.Generator().manual_seed(7)
        sum((y * torch.randn(y.shape, generator=g)).sum() for y in ys).backward()
        params = {n: p.grad for n, p in model.named_parameters() if n.startswith(name + ".")}
        return list(ys), [x.grad for x in xs], full_tensors(model, params)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    for name, _ in whole.named_children():
        y_w, gx_w, gp_w = run(whole, name)
        y_c, gx_c, gp_c = run(cut, name)
        res[name] = {"out": max(rel(a, b) for a, b in zip(y_c, y_w)),
                     "grad_in": max(rel(a, b) for a, b in zip(gx_c, gx_w)),
                     "grad_params": max(rel(gp_c[n], gp_w[n]) for n in gp_w),
                     "shapes": [list(y.shape) for y in y_c] == [list(y.shape) for y in y_w]}
    return res


def collective_checks(rank: int, world: int) -> dict:
    """``copy_in`` -> a product with this rank's columns -> ``gather_out``
    (1, 2 and 4 parts) against the one-process product on the whole
    weight: the value, and the gradients of the input (summed over the
    ranks) and of this rank's weight columns (its slice of the whole
    weight's, not summed)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.parallel import distributed

    group = torch.distributed.group.WORLD
    res = {}
    for parts in (1, 2, 4):
        g = torch.Generator().manual_seed(parts)
        cols = 3 * parts * world
        x = torch.randn(5, 7, generator=g, dtype=torch.float64)
        w = torch.randn(7, cols, generator=g, dtype=torch.float64)
        dy = torch.randn(5, cols, generator=g, dtype=torch.float64)
        # this rank's columns: block j of the packed layout, rank's share
        c = cols // parts // world
        mine = torch.cat([torch.arange(j * cols // parts + rank * c, j * cols // parts
                                       + (rank + 1) * c) for j in range(parts)])
        xs = x.clone().requires_grad_(True)
        ws = w[:, mine].clone().requires_grad_(True)
        y = distributed.gather_out(distributed.copy_in(xs, group) @ ws, -1, group, parts)
        y.backward(dy)
        xw, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yw = xw @ ww
        yw.backward(dy)
        res[f"parts{parts}"] = {
            "value": (y - yw).abs().max().item(),
            "grad_x": (xs.grad - xw.grad).abs().max().item(),
            "grad_w": (ws.grad - ww.grad[:, mine]).abs().max().item()}
    return res


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
    elif job == "checkpoint":
        (out / f"checkpoint.r{rank}.json").write_text(json.dumps(checkpoint_round_trip(out, rank)))
    elif job == "layers":
        (out / f"layers.r{rank}.json").write_text(json.dumps(layer_checks(rank, world)))
    elif job == "collectives":
        (out / f"collectives.r{rank}.json").write_text(json.dumps(collective_checks(rank, world)))
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
