"""The port's data, tensor and sequence parallelism in real process groups
on the CPU, against the JAX package's mesh and the port's one process.

The ranks are worker processes (``tests/torch_dp_worker.py``: torch and the
port, no JAX) in a gloo group on loopback ``tcp://127.0.0.1`` at a free
port, one CPU thread each, started by ``subprocess`` with a timeout on every
``communicate``, as ``tests/test_distributed.py`` starts its JAX processes.
Each run is computed once per test session (``torch_oracle``):

- ``steps`` at world 2 (``W2_CASES``: ``clskd`` with ``spkd_gram_groups`` 1
  and 2 and with remat and the bn2 fold, two steps each;
  one step of ``mse`` and of pretraining in ``SDR+PMSQE``, with complex BN
  and in ``SI-SDR``) and at world 4 (``clskd`` with 1 and 4 groups, two
  steps), on white-noise global batches of 8 x 0.5 s at the tiny geometry;
  and tensor parallel (``TP_CASES``, at the JAX tensor-parallel tests'
  geometry, where the rule shards): ``clskd`` at ``data=1, model=2`` and
  ``data=2, model=2`` (two steps), one step of the block-config form, of
  bf16 ``clskd`` and of pretraining at ``1x2``, and of the DCCRNet family
  at ``2x2``.  Their gradients and states are gathered whole.
  Each is held against the port's one-process run on the global batch:
  every loss log of every step to ``LOSS_RTOL``, the gradient norm to
  ``NORM_RTOL``, each gradient of step 1 to ``GRAD_REL_L2`` or
  ``ROUNDING_FACTOR`` times its rounding floor, and each parameter and
  statistic after the last step to ``PARAM_REL_L2`` or that factor times
  its floor (the floor: the one-process run's largest move when the first
  input is rounded once more, over ``FLOOR_SEEDS``; this geometry's
  encoder gradients move by up to 4e-4; for a 2x2 case also the move of
  the same rows split over two data ranks alone, ``DATA_SPLIT``: at the
  tensor-parallel geometry that split moves the student's LSTM gradients
  by up to 1.24e-4, 7x their input-rounding floor).  After a single step each
  parameter is held to ``PARAM_ATOL`` beyond what Adam's first step makes
  of the two sides' gradients (it moves an element by about lr times the
  sign of its gradient, so rounding decides the near-zero ones).  Every
  rank holds the same state bits (under tensor parallelism: the whole
  leaves, the BN statistics and the ABF chains bit-identical across the
  model ranks, and the gathered slices).  Where the JAX trainer computes
  the same thing (``JAX_CASES``), its losses with ``MeshConfig(data=d,
  model=m)`` on the same weights (the student's and teacher's large
  leaves placed by the JAX rule, ``param_shardings``), the batch sharded
  over ``data``, are held to the JAX package's own DP and TP tolerance
  (``tests/test_parallel.py``: rtol 2e-4, atol 1e-5); the bf16 case to
  ``tests/test_torch_bf16.py``'s loss tolerance, which holds the port's
  one-process bf16 step against JAX's (the two round bf16 differently),
  with the JAX LSTM on its Pallas kernel in interpret mode as there.
  Each tensor-parallel rank holds 1/m of every leaf the rule shards and of
  its Adam moments, and something is sharded in every case.
- ``checkpoint`` at world 2: a ``model=2`` checkpoint restored at
  ``model=1`` and the reverse, bit for bit; ``collectives``: the gradients
  of ``copy_in`` and ``gather_out``; ``layers``: each layer that runs
  sharded (the complex conv and transpose conv, the complex dense, the
  complex LSTM with its projections, the real-LSTM cell, the dense) cut
  over two ranks against the whole layer, at widths the rule cuts (the
  step cases' geometry cuts only the LSTMs' ``w_ih`` and projections).
- ``sequence`` at world 4: ``sharded_utterance_forward`` against JAX's on
  a 4-device mesh of the virtual CPU devices (the offline forward's
  tolerance, ``tests/test_torch_dccrn.py``), and its interior against the
  port's offline forward (the JAX test's 0.02 relative RMS); a span of a
  bad length raises in every rank.
- ``mesh`` at world 4: ``make_mesh``'s layouts over the world.
- The ``distill`` and ``pretrain`` CLI at world 2 from torchrun's
  environment variables, one epoch each: one checkpoint, written by rank 0;
  ``distill`` again at ``mesh.model=2``, its bundle the whole student.

Exempt, as ``tests/test_torch_trainer.py`` says why: a conv bias in front of
a batch-statistics BN has a zero gradient in exact arithmetic (held to
``ZERO_GRAD`` of the norm on both sides), and Adam moves it, and the
running mean after it, by up to ``ADAM_STEP_BOUND`` a step on rounding
noise; an ABF bn2 bias's gradient sums cancelling terms and is held
against its bn2 scale's.  Under bf16 compute the conv's output is rounded
to bf16 before the BN, so such a bias's gradient is bf16 rounding noise
(measured up to 1.2e-3 of the norm) rather than zero, and it is held by
its floor as every other gradient.
"""

import contextlib
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import (
    DataConfig as JaxDataConfig,
    DCCRNConfig as JaxDCCRNConfig,
    DistillConfig as JaxDistillConfig,
    MeshConfig as JaxMeshConfig,
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.config import STFTConfig as JaxSTFTConfig
from speech_enhancement_clskd_tpu.models import make_model as jax_make_model
from speech_enhancement_clskd_tpu.parallel.mesh import batch_sharding, param_shardings, replicated
from speech_enhancement_clskd_tpu.parallel.sequence import (
    sharded_utterance_forward as jax_sharded_utterance_forward,
)
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu.train.pretrain import PretrainTrainer as JaxPretrainTrainer
from speech_enhancement_clskd_tpu.train.trainer import TrainState
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    pretrain_state_arrays,
    train_state_arrays,
)
from test_torch_bf16 import pallas_lstm
from torch_oracle import once_per_session, one_cpu_thread

import torch_dp_worker as worker

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(worker.__file__)
TIMEOUT = 300  # seconds a run of ranks may take
TP_W2 = ("tp_clskd_1x2", "tp_block_1x2", "tp_bf16_1x2", "tp_pretrain_1x2")
TP_W4 = ("tp_clskd_2x2", "tp_dccrnet_2x2")
TP_CASES = [(2, c) for c in TP_W2] + [(4, c) for c in TP_W4]
# each 2x2 case's rows split over two data ranks alone: the difference that
# data parallelism makes at that geometry joins the case's rounding floor
DATA_SPLIT = {"tp_clskd_2x2": "dp_tp_2x1", "tp_dccrnet_2x2": "dp_dccrnet_2x1"}
W2_CASES = ("clskd_g1", "clskd_g2", "clskd_remat_fold_g1", "mse", "pretrain", "pretrain_cbn",
            "pretrain_si_sdr")
W4_CASES = ("clskd_g1", "clskd_g4")
RUNS = [(2, c) for c in W2_CASES + TP_W2] + [(4, c) for c in W4_CASES + TP_W4]
# the gloo worlds, by (world, layout), each started once and run side by
# side: their cases and jobs
WORLDS = {"2": (2, W2_CASES, ()), "4": (4, W4_CASES, ("sequence", "mesh")),
          "2tp": (2, TP_W2 + tuple(DATA_SPLIT.values()), ("checkpoint", "collectives", "layers")),
          "4tp": (4, TP_W4, ())}
# the runs the JAX trainers compute alike (remat and the bn2 fold leave the
# step's arithmetic as it is, tests/test_torch_trainer.py; ``SI-SDR`` adds
# nothing the gather does not; off the TPU the JAX block gate is closed, so
# its block-config step is its default one, which the port's plain K5
# computes)
JAX_CASES = [(2, "clskd_g1"), (2, "clskd_g2"), (4, "clskd_g1"), (4, "clskd_g4"), (2, "mse"),
             (2, "pretrain"), (2, "pretrain_cbn")] + TP_CASES
LR = 6e-4
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
GRAD_REL_L2 = 1e-4
ROUNDING_FACTOR = 2.0
FLOOR_SEEDS = (7, 8, 9)
PARAM_REL_L2 = 1e-4
ZERO_GRAD = 1e-6
ADAM_STEP_BOUND = 3.2 * LR
ADAM_EPS = 1e-8
PARAM_ATOL = 1e-5  # beyond what the gradients give through Adam's first step
STAT_TOL = 1e-5  # relative to max(1, |reference|)
JAX_RTOL, JAX_ATOL = 2e-4, 1e-5
# tests/test_torch_bf16.py's LOSS_RTOL: the port's one-process bf16 step
# against JAX's (measured <= 7.3e-4 there)
JAX_BF16_RTOL = 5e-3
SEQ_ATOL = 1e-6  # tests/test_torch_dccrn.py's WAV_ATOL
SEQ_INTERIOR = 0.02
CLI_ARGS = ["data.synthetic=true", "data.synthetic_size=4", "data.segment=0.5",
            "data.batch_size=4", "teacher.kernel_num=[8,16,32]", "teacher.rnn_units=32",
            "student.kernel_num=[4,8,8]", "student.rnn_units=16", "keep_top_k=1",
            "max_epochs=1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT), **extra)
    return env


def _wait(procs):
    """Every process's output; each must exit 0 within ``TIMEOUT``."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _ranks(world, out, *jobs):
    """The worker's ``jobs`` in a gloo group of ``world`` ranks."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), port,
                               str(out), *jobs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(), cwd=ROOT)
             for r in range(world)]
    for r, text in enumerate(_wait(procs)):
        assert f"RANK_{r}_OK" in text, text[-4000:]


def _run_world(tmp_path_factory, key):
    """The ``steps`` of a world's cases (``WORLDS[key]``), every rank's
    arrays by case, and its jobs' results: the ``checkpoint`` and
    ``collectives`` records, the ``sequence`` spans and the ``mesh``
    layouts."""
    world, cases, jobs = WORLDS[key]
    out = tmp_path_factory.mktemp(f"dp{key}")
    _ranks(world, out, "steps=" + ",".join(cases), *jobs)
    res = {"steps": {c: [dict(np.load(out / f"{c}.r{r}.npz")) for r in range(world)]
                     for c in cases}}
    res.update({job: [json.loads((out / f"{job}.r{r}.json").read_text()) for r in range(world)]
                for job in ("checkpoint", "collectives", "layers") if job in jobs})
    if "sequence" in jobs:
        res["sequence"] = np.concatenate(
            [np.load(out / f"sequence.r{r}.npy") for r in range(world)], axis=1)
        res["mesh"] = [json.loads((out / f"mesh.r{r}.json").read_text()) for r in range(world)]
    return res


class _Lazy(dict):
    """``lazy[key]``: ``compute(key)``, computed once per session when a test
    first asks for it (``once_per_session``), so an xdist worker computes or
    loads only what its own tests read."""

    def __init__(self, tmp_path_factory, prefix, compute):
        super().__init__()
        self.tmp_path_factory, self.prefix, self.compute = tmp_path_factory, prefix, compute

    def __missing__(self, key):
        self[key] = once_per_session(self.tmp_path_factory, f"{self.prefix}.{key}",
                                     lambda: self.compute(key))
        return self[key]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Lazy(tmp_path_factory, "test_torch_distributed.worlds",
                 lambda key: _run_world(tmp_path_factory, key))


def _steps(worlds, world, case):
    """Every rank's arrays of ``case`` from the world that ran it."""
    key = next(k for k, (w, cases, _) in WORLDS.items() if w == world and case in cases)
    return worlds[key]["steps"][case]


def _rounding(seed):
    def rounded(x):
        up = np.random.default_rng(seed).random(x.shape) < 0.5
        return np.nextafter(x, np.where(up, np.inf, -np.inf).astype(np.float32))
    return rounded


def _reference(case):
    """The port's one-process run of ``case`` on the global batches, and
    the same run with the first input rounded once more, a seed each."""
    one = worker.one_process()
    ref = worker.run_steps(case, mesh=one)
    floors = [worker.run_steps(case, rounding=_rounding(s), mesh=one) for s in FLOOR_SEEDS]
    return ref, floors


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return _Lazy(tmp_path_factory, "test_torch_distributed.references", _reference)


def _bn_preceded_conv_bias(name, names):
    """``grad.``/``state.`` names of a conv bias a batch-statistics BN
    follows, and of the running mean after it."""
    m = re.fullmatch(r"(grad|state)\.(student|model)\.((enc|dec)\d+)_conv\.b[ri]", name)
    if m:
        return any(n.startswith(f"{m.group(1)}.{m.group(2)}.{m.group(3)}_bn.") for n in names)
    return re.fullmatch(r"state\.(student|model)\.(enc|dec)\d+_bn\.(mean|RM[ri])", name) is not None


@pytest.mark.parametrize("world, case", RUNS, ids=[f"w{w}-{c}" for w, c in RUNS])
def test_dp_step_matches_one_process(worlds, references, world, case):
    ranks = _steps(worlds, world, case)
    got, (want, floors) = ranks[0], references[case]
    if case in DATA_SPLIT:
        floors = floors + [_steps(worlds, 2, DATA_SPLIT[case])[0]]
    bf16 = worker.CASES[case].model.get("compute_dtype") == "bfloat16"
    assert {k for k in got if not k.startswith("shard.")} == set(want)
    for r in range(1, world):  # the ranks stay replicas, bit for bit
        for k, v in want.items():
            if k.startswith("state."):
                np.testing.assert_array_equal(ranks[r][k], got[k], err_msg=f"rank {r}: {k}")
    for k in want:
        if k.startswith("log.") and ".gn" not in k and "grad_norm" not in k:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got["log.1.grad_norm"], want["log.1.grad_norm"], rtol=NORM_RTOL)
    norm = float(want["log.1.grad_norm"])
    steps = worker.CASES[case][4]
    for k, w in want.items():
        if not (k.startswith(("grad.", "state.")) and np.issubdtype(w.dtype, np.floating)):
            continue
        if not bf16 and _bn_preceded_conv_bias(k, want):
            if k.startswith("grad."):
                assert np.abs(got[k]).max() <= ZERO_GRAD * norm, k
                assert np.abs(w).max() <= ZERO_GRAD * norm, k
            else:
                assert np.abs(got[k] - w).max() <= steps * ADAM_STEP_BOUND, k
            continue
        if k.startswith("state.") and steps == 1:
            g = "grad." + k[len("state."):]
            if g in want:  # a parameter: Adam's first step on each side's gradient
                moved = LR * (got[g] / (np.abs(got[g]) + ADAM_EPS)
                              - want[g] / (np.abs(want[g]) + ADAM_EPS))
                assert np.abs(got[k] - w + moved).max() <= PARAM_ATOL, k
            else:  # a running statistic
                assert np.all(np.abs(got[k] - w) <= STAT_TOL * np.maximum(1, np.abs(w))), k
            continue
        # an ABF bn2 bias's gradient sums cancelling terms: against its scale's
        ref = want[k[:-len("bias")] + "scale"] if k.startswith("grad.") and k.endswith(
            "bn2.bias") else w
        scale = max(float(np.linalg.norm(ref)), 1e-30)
        floor = max(np.linalg.norm(f[k] - w) for f in floors) / scale
        least = GRAD_REL_L2 if k.startswith("grad.") else PARAM_REL_L2
        tol = max(least, ROUNDING_FACTOR * floor)
        err = np.linalg.norm(got[k] - w) / scale
        assert err <= tol, (k, err, tol)


# ----------------------------------------------------------------- the JAX mesh


def _jax_model(fields, c):
    stft = dict(stft=JaxSTFTConfig(window="sqrthann")) if fields.get("family") == "dccrnet" else {}
    return JaxDCCRNConfig(**fields, **stft, **c.model)


def _jax_cfg(case, world):
    c = worker.CASES[case]
    teacher, student = worker.GEOMETRIES[c.geometry]
    data = JaxDataConfig(synthetic=True, synthetic_size=2 * worker.BATCH,
                         segment=worker.SAMPLES / 16000, batch_size=worker.BATCH)
    d, m = c.mesh
    mesh = JaxMeshConfig(data=world // m if d == -1 else d, model=m)
    if c.kind == "pretrain":
        return JaxTrainConfig(teacher=_jax_model(teacher, c), data=data, loss_mode=c.mode,
                              mesh=mesh)
    return JaxTrainConfig(teacher=_jax_model(teacher, c), student=_jax_model(student, c),
                          data=data, distill=JaxDistillConfig(strategy=c.mode, **c.distill),
                          mesh=mesh)


def _jax_losses(key):
    """The JAX trainer's losses with ``MeshConfig(data=d, model=m)`` of the
    case's layout over ``world`` devices, from the port's seeded weights
    (replicated, the student's and teacher's placed by the JAX rule as
    its ``init_state`` places them) on the batches sharded over ``data``;
    a bf16 case with the JAX LSTM on its Pallas kernel in interpret mode."""
    world, case = key.split(":")
    world = int(world)
    t = worker.trainer(case, mesh=worker.one_process())
    cfg = _jax_cfg(case, world)
    with (pallas_lstm() if cfg.teacher.compute_dtype == "bfloat16" else contextlib.nullcontext()):
        if worker.CASES[case].kind == "pretrain":
            jt = JaxPretrainTrainer(cfg)
            a = jax.tree.map(jnp.asarray, pretrain_state_arrays(t))
            state = {"step": a["step"], "params": a["params"], "batch_stats": a["batch_stats"],
                     "opt_state": jt.tx.init(a["params"])}
            state = jax.device_put(state, replicated(jt.mesh))
            state["params"] = jax.device_put(state["params"],
                                             param_shardings(state["params"], jt.mesh))
        else:
            jt = JaxTrainer(cfg)
            a = {k: jax.tree.map(jnp.asarray, v) for k, v in train_state_arrays(t).items()}
            trainable = jt._trainable_of(a["student_params"], a.get("abf_enc_params"),
                                         a.get("abf_dec_params"))
            state = TrainState(step=jnp.zeros((), jnp.int32), opt_state=jt.tx.init(trainable),
                               rng=jax.random.PRNGKey(0), **a)
            state = jax.device_put(state, replicated(jt.mesh))
            state = dataclasses.replace(state, **{
                k: jax.device_put(getattr(state, k), param_shardings(getattr(state, k), jt.mesh))
                for k in ("student_params", "teacher_params")})
        assert jt.mesh.shape == {"data": cfg.mesh.data, "model": cfg.mesh.model}
        losses = []
        for mix, clean in worker.batches(worker.CASES[case].steps):
            bs = batch_sharding(jt.mesh)
            state, logs = jt.train_step(state, jax.device_put(jnp.asarray(mix), bs),
                                        jax.device_put(jnp.asarray(clean), bs))
            losses.append(float(logs["train_loss"]))
    return losses


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    return _Lazy(tmp_path_factory, "test_torch_distributed.jax", _jax_losses)


@pytest.mark.parametrize("world, case", JAX_CASES, ids=[f"w{w}-{c}" for w, c in JAX_CASES])
def test_dp_losses_match_jax_mesh(worlds, jax_losses, world, case):
    got = _steps(worlds, world, case)[0]
    port = [float(got[f"log.{k}.train_loss"]) for k in range(1, worker.CASES[case].steps + 1)]
    rtol = JAX_BF16_RTOL if worker.CASES[case].model.get("compute_dtype") else JAX_RTOL
    np.testing.assert_allclose(port, jax_losses[f"{world}:{case}"], rtol=rtol, atol=JAX_ATOL)


# ---------------------------------------------------------- tensor parallelism


@pytest.mark.parametrize("world, case", TP_CASES, ids=[f"w{w}-{c}" for w, c in TP_CASES])
def test_tp_ranks_hold_their_slices(worlds, world, case):
    """Something is sharded, and every rank holds 1/m of each leaf the rule
    shards and of its Adam moments (a frozen teacher has none)."""
    m = worker.CASES[case].mesh[1]
    for r, got in enumerate(_steps(worlds, world, case)):
        shards = {k: v for k, v in got.items() if k.startswith("shard.")}
        assert shards, f"rank {r}: nothing sharded"
        for k, (here, whole, *moments) in shards.items():
            assert here * m == whole, (r, k, here, whole)
            trained = not k.startswith("shard.teacher.")
            assert moments == ([here, here] if trained else [0, 0]), (r, k, moments)


def test_tp_checkpoint_round_trip(worlds):
    """A checkpoint written at ``model=2`` restores at ``model=1`` bit for
    bit, and the reverse (``torch_dp_worker.checkpoint_round_trip``)."""
    for r, res in enumerate(worlds["2tp"]["checkpoint"]):
        assert res == {"model2_to_model1": True, "model1_to_model2": True, "sharded": True,
                       "step": 2}, (r, res)


# a layer cut over two ranks against the whole layer: the outputs (measured
# equal) and the gradients (two partial sums added, measured <= 1.8e-6 of the
# largest element), relative to the largest whole value
TP_LAYER_OUT = 1e-6
TP_LAYER_GRAD = 1e-5
TP_LAYERS = ("enc0_conv", "dec0_conv", "rnn_linear", "clstm1", "LSTMCell_0", "lstm_proj")


@pytest.mark.parametrize("layer", TP_LAYERS)
def test_tp_layer_matches_whole(worlds, layer):
    """``torch_dp_worker.layer_checks``: the layer's leaves the rule cuts
    are cut, and its outputs and gradients are the whole layer's."""
    for r, res in enumerate(worlds["2tp"]["layers"]):
        assert any(n.startswith(layer + ".") for n in res["shards"]), (r, res["shards"])
        got = res[layer]
        assert got["shapes"] and got["out"] <= TP_LAYER_OUT, (r, got)
        assert max(got["grad_in"], got["grad_params"]) <= TP_LAYER_GRAD, (r, got)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_tp_collectives_gradients(worlds, parts):
    """``gather_out(copy_in(x) @ W_rank)`` over two ranks is the product
    with the whole weight; the input's gradient is the whole product's
    (summed over the ranks), each rank's weight gradient its slice of the
    whole one's (not summed).  float64: only the sums' order may differ."""
    for r, res in enumerate(worlds["2tp"]["collectives"]):
        got = res[f"parts{parts}"]
        assert got["value"] == 0.0 and got["grad_w"] == 0.0, (r, got)
        assert got["grad_x"] <= 1e-13, (r, got)


# ------------------------------------------------------------ sequence parallel


def _jax_sequence():
    model = jax_make_model(JaxDCCRNConfig(**worker.SEQ_CFG))
    variables = flax_from_torch_state(worker.sequence_model().state_dict())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
    return np.asarray(jax_sharded_utterance_forward(
        model, variables, jnp.asarray(worker.sequence_signal()), mesh, "data"))


def test_sequence_parallel_matches_jax(worlds, tmp_path_factory):
    want = once_per_session(tmp_path_factory, "test_torch_distributed.jax_sequence",
                            _jax_sequence)
    got = worlds["4"]["sequence"]
    assert got.shape == want.shape == (2, worker.SEQ_SAMPLES)
    np.testing.assert_allclose(got, want, atol=SEQ_ATOL)


def test_sequence_parallel_interior_matches_offline(worlds):
    got = worlds["4"]["sequence"]
    with torch.no_grad():
        offline = worker.sequence_model()(torch.from_numpy(worker.sequence_signal()),
                                          training=False).wav.numpy()
    a, b = offline[:, 8000:-8000], got[:, 8000:-8000]
    err = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2))
    assert err < SEQ_INTERIOR, err


def test_make_mesh_over_the_world(worlds):
    want = {"-1x1": {"data": 4, "model": 1}, "-1x2": {"data": 2, "model": 2},
            "2x2": {"data": 2, "model": 2}}
    assert worlds["4"]["mesh"] == [want] * 4


# ------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("command", ["distill", "pretrain"])
def test_cli_trains_data_parallel_from_torchrun_env(tmp_path, command):
    """Two ranks of ``python -m speech_enhancement_clskd_tpu_torch COMMAND
    --device cpu`` with torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and no
    argument of the group's: one epoch of one step at a global batch of 4,
    validated; rank 0 alone prints the result and writes the checkpoint
    (one), the metrics and the bundle."""
    out = tmp_path / "run"
    port = str(_free_port())
    args = [sys.executable, "-m", "speech_enhancement_clskd_tpu_torch", command,
            "--device", "cpu", "--out", str(out)]
    args += ["--strategy", "clskd"] if command == "distill" else ["--model", "teacher"]
    procs = [subprocess.Popen(args + CLI_ARGS, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                              env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                       WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    outs = _wait(procs)
    results = [[json.loads(line) for line in text.splitlines() if line.startswith("{")]
               for text in outs]
    assert [len(r) for r in results] == [1, 0], outs
    bundle = results[0][0]["bundle"]
    assert Path(bundle).is_file()
    assert bundle.endswith("the_best_model.npz" if command == "distill" else "teacher_model.npz")
    steps = sorted(p.name for p in out.glob("step_*"))
    assert steps == ["step_00000001"], steps
    assert list(json.loads((out / "index.json").read_text())["scores"]) == ["1"]
    if command == "distill":
        lines = (out / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["scope"] == "val", lines


TP_CLI_ARGS = ["mesh.data=1", "mesh.model=2", "teacher.rnn_units=64",
               "student.kernel_num=[4,8,16]", "student.rnn_units=32"]


def test_cli_trains_tensor_parallel_from_torchrun_env(tmp_path):
    """``distill --device cpu`` on two ranks from torchrun's variables at
    ``mesh.model=2`` (the rule shards the student's and the teacher's LSTM
    input weights at this geometry): rank 0 alone prints and writes one
    checkpoint and the bundle, which hold the whole student (the shapes of
    a one-process student's, which loads the bundle strictly)."""
    from speech_enhancement_clskd_tpu_torch.config import load_config
    from speech_enhancement_clskd_tpu_torch.models.dccrn import build_model
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    out = tmp_path / "run"
    port = str(_free_port())
    args = [sys.executable, "-m", "speech_enhancement_clskd_tpu_torch", "distill",
            "--device", "cpu", "--out", str(out), "--strategy", "clskd"]
    procs = [subprocess.Popen(args + CLI_ARGS + TP_CLI_ARGS, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                              env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                       WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    outs = _wait(procs)
    results = [[json.loads(line) for line in text.splitlines() if line.startswith("{")]
               for text in outs]
    assert [len(r) for r in results] == [1, 0], outs
    assert sorted(p.name for p in out.glob("step_*")) == ["step_00000001"]
    cfg = load_config(None, CLI_ARGS + TP_CLI_ARGS)
    whole = build_model(cfg.student)
    _, variables, _ = load_bundle(results[0][0]["bundle"])
    whole.load_state_dict(torch_state_from_flax(variables), strict=True)
    ckpt = torch.load(out / "step_00000001" / "state.pt", weights_only=True)
    for part, model in (("student", whole), ("teacher", build_model(cfg.teacher))):
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in ckpt["modules"][part].items()} == shapes, part
