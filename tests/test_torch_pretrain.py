"""Standalone pretraining in the port (``train/pretrain.py``, the
``pretrain`` CLI) on the CPU against the JAX ``PretrainTrainer``.

- Three steps of the port's ``PretrainTrainer`` against three of the JAX
  ``PretrainTrainer.train_step``, each step of both from the JAX state
  before it (weights, BN statistics, Adam's moments and count carried into
  the port by ``utils.bridge`` and ``_sync``; at step 1 the port's seeded
  weights and a fresh Adam on both sides), at
  ``tests/test_torch_trainer.py``'s tiny teacher (kernels (8, 16, 32), rnn
  32) on 4 clips of 0.5 s, for the default ``SDR+PMSQE``, ``SI-SNR+LMS``
  (the mel term on the model's spectrum), complex BN with the real-LSTM
  bottleneck, and the asteroid DCCRNet family.  The JAX steps are jitted
  once per session (``torch_oracle``).  Every step's loss is held to
  ``LOSS_RTOL`` and its gradient norm to ``GRAD_REL_L2``; the parameters
  after each step to ``PARAM_ATOL`` and the BN statistics to ``STAT_TOL``;
  step 1's gradients (JAX's read from Adam's first moment, 0.1 g) by
  relative L2 against their rounding floor.  A conv bias in front of a
  batch-statistics BN has a zero gradient in exact arithmetic: its
  rounding noise is held to ``ZERO_GRAD`` of the norm, the bias after the
  step to Adam's bound, and the running mean it feeds to that bound too.
- ``validate`` against the JAX ``validate`` on the same weights.
- The round trip of a pretraining state (``load_pretrain_state``,
  ``pretrain_state_arrays``), a checkpoint restore, the datasets'
  ``synthetic_profile``, a bf16 step.
- The ``pretrain`` CLI end to end on ``--device cpu``: its bundle loads
  through ``load_bundle`` and feeds ``distill --teacher-bundle``.
"""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import (
    DataConfig as JaxDataConfig,
    DCCRNConfig as JaxDCCRNConfig,
    MeshConfig,
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.train.pretrain import PretrainTrainer as JaxPretrainTrainer
from speech_enhancement_clskd_tpu_torch import cli
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    STFTConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer
from speech_enhancement_clskd_tpu_torch.utils import serialization as ser
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    load_pretrain_state,
    pretrain_state_arrays,
    torch_state_from_flax,
    trainer_parts,
)
from torch_oracle import once_per_session, one_cpu_thread

STEPS = 3
LR, B1 = 6e-4, 0.9
LOG_KEYS = ("train_loss", "grad_norm")
# each step at the same point: float32 both sides, sums in another order
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ROUNDING_FACTOR = 2.0
# the rounding floor: each side's largest move over this many roundings
FLOOR_SEEDS = (7, 8, 9)
ZERO_GRAD = 1e-6
# after one Adam update from the same point
PARAM_ATOL = 2e-4
STAT_TOL = 2e-4  # relative to max(1, |reference|)
# Adam moves a parameter by at most (1 - b1) / sqrt(1 - b2) ~ 3.2 lr a step
ADAM_STEP_BOUND = 3.2 * LR
VAL_RTOL = 1e-4

TINY = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
DATA = dict(synthetic=True, synthetic_size=8, segment=0.5, batch_size=4)
CASES = {
    "sdr_pmsqe": ({}, "SDR+PMSQE"),
    "si_snr_lms": ({}, "SI-SNR+LMS"),
    "cbn_real_lstm": (dict(use_cbn=True, use_clstm=False), "SDR+PMSQE"),
    # the JAX trainer builds the mel bases for every mode, and they take no
    # sqrthann: the family's serving window is its own filterbank's anyway
    "dccrnet": (dict(family="dccrnet"), "SDR+PMSQE"),
}
TINY_ARGS = ["data.synthetic=true", "data.synthetic_size=4", "data.segment=0.5",
             "data.batch_size=4", "teacher.kernel_num=[8,16,32]", "teacher.rnn_units=32",
             "student.kernel_num=[4,8,8]", "student.rnn_units=16", "keep_top_k=1",
             "max_epochs=1"]


def _model_kw(case):
    return {**TINY, **CASES[case][0]}


def _cfg(case, **fields):
    return TrainConfig(teacher=DCCRNConfig(**_model_kw(case)), data=DataConfig(**DATA),
                       loss_mode=CASES[case][1], **fields)


def _jax_cfg(case):
    return JaxTrainConfig(teacher=JaxDCCRNConfig(**_model_kw(case)),
                          data=JaxDataConfig(**DATA), loss_mode=CASES[case][1],
                          mesh=MeshConfig(data=1, model=1), max_epochs=1, log_every=1000)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        clean = (0.1 * rng.standard_normal((4, 8000))).astype(np.float32)
        out.append((clean + (0.05 * rng.standard_normal((4, 8000))).astype(np.float32), clean))
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v)


def _jax_state(jt, trainer):
    """The JAX pretraining state on the port's weights, a fresh Adam."""
    arrays = jax.tree.map(jnp.asarray, pretrain_state_arrays(trainer))
    return {"step": jnp.asarray(arrays["step"]), "params": arrays["params"],
            "batch_stats": arrays["batch_stats"], "opt_state": jt.tx.init(arrays["params"])}


def _sync(trainer, state):
    """The JAX state into the port trainer: weights, statistics, step, and
    Adam's moments and count (optax's ``mu``/``nu`` as torch Adam's
    ``exp_avg``/``exp_avg_sq``)."""
    host = jax.tree.map(np.array, state)
    load_pretrain_state(trainer, host)
    adam = host["opt_state"][0]
    if int(adam.count) == 0:
        return
    mu = torch_state_from_flax({"params": adam.mu})
    nu = torch_state_from_flax({"params": adam.nu})
    for name, p in trainer.model.named_parameters():
        trainer.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                      "exp_avg": mu[name].clone(),
                                      "exp_avg_sq": nu[name].clone()}


def _port_grads(trainer):
    return dict(_leaves(flax_from_torch_state(
        {n: p.grad for n, p in trainer.model.named_parameters()})["params"]))


def _jax_grads(jt, state, mix, clean):
    """The gradients of the JAX step at ``state`` (a fresh Adam) on
    ``mix``: the step taken on a copy of the state, whose Adam first moment
    is then 0.1 g."""
    copy = jax.tree.map(lambda a: jnp.array(a, copy=True), state)  # the step donates
    copy, _ = jt.train_step(copy, jnp.asarray(mix), jnp.asarray(clean))
    return {p: m / (1 - B1) for p, m in _leaves(jax.tree.map(np.array, copy["opt_state"][0].mu))}


def rounded(x, seed):
    """``x`` rounded once more: each element moved to a float32 neighbour,
    up or down at random.  (A uniform scaling, 1 + 2^-23, moves nothing
    here: the BN after the first conv and the scale-invariant losses take
    it out.)"""
    up = np.random.default_rng(seed).random(x.shape) < 0.5
    return np.nextafter(x, np.where(up, np.inf, -np.inf).astype(np.float32))


def _floors(jt, state, mix, clean, again):
    """Each side's gradients at step 1 with its weights and its input each
    rounded once more (``rounded``), over ``FLOOR_SEEDS``."""
    floors = {"jax": [], "port": []}
    for seed in FLOOR_SEEDS:
        leaves, tree = jax.tree.flatten(state["params"])
        moved = {**state, "params": jax.tree.unflatten(tree, [
            jnp.asarray(rounded(np.array(a), seed + i)) for i, a in enumerate(leaves)])}
        _sync(again, moved)
        again.train_step(rounded(mix, seed), clean)
        floors["port"].append(_port_grads(again))
        floors["jax"].append(_jax_grads(jt, moved, rounded(mix, seed), clean))
    return floors


def _run(case):
    """``STEPS`` steps, each of both trainers from the JAX state before it
    (``_sync``): per step the logs and the parameters and statistics after
    it; at step 1 the gradients of both and their rounding floors
    (``_floors``)."""
    trainer = PretrainTrainer(_cfg(case), device="cpu").init_state()
    jt = JaxPretrainTrainer(_jax_cfg(case))
    state = _jax_state(jt, trainer)
    steps = []
    for k, (mix, clean) in enumerate(_batches(), start=1):
        snap = {}
        if k == 1:
            again = PretrainTrainer(_cfg(case), device="cpu").init_state()
            snap["floors"] = _floors(jt, state, mix, clean, again)
        _sync(trainer, state)
        state, jlogs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
        logs = trainer.train_step(mix, clean)
        if k == 1:  # Adam's first moment after its first step is 0.1 g
            snap["jax_grads"] = {p: m / (1 - B1) for p, m in _leaves(
                jax.tree.map(np.array, state["opt_state"][0].mu))}
            snap["port_grads"] = _port_grads(trainer)
        port = pretrain_state_arrays(trainer)
        snap.update({
            "jax_logs": {n: float(v) for n, v in jlogs.items()},
            "port_logs": {n: float(v) for n, v in logs.items()},
            "jax": {c: dict(_leaves(jax.tree.map(np.asarray, state[c])))
                    for c in ("params", "batch_stats")},
            "port": {c: dict(_leaves(port[c])) for c in ("params", "batch_stats")},
            "step": (int(state["step"]), trainer.step)})
        steps.append(snap)
    return steps


class _Runs(dict):
    """``runs[case]``: ``_run(case)``, computed once per session when a test
    first asks for it (``once_per_session``), so an xdist worker computes or
    loads only the cases of its own tests."""

    def __init__(self, tmp_path_factory):
        super().__init__()
        self.tmp_path_factory = tmp_path_factory

    def __missing__(self, case):
        self[case] = once_per_session(self.tmp_path_factory, f"test_torch_pretrain.runs.{case}",
                                      lambda: _run(case))
        return self[case]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory)


def _bn_preceded_conv_bias(path, params):
    m = re.fullmatch(r"(enc|dec)(\d+)_conv", path[0])
    return (m is not None and path[-1] in ("br", "bi")
            and any(p[0] == f"{m.group(1)}{m.group(2)}_bn" for p in params))


CHECKS = [(case, step) for case in CASES for step in range(1, STEPS + 1)]


@pytest.mark.parametrize("case, step", CHECKS)
def test_step_logs_match_jax(runs, case, step):
    """The loss to ``LOSS_RTOL``; the gradient norm, a function of the
    gradients, as they are held."""
    snap = runs[case][step - 1]
    assert snap["step"] == (step, step)
    got, want = snap["port_logs"], snap["jax_logs"]
    assert set(got) == set(want) == set(LOG_KEYS)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_REL_L2)


@pytest.mark.parametrize("case", list(CASES))
def test_step_gradients_match_jax(runs, case):
    """Step 1's gradients, where both sides start alike: each to
    ``GRAD_REL_L2``, or where above to ``ROUNDING_FACTOR`` times its
    rounding floor, the largest move of either side's own gradient under
    one more rounding of the weights and the input (``_floors``).  A PReLU
    slope's gradient is one sum over a map whose terms cancel: under
    ``SI-SNR+LMS`` it read 1.65e-4 from JAX against a floor of 1.1e-4.  The
    zero gradients of the conv biases in front of a batch-statistics BN are
    held to ``ZERO_GRAD`` of the norm.  Later steps are held by their
    losses and updates: at step 2 of ``SDR+PMSQE`` the JAX step's own
    gradient parts from a separately jitted ``jax.grad`` of the same loss
    at the same point by 2.2e-3 on a BN bias (the port's from the latter by
    1.7e-5), so JAX's gradient there is fixed no better than that."""
    snap = runs[case][0]
    norm = snap["jax_logs"]["grad_norm"]
    assert snap["port_grads"].keys() == snap["jax_grads"].keys()
    for path, want in snap["jax_grads"].items():
        got = snap["port_grads"][path]
        if _bn_preceded_conv_bias(path, snap["jax_grads"]):
            assert np.abs(got).max() <= ZERO_GRAD * norm, path
            assert np.abs(want).max() <= ZERO_GRAD * norm, path
            continue
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        floor = max([np.linalg.norm(f[path] - got) for f in snap["floors"]["port"]]
                    + [np.linalg.norm(f[path] - want) for f in snap["floors"]["jax"]])
        floor /= np.linalg.norm(want)
        assert err <= max(GRAD_REL_L2, ROUNDING_FACTOR * floor), (path, err, floor)


@pytest.mark.parametrize("case, step", CHECKS)
def test_step_parameters_and_statistics_match_jax(runs, case, step):
    """After the step: each parameter to ``PARAM_ATOL`` (a conv bias in
    front of a batch-statistics BN, moved by Adam on rounding noise, to
    Adam's bound on each side); each BN statistic to ``STAT_TOL`` of
    max(1, |reference|), a running mean that adds such a bias in plus that
    bound."""
    snap = runs[case][step - 1]
    params = snap["jax"]["params"]
    assert snap["port"]["params"].keys() == params.keys()
    for path, want in params.items():
        diff = np.abs(snap["port"]["params"][path] - want).max()
        tol = 2 * ADAM_STEP_BOUND if _bn_preceded_conv_bias(path, params) else PARAM_ATOL
        assert diff <= tol, (path, diff)
    stats = snap["jax"]["batch_stats"]
    assert snap["port"]["batch_stats"].keys() == stats.keys()
    for path, want in stats.items():
        err = np.abs(snap["port"]["batch_stats"][path] - want).max() / max(1.0, np.abs(want).max())
        tol = STAT_TOL + (2 * ADAM_STEP_BOUND if path[-1] in ("mean", "RMr", "RMi") else 0.0)
        assert err <= tol, (path, err)


def _validate_both():
    trainer = PretrainTrainer(_cfg("sdr_pmsqe"), device="cpu").init_state(4)
    jt = JaxPretrainTrainer(_jax_cfg("sdr_pmsqe"))
    val = trainer.make_datasets()[1]
    return {"port": trainer.validate(val), "jax": jt.validate(_jax_state(jt, trainer), val)}


def test_validate_matches_jax(tmp_path_factory):
    both = once_per_session(tmp_path_factory, "test_torch_pretrain.validate", _validate_both)
    assert set(both["port"]) == set(both["jax"]) == {"si_sdr", "stoi"}
    for key, want in both["jax"].items():
        np.testing.assert_allclose(both["port"][key], want, rtol=VAL_RTOL, err_msg=key)


def test_pretrain_state_round_trip_and_checkpoint_restore(tmp_path):
    """A pretraining state goes into a trainer and comes back exactly; a
    checkpoint of a ``PretrainTrainer`` (its one part, ``model``) restores
    its weights, statistics, Adam state and counters bit for bit."""
    trainer = PretrainTrainer(_cfg("cbn_real_lstm"), device="cpu").init_state()
    assert trainer_parts(trainer) == ("model",)
    mix, clean = _batches()[0]
    trainer.train_step(mix, clean)
    arrays = pretrain_state_arrays(trainer)
    other = PretrainTrainer(_cfg("cbn_real_lstm"), device="cpu").init_state(9)
    load_pretrain_state(other, {**arrays, "opt_state": None})
    assert other.step == trainer.step == 1 and not other.optimizer.state
    again = pretrain_state_arrays(other)
    for coll in ("params", "batch_stats"):
        for path, want in _leaves(arrays[coll]):
            np.testing.assert_array_equal(dict(_leaves(again[coll]))[path], want)

    mgr = ser.CheckpointManager(str(tmp_path), keep_top_k=1)
    assert mgr.save(trainer, {"stoi": 0.5})
    restored = mgr.restore(PretrainTrainer(_cfg("cbn_real_lstm"), device="cpu").init_state(9))
    assert (restored.step, restored.epoch) == (trainer.step, trainer.epoch)
    want = trainer.model.state_dict()
    got = restored.model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert restored.optimizer.state_dict()["state"].keys() == \
        trainer.optimizer.state_dict()["state"].keys()


def test_dccrnet_preset_pretrains():
    """The DCCRNet family with its presets' sqrthann window (which the mel
    bases cannot take) pretrains in ``SDR+PMSQE``, the mode that reads no
    mel term; a ``*+LMS`` mode with it raises, as the JAX trainer does."""
    teacher = DCCRNConfig(**TINY, family="dccrnet", stft=STFTConfig(window="sqrthann"))
    cfg = TrainConfig(teacher=teacher, data=DataConfig(**DATA))
    trainer = PretrainTrainer(cfg, device="cpu").init_state()
    mix, clean = _batches()[0]
    assert all(torch.isfinite(v) for v in trainer.train_step(mix, clean).values())
    with pytest.raises(ValueError, match="sqrthann"):
        PretrainTrainer(TrainConfig(teacher=teacher, loss_mode="SDR+LMS"), device="cpu")


def test_make_datasets_honours_the_synthetic_profile():
    trainer = PretrainTrainer(TrainConfig(teacher=DCCRNConfig(**TINY), data=DataConfig(
        **DATA, synthetic_profile="hard")), device="cpu")
    train, val = trainer.make_datasets()
    assert train.profile == val.profile == "hard"
    assert (len(train), len(val)) == (8, 8)


def test_bf16_step_is_finite_with_a_float32_loss():
    """A bf16 model pretrains: the loss float32 and finite, the parameters
    float32, as the distillation step's bf16 does."""
    cfg = _cfg("sdr_pmsqe")
    cfg = TrainConfig(teacher=DCCRNConfig(**TINY, compute_dtype="bfloat16"),
                      data=cfg.data, loss_mode=cfg.loss_mode)
    trainer = PretrainTrainer(cfg, device="cpu").init_state()
    mix, clean = _batches()[0]
    logs = trainer.train_step(mix, clean)
    assert logs["train_loss"].dtype == torch.float32
    assert all(torch.isfinite(v) for v in logs.values())
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_pretrain_cli_feeds_distill(tmp_path, capsys):
    """``pretrain --model teacher`` on the CPU writes the teacher's bundle
    (its history and loss mode among the infos), which ``load_bundle``
    reads into a model that serves the trainer's final weights, and which
    ``distill --teacher-bundle`` takes."""
    out = str(tmp_path / "pre")
    assert cli.main(["pretrain", "--model", "teacher", "--device", "cpu", "--out", out,
                     *TINY_ARGS, "log_every=1"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["bundle"] == f"{out}/teacher_model.npz"
    assert set(last["final_metrics"]) >= {"si_sdr", "stoi", "epoch_time_s"}
    mcfg, variables, meta = ser.load_bundle(last["bundle"])
    assert mcfg.kernel_num == (8, 16, 32) and meta["infos"]["loss_mode"] == "SDR+PMSQE"
    assert meta["infos"]["history"] == last["final_metrics"]
    assert ser.CheckpointManager(out).best_step() == 1
    run = str(tmp_path / "run")
    assert cli.main(["distill", "--strategy", "clskd", "--teacher-bundle", last["bundle"],
                     "--device", "cpu", "--out", run, *TINY_ARGS]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["bundle"] == \
        f"{run}/the_best_model.npz"


def test_pretrain_cli_student_and_refusals(tmp_path):
    """``--model student`` pretrains the student's geometry; ``--device
    cuda`` without a card raises, as every entry point does."""
    out = str(tmp_path / "student")
    assert cli.main(["pretrain", "--model", "student", "--device", "cpu", "--out", out,
                     *TINY_ARGS, "loss_mode=SI-SNR"]) == 0
    mcfg, _, meta = ser.load_bundle(f"{out}/student_model.npz")
    assert mcfg.kernel_num == (4, 8, 8) and meta["infos"]["loss_mode"] == "SI-SNR"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["pretrain", "--out", str(tmp_path / "x"), *TINY_ARGS])


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("teacher", [{}, dict(use_cbn=True, use_clstm=False)],
                         ids=["default", "cbn_real_lstm"])
def test_chip_smoke_pretraining_check_rehearsed_on_the_cpu(smoke, teacher):
    """chip_smoke.py phase 25's card-vs-CPU step (``card_vs_cpu_checks``
    with ``pretrain``) at tiny widths, the CPU in the card's
    place: nothing fails, and the zero gradients of the conv biases in
    front of a BN, real or complex, are the exempt ones."""
    cfg = smoke.train_config(4, 0.5, teacher=DCCRNConfig(**TINY, **teacher))
    rec = smoke.card_vs_cpu_checks(cfg, "cpu", rounding_floor=True, own_floor=True,
                                   pretrain=True, floor_seeds=smoke.FLOOR_SEEDS)
    assert rec["failures"] == []
    step = rec["gaussian"]["steps"][0]
    assert step["loss_rel_err"] == 0.0 and step["grad_worst"].startswith("model.")
    assert not re.fullmatch(r"model\.(enc|dec)\d_conv\.b[ri]", step["grad_worst"])


def test_chip_smoke_pretrain_cli_rehearsed_on_the_cpu(smoke, tmp_path):
    """chip_smoke.py phase 25's CLI chain at tiny widths on the CPU:
    ``pretrain``, ``distill --teacher-bundle``, ``evaluate`` twice."""
    rec = smoke.pretrain_cli_checks(str(tmp_path), "cpu", TINY_ARGS, compute_pesq=False)
    assert rec["failures"] == [] and rec["loss_mode"] == "SDR+PMSQE"
    assert rec["model"] == TrainConfig().teacher.name  # the CLI's default teacher, narrowed
