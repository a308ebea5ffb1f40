"""CLSKD training of the asteroid DCCRNet family in the port, on the CPU
against the JAX package, at the tiny geometry of the JAX package's own test
of it (``tests/test_dccrnet_asteroid.py``: teacher kernels (8, 16, 16) and
rnn 32, student (4, 8, 8) and rnn 16, 4 clips of 0.5 s).

- The train-mode forward (BN on batch statistics, the running statistics
  moved) and the bf16 forward (running and batch statistics; the JAX LSTM
  on its Pallas kernel in interpret mode, the TPU path, as
  ``tests/test_torch_bf16.py`` runs it) against the JAX forwards on one set
  of weights, the JAX side once per session (the float32 forward jitted,
  the bf16 one op by op), and a bf16 DCCRNet serving by streaming.
- Two ``clskd`` steps of the port's ``Trainer`` against the JAX
  ``Trainer``'s from one state (the port's seeded weights, so no JAX
  initialization compiles): logs, gradients, parameters and BN statistics,
  held as ``tests/test_torch_trainer.py`` holds its steps (its helpers and
  tolerances).  One JAX step compile, once per session.
- The one-frame time gather of the ABF fuse (the DCCRNet taps shrink a
  frame a layer, so each residual is one frame short of the next map) and
  its backward against the JAX ``_nearest_axis``.
- ``reviewkd`` raises where the JAX step raises: the ABF chains' output
  widths are the JAX trainer's family-blind ones, so the fused decoder maps
  and the teacher's decoder taps differ in channels, and HCL subtracts them.
- ``spkd``, ``mse`` and ``stft`` take a finite step on the family.
- The CLI loop (``import-torch``, ``distill --teacher-bundle``,
  ``evaluate``, streaming the bundle) and chip_smoke.py's phase 24 checks,
  rehearsed on the CPU.
"""

import dataclasses
import importlib.util
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
    MeshConfig,
    STFTConfig as JaxSTFTConfig,
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.distill.abf import _nearest_axis as jax_nearest_axis
from speech_enhancement_clskd_tpu.models import dccrnet as jax_dccrnet
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    DistillConfig,
    STFTConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.distill.abf import _nearest_axis
from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
from speech_enhancement_clskd_tpu_torch.models import dccrnet
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer, log_keys, tap_channels
from speech_enhancement_clskd_tpu_torch.utils.bridge import load_train_state, torch_state_from_flax
from test_torch_bf16 import pallas_lstm
from test_torch_dccrnet import _tiny_variables
from test_torch_trainer import (
    B1,
    DRIFT_LOG_RTOL,
    LOG_RTOL,
    STAT_TOL,
    _check_gradients,
    _check_parameters,
    _check_statistics,
    _flat,
    _jax_state,
    _snapshot,
)
from torch_oracle import once_per_session, one_cpu_thread

BF16 = "bfloat16"
TINY_T = dict(name="tiny-teacher", family="dccrnet", kernel_num=(8, 16, 16), rnn_units=32)
TINY_S = dict(name="tiny-student", family="dccrnet", kernel_num=(4, 8, 8), rnn_units=16)
DATA = dict(synthetic=True, synthetic_size=4, segment=0.5, batch_size=4)
# the clskd steps, held with tests/test_torch_trainer.py's tolerances;
# measured: the logs 2.0e-6 after step 1 and 2.4e-5 after step 2 (Adam's
# first step turns rounding into moves of up to ~0.1 lr, so step 2 takes the
# drift tolerance), the parameters 7.0e-6 apart, the statistics 3.4e-7
STEPS = 2
# the train-mode forward, float32 both sides, sums in another order: the
# tolerances of tests/test_torch_dccrnet.py's forwards (measured 6.9e-8 on
# the wav, 4.8e-6 on a tap), and the running statistics as
# tests/test_torch_trainer.py holds them (measured 1.0e-7)
ATOL = RTOL = 1e-5
# the bf16 forward against the JAX one taken op by op: each tap by relative
# L2 (tests/test_torch_bf16.py's bound; measured 0 on running statistics,
# <= 1.0e-4 on batch statistics, where a float32 statistic rounds to the
# other bf16 neighbour), the float32 waveform by max abs (measured 2.3e-4
# on a peak of 0.089)
TAP_REL_L2 = 1e-3
WAV_ATOL = 1e-3
# bf16 streaming against float32 streaming on the same weights, max abs
STREAM_ATOL = 5e-3


def _stft(jax_side=False):
    return (JaxSTFTConfig if jax_side else STFTConfig)(window="sqrthann")


def _batch():
    """The JAX test's batch: 4 clips of white noise at 0.1, clean 0.9 of it."""
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((4, 8000)) * 0.1).astype(np.float32)
    return mix, (mix * np.float32(0.9)).astype(np.float32)


def _cfg(strategy="clskd", **distill):
    return TrainConfig(teacher=DCCRNConfig(stft=_stft(), **TINY_T),
                       student=DCCRNConfig(stft=_stft(), **TINY_S),
                       data=DataConfig(**DATA), distill=DistillConfig(strategy=strategy, **distill))


def _jax_cfg(strategy="clskd"):
    return JaxTrainConfig(teacher=JaxDCCRNConfig(stft=_stft(True), **TINY_T),
                          student=JaxDCCRNConfig(stft=_stft(True), **TINY_S),
                          data=JaxDataConfig(**DATA), distill=JaxDistillConfig(strategy=strategy),
                          mesh=MeshConfig(data=1, model=1), max_epochs=1, log_every=1000)


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want) / np.linalg.norm(want))


# ------------------------------------------------------------ the forwards


def _jax_forwards(variables):
    """The JAX student's train-mode forward (outputs, taps, moved running
    statistics; jitted) and its bf16 forward on running and on batch
    statistics (op by op: jitted, XLA computes a fusion's bf16 elementwise
    ops in float32 and rounds once at its end, where torch rounds each op,
    which moved 39 % of a bf16 LSTM layer's outputs by one bf16 spacing)."""
    mix, _ = _batch()
    f32 = jax_dccrnet.DCCRNet(cfg=JaxDCCRNConfig(stft=_stft(True), **TINY_S))
    bf16 = jax_dccrnet.DCCRNet(cfg=JaxDCCRNConfig(stft=_stft(True), **TINY_S,
                                                  compute_dtype=BF16))

    def flat(out):
        t = out.taps
        return {"wav": out.wav, "mask_real": out.mask_real, "mask_imag": out.mask_imag,
                "taps": list(t.encoder) + list(t.decoder) + [t.lstm_real, t.lstm_imag]}

    wav = jnp.asarray(mix)
    variables = jax.tree.map(jnp.asarray, variables)  # numpy leaves would compute in numpy
    train, moved = jax.jit(lambda v, w: f32.apply(v, w, training=True, mutable=["batch_stats"]))(
        variables, wav)
    with pallas_lstm():
        running = bf16.apply(variables, wav, training=False)
        batch = bf16.apply(variables, wav, training=False, bn_batch_stats=True)
    stats = moved["batch_stats"]
    host = lambda tree: jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)
    return {"train": host(flat(train)), "stats": host(stats),
            "bf16_running": host(flat(running)), "bf16_batch": host(flat(batch)),
            "bf16_dtypes": sorted({str(a.dtype) for a in flat(running)["taps"]})}


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    variables = once_per_session(tmp_path_factory, "dccrnet-tiny-variables", _tiny_variables)
    want = once_per_session(tmp_path_factory, "test_torch_dccrnet_train.forwards",
                            lambda: _jax_forwards(variables))
    return variables, want


def _taps(out):
    t = out.taps
    return list(t.encoder) + list(t.decoder) + [t.lstm_real, t.lstm_imag]


def test_train_mode_forward_matches_jax(forwards):
    """The student's forward with ``training=True``: the waveform, the
    masks, every tap, and the running statistics it moves."""
    variables, want = forwards
    mix, _ = _batch()
    model = dccrnet.DCCRNet(DCCRNConfig(stft=_stft(), **TINY_S))
    model.load_state_dict(torch_state_from_flax(variables), strict=True)
    model.train()
    got = model(torch.from_numpy(mix), training=True)
    for name in ("wav", "mask_real", "mask_imag"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(), want["train"][name],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    for i, (g, w) in enumerate(zip(_taps(got), want["train"]["taps"])):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL, rtol=RTOL, err_msg=str(i))
    moved = 0
    for layer, stats in want["stats"].items():
        bn = getattr(model, layer)
        for key in ("mean", "var"):
            ref = stats[key]
            err = np.abs(getattr(bn, key).numpy() - ref).max() / max(1.0, np.abs(ref).max())
            assert err <= STAT_TOL, (layer, key, err)
            moved += not np.array_equal(ref, variables["batch_stats"][layer][key])
    assert moved == 2 * len(want["stats"])  # every statistic moved


def test_train_mode_backward_is_finite_at_a_zero_mask():
    """The gradient through the tanh-bounded mask's magnitude stays finite
    where the output conv gives an exact complex zero (its weights and bias
    zero): ``safe_magnitude``'s backward is 0 there, where the plain
    sqrt's is 0/0 (the mask's scale tanh(m)/max(m, 1e-12) is 0 at 0, so
    every gradient is 0, and a NaN would show in all of them)."""
    model = make_model(DCCRNConfig(stft=_stft(), **TINY_S), device="cpu").train()
    model.requires_grad_(True)
    with torch.no_grad():
        for p in model.out_conv.parameters():
            p.zero_()
    mix, clean = _batch()
    out = model(torch.from_numpy(mix), training=True)
    assert float(out.mask_real.detach().abs().max()) == 0.0
    assert float(out.wav.detach().abs().max()) == 0.0
    loss = ((out.wav - torch.from_numpy(clean)) ** 2).mean()
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("bn", ["running", "batch"])
def test_bf16_forward_matches_jax(forwards, bn):
    """The bf16 student (``compute_dtype="bfloat16"``) on the same weights:
    every tap bf16 as in JAX, the waveform float32, the values to
    ``TAP_REL_L2`` and ``WAV_ATOL``."""
    variables, want = forwards
    want = dict(want[f"bf16_{bn}"], dtypes=want["bf16_dtypes"])
    mix, _ = _batch()
    model = make_model(DCCRNConfig(stft=_stft(), **TINY_S, compute_dtype=BF16), device="cpu")
    model.load_state_dict(torch_state_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(mix), bn_batch_stats=True if bn == "batch" else None)
    assert want["dtypes"] == [BF16]
    assert all(t.dtype == torch.bfloat16 for t in _taps(got))
    assert got.wav.dtype == got.mask_real.dtype == torch.float32
    for i, (g, w) in enumerate(zip(_taps(got), want["taps"])):
        assert _rel_l2(g.float().numpy(), w) <= TAP_REL_L2, i
    assert np.abs(got.wav.numpy() - want["wav"]).max() <= WAV_ATOL


def test_bf16_dccrnet_serves_by_streaming(forwards):
    """A bf16 DCCRNet behind ``StreamingEnhancer``: float32 audio of the
    input's shape, within ``STREAM_ATOL`` of the float32 engine on the
    same weights (the bf16 rounding of every layer; measured 4.9e-4 on a
    peak of 0.14)."""
    variables, _ = forwards
    state = torch_state_from_flax(variables)
    wav = (0.3 * np.random.default_rng(4).standard_normal(5000)).astype(np.float32)
    out = {}
    for dtype in ("float32", BF16):
        cfg = DCCRNConfig(stft=_stft(), **TINY_S, compute_dtype=dtype)
        engine = StreamingEnhancer(cfg, state, device="cpu", chunk_frames=8, context_frames=16)
        out[dtype] = engine.stream(wav)
    assert out[BF16].shape == wav.shape and out[BF16].dtype == np.float32
    assert np.abs(out[BF16] - out["float32"]).max() <= STREAM_ATOL


# ------------------------------------------------------------ the clskd steps


def _jax_steps():
    """Both trainers' start (the port's seeded weights) and the JAX step's
    snapshot after each of ``STEPS`` steps (gradients from Adam's first
    moment: mu_1 = 0.1 g_1, g_k = (mu_k - 0.9 mu_{k-1}) / 0.1)."""
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    jt = JaxTrainer(_jax_cfg())
    state = _jax_state(jt, trainer)
    start = jax.tree.map(np.array, state)
    mix, clean = _batch()
    snaps, mu_prev = [], None
    for _ in range(STEPS):
        state, logs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
        mu = {p: _flat(v) for p, v in state.opt_state[0].mu.items()}
        grads = {p: {n: (m - (0 if mu_prev is None else B1 * mu_prev[p][n])) / (1 - B1)
                     for n, m in mu[p].items()} for p in mu}
        mu_prev = mu
        snaps.append((jax.tree.map(np.array, state), {k: float(v) for k, v in logs.items()},
                      grads))
    return start, snaps


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The port's snapshot beside the JAX one after each step from the same
    start (``tests/test_torch_trainer.py``'s ``_snapshot``)."""
    start, jax_snaps = once_per_session(tmp_path_factory, "test_torch_dccrnet_train.steps",
                                        _jax_steps)
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    load_train_state(trainer, start)
    mix, clean = _batch()
    out = []
    for state, jax_logs, grads in jax_snaps:
        logs = trainer.train_step(mix, clean)
        out.append(_snapshot(state, jax_logs, trainer, logs, grads))
    return out


def test_abf_chains_take_the_family_widths():
    """The chains' input widths are the student's taps' (DCCRNet's decoder
    taps lead with the rnn_out tap), their output widths the JAX trainer's
    family-blind ones."""
    trainer = Trainer(_cfg(), device="cpu")
    assert tap_channels(trainer.cfg.student) == ((4, 8, 8), (8, 8, 4))
    ins = {name: [getattr(chain, f"abf{i}").conv1.kernel.shape[2] for i in range(3)]
           for name, chain in (("enc", trainer.abf_enc), ("dec", trainer.abf_dec))}
    outs = {name: [getattr(chain, f"abf{i}").out_channels for i in range(3)]
            for name, chain in (("enc", trainer.abf_enc), ("dec", trainer.abf_dec))}
    assert ins == {"enc": [8, 8, 4], "dec": [8, 8, 4]}  # processing order
    assert outs == {"enc": [16, 16, 8], "dec": [16, 8, 2]}


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_clskd_step_logs_match_jax(steps, step):
    snap = steps[step - 1]
    assert set(snap["port_logs"]) == set(snap["jax_logs"]) == set(log_keys("clskd"))
    rtol = LOG_RTOL if step == 1 else DRIFT_LOG_RTOL
    for k, want in snap["jax_logs"].items():
        assert np.isfinite(snap["port_logs"][k]), k
        np.testing.assert_allclose(snap["port_logs"][k], want, rtol=rtol, err_msg=k)


def test_clskd_step_gradients_match_jax(steps):
    """Step 1's gradients, both trainers at the same point."""
    _check_gradients(steps[0])


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_clskd_step_parameters_and_statistics_match_jax(steps, step):
    """After step 1 each trained parameter within ``PARAM_ATOL`` of what
    the two gradients give through Adam; after step 2 the drift tolerances
    of the 10-step runs of ``tests/test_torch_trainer.py``."""
    _check_parameters(steps[step - 1], step == 1, step)
    _check_statistics(steps[step - 1], step != 1, step)


# ------------------------------------------------------------ the time gather


@pytest.mark.parametrize("n_in, n_out, axis", [(75, 76, 2), (9, 10, 2), (5, 7, 2), (4, 3, 1),
                                               (3, 8, 1)])
def test_nearest_axis_and_its_backward_match_jax(n_in, n_out, axis):
    """``_nearest_axis`` forward and backward against the JAX function, at
    the one-frame upscale of the DCCRNet residuals (n_in = n_out - 1: frame
    0 taken twice, its gradient the sum of the first two rows) and at
    another gather, a one-row crop and an integer upscale along freq."""
    rng = np.random.default_rng(n_in * 100 + n_out)
    shape = [2, 3, 4, 5]
    shape[axis] = n_in
    x = rng.standard_normal(shape).astype(np.float32)
    out_shape = list(shape)
    out_shape[axis] = n_out
    g = rng.standard_normal(out_shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_nearest_axis(a, axis, n_out), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _nearest_axis(xt, axis, n_out)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0, atol=1e-6)
    if n_out - n_in == 1:  # frame 0 taken twice: its gradient two rows' sum
        first = np.take(g, [0], axis=axis) + np.take(g, [1], axis=axis)
        np.testing.assert_array_equal(np.take(xt.grad.numpy(), [0], axis=axis), first)


# ------------------------------------------------------------ other strategies


def test_reviewkd_raises_where_the_jax_step_raises():
    """The family-blind output widths make the fused decoder maps (16, 8, 2
    channels) differ from the teacher's decoder taps (16, 16, 8): the JAX
    step fails to broadcast in HCL while it traces, and the port raises
    naming the shapes, before any update."""
    trainer = Trainer(_cfg("reviewkd"), device="cpu").init_state(0)
    jt = JaxTrainer(_jax_cfg("reviewkd"))
    jt._build_train_step()
    mix, clean = _batch()
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jt._raw_train_step, _jax_state(jt, trainer), jnp.asarray(mix),
                       jnp.asarray(clean))
    before = {k: v.clone() for k, v in trainer.student.state_dict().items()}
    with pytest.raises(ValueError, match=r"\(4, 8, 64, 75\).*\(4, 16, 64, 75\).*8 against 16"):
        trainer.train_step(mix, clean)
    after = trainer.student.state_dict()
    assert trainer.step == 0
    assert all(torch.equal(before[k], after[k]) for k in before if not k.endswith(("mean",
                                                                                   "var")))


@pytest.mark.parametrize("strategy", ["spkd", "mse", "stft"])
def test_other_strategies_take_a_finite_step(strategy):
    """No ABF chains; one step with the strategy's log keys (those of the
    JAX step: ``log_keys``, held against JAX in
    tests/test_torch_strategies.py), every log finite, the student moved."""
    trainer = Trainer(_cfg(strategy), device="cpu").init_state(0)
    assert trainer.abf_enc is None and trainer.abf_dec is None
    before = [p.detach().clone() for p in trainer.student.parameters()]
    mix, clean = _batch()
    logs = trainer.train_step(mix[:, :4000], clean[:, :4000])
    assert set(logs) == set(log_keys(strategy))
    assert all(np.isfinite(v.item()) for v in logs.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.student.parameters()))


# ------------------------------------------------------------ the CLI and phase 24


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the CLI loop at tiny size: the smallest asteroid architecture as the
# teacher, a 6-layer student as narrow as the tiny one, 0.5 s clips
CLI_OVERRIDES = ("data.synthetic=true", "data.synthetic_size=8", "data.segment=0.5",
                 "data.batch_size=4", "max_epochs=1", "keep_top_k=1",
                 "teacher.name=dccrn-cl-test", "teacher.kernel_num=[8,16,32,64,64,64]",
                 "teacher.rnn_units=64", "student.kernel_num=[4,4,8,8,8,8]",
                 "student.rnn_units=16", "distill.abf_mid_channels=8")


def test_cli_loop_on_the_cpu(smoke, tmp_path):
    """chip_smoke.py's phase 24 CLI loop on the CPU: ``import-torch`` of a
    seeded ``DCCRN-CL-test`` ``.pth``, ``distill --teacher-bundle`` with the
    dccrnet presets (an epoch of 2 steps and 8 validation clips), the best
    bundle read back as a DCCRNet, ``evaluate`` on it and streaming it."""
    pth = smoke.write_asteroid_pth(str(tmp_path / "teacher.pth"), "DCCRN-CL-test", seed=4)
    request = (0.1 * np.random.default_rng(1).standard_normal(7000)).astype(np.float32)
    rec = smoke.dccrnet_cli_checks(pth, str(tmp_path / "cli"), "cpu", CLI_OVERRIDES,
                                   request=request, compute_pesq=False)
    assert rec["failures"] == []
    assert rec["family"] == "dccrnet" and rec["student"] == "dccrnet-cl-test"
    assert rec["teacher"] == "dccrn-cl-test"
    assert rec["lstm_launches"] == 0  # no CUDA tensor, no kernel
    assert rec["evaluate_err"]["stoi"] == 0 and rec["stream_max_abs_err_vs_cpu"] == 0
    assert np.isfinite(rec["evaluate"]["si_sdr"])


def test_chip_smoke_dccrnet_phase_rehearsed_on_the_cpu(smoke, tmp_path):
    """Phase 24's step checks on the CPU: the gates' launch counts at full
    width (no K4; K5 on each chain's unfused first block), and the
    card-vs-CPU step of the bf16 form with the teacher from a ``.pth`` and
    each gradient's own rounding floor, at tiny widths (2 clips of 0.25 s):
    the CPU against itself from the same state with zero error, the bf16
    rounding floor measured."""
    models = smoke.dccrnet_models()
    assert (models["teacher"].name, models["student"].name) == ("dccrnet-cl", "dccrnet-cl-test")
    full = {key: smoke.abf_gate_counts(smoke.train_config(2, 3.0, flags, **models))
            for key, flags in (("kernels", smoke.ABF_KERNEL_FLAGS),
                               ("block", smoke.ABF_BLOCK_FLAGS))}
    assert full == {"kernels": {"conv3x3_fwd": 24, "conv3x3_wgrad": 12},
                    "block": {"abf_block_fwd": 2, "abf_block_bwd": 2}}
    pth = smoke.write_asteroid_pth(str(tmp_path / "teacher.pth"), "DCCRN-CL-test", seed=5)
    _, teacher_vars, _ = dccrnet.read_reference_bundle(pth)
    tiny = {"teacher": dataclasses.replace(models["teacher"], compute_dtype=BF16,
                                           kernel_num=(8, 16, 32, 64, 64, 64), rnn_units=64),
            "student": dataclasses.replace(models["student"], compute_dtype=BF16,
                                           kernel_num=(4, 4, 8, 8, 8, 8), rnn_units=16)}
    cfg = smoke.train_config(2, 0.25, dict(smoke.BF16_DISTILL, abf_mid_channels=8), **tiny)
    rec = smoke.card_vs_cpu_checks(cfg, "cpu", rounding_floor=True,
                                   teacher_variables=teacher_vars, own_floor=True)
    assert rec["failures"] == []
    step = rec["gaussian"]["steps"][0]
    assert step["loss_rel_err"] == 0.0 and step["grad_max_rel_l2"] == 0.0
    assert step["rounding_floor"] > 0.0 and rec["gaussian"]["loss_rtol"] == smoke.BF16_LOSS_RTOL
    assert np.isfinite(step["loss"]) and np.isfinite(rec["speech"]["steps"][0]["loss"])
    assert step["admitted_by_own_floor"] == {}  # the CPU against itself: nothing above the hold
