"""bf16 training and serving of the port (``compute_dtype`` and
``distill.taps_dtype`` = bfloat16) on the CPU against the JAX package.

- The bf16 plain versions of K3f (and its dx pass), K3w, K4f and K4b
  against the Pallas kernels in interpret mode on the same bf16 inputs.
- The bf16 model forward, the K1 wrapper's dtypes, one bf16 ``clskd`` step
  (default, with the K3/K4 flags and with the whole-block K5) against the
  JAX bf16 step, the port's bf16-vs-float32 loss parity, every strategy and
  option under bf16, and a bf16 bundle served by ``StreamingEnhancer``.
  The bf16 K5 and K2 modules are held to the Pallas kernels in
  ``tests/test_torch_bf16_block.py``.

The JAX LSTM layers take a bf16 ``lax.scan`` on the CPU and the Pallas
sequence kernel on a TPU; the port follows the TPU path (the recurrence in
float32 on upcast inputs).  So the JAX side runs with the Pallas kernel in
interpret mode (``pallas_lstm``).  The JAX bf16 step is computed once per
test session (``torch_oracle.once_per_session``).

Tolerances, measured beside each: the kernels' plain versions sum the same
exact products in float32, as the interpret-mode Pallas bodies do, and round
once, so bf16 outputs agree to one bf16 spacing and float32 outputs to
float32 rounding.  A whole bf16 model or step rounds each op to bf16 on
both sides; where an op's float32 sum lands on the other side of a bf16
rounding boundary the two part by one spacing (2^-8 relative), and the
backward's batch-statistics BN layers amplify that (the port's own bf16 step
moves ``gn_dec`` by 1.1 % from its float32 step).
"""

import contextlib
import importlib.util
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import speech_enhancement_clskd_tpu.ops.pallas.lstm as jax_pallas_lstm
import speech_enhancement_clskd_tpu.train.trainer as jax_trainer_module
import speech_enhancement_clskd_tpu_torch.train.trainer as port_trainer_module
from speech_enhancement_clskd_tpu.config import (
    DataConfig as JaxDataConfig,
    DCCRNConfig as JaxDCCRNConfig,
    DistillConfig as JaxDistillConfig,
    MeshConfig,
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.eval.streaming import StreamingEnhancer as JaxStreamingEnhancer
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu.ops.pallas import attfuse as jax_attfuse
from speech_enhancement_clskd_tpu.ops.pallas import conv3x3 as jax_conv3x3
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu.utils.serialization import load_bundle as jax_load_bundle
from test_torch_trainer import _jax_state
from torch_oracle import once_per_session, one_cpu_thread
from speech_enhancement_clskd_tpu_torch import cli
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    DistillConfig,
    OptimConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
from speech_enhancement_clskd_tpu_torch.kernels import SUM_REL, bf16_check
from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
    attention_fuse_bwd,
    attention_fuse_fwd,
)
from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_wgrad
from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer
from speech_enhancement_clskd_tpu_torch.utils.bridge import load_train_state, torch_state_from_flax
from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle, save_bundle

BF16 = "bfloat16"
BUNDLE = str(Path(__file__).resolve().parents[1] / "artifacts/r4_distill/the_best_model.npz")
TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
DATA = dict(synthetic=True, synthetic_size=16, segment=0.5, batch_size=4)
# the shapes of tests/test_pallas_conv3x3.py (B, D, T, C, O) and
# tests/test_pallas_attfuse.py (B, D, Dp, T, C)
CONV_SHAPES = [(2, 8, 21, 8, 16), (2, 4, 21, 8, 32), (1, 2, 7, 4, 4), (2, 6, 11, 8, 8),
               (1, 16, 5, 16, 2)]
FUSE_SHAPES = [(2, 8, 4, 21, 8), (2, 4, 4, 13, 8), (1, 16, 4, 7, 16), (2, 2, 1, 11, 4)]
# float32 outputs of the kernels' plain versions against interpret mode:
# relative L2, measured <= 3.2e-7
F32_REL_L2 = 1e-5
# the bf16 model forward against JAX's: each tap by relative L2 (measured
# <= 8e-5 on batch statistics, <= 3e-5 on running ones), the float32
# waveform by max abs (measured 1.7e-5)
TAP_REL_L2 = 1e-3
WAV_ATOL = 1e-4
# the bf16 step's logs against JAX's: the losses (measured <= 7.3e-4 from
# the port's seeded state, <= 2.0e-3 from the JAX-initialized one before PR
# 20; the LSTM terms of ~4e-5) and the gradient norms (measured <= 5.6e-3,
# <= 2.5e-2 before, gn_dec; see the module docstring)
LOSS_RTOL = 5e-3
GRAD_NORM_RTOL = 5e-2
# bf16 against float32 over 4 steps: the bounds of tests/test_train.py's
# test_bf16_loss_parity_with_f32
PARITY_RTOL, PARITY_ATOL = 0.05, 5e-3
# a bf16 bundle served by the port against the JAX StreamingEnhancer of the
# same bundle: max abs on the waveform (measured 1.05e-3 on a peak of 0.44)
STREAM_ATOL = 4e-3
# the step's paths: the default chain, the K3/K4 kernels', and the whole-block
# kernel's (K5; the JAX gate is closed off the TPU, so the JAX step is the
# same snapshot, on its default chain, and the port's plain K5 rounds as the
# Pallas block does: measured logs <= 1.1e-3, gradient norms <= 5.0e-3; from
# the JAX-initialized state before PR 20, 2.0e-3 and 2.4e-2)
KERNEL_FLAGS = {"default": {}, "kernels": dict(abf_conv_pallas=True, abf_attfuse_pallas=True),
                "block": dict(abf_block_pallas=True)}


@contextlib.contextmanager
def pallas_lstm():
    """The JAX LSTM layers on the Pallas sequence kernel in interpret mode,
    the path they take on a TPU."""
    orig = jax_pallas_lstm.lstm_seq
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pallas_lstm, "lstm_pallas_available", lambda: True)
        mp.setattr(jax_pallas_lstm, "lstm_seq", lambda xw, w_hh: orig(xw, w_hh, True))
        yield


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _t(a):
    """A JAX bf16 (or float32) array as a torch tensor of the same dtype."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _batch():
    rng = np.random.default_rng(0)
    clean = (0.1 * rng.standard_normal((4, 8000))).astype(np.float32)
    return clean + (0.05 * rng.standard_normal((4, 8000))).astype(np.float32), clean


# ------------------------------------------------- the kernels' plain versions

@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv3x3_bf16_plain_matches_pallas_interpret(shape):
    """K3f, its dx pass (the flipped weights in bf16, conv3x3.py:222) and
    K3w: bf16 out and dx within one bf16 spacing (measured: at most 1, on
    dx), float32 dw."""
    b, d, t, c, o = shape
    rng = np.random.default_rng(sum(shape))
    x = _jbf(rng.standard_normal((b, d, t, c)))
    w = _jbf(rng.standard_normal((3, 3, c, o)) / (3 * np.sqrt(c)))
    g = _jbf(rng.standard_normal((b, d, t, o)))
    w_flip = jnp.transpose(w[::-1, ::-1], (0, 1, 3, 2)).astype(jnp.bfloat16)
    want_out = jax_conv3x3._conv3x3_raw(x, w, True)
    want_dx = jax_conv3x3._conv3x3_raw(g, w_flip, True)
    want_dw = jax_conv3x3._wgrad_raw(x, g, True)
    out = conv3x3_fwd(_t(x), _t(w))
    dx = conv3x3_fwd(_t(g), _t(w_flip))
    dw = conv3x3_wgrad(_t(x), _t(g))
    assert out.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert want_out.dtype == want_dx.dtype == jnp.bfloat16 and want_dw.dtype == jnp.float32
    for got, want in ((out, want_out), (dx, want_dx)):
        assert bf16_check(got, _t(want))["max_ulps"] <= 1
    assert _rel_l2(dw.numpy(), want_dw) <= F32_REL_L2


@pytest.mark.parametrize("shape", FUSE_SHAPES, ids=str)
def test_attfuse_bf16_plain_matches_pallas_interpret(shape):
    """K4f (bf16 out and z) and K4b (bf16 dx and dres, float32 parameter
    gradients) on bf16 inputs, the backward from the Pallas forward's z
    (measured: all bf16 outputs bit for bit, float32 <= 3.2e-7)."""
    b, d, dp, t, c = shape
    rng = np.random.default_rng(sum(shape))
    x, res, wx, wy, bias, g = (_jbf(a) for a in (
        rng.standard_normal((b, d, t, c)), rng.standard_normal((b, dp, t, c)),
        rng.standard_normal((c, 2)) * 0.3, rng.standard_normal((c, 2)) * 0.3,
        rng.standard_normal((2,)) * 0.1, rng.standard_normal((b, d, t, c))))
    want_out, want_z = jax_attfuse._fwd_raw(x, res, wx, wy, bias.reshape(1, 2), True)
    want = jax_attfuse._bwd_raw(x, res, want_z, g, wx, wy, True)
    out, z = attention_fuse_fwd(*(_t(a) for a in (x, res, wx, wy, bias)))
    got = attention_fuse_bwd(*(_t(a) for a in (x, res, want_z, g, wx, wy)))
    assert out.dtype == z.dtype == torch.bfloat16
    assert bf16_check(out, _t(want_out))["max_ulps"] <= 1
    assert bf16_check(z, _t(want_z))["max_ulps"] <= 1
    for name, got_t, want_a in zip(("dx", "dres", "dwx", "dwy", "dbias"), got, want):
        if name in ("dx", "dres"):
            assert got_t.dtype == torch.bfloat16 and want_a.dtype == jnp.bfloat16, name
            assert bf16_check(got_t, _t(want_a))["max_ulps"] <= 1, name
        else:
            assert got_t.dtype == torch.float32 and want_a.dtype == jnp.float32, name
            assert _rel_l2(got_t.numpy(), np.asarray(want_a).reshape(got_t.shape)) <= F32_REL_L2


def test_bf16_checks_hold_a_cancelling_sum_to_its_terms():
    """``bf16_check`` allows one spacing, or ``rel`` of the terms' magnitudes
    where a sum cancels."""
    want = torch.tensor([1.0, 2.0 ** -20], dtype=torch.bfloat16)
    got = torch.tensor([1.0 + 2.0 ** -7, 2.0 ** -20 + 2.0 ** -24], dtype=torch.bfloat16)
    assert bf16_check(got, want)["max_ulps"] == 8 and not bf16_check(got, want)["within"]
    scale = torch.tensor([1.0, 8.0])
    assert bf16_check(got, want, scale, SUM_REL)["within"]
    assert not bf16_check(got, want, scale, 2.0 ** -30)["within"]


# ------------------------------------------------------- model and LSTM


def test_lstm_wrapper_bf16_dtypes():
    """The K1 wrapper on bf16 ``xw`` and ``w_hh``: the recurrence in float32
    (``c`` float32), ``y`` and the gradients in bf16, against the Pallas
    kernel in interpret mode behind the JAX layer's casts."""
    rng = np.random.default_rng(3)
    xw = _jbf(rng.standard_normal((12, 4, 32)))
    w_hh = _jbf(rng.standard_normal((8, 32)) / np.sqrt(8))
    dy = _jbf(rng.standard_normal((12, 4, 8)))

    def layer(a, b):
        return jax_pallas_lstm.lstm_seq(a, b, True).astype(jnp.bfloat16)

    want, vjp = jax.vjp(layer, xw, w_hh)
    want_dxw, want_dwhh = vjp(dy)
    xw_t, w_t = (_t(a).requires_grad_(True) for a in (xw, w_hh))
    y, c = lstm_seq(xw_t, w_t)
    y.backward(_t(dy))
    assert (y.dtype, c.dtype, xw_t.grad.dtype, w_t.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16)
    assert want.dtype == want_dxw.dtype == want_dwhh.dtype == jnp.bfloat16
    for got, ref in ((y, want), (xw_t.grad, want_dxw), (w_t.grad, want_dwhh)):
        assert bf16_check(got.detach(), _t(ref))["max_ulps"] <= 1


def _jax_forwards():
    """The JAX bf16 student's seeded weights and its forward on them, with
    running and with batch statistics, op by op (each primitive compiled
    once for both): taps and waveform with their dtypes."""
    mix, _ = _batch()
    jax_model = jax_make_model(JaxDCCRNConfig(**TINY_S, compute_dtype=BF16))
    out = {}
    with pallas_lstm():
        variables = jax_model.init(jax.random.PRNGKey(1), jnp.asarray(mix), training=False)
        for key, bn in (("running", False), ("batch", True)):
            want = jax_model.apply(variables, jnp.asarray(mix), training=False,
                                   bn_batch_stats=bn)
            t = want.taps
            taps = list(t.encoder) + list(t.decoder) + [t.lstm_real, t.lstm_imag]
            out[key] = dict(taps=[np.asarray(a.astype(jnp.float32)) for a in taps],
                            tap_dtypes=sorted({str(a.dtype) for a in taps}),
                            wav=np.asarray(want.wav), wav_dtype=str(want.wav.dtype))
    return jax.tree.map(np.asarray, variables), out


@pytest.fixture(scope="module")
def bf16_forwards(tmp_path_factory):
    return once_per_session(tmp_path_factory, "test_torch_bf16.forwards", _jax_forwards)


@pytest.mark.parametrize("bn_batch_stats", [False, True], ids=["running", "batch"])
def test_bf16_forward_matches_jax(bf16_forwards, bn_batch_stats):
    """The bf16 student forward on the JAX model's weights: every tap bf16
    as in JAX, the waveform float32, values to ``TAP_REL_L2`` and
    ``WAV_ATOL``."""
    mix, _ = _batch()
    variables, out = bf16_forwards
    want = out["batch" if bn_batch_stats else "running"]
    model = make_model(DCCRNConfig(**TINY_S, compute_dtype=BF16), device="cpu")
    model.load_state_dict(torch_state_from_flax(variables))
    got = model(torch.from_numpy(mix), bn_batch_stats=bn_batch_stats)

    def taps(t):
        return list(t.encoder) + list(t.decoder) + [t.lstm_real, t.lstm_imag]

    assert want["tap_dtypes"] == ["bfloat16"]
    for g, w in zip(taps(got.taps), want["taps"]):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g.float().numpy(), w) <= TAP_REL_L2
    assert want["wav_dtype"] == "float32" and got.wav.dtype == torch.float32
    assert np.abs(got.wav.numpy() - want["wav"]).max() <= WAV_ATOL


# ------------------------------------------------------------ the step


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@contextlib.contextmanager
def dtype_spy(module, seen):
    """Record into ``seen`` the dtypes of every tap, fused map and the loss
    that ``module.distill_loss`` sees and returns."""
    orig = module.distill_loss

    def spy(strategy, s_out, t_out, clean, dcfg, fe=None, fd=None, **kw):
        def taps(t):  # none where a strategy reads only the waveforms
            return [] if t is None else [_dtype(a) for a in list(t.encoder) + list(t.decoder)
                                         + [t.lstm_real, t.lstm_imag]]

        def fused(maps):  # a bn2-folded map comes as (raw map, a, b)
            return [_dtype(f[0] if isinstance(f, tuple) else f) for f in maps or ()]

        loss, logs = orig(strategy, s_out, t_out, clean, dcfg, fe, fd, **kw)
        seen.update(student=taps(s_out.taps), teacher=taps(t_out.taps),
                    fused=fused(fe) + fused(fd), loss=_dtype(loss),
                    logs=sorted({_dtype(v) for v in logs.values()}))
        return loss, logs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "distill_loss", spy)
        yield seen


def _jax_step():
    """One JAX bf16 clskd step from the port's seeded state (so no JAX
    initialization compiles): the state before it, its logs and the dtypes
    its loss saw."""
    mix, clean = _batch()
    cfg = JaxTrainConfig(teacher=JaxDCCRNConfig(**TINY_T, compute_dtype=BF16),
                         student=JaxDCCRNConfig(**TINY_S, compute_dtype=BF16),
                         data=JaxDataConfig(**DATA), distill=JaxDistillConfig(taps_dtype=BF16),
                         mesh=MeshConfig(data=1, model=1), max_epochs=1, log_every=1000)
    seen = {}
    with pallas_lstm(), dtype_spy(jax_trainer_module, seen):
        jt = JaxTrainer(cfg)
        state = _jax_state(jt, Trainer(_cfg(), device="cpu").init_state(0))
        start = jax.tree.map(np.array, state)
        _, logs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
    return dict(start=start, logs={k: float(v) for k, v in logs.items()},
                log_dtypes=sorted({_dtype(v) for v in logs.values()}), dtypes=seen)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    return once_per_session(tmp_path_factory, "test_torch_bf16.jax_step", _jax_step)


def _cfg(dtype=BF16, **distill):
    return TrainConfig(teacher=DCCRNConfig(**TINY_T, compute_dtype=dtype),
                       student=DCCRNConfig(**TINY_S, compute_dtype=dtype),
                       data=DataConfig(**DATA), distill=DistillConfig(taps_dtype=dtype, **distill))


@pytest.mark.parametrize("flags", list(KERNEL_FLAGS.values()), ids=list(KERNEL_FLAGS))
def test_bf16_step_matches_jax(jax_step, flags):
    """One bf16 step from the JAX state, default, on the K3/K4 paths and on
    the K5 path (their bf16 plain versions here): the same dtypes of every tap, fused
    map and loss (bf16 taps, float32 losses), and the logs to
    ``LOSS_RTOL`` and ``GRAD_NORM_RTOL``."""
    mix, clean = _batch()
    trainer = Trainer(_cfg(**flags), device="cpu").init_state()
    load_train_state(trainer, jax_step["start"])
    seen = {}
    with dtype_spy(port_trainer_module, seen):
        logs = trainer.train_step(mix, clean)
    assert seen == jax_step["dtypes"]
    assert seen["student"] == seen["teacher"] == [BF16] * len(seen["student"])
    assert seen["fused"] == [BF16] * len(seen["fused"]) and seen["loss"] == "float32"
    assert sorted({_dtype(v) for v in logs.values()}) == jax_step["log_dtypes"] == ["float32"]
    want = jax_step["logs"]
    assert set(logs) == set(want)
    for k, v in want.items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" or k.startswith("gn_") else LOSS_RTOL
        np.testing.assert_allclose(logs[k].item(), v, rtol=rtol, err_msg=k)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for m in trainer.trainable().values() for p in m.parameters())


def test_bf16_tracks_float32_over_four_steps():
    """The port's bf16 step against its float32 step from the same seeded
    state over 4 steps (4 clips of 0.25 s): the JAX package's own bounds,
    and the bf16 loss descends."""
    mix, clean = (a[:, :4000] for a in _batch())

    def run(dtype):
        trainer = Trainer(_cfg(dtype), device="cpu").init_state(0)
        return np.array([trainer.train_step(mix, clean)["train_loss"].item()
                         for _ in range(4)])

    f32, bf16 = run("float32"), run(BF16)
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, f32, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    assert bf16[-1] < bf16[0] + 1e-3


# every strategy, and each float32 option of training, under bf16
BF16_RUNS = {
    "reviewkd": (dict(strategy="reviewkd"), {}),
    "spkd": (dict(strategy="spkd"), {}),
    "mse": (dict(strategy="mse"), {}),
    "stft": (dict(strategy="stft"), {}),
    "remat_fold_kernels": (dict(abf_remat=True, spkd_bn2_fold=True, abf_conv_pallas=True,
                                abf_attfuse_pallas=True), {}),
    "block_remat_fold": (dict(abf_block_pallas=True, abf_remat=True, spkd_bn2_fold=True), {}),
    "ninedot_reinit": (dict(abf_conv_ninedot=True, abf_reinit_each_step=True), {}),
    "adamw_clip_cosine": ({}, dict(optimizer="adamw", weight_decay=1e-2, grad_clip=0.5,
                                   lr_schedule="cosine", warmup_steps=1)),
}


@pytest.mark.parametrize("case", list(BF16_RUNS))
def test_bf16_runs_every_strategy_and_option(case):
    """Two bf16 steps (0.25 s clips) of each strategy and option: finite
    float32 logs, bf16 taps into the losses, float32 parameters and
    gradients."""
    distill, optim = BF16_RUNS[case]
    cfg = dataclasses.replace(_cfg(**distill), optim=OptimConfig(**optim), max_epochs=4)
    trainer = Trainer(cfg, device="cpu").init_state(0)
    mix, clean = _batch()
    seen = {}
    with dtype_spy(port_trainer_module, seen):
        for _ in range(2):
            logs = trainer.train_step(mix[:, :4000], clean[:, :4000])
    assert all(v.dtype == torch.float32 and np.isfinite(v.item()) for v in logs.values())
    assert seen["student"] == [BF16] * len(seen["student"]) and seen["loss"] == "float32"
    assert all(f == BF16 for f in seen["fused"])
    assert all(p.dtype == torch.float32 for m in trainer.trainable().values()
               for p in m.parameters())


def test_bf16_distill_cli_fits_and_bundles(tmp_path, capsys):
    """``distill`` with bf16 compute and taps: ``Trainer.fit`` over two
    epochs of one step, validation, the best checkpoint's bundle, whose
    config says bfloat16 and which ``StreamingEnhancer`` serves."""
    out = str(tmp_path / "run")
    argv = ["distill", "--strategy", "clskd", "--device", "cpu", "--out", out,
            "data.synthetic=true", "data.synthetic_size=4", "data.segment=0.5",
            "data.batch_size=4", "teacher.kernel_num=[8,16,32]", "teacher.rnn_units=32",
            "student.kernel_num=[4,8,8]", "student.rnn_units=16", "keep_top_k=1",
            "max_epochs=2", "teacher.compute_dtype=bfloat16",
            "student.compute_dtype=bfloat16", "distill.taps_dtype=bfloat16"]
    assert cli.main(argv) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in last["final_metrics"].values())
    cfg, variables, _ = load_bundle(last["bundle"])
    assert cfg.compute_dtype == BF16
    engine = StreamingEnhancer(cfg, torch_state_from_flax(variables), device="cpu")
    wav = SyntheticEnhancementDataset(size=1, segment=1.0, seed=5)[0][0]
    got = engine.stream(wav)
    assert got.shape == wav.shape and got.dtype == np.float32 and np.isfinite(got).all()


# ------------------------------------------------------------- serving


def test_bf16_bundle_served_by_streaming(tmp_path):
    """A bundle whose config says ``compute_dtype="bfloat16"`` (the r4
    student's weights) builds a bf16 model behind ``StreamingEnhancer``,
    which serves float32 audio of the input's shape, to ``STREAM_ATOL`` of
    the JAX StreamingEnhancer on the same bundle (its LSTM on the Pallas
    kernel)."""
    cfg, variables, _ = load_bundle(BUNDLE)
    path = str(tmp_path / "bf16_student.npz")
    save_bundle(path, variables["params"], variables["batch_stats"],
                dataclasses.replace(cfg, compute_dtype=BF16))
    cfg, variables, _ = load_bundle(path)
    assert cfg.compute_dtype == BF16
    kw = dict(chunk_frames=48, context_frames=64)
    engine = StreamingEnhancer(cfg, torch_state_from_flax(variables), device="cpu", **kw)
    assert engine.model.cfg.compute_dtype == BF16
    wav = SyntheticEnhancementDataset(size=1, segment=1.5, seed=11)[0][0][:20001]
    got = engine.stream(wav)
    assert got.shape == wav.shape and got.dtype == np.float32 and np.isfinite(got).all()
    jax_cfg, jax_variables, _ = jax_load_bundle(path)
    assert jax_cfg.compute_dtype == BF16
    with pallas_lstm():
        want = JaxStreamingEnhancer(jax_cfg, jax_variables, **kw).stream(wav)
    assert np.abs(got - want).max() <= STREAM_ATOL


def test_chip_smoke_bf16_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 18 check at tiny widths on the CPU (2 clips of
    0.25 s): the card-vs-CPU step of the bf16 kernel path, the CPU against
    itself from the same state with zero error and the bf16 rounding floor
    measured.  (Its loss parity is the port's, held by
    ``test_bf16_tracks_float32_over_four_steps``.)"""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tiny_bf16 = dict(teacher=DCCRNConfig(**TINY_T, compute_dtype=BF16),
                     student=DCCRNConfig(**TINY_S, compute_dtype=BF16))
    cfg = smoke.train_config(2, 0.25, smoke.BF16_KERNEL_DISTILL, **tiny_bf16)
    rec = smoke.card_vs_cpu_checks(cfg, "cpu", rounding_floor=True)
    assert rec["failures"] == []
    step = rec["gaussian"]["steps"][0]
    assert step["loss_rel_err"] == 0.0 and step["grad_max_rel_l2"] == 0.0
    assert step["rounding_floor"] > 0.0 and rec["gaussian"]["loss_rtol"] == smoke.BF16_LOSS_RTOL
