"""The port's CLSKD training step against the JAX ``Trainer.train_step``.

Both trainers start from one JAX ``TrainState`` (seeded teacher, student and
ABF chains, carried over by ``utils.bridge.load_train_state``) and take the
same 10 steps on 10 seeded batches, at the tiny geometry of
``tests/test_train.py``.  After step 1 and after step 10, every log value,
every gradient tensor, every parameter and every BN statistic is compared.

The JAX step does not return its gradients.  Its Adam moments carry them:
after step 1, mu = 0.1 g; after step k, g = (mu_k - 0.9 mu_{k-1}) / 0.1.

Two runs of float32 code that round differently drift apart through Adam:
its update is lr * m_hat / (sqrt(v_hat) + eps), which gives an element with
a tiny gradient a move of order lr whatever that gradient's rounding, so
per-element rounding differences of the gradients become parameter
differences of up to ~1e-5 a step.  Over 10 independent steps the two
trajectories part by ~4e-5 in the parameters, and the gradients at the two
slightly different points by up to ~5e-3 (measured).  So after 10 steps:

- the gradients are compared at the same point: the JAX state after step 9
  is loaded into a second port trainer, which takes step 10 on batch 10;
  its gradients and logs are held to the step-1 tolerances;
- the two independent 10-step trajectories are held on the logs,
  parameters and BN statistics to tolerances set from the drift measured
  (given beside each).

The same JAX step-1 snapshot also holds two more port trainers, loaded with
the initial state and taking step 1, each held to the step-1 tolerances:
snapshot ``"kernels"``, built with ``abf_conv_pallas`` and
``abf_attfuse_pallas`` (the ABF 3x3 convs and attention fuses through
``kernels/conv3x3.py`` and ``kernels/attfuse.py``), and snapshot
``"block"``, built with ``abf_block_pallas`` (every ABF block but its bn2
through ``kernels/abf_block.py``), their plain versions on the CPU.  They
stand against the JAX step with the same flags because on the CPU the JAX
gates (``conv3x3_available``, ``attfuse_available``,
``abf_block_available``) are closed, so the JAX ``Trainer`` with those flags
runs its XLA paths, the default step compiled once here (asserted in
``runs``).

The options of the rest of training.  ``reviewkd`` takes its own JAX step
(``test_reviewkd_step_matches_jax``), both trainers starting from the
port's seeded weights (the JAX ``TrainState`` built from them, so no JAX
initialization compiles), with the student's LSTM narrower than the
teacher's (SPKD on the LSTM taps) and as wide (HCL), held as step 1.  The
ABF options that leave the step's arithmetic as it is (``OPTION_FLAGS``:
``abf_remat``, ``abf_conv_ninedot``, ``spkd_bn2_fold``) are three more
snapshots of step 1, held as ``kernels`` and ``block`` are (their JAX
functions, the nine-dot conv and the bn2-folded SPKD loss, are held against
the port's in ``tests/test_torch_kd_hcl.py``).  The optimizer options
(``adamw``, ``weight_decay``, ``grad_clip``, ``cosine``) are held against
the JAX trainer's optax chain on the same gradients over 2 or 3 steps
(``test_option_matches_jax``).  ``abf_reinit_each_step`` draws from a torch
generator, so its bits cannot be JAX's: a re-init step is held equal, bit
for bit, to a normal step whose chains hold the same drawn weights.
``abf_remat`` is held bit for bit against no remat on every ABF path.

Known outliers, and what is held instead:

- The biases of every conv followed by a batch-statistics BN (the student's
  encoder convs and all decoder convs but the last) have a zero gradient in
  exact arithmetic: the BN subtracts the batch mean, so a per-channel shift
  changes nothing.  Both sides compute rounding noise of ~1e-7 of the
  global gradient norm.  Adam turns that noise into moves of about lr per
  step, so those biases, and the BN running means that add them in, follow
  the noise on each side.  Held: their gradients are zero up to rounding on
  both sides, and the parameters and those running means stay within
  Adam's bound of the reference.  The BN output they feed does not depend
  on them, which the other checks cover.
- The bias of each ABF block's bn2 gets a gradient ~1e-3 the size of the
  block's other gradients: the next consumer, the row-normalized Gram,
  hardly sees a per-channel shift.  It is a sum over B*D*T terms that
  cancel, so its float32 rounding is set by the terms and reaches a few
  1e-4 of the result.  Held: its error against 1e-4 of the same block's
  bn2.scale gradient, a sum over the same terms.  Under ``reviewkd``'s HCL
  the attention bias of each fusing block is such a sum too (~1e-5 of the
  global norm, read 3.5e-3 from JAX on its own norm): held against 1e-4 of
  the same block's ``att_conv.kernel`` gradient (measured 2.8e-6).
- HCL's log terms (``enc_loss``, ``dec_loss``) are means over maps of ~1e5
  elements, which the JAX package's float32 CPU reduction rounds by ~1e-5:
  its HCL of the port's own maps is 1.24e-5 from their float64 value, the
  port's 0 (``tests/test_torch_kd_hcl.py`` holds the port's to 1e-6).
  Held to ``HCL_LOG_RTOL``.
- Adam's first step moves a parameter by lr * g / (|g| + 1e-8), which turns
  the rounding of a gradient element near 1e-8 into a move of up to ~0.1 lr
  (an ABF conv2 weight read 1.84e-5 from JAX, against 1e-5).  Held after
  one step: each trained parameter to ``PARAM_ATOL`` beyond what the two
  gradients, held to the step-1 tolerances, give through that step.
"""

import dataclasses
import re

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import (
    DataConfig as JaxDataConfig,
    DCCRNConfig as JaxDCCRNConfig,
    DistillConfig as JaxDistillConfig,
    MeshConfig,
    OptimConfig as JaxOptimConfig,
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.ops.pallas.abf_block import abf_block_available
from speech_enhancement_clskd_tpu.ops.pallas.attfuse import attfuse_available
from speech_enhancement_clskd_tpu.ops.pallas.conv3x3 import conv3x3_available
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu.train.trainer import TrainState
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    DistillConfig,
    OptimConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.train.trainer import (
    Trainer,
    _global_norm,
    log_keys,
    warmup_cosine,
)
from torch_oracle import once_per_session
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    TRAIN_STATE_PARTS,
    flax_from_torch_state,
    load_train_state,
    torch_state_from_flax,
    train_state_arrays,
)

STEPS = 10
LR, B1 = 6e-4, 0.9
# float32 both sides, sums in another order.  At the same point (step 1, and
# step 10 from the JAX state after step 9); measured worst cases beside:
LOG_RTOL = 1e-5  # 4.3e-6 (step 1), 9.6e-6 (step 10)
GRAD_REL_L2 = 1e-4  # 1.8e-5 (step 1), 8.0e-5 (step 10, a decoder conv weight)
PARAM_ATOL = 1e-5  # beyond what the gradients give through Adam, after step 1
STAT_TOL = 1e-5  # relative to max(1, |reference|); 1.9e-6 after step 1
# after 10 independent steps (the drift the module docstring describes):
DRIFT_LOG_RTOL = 2e-4  # 7.6e-5
DRIFT_PARAM_ATOL = 1e-4  # 3.8e-5
DRIFT_STAT_TOL = 5e-5  # 1.4e-5
# HCL's terms, against the JAX float32 CPU mean's own rounding (1.24e-5 on
# the encoder term of the reviewkd step; module docstring)
HCL_LOG_RTOL = 5e-5
# a gradient that is zero in exact arithmetic, against the global norm
ZERO_GRAD = 1e-6  # 2.3e-7
# Adam moves a parameter by at most (1 - b1) / sqrt(1 - b2) ~ 3.2 lr a step
ADAM_STEP_BOUND = 3.2 * LR
ADAM_EPS = 1e-8

# the ABF kernel paths: per-op kernels, and the whole-block kernel
KERNEL_FLAGS = {"kernels": dict(abf_conv_pallas=True, abf_attfuse_pallas=True),
                "block": dict(abf_block_pallas=True)}
# the ABF options that leave the step's arithmetic as it is: the block
# recomputed in the backward, the 3x3 conv as nine matmuls, bn2's affine
# folded into the SPKD Grams
OPTION_FLAGS = {"abf_remat": dict(abf_remat=True),
                "abf_conv_ninedot": dict(abf_conv_ninedot=True),
                "spkd_bn2_fold": dict(spkd_bn2_fold=True)}
SNAPSHOT_FLAGS = {**KERNEL_FLAGS, **OPTION_FLAGS}

TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
DATA = dict(synthetic=True, synthetic_size=16, segment=0.5, batch_size=4)


def _jax_cfg(**distill):
    return JaxTrainConfig(teacher=JaxDCCRNConfig(**TINY_T), student=JaxDCCRNConfig(**TINY_S),
                          data=JaxDataConfig(**DATA), distill=JaxDistillConfig(**distill),
                          mesh=MeshConfig(data=1, model=1), max_epochs=1, log_every=1000)


def _cfg(**kw):
    return TrainConfig(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**TINY_S),
                       data=DataConfig(**DATA), **kw)


def _leaves(tree, prefix=()):
    """(path, copy) pairs: a copy, because the JAX step donates its state's
    buffers and the port's optimizer updates its tensors in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v)


def _flat(tree):
    return dict(_leaves(tree))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        clean = (0.1 * rng.standard_normal((4, 8000))).astype(np.float32)
        mix = clean + (0.05 * rng.standard_normal((4, 8000))).astype(np.float32)
        out.append((mix, clean))
    return out


def _short_batches(n):
    """The first ``n`` batches cut to 0.25 s, for the checks that hold the
    port against itself or against the JAX optimizer alone."""
    return [(mix[:, :4000], clean[:, :4000]) for mix, clean in _batches()[:n]]


def _port_grads(trainer):
    return {part: dict(_leaves(flax_from_torch_state(
        {n: p.grad for n, p in getattr(trainer, part).named_parameters()})["params"]))
        for part in ("student", "abf_enc", "abf_dec")}


def _snapshot(jax_state, jax_logs, trainer, port_logs, jax_grads):
    return {
        "jax_logs": {k: float(v) for k, v in jax_logs.items()},
        "port_logs": {k: float(v) for k, v in port_logs.items()},
        "jax_grads": jax_grads,
        "port_grads": _port_grads(trainer),
        "jax": {f: _flat(getattr(jax_state, f)) for part in TRAIN_STATE_PARTS
                for f in (f"{part}_params", f"{part}_stats")},
        "port": {k: dict(_leaves(v)) for k, v in train_state_arrays(trainer).items()},
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps on one CPU thread: the suite runs several workers at
    once, and torch's default of one thread per core in each of them
    oversubscribes the cores many times over.  One thread also makes the
    port's float32 sums, and so the measured errors below, independent of
    the machine's core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The initial JAX state, and the teacher's statistics and the ABF
    parameters in it; snapshots after step 1 and after 10 independent steps
    of both trainers; step 10 of a port trainer loaded with the JAX state
    after step 9 (``synced``); and step 1 of a port trainer with the ABF
    kernel flags (``kernels``, ``block``) and with each of
    ``OPTION_FLAGS``.  Computed once per test session
    (``torch_oracle.once_per_session``)."""
    return once_per_session(tmp_path_factory, "test_torch_trainer.runs", _runs)


def _runs():
    # the JAX step with KERNEL_FLAGS is its default step on the CPU
    assert not (conv3x3_available() or attfuse_available() or abf_block_available())
    jt = JaxTrainer(_jax_cfg())
    state = jt.init_state(jax.random.PRNGKey(0))
    trainer = Trainer(_cfg(), device="cpu").init_state()
    load_train_state(trainer, state)
    start = {f: _flat(getattr(state, f)) for f in
             ("teacher_stats", "abf_enc_params", "abf_dec_params")}
    start["state"] = jax.tree.map(np.array, state)
    snaps, mu_prev = {}, None
    synced = Trainer(_cfg(), device="cpu").init_state()
    for k, (mix, clean) in enumerate(_batches(), start=1):
        if k == STEPS:
            load_train_state(synced, jax.tree.map(np.array, state))
            synced_logs = synced.train_step(mix, clean)
        state, jax_logs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
        port_logs = trainer.train_step(mix, clean)
        if k == 1:
            flagged = {}
            for name, flags in SNAPSHOT_FLAGS.items():
                t = Trainer(_cfg(distill=DistillConfig(**flags)), device="cpu")
                load_train_state(t.init_state(), start["state"])
                flagged[name] = (t, t.train_step(mix, clean))
        mu = {p: _flat(v) for p, v in state.opt_state[0].mu.items()}
        if k in (1, STEPS):
            grads = {p: {n: (m - (0 if mu_prev is None else B1 * mu_prev[p][n])) / (1 - B1)
                         for n, m in mu[p].items()} for p in mu}
            snaps[k] = _snapshot(state, jax_logs, trainer, port_logs, grads)
        if k == 1:
            for name, (t, logs) in flagged.items():
                snaps[name] = _snapshot(state, jax_logs, t, logs, grads)
        mu_prev = mu
    snaps["synced"] = _snapshot(state, jax_logs, synced, synced_logs, grads)
    return start, snaps


def _bn_preceded_conv_bias(part, path, student_params):
    """A student conv bias that a batch-statistics BN follows."""
    if part != "student" or path[-1] not in ("br", "bi"):
        return False
    m = re.fullmatch(r"(enc|dec)(\d+)_conv", path[0])
    return m is not None and f"{m.group(1)}{m.group(2)}_bn" in student_params


def _bn_after_conv(path):
    m = re.fullmatch(r"(enc|dec)(\d+)_bn", path[0])
    return m is not None and path[-1] == "mean"


@pytest.mark.parametrize("step", [1, "synced", STEPS, "kernels", "block"] + list(OPTION_FLAGS))
def test_step_logs_match_jax(runs, step):
    snap = runs[1][step]
    rtol = DRIFT_LOG_RTOL if step == STEPS else LOG_RTOL
    assert set(snap["port_logs"]) == set(snap["jax_logs"]) == set(log_keys("clskd"))
    for k, want in snap["jax_logs"].items():
        assert np.isfinite(snap["port_logs"][k]), k
        np.testing.assert_allclose(snap["port_logs"][k], want, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("step", [1, "synced", "kernels", "block"] + list(OPTION_FLAGS))
def test_step_gradients_match_jax(runs, step):
    _check_gradients(runs[1][step])


def _check_gradients(snap, cancelling=("bn2",)):
    """``cancelling``: the blocks whose bias gradient is held against the
    same block's weight gradient (``bn2``: against its scale; ``att_conv``,
    under HCL: against its kernel), see the module docstring."""
    weight = {"bn2": "scale", "att_conv": "kernel"}
    student_params = {p[0] for p in snap["jax"]["student_params"]}
    norm = snap["jax_logs"]["grad_norm"]
    for part, want_part in snap["jax_grads"].items():
        got_part = snap["port_grads"][part]
        assert got_part.keys() == want_part.keys(), part
        for path, want in want_part.items():
            got = got_part[path]
            if _bn_preceded_conv_bias(part, path, student_params):
                assert np.abs(got).max() <= ZERO_GRAD * norm, (part, path)
                assert np.abs(want).max() <= ZERO_GRAD * norm, (part, path)
                continue
            err = np.linalg.norm(got - want)
            if path[-1] == "bias" and path[-2] in cancelling:
                scale = np.linalg.norm(want_part[path[:-1] + (weight[path[-2]],)])
                assert err <= GRAD_REL_L2 * scale, (part, path, err, scale)
                continue
            assert err <= GRAD_REL_L2 * np.linalg.norm(want), (part, path, err)


@pytest.mark.parametrize("step", [1, STEPS, "kernels", "block"] + list(OPTION_FLAGS))
def test_step_parameters_match_jax(runs, step):
    """After one step (``1``, ``kernels``, ``block``) each trained parameter
    is held to ``PARAM_ATOL`` beyond what the two gradients, held by
    ``test_step_gradients_match_jax``, give through Adam's first step,
    p -= lr * g / (|g| + eps): an element whose |g| is near eps = 1e-8 moves
    by up to ~0.1 lr on the gradients' rounding alone, as
    ``tests/test_torch_strategies.py`` holds its steps.  After 10
    independent steps the drift tolerance holds."""
    _check_parameters(runs[1][step], step != STEPS, STEPS)


def _check_parameters(snap, one_step, steps):
    student_params = {p[0] for p in snap["jax"]["student_params"]}
    for part in ("student", "teacher", "abf_enc", "abf_dec"):
        want_part = snap["jax"][f"{part}_params"]
        got_part = snap["port"][f"{part}_params"]
        assert got_part.keys() == want_part.keys(), part
        for path, want in want_part.items():
            diff = np.abs(got_part[path] - want)
            if _bn_preceded_conv_bias(part, path, student_params):
                assert diff.max() <= 2 * (1 if one_step else steps) * ADAM_STEP_BOUND, \
                    (part, path, diff.max())
            elif not one_step:
                assert diff.max() <= DRIFT_PARAM_ATOL, (part, path, diff.max())
            elif part in snap["jax_grads"]:
                g_port, g_jax = snap["port_grads"][part][path], snap["jax_grads"][part][path]
                implied = LR * np.abs(g_port / (np.abs(g_port) + ADAM_EPS)
                                      - g_jax / (np.abs(g_jax) + ADAM_EPS))
                assert (diff - implied).max() <= PARAM_ATOL, (part, path, diff.max())
            else:  # the frozen teacher
                assert diff.max() <= PARAM_ATOL, (part, path, diff.max())


@pytest.mark.parametrize("step", [1, "synced", STEPS, "kernels", "block"] + list(OPTION_FLAGS))
def test_step_bn_statistics_match_jax(runs, step):
    _check_statistics(runs[1][step], step == STEPS, STEPS)


def _check_statistics(snap, drifted, steps):
    for part in TRAIN_STATE_PARTS:
        want_part = snap["jax"][f"{part}_stats"]
        got_part = snap["port"][f"{part}_stats"]
        assert got_part.keys() == want_part.keys(), part
        for path, want in want_part.items():
            err = np.abs(got_part[path] - want).max() / max(1.0, np.abs(want).max())
            tol = STAT_TOL
            if drifted:
                tol = DRIFT_STAT_TOL
                if part == "student" and _bn_after_conv(path):
                    # a running mean that adds in a noise-driven conv bias
                    tol += 2 * steps * ADAM_STEP_BOUND
            assert err <= tol, (part, path, err)


def test_teacher_statistics_do_not_change(runs):
    start, snaps = runs
    for step in (1, STEPS):
        for path, want in start["teacher_stats"].items():
            np.testing.assert_array_equal(snaps[step]["port"]["teacher_stats"][path], want)
            np.testing.assert_array_equal(snaps[step]["jax"]["teacher_stats"][path], want)


def test_abf_parameters_move(runs):
    start, snaps = runs
    for part in ("abf_enc_params", "abf_dec_params"):
        after = snaps[STEPS]["port"][part]
        moved = [not np.array_equal(after[p], v) for p, v in start[part].items()]
        assert all(moved), part


def test_train_state_round_trip_is_exact(runs):
    state = runs[0]["state"]
    trainer = Trainer(_cfg(), device="cpu").init_state(5)
    load_train_state(trainer, state)
    back = train_state_arrays(trainer)
    for part in TRAIN_STATE_PARTS:
        for f in (f"{part}_params", f"{part}_stats"):
            want = _flat(getattr(state, f))
            got = dict(_leaves(back[f]))
            assert got.keys() == want.keys(), f
            for path, v in want.items():
                assert got[path].dtype == v.dtype
                np.testing.assert_array_equal(got[path], v, err_msg=f"{f} {path}")
    assert trainer.optimizer.state == {} and trainer.step == 0
    state_dict = torch_state_from_flax({"params": state.abf_enc_params,
                                        "batch_stats": state.abf_enc_stats})
    assert tuple(state_dict["abf0.conv2.kernel"].shape) == (32, 64, 3, 3)


def test_init_state_is_seeded():
    a = Trainer(_cfg(), device="cpu").init_state(3)
    b = Trainer(_cfg(), device="cpu").init_state(3)
    c = Trainer(_cfg(), device="cpu").init_state(4)
    for part in TRAIN_STATE_PARTS:
        sa, sb, sc = (getattr(t, part).state_dict() for t in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), part
        assert any(not torch.equal(sa[k], sc[k]) for k in sa), part
    assert not any(p.requires_grad for p in a.teacher.parameters())
    assert all(p.requires_grad for m in a.trainable().values() for p in m.parameters())


# -------------------------------------------- the options of the rest of training

# the optimizer options and their steps: 3 where the clip or the schedule
# changes from step to step; the clip is below the step's gradient norm
# (~1), so every step clips; the cosine schedule's warmup of 2 gives
# learning rates 0, lr / 2, lr
OPTIM_CASES = {
    "adamw": (dict(optimizer="adamw", weight_decay=0.5), 2),
    "weight_decay": (dict(weight_decay=1.0), 2),
    "grad_clip": (dict(grad_clip=0.25), 3),
    "cosine": (dict(lr_schedule="cosine", warmup_steps=2), 3),
}
# the port's parameters after an update against optax's update of the same
# parameters by the same gradients: float32 rounding of p - lr * u, a few
# ulp of |p| <= ~2
OPTIM_ATOL = 1e-6  # 1.19e-7 (weight_decay, a BN scale near 1)


def _option_cfgs(distill=None, optim=None, rnn_units=TINY_S["rnn_units"]):
    """The port's and the JAX TrainConfig of one option: one epoch of 4
    steps (the cosine schedule's length)."""
    student = dict(TINY_S, rnn_units=rnn_units)
    distill, optim = distill or {}, optim or {}
    port = TrainConfig(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**student),
                       data=DataConfig(**DATA), distill=DistillConfig(**distill),
                       optim=OptimConfig(**optim), max_epochs=1)
    ref = dataclasses.replace(_jax_cfg(**distill), student=JaxDCCRNConfig(**student),
                              optim=JaxOptimConfig(**optim))
    return port, ref


def _jax_state(jt, trainer):
    """A JAX ``TrainState`` holding ``trainer``'s weights, at step 0, with
    the JAX trainer's fresh optimizer."""
    a = {k: jax.tree.map(jnp.asarray, v) for k, v in train_state_arrays(trainer).items()}
    trainable = jt._trainable_of(a["student_params"], a["abf_enc_params"], a["abf_dec_params"])
    return TrainState(step=jnp.zeros((), jnp.int32), opt_state=jt.tx.init(trainable),
                      rng=jax.random.PRNGKey(0), **a)


def _reviewkd_step(rnn_units):
    """One ``reviewkd`` step of both trainers from the port's seeded weights,
    the student's LSTM ``rnn_units`` wide: the snapshot of step 1."""
    cfg, jcfg = _option_cfgs(dict(strategy="reviewkd"), rnn_units=rnn_units)
    trainer = Trainer(cfg, device="cpu").init_state(0)
    jt = JaxTrainer(jcfg)
    state = _jax_state(jt, trainer)
    mix, clean = _batches()[0]
    state, jax_logs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
    port_logs = trainer.train_step(mix, clean)
    grads = {p: {n: m / (1 - B1) for n, m in _flat(v).items()}
             for p, v in state.opt_state[0].mu.items()}
    return _snapshot(state, jax_logs, trainer, port_logs, grads)


@pytest.mark.parametrize("rnn_units", [TINY_S["rnn_units"], TINY_T["rnn_units"]],
                         ids=["reviewkd", "reviewkd_equal_lstm_widths"])
def test_reviewkd_step_matches_jax(rnn_units):
    """A ``reviewkd`` step against the JAX step, held as step 1 (HCL's
    outliers as the module docstring says): with the student's LSTM
    narrower than the teacher's (SPKD on the LSTM taps) and as wide
    (HCL)."""
    snap = _reviewkd_step(rnn_units)
    assert set(snap["port_logs"]) == set(snap["jax_logs"]) == set(log_keys("reviewkd"))
    for key, want in snap["jax_logs"].items():
        rtol = HCL_LOG_RTOL if key in ("enc_loss", "dec_loss") else LOG_RTOL
        assert np.isfinite(snap["port_logs"][key]), key
        np.testing.assert_allclose(snap["port_logs"][key], want, rtol=rtol, err_msg=key)
    _check_gradients(snap, ("bn2", "att_conv"))
    _check_parameters(snap, True, 1)
    _check_statistics(snap, False, 1)


def _tree(trainer, grads=False):
    """The trainable modules' parameters (or their gradients) as the flax
    tree the JAX trainer's optimizer takes."""
    return {part: flax_from_torch_state({n: p.grad if grads else p
                                         for n, p in m.named_parameters()})["params"]
            for part, m in trainer.trainable().items()}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_option_matches_jax(case):
    """An optimizer option against the JAX trainer's own optimizer
    (``_make_optimizer``: optax's adamw, clip_by_global_norm and
    warmup-cosine schedule) over the case's steps.  Optax updates the
    port's parameters before each step by the step's raw gradients (the
    port's own where nothing clips; under ``grad_clip`` those of a twin
    trainer with the default optimizer, loaded with the port's state, which
    takes the same step); the port's parameters after its step are held to
    ``OPTIM_ATOL`` of optax's, and under ``grad_clip`` the gradients it
    applied to optax's clipped ones, their norm to the clip.  That the
    option does something: the parameters stand apart from what plain Adam
    (optax ``adam``, the default) makes of the same gradients by at least
    100 ``OPTIM_ATOL``; ``cosine`` takes optax's learning rates (0, lr / 2,
    lr)."""
    fields, steps = OPTIM_CASES[case]
    o = OptimConfig(**fields)
    cfg, jcfg = _option_cfgs(optim=fields)
    trainer = Trainer(cfg, device="cpu").init_state(0)
    twin = Trainer(_option_cfgs()[0], device="cpu").init_state(0) if o.grad_clip else None
    tx, plain = JaxTrainer(jcfg).tx, optax.adam(o.lr)
    start = jax.tree.map(jnp.asarray, _tree(trainer))
    states = (tx.init(start), plain.init(start))

    @jax.jit
    def update(raw, states, params):
        (updates, state), (plain_updates, plain_state) = (
            t.update(raw, st, params) for t, st in zip((tx, plain), states))
        clipped = optax.clip_by_global_norm(o.grad_clip).update(raw, None)[0] if o.grad_clip else raw
        return (optax.apply_updates(params, updates), optax.apply_updates(params, plain_updates),
                (state, plain_state), clipped)

    apart = 0.0
    for k, (mix, clean) in enumerate(_short_batches(steps)):
        params = jax.tree.map(jnp.asarray, _tree(trainer))
        if twin is not None:
            for part in trainer.trainable():
                getattr(twin, part).load_state_dict(getattr(trainer, part).state_dict())
        logs = trainer.train_step(mix, clean)
        raw_from = trainer
        if twin is not None:
            twin_logs = twin.train_step(mix, clean)
            assert {n: v.item() for n, v in logs.items()} == {
                n: v.item() for n, v in twin_logs.items()}
            raw_from = twin
        want, by_adam, states, clipped = update(
            jax.tree.map(jnp.asarray, _tree(raw_from, grads=True)), states, params)
        want, by_adam = (_flat(jax.tree.map(np.asarray, t)) for t in (want, by_adam))
        got = _flat(_tree(trainer))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert np.abs(got[path] - w).max() <= OPTIM_ATOL, (k, path)
            apart = max(apart, float(np.abs(got[path] - by_adam[path]).max()))
        if o.grad_clip:
            applied = _flat(_tree(trainer, grads=True))
            for path, w in _flat(jax.tree.map(np.asarray, clipped)).items():
                assert np.linalg.norm(applied[path] - w) <= 1e-6 * np.linalg.norm(w) + 1e-12, path
            assert logs["grad_norm"].item() > o.grad_clip
            np.testing.assert_allclose(_global_norm(
                p for m in trainer.trainable().values() for p in m.parameters()).item(),
                o.grad_clip, rtol=1e-6)
    if case != "grad_clip":  # Adam scales a clip away, but for its epsilon
        assert apart > 100 * OPTIM_ATOL, apart
    assert isinstance(trainer.optimizer, torch.optim.AdamW) == (case in ("adamw", "weight_decay"))
    if case == "cosine":
        sched = optax.warmup_cosine_decay_schedule(0.0, o.lr, o.warmup_steps,
                                                   trainer.total_steps(), o.lr * 0.01)
        got = [trainer.lr_at(k) for k in range(steps)]
        np.testing.assert_allclose(got, [float(sched(k)) for k in range(steps)], rtol=1e-6)
        assert got[:2] == [0.0, o.lr / 2] and trainer.optimizer.param_groups[0]["lr"] == got[-1]


@pytest.mark.parametrize("warmup,total", [(0, 10), (2, 10), (3, 4), (5, 200)])
def test_warmup_cosine_matches_optax(warmup, total):
    lr = 6e-4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, lr * 0.01)
    steps = list(range(total + 3))
    # optax evaluates the cosine in float32
    np.testing.assert_allclose([warmup_cosine(k, lr, warmup, total, lr * 0.01) for k in steps],
                               [float(sched(k)) for k in steps], rtol=1e-5)


def test_cosine_without_decay_steps_raises():
    cfg, _ = _option_cfgs(optim=dict(lr_schedule="cosine", warmup_steps=4))
    with pytest.raises(ValueError, match="cosine schedule"):
        Trainer(cfg, device="cpu").init_state(0)  # 4 total steps, all warmup


def _manifest(directory, lengths):
    directory.mkdir()
    with open(directory / f"mixture_{directory.name}_mix_single.csv", "w") as f:
        f.write("mixture_ID,mixture_path,source_1_path,length\n")
        for i, n in enumerate(lengths):
            f.write(f"id{i},m{i}.wav,s{i}.wav,{n}\n")
    return str(directory)


@pytest.mark.parametrize("data", ["synthetic", "manifest", "no_manifest"])
def test_total_steps_matches_jax(tmp_path, data):
    """The cosine schedule's length: the synthetic set's size, a manifest's
    clips at least a segment long (9 of 11 here), or 20000 clips."""
    fields = dict(synthetic_size=22, batch_size=4, segment=0.5)
    if data == "manifest":
        train = _manifest(tmp_path / "train", [8000] * 9 + [10, 20])
        fields.update(synthetic=False, train_dir=train, valid_dir=train)
    elif data == "no_manifest":
        fields.update(synthetic=False, train_dir=str(tmp_path / "absent"))
    port = Trainer(dataclasses.replace(_cfg(), data=DataConfig(**{**DATA, **fields}),
                                       max_epochs=3), device="cpu")
    ref = JaxTrainer(dataclasses.replace(_jax_cfg(), data=JaxDataConfig(**{**DATA, **fields}),
                                         max_epochs=3))
    want = {"synthetic": 5 * 3, "manifest": 2 * 3, "no_manifest": 5000 * 3}[data]
    assert port.total_steps() == ref.total_steps() == want


def test_abf_reinit_each_step_equals_a_normal_step():
    """Each re-init step draws the ABF chains afresh (``draw_abf(step)``)
    and equals, bit for bit, a normal step whose chains hold the same drawn
    weights: its logs (with no ``gn_abf``; ``grad_norm`` over the student
    alone, as the JAX step takes it), the student's gradients, parameters
    and statistics.  The drawn weights are neither trained nor given
    gradients, and two steps draw different weights."""
    cfg = _cfg(distill=DistillConfig(abf_reinit_each_step=True))
    reinit, drawn = (Trainer(cfg, device="cpu").init_state(0) for _ in range(2))
    normal = Trainer(_cfg(), device="cpu").init_state(0)
    assert set(reinit.trainable()) == {"student"}
    draws = []
    for k, (mix, clean) in enumerate(_short_batches(2)):
        drawn.draw_abf(k)
        draws.append({part: {n: t.clone() for n, t in getattr(drawn, part).state_dict().items()}
                      for part in ("abf_enc", "abf_dec")})
        for part, sd in draws[-1].items():
            getattr(normal, part).load_state_dict(sd)
        logs = {n: v.item() for n, v in reinit.train_step(mix, clean).items()}
        want = {n: v.item() for n, v in normal.train_step(mix, clean).items()}
        assert set(logs) == set(log_keys("clskd", abf_reinit_each_step=True))
        assert set(want) - set(logs) == {"gn_abf"}
        student_norm = _global_norm(normal.student.parameters()).item()
        assert logs == dict({n: want[n] for n in logs}, grad_norm=student_norm), k
        for (name, p), q in zip(reinit.student.named_parameters(), normal.student.parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), (k, name)
        for (name, b), c in zip(reinit.student.named_buffers(), normal.student.buffers()):
            assert torch.equal(b, c), (k, name)
        for part, sd in draws[-1].items():
            for name, p in getattr(reinit, part).named_parameters():
                assert p.grad is None and torch.equal(p, sd[name]), (k, part, name)
    assert not torch.equal(draws[0]["abf_enc"]["abf0.conv1.kernel"],
                           draws[1]["abf_enc"]["abf0.conv1.kernel"])


# the ABF paths under remat: the default chain, the whole-block kernel's,
# and the whole-block kernel's on bf16 taps
REMAT_FLAGS = {"default": {}, "block": KERNEL_FLAGS["block"],
               "block_bf16": dict(KERNEL_FLAGS["block"], taps_dtype="bfloat16")}


@pytest.mark.parametrize("path", list(REMAT_FLAGS))
def test_abf_remat_is_bit_exact(path):
    """``abf_remat`` against no remat over two steps, on the default ABF
    path and on the whole-block kernel's, in float32 and on bf16 taps (its
    autograd function recomputed under the checkpoint): the same bits in
    every log, gradient, parameter and running statistic (a recomputed block
    does not move its BN statistics a second time)."""
    flags = REMAT_FLAGS[path]
    a = Trainer(_cfg(distill=DistillConfig(**flags)), device="cpu").init_state(0)
    b = Trainer(_cfg(distill=DistillConfig(abf_remat=True, **flags)), device="cpu").init_state(0)
    for mix, clean in _short_batches(2):
        la, lb = a.train_step(mix, clean), b.train_step(mix, clean)
        assert {k: v.item() for k, v in la.items()} == {k: v.item() for k, v in lb.items()}
        for part in TRAIN_STATE_PARTS:
            ma, mb = getattr(a, part), getattr(b, part)
            for (name, p), q in zip(ma.named_parameters(), mb.parameters()):
                assert torch.equal(p, q), (part, name)
                assert (p.grad is None and q.grad is None) or torch.equal(p.grad, q.grad)
            for (name, x), y in zip(ma.named_buffers(), mb.buffers()):
                assert torch.equal(x, y), (part, name)


def test_bf16_compute_raises():
    """bf16 compute with float32 taps leaves the taps in bf16 (as the JAX step
    does), so the ABF chains run in bf16: since the bf16 whole-block kernel
    was ported, nothing raises; the per-op chain and the whole-block
    kernel's both build and leave the taps uncast."""
    student = DCCRNConfig(**TINY_S, compute_dtype="bfloat16")
    cfg = TrainConfig(teacher=DCCRNConfig(**TINY_T), student=student)
    block = Trainer(dataclasses.replace(cfg, distill=DistillConfig(abf_block_pallas=True)),
                    device="cpu")
    assert block.taps_dtype is None and block.abf_enc.abf0.block_pallas
    assert Trainer(cfg, device="cpu").taps_dtype is None


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown distill strategy"):
        Trainer(_cfg(distill=DistillConfig(strategy="nope")), device="cpu")


def test_cuda_trainer_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg())  # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg(), device="cuda")


def test_step_before_init_state_raises():
    with pytest.raises(RuntimeError, match="init_state"):
        Trainer(_cfg(), device="cpu").train_step(np.zeros((4, 800), np.float32),
                                                 np.zeros((4, 800), np.float32))
