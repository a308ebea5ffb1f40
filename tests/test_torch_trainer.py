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
  bn2.scale gradient, a sum over the same terms.
- Adam's first step moves a parameter by lr * g / (|g| + 1e-8), which turns
  the rounding of a gradient element near 1e-8 into a move of up to ~0.1 lr
  (an ABF conv2 weight read 1.84e-5 from JAX, against 1e-5).  Held after
  one step: each trained parameter to ``PARAM_ATOL`` beyond what the two
  gradients, held to the step-1 tolerances, give through that step.
"""

import re

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
    TrainConfig as JaxTrainConfig,
)
from speech_enhancement_clskd_tpu.ops.pallas.abf_block import abf_block_available
from speech_enhancement_clskd_tpu.ops.pallas.attfuse import attfuse_available
from speech_enhancement_clskd_tpu.ops.pallas.conv3x3 import conv3x3_available
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    DistillConfig,
    OptimConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer, log_keys
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
# a gradient that is zero in exact arithmetic, against the global norm
ZERO_GRAD = 1e-6  # 2.3e-7
# Adam moves a parameter by at most (1 - b1) / sqrt(1 - b2) ~ 3.2 lr a step
ADAM_STEP_BOUND = 3.2 * LR
ADAM_EPS = 1e-8

# the ABF kernel paths: per-op kernels, and the whole-block kernel
KERNEL_FLAGS = {"kernels": dict(abf_conv_pallas=True, abf_attfuse_pallas=True),
                "block": dict(abf_block_pallas=True)}

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
def runs():
    """The initial JAX state, and the teacher's statistics and the ABF
    parameters in it; snapshots after step 1 and after 10 independent steps
    of both trainers; step 10 of a port trainer loaded with the JAX state
    after step 9 (``synced``); and step 1 of a port trainer with the ABF
    kernel flags (``kernels``, ``block``)."""
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
            for name, flags in KERNEL_FLAGS.items():
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


@pytest.mark.parametrize("step", [1, "synced", STEPS, "kernels", "block"])
def test_step_logs_match_jax(runs, step):
    snap = runs[1][step]
    rtol = DRIFT_LOG_RTOL if step == STEPS else LOG_RTOL
    assert set(snap["port_logs"]) == set(snap["jax_logs"]) == set(log_keys("clskd"))
    for k, want in snap["jax_logs"].items():
        assert np.isfinite(snap["port_logs"][k]), k
        np.testing.assert_allclose(snap["port_logs"][k], want, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("step", [1, "synced", "kernels", "block"])
def test_step_gradients_match_jax(runs, step):
    snap = runs[1][step]
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
            if path[-2:] == ("bn2", "bias"):
                scale = np.linalg.norm(want_part[path[:-1] + ("scale",)])
                assert err <= GRAD_REL_L2 * scale, (part, path, err, scale)
                continue
            assert err <= GRAD_REL_L2 * np.linalg.norm(want), (part, path, err)


@pytest.mark.parametrize("step", [1, STEPS, "kernels", "block"])
def test_step_parameters_match_jax(runs, step):
    """After one step (``1``, ``kernels``, ``block``) each trained parameter
    is held to ``PARAM_ATOL`` beyond what the two gradients, held by
    ``test_step_gradients_match_jax``, give through Adam's first step,
    p -= lr * g / (|g| + eps): an element whose |g| is near eps = 1e-8 moves
    by up to ~0.1 lr on the gradients' rounding alone, as
    ``tests/test_torch_strategies.py`` holds its steps.  After 10
    independent steps the drift tolerance holds."""
    snap = runs[1][step]
    one_step = step != STEPS
    student_params = {p[0] for p in snap["jax"]["student_params"]}
    for part in ("student", "teacher", "abf_enc", "abf_dec"):
        want_part = snap["jax"][f"{part}_params"]
        got_part = snap["port"][f"{part}_params"]
        assert got_part.keys() == want_part.keys(), part
        for path, want in want_part.items():
            diff = np.abs(got_part[path] - want)
            if _bn_preceded_conv_bias(part, path, student_params):
                assert diff.max() <= 2 * (1 if one_step else STEPS) * ADAM_STEP_BOUND, \
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


@pytest.mark.parametrize("step", [1, "synced", STEPS, "kernels", "block"])
def test_step_bn_statistics_match_jax(runs, step):
    snap = runs[1][step]
    for part in TRAIN_STATE_PARTS:
        want_part = snap["jax"][f"{part}_stats"]
        got_part = snap["port"][f"{part}_stats"]
        assert got_part.keys() == want_part.keys(), part
        for path, want in want_part.items():
            err = np.abs(got_part[path] - want).max() / max(1.0, np.abs(want).max())
            tol = STAT_TOL
            if step == STEPS:
                tol = DRIFT_STAT_TOL
                if part == "student" and _bn_after_conv(path):
                    # a running mean that adds in a noise-driven conv bias
                    tol += 2 * STEPS * ADAM_STEP_BOUND
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


UNPORTED = {
    "reviewkd": dict(distill=DistillConfig(strategy="reviewkd")),
    "abf_reinit_each_step": dict(distill=DistillConfig(abf_reinit_each_step=True)),
    "taps_bf16": dict(distill=DistillConfig(taps_dtype="bfloat16")),
    "abf_remat": dict(distill=DistillConfig(abf_remat=True)),
    "abf_conv_ninedot": dict(distill=DistillConfig(abf_conv_ninedot=True)),
    "spkd_bn2_fold": dict(distill=DistillConfig(spkd_bn2_fold=True)),
    "adamw": dict(optim=OptimConfig(optimizer="adamw")),
    "weight_decay": dict(optim=OptimConfig(weight_decay=1e-4)),
    "grad_clip": dict(optim=OptimConfig(grad_clip=1.0)),
    "cosine": dict(optim=OptimConfig(lr_schedule="cosine")),
    "scan_steps": dict(scan_steps=4),
}


@pytest.mark.parametrize("change", list(UNPORTED.values()), ids=list(UNPORTED))
def test_unported_options_raise(change):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        Trainer(_cfg(**change), device="cpu")


def test_bf16_compute_raises():
    cfg = TrainConfig(student=DCCRNConfig(**TINY_S, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
        Trainer(cfg, device="cpu")


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
