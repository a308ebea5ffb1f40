"""The port's ``spkd``, ``mse`` and ``stft`` training steps against the JAX
``Trainer.train_step``.

For each strategy both trainers start from one JAX ``TrainState`` (seeded
teacher and student; no ABF chains, whose ``abf_*`` fields are ``None``,
carried over by ``utils.bridge.load_train_state``) and take one step on the
same seeded batch, at the tiny geometry of ``tests/test_train.py``.  Every
log value, every gradient, every parameter and every BN statistic is held to
the step-1 tolerances of ``tests/test_torch_trainer.py``.  The JAX step does
not return its gradients; after one step its Adam moment is mu = 0.1 g.

Case ``spkd_k2`` is the ``spkd`` step with the port's ``_PALLAS_MIN_D`` set
to 0, so the tiny waveforms (4 x 8000 samples) take the fused Gram pair
(``kernels/gram.py::gram_pair``; its plain version on the CPU, asserted with
a spy) instead of the sliced matmuls.  The JAX step takes its XLA Grams on
the CPU whatever the shape, so both port routes stand against one JAX step.

These steps are worse conditioned than the ``clskd`` step: the base
log-STFT-magnitude loss carries most of the gradient, and no SPKD term on
the taps lifts the LSTM's and the PReLUs' gradients.  Measured with the port
alone (one thread): scaling the input by 1 + 1e-7, one rounding, moves the
gradients of tensors that carry < 1 % of the global norm (the PReLU slopes,
the LSTM biases) by up to 5.3e-4 of their own norm, against 2e-5 in the
``clskd`` step.  So, beside the step-1 tolerances:

- each gradient tensor is held to ``GRAD_REL_L2`` of its own norm or of
  ``GRAD_FLOOR`` of the global norm, whichever is larger (the worst
  tensor above the floor: 8.0e-5, ``enc2_conv.wi`` of ``stft``);
- Adam's first step moves a parameter by lr * g / (|g| + 1e-8), which
  turns the rounding of a gradient element near 1e-8 (~1e-8 of the global
  norm, LSTM input weights) into a move of up to ~0.1 lr.  Each parameter is
  held to ``PARAM_ATOL`` beyond what the two gradients, held above, give
  through that step.

Known outlier, held as ``tests/test_torch_trainer.py`` holds it: the biases
of the student's convs followed by a batch-statistics BN have a zero
gradient in exact arithmetic; both sides give rounding noise, which Adam
turns into moves of about lr.
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
from speech_enhancement_clskd_tpu.train import Trainer as JaxTrainer
from torch_oracle import each_once_per_session
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    DistillConfig,
    TrainConfig,
)
from speech_enhancement_clskd_tpu_torch.kernels import gram
from speech_enhancement_clskd_tpu_torch.losses import kd
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer, log_keys
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    load_train_state,
    train_state_arrays,
)

LR = 6e-4
# step-1 tolerances of tests/test_torch_trainer.py (float32 both sides, sums
# in another order); measured worst beside, one torch thread:
LOG_RTOL = 1e-5  # 9.2e-6 (gn_lstm of stft, a norm 1/400 of the global one)
GRAD_REL_L2 = 1e-4
GRAD_FLOOR = 1e-2  # of the global gradient norm (see the module docstring)
PARAM_ATOL = 1e-5  # beyond what the gradients give through Adam: 3.2e-8 (5.3e-5 raw)
STAT_TOL = 1e-5  # relative to max(1, |reference|)
ZERO_GRAD = 1e-6  # a gradient that is zero in exact arithmetic, against the global norm
ADAM_STEP_BOUND = 3.2 * LR  # (1 - b1) / sqrt(1 - b2) lr: Adam's largest move a step
ADAM_EPS = 1e-8

TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
DATA = dict(synthetic=True, synthetic_size=16, segment=0.5, batch_size=4)
PARTS = ("student", "teacher")
# case -> (strategy, fused Gram pair forced on the port's side)
CASES = {"spkd": ("spkd", False), "spkd_k2": ("spkd", True), "mse": ("mse", False),
         "stft": ("stft", False)}


def _leaves(tree, prefix=()):
    """(path, copy) pairs: a copy, because the JAX step donates its state's
    buffers and the port's optimizer updates its tensors in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v)


def _batch():
    rng = np.random.default_rng(0)
    clean = (0.1 * rng.standard_normal((4, 8000))).astype(np.float32)
    return clean + (0.05 * rng.standard_normal((4, 8000))).astype(np.float32), clean


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps on one CPU thread, as in tests/test_torch_trainer.py:
    the suite runs several workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run(strategy):
    """The JAX state before one ``strategy`` step, and the step's logs,
    gradients and state after it (one JAX compile)."""
    mix, clean = _batch()
    cfg = JaxTrainConfig(teacher=JaxDCCRNConfig(**TINY_T), student=JaxDCCRNConfig(**TINY_S),
                         data=JaxDataConfig(**DATA),
                         distill=JaxDistillConfig(strategy=strategy),
                         mesh=MeshConfig(data=1, model=1), max_epochs=1, log_every=1000)
    jt = JaxTrainer(cfg)
    state = jt.init_state(jax.random.PRNGKey(0))
    start = jax.tree.map(np.array, state)
    state, logs = jt.train_step(state, jnp.asarray(mix), jnp.asarray(clean))
    assert state.abf_enc_params is None and start.abf_enc_params is None
    return dict(
        start=start, logs={k: float(v) for k, v in logs.items()},
        grads={n: m / 0.1 for n, m in _leaves(state.opt_state[0].mu["student"])},
        state={f"{p}_{c}": dict(_leaves(getattr(state, f"{p}_{c}")))
               for p in PARTS for c in ("params", "stats")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the JAX step's logs, gradients and state after one step
    (each strategy's computed once per test session, side by side across
    workers: ``torch_oracle.each_once_per_session``), and the port's after
    the same step from the same start."""
    jax_runs = each_once_per_session(tmp_path_factory, "test_torch_strategies.jax_run",
                                     sorted({s for s, _ in CASES.values()}), _jax_run)
    mix, clean = _batch()
    out = {}
    for case, (strategy, fused) in CASES.items():
        ref = jax_runs[strategy]
        trainer = Trainer(TrainConfig(teacher=DCCRNConfig(**TINY_T),
                                      student=DCCRNConfig(**TINY_S), data=DataConfig(**DATA),
                                      distill=DistillConfig(strategy=strategy)),
                          device="cpu").init_state()
        load_train_state(trainer, ref["start"])
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            if fused:
                mp.setattr(kd, "_PALLAS_MIN_D", 0)
            reference = gram.gram_pair_reference
            mp.setattr(gram, "gram_pair_reference",
                       lambda *a: calls.append(a[0].shape) or reference(*a))
            logs = trainer.train_step(mix, clean)
        grads = dict(_leaves(flax_from_torch_state(
            {n: p.grad for n, p in trainer.student.named_parameters()})["params"]))
        out[case] = dict(jax=ref, logs={k: float(v) for k, v in logs.items()}, grads=grads,
                         state={k: dict(_leaves(v))
                                for k, v in train_state_arrays(trainer).items()},
                         gram_calls=calls, trainer=trainer)
    return out


def _bn_preceded_conv_bias(path, student_params):
    """A student conv bias that a batch-statistics BN follows."""
    if path[-1] not in ("br", "bi"):
        return False
    m = re.fullmatch(r"(enc|dec)(\d+)_conv", path[0])
    return m is not None and f"{m.group(1)}{m.group(2)}_bn" in student_params


@pytest.mark.parametrize("case", list(CASES))
def test_step_logs_match_jax(runs, case):
    run = runs[case]
    want = run["jax"]["logs"]
    assert set(run["logs"]) == set(want) == set(log_keys(CASES[case][0]))
    for k, v in want.items():
        assert np.isfinite(run["logs"][k]), k
        np.testing.assert_allclose(run["logs"][k], v, rtol=LOG_RTOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_step_gradients_match_jax(runs, case):
    run = runs[case]
    want_all = run["jax"]["grads"]
    norm = run["jax"]["logs"]["grad_norm"]
    student_params = {p[0] for p in want_all}
    assert run["grads"].keys() == want_all.keys()
    for path, want in want_all.items():
        got = run["grads"][path]
        if _bn_preceded_conv_bias(path, student_params):
            assert np.abs(got).max() <= ZERO_GRAD * norm, path
            assert np.abs(want).max() <= ZERO_GRAD * norm, path
            continue
        err = np.linalg.norm(got - want)
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(want), GRAD_FLOOR * norm), (path, err)


@pytest.mark.parametrize("case", list(CASES))
def test_step_parameters_and_statistics_match_jax(runs, case):
    run = runs[case]
    assert set(run["state"]) == set(run["jax"]["state"])
    student_params = {p[0] for p in run["jax"]["state"]["student_params"]}
    for field, want_part in run["jax"]["state"].items():
        got_part = run["state"][field]
        assert got_part.keys() == want_part.keys(), field
        for path, want in want_part.items():
            err = np.abs(got_part[path] - want).max()
            if field.endswith("_stats"):
                assert err / max(1.0, np.abs(want).max()) <= STAT_TOL, (field, path, err)
            elif field == "student_params" and _bn_preceded_conv_bias(path, student_params):
                assert err <= 2 * ADAM_STEP_BOUND, (field, path, err)
            elif field == "student_params":
                # Adam's first step: p -= lr * g / (|g| + eps)
                g_port, g_jax = run["grads"][path], run["jax"]["grads"][path]
                implied = LR * np.abs(g_port / (np.abs(g_port) + ADAM_EPS)
                                      - g_jax / (np.abs(g_jax) + ADAM_EPS))
                excess = np.abs(got_part[path] - want) - implied
                assert excess.max() <= PARAM_ATOL, (field, path, excess.max())
            else:
                assert err <= PARAM_ATOL, (field, path, err)


@pytest.mark.parametrize("case", list(CASES))
def test_gram_route(runs, case):
    """Only ``spkd_k2`` runs the fused Gram pair: once, on the two [4, 8000]
    waveforms."""
    strategy, fused = CASES[case]
    assert runs[case]["gram_calls"] == ([torch.Size([4, 8000])] if fused else [])


@pytest.mark.parametrize("case", ["spkd", "mse", "stft"])
def test_no_abf_chains(runs, case):
    """Without fusion the trainer builds no ABF chains and Adam holds only
    the student's parameters, as in JAX."""
    trainer = runs[case]["trainer"]
    assert trainer.abf_enc is None and trainer.abf_dec is None
    assert list(trainer.trainable()) == ["student"]
    opt = [p for group in trainer.optimizer.param_groups for p in group["params"]]
    assert len(opt) == len(list(trainer.student.parameters()))
    assert "gn_abf" not in runs[case]["logs"]


def test_load_train_state_refuses_mismatched_parts(runs):
    """A fusion-less state into a clskd trainer, and a state with ABF chains
    into an spkd trainer, raise instead of loading part of it."""
    spkd_state = runs["spkd"]["jax"]["start"]
    clskd = Trainer(TrainConfig(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**TINY_S),
                                data=DataConfig(**DATA)), device="cpu").init_state()
    with pytest.raises(ValueError, match="the state holds"):
        load_train_state(clskd, spkd_state)
    with_abf = spkd_state.replace(
        abf_enc_params={"abf0": {}}, abf_dec_params={"abf0": {}})
    with pytest.raises(ValueError, match="the state holds"):
        load_train_state(runs["spkd"]["trainer"], with_abf)
