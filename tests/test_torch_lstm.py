"""The port's LSTM path on the CPU: the kernel's plain version against the JAX
Pallas kernel (interpret mode) and scan, the LSTM modules against flax, and
the wrapper's CPU/CUDA contract."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.ops import complex_lstm as jax_lstm
from speech_enhancement_clskd_tpu.ops.pallas.lstm import lstm_seq as jax_lstm_seq
from speech_enhancement_clskd_tpu_torch.config import STUDENT
from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_reference
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.ops.complex_lstm import LSTM, NaiveComplexLSTM
from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax

# the forward tolerance of tests/test_pallas_lstm.py
ATOL, RTOL = 1e-5, 1e-4


def _inputs(rng, T=12, N=4, H=8):
    xw = rng.standard_normal((T, N, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_hh


def test_reference_matches_pallas_interpret(rng):
    xw, w_hh = _inputs(rng)
    want = np.asarray(jax_lstm_seq(jnp.asarray(xw), jnp.asarray(w_hh), True))
    y, c = lstm_seq_reference(torch.from_numpy(xw), torch.from_numpy(w_hh))
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL, rtol=RTOL)
    # c is the carry the Pallas forward saves for its backward
    from speech_enhancement_clskd_tpu.ops.pallas.lstm import _fwd_call

    _, want_c = _fwd_call(jnp.asarray(xw), jnp.asarray(w_hh), True)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=ATOL, rtol=RTOL)


def _jax_scan(xw, w_hh, h0, c0):
    H = w_hh.shape[0]

    def step(carry, xw_t):
        h, c = carry
        i, f, g, o = jnp.split(xw_t + h @ w_hh, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), h

    return jax.lax.scan(step, (h0, c0), xw)[1]


def test_reference_with_initial_state_matches_scan(rng):
    xw, w_hh = _inputs(rng)
    h0 = rng.standard_normal((4, 8)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((4, 8)).astype(np.float32)
    want = np.asarray(_jax_scan(*(jnp.asarray(a) for a in (xw, w_hh, h0, c0))))
    y, _ = lstm_seq(*(torch.from_numpy(a) for a in (xw, w_hh, h0, c0)))
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL, rtol=RTOL)


def test_lstm_module_with_state_matches_flax(rng):
    T, B, F, H = 10, 3, 6, 8
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    jm = jax_lstm.LSTM(H, use_pallas=False)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               (jnp.asarray(h0), jnp.asarray(c0))))
    pm = LSTM(F, H).requires_grad_(False)
    state = torch_state_from_flax({"params": {"lstm": params}})
    pm.load_state_dict({k[5:]: v for k, v in state.items()})
    got = pm(torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("projection_dim", [None, 24])
def test_naive_complex_lstm_matches_flax(rng, projection_dim):
    T, B, F, hidden = 9, 2, 12, 16
    xr = rng.standard_normal((T, B, F)).astype(np.float32)
    xi = rng.standard_normal((T, B, F)).astype(np.float32)
    jm = jax_lstm.NaiveComplexLSTM(hidden_size=hidden, projection_dim=projection_dim)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(xr), jnp.asarray(xi))["params"]
    want_r, want_i = jm.apply({"params": params}, jnp.asarray(xr), jnp.asarray(xi))
    pm = NaiveComplexLSTM(F, hidden, projection_dim).requires_grad_(False)
    state = torch_state_from_flax({"params": {"clstm0": params}})
    pm.load_state_dict({k[7:]: v for k, v in state.items()})
    got_r, got_i = pm(torch.from_numpy(xr), torch.from_numpy(xi))
    out = projection_dim // 2 if projection_dim else hidden // 2
    assert got_r.shape == got_i.shape == (T, B, out)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_path_without_launch(rng):
    xw, w_hh = _inputs(rng)
    lstm_seq.launches = 0
    y, c = lstm_seq(torch.from_numpy(xw), torch.from_numpy(w_hh))
    assert lstm_seq.launches == 0
    ry, rc = lstm_seq_reference(torch.from_numpy(xw), torch.from_numpy(w_hh))
    assert torch.equal(y, ry) and torch.equal(c, rc)


def test_wrapper_rejects_bad_inputs(rng):
    xw, w_hh = (torch.from_numpy(a) for a in _inputs(rng))
    with pytest.raises(ValueError):
        lstm_seq(xw, w_hh[:, :-4])
    with pytest.raises(TypeError):
        lstm_seq(xw.double(), w_hh.double())
    with pytest.raises(ValueError):
        lstm_seq(xw.transpose(0, 1), w_hh)
    with pytest.raises(ValueError):
        lstm_seq(xw, w_hh, h0=torch.zeros(3, 8))
    # gradients flow to xw and w_hh, not to an initial state
    with pytest.raises(NotImplementedError, match="h0/c0"):
        lstm_seq(xw, w_hh, h0=torch.zeros(4, 8, requires_grad=True))


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(STUDENT, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(STUDENT)  # the default device is the card
