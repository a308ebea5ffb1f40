"""The port's LSTM backward on the CPU: the plain backward
(``lstm_seq_bwd_reference``) and the autograd Function's CPU backward against
``jax.grad`` through the JAX Pallas kernel (interpret mode) and against torch
autograd through the plain forward; and the complex LSTM's gradients against
flax."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.ops import complex_lstm as jax_lstm
from speech_enhancement_clskd_tpu.ops.pallas.lstm import _fwd_call, _lstm_bwd
from speech_enhancement_clskd_tpu.ops.pallas.lstm import lstm_seq as jax_lstm_seq
from speech_enhancement_clskd_tpu_torch.kernels.lstm import (
    lstm_bwd_gates_reference,
    lstm_seq,
    lstm_seq_bwd,
    lstm_seq_bwd_reference,
    lstm_seq_reference,
)
from speech_enhancement_clskd_tpu_torch.ops.complex_lstm import NaiveComplexLSTM
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    torch_state_from_flax,
)
from torch_oracle import one_cpu_thread

# float32 on both sides, sums in another order through T reverse steps
ATOL, RTOL = 1e-5, 1e-4


def _inputs(rng, T, N, H, with_state=False):
    xw = rng.standard_normal((T, N, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dy = rng.standard_normal((T, N, H)).astype(np.float32)
    state = (None, None)
    if with_state:
        state = (rng.uniform(-1, 1, (N, H)).astype(np.float32),
                 rng.standard_normal((N, H)).astype(np.float32))
    return xw, w_hh, dy, state


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _function_grads(xw, w_hh, dy, h0=None, c0=None):
    """Gradients of sum(y * dy) through the port's differentiable lstm_seq."""
    xt, wt = _t(xw).requires_grad_(True), _t(w_hh).requires_grad_(True)
    y, c = lstm_seq(xt, wt, _t(h0), _t(c0))
    assert y.requires_grad and not c.requires_grad
    (y * _t(dy)).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


def _plain_grads(xw, w_hh, dy, h0=None, c0=None):
    y, c = lstm_seq_reference(_t(xw), _t(w_hh), _t(h0), _t(c0))
    dxw, dw = lstm_seq_bwd_reference(_t(xw), _t(w_hh), y, c, _t(dy), _t(h0), _t(c0))
    return dxw.numpy(), dw.numpy()


@pytest.mark.parametrize("N", [3, 5])
def test_backward_matches_pallas_interpret(rng, N):
    """Ragged N against jax.grad through the Pallas kernel's custom VJP, run
    in interpret mode as tests/test_pallas_lstm.py runs it."""
    xw, w_hh, dy, _ = _inputs(rng, T=11, N=N, H=8)
    want = jax.grad(lambda a, b: jnp.sum(jax_lstm_seq(a, b, True) * dy), argnums=(0, 1))(
        jnp.asarray(xw), jnp.asarray(w_hh))
    for got in (_plain_grads(xw, w_hh, dy), _function_grads(xw, w_hh, dy)):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [1, 2, 11])
def test_backward_matches_pallas_bwd_interpret(rng, T):
    """The plain backward, on the Pallas forward's own y and c, against the
    Pallas backward ``_lstm_bwd`` called directly in interpret mode; T = 1
    has no step before it."""
    xw, w_hh, dy, _ = _inputs(rng, T=T, N=4, H=8)
    y, c = _fwd_call(jnp.asarray(xw), jnp.asarray(w_hh), True)
    want = _lstm_bwd(True, (jnp.asarray(xw), jnp.asarray(w_hh), y, c), jnp.asarray(dy))
    got = lstm_seq_bwd_reference(_t(xw), _t(w_hh), _t(np.asarray(y)), _t(np.asarray(c)),
                                 _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_gates_reference_matches_jax(rng, with_state):
    """The backward's gate pass (plain version): the activated gates of every
    step from xw, y and h0, against the same gates in JAX from a lax.scan
    forward, with and without an initial state."""
    xw, w_hh, _, (h0, c0) = _inputs(rng, T=7, N=3, H=6, with_state=with_state)
    zeros = np.zeros((3, 6), np.float32)
    y = _jax_scan_y(jnp.asarray(xw), jnp.asarray(w_hh),
                    jnp.asarray(zeros if h0 is None else h0),
                    jnp.asarray(zeros if c0 is None else c0))
    h_prev = jnp.concatenate([jnp.asarray(zeros if h0 is None else h0)[None], y[:-1]])
    i, f, g, o = jnp.split(jnp.asarray(xw) + h_prev @ jnp.asarray(w_hh), 4, axis=-1)
    want = jnp.concatenate([jax.nn.sigmoid(i), jax.nn.sigmoid(f), jnp.tanh(g),
                            jax.nn.sigmoid(o)], axis=-1)
    got = lstm_bwd_gates_reference(_t(xw), _t(w_hh), _t(np.asarray(y)), _t(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _jax_scan_y(xw, w_hh, h0, c0):
    def step(carry, xw_t):
        h, c = carry
        i, f, g, o = jnp.split(xw_t + h @ w_hh, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), h

    return jax.lax.scan(step, (h0, c0), xw)[1]


@pytest.mark.parametrize("N", [1, 4, 7])
def test_backward_with_initial_state_matches_autograd(rng, N):
    """With h0, c0 as constants: against torch autograd through the plain
    forward and jax.grad through a lax.scan LSTM."""
    xw, w_hh, dy, (h0, c0) = _inputs(rng, T=9, N=N, H=6, with_state=True)
    xa, wa = _t(xw).requires_grad_(True), _t(w_hh).requires_grad_(True)
    y, _ = lstm_seq_reference(xa, wa, _t(h0), _t(c0))
    (y * _t(dy)).sum().backward()
    jx = jax.grad(lambda a, b: jnp.sum(_jax_scan_y(a, b, h0, c0) * dy), argnums=(0, 1))(
        jnp.asarray(xw), jnp.asarray(w_hh))
    for got in (_plain_grads(xw, w_hh, dy, h0, c0), _function_grads(xw, w_hh, dy, h0, c0)):
        for g, autograd, scan in zip(got, (xa.grad.numpy(), wa.grad.numpy()), jx):
            np.testing.assert_allclose(g, autograd, atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(g, np.asarray(scan), atol=ATOL, rtol=RTOL)


def test_backward_cpu_tensors_take_plain_path_without_launch(rng):
    xw, w_hh, dy, _ = _inputs(rng, T=6, N=2, H=4)
    y, c = lstm_seq_reference(_t(xw), _t(w_hh))
    lstm_seq_bwd.launches = 0
    got = lstm_seq_bwd(_t(xw), _t(w_hh), y, c, _t(dy))
    assert lstm_seq_bwd.launches == 0
    want = lstm_seq_bwd_reference(_t(xw), _t(w_hh), y, c, _t(dy))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_rejects_bad_inputs(rng):
    xw, w_hh, dy, _ = (_t(a) if isinstance(a, np.ndarray) else a
                       for a in _inputs(rng, T=6, N=2, H=4))
    y, c = lstm_seq_reference(xw, w_hh)
    with pytest.raises(ValueError, match="dy"):
        lstm_seq_bwd(xw, w_hh, y, c, dy[:-1])
    with pytest.raises(TypeError):
        lstm_seq_bwd(xw, w_hh, y, c, dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_seq_bwd(xw, w_hh, y, c.transpose(0, 1).contiguous().transpose(0, 1), dy)


@pytest.mark.parametrize("projection_dim", [None, 24])
def test_naive_complex_lstm_gradients_match_flax(rng, projection_dim):
    """Gradients through the input projection, both LSTMs and the output
    projection, for every parameter and both inputs."""
    T, B, F, hidden = 9, 3, 12, 16
    xr = rng.standard_normal((T, B, F)).astype(np.float32)
    xi = rng.standard_normal((T, B, F)).astype(np.float32)
    jm = jax_lstm.NaiveComplexLSTM(hidden_size=hidden, projection_dim=projection_dim)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(xr), jnp.asarray(xi))["params"]
    out = projection_dim // 2 if projection_dim else hidden // 2
    gr = rng.standard_normal((T, B, out)).astype(np.float32)
    gi = rng.standard_normal((T, B, out)).astype(np.float32)

    def loss(p, a, b):
        o_r, o_i = jm.apply({"params": p}, a, b)
        return jnp.sum(o_r * gr) + jnp.sum(o_i * gi)

    want_p, want_r, want_i = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(xr), jnp.asarray(xi))

    pm = NaiveComplexLSTM(F, hidden, projection_dim)
    state = torch_state_from_flax({"params": {"clstm0": params}})
    pm.load_state_dict({k[len("clstm0."):]: v for k, v in state.items()})
    tr, ti = _t(xr).requires_grad_(True), _t(xi).requires_grad_(True)
    o_r, o_i = pm(tr, ti)
    ((o_r * _t(gr)).sum() + (o_i * _t(gi)).sum()).backward()
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(want_r), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_i), atol=ATOL, rtol=RTOL)
    got_p = flax_from_torch_state({n: p.grad for n, p in pm.named_parameters()})["params"]
    flat_want = jax.tree_util.tree_flatten_with_path(want_p)[0]
    assert len(flat_want) == len(list(pm.parameters()))
    for path, w in flat_want:
        g = got_p
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))
