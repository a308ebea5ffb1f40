"""The port's attention fuse (``kernels/attfuse.py``) on the CPU against the
JAX package: the forward against the Pallas kernel in interpret mode
(``attention_fuse(..., interpret=True)``), and the five gradients against
``jax.grad`` of the plain composition of ``tests/test_pallas_attfuse.py``
(the Pallas custom VJP returns a bias gradient of the wrong shape, ROADMAP
section 3, so it is no oracle).  Inputs come from a numpy seed.  On the CPU
the wrapper runs its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_clskd_tpu.distill.abf import _resize_freq
from speech_enhancement_clskd_tpu.ops.pallas.attfuse import attention_fuse as jax_attention_fuse
from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
    MAX_CHANNELS,
    attention_fuse,
    attention_fuse_bwd,
    attention_fuse_fwd,
    attfuse_dispatchable,
)

# the four shapes of tests/test_pallas_attfuse.py, (B, D, Dp, T, C), k = D/Dp
# of 2, 1, 4 and 2
SHAPES = [
    (2, 8, 4, 21, 8),
    (2, 4, 4, 13, 8),
    (1, 16, 4, 7, 16),
    (2, 2, 1, 11, 4),
]
FWD_TOL = 1e-5
# gradients, as tests/test_pallas_attfuse.py holds them
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _xla_reference(x, res, wx, wy, bias):
    y = _resize_freq(res, x.shape[1], x.shape[2])
    z = jax.nn.sigmoid(jnp.einsum("bdtc,co->bdto", x, wx)
                       + jnp.einsum("bdtc,co->bdto", y, wy) + bias)
    return x * z[..., 0:1] + y * z[..., 1:2]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, d, dp, t, c = shape
    return (rng.standard_normal((b, d, t, c)).astype(np.float32),
            rng.standard_normal((b, dp, t, c)).astype(np.float32),
            (rng.standard_normal((c, 2)) * 0.3).astype(np.float32),
            (rng.standard_normal((c, 2)) * 0.3).astype(np.float32),
            (rng.standard_normal((2,)) * 0.1).astype(np.float32),
            rng.standard_normal((b, d, t, c)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_interpret(shape):
    *args, _ = _inputs(shape, 0)
    want = np.asarray(jax_attention_fuse(*map(jnp.asarray, args), interpret=True))
    got = attention_fuse(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_autodiff(shape):
    *args, g = _inputs(shape, 1)

    def loss(*a):
        return jnp.vdot(_xla_reference(*a), jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    attention_fuse(*ts).backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "res", "wx", "wy", "bias"), ts, want):
        assert tuple(t.grad.shape) == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    assert tuple(ts[4].grad.shape) == (2,)


def test_backward_wrapper_returns_the_forward_z_gradients():
    *args, g = (torch.from_numpy(a) for a in _inputs(SHAPES[0], 2))
    out, z = attention_fuse_fwd(*args)
    assert tuple(z.shape) == tuple(out.shape[:3]) + (2,)
    assert bool(((z > 0) & (z < 1)).all())
    x, res, wx, wy, _ = args
    grads = attention_fuse_bwd(x, res, z, g, wx, wy)
    assert [tuple(t.shape) for t in grads] == [tuple(x.shape), tuple(res.shape), (8, 2),
                                               (8, 2), (2,)]


def test_dispatch_gate():
    assert attfuse_dispatchable((2, 8, 21, 8), (2, 4, 21, 8))
    assert not attfuse_dispatchable((2, 8, 21, 8), (2, 3, 21, 8))  # 8 % 3
    assert not attfuse_dispatchable((2, 8, 21, 8), (2, 4, 20, 8))  # T differs
    assert not attfuse_dispatchable((2, 8, 21, 8), (2, 4, 21, 4))  # C differs
    assert not attfuse_dispatchable((2, 8, 21, 8), (1, 4, 21, 8))  # B differs
    # the kernels hold a row's channels in registers: C <= 256
    assert attfuse_dispatchable((1, 4, 5, MAX_CHANNELS), (1, 2, 5, MAX_CHANNELS))
    assert not attfuse_dispatchable((1, 4, 5, MAX_CHANNELS + 1), (1, 2, 5, MAX_CHANNELS + 1))
    # k = 32 (no freq tile limit here, unlike the TPU kernel)
    assert attfuse_dispatchable((2, 32, 21, 8), (2, 1, 21, 8))


def test_wrappers_reject_bad_inputs():
    x, res, wx, wy, bias, g = (torch.from_numpy(a) for a in _inputs(SHAPES[0], 3))
    before = (attention_fuse_fwd.launches, attention_fuse_bwd.launches)
    with pytest.raises(ValueError, match="attfuse_dispatchable"):
        attention_fuse(x, res[:, :3], wx, wy, bias)
    with pytest.raises(ValueError, match="wx must be"):
        attention_fuse(x, res, wx[:4], wy, bias)
    with pytest.raises(ValueError, match="bias must be"):
        attention_fuse(x, res, wx, wy, bias[None])
    with pytest.raises(TypeError, match="float32"):
        attention_fuse(x.double(), res.double(), wx.double(), wy.double(), bias.double())
    with pytest.raises(ValueError, match="contiguous"):
        attention_fuse(x, res, wx.T.contiguous().T, wy, bias)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        attention_fuse(*(t.to("meta") for t in (x, res, wx, wy, bias)))
    assert (attention_fuse_fwd.launches, attention_fuse_bwd.launches) == before
