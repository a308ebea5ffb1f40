"""The port's 3x3 conv (``kernels/conv3x3.py``) on the CPU against the JAX
Pallas kernel run in interpret mode (``_conv3x3_fn(True)``): the forward,
and dx and dw against ``jax.grad`` through the same Pallas path.  Inputs come
from a numpy seed; the port gets the weight in its module layout
``[O, C, 3, 3]``.  On the CPU the wrapper runs its plain version, an
explicit sum over the nine shifts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_enhancement_clskd_tpu.ops.pallas.conv3x3 import _conv3x3_fn
from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
    conv3x3,
    conv3x3_fwd,
    conv3x3_reference,
    conv3x3_wgrad,
    conv3x3_wgrad_reference,
)
from torch_oracle import one_cpu_thread

# the five shapes of tests/test_pallas_conv3x3.py: (B, D, T, C, O)
SHAPES = [
    (2, 8, 21, 8, 16),
    (2, 4, 21, 8, 32),
    (1, 2, 7, 4, 4),
    (2, 6, 11, 8, 8),
    (1, 16, 5, 16, 2),
]
# float32 both sides, sums in another order: the forward sums 9C products
# per output, the gradients up to B*D*T*9 per element
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, d, t, c, o = shape
    x = rng.standard_normal((b, d, t, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, d, t, o)).astype(np.float32)
    return x, w, g


def _module_weight(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_interpret(shape):
    x, w, _ = _inputs(shape, 0)
    want = np.asarray(_conv3x3_fn(True)(jnp.asarray(x), jnp.asarray(w)))
    got = conv3x3(torch.from_numpy(x), _module_weight(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_pallas_vjp(shape):
    """dx (the forward kernel on flipped, transposed weights) and dw, in the
    module's weight layout."""
    x, w, g = _inputs(shape, 1)

    def loss(x, w):
        return jnp.vdot(_conv3x3_fn(True)(x, w), jnp.asarray(g))

    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _module_weight(w).requires_grad_(True)
    conv3x3(xt, wt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw).transpose(3, 2, 0, 1),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_plain_versions_match_conv2d_in_float64():
    """The plain versions against ``F.conv2d`` and its autograd, an
    independent implementation, in float64 (exact up to rounding)."""
    x, w, g = (torch.from_numpy(a).double() for a in _inputs(SHAPES[0], 2))
    wt = w.permute(3, 2, 0, 1).contiguous()
    xr = x.clone().requires_grad_(True)
    wr = wt.clone().requires_grad_(True)
    ref = F.conv2d(xr.permute(0, 3, 1, 2), wr, padding=1).permute(0, 2, 3, 1)
    ref.backward(g)
    torch.testing.assert_close(conv3x3_reference(x, w), ref.detach(), rtol=0, atol=1e-12)
    torch.testing.assert_close(conv3x3_wgrad_reference(x, g).permute(3, 2, 0, 1), wr.grad,
                               rtol=0, atol=1e-11)


def test_cpu_calls_launch_no_kernel():
    x, w, g = (torch.from_numpy(a) for a in _inputs(SHAPES[2], 3))
    before = (conv3x3_fwd.launches, conv3x3_wgrad.launches)
    conv3x3_fwd(x, w)
    conv3x3_wgrad(x, g)
    assert (conv3x3_fwd.launches, conv3x3_wgrad.launches) == before


def test_wrappers_reject_bad_inputs():
    x, w, g = (torch.from_numpy(a) for a in _inputs(SHAPES[2], 4))
    with pytest.raises(ValueError, match="w must be"):
        conv3x3_fwd(x, w[:, :, :2])
    with pytest.raises(ValueError, match="w must be"):
        conv3x3(x, w)  # HWIO where the module layout is expected
    with pytest.raises(TypeError, match="float32"):
        conv3x3_fwd(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="g must be"):
        conv3x3_wgrad(x, g[:, :1])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv3x3_fwd(x.to("meta"), w.to("meta"))
