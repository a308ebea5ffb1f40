"""Port complex conv / transpose conv / BN / PReLU against the JAX modules on
weights carried over by the bridge."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.ops import complex_layers as jl
from speech_enhancement_clskd_tpu_torch.ops import complex_layers as pl
from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
from torch_oracle import one_cpu_thread

# float32 convs summing 5*2*2C products: the sums run in another order
ATOL, RTOL = 1e-5, 1e-5


def _bridged(module, name, params):
    """Load flax ``params`` of one layer into ``module`` through the bridge,
    under the layer name the model gives it (which picks the conv layout)."""
    state = torch_state_from_flax({"params": {name: params}})
    module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()})
    return module


def _random_params(rng, params):
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.2, params)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out", [(1, 4), (4, 8)])
def test_complex_conv2d_causal(rng, c_in, c_out):
    x = _x(rng, (2, 32, 11, 2 * c_in))
    jm = jl.ComplexConv2d(features=2 * c_out, causal=True)
    params = _random_params(rng, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = _bridged(pl.ComplexConv2d(2 * c_in, 2 * c_out), "enc0_conv", params)
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 16, 11, 2 * c_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("c_in,c_out", [(8, 4), (4, 1)])
def test_complex_conv_transpose2d_time_crop(rng, c_in, c_out):
    x = _x(rng, (2, 8, 9, 2 * c_in))
    jm = jl.ComplexConvTranspose2d(features=2 * c_out, time_crop_left=1)
    params = _random_params(rng, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = _bridged(pl.ComplexConvTranspose2d(2 * c_in, 2 * c_out, time_crop_left=1),
                  "dec0_conv", params)
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 16, 9, 2 * c_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_batchnorm_both_modes(rng, use_batch_stats):
    x = _x(rng, (2, 6, 7, 8)) * 3.0 + 1.5
    jm = jl.BatchNorm()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    params = {"scale": rng.uniform(0.5, 2.0, 8).astype(np.float32),
              "bias": _x(rng, (8,))}
    stats = {"mean": _x(rng, (8,)), "var": rng.uniform(0.5, 4.0, 8).astype(np.float32)}
    assert jax.tree.map(np.shape, variables) == jax.tree.map(
        np.shape, {"params": params, "batch_stats": stats})
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               training=False, use_batch_stats=use_batch_stats))
    state = torch_state_from_flax({"params": {"bn": params}, "batch_stats": {"bn": stats}})
    pm = pl.BatchNorm(8)
    pm.load_state_dict({k[3:]: v for k, v in state.items()})
    got = pm(torch.from_numpy(x), use_batch_stats=use_batch_stats).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # serving never moves the running statistics
    np.testing.assert_array_equal(pm.mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(pm.var.numpy(), stats["var"])


def test_prelu(rng):
    x = _x(rng, (3, 5, 4))
    jm = jl.PReLU()
    params = {"alpha": np.array([0.37], np.float32)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = pl.PReLU()
    pm.load_state_dict({"alpha": torch.tensor([0.37])})
    np.testing.assert_array_equal(pm(torch.from_numpy(x)).detach().numpy(), want)


def test_complex_cat_and_split(rng):
    a, b = _x(rng, (2, 3, 4, 6)), _x(rng, (2, 3, 4, 10))
    want = np.asarray(jl.complex_cat([jnp.asarray(a), jnp.asarray(b)], axis=-1))
    got = pl.complex_cat([torch.from_numpy(a), torch.from_numpy(b)], dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    re, im = pl.split_complex(torch.from_numpy(got))
    np.testing.assert_array_equal(re.numpy(), np.concatenate([a[..., :3], b[..., :5]], -1))
    np.testing.assert_array_equal(im.numpy(), np.concatenate([a[..., 3:], b[..., 5:]], -1))
