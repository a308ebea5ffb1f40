"""Port STFT/iSTFT and the safe magnitude/phase against the JAX package."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.ops import stft as jax_stft
from speech_enhancement_clskd_tpu_torch.ops import stft as port_stft
from torch_oracle import one_cpu_thread

# float32 matmuls over 400-sample frames: a few ulp of the spectrum's scale
ATOL = 2e-5


def _signal(rng, batch=2, samples=4000):
    x = (0.3 * rng.standard_normal((batch, samples))).astype(np.float32)
    x[:, 1000:2000] = 0.0  # digital silence: all-zero frames in the middle
    x[:, -600:] = 0.0
    return x


@pytest.mark.parametrize("window", ["hamming", "hann", None])
def test_stft_matches_jax(rng, window):
    x = _signal(rng)
    jk = jax_stft.make_kernels(400, 100, 512, window)
    pk = port_stft.make_kernels(400, 100, 512, window)
    np.testing.assert_array_equal(pk.fwd.numpy(), jk.fwd)
    np.testing.assert_array_equal(pk.inv.numpy(), jk.inv)
    want = np.asarray(jax_stft.stft(jnp.asarray(x), jk))
    got = port_stft.stft(torch.from_numpy(x), pk).numpy()
    assert got.shape == want.shape == (2, 514, 43)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    F = 257
    silent = slice(14, 17)  # frames wholly inside the silent stretch
    assert np.all(got[:, :, silent] == 0.0)
    assert np.all(got[:, :F].any(axis=1)[:, :5])


def test_istft_matches_jax_and_inverts(rng):
    x = _signal(rng)
    jk = jax_stft.make_kernels()
    pk = port_stft.make_kernels()
    spec = np.asarray(jax_stft.stft(jnp.asarray(x), jk))
    want = np.asarray(jax_stft.istft(jnp.asarray(spec), jk))
    got = port_stft.istft(torch.from_numpy(spec), pk).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, x, atol=1e-4)


def test_overlap_add_matches_jax(rng):
    frames = rng.standard_normal((3, 7, 400)).astype(np.float32)
    want = np.asarray(jax_stft.overlap_add(jnp.asarray(frames), 100))
    got = port_stft.overlap_add(torch.from_numpy(frames), 100).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_frame_matches_jax(rng):
    x = rng.standard_normal((2, 1234)).astype(np.float32)
    want = np.asarray(jax_stft.frame(jnp.asarray(x), 400, 100))
    got = port_stft.frame(torch.from_numpy(x), 400, 100).numpy()
    np.testing.assert_array_equal(got, want)


def test_safe_magnitude_and_arctan2_at_origin():
    re = np.array([0.0, 0.0, 3.0, -1.0, 0.0], np.float32)
    im = np.array([0.0, 2.0, 4.0, 0.0, -0.5], np.float32)
    want_m = np.asarray(jax_stft.safe_magnitude(jnp.asarray(re), jnp.asarray(im)))
    want_p = np.asarray(jax_stft.safe_arctan2(jnp.asarray(im), jnp.asarray(re)))
    tre = torch.tensor(re, requires_grad=True)
    tim = torch.tensor(im, requires_grad=True)
    got_m = port_stft.safe_magnitude(tre, tim)
    got_p = port_stft.safe_arctan2(tim, tre)
    np.testing.assert_array_equal(got_m.detach().numpy(), want_m)
    np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=1e-7)
    assert got_m[0].item() == 0.0 and got_p[0].item() == 0.0
    # finite (zero) subgradient at exactly (0, 0)
    (got_m.sum() + got_p.sum()).backward()
    assert torch.isfinite(tre.grad).all() and torch.isfinite(tim.grad).all()
    assert tre.grad[0].item() == 0.0 and tim.grad[0].item() == 0.0
