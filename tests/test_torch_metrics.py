"""The port's validation metrics against the JAX package's: STOI (batched,
with the silent-frame compaction), the time-domain signal losses, and PIT,
on inputs made with numpy from a seed, the port on the CPU."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.losses import pit as jax_pit
from speech_enhancement_clskd_tpu.losses import signal as jax_signal
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.losses import pit, signal
from speech_enhancement_clskd_tpu_torch.metrics import stoi
from torch_oracle import one_cpu_thread

# the module: the JAX package's ``metrics`` exports a function of that name
jax_stoi = importlib.import_module("speech_enhancement_clskd_tpu.metrics.stoi")
# one compile a shape instead of one for each operation of the eager call
jax_stoi_batch = jax.jit(jax_stoi.stoi_batch, static_argnames="fs")

SR = 16000
# float32 both sides, sums in another order (the resampling filter by a
# strided conv1d, the DFT by matmul); measured worst 6e-8
STOI_ATOL = 1e-5
SIGNAL_RTOL = 1e-5
# the fewest 16 kHz samples that give 30 frames at 10 kHz, one segment
MIN_SAMPLES = 6349


def _speech_pairs(n: int, seconds: float, seed: int):
    """(clean, degraded) [n, T] from the synthetic set: the clean target
    and its noisy mixture."""
    ds = SyntheticEnhancementDataset(size=n, segment=seconds, seed=seed)
    items = [ds[i] for i in range(n)]
    return (np.stack([c[0] for _, c in items]), np.stack([m for m, _ in items]))


def _stoi_cases():
    rng = np.random.default_rng(0)
    clean, mix = _speech_pairs(3, 1.5, seed=1)
    # leading and trailing silence: frames dropped at both ends (compaction)
    clean[1, :5000] = 0.0
    clean[1, -4000:] = 0.0
    # silence in the middle too, so kept frames are not contiguous
    clean[2, 9000:12000] *= 1e-4
    # white noise has no silent frame: all 30 frames kept, one segment
    short_c = (0.1 * rng.standard_normal((2, MIN_SAMPLES))).astype(np.float32)
    short_m = short_c + (0.05 * rng.standard_normal(short_c.shape)).astype(np.float32)
    return {
        "speech": (clean, mix),
        "thirty_frames": (short_c, short_m),
        "below_thirty_frames": (short_c[:, :-200], short_m[:, :-200]),
    }


@pytest.mark.parametrize("case", ["speech", "thirty_frames", "below_thirty_frames"])
def test_stoi_batch_matches_jax(case):
    x, y = _stoi_cases()[case]
    want = np.asarray(jax_stoi_batch(jnp.asarray(x), jnp.asarray(y), fs=SR))
    got = stoi.stoi_batch(torch.from_numpy(x), torch.from_numpy(y), fs=SR).numpy()
    assert got.shape == want.shape == (x.shape[0],)
    np.testing.assert_allclose(got, want, rtol=0, atol=STOI_ATOL)
    if case == "below_thirty_frames":
        assert (got == 0).all()
    else:
        assert (got > 0.3).all()


def test_stoi_single_and_frame_count():
    x, y = _stoi_cases()["thirty_frames"]
    x10 = stoi.resample(torch.from_numpy(x), SR)
    assert (x10.shape[-1] - stoi.N_FRAME) // stoi.HOP + 1 == stoi.N_SEG
    got = float(stoi.stoi(torch.from_numpy(x[0]), torch.from_numpy(y[0]), fs=SR))
    want = float(jax_stoi_batch(jnp.asarray(x[:1]), jnp.asarray(y[:1]), fs=SR)[0])
    assert abs(got - want) <= STOI_ATOL


def test_stoi_compaction_matches_jax_nonzero():
    """The kept frames' indices, then frame N - 1: the JAX size-bounded
    ``jnp.nonzero`` with its fill, built without a host sync."""
    rng = np.random.default_rng(3)
    mask = rng.random((5, 40)) > 0.4
    mask[3] = False
    mask[4] = True
    m = torch.from_numpy(mask)
    order = torch.sort((~m).to(torch.int32), dim=-1, stable=True).indices
    keep = torch.where(torch.arange(40) < m.sum(-1, keepdim=True), order, 39)
    for row, want_mask in zip(keep.numpy(), mask):
        (want,) = jnp.nonzero(jnp.asarray(want_mask), size=40, fill_value=39)
        np.testing.assert_array_equal(row, np.asarray(want))


def test_resample_matches_jax():
    x, _ = _speech_pairs(2, 0.7, seed=4)
    want = np.asarray(jax_stoi.resample(jnp.asarray(x), SR))
    got = stoi.resample(torch.from_numpy(x), SR).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["sdr", "si_snr", "si_sdr", "rmse"])
def test_signal_losses_match_jax(fn):
    clean, mix = _speech_pairs(4, 0.5, seed=5)
    want = float(getattr(jax_signal, fn)(jnp.asarray(clean), jnp.asarray(mix)))
    got = float(getattr(signal, fn)(torch.from_numpy(clean), torch.from_numpy(mix)))
    np.testing.assert_allclose(got, want, rtol=SIGNAL_RTOL)


def _sources(n_src: int, seed: int):
    """[B, n_src, T] references and shuffled, noisy estimates of them."""
    rng = np.random.default_rng(seed)
    B, T = 5, 3000
    ref = (0.3 * rng.standard_normal((B, n_src, T))).astype(np.float32)
    perms = np.stack([rng.permutation(n_src) for _ in range(B)])
    est = np.take_along_axis(ref, perms[..., None], axis=1)
    est = est + (0.1 * rng.standard_normal(est.shape)).astype(np.float32)
    return est.astype(np.float32), ref


@pytest.mark.parametrize("n_src", [2, 3])
def test_pit_reorder_matches_jax(n_src):
    est, ref = _sources(n_src, seed=n_src)
    want_est, want_loss = jax_pit.pit_reorder(jnp.asarray(est), jnp.asarray(ref))
    got_est, got_loss = pit.pit_reorder(torch.from_numpy(est), torch.from_numpy(ref))
    # the same permutation: the reordered estimates are the same rows
    np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), rtol=SIGNAL_RTOL)
    pw_want = np.array(jax_pit.pairwise_neg_si_sdr(jnp.asarray(est), jnp.asarray(ref)))
    pw_got = pit.pairwise_neg_si_sdr(torch.from_numpy(est), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(pw_got, pw_want, rtol=SIGNAL_RTOL, atol=1e-5)
    _, perm_want = jax_pit.pit_from_pw_mtx(jnp.asarray(pw_want))
    _, perm_got = pit.pit_from_pw_mtx(torch.from_numpy(pw_want))
    np.testing.assert_array_equal(perm_got.numpy(), np.asarray(perm_want))
    np.testing.assert_allclose(float(pit.pit_si_sdr_loss(torch.from_numpy(est),
                                                          torch.from_numpy(ref))),
                               float(jax_pit.pit_si_sdr_loss(jnp.asarray(est), jnp.asarray(ref))),
                               rtol=SIGNAL_RTOL)


def test_pit_ties_take_the_first_permutation_as_jax():
    pw = np.zeros((2, 3, 3), np.float32)  # every permutation ties
    _, perm_want = jax_pit.pit_from_pw_mtx(jnp.asarray(pw))
    _, perm_got = pit.pit_from_pw_mtx(torch.from_numpy(pw))
    np.testing.assert_array_equal(perm_got.numpy(), np.asarray(perm_want))
    np.testing.assert_array_equal(perm_got.numpy(), [[0, 1, 2]] * 2)
