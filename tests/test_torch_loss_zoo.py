"""The loss zoo of standalone DCCRN training in the port against the JAX
package on the CPU: PMSQE (``losses/pmsqe.py``), the multi-scale log-mel
distance (``losses/mel.py``) and every mode of ``dccrn_loss``
(``losses/modes.py``).

Each value is held to ``VALUE_RTOL`` and each gradient (of the enhanced
waveform, and of the masked spectrum where a ``*+LMS`` mode reads it) to
``GRAD_REL_L2`` relative L2: float32 on both sides, sums in another order.
The JAX side is jitted (``jax.value_and_grad``): one compile a mode.  The port's PMSQE also stands on the JAX
package's own regression goldens (``tests/test_losses.py``), without JAX.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.losses import mel as jax_mel
from speech_enhancement_clskd_tpu.losses import modes as jax_modes
from speech_enhancement_clskd_tpu.losses import pmsqe as jax_pmsqe
from speech_enhancement_clskd_tpu.ops import stft as jax_stft
from speech_enhancement_clskd_tpu_torch.losses import mel, modes, pmsqe
from speech_enhancement_clskd_tpu_torch.ops import stft as stft_ops
from torch_oracle import one_cpu_thread

VALUE_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# tests/test_losses.py::test_pmsqe_value_goldens: noise level -> PMSQE
PMSQE_GOLDENS = {0.0: 0.013202, 0.01: 0.015037, 0.03: 0.040250, 0.1: 0.267454}
GOLDEN_RTOL = 2e-3


def _wavs(n=2, samples=8000, seed=0):
    """Clean speech-like noise at 0.1 and an estimate 0.03 from it."""
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((n, samples))).astype(np.float32)
    est = clean + (0.03 * rng.standard_normal((n, samples))).astype(np.float32)
    return est, clean


def _spectrum(wav, seed=1):
    """A masked spectrum [B, F, T'] for the *+LMS modes: the STFT of
    ``wav`` on the default frontend, each bin scaled by a random mask."""
    k = stft_ops.make_kernels()
    spec = stft_ops.stft(torch.from_numpy(wav), k).numpy()
    F = k.fft_len // 2 + 1
    mask = np.random.default_rng(seed).uniform(0.5, 1.0, spec[:, :F].shape).astype(np.float32)
    return spec[:, :F] * mask, spec[:, F:] * mask


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _port_value_and_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = fn(*ts)
    grads = torch.autograd.grad(val, ts)
    return float(val.detach()), [g.numpy() for g in grads]


def _jax_value_and_grads(fn, *arrays):
    val, grads = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    return float(val), [np.asarray(g) for g in grads]


def _check(port, want):
    (v, grads), (jv, jgrads) = port, want
    np.testing.assert_allclose(v, jv, rtol=VALUE_RTOL)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert _rel_l2(g, jg) <= GRAD_REL_L2, (i, _rel_l2(g, jg))


def test_bark_tables_match_jax():
    for fft, sr in ((512, 16000), (512, 8000)):
        mat, centers = pmsqe.bark_matrix(fft, sr)
        jmat, jcenters = jax_pmsqe.bark_matrix(fft, sr)
        np.testing.assert_array_equal(mat, jmat)
        np.testing.assert_array_equal(centers, jcenters)
        np.testing.assert_array_equal(pmsqe._abs_thresh_power(sr, fft),
                                      jax_pmsqe._abs_thresh_power(sr, fft))


@pytest.mark.parametrize("num_coeffs, fft", [(16, 512), (32, 512), (64, 512), (24, 256)])
def test_mel_filterbank_matches_jax(num_coeffs, fft):
    np.testing.assert_array_equal(mel.mel_filterbank(num_coeffs, fft),
                                  jax_mel.mel_filterbank(num_coeffs, fft))


def test_pmsqe_matches_jax():
    """PMSQE from waveforms, its value and its gradient in the degraded
    waveform (the loss's only trained input) and in the reference."""
    est, clean = _wavs()
    _check(_port_value_and_grads(lambda d, r: pmsqe.pmsqe_from_wav(r, d), est, clean),
           _jax_value_and_grads(lambda d, r: jax_pmsqe.pmsqe_from_wav(r, d), est, clean))


def test_pmsqe_from_magnitudes_matches_jax():
    """``pmsqe`` on magnitude spectrograms of another leading shape
    ([B, T, F] with B = 3), louder than the listening level and quieter."""
    rng = np.random.default_rng(3)
    ref = np.abs(rng.standard_normal((3, 20, 257))).astype(np.float32) * 50.0
    deg = (ref * rng.uniform(0.3, 2.0, ref.shape)).astype(np.float32)
    _check(_port_value_and_grads(lambda d, r: pmsqe.pmsqe(r, d), deg, ref),
           _jax_value_and_grads(lambda d, r: jax_pmsqe.pmsqe(r, d), deg, ref))


def test_pmsqe_value_goldens_without_jax():
    """The port's PMSQE on tests/test_losses.py's fixed signals and goldens."""
    g = np.random.default_rng(1234)
    clean = g.standard_normal((1, 16000)).astype(np.float32) * 0.1
    for noise, expected in PMSQE_GOLDENS.items():
        deg = clean + noise * g.standard_normal((1, 16000)).astype(np.float32)
        v = float(pmsqe.pmsqe_from_wav(torch.from_numpy(clean), torch.from_numpy(deg)))
        np.testing.assert_allclose(v, expected, rtol=GOLDEN_RTOL, err_msg=str(noise))


def test_perceptual_distance_and_array_mel_loss_match_jax():
    """One utterance's distance, and the batch mean ``array_mel_loss``
    takes in one batched pass against the JAX per-utterance loop."""
    rng = np.random.default_rng(4)
    clean = np.abs(rng.standard_normal((3, 257, 30))).astype(np.float32) + 0.1
    est = (clean * rng.uniform(0.5, 1.5, clean.shape)).astype(np.float32)
    _check(_port_value_and_grads(lambda e, c: mel.perceptual_distance(c[0], e[0]), est, clean),
           _jax_value_and_grads(lambda e, c: jax_mel.perceptual_distance(c[0], e[0]),
                                est, clean))
    _check(_port_value_and_grads(lambda e, c: mel.array_mel_loss(c, e), est, clean),
           _jax_value_and_grads(lambda e, c: jax_mel.array_mel_loss(c, e), est, clean))


@pytest.mark.parametrize("mode", modes.LOSS_MODES)
def test_dccrn_loss_mode_matches_jax(mode):
    """Each of the 12 modes: the value, and the gradients in the enhanced
    waveform and (the ``*+LMS`` modes) the masked spectrum, the mel terms
    on the default frontend's bases on both sides."""
    est, clean = _wavs()
    er, ei = _spectrum(est)
    k, jk = stft_ops.make_kernels(), jax_stft.make_kernels()
    if mode.endswith("LMS"):
        port = _port_value_and_grads(
            lambda x, r, i: modes.dccrn_loss(x, torch.from_numpy(clean), r, i, loss_mode=mode,
                                             stft_kernels=k), est, er, ei)
        want = _jax_value_and_grads(
            lambda x, r, i: jax_modes.dccrn_loss(x, jnp.asarray(clean), r, i, loss_mode=mode,
                                                 stft_kernels=jk), est, er, ei)
    else:
        port = _port_value_and_grads(
            lambda x: modes.dccrn_loss(x, torch.from_numpy(clean), loss_mode=mode,
                                       stft_kernels=k), est)
        want = _jax_value_and_grads(
            lambda x: jax_modes.dccrn_loss(x, jnp.asarray(clean), loss_mode=mode,
                                           stft_kernels=jk), est)
    _check(port, want)


def test_dccrn_loss_upcasts_bf16_and_refuses_an_unknown_mode():
    """A bf16 estimate is scored in float32 (the value of its float32
    copy); an unknown mode raises ``ValueError``, as in JAX."""
    est, clean = _wavs()
    bf16 = torch.from_numpy(est).bfloat16()
    got = modes.dccrn_loss(bf16, torch.from_numpy(clean))
    assert got.dtype == torch.float32
    assert float(got) == float(modes.dccrn_loss(bf16.float(), torch.from_numpy(clean)))
    with pytest.raises(ValueError, match="unknown loss_mode"):
        modes.dccrn_loss(torch.from_numpy(est), torch.from_numpy(clean), loss_mode="L1")
    with pytest.raises(ValueError, match="unknown loss_mode"):
        jax_modes.dccrn_loss(jnp.asarray(est), jnp.asarray(clean), loss_mode="L1")
