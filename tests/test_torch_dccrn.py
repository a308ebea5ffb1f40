"""The port's eval-mode DCCRN forward against JAX ``DCCRN.apply(training=False)``
on the same weights: wav, masks, masked spectrum and every feature tap."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu.utils.serialization import load_bundle as jax_load_bundle
from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig, STFTConfig
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle
from torch_oracle import one_cpu_thread

BUNDLE = str(Path(__file__).resolve().parents[1] / "artifacts/r4_distill/the_best_model.npz")

# f32 on both sides; convs and matmuls sum in another order.  Measured
# worst case on the r4 bundle: 2e-7 on the wav, 1e-5 on the deepest taps
# (values of order 10), so these leave about 5x headroom.
WAV_ATOL = 1e-6
TAP_ATOL, TAP_RTOL = 5e-5, 1e-5


def _compare(want, got):
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(want.wav), atol=WAV_ATOL)
    for name in ("mask_real", "mask_imag", "est_real", "est_imag"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TAP_ATOL, rtol=TAP_RTOL, err_msg=name)
    taps = [("enc", a, b) for a, b in zip(want.taps.encoder, got.taps.encoder)]
    taps += [("dec", a, b) for a, b in zip(want.taps.decoder, got.taps.decoder)]
    taps += [("lstm_real", want.taps.lstm_real, got.taps.lstm_real),
             ("lstm_imag", want.taps.lstm_imag, got.taps.lstm_imag)]
    assert len(taps) == 2 * len(want.taps.encoder) + 2
    for name, a, b in taps:
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TAP_ATOL,
                                   rtol=TAP_RTOL, err_msg=name)


def _run_both(jax_cfg, variables, cfg, wav, bn_batch_stats=None):
    want = jax.jit(
        lambda v, w: jax_make_model(jax_cfg).apply(
            v, w, training=False, bn_batch_stats=bn_batch_stats)
    )(variables, jnp.asarray(wav))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(torch_state_from_flax(variables))
    got = model(torch.from_numpy(wav), training=False, bn_batch_stats=bn_batch_stats)
    return want, got


@pytest.fixture(scope="module")
def tiny_variables():
    cfg = JaxDCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
    init = jax.jit(lambda k: jax_make_model(cfg).init(k, jnp.zeros((1, 1600)), training=True))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    # non-trivial running statistics, so BN in serving mode does real work
    variables["batch_stats"] = jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.mark.parametrize("mode,bn_batch_stats", [("E", None), ("C", None), ("R", None),
                                                 ("E", True)])
def test_tiny_forward_matches_jax(tiny_variables, mode, bn_batch_stats):
    jax_cfg = JaxDCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16,
                             masking_mode=mode)
    cfg = DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16, masking_mode=mode)
    wav = (0.3 * np.random.default_rng(1).standard_normal((2, 8000))).astype(np.float32)
    want, got = _run_both(jax_cfg, tiny_variables, cfg, wav, bn_batch_stats)
    _compare(want, got)


def test_r4_bundle_forward_matches_jax():
    """The slice as a whole: the trained student bundle, 1 s of audio."""
    jax_cfg, variables, _ = jax_load_bundle(BUNDLE)
    cfg, _, _ = load_bundle(BUNDLE)
    wav = SyntheticEnhancementDataset(size=2, segment=1.0, seed=3)[0][0][None]
    want, got = _run_both(jax_cfg, variables, cfg, wav)
    assert got.wav.shape == (1, 16000)
    assert torch.isfinite(got.wav).all()
    _compare(want, got)


def test_seeded_init_is_deterministic():
    cfg = DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
    a = make_model(cfg, device="cpu", seed=3).state_dict()
    b = make_model(cfg, device="cpu", seed=3).state_dict()
    c = make_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc0_conv.wr"], c["enc0_conv.wr"])
    assert a["enc0_conv.wr"].std().item() == pytest.approx(0.05, rel=0.5)
    bound = 1.0 / np.sqrt(8)
    w = a["clstm0.real_lstm.w_hh"]
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.5 * bound


@pytest.mark.parametrize("change", [
    {"use_cbn": True},
    {"use_clstm": False},
    {"family": "dccrnet", "stft": STFTConfig(window="sqrthann")},
    {"compute_dtype": "bfloat16"},
])
def test_unported_options_raise(change):
    """The options the port does not have raise naming their ROADMAP item;
    bf16 compute, ported since, builds a model whose taps are bf16 and whose
    waveform is float32; the asteroid family, ported since, builds a
    ``DCCRNet`` (tests/test_torch_dccrnet.py holds it against JAX)."""
    cfg = DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16, **change)
    if change.get("compute_dtype") == "bfloat16":
        out = make_model(cfg, device="cpu")(torch.zeros(1, 1600))
        assert out.wav.dtype == torch.float32
        assert {t.dtype for t in out.taps.encoder + out.taps.decoder} == {torch.bfloat16}
        return
    if change.get("family") == "dccrnet":
        model = make_model(cfg, device="cpu")
        assert type(model).__name__ == "DCCRNet"
        assert model(torch.zeros(1, 1600)).wav.shape == (1, 1600)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(cfg, device="cpu")


def test_forward_turns_tf32_off_and_restores_the_callers_flags():
    """cuDNN convolutions default to TF32; the float32 model turns it off for
    its own calls, and gives the caller's settings back after."""
    cfg = DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
    model = make_model(cfg, device="cpu")
    seen = []
    model.enc0_conv.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        model(torch.zeros(1, 1600))
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest")]
    assert after == (True, "medium")


def test_training_forward_raises():
    """A serving model (eval mode) refuses a training forward, which would
    move its running statistics; in train mode the forward updates them."""
    cfg = DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
    model = make_model(cfg, device="cpu")
    wav = torch.from_numpy(0.1 * np.random.default_rng(2).standard_normal((2, 1600),
                                                                          np.float32))
    with pytest.raises(RuntimeError, match="eval mode"):
        model(wav, training=True)
    assert torch.equal(model.enc0_bn.mean, torch.zeros(4))
    model.train()(wav, training=True)
    assert not torch.equal(model.enc0_bn.mean, torch.zeros(4))
