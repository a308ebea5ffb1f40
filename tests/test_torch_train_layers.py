"""The training step's layers on the CPU against the JAX package on the same
weights and inputs: BatchNorm in training mode, the training forward of
DCCRN, the spectral and SPKD losses (values and input gradients), the
torch-exact nearest resize, and the two ReviewKD chains of ABF blocks
(outputs, updated statistics, gradients for the taps and every parameter)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.distill import abf as jabf
from speech_enhancement_clskd_tpu.losses import kd as jkd
from speech_enhancement_clskd_tpu.losses import spectral as jspectral
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu.ops import complex_layers as jl
from speech_enhancement_clskd_tpu.ops import stft as jstft
from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig
from speech_enhancement_clskd_tpu_torch.distill import abf as pabf
from speech_enhancement_clskd_tpu_torch.losses import kd as pkd
from speech_enhancement_clskd_tpu_torch.losses import spectral as pspectral
from speech_enhancement_clskd_tpu_torch.models.dccrn import DCCRN
from speech_enhancement_clskd_tpu_torch.ops import complex_layers as pl
from speech_enhancement_clskd_tpu_torch.ops import stft as pstft
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    torch_state_from_flax,
)
from torch_oracle import one_cpu_thread

# BatchNorm: float32 moments over a few hundred elements
BN_ATOL, BN_RTOL = 1e-6, 1e-6
# losses and maps: float32 matmuls and reductions summed in another order
ATOL, RTOL = 1e-5, 1e-5
# gradients, compared as whole tensors
GRAD_REL_L2 = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("given_moments", [False, True])
@pytest.mark.parametrize("return_affine", [False, True])
def test_batchnorm_training_matches_jax(rng, given_moments, return_affine):
    """Output (or affine), and the running statistics moved with momentum
    0.1 and the unbiased variance."""
    x = (rng.standard_normal((3, 5, 7, 6)) * 2.0 + 0.7).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 2.0, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 4.0, 6).astype(np.float32)}
    n = x.size // 6
    moments = None
    if given_moments:
        xf = x.reshape(-1, 6).astype(np.float64)
        moments = (xf.mean(0).astype(np.float32), xf.var(0).astype(np.float32), n)
    # the normalized map needs x; the affine alone needs only the moments
    x_in = None if given_moments and return_affine else x
    jm = jl.BatchNorm(features=6)
    want, mut = jm.apply(
        {"params": params, "batch_stats": stats},
        None if x_in is None else jnp.asarray(x_in), training=True,
        return_affine=return_affine,
        moments=None if moments is None else (jnp.asarray(moments[0]),
                                              jnp.asarray(moments[1]), n),
        mutable=["batch_stats"])
    pm = pl.BatchNorm(6)
    pm.load_state_dict(torch_state_from_flax({"params": params, "batch_stats": stats}))
    got = pm(None if x_in is None else _t(x_in), training=True, return_affine=return_affine,
             moments=None if moments is None else (_t(moments[0]), _t(moments[1]), n))
    for g, w in (zip(got, want) if return_affine else [(got, want)]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=BN_ATOL,
                                   rtol=BN_RTOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(pm, k).numpy(),
                                   np.asarray(mut["batch_stats"][k]),
                                   atol=BN_ATOL, rtol=BN_RTOL, err_msg=k)
        assert not np.array_equal(getattr(pm, k).numpy(), stats[k])


def test_batchnorm_batch_statistics_without_training_leave_running_stats(rng):
    """The frozen teacher's mode: batch statistics normalize, nothing moves."""
    x = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    pm = pl.BatchNorm(5)
    got = pm(_t(x), training=False, use_batch_stats=True)
    want = jl.BatchNorm().apply({"params": {"scale": np.ones(5, np.float32),
                                            "bias": np.zeros(5, np.float32)},
                                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                                 "var": np.ones(5, np.float32)}},
                                jnp.asarray(x), training=False, use_batch_stats=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=BN_ATOL,
                               rtol=BN_RTOL)
    assert torch.equal(pm.mean, torch.zeros(5)) and torch.equal(pm.var, torch.ones(5))


# ------------------------------------------------------ DCCRN training forward


def test_dccrn_training_forward_matches_jax():
    """The student-sized model in training mode: wav, taps and every updated
    BN statistic."""
    jcfg = JaxDCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_make_model(jcfg).init(k, jnp.zeros((1, 1600)), training=True))(
        jax.random.PRNGKey(3)))
    wav = (0.1 * np.random.default_rng(4).standard_normal((3, 4000))).astype(np.float32)
    want, mut = jax.jit(lambda v, w: jax_make_model(jcfg).apply(
        v, w, training=True, mutable=["batch_stats"]))(variables, jnp.asarray(wav))
    model = DCCRN(DCCRNConfig(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)).train()
    model.load_state_dict(torch_state_from_flax(variables))
    got = model(_t(wav), training=True)
    np.testing.assert_allclose(got.wav.detach().numpy(), np.asarray(want.wav), atol=1e-6)
    for a, b in zip(want.taps.encoder + want.taps.decoder,
                    got.taps.encoder + got.taps.decoder):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=5e-5, rtol=1e-5)
    stats = flax_from_torch_state(model.state_dict())["batch_stats"]
    for path, w in _leaves(mut["batch_stats"]):
        g = stats[path[0]][path[1]]
        np.testing.assert_allclose(g, w, atol=BN_ATOL, rtol=BN_RTOL, err_msg=str(path))


# ------------------------------------------------------------------- losses


def _wavs(rng, b=2, n=4000):
    x = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    y = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    return x, y


def test_stft_magnitude_and_gradient_match_jax(rng):
    x, _ = _wavs(rng)
    w = rng.standard_normal((2, 4000 // 100 + 1, 257)).astype(np.float32)
    args = (512, 100, 400, "hann")
    want = jstft.stft_magnitude(jnp.asarray(x), *args)
    want_g = jax.grad(lambda a: jnp.sum(jstft.stft_magnitude(a, *args) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = pstft.stft_magnitude(xt, *args)
    assert tuple(got.shape) == want.shape == w.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    (got * _t(w)).sum().backward()
    assert _rel_l2(xt.grad.numpy(), want_g) <= GRAD_REL_L2


STFT_RESOLUTIONS = [((512,), (100,), (400,)), ((1024, 256), (120, 50), (600, 240))]


def _jax_stft_loss_and_grad(x, y, resolutions):
    ffts, hops, wins = resolutions
    loss = jspectral.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y), ffts, hops, wins)
    grad = jax.grad(lambda a: sum(jspectral.multi_resolution_stft_loss(
        a, jnp.asarray(y), ffts, hops, wins)))(jnp.asarray(x))
    return [float(v) for v in loss], np.asarray(grad)


def _port_stft_loss_and_grad(x, y, resolutions):
    xt = _t(x).requires_grad_(True)
    got = pspectral.multi_resolution_stft_loss(xt, _t(y), *resolutions)
    sum(got).backward()
    return [g.item() for g in got], xt.grad.numpy()


@pytest.mark.parametrize("resolutions", STFT_RESOLUTIONS)
def test_multi_resolution_stft_loss_formula_matches_jax_in_float64(rng, resolutions):
    """The two losses are one formula: in float64 on both sides (JAX under
    ``jax.enable_x64``) the losses agree to 1e-12 and the input gradients to
    1e-10 relative L2."""
    x, y = (a.astype(np.float64) for a in _wavs(rng))
    with jax.enable_x64():
        want, want_g = _jax_stft_loss_and_grad(x, y, resolutions)
    assert want_g.dtype == np.float64
    got, got_g = _port_stft_loss_and_grad(x, y, resolutions)
    assert got_g.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert _rel_l2(got_g, want_g) <= 1e-10


@pytest.mark.parametrize("resolutions", STFT_RESOLUTIONS)
def test_multi_resolution_stft_loss_matches_jax(rng, resolutions):
    """The float32 port against the truth, JAX's float64 gradient: no further
    from it than JAX's own float32 gradient is, and never looser than
    GRAD_REL_L2.  The log-magnitude L1's gradient flips sign where two bins
    meet, so a float32 gradient of this loss can sit more than GRAD_REL_L2
    from the truth, and how far depends on the summation order of the
    float32 FFTs, which moves with the thread count: the case runs at one
    torch thread and at the count found, and restores it."""
    x, y = _wavs(rng)
    with jax.enable_x64():
        _, truth = _jax_stft_loss_and_grad(x.astype(np.float64), y.astype(np.float64),
                                           resolutions)
    want, want_g = _jax_stft_loss_and_grad(x, y, resolutions)
    err_jax32 = _rel_l2(want_g, truth)
    threads = torch.get_num_threads()
    try:
        for n in dict.fromkeys((1, threads)):
            torch.set_num_threads(n)
            got, got_g = _port_stft_loss_and_grad(x, y, resolutions)
            np.testing.assert_allclose(got, want, rtol=RTOL)
            err = _rel_l2(got_g, truth)
            assert err <= max(GRAD_REL_L2, err_jax32), (n, err, err_jax32)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("layout", ["4d", "lstm"])
def test_spkd_loss_and_gradient_match_jax(rng, layout, groups):
    """4-D taps with student and teacher widths that differ, and [T, B, F]
    LSTM taps with the Gram over batch axis 1."""
    if layout == "4d":
        s = rng.standard_normal((4, 6, 5, 3)).astype(np.float32)
        t = rng.standard_normal((4, 6, 5, 8)).astype(np.float32)
        axis = 0
    else:
        s = rng.standard_normal((7, 4, 5)).astype(np.float32)
        t = rng.standard_normal((7, 4, 12)).astype(np.float32)
        axis = 1
    want = jkd.spkd_loss(jnp.asarray(s), jnp.asarray(t), "batchmean", use_pallas=False,
                         batch_axis=axis, groups=groups)
    want_g = jax.grad(lambda a: jkd.spkd_loss(a, jnp.asarray(t), "batchmean", use_pallas=False,
                                              batch_axis=axis, groups=groups))(jnp.asarray(s))
    st = _t(s).requires_grad_(True)
    got = pkd.spkd_loss(st, _t(t), "batchmean", batch_axis=axis, groups=groups)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=1e-7)
    got.backward()
    assert _rel_l2(st.grad.numpy(), want_g) <= GRAD_REL_L2


def test_grams_match_jax(rng):
    z = rng.standard_normal((5, 4, 6)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_allclose(pkd._gram(_t(z), axis).numpy(),
                                   np.asarray(jkd._gram(jnp.asarray(z), axis)),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(pkd._gram_l1(_t(z), axis).numpy(),
                                   np.asarray(jkd._gram_l1(jnp.asarray(z), axis)),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        pkd._grouped_gram_l1(_t(z), 0, 1).numpy()[0],
        np.asarray(jkd._gram_l1(jnp.asarray(z), 0)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        pkd._grouped_gram_l1(_t(z), 1, 2).numpy(),
        np.asarray(jkd._grouped_gram_l1(jnp.asarray(z), 1, 2)), atol=ATOL, rtol=RTOL)


def test_spkd_loss_float32_matches_float64_at_full_width(rng):
    """A full-width tap row holds ~1e6 elements (here 32 channels x 64 freq x
    300 frames, channels-last in memory as the conv maps are).  Student and
    teacher maps are close, so the loss is a small difference of two Grams;
    the port's sliced float32 Gram keeps it within 1e-5 of float64
    (measured 7.7e-7)."""
    x = rng.standard_normal((4, 32, 64, 300)).astype(np.float32)
    student = np.maximum(x, 0.25 * x)  # PReLU-like: positive mean
    teacher = student + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    s_t, t_t = (_t(a).permute(0, 2, 3, 1) for a in (student, teacher))  # [B, D, T, C] views
    got = pkd.spkd_loss(s_t, t_t).item()

    def gram64(a):
        z = a.reshape(4, -1).astype(np.float64)
        g = z @ z.T
        return g / np.abs(g).sum(1, keepdims=True)

    want = float(((gram64(teacher) - gram64(student)) ** 2).sum() / 16)
    assert abs(got - want) <= 1e-5 * want, (got, want)


def test_spkd_loss_refuses_groups_without_pairs(rng):
    """The JAX loss is silently zero when a group holds one utterance; the
    port raises, as it does for a batch that does not divide."""
    s = _t(rng.standard_normal((4, 3, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="at least 2"):
        pkd.spkd_loss(s, s, groups=4)
    with pytest.raises(ValueError, match="not divisible"):
        pkd.spkd_loss(s, s, groups=3)


# ------------------------------------------------------------ nearest resize


@pytest.mark.parametrize("d_out,t_out", [(8, 5), (4, 5), (3, 5), (2, 5), (12, 10), (6, 3)])
def test_resize_freq_is_torch_exact(rng, d_out, t_out):
    """Integer upscale (repeat), one-less (crop), and other sizes (gather)
    on both axes, against F.interpolate(mode='nearest') and the JAX resize."""
    x = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    got = pabf._resize_freq(_t(x), d_out, t_out)
    want = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(d_out, t_out),
                         mode="nearest").permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jabf._resize_freq(jnp.asarray(x), d_out, t_out)))


# ---------------------------------------------------------------- ReviewKD

# student/teacher tap geometry of a 3-layer encoder: freq halves per layer;
# the decoder mirrors it (deepest map first)
B, T_FRAMES = 4, 9
S_ENC, T_ENC, ENC_D = (4, 8, 8), (8, 16, 32), (16, 8, 4)
S_DEC, T_DEC, DEC_D = (8, 4, 2), (32, 16, 2), (8, 16, 32)
MID = 6


def _chain(rng, reverse):
    s_ch, t_ch, ds = (S_ENC, T_ENC, ENC_D) if reverse else (S_DEC, T_DEC, DEC_D)
    taps = [rng.standard_normal((B, d, T_FRAMES, c)).astype(np.float32)
            for d, c in zip(ds, s_ch)]
    jm = jabf.ReviewKD(out_channels=t_ch, mid_channels=MID, reverse=reverse)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5),
                                                  [jnp.asarray(t) for t in taps]))
    # non-trivial BN parameters and running statistics
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "scale" else
                      0.3 * rng.standard_normal(v.shape) if p[-1].key == "bias" else v
                      ).astype(np.float32), variables["params"])
    stats = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
                         variables["batch_stats"])
    pm = pabf.ReviewKD(s_ch, t_ch, MID, reverse=reverse)
    pm.load_state_dict(torch_state_from_flax({"params": params, "batch_stats": stats}),
                       strict=True)
    cot = [rng.standard_normal((B, d, T_FRAMES, c)).astype(np.float32)
           for d, c in zip(ds, t_ch)]
    return jm, params, stats, pm, taps, cot


@pytest.mark.parametrize("reverse", [True, False], ids=["encoder", "decoder"])
def test_review_kd_matches_jax(rng, reverse):
    jm, params, stats, pm, taps, cot = _chain(rng, reverse)

    def loss(p, ts):
        outs, mut = jm.apply({"params": p, "batch_stats": stats}, ts, training=True,
                             mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), (outs, mut)

    (_, (want, mut)), (want_gp, want_gt) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, [jnp.asarray(t) for t in taps])

    tt = [_t(t).requires_grad_(True) for t in taps]
    got = pm(tt, training=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    got_stats = flax_from_torch_state(pm.state_dict())["batch_stats"]
    for path, w in _leaves(mut["batch_stats"]):
        g = got_stats[path[0]][path[1]][path[2]]
        np.testing.assert_allclose(g, w, atol=BN_ATOL, rtol=BN_RTOL, err_msg=str(path))
    sum((g * _t(c)).sum() for g, c in zip(got, cot)).backward()
    for g, w in zip(tt, want_gt):
        assert _rel_l2(g.grad.numpy(), w) <= GRAD_REL_L2
    got_gp = dict(_leaves(flax_from_torch_state(
        {n: p.grad for n, p in pm.named_parameters()})["params"]))
    want_flat = dict(_leaves(want_gp))
    assert got_gp.keys() == want_flat.keys()
    for path, w in want_flat.items():
        assert _rel_l2(got_gp[path], w) <= GRAD_REL_L2, path


def test_review_kd_without_training_uses_running_statistics(rng):
    jm, params, stats, pm, taps, _ = _chain(rng, True)
    want = jm.apply({"params": params, "batch_stats": stats},
                    [jnp.asarray(t) for t in taps], training=False)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():
        got = pm([_t(t) for t in taps], training=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    assert all(torch.equal(v, pm.state_dict()[k]) for k, v in before.items())


def test_abf_init_families(rng):
    """kaiming_uniform for conv1/conv2 (bound sqrt(6/fan_in)), lecun_normal
    truncated at two deviations for att_conv, zero att bias, unit BN."""
    pm = pabf.ReviewKD((16, 16), (32, 32), 64)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    conv1 = pm.abf1.conv1.kernel
    assert conv1.abs().max().item() <= np.sqrt(6 / 16)
    assert conv1.std().item() == pytest.approx(np.sqrt(2 / 16), rel=0.1)
    conv2 = pm.abf1.conv2.kernel
    assert tuple(conv2.shape) == (32, 64, 3, 3)
    assert conv2.abs().max().item() <= np.sqrt(6 / (9 * 64))
    att = pm.abf1.att_conv.kernel
    std = np.sqrt(1 / 128) / 0.87962566103423978
    assert att.abs().max().item() <= 2 * std
    assert att.std().item() == pytest.approx(np.sqrt(1 / 128), rel=0.2)
    assert torch.equal(pm.abf1.att_conv.bias, torch.zeros(2))
    assert pm.abf0.att_conv is None
    assert torch.equal(pm.abf0.bn2.scale, torch.ones(32))
