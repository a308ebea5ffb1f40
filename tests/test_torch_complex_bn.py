"""Complex batchnorm (``ops/complex_bn.py``, ``use_cbn``) and the real-LSTM
bottleneck (``use_clstm=False``) in the port, on the CPU against the JAX
package.

- ``ComplexBatchNorm`` against the JAX module on one correlated input:
  the training forward, the running statistics it moves, the forward on
  those statistics; in bf16 against the JAX module taken op by op; and the
  whitening property of ``tests/test_complex_ops.py``.
- ``DCCRN`` with ``use_cbn``, with ``use_clstm=False`` and with both, at
  tiny widths (kernels (8, 16, 32), rnn 32, 2 clips of 0.5 s), on the
  port's seeded weights carried to the JAX model: the waveform, the masks,
  every tap and the moved running statistics of the training forward, the
  forward on running statistics, and ``bn_batch_stats=True``, which complex
  BN ignores on both sides.  The JAX forwards are jitted once per session.
- The bridge: the port's state_dict of each model maps name for name onto
  the JAX model's variable tree (the complex BN statistics under
  ``batch_stats``, flax's ``LSTMCell_{i}`` leaves), and back exactly.
- The gradient-norm groups: ``gn_lstm``'s prefixes pick the same leaves
  in both trees.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu.ops.complex_bn import ComplexBatchNorm as JaxComplexBN
from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig
from speech_enhancement_clskd_tpu_torch.models.dccrn import build_model, make_model
from speech_enhancement_clskd_tpu_torch.ops.complex_bn import ComplexBatchNorm
from speech_enhancement_clskd_tpu_torch.ops.complex_lstm import LSTMCell
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    torch_state_from_flax,
)
from torch_oracle import each_once_per_session, one_cpu_thread

# float32 both sides, sums in another order
ATOL = RTOL = 1e-5
# the bf16 normalization against the JAX module op by op, by relative L2
BF16_REL_L2 = 1e-2
TINY = dict(kernel_num=(8, 16, 32), rnn_units=32)
VARIANTS = {"cbn": dict(use_cbn=True), "real_lstm": dict(use_clstm=False),
            "cbn_real_lstm": dict(use_cbn=True, use_clstm=False)}
SAMPLES = 8000
# the names Trainer._grad_norms (and the JAX trainer's) file under gn_lstm
LSTM_PREFIXES = ("clstm", "rnn", "lstm")


def _correlated(seed=0, shape=(4, 6, 10), C=3):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape + (2 * C,)).astype(np.float32)
    z[..., C:] = 0.7 * z[..., :C] + 0.3 * z[..., C:] + 1.5
    return z


def _bn_variables(bn):
    return {"params": {k: jnp.asarray(getattr(bn, k).detach().numpy())
                       for k in ("Wrr", "Wri", "Wii", "Br", "Bi")},
            "batch_stats": {k: jnp.asarray(getattr(bn, k).numpy())
                            for k in ("RMr", "RMi", "RVrr", "RVri", "RVii")}}


def test_complex_bn_matches_jax():
    """Training forward, the moved running statistics, and the forward on
    them; ``Wri`` drawn in [-0.9, 0.9] by the generator."""
    x = _correlated()
    bn = ComplexBatchNorm(3)
    bn.reset_parameters(torch.Generator().manual_seed(0))
    assert (bn.Wri.abs() <= 0.9).all() and bn.Wri.abs().max() > 0
    jbn = JaxComplexBN()
    v = _bn_variables(bn)
    want, moved = jbn.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    got = bn(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for k, w in moved["batch_stats"].items():
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    v2 = {"params": v["params"], "batch_stats": moved["batch_stats"]}
    x2 = _correlated(seed=1)
    want_eval = jbn.apply(v2, jnp.asarray(x2), training=False)
    before = {k: getattr(bn, k).clone() for k in ("RMr", "RMi", "RVrr", "RVri", "RVii")}
    got_eval = bn(torch.from_numpy(x2), training=False)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), atol=ATOL,
                               rtol=RTOL)
    assert all(torch.equal(getattr(bn, k), t) for k, t in before.items())


def test_complex_bn_bf16_computes_in_bf16_as_jax():
    """A bf16 input is normalized in bf16 (float32 parameters cast to it),
    on batch and on running statistics, as the JAX module does it op by
    op; the moved statistics stay float32."""
    x = _correlated(seed=2)
    seeded = ComplexBatchNorm(3)
    seeded.reset_parameters(torch.Generator().manual_seed(1))
    v = _bn_variables(seeded)
    for training in (True, False):
        bn = ComplexBatchNorm(3)
        bn.load_state_dict(seeded.state_dict())
        want = JaxComplexBN().apply(v, jnp.asarray(x, jnp.bfloat16), training=training,
                                    mutable=["batch_stats"])[0]
        got = bn(torch.from_numpy(x).bfloat16(), training=training)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert bn.RMr.dtype == torch.float32
        w = np.asarray(want.astype(jnp.float32))
        err = np.linalg.norm(got.float().detach().numpy() - w) / np.linalg.norm(w)
        assert err <= BF16_REL_L2, (training, err)


def test_complex_bn_whitens():
    """Without the affine, each channel's (re, im) covariance is ~I."""
    B, C, D, T = 8, 3, 16, 20
    z = np.random.default_rng(0).standard_normal((B, D, T, 2 * C)).astype(np.float32)
    z[..., C:] = 0.7 * z[..., :C] + 0.3 * z[..., C:] + 1.5
    y = ComplexBatchNorm(C, affine=False, track_running_stats=False)(
        torch.from_numpy(z), training=True).numpy()
    yr, yi = y[..., :C], y[..., C:]
    for c in range(C):
        r, i = yr[..., c].ravel(), yi[..., c].ravel()
        assert abs(r.mean()) < 1e-4 and abs(i.mean()) < 1e-4
        np.testing.assert_allclose(np.mean(r * r), 1.0, atol=1e-2)
        np.testing.assert_allclose(np.mean(i * i), 1.0, atol=1e-2)
        np.testing.assert_allclose(np.mean(r * i), 0.0, atol=1e-2)


# ------------------------------------------------------------ the models


def _model(variant):
    model = build_model(DCCRNConfig(name=variant, **TINY, **VARIANTS[variant]))
    model.reset_parameters(torch.Generator().manual_seed(3))
    return model


def _wav():
    return (0.1 * np.random.default_rng(5).standard_normal((2, SAMPLES))).astype(np.float32)


def _shapes(tree, prefix=()):
    """(path, shape) of every leaf."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


def _flat_out(out):
    t = out.taps
    return {"wav": out.wav, "mask_real": out.mask_real, "mask_imag": out.mask_imag,
            "est_real": out.est_real, "taps": list(t.encoder) + list(t.decoder)
            + [t.lstm_real, t.lstm_imag]}


def _jax_forwards(variant):
    """The JAX model of ``variant`` on the port's seeded weights: the
    training forward and its moved statistics, the forward on running
    statistics and with ``bn_batch_stats=True``; one jit."""
    model = jax_make_model(JaxDCCRNConfig(name=variant, **TINY, **VARIANTS[variant]))
    variables = jax.tree.map(jnp.asarray, flax_from_torch_state(_model(variant).state_dict()))

    @jax.jit
    def run(v, w):
        train, moved = model.apply(v, w, training=True, mutable=["batch_stats"])
        return (_flat_out(train), moved["batch_stats"], _flat_out(model.apply(v, w, training=False)),
                _flat_out(model.apply(v, w, training=False, bn_batch_stats=True)))

    train, stats, running, batch = run(variables, jnp.asarray(_wav()))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    shapes = jax.eval_shape(lambda w: model.init(jax.random.PRNGKey(0), w, training=True),
                            jnp.zeros((2, SAMPLES)))
    return {"train": host(train), "stats": host(stats), "running": host(running),
            "batch": host(batch), "tree": dict(_shapes(shapes))}


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    return each_once_per_session(tmp_path_factory, "test_torch_complex_bn.forwards",
                                 list(VARIANTS), _jax_forwards)


def _close(got, want, label):
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert len(g) == len(w), label
            for i, (gi, wi) in enumerate(zip(g, w)):
                np.testing.assert_allclose(gi.detach().numpy(), wi, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{label} {key}[{i}]")
        else:
            np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{label} {key}")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["train", "running", "batch"])
def test_forward_matches_jax(forwards, variant, mode):
    """``train``: training mode, BN on batch statistics, the running
    statistics moved as JAX moves them; ``running``: serving; ``batch``:
    ``bn_batch_stats=True`` (real BN on batch statistics, complex BN on its
    running ones)."""
    want = forwards[variant]
    model = _model(variant).train()
    wav = torch.from_numpy(_wav())
    with torch.no_grad():
        if mode == "train":
            out = model(wav, training=True)
        else:
            out = model(wav, training=False, bn_batch_stats=True if mode == "batch" else None)
    _close(_flat_out(out), want[mode], f"{variant} {mode}")
    if mode == "train":
        stats = flax_from_torch_state(model.state_dict())["batch_stats"]
        assert stats.keys() == want["stats"].keys()
        for name, leaves in want["stats"].items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(stats[name][leaf], w, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name}.{leaf}")
    if mode == "batch" and VARIANTS[variant].get("use_cbn"):
        for key in ("wav", "mask_real"):  # complex BN ignores bn_batch_stats
            np.testing.assert_array_equal(want["batch"][key], want["running"][key])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_maps_the_new_leaves_name_for_name(forwards, variant):
    """The port's tree in flax layouts is the JAX model's (every leaf, its
    collection and its shape), and it comes back into the port exactly."""
    model = _model(variant)
    state = model.state_dict()
    tree = flax_from_torch_state(state)
    assert dict(_shapes(tree)) == forwards[variant]["tree"]
    back = torch_state_from_flax(tree)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    fresh = build_model(model.cfg)
    fresh.load_state_dict(back, strict=True)


@pytest.mark.parametrize("variant", ["real_lstm", "cbn"])
def test_gn_lstm_groups_the_leaves_jax_groups(forwards, variant):
    """``gn_lstm`` (a parameter name's prefix) picks the same parameters in
    both trees: with the real LSTM only ``lstm_proj``, flax's
    ``LSTMCell_{i}`` falling outside it as in JAX."""
    port = {n.split(".")[0] for n, _ in _model(variant).named_parameters()
            if n.startswith(LSTM_PREFIXES)}
    jax_side = {path[1] for path in forwards[variant]["tree"]
                if path[0] == "params" and path[1].startswith(LSTM_PREFIXES)}
    assert port == jax_side
    if variant == "real_lstm":
        assert port == {"lstm_proj"}


def test_lstm_cell_concatenates_flax_gates_onto_the_sequence_kernel():
    """An ``LSTMCell`` equals flax's cell stepped over the sequence
    (``nn.RNN(nn.LSTMCell)``), on its own leaves."""
    import flax.linen as nn

    cell = LSTMCell(12, 8)
    cell.reset_parameters(torch.Generator().manual_seed(7))
    x = np.random.default_rng(6).standard_normal((9, 3, 12)).astype(np.float32)
    params = flax_from_torch_state({f"c.{k}": v for k, v in cell.state_dict().items()})["params"]
    rnn = nn.RNN(nn.LSTMCell(features=8), time_major=True)
    want = rnn.apply({"params": {"cell": jax.tree.map(jnp.asarray, params["c"])}},
                     jnp.asarray(x))
    got = cell(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_models_serve_from_make_model():
    """``make_model`` builds each variant (it raised before), in eval mode,
    and its forward is finite; the real LSTM stays float32 under bf16."""
    for variant, kw in VARIANTS.items():
        model = make_model(DCCRNConfig(**TINY, **kw), device="cpu")
        with torch.no_grad():
            out = model(torch.from_numpy(_wav()))
        assert not model.training and torch.isfinite(out.wav).all(), variant
    bf16 = make_model(DCCRNConfig(**TINY, use_clstm=False, compute_dtype="bfloat16"),
                      device="cpu")
    with torch.no_grad():
        taps = bf16(torch.from_numpy(_wav())).taps
    assert taps.encoder[0].dtype == torch.bfloat16 and taps.lstm_real.dtype == torch.float32
