"""K2's module, ``kernels/gram.py`` (the fused SPKD Gram pair), on the CPU
against the Pallas kernel ``ops/pallas/gram.py`` in interpret mode (as
``tests/test_pallas_gram.py`` runs it), forward and custom VJP; the port's
``spkd_loss`` routing onto it; and one full-width row against the JAX XLA
path and float64.

Tolerances (float32 on both sides, the D sums split and ordered differently:
chunks of 2048 summed in order here, the Pallas grid's tiles of 2048 there):
Grams to 1e-5 of their largest element, losses to 1e-5 relative, gradients
to 1e-4 relative L2 error.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.losses import kd as jkd
from speech_enhancement_clskd_tpu.ops.pallas import gram as jgram
from speech_enhancement_clskd_tpu_torch.kernels import gram
from speech_enhancement_clskd_tpu_torch.losses import kd as pkd

GRAM_RTOL = 1e-5  # of the largest |G| element
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
FULL_D = 1 << 19  # the JAX auto gate's least D

# (s shape, t shape): the Pallas test's pair, N-D inputs, a D that is no
# multiple of the chunk (and Ds != Dt), and chunk-aligned lengths
SHAPES = {
    "8x5000_8x3000": ((8, 5000), (8, 3000)),
    "nd": ((4, 16, 10, 6), (4, 32, 10, 6)),
    "ragged": ((3, 2 * gram.CHUNK + 77), (3, gram.CHUNK - 5)),
    "aligned": ((2, gram.CHUNK), (2, 3 * gram.CHUNK)),
}


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30)


def _assert_gram(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= GRAM_RTOL * np.abs(want).max(), (err, np.abs(want).max())


def _pair(rng, name):
    s_shape, t_shape = SHAPES[name]
    return (rng.standard_normal(s_shape).astype(np.float32),
            rng.standard_normal(t_shape).astype(np.float32))


@pytest.fixture
def spy(monkeypatch):
    """The shapes of every ``gram_pair_reference`` call (the K2 route on the
    CPU)."""
    calls = []
    reference = gram.gram_pair_reference
    monkeypatch.setattr(gram, "gram_pair_reference",
                        lambda s2, t2: calls.append((tuple(s2.shape), tuple(t2.shape)))
                        or reference(s2, t2))
    return calls


@pytest.mark.parametrize("name", list(SHAPES))
def test_gram_pair_matches_pallas(rng, name):
    s, t = _pair(rng, name)
    want_s, want_t = jgram.gram_pair(jnp.asarray(s), jnp.asarray(t), interpret=True)
    b = s.shape[0]
    ref_s, ref_t = gram.gram_pair_reference(_t(s.reshape(b, -1)), _t(t.reshape(b, -1)))
    got_s, got_t = gram.gram_pair(_t(s), _t(t))
    for got, want in ((ref_s, want_s), (ref_t, want_t), (got_s, want_s), (got_t, want_t)):
        _assert_gram(got, want)


def test_wrapper_on_cpu_is_the_reference_and_counts_nothing(rng):
    s, t = _pair(rng, "ragged")
    before = gram.gram_pair_fwd.launches
    got = gram.gram_pair_fwd(_t(s), _t(t))
    want = gram.gram_pair_reference(_t(s), _t(t))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert gram.gram_pair_fwd.launches == before


def test_reference_sums_chunks_in_order(rng):
    """The plain version is the in-order sum of the chunks' products, the
    sum the kernel takes across its blocks."""
    z = _t(rng.standard_normal((3, 3 * gram.CHUNK + 10)).astype(np.float32))
    want = torch.zeros(3, 3)
    for c in range(0, z.shape[1], gram.CHUNK):
        part = z[:, c:c + gram.CHUNK]
        want = want + part @ part.T
    got, _ = gram.gram_pair_reference(z, z[:, :5])
    assert torch.equal(got, want)


def test_spkd_losses_match_pallas(rng):
    s = rng.standard_normal((8, 2500)).astype(np.float32)
    t = rng.standard_normal((8, 4100)).astype(np.float32)
    want = float(jgram.spkd_loss_pallas(jnp.asarray(s), jnp.asarray(t), interpret=True))
    for got in (pkd.spkd_loss(_t(s), _t(t), "batchmean", use_pallas=True),
                gram.spkd_loss_fused(_t(s), _t(t))):
        np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    want_sum = float(jgram.spkd_loss_pallas(jnp.asarray(s), jnp.asarray(t), reduction="sum",
                                            interpret=True))
    np.testing.assert_allclose(gram.spkd_loss_fused(_t(s), _t(t), "sum").item(), want_sum,
                               rtol=LOSS_RTOL)


def test_spkd_gradients_match_pallas_vjp(rng):
    s = rng.standard_normal((8, 2500)).astype(np.float32)
    t = rng.standard_normal((8, 4100)).astype(np.float32)
    want = jax.grad(lambda a, b: jgram.spkd_loss_pallas(a, b, interpret=True),
                    argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    st, tt = _t(s, True), _t(t, True)
    gram.spkd_loss_fused(st, tt).backward()
    for got, w in zip((st.grad, tt.grad), want):
        assert _rel_l2(got.numpy(), w) <= GRAD_REL_L2


def test_gram_pair_vjp_nonsymmetric_cotangent(rng):
    """The VJP for an arbitrary cotangent, N-D inputs: dZ = (dG + dG^T) Z."""
    s = rng.standard_normal((4, 7, 100)).astype(np.float32)
    t = rng.standard_normal((4, 300)).astype(np.float32)
    cs = rng.standard_normal((4, 4)).astype(np.float32)
    ct = rng.standard_normal((4, 4)).astype(np.float32)

    def scalar(a, b):
        gs, gt = jgram.gram_pair(a, b, interpret=True)
        return jnp.sum(gs * cs) + jnp.sum(gt * ct)

    want = jax.grad(scalar, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    st, tt = _t(s, True), _t(t, True)
    gs, gt = gram.gram_pair(st, tt)
    ((gs * _t(cs)).sum() + (gt * _t(ct)).sum()).backward()
    assert st.grad.shape == st.shape
    for got, w in zip((st.grad, tt.grad), want):
        assert _rel_l2(got.numpy(), w) <= GRAD_REL_L2


def test_no_gradient_for_an_input_that_needs_none(rng):
    s = _t(rng.standard_normal((3, 50)).astype(np.float32), True)
    t = _t(rng.standard_normal((3, 40)).astype(np.float32))
    gram.spkd_loss_fused(s, t).backward()
    assert s.grad is not None and t.grad is None


# (s shape, t shape, batch_axis, groups, dispatchable)
GATE = {
    "at_min_d": ((4, FULL_D), (4, FULL_D), 0, 1, True),
    "above_min_d_unequal": ((4, FULL_D + 1), (4, 3 * FULL_D), 0, 1, True),
    "student_below": ((4, FULL_D - 1), (4, FULL_D), 0, 1, False),
    "teacher_below": ((4, FULL_D), (4, FULL_D - 1), 0, 1, False),
    "unequal_batch": ((4, FULL_D), (5, FULL_D), 0, 1, False),
    "groups": ((4, FULL_D), (4, FULL_D), 0, 2, False),
    "batch_axis": ((4, FULL_D), (4, FULL_D), 1, 1, False),
    "three_d": ((4, 2, FULL_D), (4, 2, FULL_D), 0, 1, False),
    "max_batch": ((gram.MAX_BATCH, FULL_D), (gram.MAX_BATCH, FULL_D), 0, 1, True),
    "above_max_batch": ((gram.MAX_BATCH + 1, FULL_D), (gram.MAX_BATCH + 1, FULL_D), 0, 1,
                        False),
    "one_row": ((1, FULL_D), (1, FULL_D), 0, 1, False),
}


@pytest.mark.parametrize("name", list(GATE))
def test_dispatchable_on_shapes(name):
    s_shape, t_shape, axis, groups, want = GATE[name]
    assert gram.gram_pair_dispatchable(s_shape, t_shape, axis, groups,
                                       min_d=pkd._PALLAS_MIN_D) is want
    assert pkd._PALLAS_MIN_D == jkd._PALLAS_MIN_D


@pytest.mark.parametrize("use_pallas,groups,routed", [(None, 1, False), (True, 1, True),
                                                     (False, 1, False), (True, 2, False)])
def test_spkd_loss_routes_as_jax(rng, spy, use_pallas, groups, routed):
    """Below the gate's D the auto route takes the sliced matmuls; True
    forces the fused pair, False and ``groups > 1`` never take it.  Every
    route gives the JAX loss."""
    s = rng.standard_normal((4, 900)).astype(np.float32)
    t = rng.standard_normal((4, 700)).astype(np.float32)
    got = pkd.spkd_loss(_t(s), _t(t), "batchmean", use_pallas, groups=groups).item()
    want = float(jkd.spkd_loss(jnp.asarray(s), jnp.asarray(t), "batchmean", use_pallas=False,
                               groups=groups))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert spy == ([((4, 900), (4, 700))] if routed else [])


def test_forced_route_refuses_another_batch_axis(rng):
    z = _t(rng.standard_normal((5, 4, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="batch_axis must be 0"):
        pkd.spkd_loss(z, z, "batchmean", use_pallas=True, batch_axis=1)


@pytest.mark.parametrize("s_shape,t_shape,error", [
    ((1, 100), (1, 100), ValueError), ((gram.MAX_BATCH + 1, 10), (gram.MAX_BATCH + 1, 10),
                                       ValueError),
    ((3, 100), (4, 100), ValueError), ((3, 4, 5), (3, 20), ValueError)])
def test_wrapper_refuses_bad_shapes(s_shape, t_shape, error):
    with pytest.raises(error):
        gram.gram_pair_fwd(torch.zeros(s_shape), torch.zeros(t_shape))


@pytest.mark.parametrize("D, offset", [(4096, 0), (4097, 0), (7, 0), (4096, 1), (2049, 3)])
def test_bulk_ready_pads_to_whole_16_byte_rows(rng, D, offset):
    """What the bf16 kernel is handed: the view itself where its rows are
    whole 16-byte units on a 16-byte base, else a copy zero-padded to a
    multiple of 8 columns on a 16-byte base, whose plain Grams equal the
    view's (the same chunks; the added columns are zero)."""
    buf = _t(rng.standard_normal(5 * D + 8).astype(np.float32)).bfloat16()
    z = buf[offset:offset + 5 * D].reshape(5, D)
    got = gram.bulk_ready(z)
    assert got.shape == (5, -(-D // 8) * 8) and got.data_ptr() % 16 == 0
    assert (got is z) == (D % 8 == 0 and offset == 0)
    assert torch.equal(got[:, :D], z) and not got[:, D:].any()
    for a, b in zip(gram.gram_pair_reference(got, got), gram.gram_pair_reference(z, z)):
        assert torch.allclose(a, b, rtol=1e-6, atol=0)


def test_wrapper_refuses_bad_dtype_and_layout():
    with pytest.raises(TypeError, match="float32"):
        gram.gram_pair_fwd(torch.zeros(3, 10, dtype=torch.float64), torch.zeros(3, 10))
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_pair_fwd(torch.zeros(10, 3).T, torch.zeros(3, 10))


def test_full_width_auto_route_matches_jax_and_float64(rng, spy):
    """B = 4, D = 2^19, the gate's least D: the auto route takes the fused
    pair (its plain version here) and gives the JAX XLA loss, and float64."""
    x = rng.standard_normal((4, FULL_D)).astype(np.float32)
    student = np.maximum(x, 0.25 * x)  # PReLU-like: positive mean
    teacher = student + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    got = pkd.spkd_loss(_t(student), _t(teacher)).item()
    assert spy == [((4, FULL_D), (4, FULL_D))]
    want_xla = float(jkd.spkd_loss(jnp.asarray(student), jnp.asarray(teacher)))
    np.testing.assert_allclose(got, want_xla, rtol=LOSS_RTOL)

    def gram64(a):
        z = a.astype(np.float64)
        g = z @ z.T
        return g / np.abs(g).sum(1, keepdims=True)

    want = float(((gram64(teacher) - gram64(student)) ** 2).sum() / 16)
    assert abs(got - want) <= LOSS_RTOL * want, (got, want)
