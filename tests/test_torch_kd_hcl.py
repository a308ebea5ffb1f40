"""The port's HCL, adaptive pooling, bn2-folded SPKD and nine-dot conv
against the JAX package's (``losses/kd.py``, ``ops/pallas/conv3x3.py``).

Inputs are drawn from a seed with numpy and go through both functions in
float32.  Forward values are held to 1e-5 relative, gradients (``jax.grad``
against ``torch.autograd``, of the loss, or of the conv's output against a
random cotangent) to 1e-4 relative L2.  The sizes include pooled sizes that
do not divide the map (5 x 7, 3 x 483) and maps of height <= 4, where HCL
skips levels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.losses import kd as jax_kd
from speech_enhancement_clskd_tpu.ops.pallas.conv3x3 import _conv3x3_ninedot
from speech_enhancement_clskd_tpu_torch.distill.abf import _conv3x3_ninedot as ninedot
from speech_enhancement_clskd_tpu_torch.losses import kd

FWD_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _rel_l2(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want))


def _draw(rng, *shapes, shift=0.0):
    return [(rng.standard_normal(s) + shift).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (2, 3, 3, 483), (1, 2, 4, 4), (2, 9, 11),
                                   (3, 1, 2, 9)])
def test_adaptive_avg_pool2d_matches_jax(shape):
    (x,) = _draw(np.random.default_rng(0), shape)
    for out in (4, 2, 1):
        got = kd._adaptive_avg_pool2d(torch.from_numpy(x), out).numpy()
        want = np.asarray(jax_kd._adaptive_avg_pool2d(jnp.asarray(x), out))
        assert got.shape == want.shape == shape[:-2] + (out, out)
        np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=1e-7, err_msg=str(out))


# lists of (student, teacher) shapes: the fused taps as [B, C, D, T] (heights
# above and at the pooled sizes), [B, T, F] LSTM taps, and heights 1..4
HCL_CASES = {
    "fused_taps": [(2, 3, 5, 7), (2, 4, 16, 9), (2, 2, 64, 13)],
    "lstm_taps": [(4, 483, 6)],
    "low_maps": [(2, 3, 1, 5), (2, 3, 2, 5), (2, 3, 3, 5), (2, 3, 4, 5)],
}


@pytest.mark.parametrize("case", list(HCL_CASES))
def test_hcl_matches_jax(case):
    rng = np.random.default_rng(1)
    shapes = HCL_CASES[case]
    fs = _draw(rng, *shapes)
    ft = _draw(rng, *shapes, shift=0.3)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda s, t: jax_kd.hcl(s, t)))([jnp.asarray(f) for f in fs], [jnp.asarray(t) for t in ft])
    ts = [torch.from_numpy(f).requires_grad_(True) for f in fs]
    got = kd.hcl(ts, [torch.from_numpy(t) for t in ft])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=FWD_RTOL)
    for t, g in zip(ts, want_g):
        assert _rel_l2(t.grad, g) <= GRAD_REL_L2


def test_hcl_of_channels_last_maps_matches_jax():
    """The strategy's case: fused maps and teacher taps [B, D, T, C] handed
    to HCL as [B, C, D, T] views (pooled as they lie), against JAX on the
    transposed arrays."""
    rng = np.random.default_rng(6)
    shapes = [(2, 16, 37, 5), (2, 5, 37, 3)]
    fs = _draw(rng, *shapes)
    ft = _draw(rng, *shapes, shift=0.3)
    want, want_g = jax.jit(jax.value_and_grad(lambda s, t: jax_kd.hcl(
        [jnp.transpose(x, (0, 3, 1, 2)) for x in s],
        [jnp.transpose(x, (0, 3, 1, 2)) for x in t])))([jnp.asarray(f) for f in fs],
                                                       [jnp.asarray(t) for t in ft])
    ts = [torch.from_numpy(f).requires_grad_(True) for f in fs]
    got = kd.hcl([t.permute(0, 3, 1, 2) for t in ts],
                 [torch.from_numpy(t).permute(0, 3, 1, 2) for t in ft])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=FWD_RTOL)
    for t, g in zip(ts, want_g):
        assert _rel_l2(t.grad, g) <= GRAD_REL_L2


def test_hcl_rounds_as_float64():
    """The port's HCL of maps the size of the tiny training step's fused taps
    is within 1e-6 of its float64 value (the JAX float32 CPU mean reads
    ~1e-5 off on these sizes: tests/test_torch_trainer.py)."""
    rng = np.random.default_rng(2)
    shapes = [(4, 8, 128, 83), (4, 16, 64, 83), (4, 32, 32, 83)]
    fs = [torch.from_numpy(x) for x in _draw(rng, *shapes)]
    ft = [torch.from_numpy(x) for x in _draw(rng, *shapes, shift=0.3)]
    got = kd.hcl(fs, ft).item()
    want = kd.hcl([f.double() for f in fs], [t.double() for t in ft]).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("groups", [1, 2])
def test_spkd_loss_affine_matches_jax(groups):
    """The bn2-folded SPKD loss and its gradients in the raw map, a and b,
    against the JAX function; with one group also equal to ``spkd_loss`` of
    the formed map (the fold changes nothing but the order of the sums)."""
    rng = np.random.default_rng(3)
    raw, teacher = _draw(rng, (4, 6, 300, 5), (4, 3, 300, 7), shift=0.5)
    a, b = _draw(rng, (5,), (5,))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda r, a_, b_, t: jax_kd.spkd_loss_affine(r, a_, b_, t, groups=groups),
        argnums=(0, 1, 2)))(jnp.asarray(raw), jnp.asarray(a), jnp.asarray(b), jnp.asarray(teacher))
    args = [torch.from_numpy(x).requires_grad_(True) for x in (raw, a, b)]
    got = kd.spkd_loss_affine(*args, torch.from_numpy(teacher), groups=groups)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=FWD_RTOL)
    for t, g in zip(args, want_g):
        assert _rel_l2(t.grad, g) <= GRAD_REL_L2
    formed = kd.spkd_loss(args[0] * args[1] + args[2], torch.from_numpy(teacher), groups=groups)
    np.testing.assert_allclose(got.item(), formed.item(), rtol=FWD_RTOL)


def test_spkd_loss_affine_refuses_one_utterance():
    raw, teacher = torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="at least 2"):
        kd.spkd_loss_affine(raw, torch.ones(4), torch.zeros(4), teacher)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3, 4), (1, 1, 9, 2, 3), (2, 4, 483, 8, 5)])
def test_conv3x3_ninedot_matches_jax(shape):
    """Forward, dx and dw of the nine-dot conv against the JAX one (HWIO
    kernel there, [O, I, 3, 3] in the port)."""
    B, D, T, C, O = shape
    rng = np.random.default_rng(4)
    x, w, cot = _draw(rng, (B, D, T, C), (3, 3, C, O), (B, D, T, O))
    want = np.asarray(jax.jit(_conv3x3_ninedot)(jnp.asarray(x), jnp.asarray(w)))
    want_dx, want_dw = jax.jit(jax.grad(
        lambda x_, w_, c: jnp.sum(_conv3x3_ninedot(x_, w_) * c),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_(True)
    got = ninedot(tx, tw)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())
    assert _rel_l2(tx.grad, want_dx) <= GRAD_REL_L2
    assert _rel_l2(tw.grad.permute(2, 3, 1, 0), want_dw) <= GRAD_REL_L2
    # the same function as the direct conv
    direct = torch.nn.functional.conv2d(tx.detach().permute(0, 3, 1, 2), tw.detach(), padding=1)
    np.testing.assert_allclose(got.detach().numpy(), direct.permute(0, 2, 3, 1).numpy(),
                               rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(want).max())


def test_conv3x3_ninedot_sums_bf16_inputs_in_float32():
    """On bfloat16 inputs the nine products are summed in float32 and the
    result rounded to bfloat16 once (the JAX function sums in bfloat16):
    the bits of the float32 sum of the same bf16 values, rounded."""
    rng = np.random.default_rng(5)
    x, w = _draw(rng, (2, 6, 40, 16), (8, 16, 3, 3))
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = ninedot(xb, wb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ninedot(xb.float(), wb.float()).bfloat16())
