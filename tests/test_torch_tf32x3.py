"""The split-TF32 ("3xTF32") arithmetic of the 3x3 conv kernels' tensor-core
routes (K3f, ``kernels/csrc/conv3x3_fwd.cu``, and K3w, the weight gradient in
``kernels/csrc/conv3x3_tiles.cuh``), emulated in plain PyTorch on the CPU.

The kernel splits each float32 operand a into hi = cvt.rna.tf32(a) and
lo = cvt.rna.tf32(a - hi) and takes each product as lo_a*hi_b + hi_a*lo_b +
hi_a*hi_b on the tensor cores, which multiply TF32 values exactly and add in
float32.  Here ``tf32_rna`` rounds float32 bits as cvt.rna.tf32.f32 does (to
nearest, ties away from zero, 10 mantissa bits kept), and the three products
are three float32 convolutions of the split operands.  At the reference
conv's width (C = 64, K = 9C = 576) against a float64 conv, the three-product
scheme stays within the kernel's tolerance against its plain version
(``KERNEL_ATOL`` of ``chip_smoke.py``) and a single TF32 pass does not: that
is why the design takes three passes.

The tensor cores add each k8 step's products into their f32 accumulator with
truncation.  K3w's reduction runs over the pixels, thousands of them in a
block and up to millions in a call: emulated with round-toward-zero adds over
tens of thousands of pixels, one accumulator over the whole reduction drifts
past the tolerance K3w is held to, and fresh accumulators per short run of
pixels, added with round-to-nearest, meet it.  That is why K3w's design
starts a fresh accumulator every stage of 64 pixels.

The same three products for the Gram pair ``Z Z^T`` over D ~ 528,000
columns (a split-TF32 tensor-core design of K2, measured on the card against
its f32 FMA tiles and not kept: PERF.md) must stay within 1e-6 of the
largest |G| element (``GRAM_TOL`` of ``chip_smoke.py``), a hundred times
tighter than the conv kernels.  Emulated on waveform-like rows, a fresh
accumulator every k8 step meets it, and one accumulator over a whole
2048-column chunk, or one TF32 pass, does not: such a design has to add each
k8 step's three products into its float32 sums at once.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import _shifted, conv3x3_reference

KERNEL_ATOL = 1e-4  # chip_smoke.py: K3f (max abs) and K3w (relative L2) against plain


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the float32 value cvt.rna.tf32.f32 gives: the 13 low
    mantissa bits rounded off to nearest, ties away from zero (adding half an
    ulp of TF32 to the magnitude bits carries into the exponent where it
    should)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {
        one: one,
        one + 2.0 ** -12: one,                 # below half a TF32 ulp (2^-10)
        one + 2.0 ** -11: one + 2.0 ** -10,    # a tie: away from zero
        -(one + 2.0 ** -11): -(one + 2.0 ** -10),
        one + 3 * 2.0 ** -12: one + 2.0 ** -10,
        2.0 - 2.0 ** -23: 2.0,                 # carries into the exponent
        1e-30: tf32_rna(torch.tensor([1e-30])).item(),
    }
    got = tf32_rna(torch.tensor(list(cases), dtype=torch.float32))
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(got, want)
    low = got.view(torch.int32) & ((1 << 13) - 1)
    assert torch.all(low == 0)


def test_split_keeps_float32_precision():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(a)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    rel = ((hi.double() + lo.double() - a.double()).abs() / a.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel  # hi: 11 bits, lo: 11 more
    rel_hi = ((hi.double() - a.double()).abs() / a.double().abs()).max().item()
    assert 2.0 ** -13 < rel_hi <= 2.0 ** -11, rel_hi


@pytest.fixture(scope="module")
def conv_case():
    """x [2, 6, 37, 64] and w [3, 3, 64, 64] as chip_smoke.py's conv cases
    make them, and their float64 convolution."""
    rng = np.random.default_rng(0)
    C, O = 64, 64
    x = torch.from_numpy(rng.standard_normal((2, 6, 37, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, O)) / (3 * C ** 0.5)).astype(np.float32))
    exact = conv3x3_reference(x.double(), w.double())
    return x, w, exact


def test_three_tf32_products_stay_within_the_kernel_tolerance(conv_case):
    x, w, exact = conv_case
    (xh, xl), (wh, wl) = split(x), split(w)
    got = conv3x3_reference(xl, wh) + conv3x3_reference(xh, wl) + conv3x3_reference(xh, wh)
    err = (got.double() - exact).abs().max().item()
    f32 = (conv3x3_reference(x, w).double() - exact).abs().max().item()
    assert err <= KERNEL_ATOL, err
    assert err <= 10 * f32, (err, f32)  # near a plain float32 sum


def test_one_tf32_pass_misses_the_kernel_tolerance(conv_case):
    x, w, exact = conv_case
    got = conv3x3_reference(tf32_rna(x), tf32_rna(w))
    err = (got.double() - exact).abs().max().item()
    assert err > KERNEL_ATOL, err


def _rz_add(acc: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """float32 ``acc`` plus float64 ``inc``, the exact sum rounded toward zero
    to float32, as the tensor cores' accumulator adds."""
    exact = acc.double() + inc
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def test_long_wgrad_reduction_needs_fresh_accumulators():
    """K3w's product at a [576, 8] output (9 shifts x 64 channels, 8 output
    channels) over 32,000 pixels, three TF32 products a k8 step of 8 pixels,
    each step's products added exactly and then into the accumulator rounded
    toward zero."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 8, 4000, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 8, 4000, 8)).astype(np.float32))
    a = torch.cat([xs.reshape(-1, 64) for _, _, xs in _shifted(x)], dim=1)  # [pixels, 576]
    b = g.reshape(-1, 8)
    exact = a.double().T @ b.double()
    (ah, al), (bh, bl) = split(a), split(b)
    one = torch.zeros(576, 8)     # one accumulator over the whole reduction
    fresh = torch.zeros(576, 8)   # K3w: a fresh one per 64 pixels, added to nearest
    part = torch.zeros(576, 8)
    for k0 in range(0, a.shape[0], 8):
        step = slice(k0, k0 + 8)
        for lhs, rhs in ((al, bh), (ah, bl), (ah, bh)):
            inc = lhs[step].double().T @ rhs[step].double()
            one = _rz_add(one, inc)
            part = _rz_add(part, inc)
        if (k0 + 8) % 64 == 0:
            fresh = fresh + part
            part = torch.zeros(576, 8)
    fresh = fresh + part

    def rel_l2(got):
        return ((got.double() - exact).norm() / exact.norm()).item()

    f32 = rel_l2(a.T @ b)
    assert rel_l2(one) > KERNEL_ATOL, rel_l2(one)
    assert rel_l2(fresh) <= KERNEL_ATOL, rel_l2(fresh)
    assert rel_l2(fresh) <= 10 * f32, (rel_l2(fresh), f32)  # near a plain float32 sum


BLOCK_REL_L2 = 1e-5  # chip_smoke.py: every K5b output against its plain version


def test_block_adjoint_needs_a_fresh_accumulator_per_chunk():
    """K5b's conv adjoint at the deepest blocks' width: g_out with O = 256
    input channels, so K = 9 x 256 = 2304, through K3f's tensor-core tile
    (csrc/conv3x3_mma.cuh).  Per 8-channel chunk and shift, each of the three
    TF32 products is one k8 step, added exactly and then into the
    accumulator rounded toward zero.  One accumulator over all 32 chunks
    drifts past the tolerance K5b is held to; a fresh one per chunk (27
    products), added to the running sum with round-to-nearest, meets it."""
    rng = np.random.default_rng(2)
    O, M = 256, 16
    g = torch.from_numpy(rng.standard_normal((1, 3, 24, O)).astype(np.float32))
    w2f = torch.from_numpy((rng.standard_normal((3, 3, O, M)) / (3 * M ** 0.5))
                           .astype(np.float32))
    shifted = [xs.reshape(-1, O) for _, _, xs in _shifted(g)]  # 9 x [pixels, O]
    exact = conv3x3_reference(g.double(), w2f.double()).reshape(-1, M)
    one = torch.zeros(exact.shape)    # one accumulator over all of K
    fresh = torch.zeros(exact.shape)  # the kernel: a fresh one per chunk
    for c0 in range(0, O, 8):
        part = torch.zeros(exact.shape)
        for k, xs in enumerate(shifted):
            (ah, al), (bh, bl) = split(xs[:, c0:c0 + 8]), split(w2f[k // 3, k % 3, c0:c0 + 8])
            for lhs, rhs in ((al, bh), (ah, bl), (ah, bh)):
                inc = lhs.double() @ rhs.double()
                one = _rz_add(one, inc)
                part = _rz_add(part, inc)
        fresh = fresh + part

    def rel_l2(got):
        return ((got.double() - exact).norm() / exact.norm()).item()

    f32 = rel_l2(conv3x3_reference(g, w2f).reshape(-1, M))
    assert rel_l2(one) > BLOCK_REL_L2, rel_l2(one)
    assert rel_l2(fresh) <= BLOCK_REL_L2, rel_l2(fresh)
    assert rel_l2(fresh) <= 10 * f32, (rel_l2(fresh), f32)  # near a plain float32 sum


GRAM_TOL = 1e-6  # chip_smoke.py: K2 against its plain version, of the largest |G| element
GRAM_CHUNK = 2048  # kernels/gram.py CHUNK: the columns of one partial


def _emulated_gram(z: torch.Tensor, steps_per_acc: int) -> torch.Tensor:
    """``z z^T`` as a split-TF32 tensor-core Gram sums it: each k8 step's
    three TF32 products (lo*hi, hi*lo, hi*hi, each added exactly and then
    into the accumulator rounded toward zero), a fresh accumulator every
    ``steps_per_acc`` steps added in order into float32 sums to nearest, one
    partial per ``GRAM_CHUNK`` columns, and the partials added in chunk
    order."""
    B, D = z.shape
    steps = GRAM_CHUNK // 8
    total = torch.zeros(B, B)
    for c0 in range(0, D, GRAM_CHUNK):
        zc = torch.zeros(B, GRAM_CHUNK)  # columns past D count as zero
        zc[:, :min(GRAM_CHUNK, D - c0)] = z[:, c0:c0 + GRAM_CHUNK]
        hi, lo = (h.double().view(B, steps, 8) for h in split(zc))
        incs = [torch.einsum("bsk,csk->sbc", lhs, rhs) for lhs, rhs in ((lo, hi), (hi, lo), (hi, hi))]
        stretches = steps // steps_per_acc
        acc = torch.zeros(stretches, B, B)
        for j in range(steps_per_acc):
            for inc in incs:
                acc = _rz_add(acc, inc.view(stretches, steps_per_acc, B, B)[:, j])
        part = torch.zeros(B, B)
        for a in acc:
            part = part + a
        total = total + part
    return total


def _waveforms(B: int, D: int) -> torch.Tensor:
    """Rows like the spkd step's waveforms: values in [-1, 1]."""
    rng = np.random.default_rng(B)
    return torch.from_numpy(np.clip(0.3 * rng.standard_normal((B, D)), -1, 1).astype(np.float32))


def _gram_error(got: torch.Tensor, z: torch.Tensor) -> float:
    exact = z.double() @ z.double().T
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


# (B, D): a small batch over 32 chunks and the spkd step's batch over 16
GRAM_SHAPES = [(8, 65536), (32, 32768)]


@pytest.mark.parametrize("B,D", GRAM_SHAPES)
def test_gram_fresh_accumulator_every_k_step_meets_the_tolerance(B, D):
    z = _waveforms(B, D)
    err = _gram_error(_emulated_gram(z, 1), z)
    f32 = _gram_error(z @ z.T, z)
    assert err <= GRAM_TOL / 2, err  # room for the plain version's own rounding
    assert err <= 10 * f32, (err, f32)  # near a plain float32 sum


@pytest.mark.parametrize("B,D", GRAM_SHAPES)
def test_gram_one_accumulator_over_a_chunk_misses_the_tolerance(B, D):
    z = _waveforms(B, D)
    err = _gram_error(_emulated_gram(z, GRAM_CHUNK // 8), z)
    assert err > GRAM_TOL, err


def test_gram_one_tf32_pass_misses_the_tolerance():
    z = _waveforms(32, 32768)
    zr = tf32_rna(z).double()
    err = _gram_error(zr @ zr.T, z)
    assert err > GRAM_TOL, err
