"""The hand-written CUDA kernels of the ABF chain (3x3 conv K3f, its weight
gradient K3w, attention fuse K4f and its backward K4b, the whole block K5f
and its backward K5b) against their plain PyTorch versions, on the card, and
the bf16 instantiations of K3f, K3w, K4f, K4b, K5f and K5b against their
plain bf16 versions.  Skipped where there is no CUDA device.

Imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_abf_cuda_kernels.py -q
"""

import pytest
import torch

from speech_enhancement_clskd_tpu_torch.kernels import BLEND_REL, SUM_REL, bf16_check
from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
    abf_block,
    abf_block_bwd,
    abf_block_bwd_reference,
    abf_block_bf16_scales,
    abf_block_bwd_route,
    abf_block_fwd,
    abf_block_fwd_route,
    abf_block_reference,
)
from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
    attention_fuse,
    attention_fuse_bwd,
    attention_fuse_bwd_reference,
    attention_fuse_fwd,
    attention_fuse_reference,
)
from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
    conv3x3,
    conv3x3_fwd,
    conv3x3_fwd_route,
    conv3x3_reference,
    conv3x3_wgrad,
    conv3x3_wgrad_reference,
    conv3x3_wgrad_route,
)

pytestmark = pytest.mark.cuda

# f32 both sides (the kernels' tensor-core routes in split TF32, within f32
# rounding of an f32 sum), sums in another order.  Maps by max abs error; the
# parameter gradients, sums over every row, by relative L2 error.
ATOL = 1e-4
REL_L2 = 1e-4

# (B, D, T, C, O): D down to 1 and 4, ragged T, O and C from 2 to 256 (every
# tile shape of both kernels), and the dx pass's C = 256 -> 64
CONV_SHAPES = [(2, 4, 483, 64, 256), (3, 5, 37, 64, 64), (2, 8, 70, 64, 32),
               (2, 6, 19, 64, 16), (1, 16, 300, 64, 2), (2, 16, 483, 256, 64),
               (1, 1, 5, 3, 7), (2, 3, 9, 2, 64), (2, 5, 33, 64, 12)]
# (B, D, Dp, T, C): k = 2, 1, 4, ragged rows and C below and above 64
FUSE_SHAPES = [(2, 8, 4, 483, 64), (3, 5, 5, 37, 64), (2, 16, 4, 11, 32),
               (1, 4, 2, 9, 200), (2, 2, 1, 7, 6)]
# (fuse, B, D, k, T, Cs, M, O): every K5f tile (O >= 64, 32, 16, < 16), k = 1,
# 2, 4, T ragged past K5b's 64-step items, D of one row, Cs and M from 2 to 64;
# then each route of both kernels: the mask block's direct paths (O = 2,
# Cs = 2) over two chunks of K5f's rows, M = 8 (the least M on K5b's mma
# route) with T one past an item, a direct forward beside an mma adjoint
# (O = 4), M < 4 with O > 8 (the direct forward's output tiles, the direct
# adjoint's channel stages; widths off the float4 loads), M = 6 on the mma
# forward beside a direct adjoint, and k = 4, Cs = 12 (a tap quad past the
# power of two) with T ragged over two items
BLOCK_SHAPES = [(True, 2, 8, 2, 483, 16, 64, 64), (True, 2, 16, 2, 70, 64, 64, 256),
                (True, 1, 8, 4, 37, 8, 64, 32), (True, 3, 5, 1, 19, 2, 64, 16),
                (True, 2, 32, 2, 100, 2, 64, 2), (True, 2, 2, 2, 9, 4, 6, 5),
                (False, 2, 4, 1, 483, 64, 64, 256), (False, 1, 1, 1, 5, 3, 7, 7),
                (True, 2, 64, 2, 37, 2, 64, 2), (True, 3, 5, 1, 65, 16, 8, 16),
                (True, 2, 6, 2, 19, 4, 8, 4), (True, 1, 3, 1, 21, 5, 3, 20),
                (True, 2, 4, 2, 30, 5, 6, 16), (True, 2, 40, 4, 130, 12, 64, 32)]
BLOCK_GRADS = ("g_tap", "g_res", "dw1a", "dbvec", "dwxt", "dwy", "dzoff", "dw2")
# The bf16 K5f and K5b's route "fused" (csrc/abf_block_bf16.cu): every block
# shape of the block-config step (chip_smoke.STEP_BLOCKS: D 4 .. 256, Cs 64 ..
# 2, O 256 .. 2, the mask block last) at batch 2 and the step's T = 483; then
# ragged shapes: T off the 64-step strips, D of one row (with and without the
# fuse), k = 1 over an odd D (a pair's second row past the map), k = 4, M =
# 8 and 32, O = 72 (w2f streamed, a chunk of one group; K5f's two passes),
# the mask block's narrow route over a ragged T and without the fuse, and
# K5f's one-kernel forward (O <= 64) over D = 40 (its 32-row chunks, the
# last short) and T = 124 (two whole 62-step strips)
BF16_FUSED_SHAPES = [(False, 2, 4, 1, 483, 64, 64, 256), (True, 2, 8, 2, 483, 64, 64, 256),
                     (True, 2, 16, 2, 483, 64, 64, 256), (True, 2, 32, 2, 483, 32, 64, 128),
                     (True, 2, 64, 2, 483, 16, 64, 64), (True, 2, 128, 2, 483, 8, 64, 32),
                     (False, 2, 8, 1, 483, 64, 64, 256), (True, 2, 256, 2, 483, 2, 64, 2),
                     (False, 2, 1, 1, 100, 16, 64, 64), (True, 3, 1, 1, 37, 8, 64, 32),
                     (True, 2, 5, 1, 65, 16, 64, 16), (True, 2, 16, 4, 130, 8, 64, 32),
                     (True, 2, 4, 2, 19, 8, 8, 8), (True, 2, 6, 2, 90, 64, 32, 64),
                     (True, 1, 4, 2, 50, 8, 64, 72), (True, 2, 16, 2, 37, 2, 64, 2),
                     (False, 2, 8, 1, 70, 2, 64, 2), (True, 2, 40, 2, 124, 8, 64, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _conv_inputs(shape, seed, dev):
    B, D, T, C, O = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, D, T, C, generator=g).to(dev)
    w = (torch.randn(3, 3, C, O, generator=g) / (3 * C ** 0.5)).to(dev)
    gy = torch.randn(B, D, T, O, generator=g).to(dev)
    return x, w, gy


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_kernels_match_plain(cuda, shape):
    x, w, gy = _conv_inputs(shape, sum(shape), cuda)
    before = (conv3x3_fwd.launches, conv3x3_wgrad.launches)
    out = conv3x3_fwd(x, w)
    dw = conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches, conv3x3_wgrad.launches) == (before[0] + 1, before[1] + 1)
    assert (out - conv3x3_reference(x, w)).abs().max().item() <= ATOL
    assert _rel_l2(dw, conv3x3_wgrad_reference(x, gy)) <= REL_L2
    assert torch.equal(dw, conv3x3_wgrad(x, gy))  # the same bits every run


def test_conv_autograd_launches_its_kernels(cuda):
    x, w, gy = _conv_inputs((2, 8, 40, 16, 32), 3, cuda)
    w_mod = w.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    x = x.requires_grad_(True)
    before = (conv3x3_fwd.launches, conv3x3_wgrad.launches)
    conv3x3(x, w_mod).backward(gy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches, conv3x3_wgrad.launches) == (before[0] + 2, before[1] + 1)
    xr = x.detach().clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    conv3x3_reference(xr, wr).backward(gy)
    assert (x.grad - xr.grad).abs().max().item() <= ATOL
    assert _rel_l2(w_mod.grad, wr.grad.permute(3, 2, 0, 1)) <= REL_L2


# K3f by route (B, D, T, C, O, route): ragged T, D = 1, C not a multiple of 8
# (16-byte copies at C = 12, 4-byte copies at C = 6), O = 8 and 256, the dx
# passes of the training step (C = 256, 128, 32 -> 64; C = 2 -> 64 on the FMA
# tile), and the FMA tile's O = 2 and 7 and C = 3
K3F_SHAPES = [(2, 5, 37, 12, 64, "mma"), (1, 1, 483, 64, 256, "mma"),
              (2, 3, 21, 6, 10, "mma"), (3, 2, 19, 64, 8, "mma"), (2, 4, 70, 64, 32, "mma"),
              (2, 16, 483, 256, 64, "mma"), (2, 32, 100, 128, 64, "mma"),
              (2, 64, 61, 32, 64, "mma"), (1, 1, 1, 64, 16, "mma"),
              (2, 64, 50, 2, 64, "fma"), (1, 16, 300, 64, 2, "fma"), (2, 3, 9, 64, 7, "fma"),
              (2, 3, 9, 3, 64, "fma")]


@pytest.mark.parametrize("shape", K3F_SHAPES, ids=str)
def test_k3f_matches_plain_on_its_route(cuda, shape):
    """Each shape takes the route its C entry states, matches the plain
    version and gives the same bits on a second run."""
    *dims, route = shape
    x, w, _ = _conv_inputs(dims, sum(dims), cuda)
    assert conv3x3_fwd_route(dims[3], dims[4]) == route
    before = conv3x3_fwd.launches
    out = conv3x3_fwd(x, w)
    again = conv3x3_fwd(x, w)
    torch.cuda.synchronize()
    assert conv3x3_fwd.launches == before + 2
    assert (out - conv3x3_reference(x, w)).abs().max().item() <= ATOL
    assert torch.equal(out, again)


def _fuse_inputs(shape, seed, dev):
    B, D, Dp, T, C = shape
    g = torch.Generator().manual_seed(seed)
    return [t.to(dev) for t in (torch.randn(B, D, T, C, generator=g),
                                torch.randn(B, Dp, T, C, generator=g),
                                0.3 * torch.randn(C, 2, generator=g),
                                0.3 * torch.randn(C, 2, generator=g),
                                0.1 * torch.randn(2, generator=g),
                                torch.randn(B, D, T, C, generator=g))]


@pytest.mark.parametrize("shape", FUSE_SHAPES, ids=str)
def test_fuse_kernels_match_plain(cuda, shape):
    x, res, wx, wy, bias, gy = _fuse_inputs(shape, sum(shape), cuda)
    before = (attention_fuse_fwd.launches, attention_fuse_bwd.launches)
    out, z = attention_fuse_fwd(x, res, wx, wy, bias)
    grads = attention_fuse_bwd(x, res, z, gy, wx, wy)
    torch.cuda.synchronize()
    assert (attention_fuse_fwd.launches, attention_fuse_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    rout, rz = attention_fuse_reference(x, res, wx, wy, bias)
    assert (out - rout).abs().max().item() <= ATOL
    assert (z - rz).abs().max().item() <= ATOL
    want = attention_fuse_bwd_reference(x, res, z, gy, wx, wy)
    for name, got, ref in zip(("dx", "dres", "dwx", "dwy", "dbias"), grads, want):
        assert got.shape == ref.shape, name
        if name in ("dx", "dres"):
            assert (got - ref).abs().max().item() <= ATOL, name
        else:
            assert _rel_l2(got, ref) <= REL_L2, name
    again = attention_fuse_bwd(x, res, z, gy, wx, wy)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # the same bits every run


def test_fuse_autograd_launches_its_kernels(cuda):
    x, res, wx, wy, bias, gy = _fuse_inputs((2, 8, 4, 21, 64), 5, cuda)
    ins = [t.requires_grad_(True) for t in (x, res, wx, wy, bias)]
    before = (attention_fuse_fwd.launches, attention_fuse_bwd.launches)
    attention_fuse(*ins).backward(gy)
    torch.cuda.synchronize()
    assert (attention_fuse_fwd.launches, attention_fuse_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    assert tuple(ins[4].grad.shape) == (2,)
    refs = [t.detach().clone().requires_grad_(True) for t in ins]
    attention_fuse_reference(*refs)[0].backward(gy)
    for got, ref in zip(ins, refs):
        assert _rel_l2(got.grad, ref.grad) <= REL_L2


def test_fuse_kernel_rejects_too_wide(cuda):
    x, res, wx, wy, bias, _ = _fuse_inputs((1, 2, 1, 3, 257), 0, cuda)
    with pytest.raises(ValueError, match="attfuse_dispatchable"):
        attention_fuse_fwd(x, res, wx, wy, bias)


def _block_inputs(shape, seed, dev):
    """(kwargs of abf_block, g_xf, g_out) on ``dev``."""
    fuse, B, D, k, T, Cs, M, O = shape
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(dev)

    kw = dict(tap=r(B, D, T, Cs), res=r(B, D // k, T, M) if fuse else None,
              w1a=r(Cs, M, scale=0.4), bvec=r(M, scale=0.2), wxt=r(Cs, 2, scale=0.3),
              wy=r(M, 2, scale=0.3), zoff=r(2, scale=0.1),
              w2=r(3, 3, M, O, scale=1 / (3 * M ** 0.5)))
    return kw, r(B, D, T, M), r(B, D, T, O)


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_block_kernels_match_plain(cuda, shape):
    kw, gxf, gout = _block_inputs(shape, sum(shape), cuda)
    before = (abf_block_fwd.launches, abf_block_bwd.launches)
    xf, out = abf_block_fwd(**kw)
    grads = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    torch.cuda.synchronize()
    assert (abf_block_fwd.launches, abf_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    xf_again, out_again = abf_block_fwd(**kw)
    assert torch.equal(xf, xf_again) and torch.equal(out, out_again)  # the same bits
    rxf, rout = abf_block_reference(**kw)
    assert (xf - rxf).abs().max().item() <= ATOL
    assert (out - rout).abs().max().item() <= ATOL
    want = abf_block_bwd_reference(**kw, xf=rxf, gxf=gxf, gout=gout)
    for name, got, ref in zip(BLOCK_GRADS, grads, want):
        if ref is None:
            assert got is None, name
        elif name in ("g_tap", "g_res"):
            assert got.shape == ref.shape, name
            assert (got - ref).abs().max().item() <= ATOL, name
        else:
            assert got.shape == ref.shape, name
            assert _rel_l2(got, ref) <= REL_L2, name
    again = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, again))  # the same bits


def test_block_autograd_launches_only_its_kernels(cuda):
    kw, gxf, gout = _block_inputs((True, 2, 8, 2, 40, 16, 64, 32), 7, cuda)
    ins = {n: t.requires_grad_(True) for n, t in kw.items()}
    others = (conv3x3_fwd, conv3x3_wgrad, attention_fuse_fwd, attention_fuse_bwd)
    before = [fn.launches for fn in (abf_block_fwd, abf_block_bwd) + others]
    xf, out = abf_block(**ins)
    (torch.vdot(xf.flatten(), gxf.flatten()) + torch.vdot(out.flatten(), gout.flatten())).backward()
    torch.cuda.synchronize()
    assert [fn.launches for fn in (abf_block_fwd, abf_block_bwd) + others] == \
        [before[0] + 1, before[1] + 1] + before[2:]
    assert tuple(ins["bvec"].grad.shape) == (64,) and tuple(ins["zoff"].grad.shape) == (2,)
    refs = {n: t.detach().clone().requires_grad_(True) for n, t in kw.items()}
    rxf, rout = abf_block_reference(**refs)
    (torch.vdot(rxf.flatten(), gxf.flatten()) + torch.vdot(rout.flatten(), gout.flatten())
     ).backward()
    for n in kw:
        assert _rel_l2(ins[n].grad, refs[n].grad) <= REL_L2, n


@pytest.mark.parametrize("M, O, fwd_route, bwd_route",
                         [(64, 256, "mma", "mma"), (64, 8, "mma", "mma"), (64, 4, "direct", "mma"),
                          (64, 2, "direct", "direct"), (8, 16, "mma", "mma"),
                          (7, 16, "mma", "direct"), (3, 20, "direct", "direct")])
def test_block_route_by_shape(cuda, M, O, fwd_route, bwd_route):
    assert (abf_block_fwd_route(M, O), abf_block_bwd_route(M, O)) == (fwd_route, bwd_route)


def test_block_kernel_rejects_too_wide(cuda):
    kw, _, _ = _block_inputs((True, 1, 2, 1, 3, 65, 8, 4), 0, cuda)
    with pytest.raises(ValueError, match="abf_block_dispatchable"):
        abf_block_fwd(**kw)


# K3w by route (B, D, T, C, O, route): each distinct wgrad shape of the
# kernel-config step at batch 32 (x has the mid C = 64 channels, g a teacher
# tap's O), then ragged ones: D = 1, T = 1, C = 2 and 6 and O = 10 (4-byte
# copies), O = 12 (16-byte copies, a ragged output tile), O = 9 (the least
# O on route "mma") and O = 8, 7 on route "narrow"
K3W_STEP_SHAPES = [(32, 4, 483, 64, 256, "mma"), (32, 8, 483, 64, 256, "mma"),
                   (32, 16, 483, 64, 256, "mma"), (32, 32, 483, 64, 128, "mma"),
                   (32, 64, 483, 64, 64, "mma"), (32, 128, 483, 64, 32, "mma"),
                   (32, 256, 483, 64, 2, "narrow")]
K3W_SHAPES = K3W_STEP_SHAPES + [
    (1, 1, 483, 64, 64, "mma"), (2, 3, 1, 64, 32, "mma"), (2, 3, 9, 2, 64, "mma"),
    (2, 3, 21, 6, 10, "mma"), (2, 5, 33, 64, 12, "mma"), (3, 2, 70, 40, 9, "mma"),
    (2, 4, 37, 64, 8, "narrow"), (2, 3, 9, 64, 7, "narrow")]


@pytest.mark.parametrize("shape", K3W_SHAPES, ids=str)
def test_k3w_matches_plain_on_its_route(cuda, shape):
    """Each shape takes the route its C entry states, matches the plain
    version and gives the same bits on a second run."""
    *dims, route = shape
    x, _, gy = _conv_inputs(dims, sum(dims), cuda)
    assert conv3x3_wgrad_route(dims[3], dims[4]) == route
    before = conv3x3_wgrad.launches
    dw = conv3x3_wgrad(x, gy)
    again = conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 2
    assert _rel_l2(dw, conv3x3_wgrad_reference(x, gy)) <= REL_L2
    assert torch.equal(dw, again)


@pytest.mark.parametrize("C, O, route", [(64, 256, "mma"), (64, 9, "mma"), (2, 64, "mma"),
                                         (64, 8, "narrow"), (64, 2, "narrow"),
                                         (3, 1, "narrow")])
def test_k3w_route_by_shape(cuda, C, O, route):
    assert conv3x3_wgrad_route(C, O) == route


# ---------------------------------------------------------------- bf16

# bf16 outputs: both sides sum the same exact products (or float32 terms) in
# other orders and round once, so an element differs by one bf16 spacing or,
# where its sum cancels, by the float32 rounding of its terms' magnitudes
# (kernels.SUM_REL of them; measured <= 0.54 float32 roundings on ~1e-5 of
# the elements); K4f's blend by one spacing of z carried through
# (kernels.BLEND_REL).  float32 outputs (dw, the fuse's parameter gradients)
# by float32 rounding.
BF16_REL_L2 = 1e-5
# every route of both bf16 conv kernels: the wgmma forward and weight
# gradient at every (C, O) pair of the training step's convs and dx passes
# (64 -> 256, 256 -> 64, 64 -> 128, 128 -> 64, 64 -> 32, 32 -> 64) with T off
# the 64-step tile, D = 1 (both halo rows outside the map) and C = 192 (three
# resident 64-channel chunks), C = 8 and O = 8, 24, 40 (tiles mostly zeros
# from TMA); the mma forward and weight gradient off wgmma (C = 12, O = 12),
# C below 8 (the FMA route), O = 2 (FMA forward, narrow weight gradient)
BF16_CONV_SHAPES = CONV_SHAPES + [(2, 3, 20, 12, 8), (2, 4, 40, 8, 24),
                                  (2, 3, 130, 64, 128), (2, 5, 61, 128, 64),
                                  (2, 6, 77, 32, 64), (1, 1, 64, 64, 64), (1, 1, 100, 256, 64),
                                  (1, 3, 50, 192, 40)]
# the bf16 K5b's dw1a, dwxt and dwy: float32 sums of g_xhat and dp rounded to
# bf16 inside the kernel, where a float32 value near a rounding midpoint may
# round the other way on the two sides and move its term by one bf16 spacing
# (measured 2.4e-5 on dw1a, NVIDIA H100 80GB HBM3, 700 W; dbvec, dzoff and dw2
# sum unrounded values and stay within BF16_REL_L2)
BF16_ROUNDED_REL_L2 = 1e-4
# the fuse's shapes, two with odd C (the element-wise loads), a step shape of
# the kernel-config step at batch 2 (D = 256, k = 2, T = 483: a short last
# strip, z's planes off 16 bytes) and a D of one row
BF16_FUSE_SHAPES = FUSE_SHAPES + [(2, 4, 2, 9, 5), (1, 2, 1, 7, 255), (2, 256, 128, 483, 64),
                                  (2, 1, 1, 483, 64)]


def _bf16(*ts):
    return tuple(t.to(torch.bfloat16) for t in ts)


@pytest.mark.parametrize("shape", BF16_CONV_SHAPES, ids=str)
def test_bf16_conv_kernels_match_plain(cuda, shape):
    x, w, gy = _bf16(*_conv_inputs(shape, sum(shape), cuda))
    before = (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16)
    out = conv3x3_fwd(x, w)
    dw = conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16) == (before[0] + 1,
                                                                         before[1] + 1)
    assert out.dtype == torch.bfloat16 and dw.dtype == torch.float32
    scale = conv3x3_reference(x.abs().float(), w.abs().float())
    assert bf16_check(out, conv3x3_reference(x, w), scale, SUM_REL)["within"]
    assert _rel_l2(dw, conv3x3_wgrad_reference(x, gy)) <= BF16_REL_L2
    assert torch.equal(out, conv3x3_fwd(x, w))  # the same bits every run
    assert torch.equal(dw, conv3x3_wgrad(x, gy))


def test_bf16_conv_autograd_launches_its_kernels(cuda):
    x, w, gy = _bf16(*_conv_inputs((2, 8, 40, 16, 32), 3, cuda))
    w_mod = w.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    x = x.requires_grad_(True)
    before = (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16)
    conv3x3(x, w_mod).backward(gy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16) == (before[0] + 2,
                                                                         before[1] + 1)
    assert x.grad.dtype == w_mod.grad.dtype == torch.bfloat16
    w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
    scale = conv3x3_reference(gy.abs().float(), w_flip.abs().float())
    assert bf16_check(x.grad, conv3x3_reference(gy, w_flip), scale, SUM_REL)["within"]
    want = conv3x3_wgrad_reference(x.detach(), gy).to(torch.bfloat16).permute(3, 2, 0, 1)
    assert bf16_check(w_mod.grad, want)["within"]


@pytest.mark.parametrize("C, O, fwd, wgrad", [(64, 64, "wgmma", "wgmma"), (8, 8, "wgmma", "narrow"),
                                              (4, 64, "fma", "mma"), (64, 2, "fma", "narrow"),
                                              (12, 64, "mma", "mma"), (64, 12, "mma", "mma"),
                                              (256, 64, "wgmma", "wgmma"),
                                              (512, 64, "mma", "wgmma")])
def test_bf16_conv_route_by_shape(cuda, C, O, fwd, wgrad):
    assert conv3x3_fwd_route(C, O, torch.bfloat16) == fwd
    assert conv3x3_wgrad_route(C, O, torch.bfloat16) == wgrad
    # a map off 16 bytes takes the m16n8k16 tile in place of TMA's
    assert conv3x3_fwd_route(C, O, torch.bfloat16, aligned=False) == fwd.replace("wgmma", "mma")
    assert conv3x3_wgrad_route(C, O, torch.bfloat16, aligned=False) == wgrad.replace("wgmma",
                                                                                    "mma")


@pytest.mark.parametrize("shape", [(2, 3, 70, 64, 64), (1, 2, 37, 256, 64)], ids=str)
def test_bf16_conv_unaligned_input_takes_mma(cuda, shape):
    """x one element into a larger buffer (2 bytes off TMA's 16-byte
    alignment): both kernels run on the m16n8k16 tile, match their plain
    versions as on the aligned maps, and give the same bits twice."""
    x, w, gy = _bf16(*_conv_inputs(shape, sum(shape) + 1, cuda))
    buf = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0
    C, O = shape[3], shape[4]
    assert conv3x3_fwd_route(C, O, torch.bfloat16, aligned=False) == "mma"
    assert conv3x3_wgrad_route(C, O, torch.bfloat16, aligned=False) == "mma"
    before = (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16)
    out = conv3x3_fwd(xo, w)
    dw = conv3x3_wgrad(xo, gy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16) == (before[0] + 1,
                                                                         before[1] + 1)
    scale = conv3x3_reference(x.abs().float(), w.abs().float())
    assert bf16_check(out, conv3x3_reference(x, w), scale, SUM_REL)["within"]
    assert _rel_l2(dw, conv3x3_wgrad_reference(x, gy)) <= BF16_REL_L2
    assert torch.equal(out, conv3x3_fwd(xo, w))
    assert torch.equal(dw, conv3x3_wgrad(xo, gy))


@pytest.mark.parametrize("shape", BF16_FUSE_SHAPES, ids=str)
def test_bf16_fuse_kernels_match_plain(cuda, shape):
    x, res, wx, wy, bias, gy = _bf16(*_fuse_inputs(shape, sum(shape), cuda))
    before = (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16)
    out, z = attention_fuse_fwd(x, res, wx, wy, bias)
    grads = attention_fuse_bwd(x, res, z, gy, wx, wy)
    torch.cuda.synchronize()
    assert (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    rout, rz = attention_fuse_reference(x, res, wx, wy, bias)
    assert out.dtype == z.dtype == torch.bfloat16
    y = torch.repeat_interleave(res, x.shape[1] // res.shape[1], dim=1)
    blend = x.float().abs() * rz[..., 0:1].float() + y.float().abs() * rz[..., 1:2].float()
    assert bf16_check(out, rout, blend, BLEND_REL)["within"]
    assert bf16_check(z, rz)["within"]
    want = attention_fuse_bwd_reference(x, res, z, gy, wx, wy)
    # the magnitudes of dx's and dres's terms: the plain backward on |inputs|
    scales = attention_fuse_bwd_reference(*(t.abs() for t in (x, res, z, gy, wx, wy)))
    for name, got, ref, scale in zip(("dx", "dres", "dwx", "dwy", "dbias"), grads, want,
                                     scales):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        if name in ("dx", "dres"):
            assert got.dtype == torch.bfloat16
            assert bf16_check(got, ref, scale, SUM_REL)["within"], name
        else:
            assert got.dtype == torch.float32
            assert _rel_l2(got, ref) <= BF16_REL_L2, name
    again_out, again_z = attention_fuse_fwd(x, res, wx, wy, bias)
    assert torch.equal(out, again_out) and torch.equal(z, again_z)
    again = attention_fuse_bwd(x, res, z, gy, wx, wy)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # the same bits every run


@pytest.mark.parametrize("shape", [(2, 8, 4, 70, 64), (1, 4, 2, 37, 200)], ids=str)
def test_bf16_fuse_unaligned_input_is_copied(cuda, shape):
    """x and g one element into larger buffers (2 bytes off the bulk copies'
    16-byte alignment): the wrappers copy them and the kernels give the plain
    versions' values, and the same bits twice."""
    x, res, wx, wy, bias, gy = _bf16(*_fuse_inputs(shape, sum(shape) + 1, cuda))
    xo, go = (torch.empty(t.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(t.shape)
              for t in (x, gy))
    xo.copy_(x)
    go.copy_(gy)
    assert xo.data_ptr() % 16 != 0 and go.data_ptr() % 16 != 0
    before = (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16)
    out, z = attention_fuse_fwd(xo, res, wx, wy, bias)
    grads = attention_fuse_bwd(xo, res, z, go, wx, wy)
    torch.cuda.synchronize()
    assert (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    rout, rz = attention_fuse_reference(x, res, wx, wy, bias)
    y = torch.repeat_interleave(res, x.shape[1] // res.shape[1], dim=1)
    blend = x.float().abs() * rz[..., 0:1].float() + y.float().abs() * rz[..., 1:2].float()
    assert bf16_check(out, rout, blend, BLEND_REL)["within"]
    assert bf16_check(z, rz)["within"]
    want = attention_fuse_bwd_reference(x, res, z, gy, wx, wy)
    scales = attention_fuse_bwd_reference(*(t.abs() for t in (x, res, z, gy, wx, wy)))
    for name, got, ref, scale in zip(("dx", "dres", "dwx", "dwy", "dbias"), grads, want,
                                     scales):
        if name in ("dx", "dres"):
            assert bf16_check(got, ref, scale, SUM_REL)["within"], name
        else:
            assert _rel_l2(got, ref) <= BF16_REL_L2, name
    again_out, again_z = attention_fuse_fwd(xo, res, wx, wy, bias)
    assert torch.equal(out, again_out) and torch.equal(z, again_z)
    again = attention_fuse_bwd(xo, res, z, go, wx, wy)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_bf16_fuse_autograd_launches_its_kernels(cuda):
    x, res, wx, wy, bias, gy = _bf16(*_fuse_inputs((2, 8, 4, 21, 64), 5, cuda))
    ins = [t.requires_grad_(True) for t in (x, res, wx, wy, bias)]
    before = (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16)
    attention_fuse(*ins).backward(gy)
    torch.cuda.synchronize()
    assert (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert all(t.grad.dtype == torch.bfloat16 for t in ins)
    assert tuple(ins[4].grad.shape) == (2,)


def _bf16_block(kw, gxf, gout):
    """The block's inputs as the bf16 path hands them over: the maps and
    w1a, wxt, wy, w2 in bf16, bvec and zoff float32."""
    return ({n: t if t is None or n in ("bvec", "zoff") else t.to(torch.bfloat16)
             for n, t in kw.items()}, *_bf16(gxf, gout))


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_bf16_block_kernels_match_plain(cuda, shape):
    """The bf16 K5f and K5b against their plain bf16 versions on the same
    inputs (the backward on the kernel's own xf): the bf16 maps by
    ``bf16_check`` with ``abf_block_bf16_scales``, the float32 parameter
    gradients by relative L2; every route of both kernels (BLOCK_SHAPES),
    Cs and M off the 4-wide loads; two runs give the same bits."""
    _bf16_block_holds(*_bf16_block(*_block_inputs(shape, sum(shape), cuda)))


def _bf16_block_holds(kw, gxf, gout):
    """The bf16 K5f and K5b on ``kw``'s inputs against their plain bf16
    versions, and a second run's bits against the first's."""
    before = (abf_block_fwd.launches_bf16, abf_block_bwd.launches_bf16)
    xf, out = abf_block_fwd(**kw)
    grads = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    torch.cuda.synchronize()
    assert (abf_block_fwd.launches_bf16, abf_block_bwd.launches_bf16) == (before[0] + 1,
                                                                         before[1] + 1)
    assert xf.dtype == out.dtype == grads[0].dtype == torch.bfloat16
    assert all(g is None or g.dtype == torch.float32 for g in grads[2:])
    scales = abf_block_bf16_scales(**kw, xf=xf, gxf=gxf, gout=gout)
    rxf, _ = abf_block_reference(**kw)
    assert bf16_check(xf, rxf, *scales["xf"])["within"]
    # the conv on the kernel's own xf: out isolates the conv from xf's roundings
    assert bf16_check(out, conv3x3_reference(xf, kw["w2"]), *scales["out"])["within"]
    want = abf_block_bwd_reference(**kw, xf=xf, gxf=gxf, gout=gout)
    for name, got, ref in zip(BLOCK_GRADS, grads, want):
        if ref is None:
            assert got is None, name
            continue
        assert got.shape == ref.shape, name
        if name in ("g_tap", "g_res"):
            assert bf16_check(got, ref, *scales[name])["within"], name
        else:
            tol = BF16_ROUNDED_REL_L2 if name in ("dw1a", "dwxt", "dwy") else BF16_REL_L2
            assert _rel_l2(got, ref) <= tol, name
    xf_again, out_again = abf_block_fwd(**kw)
    assert torch.equal(xf, xf_again) and torch.equal(out, out_again)  # the same bits
    again = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("shape", BF16_FUSED_SHAPES, ids=str)
def test_bf16_block_fused_route_matches_plain(cuda, shape):
    """Route "fused" at each step shape and the ragged ones: both kernels
    take it (by shape, as their route functions state) and hold to their
    plain versions with the tolerances above, the same bits twice."""
    fuse, B, D, k, T, Cs, M, O = shape
    assert abf_block_fwd_route(M, O, torch.bfloat16, Cs=Cs, D=D, k=k, fuse=fuse) == "fused"
    assert abf_block_bwd_route(M, O, torch.bfloat16, Cs=Cs, D=D, k=k, fuse=fuse) == "fused"
    _bf16_block_holds(*_bf16_block(*_block_inputs(shape, sum(shape), cuda)))
    assert (abf_block_fwd.route, abf_block_bwd.route) == ("fused", "fused")


@pytest.mark.parametrize("shape, route", [((True, 2, 8, 2, 70, 16, 64, 64), "wgmma"),
                                          ((True, 2, 32, 2, 100, 2, 64, 2), "direct")], ids=str)
def test_bf16_block_unaligned_takes_the_old_route(cuda, shape, route):
    """A map one element into its buffer (not on 16 bytes, which TMA needs)
    takes the earlier routes (the maps copied onto 16 bytes): "wgmma" at
    M = O = 64, "direct" at the mask block's widths; it holds the same; the
    aligned call of the same shape takes route "fused"."""
    kw, gxf, gout = _bf16_block(*_block_inputs(shape, 11, cuda))
    buf = torch.empty(kw["tap"].numel() + 1, device=cuda, dtype=torch.bfloat16)
    tap = buf[1:].view(kw["tap"].shape)
    tap.copy_(kw["tap"])
    assert tap.data_ptr() % 16 != 0
    _bf16_block_holds(dict(kw, tap=tap), gxf, gout)
    assert (abf_block_fwd.route, abf_block_bwd.route) == (route, route)
    _bf16_block_holds(kw, gxf, gout)
    assert (abf_block_fwd.route, abf_block_bwd.route) == ("fused", "fused")


def test_bf16_block_autograd_launches_its_kernels(cuda):
    """``abf_block`` on bf16 launches the bf16 K5f and K5b and nothing else,
    and returns each gradient in its input's dtype, as the JAX VJP casts."""
    kw, gxf, gout = _bf16_block(*_block_inputs((True, 2, 8, 2, 40, 16, 64, 32), 7, cuda))
    ins = {n: t.requires_grad_(True) for n, t in kw.items()}
    wrappers = (abf_block_fwd, abf_block_bwd, conv3x3_fwd, conv3x3_wgrad, attention_fuse_fwd,
                attention_fuse_bwd)
    count = lambda: [getattr(fn, a) for fn in wrappers for a in ("launches", "launches_bf16")]
    before = count()
    xf, out = abf_block(**ins)
    (torch.vdot(xf.float().flatten(), gxf.float().flatten())
     + torch.vdot(out.float().flatten(), gout.float().flatten())).backward()
    torch.cuda.synchronize()
    after = count()
    assert [b - a for a, b in zip(before, after)] == [0, 1, 0, 1] + [0] * 8
    for n, t in ins.items():
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape, n


# (M, O, fwd route, bwd route, shape of the block or None): route "fused"
# for the step's shapes (Cs, D, k, fuse given), the mask block included; off
# it (Cs 12, k 3, O 4 with Cs 2, M 6, D 12 at the mask block's widths, an
# unaligned map) the earlier routes by M and O
@pytest.mark.parametrize("M, O, fwd_route, bwd_route, block",
                         [(64, 256, "wgmma", "wgmma", None), (64, 8, "wgmma", "wgmma", None),
                          (64, 4, "direct", "direct", None), (64, 2, "direct", "direct", None),
                          (8, 16, "wgmma", "wgmma", None), (7, 16, "direct", "direct", None),
                          (3, 20, "direct", "direct", None), (12, 16, "mma", "mma", None),
                          (64, 20, "mma", "mma", None),
                          (64, 256, "fused", "fused", dict(Cs=64, D=4, k=1, fuse=False)),
                          (64, 128, "fused", "fused", dict(Cs=32, D=32, k=2, fuse=True)),
                          (64, 64, "fused", "fused", dict(Cs=16, D=64, k=2, fuse=True)),
                          (64, 32, "fused", "fused", dict(Cs=8, D=128, k=2, fuse=True)),
                          (64, 2, "fused", "fused", dict(Cs=2, D=256, k=2, fuse=True)),
                          (64, 64, "fused", "fused", dict(Cs=16, D=64, k=4, fuse=True)),
                          (64, 64, "wgmma", "wgmma", dict(Cs=12, D=64, k=2, fuse=True)),
                          (64, 64, "wgmma", "wgmma", dict(Cs=16, D=63, k=3, fuse=True)),
                          (64, 4, "direct", "direct", dict(Cs=2, D=256, k=2, fuse=True)),
                          (6, 16, "direct", "direct", dict(Cs=16, D=64, k=2, fuse=True)),
                          (64, 2, "direct", "direct", dict(Cs=2, D=12, k=2, fuse=True)),
                          (64, 64, "wgmma", "wgmma", dict(Cs=16, D=64, k=2, fuse=True,
                                                          aligned=False))])
def test_bf16_block_route_by_shape(cuda, M, O, fwd_route, bwd_route, block):
    block = block or {}
    assert (abf_block_fwd_route(M, O, torch.bfloat16, **block),
            abf_block_bwd_route(M, O, torch.bfloat16, **block)) == (fwd_route, bwd_route)
