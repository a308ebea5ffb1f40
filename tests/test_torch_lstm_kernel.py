"""The hand-written CUDA LSTM kernels (forward K1f, backward K1b) against
their plain PyTorch versions, on the card.  Skipped where there is no CUDA
device.

Imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_lstm_kernel.py -q
"""

import pytest
import torch

from speech_enhancement_clskd_tpu_torch.kernels.lstm import (
    lstm_seq,
    lstm_seq_bwd,
    lstm_seq_bwd_plan,
    lstm_seq_bwd_reference,
    lstm_seq_fwd_plan,
    lstm_seq_reference,
)

pytestmark = pytest.mark.cuda

# f32 both sides; h @ W_hh summed in another order than cuBLAS.  The
# backward's dW_hh sums T*N products, so it is held relative to its largest
# element (at least 1).
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, N, H, seed, with_state=False):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(T, N, 4 * H, generator=g)
    w_hh = (torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5
    state = (torch.rand(N, H, generator=g) * 2 - 1, torch.randn(N, H, generator=g))
    return xw, w_hh, state if with_state else (None, None)


@pytest.mark.parametrize("H", [32, 128])
@pytest.mark.parametrize("N", [2, 64, 201])
def test_kernel_matches_plain(cuda, H, N):
    T = 483 if N <= 64 else 20
    xw, w_hh, _ = _inputs(T, N, H, seed=H + N)
    xw, w_hh = xw.to(cuda), w_hh.to(cuda)
    before = lstm_seq.launches
    y, c = lstm_seq(xw, w_hh)
    torch.cuda.synchronize()
    assert lstm_seq.launches == before + 1
    ry, rc = lstm_seq_reference(xw, w_hh)
    assert (y - ry).abs().max().item() <= ATOL
    assert (c - rc).abs().max().item() <= ATOL * max(1.0, rc.abs().max().item())


def test_kernel_with_initial_state(cuda):
    xw, w_hh, (h0, c0) = _inputs(118, 6, 32, seed=5, with_state=True)
    args = [t.to(cuda) for t in (xw, w_hh, h0, c0)]
    y, c = lstm_seq(*args)
    ry, rc = lstm_seq_reference(*args)
    torch.cuda.synchronize()
    assert (y - ry).abs().max().item() <= ATOL
    assert (c - rc).abs().max().item() <= ATOL * max(1.0, rc.abs().max().item())


def test_kernel_rejects_too_wide(cuda):
    xw, w_hh, _ = _inputs(4, 2, 320, seed=0)
    with pytest.raises(ValueError, match="4H"):
        lstm_seq(xw.to(cuda), w_hh.to(cuda))


def _backward_case(cuda, T, N, H, seed, with_state=False):
    xw, w_hh, (h0, c0) = _inputs(T, N, H, seed, with_state)
    dy = torch.randn(T, N, H, generator=torch.Generator().manual_seed(seed + 1))
    xw, w_hh, dy = xw.to(cuda), w_hh.to(cuda), dy.to(cuda)
    h0 = None if h0 is None else h0.to(cuda)
    c0 = None if c0 is None else c0.to(cuda)
    y, c = lstm_seq_reference(xw, w_hh, h0, c0)
    before = lstm_seq_bwd.launches
    dxw, dw = lstm_seq_bwd(xw, w_hh, y, c, dy, h0, c0)
    torch.cuda.synchronize()
    assert lstm_seq_bwd.launches == before + 1
    rdxw, rdw = lstm_seq_bwd_reference(xw, w_hh, y, c, dy, h0, c0)
    assert (dxw - rdxw).abs().max().item() <= ATOL
    assert (dw - rdw).abs().max().item() <= ATOL * max(1.0, rdw.abs().max().item())


@pytest.mark.parametrize("H", [32, 128])
@pytest.mark.parametrize("N", [2, 64, 201])
def test_backward_kernel_matches_plain(cuda, H, N):
    _backward_case(cuda, 483 if N <= 64 else 20, N, H, seed=7 * H + N)


def test_backward_kernel_with_initial_state(cuda):
    _backward_case(cuda, 57, 3, 32, seed=11, with_state=True)


def test_autograd_launches_both_kernels(cuda):
    xw, w_hh, _ = _inputs(40, 6, 32, seed=3)
    xw = xw.to(cuda).requires_grad_(True)
    w_hh = w_hh.to(cuda).requires_grad_(True)
    fwd, bwd = lstm_seq.launches, lstm_seq_bwd.launches
    y, _ = lstm_seq(xw, w_hh)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (lstm_seq.launches, lstm_seq_bwd.launches) == (fwd + 1, bwd + 1)
    rdxw, rdw = lstm_seq_bwd_reference(xw.detach(), w_hh.detach(), y.detach(),
                                       lstm_seq_reference(xw.detach(), w_hh.detach())[1],
                                       2 * y.detach())
    assert (xw.grad - rdxw).abs().max().item() <= ATOL
    assert (w_hh.grad - rdw).abs().max().item() <= ATOL * max(1.0, rdw.abs().max().item())


# K1f's plans (T, N, H, initial state): N = 1 and odd N that leave the last
# cluster's row tile ragged, H = 64 and 256 (4H = 1024, the widest; a
# cluster of 8), T = 1, the spkd step's T = 5283 at N = 32 for both widths,
# and an initial state through a cluster
K1F_SHAPES = [(483, 1, 32, False), (483, 1, 128, False), (57, 3, 128, False),
              (40, 67, 32, False), (30, 133, 128, False), (118, 5, 64, False),
              (60, 3, 256, False), (1, 4, 128, False), (1, 2, 32, False),
              (5283, 32, 32, False), (5283, 32, 128, False), (118, 6, 128, True),
              (40, 3, 256, True)]


@pytest.mark.parametrize("shape", K1F_SHAPES, ids=str)
def test_forward_plans_match_plain(cuda, shape):
    T, N, H, with_state = shape
    xw, w_hh, (h0, c0) = _inputs(T, N, H, seed=3 * H + N + T, with_state=with_state)
    args = [None if t is None else t.to(cuda) for t in (xw, w_hh, h0, c0)]
    plan = lstm_seq_fwd_plan(N, H)
    assert 1 <= plan["P"] <= 8 and plan["rows"] in (1, 2, 4)
    before = lstm_seq.launches
    y, c = lstm_seq(*args)
    torch.cuda.synchronize()
    assert lstm_seq.launches == before + 1
    ry, rc = lstm_seq_reference(*args)
    assert (y - ry).abs().max().item() <= ATOL, plan
    assert (c - rc).abs().max().item() <= ATOL * max(1.0, rc.abs().max().item()), plan


@pytest.mark.parametrize("H", [32, 128])
def test_backward_on_the_forward_kernels_outputs(cuda, H):
    """K1b on what K1f wrote (a single CTA at H = 32, a cluster at H = 128)
    matches the plain backward on the plain forward's outputs."""
    xw, w_hh, _ = _inputs(200, 6, H, seed=H)
    xw = xw.to(cuda).requires_grad_(True)
    w_hh = w_hh.to(cuda).requires_grad_(True)
    fwd, bwd = lstm_seq.launches, lstm_seq_bwd.launches
    y, _ = lstm_seq(xw, w_hh)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (lstm_seq.launches, lstm_seq_bwd.launches) == (fwd + 1, bwd + 1)
    ry, rc = lstm_seq_reference(xw.detach(), w_hh.detach())
    rdxw, rdw = lstm_seq_bwd_reference(xw.detach(), w_hh.detach(), ry, rc, 2 * ry)
    assert (xw.grad - rdxw).abs().max().item() <= ATOL
    assert (w_hh.grad - rdw).abs().max().item() <= ATOL * max(1.0, rdw.abs().max().item())


# K1b's plans (T, N, H, initial state): the spkd step's student LSTM on 33 s
# clips at batch 16 and at its card-vs-CPU batch 2, N = 133 (two rows a block
# on a 132-SM card, the last ragged), T = 1, H = 64 and the L2 plan's H = 128
# and 256 (4H = 1024, the widest), and initial states through each plan
K1B_SHAPES = [(5283, 32, 32, False), (5283, 4, 32, False), (40, 133, 32, False),
              (1, 4, 32, False), (118, 5, 64, False), (483, 64, 128, False),
              (20, 201, 128, False), (30, 5, 256, False), (57, 3, 32, True),
              (40, 3, 128, True), (25, 2, 64, True)]


@pytest.mark.parametrize("shape", K1B_SHAPES, ids=str)
def test_backward_plans_match_plain(cuda, shape):
    T, N, H, with_state = shape
    plan = lstm_seq_bwd_plan(H)
    assert plan["WPT"] == (32 if H <= 32 else 64 if H <= 64 else 0), plan
    _backward_case(cuda, T, N, H, seed=5 * H + N + T, with_state=with_state)


@pytest.mark.parametrize("H", [32, 128])
def test_backward_kernel_repeats_bitwise(cuda, H):
    """dxw and dW_hh (fixed-order partials) are the same bits on a second call."""
    xw, w_hh, _ = _inputs(300, 40, H, seed=H + 1)
    dy = torch.randn(300, 40, H, generator=torch.Generator().manual_seed(2)).to(cuda)
    xw, w_hh = xw.to(cuda), w_hh.to(cuda)
    y, c = lstm_seq_reference(xw, w_hh)
    first = lstm_seq_bwd(xw, w_hh, y, c, dy)
    again = lstm_seq_bwd(xw, w_hh, y, c, dy)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
