"""The hand-written CUDA kernel of the fused SPKD Gram pair (K2,
``kernels/csrc/gram_pair_fwd.cu``) against its plain PyTorch version, on the
card.  Skipped where there is no CUDA device.

Imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_gram_kernel.py -q
"""

import pytest
import torch

from speech_enhancement_clskd_tpu_torch.kernels import gram

pytestmark = pytest.mark.cuda

# f32 FMA on the card, f32 matmuls per chunk in the plain version, the same
# chunks added in the same order: held to 1e-6 of the largest |G| element
GRAM_RTOL = 1e-6
# the backward is torch.matmul on both sides; gradients by relative L2 error
GRAD_REL_L2 = 1e-5

# (B, Ds, Dt): the spkd step's 33 s waveforms at batch 16, the 3 s waveforms
# at batch 32, a ragged tail (2^19 + 1), Ds != Dt with lengths that rule out
# float4 loads, B = 2, B not a multiple of 4, and the largest batch
SHAPES = [(16, 528000, 528000), (32, 48000, 48000), (4, (1 << 19) + 1, (1 << 19) + 1),
          (8, 100003, 64000), (2, 528000, 528000), (7, 5000, 2049), (gram.MAX_BATCH, 20000, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, ds, dt, dev, seed=0):
    g = torch.Generator().manual_seed(seed + B)
    return (0.3 * torch.randn(B, ds, generator=g)).to(dev), torch.randn(B, dt, generator=g).to(dev)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape):
    s, t = _inputs(*shape, cuda)
    before = gram.gram_pair_fwd.launches
    gs, gt = gram.gram_pair_fwd(s, t)
    again = gram.gram_pair_fwd(s, t)
    torch.cuda.synchronize()
    assert gram.gram_pair_fwd.launches == before + 2
    for got, rep, want in zip((gs, gt), again, gram.gram_pair_reference(s, t)):
        assert torch.equal(got, rep)  # the same bits every run
        assert torch.equal(got, got.T)  # exactly symmetric
        err = (got - want).abs().max().item()
        assert err <= GRAM_RTOL * want.abs().max().item(), (err, want.abs().max().item())


def test_unaligned_view(cuda):
    """A row-contiguous view that starts off a 16-byte boundary takes the
    scalar loads."""
    s, t = _inputs(5, 4097, 4096, cuda)
    s_view = s.reshape(-1)[1:1 + 5 * 4096].reshape(5, 4096)
    got = gram.gram_pair_fwd(s_view, t)
    want = gram.gram_pair_reference(s_view, t)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= GRAM_RTOL * b.abs().max().item()


def test_autograd_matches_cpu(cuda):
    s, t = _inputs(6, 70000, 50000, torch.device("cpu"))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        st, tt = s.to(dev).requires_grad_(True), t.to(dev).requires_grad_(True)
        gram.spkd_loss_fused(st, tt).backward()
        grads.append((st.grad.cpu(), tt.grad.cpu()))
    for got, want in zip(*grads):
        assert ((got - want).norm() / want.norm()).item() <= GRAD_REL_L2


def test_kernel_refuses_bad_inputs(cuda):
    s, t = _inputs(4, 1000, 1000, cuda)
    with pytest.raises(TypeError, match="float32"):
        gram.gram_pair_fwd(s.double(), t)
    with pytest.raises(ValueError, match="expected cuda"):
        gram.gram_pair_fwd(s, t.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_pair_fwd(s[:, ::2], t)
    with pytest.raises(ValueError, match="rows"):
        gram.gram_pair_fwd(s[:1], t[:1])
    big = torch.zeros(gram.MAX_BATCH + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        gram.gram_pair_fwd(big, big)
