"""The hand-written CUDA kernels of the fused SPKD Gram pair (K2,
``kernels/csrc/gram_pair_fwd.cu`` in float32, ``kernels/csrc/gram_pair_bf16.cu``
on bf16 inputs) against their plain PyTorch version, on the card.  Skipped
where there is no CUDA device.

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

# (B, Ds, Dt): the spkd step's 33 s waveforms at batch 16 and at the largest
# batch, the 3 s waveforms at batch 32, a ragged tail (2^19 + 1), Ds != Dt
# with one side on the bulk copies (D % 4 == 0) and the other not, B = 2, B
# not a multiple of 4 or 8 (3, 5, 7), the largest batch on 3 columns, and D
# one column past and one short of a stage's width (512 columns to B = 32,
# 256 above), 4 columns past on the bulk copies, and more chunks than the
# second pass stages at a time (320 chunks, 655,360 columns) on both sides
SHAPES = [(16, 528000, 528000), (gram.MAX_BATCH, 528000, 528000), (32, 48000, 48000),
          (4, (1 << 19) + 1, (1 << 19) + 1), (8, 100003, 64000), (3, 528000, 48001),
          (2, 528000, 528000), (7, 5000, 2049), (gram.MAX_BATCH, 20000, 3),
          (5, 513, 511), (24, 513, 511), (40, 257, 255), (24, 516, 508),
          (6, 1400000, 655361)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_every_chunk_has_its_own_slot(cuda, dtype):
    """Each chunk's columns scaled by its own factor, so every chunk's partial
    differs; run twice on two such inputs, a chunk that wrote another's slot
    or none would leave a stale or lost partial in the second result (bf16:
    the inputs rounded after scaling, the Grams held by relative L2)."""
    D = 528000
    for seed, base in ((1, 1.0), (2, 3.0)):
        s, t = _inputs(32, D, D, cuda, seed=seed)
        scale = (base + torch.arange(D, device=cuda) // gram.CHUNK % 7).float() / 8
        s, t = (s * scale).to(dtype), (t * scale.flip(0)).to(dtype)
        gs, gt = gram.gram_pair_fwd(s, t)
        want = gram.gram_pair_reference(s, t)
        for got, ref in zip((gs, gt), want):
            if dtype == torch.float32:
                err = (got - ref).abs().max().item()
                assert err <= GRAM_RTOL * ref.abs().max().item(), (seed, err)
            else:
                assert ((got - ref).norm() / ref.norm()).item() <= BF16_REL_L2, seed
        del gs, gt  # the second call may take the first one's memory


def test_unaligned_view(cuda):
    """A row-contiguous view that starts off a 16-byte boundary takes the
    4-byte cp.async copies instead of the bulk copies."""
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
    with pytest.raises(TypeError, match="float32"):
        gram.gram_pair_fwd(s.bfloat16(), t)  # one dtype for both
    with pytest.raises(ValueError, match="expected cuda"):
        gram.gram_pair_fwd(s, t.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_pair_fwd(s[:, ::2], t)
    with pytest.raises(ValueError, match="rows"):
        gram.gram_pair_fwd(s[:1], t[:1])
    big = torch.zeros(gram.MAX_BATCH + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        gram.gram_pair_fwd(big, big)


# bf16 inputs: the products exact in float32 on both sides (the tensor
# cores' bf16 products, float32 accumulators), the same chunks added in the
# same order; the Grams float32, held by relative L2.  The diagonal (sums of
# squares, all positive, of values with 8 significant bits) parted by up to
# 3.7e-6 of the largest element in the first design: the kernel lay 7.8e-7 of
# it from the float64 Gram, the plain version (cuBLAS float32 per chunk)
# 3.5e-6 (B = 32, D = 528,000; NVIDIA H100 80GB HBM3, 700 W); relative L2
# 3.1e-6.  The tensor-core design lies 1.35e-6 from float64, relative L2
# 2.3e-6
BF16_REL_L2 = 1e-5
# (B, Ds, Dt): every plan of the kernel (B <= 16, 32, 48, 64 rows: 16-row
# blocks) at its edges (2, 5, 8, 16, 17, 32, 33, 64); the spkd step's 33 s
# waveforms; D of one column, of 7 (padded to 8), one chunk (2048), one
# column past it (2049, padded to 2056: a last stage of 8 columns in a box
# the map fills with zeros), two chunks and one (4097); Ds != Dt; a stage's
# width +- a column (257, 511, 513, 1023, 1025)
BF16_SHAPES = [(32, 528000, 528000), (gram.MAX_BATCH, 528000, 528000), (16, 528000, 528000),
               (4, (1 << 19) + 1, 2049), (8, 100003, 64000), (5, 513, 511), (40, 257, 255),
               (24, 520, 504), (2, 7, 9), (2, 1, 2048), (5, 4097, 7), (8, 2049, 1),
               (16, 1025, 1023), (17, 4097, 2048), (32, 2049, 4097), (33, 7, 2049),
               (33, 528000, 48001), (gram.MAX_BATCH, 1, 4097), (gram.MAX_BATCH, 2049, 2048)]


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_kernel_matches_plain(cuda, shape):
    """The bf16 K2 on rows of whole 16-byte units (D a multiple of 8) and on
    others (the wrapper pads them with zero columns), against the plain
    version on the same bf16 inputs: two runs' bits, exact symmetry, one
    bf16 launch a call."""
    s, t = (z.to(torch.bfloat16) for z in _inputs(*shape, cuda))
    before = (gram.gram_pair_fwd.launches, gram.gram_pair_fwd.launches_bf16)
    gs, gt = gram.gram_pair_fwd(s, t)
    again = gram.gram_pair_fwd(s, t)
    torch.cuda.synchronize()
    assert (gram.gram_pair_fwd.launches, gram.gram_pair_fwd.launches_bf16) == (
        before[0], before[1] + 2)
    assert gs.dtype == gt.dtype == torch.float32
    for got, rep, want in zip((gs, gt), again, gram.gram_pair_reference(s, t)):
        assert torch.equal(got, rep) and torch.equal(got, got.T)
        assert ((got - want).norm() / want.norm()).item() <= BF16_REL_L2


@pytest.mark.parametrize("shape", [(5, 4096, 1), (33, 2049, 3), (gram.MAX_BATCH, 4104, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_unaligned_view(cuda, shape):
    """A bf16 view that starts ``offset`` elements (2 bytes each) into its
    buffer, off a 16-byte boundary: the wrapper copies it into an aligned
    buffer first (the kernel's C entry refuses it), and the Grams, bits and
    launches are as for an aligned input."""
    B, D, offset = shape
    s, t = (z.to(torch.bfloat16) for z in _inputs(B, D + 8, D, cuda))
    s_view = s.reshape(-1)[offset:offset + B * D].reshape(B, D)
    assert s_view.data_ptr() % 16 != 0 and s_view.is_contiguous()
    before = gram.gram_pair_fwd.launches_bf16
    got = gram.gram_pair_fwd(s_view, t)
    again = gram.gram_pair_fwd(s_view, t)
    torch.cuda.synchronize()
    assert gram.gram_pair_fwd.launches_bf16 == before + 2
    for a, rep, b in zip(got, again, gram.gram_pair_reference(s_view, t)):
        assert torch.equal(a, rep) and torch.equal(a, a.T)
        assert ((a - b).norm() / b.norm()).item() <= BF16_REL_L2
    # the C entry takes rows of whole 16-byte units on 16-byte bases alone
    kernel = gram._library()[torch.bfloat16]
    out = torch.empty(2 * B * B + 2 * -(-D // gram.CHUNK) * B * (B + 1) // 2, device=cuda)
    err = kernel(s_view.data_ptr(), t.data_ptr(), out.data_ptr(), B, D, D,
                 torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_bf16_autograd_matches_cpu(cuda):
    """The VJP in float32, cast to the inputs' bf16, as the JAX VJP casts."""
    s, t = (z.to(torch.bfloat16) for z in _inputs(6, 70000, 50000, torch.device("cpu")))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        st, tt = s.to(dev).requires_grad_(True), t.to(dev).requires_grad_(True)
        gram.spkd_loss_fused(st, tt).backward()
        assert st.grad.dtype == tt.grad.dtype == torch.bfloat16
        grads.append((st.grad.float().cpu(), tt.grad.float().cpu()))
    for got, want in zip(*grads):
        assert ((got - want).norm() / want.norm()).item() <= 2.0 ** -8
