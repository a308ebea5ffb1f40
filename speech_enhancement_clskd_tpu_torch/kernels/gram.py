"""The SPKD Gram pair ``(S S^T, T T^T)``: a hand-written Hopper kernel and
its plain PyTorch version.

Replaces ``speech_enhancement_clskd_tpu/ops/pallas/gram.py``:
``_gram_pair_kernel`` (K2, via ``_gram_pair_raw``), reached through
``gram_pair`` and ``spkd_loss_pallas``.

- ``gram_pair(s, t)``: ``[B, *]`` inputs flattened to ``[B, Ds]`` and
  ``[B, Dt]`` (Ds may differ from Dt) give the two ``[B, B]`` Grams in
  float32, differentiable in both.  The backward is ``dZ = (dG + dG^T) Z``,
  two skinny matrix products in float32 left to ``torch.matmul``, as the JAX
  VJP leaves them to XLA, each returned in its input's dtype.
- ``gram_pair_fwd(s2, t2)`` is the kernel's wrapper.  On CUDA tensors it
  launches the kernel of ``csrc/gram_pair_fwd.cu`` (float32) or of
  ``csrc/gram_pair_bf16.cu`` (bfloat16), built at first use, or raises;
  nothing falls back.  On CPU tensors it runs ``gram_pair_reference``.  Its
  ``launches`` counter counts float32 kernel launches only, ``launches_bf16``
  the bf16 kernel's.  One allocation a call holds ``gs``, ``gt`` (returned as
  views) and the kernel's partials; a bf16 view off 16 bytes, or with D not a
  multiple of 8, is first copied into a zero-padded buffer (``bulk_ready``).
- ``gram_pair_reference`` sums the Grams of the same ``CHUNK``-column chunks
  the kernel splits D into, in the same order, one matrix product per chunk,
  so the card and the CPU agree to ~1e-7 of the largest element at the
  strategy's D ~ 528,000.
- ``gram_pair_dispatchable`` is the JAX auto gate (``losses/kd.py``) on
  shapes, without its device condition, plus ``B <= MAX_BATCH``.
- ``spkd_loss_fused`` is the SPKD loss on ``gram_pair``
  (``spkd_loss_pallas``).

The inputs are float32 or bfloat16 (both of one dtype), the Grams float32.
The float32 kernel sums in f32 FMA, not TF32; the bf16 kernel (the Pallas
kernel on bf16 operands: bf16 products, exact in float32, summed in
float32) takes its products on the tensor cores (``mma.sync`` m16n8k16 with
float32 accumulators).  The plain version widens bf16 to float32 and sums
the same chunks in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build, check_tensors, float_dtype, on16, widened

SOURCE = "gram_pair_fwd.cu"
BF16_SOURCE = "gram_pair_bf16.cu"
SOURCES = (SOURCE, BF16_SOURCE)
# columns of each chunk whose partial the kernel's first pass writes (the
# Pallas kernel's D tile); the number of chunks depends only on D
CHUNK = 2048
# rows the kernel takes (the JAX gate's batches, and eight row blocks of 8)
MAX_BATCH = 64


def gram_pair_dispatchable(s_shape: Sequence[int], t_shape: Sequence[int], batch_axis: int = 0,
                           groups: int = 1, *, min_d: int) -> bool:
    """The JAX auto gate (``kd.py:135-142``) on shapes: one global Gram over
    2-D ``[B, D]`` inputs with batch axis 0, equal B and both D >= ``min_d``;
    and the kernel's batch, ``2 <= B <= MAX_BATCH``."""
    return (groups == 1 and batch_axis == 0 and len(s_shape) == 2 and len(t_shape) == 2
            and s_shape[0] == t_shape[0] and 2 <= s_shape[0] <= MAX_BATCH
            and min(s_shape[1], t_shape[1]) >= min_d)


def _chunked_gram(z: torch.Tensor) -> torch.Tensor:
    B, D = z.shape
    full = D // CHUNK
    g = z.new_zeros(B, B)
    if full:
        zc = z[:, :full * CHUNK].reshape(B, full, CHUNK).transpose(0, 1)
        for part in torch.matmul(zc, zc.transpose(1, 2)):  # [full, B, B], added in order
            g = g + part
    if D % CHUNK:
        tail = z[:, full * CHUNK:]
        g = g + tail @ tail.T
    return g


def gram_pair_reference(s2: torch.Tensor, t2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: ``(s2 s2^T, t2 t2^T)`` in float32 (bf16 inputs widened),
    each the sum over ``CHUNK``-column chunks, in chunk order, of the chunk's
    product."""
    return _chunked_gram(widened(s2)), _chunked_gram(widened(t2))


def _check(s2: torch.Tensor, t2: torch.Tensor) -> None:
    if s2.ndim != 2 or t2.ndim != 2 or s2.shape[0] != t2.shape[0]:
        raise ValueError(f"s2 and t2 must be [B, Ds] and [B, Dt], got {tuple(s2.shape)} "
                         f"and {tuple(t2.shape)}")
    B = s2.shape[0]
    if not 2 <= B <= MAX_BATCH:
        raise ValueError(f"the Gram pair takes 2 <= B <= {MAX_BATCH} rows, got {B}")
    if s2.shape[1] < 1 or t2.shape[1] < 1:
        raise ValueError(f"empty rows: {tuple(s2.shape)}, {tuple(t2.shape)}")
    check_tensors((("s2", s2), ("t2", t2)), s2.device, "gram_pair",
                  float_dtype(s2, "gram_pair"))


@functools.lru_cache(maxsize=None)
def _library() -> dict:
    """The two kernels' C entries by input dtype, both sources built at
    once (one ``nvcc`` each) and loaded."""
    _build.build_all(SOURCES)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries = {}
    for dtype, source, name in ((torch.float32, SOURCE, "gram_pair_fwd"),
                                (torch.bfloat16, BF16_SOURCE, "gram_pair_fwd_bf16")):
        lib = _build.load(source)
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 3 + [i32, i64, i64, ptr]
        fn.restype = i32
        for const in ("gram_pair_chunk_cols", "gram_pair_max_batch"):
            getattr(lib, const).argtypes = []
            getattr(lib, const).restype = i32
        built = (lib.gram_pair_chunk_cols(), lib.gram_pair_max_batch())
        if built != (CHUNK, MAX_BATCH):
            raise RuntimeError(f"{source} has (chunk, max batch) {built}, the wrapper "
                               f"{(CHUNK, MAX_BATCH)}")
        entries[dtype] = fn
    return entries


def bulk_ready(z: torch.Tensor) -> torch.Tensor:
    """``z`` ([B, D] bf16), or a copy of it zero-padded to ``[B, round_up(D,
    8)]`` on a 16-byte base where its rows are not whole 16-byte units or it
    starts off 16 bytes (the bf16 kernel's TMA maps take neither).  The added
    columns are zero: the Grams and the chunks (``CHUNK`` is a multiple of 8)
    stay the same."""
    B, D = z.shape
    if D % 8 == 0 and on16(z):
        return z
    padded = z.new_zeros(B, -(-D // 8) * 8)
    padded[:, :D] = z
    return padded


def gram_pair_fwd(s2: torch.Tensor, t2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s2 s2^T, t2 t2^T)`` in float32 for ``[B, Ds]`` and ``[B, Dt]``
    (float32 or bfloat16): the K2 kernel on CUDA tensors (counted in
    ``gram_pair_fwd.launches``, the bf16 kernel in
    ``gram_pair_fwd.launches_bf16``; partial Grams per chunk, added in chunk
    order, so repeated runs give the same bits and the output is exactly
    symmetric), ``gram_pair_reference`` on CPU tensors."""
    _check(s2, t2)
    if s2.device.type == "cpu":
        return gram_pair_reference(s2, t2)
    B, ds = s2.shape
    dt = t2.shape[1]
    kernel = _library()[s2.dtype]
    # gs, gt, then each chunk's packed upper triangle, in one allocation
    partial = (-(-ds // CHUNK) + -(-dt // CHUNK)) * (B * (B + 1) // 2)
    out = torch.empty(2 + -(-partial // (B * B)), B, B, device=s2.device, dtype=torch.float32)
    bf16 = s2.dtype == torch.bfloat16
    if bf16:
        s2, t2 = bulk_ready(s2), bulk_ready(t2)
    with torch.cuda.device(s2.device):
        err = kernel(s2.data_ptr(), t2.data_ptr(), out.data_ptr(), B, s2.shape[1], t2.shape[1],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_pair_fwd launch failed ({s2.dtype}): CUDA error {err}")
    if bf16:
        gram_pair_fwd.launches_bf16 += 1
    else:
        gram_pair_fwd.launches += 1
    return out[0], out[1]


gram_pair_fwd.launches = 0
gram_pair_fwd.launches_bf16 = 0


class _GramPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s2, t2):
        ctx.save_for_backward(s2, t2)
        return gram_pair_fwd(s2, t2)

    @staticmethod
    @once_differentiable
    def backward(ctx, dgs, dgt):
        s2, t2 = ctx.saved_tensors
        # G = Z Z^T  =>  dZ = (dG + dG^T) Z, in float32, cast to Z's dtype
        ds = ((dgs + dgs.T) @ widened(s2)).to(s2.dtype) if ctx.needs_input_grad[0] else None
        dt = ((dgt + dgt.T) @ widened(t2)).to(t2.dtype) if ctx.needs_input_grad[1] else None
        return ds, dt


def gram_pair(s: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S S^T, T T^T)`` in float32 for ``[B, *]`` inputs flattened to
    ``[B, D]``; differentiable in both."""
    B = s.shape[0]
    if t.shape[0] != B:
        raise ValueError(f"s and t must have the same batch, got {s.shape[0]} and {t.shape[0]}")
    return _GramPair.apply(s.reshape(B, -1).contiguous(), t.reshape(B, -1).contiguous())


def norm_l1(g: torch.Tensor) -> torch.Tensor:
    """Rows divided by max(||row||_1, 1e-12) (torch F.normalize(g, 1))."""
    return g / torch.clamp(g.abs().sum(dim=-1, keepdim=True), min=1e-12)


def spkd_loss_fused(student: torch.Tensor, teacher: torch.Tensor,
                    reduction: str = "batchmean") -> torch.Tensor:
    """The SPKD loss on ``gram_pair``: ``||N(G_t) - N(G_s)||_F^2`` with rows
    L1-normalized, divided by B^2 for ``reduction="batchmean"``."""
    gs, gt = gram_pair(student, teacher)
    loss = torch.sum((norm_l1(gt) - norm_l1(gs)) ** 2)
    if reduction == "batchmean":
        return loss / teacher.shape[0] ** 2
    return loss
