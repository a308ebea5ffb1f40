"""Knowledge-distillation losses: SPKD Gram similarity and HCL.

Port of ``speech_enhancement_clskd_tpu/losses/kd.py``.  SPKD
(similarity-preserving KD): the per-batch Gram matrix of the flattened
activations, row-L1-normalized; the loss is the squared Frobenius difference
between the student's and the teacher's.  HCL (hierarchical context loss,
the ``reviewkd`` strategy): the MSE of two maps plus the MSEs of their
adaptive-average-pooled pyramids.

Two routes, chosen as the JAX ``spkd_loss`` chooses them (``use_pallas``):

- 2-D ``[B, D]`` inputs with batch axis 0, one global Gram (``groups=1``),
  equal B and D >= 2^19 (``_PALLAS_MIN_D``; the JAX gate, set by a TPU
  crossover) take the fused Gram pair ``kernels/gram.py::gram_pair``: the
  hand-written kernel K2 on CUDA tensors, its plain version on CPU tensors,
  so both devices take the same route.  The ``spkd`` strategy's waveforms
  reach it from clips of 32.8 s at 16 kHz.  The port's gate adds the
  kernel's ``2 <= B <= MAX_BATCH``.
- Everything else, the ``clskd`` strategy's 4-D and ``[T, B, F]`` taps
  among it, takes float32 matmuls batched over slices of the map
  (``_grams``), as it runs outside any kernel in the JAX package.

``spkd_loss_affine`` (``distill.spkd_bn2_fold``) takes the ABF's raw conv2
map and bn2's per-channel affine and folds the affine into per-channel
Grams, summed slice by slice as ``_grams`` sums.

bf16 taps (``distill.taps_dtype``): the Grams and HCL's terms are summed in
float32 from the upcast taps (a bf16 product is exact in float32, as in the
JAX ``dot_general(..., preferred_element_type=float32)``), and every loss is
float32.  The fused Gram pair takes bf16 inputs as float32 ones (its bf16
instantiation) and returns float32 Grams.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.gram import gram_pair_dispatchable, norm_l1, spkd_loss_fused

# the JAX package's gate for the fused Gram kernel: 2-D inputs, D >= 2^19
_PALLAS_MIN_D = 1 << 19


# least elements each slice's product contracts (see _grams)
_SLICE_MIN = 256


def _grams(z: torch.Tensor, batch_axis: int, groups: int) -> torch.Tensor:
    """[groups, b, b] Grams of z, the batch axis split into ``groups``
    contiguous groups of b = B / groups, contracting every other axis.

    A map of 3 or more axes is contracted slice by slice: the innermost axes
    in memory (at least ``_SLICE_MIN`` elements, e.g. time of a channels-last
    conv map, features of a [T, B, F] LSTM tap) form each slice, the outer
    ones index the slices, and the slices' [b, b] products, one batched
    matmul, are summed.  The batched product reads z as it lies in memory,
    with no relayout copy, and a float32 sum over one slice rather than over
    all of D keeps the Gram's rounding near 1e-7: at the step's full width D
    reaches ~2e7 per row, where one float32 product over D is off by ~1e-5
    and the SPKD loss, a small difference of two such Grams, by ~1e-4."""
    z = z.float()
    b = z.shape[batch_axis] // groups
    if z.ndim < 3:
        zf = z.movedim(batch_axis, 0).reshape(groups, b, -1)
        return torch.matmul(zf, zf.transpose(1, 2))
    others = sorted((a for a in range(z.ndim) if a != batch_axis), key=z.stride, reverse=True)
    k, inner = len(others), 1
    while k > 1 and inner < _SLICE_MIN:
        k -= 1
        inner *= z.shape[others[k]]
    zs = z.permute(others[:k] + [batch_axis] + others[k:]).reshape(-1, groups, b, inner)
    return torch.matmul(zs, zs.transpose(-1, -2)).sum(0)


def _gram(z: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """[B, B] Gram matrix of z treated as [B, D] (D = all non-batch axes)."""
    return _grams(z, batch_axis, 1)[0]


def _gram_l1(z: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """Row-L1-normalized Gram matrix of z flattened to [B, D]."""
    return norm_l1(_gram(z, batch_axis))


def _grouped_gram_l1(z: torch.Tensor, batch_axis: int, groups: int) -> torch.Tensor:
    """[G, b, b] row-L1-normalized Grams of the batch axis split into
    ``groups`` contiguous groups of b = B / groups."""
    _check_groups(z.shape[batch_axis], groups)
    return norm_l1(_grams(z, batch_axis, groups))


def _check_groups(b_total: int, groups: int) -> None:
    if groups < 1 or b_total % groups:
        raise ValueError(f"batch {b_total} not divisible into {groups} groups")
    if b_total // groups < 2:
        # a Gram over one utterance normalizes to 1 whatever the input: the
        # loss would be zero, silently
        raise ValueError(
            f"batch {b_total} in {groups} groups leaves {b_total // groups} per group; "
            "SPKD needs at least 2")


def spkd_loss(
    student: torch.Tensor,
    teacher: torch.Tensor,
    reduction: str = "batchmean",
    use_pallas: Optional[bool] = None,
    batch_axis: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """||G_t - G_s||_F^2, with ``reduction="batchmean"`` divided by B^2.

    ``use_pallas``: ``None`` routes by ``gram_pair_dispatchable`` (the JAX
    auto gate on shapes), ``True`` forces the fused Gram pair
    (``kernels/gram.py``; inputs flattened to ``[B, D]``, batch axis 0 only),
    ``False`` the sliced matmuls.  With ``groups > 1`` the fused pair is
    never taken, as in JAX.
    ``batch_axis``: which axis is the Gram batch (1 for [T, B, F] LSTM taps).
    ``groups``: split the batch into G contiguous groups and average the
    per-group Gram losses (G=1 is the reference's single global Gram)."""
    if groups == 1:
        if use_pallas is None:
            use_pallas = gram_pair_dispatchable(student.shape, teacher.shape, batch_axis,
                                                groups, min_d=_PALLAS_MIN_D)
        if use_pallas:
            if batch_axis != 0:
                raise ValueError(
                    f"the fused Gram pair flattens [B, *] inputs: batch_axis must be 0, "
                    f"got {batch_axis}")
            return spkd_loss_fused(student, teacher, reduction)
    g_s = _grouped_gram_l1(student, batch_axis, groups)
    g_t = _grouped_gram_l1(teacher, batch_axis, groups)
    loss = torch.sum((g_t - g_s) ** 2)
    if reduction == "batchmean":
        b_local = teacher.shape[batch_axis] // groups
        return loss / (groups * b_local ** 2)
    return loss


def _channel_grams(y: torch.Tensor) -> torch.Tensor:
    """[C, B, B] per-channel Grams of a channels-last map y [B, ..., C],
    contracting the axes between batch and channel.  As in ``_grams``, the
    innermost of those axes (at least ``_SLICE_MIN`` elements, e.g. time)
    form each slice and the slices' products are summed."""
    y = y.float()
    B, C = y.shape[0], y.shape[-1]
    mid = y.shape[1:-1]
    k, inner = len(mid), 1
    while k > 0 and inner < _SLICE_MIN:
        k -= 1
        inner *= mid[k]
    ys = y.reshape(B, -1, inner, C).permute(1, 3, 0, 2)  # [slices, C, B, inner]
    return torch.matmul(ys, ys.transpose(-1, -2)).sum(0)


def spkd_loss_affine(
    student_raw: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    teacher: torch.Tensor,
    reduction: str = "batchmean",
    groups: int = 1,
) -> torch.Tensor:
    """The SPKD loss of ``xhat = student_raw * a + b`` (a per-channel affine
    over the last axis, bn2's) against ``teacher``, without forming xhat:

        G = sum_c a_c^2 S_c + u 1^T + 1 u^T + m sum_c b_c^2
        S_c[i, j] = sum y[i, ..., c] y[j, ..., c],   u = r (a * b),
        r[i, c] = sum y[i, ..., c],                  m = elements a channel

    ``groups > 1`` forms xhat and takes ``spkd_loss`` without the fused
    Gram pair, as the JAX function does."""
    if groups > 1:
        xhat = student_raw * a.to(student_raw.dtype) + b.to(student_raw.dtype)
        return spkd_loss(xhat, teacher, reduction, use_pallas=False, groups=groups)
    _check_groups(student_raw.shape[0], 1)
    af, bf = a.float(), b.float()
    s_c = _channel_grams(student_raw)  # [C, B, B]
    contract = tuple(range(1, student_raw.ndim - 1))
    r = student_raw.float().sum(dim=contract)  # [B, C]
    m = 1
    for ax in contract:
        m *= student_raw.shape[ax]
    u = r @ (af * bf)  # [B]
    g = (torch.einsum("c,cij->ij", af * af, s_c)
         + u[:, None] + u[None, :] + m * torch.sum(bf * bf))
    loss = torch.sum((_gram_l1(teacher, 0) - norm_l1(g)) ** 2)
    if reduction == "batchmean":
        return loss / (teacher.shape[0] ** 2)
    return loss


def _bins(n: int, out: int, device) -> torch.Tensor:
    """[n, out] averaging weights of torch's adaptive pool along one axis:
    bin i covers [floor(i n / out), ceil((i + 1) n / out)), weight 1 / its
    length."""
    m = torch.zeros(n, out)
    for i in range(out):
        lo, hi = (i * n) // out, -(-((i + 1) * n) // out)
        m[lo:hi, i] = 1.0 / (hi - lo)
    return m.to(device)


def _pool_levels(x: torch.Tensor, levels: Sequence[int]) -> list:
    """x [..., H, W] pooled by torch's adaptive average pool to l x l for
    each l of ``levels``, as two contractions with the bins' weights: W for
    all levels at once (one pass over x, and one in the backward), then H.
    A 4-D map that lies channels-last (a [B, C, D, T] view of a [B, D, T, C]
    map) is contracted as it lies, [T, C] rows of each (b, d), with no
    copy; a pooled map comes back [..., l, l] either way."""
    *_, h, w = x.shape
    pw = torch.cat([_bins(w, lv, x.device) for lv in levels], dim=1)  # [W, sum l]
    channels_last = x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last)
    if channels_last:
        y = torch.matmul(pw.T, x.permute(0, 2, 3, 1))  # [B, H, sum l, C]
    else:
        y = torch.matmul(x, pw)  # [..., H, sum l]
    out, col = [], 0
    for lv in levels:
        ph = _bins(h, lv, x.device)  # [H, l]
        if channels_last:
            out.append(torch.einsum("bhkc,hl->bclk", y[:, :, col:col + lv], ph))
        else:
            out.append(torch.matmul(ph.T, y[..., col:col + lv]))
        col += lv
    return out


def _adaptive_avg_pool2d(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch's adaptive average pool over the last two axes to ``out`` x
    ``out`` (the JAX function's bins), through ``_pool_levels``."""
    return _pool_levels(x, [out])[0]


def hcl(fstudent: Sequence[torch.Tensor], fteacher: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hierarchical context loss, summed over the pairs of maps: for each,
    the MSE, plus the MSEs of both maps pooled to 4x4, 2x2 and 1x1 (torch's
    adaptive average pool over the last two axes, ``_pool_levels``) with
    weights 1/2, 1/4, 1/8, a level skipped where it is not below the map's
    height (``shape[-2]``), all over the summed weights; in float32."""
    total = 0.0
    for fs, ft in zip(fstudent, fteacher):
        fs, ft = fs.float(), ft.float()
        loss = torch.mean((fs - ft) ** 2)
        cnt, tot = 1.0, 1.0
        levels = [lv for lv in (4, 2, 1) if lv < fs.shape[-2]]
        if levels:
            for ps, pt in zip(_pool_levels(fs, levels), _pool_levels(ft, levels)):
                cnt /= 2.0
                loss = loss + torch.mean((ps - pt) ** 2) * cnt
                tot += cnt
        total = total + loss / tot
    return total
