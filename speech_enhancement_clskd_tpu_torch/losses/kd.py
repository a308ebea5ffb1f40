"""Knowledge-distillation losses: SPKD Gram similarity.

Port of ``speech_enhancement_clskd_tpu/losses/kd.py``, the parts the
``clskd`` and ``spkd`` strategies use.  SPKD (similarity-preserving KD): the
per-batch Gram matrix of the flattened activations, row-L1-normalized; the
loss is the squared Frobenius difference between the student's and the
teacher's.

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

``spkd_loss_affine`` and ``hcl`` belong to non-default options and to the
``reviewkd`` strategy and are not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

import torch

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
    b_total = z.shape[batch_axis]
    if groups < 1 or b_total % groups:
        raise ValueError(f"batch {b_total} not divisible into {groups} groups")
    if b_total // groups < 2:
        # a Gram over one utterance normalizes to 1 whatever the input: the
        # loss would be zero, silently
        raise ValueError(
            f"batch {b_total} in {groups} groups leaves {b_total // groups} per group; "
            "SPKD needs at least 2")
    return norm_l1(_grams(z, batch_axis, groups))


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
            return spkd_loss_fused(student.float(), teacher.float(), reduction)
    g_s = _grouped_gram_l1(student, batch_axis, groups)
    g_t = _grouped_gram_l1(teacher, batch_axis, groups)
    loss = torch.sum((g_t - g_s) ** 2)
    if reduction == "batchmean":
        b_local = teacher.shape[batch_axis] // groups
        return loss / (groups * b_local ** 2)
    return loss
