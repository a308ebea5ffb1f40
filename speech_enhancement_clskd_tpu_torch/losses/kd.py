"""Knowledge-distillation losses: SPKD Gram similarity.

Port of ``speech_enhancement_clskd_tpu/losses/kd.py``, the parts the CLSKD
step uses.  SPKD (similarity-preserving KD): the per-batch Gram matrix of the
flattened activations, row-L1-normalized; the loss is the squared Frobenius
difference between the student's and the teacher's.

Grams are float32 matmuls (batched over slices of the map, ``_grams``), as
they are outside any kernel in the JAX package's default path.  The JAX package sends 2-D inputs with D >= 2^19
on a TPU to its fused Gram kernel (K2, ``ops/pallas/gram.py``); that kernel
is not ported yet, so such a call on a CUDA tensor raises (ROADMAP section 2).
``spkd_loss_affine`` and ``hcl`` belong to non-default options and
strategies and are not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import torch

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


def _norm_l1(g: torch.Tensor) -> torch.Tensor:
    """Rows divided by max(||row||_1, 1e-12) (torch F.normalize(g, 1))."""
    return g / torch.clamp(g.abs().sum(dim=-1, keepdim=True), min=1e-12)


def _gram_l1(z: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """Row-L1-normalized Gram matrix of z flattened to [B, D]."""
    return _norm_l1(_gram(z, batch_axis))


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
    return _norm_l1(_grams(z, batch_axis, groups))


def spkd_loss(
    student: torch.Tensor,
    teacher: torch.Tensor,
    reduction: str = "batchmean",
    batch_axis: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """||G_t - G_s||_F^2, with ``reduction="batchmean"`` divided by B^2.

    ``batch_axis``: which axis is the Gram batch (1 for [T, B, F] LSTM taps).
    ``groups``: split the batch into G contiguous groups and average the
    per-group Gram losses (G=1 is the reference's single global Gram)."""
    d_s = student.numel() // student.shape[batch_axis]
    d_t = teacher.numel() // teacher.shape[batch_axis]
    if (groups == 1 and student.is_cuda and batch_axis == 0 and student.ndim == 2
            and teacher.ndim == 2 and min(d_s, d_t) >= _PALLAS_MIN_D
            and student.shape[0] == teacher.shape[0]):
        raise NotImplementedError(
            "SPKD on 2-D inputs with D >= 2^19 runs the fused Gram kernel K2 "
            "(ops/pallas/gram.py), not ported yet: ROADMAP section 2")
    g_s = _grouped_gram_l1(student, batch_axis, groups)
    g_t = _grouped_gram_l1(teacher, batch_axis, groups)
    loss = torch.sum((g_t - g_s) ** 2)
    if reduction == "batchmean":
        b_local = teacher.shape[batch_axis] // groups
        return loss / (groups * b_local ** 2)
    return loss
