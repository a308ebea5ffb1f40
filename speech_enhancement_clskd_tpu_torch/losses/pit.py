"""Permutation-invariant training (PIT) utilities.

Port of ``speech_enhancement_clskd_tpu/losses/pit.py``: the behavioural
equivalent of asteroid ``PITLossWrapper(pairwise_neg_sisdr,
pit_from='pw_mtx')`` used by the reference's validation/eval loops
(reference distill.py:56-57,164-166 and eval.py:25-27,67) to reorder the
estimated sources before metrics.

The permutation search is exhaustive over the (tiny) ``n_src!``
permutations and batched on the device: no host round trip.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, Tuple

import torch


def pairwise_neg_si_sdr(est: torch.Tensor, ref: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """[..., n_est, n_ref] matrix of -SI-SDR(ref_j, est_i).

    ``est``/``ref``: [..., n_src, T].  Matches asteroid's
    ``pairwise_neg_sisdr`` (zero-mean first, scale projection onto ref).
    """
    est = est - torch.mean(est, dim=-1, keepdim=True)
    ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    dots = torch.einsum("...it,...jt->...ij", est, ref)  # [..., n_est, n_ref]
    ref_energy = torch.sum(ref**2, dim=-1)[..., None, :] + eps
    scale = dots / ref_energy
    # projection of est_i onto ref_j: scale_ij * ref_j
    proj = scale[..., None] * ref[..., None, :, :]  # [..., n_est, n_ref, T]
    noise = est[..., :, None, :] - proj
    ratio = torch.sum(proj**2, dim=-1) / (torch.sum(noise**2, dim=-1) + eps)
    return -10.0 * torch.log10(ratio + eps)


def pit_from_pw_mtx(pw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min mean loss, best permutation index array) from a pairwise loss
    matrix [..., n_src, n_src].

    Returns (loss [...], perm [..., n_src]) where ``est[perm[k]]`` matches
    ``ref[k]`` — asteroid ``find_best_perm`` semantics.
    """
    n_src = pw.shape[-1]
    perms = list(permutations(range(n_src)))
    perm_arr = torch.tensor(perms, device=pw.device)  # [P, n_src]
    losses = torch.stack(
        [torch.mean(torch.stack([pw[..., p[k], k] for k in range(n_src)], dim=-1), dim=-1)
         for p in perms],
        dim=-1,
    )  # [..., P]
    best = torch.argmin(losses, dim=-1)  # the first of equal losses, as jnp.argmin
    return torch.take_along_dim(losses, best[..., None], -1)[..., 0], perm_arr[best]


def pit_reorder(
    est: torch.Tensor,
    ref: torch.Tensor,
    pairwise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = pairwise_neg_si_sdr,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder ``est`` sources to best match ``ref`` (PIT).

    est/ref: [..., n_src, T].  Returns (est_reordered, min_loss[...]) —
    the reference's ``loss_func(est_sources, sources, return_est=True)``
    (eval.py:67).
    """
    pw = pairwise_fn(est, ref)
    loss, perm = pit_from_pw_mtx(pw)  # perm: [..., n_src]
    reordered = torch.take_along_dim(est, perm[..., None], dim=-2)
    return reordered, loss


def pit_si_sdr_loss(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Scalar PIT loss (mean over batch of min-perm -SI-SDR) — the
    reference's validation ``loss_func(est, sources)`` (distill.py:164)."""
    loss, _ = pit_from_pw_mtx(pairwise_neg_si_sdr(est, ref))
    return torch.mean(loss)
