"""Sequence (time-axis) parallelism for long-utterance inference.

Port of ``speech_enhancement_clskd_tpu/parallel/sequence.py``.  The
waveform's time axis is split over the ranks of a process group: rank r
holds its span ``[B, T / N]`` of a ``[B, T]`` utterance and enhances it with

- a left context halo, the left neighbour's last ``context_frames * hop``
  samples (the causal conv stack and the LSTM warm up over it), and
- a right lookahead halo, the right neighbour's first ``win_len - hop``
  samples (the STFT/iSTFT edge),

zeros at the utterance's ends, then keeps its own span of the offline
forward of that window.  The JAX package fetches the halos with
``ppermute``; the port gathers every rank's two halo slices in one
``all_gather`` (which gloo takes on CUDA tensors too, where its ``send``
and ``recv`` may not).  The conv stack is exact with 12 or more frames of
context; the LSTM re-warms over the context window, so the interior stays
within a fraction of a percent of the offline forward (the JAX test holds
0.02 relative RMS).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import distributed


@torch.no_grad()
def sharded_utterance_forward(model, wav: torch.Tensor,
                              group: Optional[dist.ProcessGroup] = None,
                              context_frames: int = 64) -> torch.Tensor:
    """Enhance this rank's span ``wav`` [B, T / N] of a [B, T] utterance
    split over the ``N`` ranks of ``group`` (the default group where one is
    up, else a world of 1), in rank order; returns the enhanced span.
    ``model`` runs its offline forward with ``training=False`` on the
    span's device.  T must divide by ``N * hop``, else ``ValueError``."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    hop = model.cfg.stft.hop
    guard = model.cfg.stft.win_len - hop
    ctx = context_frames * hop
    n = distributed.world_size(group)
    r = distributed.rank(group)
    B, t_loc = wav.shape
    if (t_loc * n) % (n * hop):
        raise ValueError(f"T={t_loc * n} must be divisible by axis_size*hop={n * hop}")
    tail, head = wav[:, -ctx:], wav[:, :guard]
    if group is None:
        left, right = torch.zeros_like(tail), torch.zeros_like(head)
    else:
        halos = distributed.all_gather(torch.cat([tail, head], dim=1)[None], 0, group)
        left = halos[r - 1, :, :tail.shape[1]] if r > 0 else torch.zeros_like(tail)
        right = halos[r + 1, :, tail.shape[1]:] if r < n - 1 else torch.zeros_like(head)
    window = torch.cat([left, wav, right], dim=1)
    out = model(window, training=False).wav
    return out[:, ctx:ctx + t_loc]
