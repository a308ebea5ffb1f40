"""Complex batch normalization by 2x2 covariance whitening.

Port of ``speech_enhancement_clskd_tpu/ops/complex_bn.py``, the Trabelsi
deep-complex-networks whitening batchnorm of the reference: per complex
channel, subtract the complex mean, multiply by the inverse square root of
the 2x2 covariance ``[[Vrr, Vri], [Vri, Vii]]`` (closed form for a 2x2 SPD
matrix), then apply a learnable 2x2 affine (``Wrr``, ``Wri``, ``Wii``) and a
complex bias (``Br``, ``Bi``).

Input layout: packed complex ``[B, ..., 2C]`` (the first C channels real,
the last C imaginary), the moments taken over every axis but the last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import distributed
from .complex_layers import split_complex


class ComplexBatchNorm(nn.Module):
    """Whitening complex BN of ``features`` complex channels.

    ``training=True`` (or ``track_running_stats=False``) normalizes with
    the batch's mean and biased covariance; ``training=True`` also moves the
    running statistics (buffers ``RMr``, ``RMi``, ``RVrr``, ``RVri``,
    ``RVii``) by ``(1 - m) * running + m * batch``, m = 0.1, before ``eps``
    is added to the variances.  ``training=False`` normalizes with the
    running statistics.  Unlike ``complex_layers.BatchNorm`` there is no
    ``use_batch_stats``: the JAX module follows ``training`` alone, so a
    frozen teacher with complex BN in a distillation step (``training=False,
    bn_batch_stats=True``) normalizes with its running statistics.

    Parameters (``Wrr``, ``Wri``, ``Wii``, ``Br``, ``Bi``) and statistics
    are float32; the normalization runs in the input's dtype, the
    statistics updated from the batch moments cast to float32, as the JAX
    module does.  ``Wri`` is drawn uniform in [-0.9, 0.9] from the
    generator of ``reset_parameters``.

    ``process_group`` (``None``: one process) is the data-parallel group
    whose ranks' rows form the batch: the batch means are then the global
    ones, the ranks' raw sums added by a differentiable all-reduce (the
    centred second moments taken about the global mean, as the JAX module
    takes them over the whole batch: two all-reduces a layer).
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 affine: bool = True, track_running_stats: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = None
        if affine:
            for name in ("Wrr", "Wri", "Wii", "Br", "Bi"):
                self.register_parameter(name, nn.Parameter(torch.empty(features)))
        if track_running_stats:
            for name in ("RMr", "RMi", "RVrr", "RVri", "RVii"):
                self.register_buffer(name, torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.affine:
            self.Wrr.fill_(1.0)
            self.Wri.uniform_(-0.9, 0.9, generator=generator)
            self.Wii.fill_(1.0)
            self.Br.zero_()
            self.Bi.zero_()
        if self.track_running_stats:
            for name, value in (("RMr", 0.0), ("RMi", 0.0), ("RVrr", 1.0), ("RVri", 0.0),
                                ("RVii", 1.0)):
                getattr(self, name).fill_(value)

    def _batch_means(self, terms, axes, n: int):
        """The batch means of ``terms`` over ``axes``: each one's float32
        sum over the rows (over every rank's rows with a ``process_group``,
        one differentiable all-reduce) over the global count ``n``, rounded
        once to the terms' dtype, as ``torch.mean`` rounds."""
        sums = [torch.sum(t, dim=axes, dtype=torch.float32) for t in terms]
        if self.process_group is not None:
            sums = distributed.all_reduce(torch.stack(sums), self.process_group).unbind(0)
        return [(s / n).to(t.dtype) for s, t in zip(sums, terms)]

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        dt = x.dtype
        xr, xi = split_complex(x)
        axes = tuple(range(x.ndim - 1))
        n = xr.numel() // xr.shape[-1] * distributed.world_size(self.process_group)
        use_batch = training or not self.track_running_stats
        if use_batch:
            mr, mi = self._batch_means((xr, xi), axes, n)
        else:
            mr, mi = self.RMr.to(dt), self.RMi.to(dt)
        xr = xr - mr
        xi = xi - mi
        if use_batch:
            vrr, vri, vii = self._batch_means((xr * xr, xr * xi, xi * xi), axes, n)
        else:
            vrr, vri, vii = self.RVrr.to(dt), self.RVri.to(dt), self.RVii.to(dt)
        if training and self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                for name, batch in (("RMr", mr), ("RMi", mi), ("RVrr", vrr), ("RVri", vri),
                                    ("RVii", vii)):
                    run = getattr(self, name)
                    run.copy_(run * (1 - m) + m * batch.float())

        vrr = vrr + self.eps
        vii = vii + self.eps
        # the inverse square root of [[vrr, vri], [vri, vii]] in closed form
        tau = vrr + vii
        delta = vrr * vii - vri * vri
        s = torch.sqrt(delta)
        t = torch.sqrt(tau + 2 * s)
        rst = 1.0 / (s * t)
        urr = (s + vii) * rst
        uii = (s + vrr) * rst
        uri = -vri * rst

        if self.affine:
            wrr, wri, wii = self.Wrr.to(dt), self.Wri.to(dt), self.Wii.to(dt)
            zrr = wrr * urr + wri * uri
            zri = wrr * uri + wri * uii
            zir = wri * urr + wii * uri
            zii = wri * uri + wii * uii
        else:
            zrr, zri, zir, zii = urr, uri, uri, uii

        yr = zrr * xr + zri * xi
        yi = zir * xr + zii * xi
        if self.affine:
            yr = yr + self.Br.to(dt)
            yi = yi + self.Bi.to(dt)
        return torch.cat([yr, yi], dim=-1)
