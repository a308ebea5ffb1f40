"""Attention-based fusion (ABF) + ReviewKD cross-layer feature chain.

Port of ``speech_enhancement_clskd_tpu/distill/abf.py``: its default path,
the opt-in kernel paths of ``conv_pallas`` (the 3x3 conv through
``kernels.conv3x3``, K3f/K3w), ``attfuse_pallas`` (the attention fuse
through ``kernels.attfuse``, K4f/K4b) and ``block_pallas`` (the whole block
but bn2 through ``kernels.abf_block``, K5f/K5b), and the options
``conv_ninedot`` (the 3x3 conv as nine shifted matmuls), ``bn2_affine_out``
(bn2's affine returned, not applied) and ``remat`` (each block recomputed in
the backward).  Each ABF block takes one student tap ``[B, D, T, C_in]``:

    x1   = tap @ W1                      (1x1 conv, bias-free)
    xhat = bn1(x1)                       (batch moments derived from the tap)
    xf   = sigmoid-attention blend of xhat with the residual of the previous
           block, resized to this tap's geometry (all blocks but the first)
    out  = bn2(conv3x3(xf))              (teacher channel count)

and passes ``xf`` on as the next block's residual.  Processing starts from
the deepest (smallest freq) map; outputs come back in tap-list order, so they
zip 1:1 with the teacher taps.

As in the JAX package, bn1's batch moments come from the tap's channel
moments (``_bn1_moments_from_tap``), and the 1x1 conv and bn1's affine are
folded into the attention contraction, so the mid-channel map x1 is never
formed on its own.  The attention-fuse kernel path, as in JAX, hands the
normalized map ``(tap @ W1) * a + b`` to the kernel with the raw attention
weights and bias.  Parameters keep the flax layouts (``conv1.kernel``
``[1, 1, I, O]``, ``att_conv.kernel`` ``[1, 1, 2C, 2]`` + ``bias``) except the
3x3 kernel, which is ``[O, I, 3, 3]`` for ``F.conv2d`` (``utils.bridge``
permutes it; the conv kernel's wrapper makes its own HWIO copy).

A chain computes in its taps' dtype, as the JAX chain does: under bf16 taps
the contractions and the blend run in bf16 with the float32 parameters cast
to bf16 at each use, bn1's moments and the folded affines stay float32, BN
normalizes in bf16 on float32 statistics, and the kernel paths take the bf16
instantiations of K3, K4 and K5 (the whole block's operands cast as the JAX
block casts them: ``ABF._block``).

Under ``remat`` each block runs inside ``torch.utils.checkpoint``, so its
forward runs again in the backward, the kernels' forwards with it (K5f twice
a block a step, and likewise K3f and K4f).  The port's BatchNorm moves its
running statistics in its forward, and a recomputed forward would move them
twice, where JAX's functional remat moves them once.  So a block's
checkpointed part (``ABF.run``) normalizes on batch statistics without
moving them and returns them, and the running statistics move outside the
checkpoint (``ABF.update_running``), once a step.

Under data parallelism (bn1's and bn2's ``process_group``, set by the
trainer) bn1's tap moments and bn2's moments are those of the global batch:
the ranks' raw sums are added by a differentiable all-reduce before the
division, so the K5 kernel gets bn1 folded from the global moments.  Under
``remat`` the recomputed forward repeats those all-reduces in the backward,
in the same order on every rank.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.abf_block import abf_block, abf_block_dispatchable
from ..kernels.attfuse import attention_fuse, attfuse_dispatchable
from ..kernels.conv3x3 import conv3x3
from ..ops.complex_layers import BatchNorm, batch_moments
from ..parallel import distributed

# flax's truncated_normal initializers divide the stddev by the stddev of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _kaiming_uniform_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax ``kaiming_uniform``: U(-b, b), b = sqrt(6 / fan_in)."""
    bound = math.sqrt(6.0 / fan_in)
    t.uniform_(-bound, bound, generator=generator)


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax ``lecun_normal``: a normal truncated at two deviations, scaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _nearest_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """Torch-exact nearest resize along one axis: out[i] = in[floor(i*n_in/n_out)]
    (``F.interpolate`` mode='nearest').  An integer upscale is a repeat, a
    downscale by one element a crop (floor(i*(n+1)/n) == i for i < n); other
    sizes gather, among them the DCCRNet family's residuals, one frame
    shorter than the next tap (index 0 twice, so its gradient row is the sum
    of the first two)."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    if n_out % n_in == 0:
        return torch.repeat_interleave(x, n_out // n_in, dim=axis)
    if n_in - n_out == 1:
        return x.narrow(axis, 0, n_out)
    idx = torch.arange(n_out, device=x.device) * n_in // n_out
    return x.index_select(axis, idx)


def _resize_freq(x: torch.Tensor, d_out: int, t_out: Optional[int] = None) -> torch.Tensor:
    """Nearest resize of the freq (and, when given, time) axis of [B, D, T, C]."""
    t_out = x.shape[2] if t_out is None else t_out
    return _nearest_axis(_nearest_axis(x, 1, d_out), 2, t_out)


def _channel_moments(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """float32 per-channel first moment [C] and second-moment matrix [C, C]
    of a [..., C] map, over all leading axes.  With a data-parallel
    ``group`` the ranks' raw sums are added first (one differentiable
    all-reduce) and ``n`` is the global count."""
    xf = x.float().reshape(-1, x.shape[-1])
    c, n = xf.shape[1], xf.shape[0]
    s1, s2 = xf.sum(dim=0), xf.T @ xf
    if group is not None:
        sums = distributed.all_reduce(torch.cat([s1, s2.reshape(-1)]), group)
        s1, s2 = sums[:c], sums[c:].view(c, c)
        n *= distributed.world_size(group)
    return s1 / n, s2 / n, n


def _bn1_moments_from_tap(tap: torch.Tensor, w1: torch.Tensor, group=None):
    """Batch-norm moments of ``x1 = tap @ w1`` without forming x1:
    mean = m1 @ w1 and E[x1^2]_m = (w1^T E[tap tap^T] w1)_mm (over the
    ranks of ``group``, ``_channel_moments``)."""
    m1, m2, n = _channel_moments(tap, group)
    w1f = w1.float()
    mean = m1 @ w1f
    e2 = ((m2 @ w1f) * w1f).sum(dim=0)
    return mean, e2 - mean.square(), n


class _Kernel(nn.Module):
    """A bare ``kernel`` parameter (the 1x1 conv of an ABF block)."""

    def __init__(self, shape: Tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))


class AttentionFuse(nn.Module):
    """2-way sigmoid attention fusion of a map with the propagated residual:
    resize the residual to the map's geometry, ``z = sigmoid(att_conv(
    concat(xhat, y)))``, blend ``xhat*z0 + y*z1``.

    ``x`` is the RAW tap; the normalized map is ``xhat = (x @ w_in) * a + b``
    with the 1x1 conv ``w_in`` [C_in, C] and bn1's affine ``(a, b)`` folded
    in.  The attention logit of the map is one tap-level contraction
    ``x @ (w_in @ (a * wx))``; the residual's is contracted at its small size
    and only the 2-channel logits are resized.

    ``use_kernel``: where the geometry passes ``attfuse_dispatchable``, form
    ``xhat`` and fuse through ``kernels.attfuse.attention_fuse`` (K4f/K4b)
    with the raw ``wx``, ``wy`` and bias instead.
    """

    def __init__(self, channels: int, use_kernel: bool = False):
        super().__init__()
        self.channels = channels
        self.use_kernel = use_kernel
        self.kernel = nn.Parameter(torch.empty(1, 1, 2 * channels, 2))
        self.bias = nn.Parameter(torch.zeros(2))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.kernel, 2 * self.channels, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, res: torch.Tensor,
                affine: Tuple[torch.Tensor, torch.Tensor], w_in: torch.Tensor) -> torch.Tensor:
        c, dt = self.channels, x.dtype
        wx, wy = self.kernel[0, 0, :c], self.kernel[0, 0, c:]
        a, b0 = affine  # float32
        xhat = torch.matmul(x, w_in.to(dt)) * a.to(dt) + b0.to(dt)
        if self.use_kernel and attfuse_dispatchable(xhat.shape, res.shape):
            return attention_fuse(xhat, res.to(dt), wx.to(dt), wy.to(dt), self.bias.to(dt))
        z_off = (b0 @ wx + self.bias).to(dt)
        wx_eff = (w_in.float() @ (a[:, None] * wx)).to(dt)  # [C_in, 2]
        y_small = _nearest_axis(res, 2, x.shape[2]).to(dt)
        zx = torch.matmul(x, wx_eff)
        zy = _nearest_axis(torch.matmul(y_small, wy.to(dt)), 1, x.shape[1])
        z = torch.sigmoid((zx + zy + z_off).float()).to(dt)  # rounded once, as XLA's
        y = _nearest_axis(y_small, 1, x.shape[1])
        return xhat * z[..., 0:1] + y * z[..., 1:2]


def _conv3x3_ninedot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of x [B, D, T, C] with w [O, C, 3, 3] as nine shifted
    [B, D, T, C] x [C, O] matmuls, summed in float32 whatever the input
    dtype (the JAX ``_conv3x3_ninedot`` sums in the input's dtype), and
    returned in x's dtype."""
    b, d, t, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    out = None
    for di in range(3):
        for dj in range(3):
            y = torch.matmul(xp[:, di:di + d, dj:dj + t], wf[:, :, di, dj].T)
            out = y if out is None else out + y
    return out.to(x.dtype)


class Conv3x3(nn.Module):
    """Bias-free 3x3 SAME conv over [B, D, T, C]: ``F.conv2d`` on the NCHW
    view, as the JAX default path leaves it to XLA's conv; with
    ``use_kernel`` ``kernels.conv3x3.conv3x3`` (K3f/K3w); else with
    ``use_ninedot`` ``_conv3x3_ninedot``."""

    def __init__(self, in_channels: int, features: int, use_kernel: bool = False,
                 use_ninedot: bool = False):
        super().__init__()
        self.use_kernel = use_kernel
        self.use_ninedot = use_ninedot
        self.kernel = nn.Parameter(torch.empty(features, in_channels, 3, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_uniform_(self.kernel, 9 * self.kernel.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if self.use_kernel:
            return conv3x3(x, w)
        if self.use_ninedot:
            return _conv3x3_ninedot(x, w)
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


class ABF(nn.Module):
    """One fusion block: 1x1 conv -> bn1, optional attention fusion with the
    propagated residual, 3x3 conv -> bn2.  Returns ``(out, xf)``: the block's
    output (teacher channels) and the fused map passed on as residual.
    ``conv_pallas`` and ``attfuse_pallas`` take the 3x3 conv and the fuse
    through their kernels, and ``block_pallas`` everything but bn2 through
    the whole-block kernel where ``abf_block_dispatchable`` takes the
    geometry (the JAX flag names; a block the gate refuses takes the per-op
    path under the other two).  ``conv_ninedot``: the per-op path's 3x3 conv
    as nine matmuls (``conv_pallas`` first, as in JAX).  ``bn2_affine_out``:
    ``out`` is ``(raw conv2 map, a, b)`` with bn2's float32 affine, bn2's
    running statistics moved all the same."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int, fuse: bool,
                 conv_pallas: bool = False, attfuse_pallas: bool = False,
                 block_pallas: bool = False, conv_ninedot: bool = False,
                 bn2_affine_out: bool = False):
        super().__init__()
        self.mid_channels, self.out_channels = mid_channels, out_channels
        self.block_pallas = block_pallas
        self.bn2_affine_out = bn2_affine_out
        self.conv1 = _Kernel((1, 1, in_channels, mid_channels))
        self.bn1 = BatchNorm(mid_channels)
        self.att_conv = AttentionFuse(mid_channels, attfuse_pallas) if fuse else None
        self.conv2 = Conv3x3(mid_channels, out_channels, conv_pallas, conv_ninedot)
        self.bn2 = BatchNorm(out_channels)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_uniform_(self.conv1.kernel, self.conv1.kernel.shape[2], generator)
        self.bn1.reset_parameters(generator)
        if self.att_conv is not None:
            self.att_conv.reset_parameters(generator)
        self.conv2.reset_parameters(generator)
        self.bn2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                training: bool = True):
        out, xf, moments = self.run(x, residual, training)
        self.update_running(moments)
        return out, xf

    def run(self, x: torch.Tensor, residual: Optional[torch.Tensor], training: bool):
        """The block with bn1 and bn2 on batch statistics (``training``) or
        running ones, the running statistics left as they are: ``(out, xf,
        moments)``, ``moments`` bn1's and bn2's ``(mean, var, n)`` under
        ``training``, else None."""
        w1 = self.conv1.kernel[0, 0]
        m1 = _bn1_moments_from_tap(x, w1, self.bn1.process_group) if training else None
        aff = self.bn1(None, use_batch_stats=training, return_affine=True, moments=m1)
        fuse = self.att_conv is not None and residual is not None
        if self.block_pallas and abf_block_dispatchable(
                x.shape, residual.shape if fuse else None, self.mid_channels,
                self.out_channels):
            raw, xf = self._block(x, residual if fuse else None, w1, aff)
        else:
            if fuse:
                xf = self.att_conv(x, residual, aff, w1)
            else:
                a, b0 = aff
                xf = torch.matmul(x, w1.to(x.dtype)) * a.to(x.dtype) + b0.to(x.dtype)
            raw = self.conv2(xf)
        m2 = batch_moments(raw, self.bn2.process_group) if training else None
        if self.bn2_affine_out:
            out = (raw,) + self.bn2(None, use_batch_stats=training, return_affine=True,
                                    moments=m2)
        else:
            out = self.bn2(raw, use_batch_stats=training, moments=m2)
        return out, xf, (m1, m2) if training else None

    def update_running(self, moments) -> None:
        """Move bn1's and bn2's running statistics by ``run``'s moments."""
        if moments is not None:
            for bn, (mean, var, n) in zip((self.bn1, self.bn2), moments):
                bn.update_running(mean.detach(), var.detach(), n)

    def _block(self, x, residual, w1, aff):
        """``(raw conv2 output, xf)`` through ``kernels.abf_block``, with the
        kernel's folded weights formed here, in autograd, so the gradients
        reach conv1, bn1, att_conv and conv2: ``w1a = w1 * a``, ``wxt = w1a @
        wx``, ``zoff = b @ wx + att bias`` and conv2's kernel as HWIO.  As the
        JAX block does, the residual, ``w1a``, ``wxt``, ``wy`` and the HWIO
        kernel are cast to the tap's dtype (``wxt`` formed in float32 first),
        and ``bvec = b`` and ``zoff`` stay float32; the gradients reach the
        float32 parameters through the casts."""
        dt = x.dtype
        a, b0 = aff
        w1a = w1 * a
        w2 = self.conv2.kernel.permute(2, 3, 1, 0).to(dt).contiguous()
        if residual is None:
            xf, out = abf_block(x.contiguous(), None, w1a.to(dt), b0, None, None, None, w2)
            return out, xf
        c = self.mid_channels
        att = self.att_conv.kernel[0, 0]
        wx, wy = att[:c], att[c:]
        xf, out = abf_block(x.contiguous(), residual.to(dt).contiguous(), w1a.to(dt), b0,
                            (w1a @ wx).to(dt), wy.to(dt).contiguous(),
                            b0 @ wx + self.att_conv.bias, w2)
        return out, xf


class ReviewKD(nn.Module):
    """A chain of ABF blocks over a tap list.

    ``in_channels[i]``/``out_channels[i]`` are the student's and the
    teacher's channel counts of tap i (tap-list order).  ``reverse=True`` for
    encoder taps (the list runs shallow -> deep, so processing starts from
    its end); decoder tap lists already lead with the deepest map.  Block
    ``abf{i}`` is the i-th in processing order.  ``conv_pallas``,
    ``attfuse_pallas``, ``block_pallas``, ``conv_ninedot`` and
    ``bn2_affine_out`` go to every block (``ABF``).  ``remat``: each block
    runs under ``torch.utils.checkpoint`` (non-reentrant) while gradients
    are recorded, its running statistics moved outside it.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 mid_channels: int, reverse: bool = True, conv_pallas: bool = False,
                 attfuse_pallas: bool = False, block_pallas: bool = False,
                 conv_ninedot: bool = False, bn2_affine_out: bool = False,
                 remat: bool = False):
        super().__init__()
        if len(in_channels) != len(out_channels):
            raise ValueError("in_channels and out_channels differ in length")
        self.reverse = reverse
        self.remat = remat
        ins = list(in_channels[::-1] if reverse else in_channels)
        outs = list(out_channels[::-1] if reverse else out_channels)
        self.blocks = len(ins)
        for i, (c_in, c_out) in enumerate(zip(ins, outs)):
            self.add_module(f"abf{i}", ABF(c_in, mid_channels, c_out, fuse=i > 0,
                                           conv_pallas=conv_pallas,
                                           attfuse_pallas=attfuse_pallas,
                                           block_pallas=block_pallas,
                                           conv_ninedot=conv_ninedot,
                                           bn2_affine_out=bn2_affine_out))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.blocks):
            getattr(self, f"abf{i}").reset_parameters(generator)

    def forward(self, feats: Sequence[torch.Tensor], training: bool = True) -> List[torch.Tensor]:
        xs = list(feats[::-1] if self.reverse else feats)
        results: List[torch.Tensor] = []
        res = None
        remat = self.remat and torch.is_grad_enabled()
        for i, f in enumerate(xs):
            block = getattr(self, f"abf{i}")
            if remat:
                out, res, moments = checkpoint(block.run, f, res, training, use_reentrant=False)
            else:
                out, res, moments = block.run(f, res, training)
            block.update_running(moments)
            results.append(out)
        return results[::-1] if self.reverse else results
