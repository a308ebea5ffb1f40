"""Complex-valued conv layers as single real convolutions, the complex dense
layer, and real BN, PReLU and per-part complex PReLU.

Port of ``speech_enhancement_clskd_tpu/ops/complex_layers.py``.  A complex
conv is ONE real convolution over a block weight::

        [xr xi] * [[Wr  Wi]
                   [-Wi Wr]]  =  [xr*Wr - xi*Wi,  xr*Wi + xi*Wr]

Public tensors are channels-last ``[B, D(freq), T(time), 2C]`` with the first
C channels real and the last C imaginary, as in the JAX package.  Inside a
conv the tensor is viewed as NCHW (``permute``, no copy: the view has
channels-last strides, which cuDNN takes as they are).

Parameters are float32.  A layer computes in its input's dtype: under
bf16 compute the convs cast their weights and biases to bf16 (cuDNN runs the
bf16 convolution, accumulating in float32), PReLU its slope, and BatchNorm
keeps its statistics and their update in float32 and normalizes in bf16, as
the JAX layers do.

Weights are stored in ``torch.nn.functional`` layouts: ``[O, I, kh, kw]`` for
``ComplexConv2d``, ``[I, O, kh, kw]`` for ``ComplexConvTranspose2d``
(``utils.bridge`` maps them from flax HWIO).  Every module draws its initial
values from an explicit ``torch.Generator`` in ``reset_parameters``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def split_complex(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[dim] // 2
    return x.narrow(dim, 0, c), x.narrow(dim, c, c)


def complex_cat(xs: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Concatenate packed-complex tensors keeping all real parts first."""
    parts = [split_complex(x, dim) for x in xs]
    return torch.cat([re for re, _ in parts] + [im for _, im in parts], dim=dim)


def _block_weight(wr: torch.Tensor, wi: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Real block weight implementing complex multiplication.

    ``transposed=False``: ``[O, I, kh, kw]`` pair -> ``[2O, 2I, kh, kw]``.
    ``transposed=True``: ``[I, O, kh, kw]`` pair -> ``[2I, 2O, kh, kw]``.
    Input rows (re, im) map to output columns (re, im) as [[Wr, Wi], [-Wi, Wr]].
    """
    if transposed:  # dim 0 = input, dim 1 = output
        return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)
    return torch.cat([torch.cat([wr, -wi], 1), torch.cat([wi, wr], 1)], 0)


class _ComplexConvBase(nn.Module):
    """``use_bias=False`` has no ``br``/``bi`` (the flax tree has none)."""

    def __init__(self, weight_shape: Tuple[int, ...], c_out: int, use_bias: bool = True):
        super().__init__()
        self.wr = nn.Parameter(torch.empty(weight_shape))
        self.wi = nn.Parameter(torch.empty(weight_shape))
        self.use_bias = use_bias
        if use_bias:
            self.br = nn.Parameter(torch.zeros(c_out))
            self.bi = nn.Parameter(torch.zeros(c_out))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """normal(std=0.05) weights and zero bias (reference init)."""
        self.wr.normal_(0.0, 0.05, generator=generator)
        self.wi.normal_(0.0, 0.05, generator=generator)
        if self.use_bias:
            self.br.zero_()
            self.bi.zero_()

    def _bias(self, dtype: torch.dtype) -> Optional[torch.Tensor]:
        return torch.cat([self.br, self.bi]).to(dtype) if self.use_bias else None


class ComplexConv2d(_ComplexConvBase):
    """Complex conv over [B, D, T, in_features] -> [B, D', T', features].

    ``in_features``/``features`` count the full packed width (real+imag).
    The freq axis is padded by ``padding[0]`` on both sides; the time axis
    by ``padding[1]`` on the left only (``causal=True``, the DCCRN family) or
    on both sides (``causal=False``, the asteroid DCCRNet family, which also
    has ``use_bias=False``).
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (5, 2),
        strides: Tuple[int, int] = (2, 1),
        padding: Tuple[int, int] = (2, 1),
        causal: bool = True,
        use_bias: bool = True,
    ):
        kh, kw = kernel_size
        super().__init__((features // 2, in_features // 2, kh, kw), features // 2, use_bias)
        self.strides = tuple(strides)
        self.padding = tuple(padding)
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pf, pt = self.padding
        xn = x.permute(0, 3, 1, 2)  # [B, C, D, T]
        if self.causal:
            xn, pt = F.pad(xn, (pt, 0)), 0  # causal time pad
        y = F.conv2d(xn, _block_weight(self.wr, self.wi, False).to(x.dtype),
                     self._bias(x.dtype), stride=self.strides, padding=(pf, pt))
        return y.permute(0, 2, 3, 1)


class ComplexConvTranspose2d(_ComplexConvBase):
    """Complex transpose conv with torch ConvTranspose2d geometry.

    ``time_crop_left`` drops the first output time steps.  The JAX package
    folds that crop into the left pad of a conv with lhs dilation and a
    flipped kernel (pads ``k-1-p-crop`` / ``k-1-p+output_padding``); here
    ``conv_transpose2d`` computes the uncropped map and the crop is a slice
    (a view).  Exact only while the time stride is 1.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (5, 2),
        strides: Tuple[int, int] = (2, 1),
        padding: Tuple[int, int] = (2, 0),
        output_padding: Tuple[int, int] = (1, 0),
        time_crop_left: int = 0,
        use_bias: bool = True,
    ):
        kh, kw = kernel_size
        super().__init__((in_features // 2, features // 2, kh, kw), features // 2, use_bias)
        if time_crop_left and strides[1] != 1:
            raise ValueError("time_crop_left requires time stride 1")
        self.strides = tuple(strides)
        self.padding = tuple(padding)
        self.output_padding = tuple(output_padding)
        self.time_crop_left = time_crop_left

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2),
            _block_weight(self.wr, self.wi, True).to(x.dtype),
            self._bias(x.dtype),
            stride=self.strides,
            padding=self.padding,
            output_padding=self.output_padding,
        )
        return y[..., self.time_crop_left:].permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Single-alpha PReLU (torch nn.PReLU() default: one shared slope)."""

    def __init__(self, init_alpha: float = 0.25):
        super().__init__()
        self.init_alpha = init_alpha
        self.alpha = nn.Parameter(torch.full((1,), init_alpha))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.alpha.fill_(self.init_alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class CPReLU(nn.Module):
    """Per-part PReLU on packed complex input: slope ``alpha_r`` on the real
    half, ``alpha_i`` on the imaginary half (the asteroid DCCRNet family)."""

    def __init__(self, init_alpha: float = 0.25):
        super().__init__()
        self.init_alpha = init_alpha
        self.alpha_r = nn.Parameter(torch.full((1,), init_alpha))
        self.alpha_i = nn.Parameter(torch.full((1,), init_alpha))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.alpha_r.fill_(self.init_alpha)
        self.alpha_i.fill_(self.init_alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        re, im = split_complex(x)
        re = torch.where(re >= 0, re, self.alpha_r.to(x.dtype) * re)
        im = torch.where(im >= 0, im, self.alpha_i.to(x.dtype) * im)
        return torch.cat([re, im], dim=-1)


class ComplexDense(nn.Module):
    """Complex linear on packed input [..., 2F] -> [..., 2 * features]:
    ``(Wr + i Wi)(xr + i xi)`` with ``wr``/``wi`` ``[F, features]`` (flax
    layout), uniform +-1/sqrt(F) init as torch ``nn.Linear``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.in_features = in_features
        self.wr = nn.Parameter(torch.empty(in_features, features))
        self.wi = nn.Parameter(torch.empty(in_features, features))
        self.br = nn.Parameter(torch.empty(features))
        self.bi = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / self.in_features ** 0.5
        for p in self.parameters():
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xr, xi = split_complex(x)
        wr, wi = self.wr.to(x.dtype), self.wi.to(x.dtype)
        yr = xr @ wr - xi @ wi + self.br.to(x.dtype)
        yi = xr @ wi + xi @ wr + self.bi.to(x.dtype)
        return torch.cat([yr, yi], dim=-1)


class BatchNorm(nn.Module):
    """Real batchnorm over the last (packed channel) axis: momentum 0.1,
    eps 1e-5, biased batch variance for normalizing, running statistics
    updated with the unbiased variance.

    Written out by hand rather than ``nn.BatchNorm2d`` so that every mode
    follows the JAX package exactly.  ``use_batch_stats`` says which
    statistics normalize, ``training`` alone whether the running statistics
    update (as in the JAX module):

    - ``training=False`` (the serving default): running statistics;
    - ``training=True``: per-batch statistics, E[x^2] - E[x]^2 in float32, and
      the running statistics move by ``(1 - m) * running + m * batch``;
    - ``use_batch_stats=True, training=False``: per-batch statistics with the
      running statistics left as they are (the reference's eval quirk of
      never calling ``model.eval()``, and the frozen teacher of a training
      step).

    ``return_affine=True`` returns the float32 per-channel ``(a, b)`` with
    ``normalize(x) == x * a + b`` instead of the normalized map, so a caller
    can fold it into its next contraction.  ``moments=(mean, var, n)`` gives
    the batch statistics from the caller (``var`` biased, ``n`` the element
    count behind it, as ``batch_moments`` returns them); ``x`` may then be
    None.  ``update_running(mean, var, n)`` is the running-statistics update
    alone, for a caller that normalizes with ``training=False,
    use_batch_stats=True`` and moves the statistics itself (the ABF blocks
    under recomputation, ``distill.abf``).
    """

    MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(
        self,
        x: Optional[torch.Tensor],
        training: bool = False,
        use_batch_stats: Optional[bool] = None,
        return_affine: bool = False,
        moments: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
    ):
        if use_batch_stats is None:
            use_batch_stats = training
        if use_batch_stats:
            mean, var, n = moments if moments is not None else batch_moments(x)
            mean, var = mean.float(), var.float()
            if training:
                self.update_running(mean, var, n)
        else:
            mean, var = self.mean, self.var
        if return_affine:
            a = torch.rsqrt(var.float() + self.eps) * self.scale.float()
            return a, self.bias.float() - mean.float() * a
        dt = x.dtype  # normalize in the input's dtype, as the JAX module does
        # rsqrt taken in float32 and rounded once (torch's bf16 rsqrt on the
        # CPU is not correctly rounded; XLA's is)
        inv = torch.rsqrt((var.to(dt) + self.eps).float()).to(dt)
        return (x - mean.to(dt)) * inv * self.scale.to(dt) + self.bias.to(dt)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """running <- (1 - m) running + m batch, the variance made unbiased."""
        m = self.MOMENTUM
        unbiased = var.float() * (n / max(n - 1, 1))
        self.mean.copy_((1 - m) * self.mean + m * mean.to(self.mean.dtype))
        self.var.copy_((1 - m) * self.var + m * unbiased.to(self.var.dtype))


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """float32 per-channel batch mean and biased variance (E[x^2] - E[x]^2)
    of a [..., C] map over all leading axes, and the element count a channel."""
    dims = tuple(range(x.ndim - 1))
    xf = x.float()
    mean = xf.mean(dim=dims)
    return mean, xf.square().mean(dim=dims) - mean.square(), x.numel() // x.shape[-1]
