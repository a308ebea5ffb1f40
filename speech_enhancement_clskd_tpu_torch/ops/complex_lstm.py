"""Complex LSTM bottleneck over the sequence kernel.

Port of ``speech_enhancement_clskd_tpu/ops/complex_lstm.py``.  The
reference's complex LSTM holds two real LSTMs and cross-combines four
invocations::

    out_r = real(xr) - imag(xi)        out_i = imag(xr) + real(xi)

- the four invocations are two, by stacking (xr, xi) on the batch axis: the
  real LSTM on ``[xr; xi]`` gives (r2r, i2r), the imaginary one (r2i, i2i);
- the input projection ``x @ W_ih + (b_ih + b_hh)`` is one matmul over all
  timesteps; the recurrence ``h @ W_hh`` goes through ``kernels.lstm.lstm_seq``
  (the Hopper kernel on CUDA tensors, its plain version on CPU tensors);
- gate order (i, f, g, o) and init (uniform +-1/sqrt(H), separate b_ih/b_hh)
  follow torch nn.LSTM.

Parameters are float32; the layer computes in its input's dtype.  Under
bf16 compute ``xw`` and the output projections are bf16 matmuls with the
weights cast to bf16, and ``lstm_seq`` runs its recurrence in float32 on
the upcast ``xw`` and W_hh and hands ``y`` back in bf16 (the JAX layer's
casts around the Pallas kernel).

``LSTMCell`` and ``Dense`` are the real-LSTM bottleneck of a DCCRN with
``use_clstm=False`` (JAX ``models/dccrn.py:136-142``, flax's
``nn.RNN(nn.LSTMCell)`` and ``nn.Dense``), their modules and leaves named as
flax names them so ``utils.bridge`` maps the trees name for name.  A cell
concatenates its eight flax denses into the ``xw`` and ``W_hh`` of the same
``lstm_seq``, so its recurrence runs on the same kernels.

Tensor parallelism (``ops.complex_layers.TensorParallel``, set up by
``models.dccrn.shard_model``): ``x @ W_ih`` and the output projections are
column-parallel, each rank's columns gathered to the full ``4H`` (``P``)
before the biases are added; ``W_hh`` is gathered whole and the recurrence
runs unsplit on every rank (``lstm_seq``: K1f forward, K1b backward), whose
gradient of the gathered ``W_hh`` is the same on every rank, each keeping
its slice.  Splitting the gate columns of the recurrence would need an
exchange every frame.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.lstm import lstm_seq
from ..parallel import distributed
from .complex_layers import TensorParallel


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> None:
    t.uniform_(-bound, bound, generator=generator)


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated one has variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    std = (1.0 / t.shape[0]) ** 0.5 / _TRUNCATED_STD  # fan_in: the kernel's rows
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class LSTM(TensorParallel, nn.Module):
    """Single-layer unidirectional LSTM over [T, B, F] -> [T, B, H].

    Parameters keep the JAX layouts: ``w_ih [F, 4H]``, ``w_hh [H, 4H]``.
    """

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b_ih = nn.Parameter(torch.empty(4 * hidden))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            _uniform_(p, bound, generator)

    def forward(
        self,
        x: torch.Tensor,
        state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        dt = x.dtype
        group = self.tp("w_ih")
        xw = distributed.gather_out(torch.matmul(distributed.copy_in(x, group), self.w_ih.to(dt)),
                                    -1, group)
        xw = xw + (self.full("b_ih") + self.full("b_hh")).to(dt)
        h0, c0 = (None, None) if state is None else state
        y, _ = lstm_seq(xw, self.full("w_hh").to(dt), h0, c0)
        return y


class NaiveComplexLSTM(TensorParallel, nn.Module):
    """Packed-complex LSTM layer: ([T,B,F], [T,B,F]) -> ([T,B,*], [T,B,*]).

    ``hidden_size`` counts the full packed width (real+imag).
    ``projection_dim`` adds per-part output projections to
    ``projection_dim // 2`` (the last bottleneck layer).
    """

    def __init__(self, input_size: int, hidden_size: int,
                 projection_dim: Optional[int] = None):
        super().__init__()
        units = hidden_size // 2
        self.units = units
        self.real_lstm = LSTM(input_size, units)
        self.imag_lstm = LSTM(input_size, units)
        self.projection_dim = projection_dim
        if projection_dim is not None:
            proj = projection_dim // 2
            self.proj_wr = nn.Parameter(torch.empty(units, proj))
            self.proj_br = nn.Parameter(torch.empty(proj))
            self.proj_wi = nn.Parameter(torch.empty(units, proj))
            self.proj_bi = nn.Parameter(torch.empty(proj))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.real_lstm.reset_parameters(generator)
        self.imag_lstm.reset_parameters(generator)
        if self.projection_dim is not None:
            bound = 1.0 / math.sqrt(self.units)
            for p in (self.proj_wr, self.proj_br, self.proj_wi, self.proj_bi):
                _uniform_(p, bound, generator)

    def forward(self, xr: torch.Tensor, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B = xr.shape[1]
        z = torch.cat([xr, xi], dim=1)  # [T, 2B, F]
        real_out2 = self.real_lstm(z)
        imag_out2 = self.imag_lstm(z)
        r2r, i2r = real_out2[:, :B], real_out2[:, B:]
        r2i, i2i = imag_out2[:, :B], imag_out2[:, B:]
        out_r = r2r - i2i
        out_i = r2i + i2r
        if self.projection_dim is not None:
            out_r = self._project(out_r, "r")
            out_i = self._project(out_i, "i")
        return out_r, out_i

    def _project(self, h: torch.Tensor, part: str) -> torch.Tensor:
        """``h @ proj_w{part} + proj_b{part}``, column-parallel where the
        weight holds this rank's columns."""
        group = self.tp(f"proj_w{part}")
        w = getattr(self, f"proj_w{part}").to(h.dtype)
        y = distributed.gather_out(distributed.copy_in(h, group) @ w, -1, group)
        return y + self.full(f"proj_b{part}").to(h.dtype)


class Dense(TensorParallel, nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, ``kernel [F, O]``;
    lecun-normal kernel (orthogonal with ``orthogonal=True``), zero bias;
    column-parallel where ``kernel`` holds this rank's columns."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 orthogonal: bool = False):
        super().__init__()
        self.orthogonal = orthogonal
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.orthogonal:
            nn.init.orthogonal_(self.kernel, generator=generator)
        else:
            _lecun_normal_(self.kernel, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.tp("kernel")
        y = distributed.gather_out(
            torch.matmul(distributed.copy_in(x, group), self.kernel.to(x.dtype)), -1, group)
        return y if self.bias is None else y + self.full("bias").to(x.dtype)


# flax LSTMCell's gates, in the order lstm_seq takes them
_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """One real LSTM layer over ``[T, N, F] -> [T, N, H]`` with flax
    ``nn.LSTMCell``'s parameters: input denses ``ii``, ``if``, ``ig``, ``io``
    (``kernel [F, H]``, no bias, lecun-normal) and recurrent denses ``hi``,
    ``hf``, ``hg``, ``ho`` (``kernel [H, H]``, orthogonal, and ``bias``,
    zero).  The step is flax's, ``i = sigmoid(ii(x) + hi(h))`` and so on, the
    carry starting at zeros; the layer runs it as ``lstm_seq(x @ [Wii Wif
    Wig Wio] + [bhi bhf bhg bho], [Whi Whf Whg Who])``, float32 whatever the
    input's dtype (flax promotes a bf16 input to its float32 parameters).
    The four input denses have one shape, and so do the four recurrent
    ones, so the rule slices each four alike: sliced, each rank's
    ``[i f g o]`` columns are gathered gate by gate (``gather_out`` with 4
    parts).
    """

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in _GATES:
            self.add_module(f"i{gate}", Dense(input_size, hidden, use_bias=False))
        for gate in _GATES:
            self.add_module(f"h{gate}", Dense(hidden, hidden, orthogonal=True))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = [getattr(self, f"i{gate}") for gate in _GATES]
        recurrent = [getattr(self, f"h{gate}") for gate in _GATES]
        w_ih = torch.cat([d.kernel for d in inputs], dim=1)
        group = inputs[0].tp("kernel")
        xw = distributed.gather_out(torch.matmul(distributed.copy_in(x.float(), group), w_ih),
                                    -1, group, parts=len(_GATES))
        b = torch.cat([d.full("bias") for d in recurrent])
        w_hh = distributed.gather_out(torch.cat([d.kernel for d in recurrent], dim=1), 1,
                                      recurrent[0].tp("kernel"), parts=len(_GATES))
        y, _ = lstm_seq(xw + b, w_hh)
        return y
