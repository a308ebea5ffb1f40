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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.lstm import lstm_seq


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> None:
    t.uniform_(-bound, bound, generator=generator)


class LSTM(nn.Module):
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
        xw = torch.matmul(x, self.w_ih.to(dt)) + (self.b_ih + self.b_hh).to(dt)
        h0, c0 = (None, None) if state is None else state
        y, _ = lstm_seq(xw, self.w_hh.to(dt), h0, c0)
        return y


class NaiveComplexLSTM(nn.Module):
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
            dt = out_r.dtype
            out_r = out_r @ self.proj_wr.to(dt) + self.proj_br.to(dt)
            out_i = out_i @ self.proj_wi.to(dt) + self.proj_bi.to(dt)
        return out_r, out_i
