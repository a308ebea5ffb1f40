"""The LSTM recurrence over a whole sequence and its backward: hand-written
Hopper kernels and their plain PyTorch versions.

Replaces ``speech_enhancement_clskd_tpu/ops/pallas/lstm.py``: ``_fwd_kernel``
(K1f, via ``lstm_seq``) and ``_bwd_kernel`` (K1b, via the custom VJP
``_lstm_bwd``).  ``lstm_seq(xw, w_hh, h0, c0) -> (y, c)`` takes the
pre-projected inputs ``xw = x @ W_ih + b`` ``[T, N, 4H]`` and the recurrent
weights ``W_hh [H, 4H]`` (gate order i, f, g, o) and returns the hidden and
cell states of every step, ``[T, N, H]`` each, in float32.  It is
differentiable in ``xw`` and ``w_hh``; ``c`` is not differentiable, and
gradients for ``h0``/``c0`` are not supported (the JAX kernel path runs
without a state).  bf16 inputs (bf16 compute) are upcast to float32 for the
kernels and ``y`` comes back in bf16, their gradients in bf16, as the JAX
layer casts around the Pallas call (``ops/pallas/lstm.py:118, 176-187``): the
recurrence always runs in float32.

- On a CUDA tensor the forward launches the kernel of ``csrc/lstm_seq_fwd.cu``
  and the backward that of ``csrc/lstm_seq_bwd.cu`` (each built at first use),
  or raise; nothing falls back.  The sources' head notes say what bounds each
  kernel on the H100 and how its design answers that.
- On a CPU tensor they run ``lstm_seq_reference`` and
  ``lstm_seq_bwd_reference``, plain time loops; the latter first computes the
  gates of every step with ``lstm_bwd_gates_reference``, the plain version
  of the backward kernel's gate pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build, check_tensors, float_dtype

FWD_SOURCE = "lstm_seq_fwd.cu"
BWD_SOURCE = "lstm_seq_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
MAX_GATES = 1024  # 4H: both kernels' plans take H <= 256
# rows of the T*N axis per block of the backward's dW_hh pass; the scratch
# holds one [H, 4H] partial per chunk (grid.y allows at most 65535 chunks)
DW_CHUNK_ROWS = 512
MAX_DW_CHUNKS = 65535


def lstm_seq_reference(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch time loop computing what the forward kernel computes."""
    T, N, G = xw.shape
    H = G // 4
    h = xw.new_zeros(N, H) if h0 is None else h0
    c = xw.new_zeros(N, H) if c0 is None else c0
    ys, cs = [], []
    for t in range(T):
        gates = xw[t] + h @ w_hh
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


@torch.no_grad()
def lstm_bwd_gates_reference(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    y: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel's gate pass: the gates of
    every step from the forward's inputs and outputs, ``[T, N, 4H]`` in order
    (i, f, g, o) after their sigmoid or tanh: ``xw[t] + h_{t-1} @ W_hh`` with
    ``h_{t-1} = y[t-1]`` (``h0``, or zeros, at t = 0).  None of it depends on
    the backward's serial chain."""
    H = xw.shape[-1] // 4
    zeros = xw.new_zeros(1, xw.shape[1], H)
    h_prev = torch.cat([zeros if h0 is None else h0[None], y[:-1]])
    gates = xw + h_prev @ w_hh
    i, f, g, o = gates.split(H, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)],
                     dim=-1)


@torch.no_grad()
def lstm_seq_bwd_reference(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    y: torch.Tensor,
    c: torch.Tensor,
    dy: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of what the backward kernel computes: the gates
    of every step first (``lstm_bwd_gates_reference``), then the reverse time
    loop, as the Pallas ``_bwd_kernel`` does it step by step: dh = dy_t +
    dgates_{t+1} @ W_hh^T; dc carried through f; dxw[t] = dgates_t; dW_hh +=
    h_{t-1}^T @ dgates_t."""
    T, N, G = xw.shape
    H = G // 4
    act = lstm_bwd_gates_reference(xw, w_hh, y, h0)
    zeros = xw.new_zeros(1, N, H)
    h_prev = torch.cat([zeros if h0 is None else h0[None], y[:-1]])
    c_prev = torch.cat([zeros if c0 is None else c0[None], c[:-1]])
    dh_next = xw.new_zeros(N, H)
    dc_next = xw.new_zeros(N, H)
    dw_hh = torch.zeros_like(w_hh)
    dxw = torch.empty_like(xw)
    for t in reversed(range(T)):
        i, f, g, o = act[t].split(H, dim=-1)
        tc = torch.tanh(c[t])
        dh = dy[t] + dh_next
        do_lin = dh * tc * o * (1 - o)
        dc = dh * o * (1 - tc * tc) + dc_next
        di_lin = dc * g * i * (1 - i)
        dg_lin = dc * i * (1 - g * g)
        df_lin = dc * c_prev[t] * f * (1 - f)
        dgates = torch.cat([di_lin, df_lin, dg_lin, do_lin], dim=-1)
        dxw[t] = dgates
        dw_hh += h_prev[t].T @ dgates
        dh_next = dgates @ w_hh.T
        dc_next = dc * f
    return dxw, dw_hh


def _check(xw, w_hh, h0, c0) -> None:
    if xw.ndim != 3 or xw.shape[-1] % 4 or xw.shape[0] < 1 or xw.shape[1] < 1:
        raise ValueError(f"xw must be [T>=1, N>=1, 4H], got {tuple(xw.shape)}")
    T, N, G = xw.shape
    H = G // 4
    if tuple(w_hh.shape) != (H, G):
        raise ValueError(f"w_hh must be [{H}, {G}], got {tuple(w_hh.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if s is not None and tuple(s.shape) != (N, H):
            raise ValueError(f"{name} must be [{N}, {H}], got {tuple(s.shape)}")
    check_tensors((("xw", xw), ("w_hh", w_hh), ("h0", h0), ("c0", c0)), xw.device, "lstm_seq")
    if xw.device.type == "cuda" and G > MAX_GATES:
        raise ValueError(f"the kernels take 4H <= {MAX_GATES}, got {G}")


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == FWD_SOURCE:
        lib.lstm_seq_fwd.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
        lib.lstm_seq_fwd.restype = i32
        lib.lstm_seq_fwd_plan_of.argtypes = [i32] * 2 + [ctypes.POINTER(i32)] * 4
        lib.lstm_seq_fwd_plan_of.restype = i32
    else:
        lib.lstm_seq_bwd.argtypes = [ptr] * 10 + [i32] * 4 + [ptr]
        lib.lstm_seq_bwd.restype = i32
        lib.lstm_seq_bwd_scratch_floats.argtypes = [i32] * 4
        lib.lstm_seq_bwd_scratch_floats.restype = ctypes.c_long
        lib.lstm_seq_bwd_plan_of.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
        lib.lstm_seq_bwd_plan_of.restype = i32
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd(xw, w_hh, h0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on checked inputs: the K1f kernel on CUDA tensors (counted
    in ``lstm_seq.launches``), the plain loop on CPU tensors."""
    if xw.device.type == "cpu":
        return lstm_seq_reference(xw, w_hh, h0, c0)
    T, N, G = xw.shape
    lib = _library(FWD_SOURCE)
    y = torch.empty(T, N, G // 4, device=xw.device, dtype=torch.float32)
    c = torch.empty_like(y)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.lstm_seq_fwd(_ptr(xw), _ptr(w_hh), _ptr(h0), _ptr(c0), _ptr(y), _ptr(c),
                               T, N, G // 4, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_fwd launch failed: CUDA error {err}")
    lstm_seq.launches += 1
    return y, c


def lstm_seq_fwd_plan(N: int, H: int) -> dict:
    """The plan K1f takes for N rows of width H on the current card, as its C
    entry chooses it: cluster size ``P``, lanes a gate column ``KS`` and batch
    rows a cluster ``rows``.  Asks the built library, so it needs the card."""
    out = [ctypes.c_int() for _ in range(4)]
    err = _library(FWD_SOURCE).lstm_seq_fwd_plan_of(N, H, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"lstm_seq_fwd_plan_of failed: CUDA error {err}")
    return dict(zip(("plan", "P", "KS", "rows"), (v.value for v in out)))


def lstm_seq_bwd(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    y: torch.Tensor,
    c: torch.Tensor,
    dy: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dxw, dw_hh)`` of ``lstm_seq``'s ``y`` for the incoming
    ``dy``, from the forward's inputs and outputs: the K1b kernel on CUDA
    tensors, ``lstm_seq_bwd_reference`` on CPU tensors."""
    _check(xw, w_hh, h0, c0)
    T, N, G = xw.shape
    for name, t in (("y", y), ("c", c), ("dy", dy)):
        if tuple(t.shape) != (T, N, G // 4):
            raise ValueError(f"{name} must be [{T}, {N}, {G // 4}], got {tuple(t.shape)}")
    check_tensors((("y", y), ("c", c), ("dy", dy)), xw.device, "lstm_seq_bwd")
    if xw.device.type == "cpu":
        return lstm_seq_bwd_reference(xw, w_hh, y, c, dy, h0, c0)
    H = G // 4
    chunk_rows = max(DW_CHUNK_ROWS, -(-T * N // MAX_DW_CHUNKS))
    lib = _library(BWD_SOURCE)
    dxw = torch.empty_like(xw)
    dw_hh = torch.empty_like(w_hh)
    # the gates of every step, the dW_hh partials and W_hh^T
    scratch = torch.empty(lib.lstm_seq_bwd_scratch_floats(T, N, H, chunk_rows),
                          device=xw.device, dtype=torch.float32)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.lstm_seq_bwd(_ptr(xw), _ptr(w_hh), _ptr(y), _ptr(c), _ptr(dy), _ptr(h0),
                               _ptr(c0), _ptr(dxw), _ptr(dw_hh), _ptr(scratch),
                               T, N, H, chunk_rows, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd launch failed: CUDA error {err}")
    lstm_seq_bwd.launches += 1
    return dxw, dw_hh


lstm_seq_bwd.launches = 0


def lstm_seq_bwd_plan(H: int) -> dict:
    """The plan K1b takes for width H, as its C entry chooses it: lanes a
    gate quarter ``KS`` and W_hh weights a lane in registers ``WPT`` (0: read
    through L2).  Asks the built library, so it needs the CUDA toolkit."""
    out = [ctypes.c_int() for _ in range(3)]
    err = _library(BWD_SOURCE).lstm_seq_bwd_plan_of(H, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd_plan_of failed: CUDA error {err}")
    return dict(zip(("plan", "KS", "WPT"), (v.value for v in out)))


class _LSTMSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, w_hh, h0, c0):
        y, c = _fwd(xw, w_hh, h0, c0)
        ctx.save_for_backward(xw, w_hh, y, c, h0, c0)
        ctx.mark_non_differentiable(c)
        return y, c

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dc):
        xw, w_hh, y, c, h0, c0 = ctx.saved_tensors
        dxw, dw_hh = lstm_seq_bwd(xw, w_hh, y, c, dy.contiguous(), h0, c0)
        return dxw, dw_hh, None, None


def lstm_seq(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, N, 4H] + [H, 4H] (+ [N, H] initial states) -> y, c [T, N, H];
    differentiable in ``xw`` and ``w_hh``.  ``y`` in xw's dtype (float32 or
    bfloat16; the recurrence in float32 either way), ``c`` float32."""
    dtype = float_dtype(xw, "lstm_seq")
    if dtype != torch.float32:
        xw, w_hh = xw.float(), w_hh.float()
        h0, c0 = (None if s is None else s.float() for s in (h0, c0))
    _check(xw, w_hh, h0, c0)
    if torch.is_grad_enabled() and any(s is not None and s.requires_grad for s in (h0, c0)):
        raise NotImplementedError(
            "lstm_seq has no gradient for h0/c0 (the JAX kernel path runs without a "
            "state); pass them without requires_grad")
    y, c = _LSTMSeq.apply(xw, w_hh, h0, c0)
    return y.to(dtype), c


lstm_seq.launches = 0
