"""The ABF attention fuse (freq upscale of the residual, 2-way sigmoid
attention, blend) and its backward: hand-written Hopper kernels and their
plain PyTorch versions.

Replaces ``speech_enhancement_clskd_tpu/ops/pallas/attfuse.py``:
``_fwd_kernel`` (K4f, via ``attention_fuse_fwd``) and ``_bwd_kernel`` (K4b,
via ``attention_fuse_bwd``).  With ``y`` the k-fold nearest freq upscale of
the residual (``y[:, d] = res[:, d // k]``, ``k = D / Dp``):

    z   = sigmoid(x @ wx + y @ wy + bias)      [B, D, T, 2]
    out = x * z[..., :1] + y * z[..., 1:]      [B, D, T, C]

- ``attention_fuse(x, res, wx, wy, bias)``: ``x [B, D, T, C]``, ``res
  [B, Dp, T, C]``, ``wx``/``wy [C, 2]``, ``bias [2]``; differentiable in all
  five (the bias gradient has the bias's shape ``[2]``).  The forward's ``z``
  is kept for the backward.  Callers gate on ``attfuse_dispatchable``.
- ``attention_fuse_fwd`` and ``attention_fuse_bwd`` are the kernels'
  wrappers.  On a CUDA tensor they launch the kernels of
  ``csrc/attfuse_fwd.cu`` and ``csrc/attfuse_bwd.cu`` (float32) or
  ``csrc/attfuse_bf16.cu`` (bfloat16), built at first use, or raise; nothing
  falls back.  On a CPU tensor they run ``attention_fuse_reference`` and
  ``attention_fuse_bwd_reference``.  Their ``launches`` counters count kernel
  launches only.

Each wrapper runs in its input's dtype, float32 or bfloat16 (all inputs of
one dtype).  The bf16 kernels (``attfuse_fwd_bf16`` and ``attfuse_bwd_bf16``
in ``csrc/attfuse_bf16.cu``, counted in ``launches_bf16``) are the Pallas
kernels on bf16 maps: K4f sums the logits of the exact products in float32,
rounds ``z = sigmoid(p + bias)`` to bf16 and blends in bf16 arithmetic (each
product and the sum rounded); K4b upcasts to float32, rounds ``dx`` and
``dres`` once to bf16 and returns the parameter gradients in float32.  They
copy their strips by bulk copy and so take maps that start on 16 bytes: the
wrappers copy a bf16 input that does not to an aligned buffer first.  The
plain versions round at the same places.  The differentiable
``attention_fuse`` returns the parameter gradients in the parameters' dtype,
as the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build, aligned, check_tensors, float_dtype, widened

FWD_SOURCE = "attfuse_fwd.cu"
BWD_SOURCE = "attfuse_bwd.cu"
BF16_SOURCE = "attfuse_bf16.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE, BF16_SOURCE)
# the kernels keep a row's channels in registers, 32 lanes x at most 8 each
MAX_CHANNELS = 256
# blocks of the float32 backward's main pass, each writing one partial of the
# small gradients; fixed, so the sum order depends only on the shape (the
# bf16 backward's count comes from its library, by shape)
BWD_BLOCKS = 4096


def attfuse_dispatchable(x_shape, res_shape) -> bool:
    """Geometry the kernels take: equal B, T and C, D a multiple of the
    residual's Dp, and C <= ``MAX_CHANNELS``."""
    b, d, t, c = x_shape
    rb, dp, rt, rc = res_shape
    return rb == b and rt == t and rc == c and dp >= 1 and d % dp == 0 and c <= MAX_CHANNELS


def _upscale(res: torch.Tensor, d: int) -> torch.Tensor:
    return torch.repeat_interleave(res, d // res.shape[1], dim=1)


def attention_fuse_reference(x, res, wx, wy, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: ``(out, z)``, with the residual upscaled in memory.  On
    bf16 inputs the logits are float32 sums, ``z`` is rounded to bf16 and the
    blend runs in bf16 (each product and the sum rounded), as the Pallas
    body does."""
    y = _upscale(res, x.shape[1])
    if x.dtype != torch.bfloat16:
        z = torch.sigmoid(x @ wx + y @ wy + bias)
    else:
        p = x.float() @ wx.float() + y.float() @ wy.float()
        z = torch.sigmoid(p + bias.float()).to(x.dtype)
    return x * z[..., 0:1] + y * z[..., 1:2], z


def attention_fuse_bwd_reference(x, res, z, g, wx, wy):
    """Plain PyTorch: ``(dx, dres, dwx, dwy, dbias)`` for the incoming ``g``,
    from the forward's inputs and its ``z``.  On bf16 inputs: in float32 from
    the upcast inputs, ``dx`` and ``dres`` rounded to bf16, the parameter
    gradients float32."""
    dt = x.dtype
    x, res, z, g, wx, wy = (widened(t) for t in (x, res, z, g, wx, wy))
    B, D, T, C = x.shape
    Dp = res.shape[1]
    y = _upscale(res, D)
    dz = torch.stack([(g * x).sum(-1), (g * y).sum(-1)], dim=-1)
    dp = z * (1 - z) * dz
    dx = z[..., 0:1] * g + dp @ wx.T
    dy = z[..., 1:2] * g + dp @ wy.T
    dres = dy.reshape(B, Dp, D // Dp, T, C).sum(dim=2)
    dp2 = dp.reshape(-1, 2)
    return (dx.to(dt), dres.to(dt), x.reshape(-1, C).T @ dp2, y.reshape(-1, C).T @ dp2,
            dp2.sum(dim=0))


def _check_inputs(x, res, wx, wy) -> None:
    if x.ndim != 4 or res.ndim != 4:
        raise ValueError(f"x and res must be [B, D, T, C], got {tuple(x.shape)}, "
                         f"{tuple(res.shape)}")
    C = x.shape[-1]
    if not attfuse_dispatchable(x.shape, res.shape):
        raise ValueError(f"attention_fuse does not take x {tuple(x.shape)} with res "
                         f"{tuple(res.shape)}: gate on attfuse_dispatchable")
    for name, w in (("wx", wx), ("wy", wy)):
        if tuple(w.shape) != (C, 2):
            raise ValueError(f"{name} must be [{C}, 2], got {tuple(w.shape)}")


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {FWD_SOURCE: ("attfuse_fwd",), BWD_SOURCE: ("attfuse_bwd",),
               BF16_SOURCE: ("attfuse_fwd_bf16", "attfuse_bwd_bf16")}[source]
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * 7 + [i32] * 5 if "fwd" in name else [ptr] * 10 + [i32] * 6) + [ptr]
        fn.restype = i32
    if source == BF16_SOURCE:
        lib.attfuse_bwd_bf16_blocks.argtypes = [i32] * 4
        lib.attfuse_bwd_bf16_blocks.restype = i32
    return lib


def attention_fuse_fwd(x, res, wx, wy, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, D, T, C], z [B, D, T, 2])`` in x's dtype (float32 or
    bfloat16): the K4f kernel on CUDA tensors (counted in
    ``attention_fuse_fwd.launches``, the bf16 kernel in
    ``attention_fuse_fwd.launches_bf16``; a bf16 input off 16 bytes is
    copied first), ``attention_fuse_reference`` on CPU tensors."""
    _check_inputs(x, res, wx, wy)
    if tuple(bias.shape) != (2,):
        raise ValueError(f"bias must be [2], got {tuple(bias.shape)}")
    dtype = float_dtype(x, "attention_fuse")
    check_tensors((("x", x), ("res", res), ("wx", wx), ("wy", wy), ("bias", bias)), x.device,
                  "attention_fuse", dtype)
    if x.device.type == "cpu":
        return attention_fuse_reference(x, res, wx, wy, bias)
    B, D, T, C = x.shape
    bf16 = dtype == torch.bfloat16
    if bf16:
        x, res, wx, wy, bias = (aligned(t) for t in (x, res, wx, wy, bias))
    lib = _library(BF16_SOURCE if bf16 else FWD_SOURCE)
    out = torch.empty_like(x)
    z = torch.empty(B, D, T, 2, device=x.device, dtype=dtype)
    with torch.cuda.device(x.device):
        err = (lib.attfuse_fwd_bf16 if bf16 else lib.attfuse_fwd)(
            x.data_ptr(), res.data_ptr(), wx.data_ptr(), wy.data_ptr(), bias.data_ptr(),
            out.data_ptr(), z.data_ptr(), B, D, res.shape[1], T, C,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attfuse_fwd launch failed ({dtype}): CUDA error {err}")
    if bf16:
        attention_fuse_fwd.launches_bf16 += 1
    else:
        attention_fuse_fwd.launches += 1
    return out, z


attention_fuse_fwd.launches = 0
attention_fuse_fwd.launches_bf16 = 0


def attention_fuse_bwd(x, res, z, g, wx, wy):
    """``(dx, dres, dwx [C, 2], dwy [C, 2], dbias [2])`` for the incoming
    ``g``, ``dx`` and ``dres`` in x's dtype (float32 or bfloat16), the
    three small gradients float32: the K4b kernel on CUDA tensors (counted
    in ``attention_fuse_bwd.launches``, the bf16 kernel in
    ``attention_fuse_bwd.launches_bf16``; the three small gradients are
    per-block partials added in a fixed order, so repeated runs give the
    same bits; a bf16 input off 16 bytes is copied first),
    ``attention_fuse_bwd_reference`` on CPU tensors."""
    _check_inputs(x, res, wx, wy)
    B, D, T, C = x.shape
    if tuple(z.shape) != (B, D, T, 2) or tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"z must be [{B}, {D}, {T}, 2] and g like x, got "
                         f"{tuple(z.shape)}, {tuple(g.shape)}")
    dtype = float_dtype(x, "attention_fuse")
    check_tensors((("x", x), ("res", res), ("z", z), ("g", g), ("wx", wx), ("wy", wy)),
                  x.device, "attention_fuse", dtype)
    if x.device.type == "cpu":
        return attention_fuse_bwd_reference(x, res, z, g, wx, wy)
    bf16 = dtype == torch.bfloat16
    Dp = res.shape[1]
    if bf16:
        x, res, z, g, wx, wy = (aligned(t) for t in (x, res, z, g, wx, wy))
        lib = _library(BF16_SOURCE)
        blocks = lib.attfuse_bwd_bf16_blocks(B, Dp, T, C)
    else:
        lib = _library(BWD_SOURCE)
        blocks = min(BWD_BLOCKS, B * Dp * T)
    dx = torch.empty_like(x)
    dres = torch.empty_like(res)
    grads = torch.empty(4 * C + 2, device=x.device, dtype=torch.float32)
    scratch = torch.empty(blocks, 4 * C + 2, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = (lib.attfuse_bwd_bf16 if bf16 else lib.attfuse_bwd)(
            x.data_ptr(), res.data_ptr(), z.data_ptr(), g.data_ptr(), wx.data_ptr(),
            wy.data_ptr(), dx.data_ptr(), dres.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
            B, D, Dp, T, C, blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attfuse_bwd launch failed ({dtype}): CUDA error {err}")
    if bf16:
        attention_fuse_bwd.launches_bf16 += 1
    else:
        attention_fuse_bwd.launches += 1
    return dx, dres, grads[:2 * C].view(C, 2), grads[2 * C:4 * C].view(C, 2), grads[4 * C:]


attention_fuse_bwd.launches = 0
attention_fuse_bwd.launches_bf16 = 0


class _AttentionFuse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, wx, wy, bias):
        out, z = attention_fuse_fwd(x, res, wx, wy, bias)
        ctx.save_for_backward(x, res, z, wx, wy)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, res, z, wx, wy = ctx.saved_tensors
        dx, dres, dwx, dwy, db = attention_fuse_bwd(x, res, z, g.contiguous(), wx, wy)
        # float32 sums, returned in the parameters' dtype (the JAX VJP's casts)
        return dx, dres, dwx.to(wx.dtype), dwy.to(wy.dtype), db.to(wx.dtype)


def attention_fuse(x: torch.Tensor, res: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Sigmoid-attention fusion of ``x [B, D, T, C]`` with the nearest freq
    upscale of ``res [B, Dp, T, C]``; ``wx``/``wy [C, 2]``, ``bias [2]``.
    Differentiable in all five."""
    return _AttentionFuse.apply(x, res, wx, wy, bias)
