"""The ABF's bias-free 3x3 SAME convolution over channels-last maps and its
gradients: hand-written Hopper kernels and their plain PyTorch versions.

Replaces ``speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py``:
``_fwd_kernel`` (K3f, via ``conv3x3_fwd``; the backward's dx pass is the same
kernel on flipped, transposed weights) and ``_wgrad_kernel`` (K3w, via
``conv3x3_wgrad``).

- ``conv3x3(x, w)``: ``x [B, D, T, C]`` and the module's weight ``w
  [O, C, 3, 3]`` (the layout of ``distill.abf.Conv3x3.kernel``, which
  ``utils.bridge`` maps from flax's HWIO) give ``[B, D, T, O]``,
  differentiable in both; the weight gradient comes back in ``w``'s layout.
  Each call makes its own HWIO copy of ``w`` (at most 9 * 64 * 256 floats
  here).
- ``conv3x3_fwd(x, w_hwio)`` and ``conv3x3_wgrad(x, g)`` are the kernels'
  wrappers, in the JAX kernel's layouts (``w_hwio [3, 3, C, O]``).  On a CUDA
  tensor they launch the kernels of ``csrc/conv3x3_fwd.cu`` and
  ``csrc/conv3x3_wgrad.cu`` (built at first use) or raise; nothing falls
  back.  On a CPU tensor they run ``conv3x3_reference`` and
  ``conv3x3_wgrad_reference``, explicit sums over the nine shifts.  Their
  ``launches`` counters count kernel launches only.

Each wrapper runs in its input's dtype, float32 or bfloat16 (``x`` and
``w`` of one dtype).  The bf16 instantiations (``csrc/conv3x3_bf16.cu``,
counted in ``launches_bf16``) are the Pallas kernels on bf16 operands: the
products of bf16 values, exact in float32, summed in float32, the forward's
output rounded once to bf16 and ``dw`` left in float32; TMA-fed ``wgmma``
bf16 tensor-core products (route ``"wgmma"``: C and O multiples of 8, the
forward's C <= 256, the maps 16-byte aligned), ``m16n8k16`` ``mma.sync``
ones (route ``"mma"``: the other shapes with O >= 8 and C >= 8) or f32 FMA
(route ``"fma"``; the weight gradient's ``"narrow"`` for O <= 8).  The plain
versions do the same in float32 and round where the kernels round.  The
differentiable ``conv3x3`` returns the weight gradient in the weight's
dtype, as the JAX custom VJP does.

In float32, K3f takes one of two routes by shape
(``conv3x3_fwd_route``): ``"mma"``, f32 operands split into two TF32 parts
each and three tensor-core products a pair ("3xTF32", within f32 rounding
of an f32 sum), or ``"fma"``, f32 FMA, for O < 8 or C < 4.  K3w takes one
of two routes by shape (``conv3x3_wgrad_route``): ``"mma"``, the same split
TF32 on the tensor cores with the pixels as the product's reduction, or
``"narrow"``, f32 FMA, for O <= 8.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, check_tensors, float_dtype, widened

FWD_SOURCE = "conv3x3_fwd.cu"
WGRAD_SOURCE = "conv3x3_wgrad.cu"
BF16_SOURCE = "conv3x3_bf16.cu"
SOURCES = (FWD_SOURCE, WGRAD_SOURCE, BF16_SOURCE)


def _shifted(x: torch.Tensor):
    """The nine views ``x[:, d+dd-1, t+tt-1]`` (zeros outside), with (dd, tt)."""
    _, D, T, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    for dd in range(3):
        for tt in range(3):
            yield dd, tt, xp[:, dd:dd + D, tt:tt + T]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: ``out = sum_{dd, tt} x[:, d+dd-1, t+tt-1] @ w[dd, tt]``
    for ``x [B, D, T, C]`` and ``w [3, 3, C, O]``, returned in x's dtype;
    bf16 inputs summed in float32 and the output rounded once."""
    xf, wf = widened(x), widened(w)
    out = None
    for dd, tt, xs in _shifted(xf):
        y = torch.matmul(xs, wf[dd, tt])
        out = y if out is None else out + y
    return out.to(x.dtype)


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: ``dw[dd, tt] = x[:, d+dd-1, t+tt-1]^T g`` summed over
    every (b, d, t), ``[3, 3, C, O]`` (float32 for bf16 inputs)."""
    xf, gf = widened(x), widened(g)
    C, O = x.shape[-1], g.shape[-1]
    g2 = gf.reshape(-1, O)
    dw = xf.new_empty(3, 3, C, O)
    for dd, tt, xs in _shifted(xf):
        dw[dd, tt] = xs.reshape(-1, C).T @ g2
    return dw


def _check_map(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    if t.ndim != 4:
        raise ValueError(f"{name} must be [B, D, T, C], got {tuple(t.shape)}")
    check_tensors(((name, t),), device, "conv3x3", dtype)


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == FWD_SOURCE:
        lib.conv3x3_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.conv3x3_fwd.restype = i32
        lib.conv3x3_fwd_scratch_floats.argtypes = [i32] * 2
        lib.conv3x3_fwd_scratch_floats.restype = ctypes.c_long
        lib.conv3x3_fwd_route.argtypes = [i32] * 2
        lib.conv3x3_fwd_route.restype = i32
    elif source == BF16_SOURCE:
        lib.conv3x3_bf16_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.conv3x3_bf16_fwd.restype = i32
        lib.conv3x3_bf16_fwd_scratch_elems.argtypes = [i32] * 2
        lib.conv3x3_bf16_fwd_scratch_elems.restype = ctypes.c_long
        for name in ("conv3x3_bf16_fwd_route", "conv3x3_bf16_wgrad_route"):
            getattr(lib, name).argtypes = [i32] * 3
            getattr(lib, name).restype = i32
        lib.conv3x3_bf16_wgrad_chunks.argtypes = [i32] * 3
        lib.conv3x3_bf16_wgrad_chunks.restype = i32
        lib.conv3x3_bf16_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.conv3x3_bf16_wgrad.restype = i32
    else:
        lib.conv3x3_wgrad_chunks.argtypes = [i32] * 3
        lib.conv3x3_wgrad_chunks.restype = i32
        lib.conv3x3_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.conv3x3_wgrad.restype = i32
        lib.conv3x3_wgrad_route.argtypes = [i32] * 2
        lib.conv3x3_wgrad_route.restype = i32
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [B, D, T, C]`` (*) ``w [3, 3, C, O]`` -> ``[B, D, T, O]`` in x's
    dtype (float32 or bfloat16, ``w`` the same): the K3f kernel on CUDA
    tensors (counted in ``conv3x3_fwd.launches``, the bf16 instantiation in
    ``conv3x3_fwd.launches_bf16``), ``conv3x3_reference`` on CPU tensors."""
    dtype = float_dtype(x, "conv3x3")
    _check_map("x", x, x.device, dtype)
    B, D, T, C = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be [3, 3, {C}, O], got {tuple(w.shape)}")
    _check_map("w", w, x.device, dtype)
    O = w.shape[3]
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    if dtype == torch.bfloat16:
        return _fwd_bf16(x, w, B, D, T, C, O)
    lib = _library(FWD_SOURCE)
    out = torch.empty(B, D, T, O, device=x.device, dtype=torch.float32)
    # the weights split into TF32 parts, in the tensor-core route's layout
    n_split = lib.conv3x3_fwd_scratch_floats(C, O)
    split = torch.empty(n_split, device=x.device, dtype=torch.float32) if n_split else None
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(x.data_ptr(), w.data_ptr(),
                              None if split is None else split.data_ptr(), out.data_ptr(),
                              B, D, T, C, O, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_fwd launch failed: CUDA error {err}")
    conv3x3_fwd.launches += 1
    return out


def _fwd_bf16(x, w, B, D, T, C, O):
    lib = _library(BF16_SOURCE)
    out = torch.empty(B, D, T, O, device=x.device, dtype=torch.bfloat16)
    # the weights packed [9, O, C] for the tensor-core route
    n_pack = lib.conv3x3_bf16_fwd_scratch_elems(C, O)
    pack = torch.empty(n_pack, device=x.device, dtype=torch.bfloat16) if n_pack else None
    with torch.cuda.device(x.device):
        err = lib.conv3x3_bf16_fwd(x.data_ptr(), w.data_ptr(),
                                   None if pack is None else pack.data_ptr(), out.data_ptr(),
                                   B, D, T, C, O, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_bf16_fwd launch failed: CUDA error {err}")
    conv3x3_fwd.launches_bf16 += 1
    return out


conv3x3_fwd.launches = 0
conv3x3_fwd.launches_bf16 = 0

FWD_ROUTES = ("fma", "mma", "wgmma")


def conv3x3_fwd_route(C: int, O: int, dtype: torch.dtype = torch.float32,
                      aligned: bool = True) -> str:
    """The route K3f takes for C input and O output channels in ``dtype``,
    as its C entry chooses it: ``"mma"`` (split TF32, or bf16 m16n8k16, on
    the tensor cores), ``"fma"`` (f32 FMA, where a tensor-core tile would be
    mostly padding) or, in bf16 only, ``"wgmma"`` (TMA and wgmma, where C
    and O are multiples of 8, C <= 256 and the maps start on 16 bytes;
    ``aligned`` false: x does not, and the route is ``"mma"``).  Asks the
    built library, so it needs the CUDA toolkit."""
    if dtype == torch.bfloat16:
        return FWD_ROUTES[_library(BF16_SOURCE).conv3x3_bf16_fwd_route(C, O, int(aligned))]
    return FWD_ROUTES[_library(FWD_SOURCE).conv3x3_fwd_route(C, O)]


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``[3, 3, C, O]`` (float32) of ``conv3x3_fwd(x, w)``
    for the incoming ``g [B, D, T, O]`` (x's dtype, float32 or bfloat16):
    the K3w kernel on CUDA tensors (counted in ``conv3x3_wgrad.launches``,
    the bf16 instantiation in ``conv3x3_wgrad.launches_bf16``; partial sums
    per chunk of freq rows, added in a fixed order, so repeated runs give the
    same bits), ``conv3x3_wgrad_reference`` on CPU tensors."""
    dtype = float_dtype(x, "conv3x3")
    _check_map("x", x, x.device, dtype)
    _check_map("g", g, x.device, dtype)
    B, D, T, C = x.shape
    if tuple(g.shape[:3]) != (B, D, T):
        raise ValueError(f"g must be [{B}, {D}, {T}, O], got {tuple(g.shape)}")
    O = g.shape[3]
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    bf16 = dtype == torch.bfloat16
    lib = _library(BF16_SOURCE if bf16 else WGRAD_SOURCE)
    chunks = (lib.conv3x3_bf16_wgrad_chunks if bf16 else lib.conv3x3_wgrad_chunks)(C, O, B * D)
    dw = torch.empty(3, 3, C, O, device=x.device, dtype=torch.float32)
    scratch = torch.empty(chunks, 9 * C * O, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = (lib.conv3x3_bf16_wgrad if bf16 else lib.conv3x3_wgrad)(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, D, T, C, O,
            chunks, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad launch failed ({dtype}): CUDA error {err}")
    if bf16:
        conv3x3_wgrad.launches_bf16 += 1
    else:
        conv3x3_wgrad.launches += 1
    return dw


conv3x3_wgrad.launches = 0
conv3x3_wgrad.launches_bf16 = 0

WGRAD_ROUTES = ("narrow", "mma", "wgmma")


def conv3x3_wgrad_route(C: int, O: int, dtype: torch.dtype = torch.float32,
                        aligned: bool = True) -> str:
    """The route K3w takes for C input and O output channels in ``dtype``,
    as its C entry chooses it: ``"mma"`` (split TF32, or bf16 m16n8k16, on
    the tensor cores), ``"narrow"`` (f32 FMA, where an n8 tile of output
    channels would be mostly padding) or, in bf16 only, ``"wgmma"`` (TMA and
    wgmma, where C and O are multiples of 8 and x and g start on 16 bytes;
    ``aligned`` false: one does not, and the route is ``"mma"``).  Asks the
    built library, so it needs the CUDA toolkit."""
    if dtype == torch.bfloat16:
        return WGRAD_ROUTES[_library(BF16_SOURCE).conv3x3_bf16_wgrad_route(C, O, int(aligned))]
    return WGRAD_ROUTES[_library(WGRAD_SOURCE).conv3x3_wgrad_route(C, O)]


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w.permute(2, 3, 1, 0).contiguous())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = conv3x3(g, flip(w)^T): w_flip[dd, tt, o, c] = w[o, c, 2-dd, 2-tt]
            dx = conv3x3_fwd(g, w.flip(2, 3).permute(2, 3, 0, 1).contiguous())
        if ctx.needs_input_grad[1]:
            # float32 sums, returned in the weight's dtype (the JAX VJP's cast)
            dw = conv3x3_wgrad(x, g).to(w.dtype).permute(3, 2, 0, 1).contiguous()
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free 3x3 SAME conv of ``x [B, D, T, C]`` with the module weight
    ``w [O, C, 3, 3]`` of x's dtype: ``[B, D, T, O]``, differentiable in
    ``x`` and ``w``."""
    if w.ndim != 4 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"w must be [O, {x.shape[-1]}, 3, 3], got {tuple(w.shape)}")
    return _Conv3x3.apply(x, w)
