"""The whole ABF block (1x1 conv with bn1's affine folded in, attention fuse
with the upscaled residual, 3x3 SAME conv) and its backward: hand-written
Hopper kernels and their plain PyTorch versions.

Replaces ``speech_enhancement_clskd_tpu/ops/pallas/abf_block.py``:
``_fwd_kernel`` (K5f, via ``abf_block_fwd``) and ``_bwd_kernel`` (K5b, via
``abf_block_bwd``).  With ``y`` the k-fold nearest freq upscale of the
residual (``y[:, d] = res[:, d // k]``, ``k = D / Dp``):

    xhat = tap @ w1a + bvec                          [B, D, T, M]
    z    = sigmoid(tap @ wxt + y @ wy + zoff)        [B, D, T, 2]
    xf   = xhat * z[..., :1] + y * z[..., 1:]        (xhat without a residual)
    out  = conv3x3_same(xf, w2)                      [B, D, T, O]

- ``abf_block(tap, res, w1a, bvec, wxt, wy, zoff, w2)``: ``tap [B, D, T,
  Cs]``, ``res [B, Dp, T, M]`` or ``None`` (the deepest block: no fuse, and
  ``wxt``, ``wy``, ``zoff`` are ignored), ``w1a [Cs, M]``, ``bvec [M]``,
  ``wxt [Cs, 2]``, ``wy [M, 2]``, ``zoff [2]``, ``w2 [3, 3, M, O]`` (HWIO);
  returns ``(xf, out)``, differentiable in every tensor input (``bvec`` and
  ``zoff`` get gradients of their own shapes).  The forward keeps tap, res,
  the small weights and ``xf`` for the backward, as the JAX VJP does.
  Callers gate on ``abf_block_dispatchable``.
- ``abf_block_fwd`` and ``abf_block_bwd`` are the kernels' wrappers.  On a
  CUDA tensor they launch the kernels of ``csrc/abf_block_fwd.cu`` and
  ``csrc/abf_block_bwd.cu`` (built at first use) or raise; nothing falls
  back.  On a CPU tensor they run ``abf_block_reference`` and
  ``abf_block_bwd_reference``.  Their ``launches`` counters count calls that
  launched the kernels (K5f's xf pass and conv, K5b's adjoint, pixel pass,
  reduction and dw2 passes count as one).

Everything is float32; a bfloat16 input raises ``NotImplementedError`` (the
bf16 instantiations are ROADMAP queue 1 item 10).  Each kernel takes one of two routes by shape
(``abf_block_fwd_route``, ``abf_block_bwd_route``).  ``"mma"``: the 3x3 conv
(K5f's over xf; K5b's adjoint over g_out, into a scratch ``dxf``) on K3f's
tensor-core tile, f32 operands split into two TF32 parts each and three
products a pair ("3xTF32", within f32 rounding of an f32 sum).  ``"direct"``
(K5f: O < 8 or M < 4, the decoder's mask block; K5b: O < 4 or M < 8): the
conv in f32 FMA inside the kernel's own pass.  The 1x1 conv, the attention
and their gradients are f32 FMA; K5b's dw2 is K3w's split-TF32 reduction
(f32 FMA for O <= 8).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build, check_tensors, refuse_bf16
from .conv3x3 import conv3x3_reference, conv3x3_wgrad_reference

FWD_SOURCE = "abf_block_fwd.cu"
BWD_SOURCE = "abf_block_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
# the kernels stage all of w1a in shared memory, and K5b holds all mid
# channels of a pixel in one block
MAX_TAP_CHANNELS = 64
MAX_MID_CHANNELS = 64


def abf_block_dispatchable(tap_shape, res_shape, mid: int, out_ch: int) -> bool:
    """Geometry the kernels take: the JAX gate's shape conditions (equal B
    and T, the residual in ``mid`` channels, D a multiple of its Dp), with
    the kernels' own limits in place of the TPU tile budget: Cs <=
    ``MAX_TAP_CHANNELS``, ``mid`` <= ``MAX_MID_CHANNELS``."""
    b, d, t, cs = tap_shape
    if not (1 <= cs <= MAX_TAP_CHANNELS and 1 <= mid <= MAX_MID_CHANNELS and out_ch >= 1):
        return False
    if res_shape is None:
        return True
    rb, dp, rt, rc = res_shape
    return rb == b and rt == t and rc == mid and dp >= 1 and d % dp == 0


def _upscale(res: torch.Tensor, d: int) -> torch.Tensor:
    return torch.repeat_interleave(res, d // res.shape[1], dim=1)


def _flip(w2: torch.Tensor) -> torch.Tensor:
    """The conv adjoint's weights ``[3, 3, O, M]``: ``w2f[dd, tt, o, m] =
    w2[2 - dd, 2 - tt, m, o]``."""
    return w2.flip(0, 1).transpose(2, 3).contiguous()


def abf_block_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2):
    """Plain PyTorch: ``(xf, out)``, every intermediate in memory (the
    composition of ``_ref_block`` in ``tests/test_pallas_abf_block.py``)."""
    xf = tap @ w1a + bvec
    if res is not None:
        y = _upscale(res, tap.shape[1])
        z = torch.sigmoid(tap @ wxt + y @ wy + zoff)
        xf = xf * z[..., 0:1] + y * z[..., 1:2]
    return xf, conv3x3_reference(xf, w2)


def abf_block_bwd_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout):
    """Plain PyTorch, the backward written out: ``(g_tap, g_res, dw1a, dbvec,
    dwxt, dwy, dzoff, dw2)`` for the incoming ``gxf``/``gout``; without a
    residual ``g_res``, ``dwxt``, ``dwy`` and ``dzoff`` are ``None``."""
    Cs, M = w1a.shape
    dxf = gxf + conv3x3_reference(gout, _flip(w2))
    dw2 = conv3x3_wgrad_reference(xf, gout)
    tap2 = tap.reshape(-1, Cs)
    if res is None:
        g_xhat = dxf.reshape(-1, M)
        gtap = (g_xhat @ w1a.T).reshape(tap.shape)
        return gtap, None, tap2.T @ g_xhat, g_xhat.sum(0), None, None, None, dw2
    B, D, T, _ = tap.shape
    Dp = res.shape[1]
    y = _upscale(res, D)
    xhat = tap @ w1a + bvec
    z = torch.sigmoid(tap @ wxt + y @ wy + zoff)
    dp = z * (1 - z) * torch.stack([(dxf * xhat).sum(-1), (dxf * y).sum(-1)], dim=-1)
    g_xhat = dxf * z[..., 0:1]
    g_y = dxf * z[..., 1:2] + dp @ wy.T
    gtap = g_xhat @ w1a.T + dp @ wxt.T
    gres = g_y.reshape(B, Dp, D // Dp, T, M).sum(dim=2)
    g_xhat2, dp2 = g_xhat.reshape(-1, M), dp.reshape(-1, 2)
    return (gtap, gres, tap2.T @ g_xhat2, g_xhat2.sum(0), tap2.T @ dp2,
            y.reshape(-1, M).T @ dp2, dp2.sum(0), dw2)


def _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, op: str) -> Tuple[int, int, int]:
    """Raise unless the inputs fit the kernels; ``(Cs, M, O)``."""
    if tap.ndim != 4 or (res is not None and res.ndim != 4):
        raise ValueError(f"tap and res must be [B, D, T, C], got {tuple(tap.shape)}, "
                         f"{None if res is None else tuple(res.shape)}")
    Cs = tap.shape[-1]
    if w1a.ndim != 2 or w1a.shape[0] != Cs:
        raise ValueError(f"w1a must be [{Cs}, M], got {tuple(w1a.shape)}")
    M = w1a.shape[1]
    if w2.ndim != 4 or tuple(w2.shape[:3]) != (3, 3, M):
        raise ValueError(f"w2 must be [3, 3, {M}, O], got {tuple(w2.shape)}")
    O = w2.shape[3]
    if not abf_block_dispatchable(tap.shape, None if res is None else res.shape, M, O):
        raise ValueError(f"abf_block does not take tap {tuple(tap.shape)} with res "
                         f"{None if res is None else tuple(res.shape)}, mid {M}: gate on "
                         "abf_block_dispatchable")
    shapes = [("bvec", bvec, (M,))]
    if res is not None:
        shapes += [("wxt", wxt, (Cs, 2)), ("wy", wy, (M, 2)), ("zoff", zoff, (2,))]
    for name, t, want in shapes:
        if t is None or tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{None if t is None else tuple(t.shape)}")
    fused = (("res", res), ("wxt", wxt), ("wy", wy), ("zoff", zoff)) if res is not None else ()
    refuse_bf16((("tap", tap), ("w1a", w1a), ("bvec", bvec), ("w2", w2)) + fused, op)
    check_tensors((("tap", tap), ("w1a", w1a), ("bvec", bvec), ("w2", w2)) + fused, tap.device,
                  op)
    return Cs, M, O


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == FWD_SOURCE:
        lib.abf_block_fwd.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        lib.abf_block_fwd.restype = i32
        lib.abf_block_fwd_route.argtypes = [i32] * 2
        lib.abf_block_fwd_route.restype = i32
        lib.abf_block_fwd_scratch_floats.argtypes = [i32] * 2
        lib.abf_block_fwd_scratch_floats.restype = ctypes.c_long
    else:
        lib.abf_block_bwd_blocks.argtypes = [i32] * 3
        lib.abf_block_bwd_blocks.restype = i32
        lib.abf_block_bwd_wgrad_chunks.argtypes = [i32] * 3
        lib.abf_block_bwd_wgrad_chunks.restype = i32
        lib.abf_block_bwd.argtypes = [ptr] * 19 + [i32] * 9 + [ptr]
        lib.abf_block_bwd.restype = i32
        lib.abf_block_bwd_route.argtypes = [i32] * 2
        lib.abf_block_bwd_route.restype = i32
        lib.abf_block_bwd_split_floats.argtypes = [i32] * 2
        lib.abf_block_bwd_split_floats.restype = ctypes.c_long
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it that starts on 16 bytes (the kernels read the
    maps as float4s where the widths allow; a view into a larger tensor may
    start anywhere)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def abf_block_fwd(tap, res, w1a, bvec, wxt, wy, zoff, w2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xf [B, D, T, M], out [B, D, T, O])``: the K5f kernel on CUDA
    tensors (counted in ``abf_block_fwd.launches``), ``abf_block_reference``
    on CPU tensors."""
    Cs, M, O = _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, "abf_block")
    if tap.device.type == "cpu":
        return abf_block_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2)
    if res is None:
        wxt = wy = zoff = None
    tap, res = _aligned(tap), _aligned(res)
    B, D, T, _ = tap.shape
    lib = _library(FWD_SOURCE)
    xf = torch.empty(B, D, T, M, device=tap.device, dtype=torch.float32)
    out = torch.empty(B, D, T, O, device=tap.device, dtype=torch.float32)
    # route "mma": w2 split into TF32 parts, in the tensor-core tile's layout
    n_split = lib.abf_block_fwd_scratch_floats(M, O)
    split = torch.empty(n_split, device=tap.device, dtype=torch.float32) if n_split else None
    with torch.cuda.device(tap.device):
        err = lib.abf_block_fwd(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2.data_ptr(), _ptr(split), xf.data_ptr(), out.data_ptr(), B, D,
            D if res is None else res.shape[1], T, Cs, M, O,
            torch.cuda.current_stream(tap.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_fwd launch failed: CUDA error {err}")
    abf_block_fwd.launches += 1
    return xf, out


abf_block_fwd.launches = 0

ROUTES = ("direct", "mma")


def abf_block_fwd_route(M: int, O: int) -> str:
    """The route K5f takes for M mid and O output channels, as its C entry
    chooses it: ``"mma"`` (xf pass, then the conv on K3f's tensor-core tile)
    or ``"direct"`` (xf and the conv in one f32 FMA pass).  Asks the built
    library, so it needs the CUDA toolkit."""
    return ROUTES[_library(FWD_SOURCE).abf_block_fwd_route(M, O)]


def abf_block_bwd_route(M: int, O: int) -> str:
    """The route of K5b's conv adjoint for M mid and O output channels, as its
    C entry chooses it: ``"mma"`` (K3f's tensor-core tile into a scratch dxf)
    or ``"direct"`` (formed in the pixel pass, f32 FMA).  Asks the built
    library, so it needs the CUDA toolkit."""
    return ROUTES[_library(BWD_SOURCE).abf_block_bwd_route(M, O)]


def abf_block_bwd(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout):
    """``(g_tap, g_res, dw1a [Cs, M], dbvec [M], dwxt [Cs, 2], dwy [M, 2],
    dzoff [2], dw2 [3, 3, M, O])`` for the incoming ``gxf [B, D, T, M]`` and
    ``gout [B, D, T, O]``, from the forward's inputs and its ``xf`` (without
    a residual ``g_res``, ``dwxt``, ``dwy`` and ``dzoff`` are ``None``): the
    K5b kernel on CUDA tensors (counted in ``abf_block_bwd.launches``; the
    parameter gradients are per-block partials added in a fixed order, so
    repeated runs give the same bits), ``abf_block_bwd_reference`` on CPU
    tensors."""
    Cs, M, O = _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, "abf_block")
    B, D, T, _ = tap.shape
    for name, t, c in (("xf", xf, M), ("gxf", gxf, M), ("gout", gout, O)):
        if tuple(t.shape) != (B, D, T, c):
            raise ValueError(f"{name} must be [{B}, {D}, {T}, {c}], got {tuple(t.shape)}")
    check_tensors((("xf", xf), ("gxf", gxf), ("gout", gout)), tap.device, "abf_block")
    if tap.device.type == "cpu":
        return abf_block_bwd_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout)
    fuse = res is not None
    if not fuse:
        wxt = wy = zoff = None
    tap, res, xf, gxf, gout = (_aligned(t) for t in (tap, res, xf, gxf, gout))
    Dp = res.shape[1] if fuse else D
    lib = _library(BWD_SOURCE)
    blocks = lib.abf_block_bwd_blocks(B, Dp, T)
    chunks = lib.abf_block_bwd_wgrad_chunks(M, O, B * D)
    dev = tap.device
    # route "mma": the adjoint (with g_xf added) goes through a scratch dxf,
    # and w2f split into TF32 parts
    n_split = lib.abf_block_bwd_split_floats(M, O)
    split = torch.empty(n_split, device=dev, dtype=torch.float32) if n_split else None
    dxf = torch.empty(B, D, T, M, device=dev, dtype=torch.float32) if n_split else None
    n = Cs * M + 3 * M + 2 * Cs + 2
    gtap = torch.empty_like(tap)
    gres = torch.empty_like(res) if fuse else None
    grads = torch.empty(n, device=dev, dtype=torch.float32)
    partial = torch.empty(blocks, n, device=dev, dtype=torch.float32)
    dw2 = torch.empty(3, 3, M, O, device=dev, dtype=torch.float32)
    wscratch = torch.empty(chunks, 9 * M * O, device=dev, dtype=torch.float32)
    w2f = _flip(w2)
    with torch.cuda.device(dev):
        err = lib.abf_block_bwd(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2f.data_ptr(), xf.data_ptr(), gxf.data_ptr(), gout.data_ptr(),
            gtap.data_ptr(), _ptr(gres), grads.data_ptr(), partial.data_ptr(), dw2.data_ptr(),
            wscratch.data_ptr(), _ptr(dxf), _ptr(split), B, D, Dp, T, Cs, M, O, blocks, chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_bwd launch failed: CUDA error {err}")
    abf_block_bwd.launches += 1
    dw1a = grads[:Cs * M].view(Cs, M)
    dbvec = grads[Cs * M:Cs * M + M]
    if not fuse:
        return gtap, None, dw1a, dbvec, None, None, None, dw2
    rest = grads[Cs * M + M:]
    return (gtap, gres, dw1a, dbvec, rest[:2 * Cs].view(Cs, 2),
            rest[2 * Cs:2 * Cs + 2 * M].view(M, 2), rest[2 * Cs + 2 * M:], dw2)


abf_block_bwd.launches = 0


class _ABFBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tap, res, w1a, bvec, wxt, wy, zoff, w2):
        xf, out = abf_block_fwd(tap, res, w1a, bvec, wxt, wy, zoff, w2)
        ctx.save_for_backward(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf)
        return xf, out

    @staticmethod
    @once_differentiable
    def backward(ctx, gxf, gout):
        # an unused xf (the last block's) comes back as a materialized zero
        return abf_block_bwd(*ctx.saved_tensors, gxf.contiguous(), gout.contiguous())


def abf_block(tap: torch.Tensor, res: Optional[torch.Tensor], w1a: torch.Tensor,
              bvec: torch.Tensor, wxt: Optional[torch.Tensor], wy: Optional[torch.Tensor],
              zoff: Optional[torch.Tensor], w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole ABF block (module docstring): ``(xf, out)``.  With ``res``
    ``None`` (no fuse) ``wxt``, ``wy`` and ``zoff`` are not used."""
    if res is None:
        wxt = wy = zoff = None
    return _ABFBlock.apply(tap, res, w1a, bvec, wxt, wy, zoff, w2)
