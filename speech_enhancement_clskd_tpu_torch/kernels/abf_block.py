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
  ``csrc/abf_block_bwd.cu``, or on bf16 those of ``csrc/abf_block_bf16.cu``
  (built at first use), or raise; nothing falls back.  On a CPU tensor they
  run ``abf_block_reference`` and ``abf_block_bwd_reference``.  Their
  ``launches`` counters count calls that launched the kernels (K5f's xf pass
  and conv, K5b's adjoint, pixel pass, reduction and dw2 passes count as
  one; the bf16 instantiation in ``launches_bf16``).

The wrappers run in the tap's dtype, float32 or bfloat16 (``kernels.
float_dtype``): the maps (tap, res, xf, the incoming gradients) and ``w1a``,
``wxt``, ``wy``, ``w2`` in that dtype, ``bvec`` and ``zoff`` always float32, as
``distill/abf.py`` hands them to the JAX kernel.  Outputs: ``xf`` and ``out``,
``g_tap`` and ``g_res`` in the tap's dtype; the backward's parameter
gradients float32 (their sums), which ``abf_block`` returns in the dtypes of
their inputs, as the JAX VJP casts them (``dw1a``, ``dwxt``, ``dwy``, ``dw2``
bf16 under bf16; ``dbvec``, ``dzoff`` float32).

On bf16 the plain versions round where the Pallas bodies round on bf16
operands (each dot multiplies bf16 by bf16 into float32 sums): the forward's
``xhat = bf16(tap @ w1a + bvec)``, the logits and ``z`` float32, the blend
``bf16(bf16(xhat * bf16(z0)) + bf16(y * bf16(z1)))`` (each product rounded
before the add: measured bit for bit against ``abf_block(...,
interpret=True)``, as the bf16 K4f's blend), the conv on bf16 ``xf`` and
``w2`` rounded once.  The backward: ``dxf`` the float32 adjoint of bf16
``g_out`` plus ``g_xf``; ``xhat`` recomputed and not rounded (the Pallas
backward does not round it); ``z``, ``dp``, ``g_xhat`` and ``g_y`` float32;
``g_tap = bf16(g_xhat) @ w1a^T + dp @ wxt^T`` and ``g_res`` rounded once;
``dw1a`` from ``bf16(g_xhat)``, ``dwxt`` and ``dwy`` from ``bf16(dp)``, ``dbvec``
and ``dzoff`` unrounded sums; ``dw2`` from bf16 ``xf`` and ``g_out``.

In float32 each kernel takes one of two routes by shape
(``abf_block_fwd_route``, ``abf_block_bwd_route``).  ``"mma"``: the 3x3 conv
(K5f's over xf; K5b's adjoint over g_out, into a scratch ``dxf``) on K3f's
tensor-core tile, f32 operands split into two TF32 parts each and three
products a pair ("3xTF32", within f32 rounding of an f32 sum).  ``"direct"``
(K5f: O < 8 or M < 4, the decoder's mask block; K5b: O < 4 or M < 8): the
conv in f32 FMA inside the kernel's own pass.  The 1x1 conv, the attention
and their gradients are f32 FMA; K5b's dw2 is K3w's split-TF32 reduction
(f32 FMA for O <= 8).

The bf16 routes, by shape (the rules stated once, here; the route
functions and ``csrc/abf_block_bf16.cu``'s ``route_of`` apply them):

- ``"fused"`` (``csrc/abf_block_bf16.cu``) where TMA takes every map (each
  on 16 bytes) and either M is a multiple of 8 up to 64, k is 1 or even,
  and Cs and O are multiples of 8 ("wide"), or the mask block's Cs <= 4,
  O = 2, k <= 2 with D a multiple of 8 ("narrow").  Every block of the
  block-config step takes it.  K5b: one persistent kernel forms the conv
  adjoint a 64-step tile at a time on the tensor cores (wgmma; on the
  narrow route ``mma.sync``, dw2 folded in) and consumes it from registers
  in the pixel pass, the 1x1 products on ``mma.sync``: no ``dxf`` reaches
  device memory; then the blocks' partials in block order and, wide, dw2
  on the bf16 K3w's wgmma route.  K5f: for O <= 64 one kernel forms xf in
  shared memory, writes it once and convolves it there on wgmma; for O >
  64 an xf pass on the tensor cores, then the conv over xf on the bf16
  K3f's wgmma tile (measured faster than forming xf again in each block of
  64 output channels); narrow, the xf pass and a conv that walks the freq
  rows with a ring of xf rows.
- Otherwise (other shapes, or a map off 16 bytes, which is copied onto 16
  bytes first) the earlier routes of ``csrc/abf_block_fwd.cu``/
  ``abf_block_bwd.cu``: K5f's xf pass, then the conv on the bf16 K3f's TMA
  and wgmma tile (``"wgmma"``: M and O multiples of 8, M <= 256) or its
  m16n8k16 tile (``"mma"``: the other shapes with O >= 8 and M >= 8), or
  the direct kernel on bf16 loads (``"direct"``); K5b's adjoint on the same
  tiles into a float32 scratch ``dxf`` (``"wgmma"`` or ``"mma"`` by the
  same test with O input channels) or in the pixel pass (``"direct"``), the
  pass on bf16 loads in float32 arithmetic, dw2 on the bf16 K3w's routes.

Each wrapper records the route it took in its ``route`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import BLEND_REL, SUM_REL, _build, aligned, check_tensors, float_dtype, on16, widened
from .conv3x3 import conv3x3_reference, conv3x3_wgrad_reference

FWD_SOURCE = "abf_block_fwd.cu"
BWD_SOURCE = "abf_block_bwd.cu"
BF16_SOURCE = "abf_block_bf16.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE, BF16_SOURCE)
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


def _rounding(dtype: torch.dtype):
    """``x -> x`` rounded to ``dtype`` and read back in float32 (bf16), or
    ``x`` itself (float32)."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(dtype).float()
    return lambda x: x


def abf_block_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2):
    """Plain PyTorch: ``(xf, out)`` in the tap's dtype, every intermediate in
    memory (the composition of ``_ref_block`` in
    ``tests/test_pallas_abf_block.py``), rounded where the Pallas body rounds
    on bf16 operands (module docstring)."""
    rnd = _rounding(tap.dtype)
    tapw = widened(tap)
    xf = rnd(tapw @ widened(w1a) + bvec)
    if res is not None:
        y = _upscale(widened(res), tap.shape[1])
        z = torch.sigmoid(tapw @ widened(wxt) + y @ widened(wy) + zoff)
        xf = rnd(rnd(xf * rnd(z[..., 0:1])) + rnd(y * rnd(z[..., 1:2])))
    xf = xf.to(tap.dtype)
    return xf, conv3x3_reference(xf, w2)


def abf_block_bwd_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout):
    """Plain PyTorch, the backward written out: ``(g_tap, g_res, dw1a, dbvec,
    dwxt, dwy, dzoff, dw2)`` for the incoming ``gxf``/``gout``, ``g_tap`` and
    ``g_res`` in the tap's dtype and the parameter gradients float32, rounded
    where the Pallas body rounds on bf16 operands (module docstring); without
    a residual ``g_res``, ``dwxt``, ``dwy`` and ``dzoff`` are ``None``."""
    Cs, M = w1a.shape
    dt = tap.dtype
    rnd = _rounding(dt)
    tapw, w1w = widened(tap), widened(w1a)
    dxf = widened(gxf) + conv3x3_reference(widened(gout), _flip(widened(w2)))
    dw2 = conv3x3_wgrad_reference(xf, gout)
    tap2 = tapw.reshape(-1, Cs)
    if res is None:
        g_xhat = dxf.reshape(-1, M)
        gtap = (rnd(g_xhat) @ w1w.T).reshape(tap.shape).to(dt)
        return gtap, None, tap2.T @ rnd(g_xhat), g_xhat.sum(0), None, None, None, dw2
    B, D, T, _ = tap.shape
    Dp = res.shape[1]
    y = _upscale(widened(res), D)
    wxw, wyw = widened(wxt), widened(wy)
    xhat = tapw @ w1w + bvec
    z = torch.sigmoid(tapw @ wxw + y @ wyw + zoff)
    dp = z * (1 - z) * torch.stack([(dxf * xhat).sum(-1), (dxf * y).sum(-1)], dim=-1)
    g_xhat = dxf * z[..., 0:1]
    g_y = dxf * z[..., 1:2] + dp @ wyw.T
    gtap = (rnd(g_xhat) @ w1w.T + dp @ wxw.T).to(dt)
    gres = g_y.reshape(B, Dp, D // Dp, T, M).sum(dim=2).to(dt)
    g_xhat2, dp2 = g_xhat.reshape(-1, M), dp.reshape(-1, 2)
    return (gtap, gres, tap2.T @ rnd(g_xhat2), g_xhat2.sum(0), tap2.T @ rnd(dp2),
            y.reshape(-1, M).T @ rnd(dp2), dp2.sum(0), dw2)


def abf_block_bf16_scales(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout) -> dict:
    """How far the bf16 kernels' map outputs may lie from the plain
    versions' on the same inputs (``xf`` the kernel's, which both backward
    passes take), for ``kernels.bf16_check(got, want, scale, rel)``: one bf16
    spacing plus ``rel * scale``.  ``{name: (scale, rel)}`` for ``xf``,
    ``out``, ``g_tap`` and ``g_res`` (``None`` without a residual), ``scale``
    (float32) the sum of the magnitudes of the terms that form each element.
    ``rel`` is ``SUM_REL`` where both sides sum float32 terms in another
    order and round once (``out``; ``g_res``, from float32 ``dxf`` and
    ``dp``), and ``BLEND_REL`` where a value rounded to bf16 inside the sum
    may round the other way and carry one bf16 spacing through its product
    (``xhat`` and ``z`` in ``xf``'s blend, as in K4f's; ``bf16(g_xhat)`` in
    ``g_tap``)."""
    absw = (lambda t: widened(t).abs())
    D = tap.shape[1]
    tapw, w1w = widened(tap), widened(w1a)
    w1_abs = w1w.abs()
    dot = tapw.abs() @ w1_abs + bvec.abs()
    out_scale = conv3x3_reference(absw(xf), absw(w2))
    dxf = absw(gxf) + conv3x3_reference(absw(gout), _flip(absw(w2)))
    if res is None:
        return {"xf": (dot, BLEND_REL), "out": (out_scale, SUM_REL),
                "g_tap": (dxf @ w1_abs.T, BLEND_REL), "g_res": None}
    y = _upscale(widened(res), D)
    xhat = tapw @ w1w + bvec
    z = torch.sigmoid(tapw @ widened(wxt) + y @ widened(wy) + zoff)
    z0, z1 = z[..., 0:1], z[..., 1:2]
    # dp's terms: dz's, through z (1 - z), whose float32 error is z's (1 - z
    # cancels where z nears 1)
    dp = z * torch.stack([(dxf * xhat.abs()).sum(-1), (dxf * y.abs()).sum(-1)], -1)
    g_tap = (dxf * z0) @ w1_abs.T + dp @ absw(wxt).T
    g_y = dxf * z1 + dp @ absw(wy).T
    B, _, T, M = g_y.shape
    g_res = g_y.reshape(B, res.shape[1], D // res.shape[1], T, M).sum(dim=2)
    return {"xf": ((xhat.abs() + dot) * z0 + y.abs() * z1, BLEND_REL),
            "out": (out_scale, SUM_REL), "g_tap": (g_tap, BLEND_REL), "g_res": (g_res, SUM_REL)}


def _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, op: str) -> Tuple[int, int, int]:
    """Raise unless the inputs fit the kernels: the maps and weights in the
    tap's dtype (float32 or bfloat16), ``bvec`` and ``zoff`` float32;
    ``(Cs, M, O)``."""
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
    dtype = float_dtype(tap, op)
    fused = (("res", res), ("wxt", wxt), ("wy", wy)) if res is not None else ()
    check_tensors((("tap", tap), ("w1a", w1a), ("w2", w2)) + fused, tap.device, op, dtype)
    check_tensors((("bvec", bvec), ("zoff", zoff if res is not None else None)), tap.device, op)
    return Cs, M, O


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == BF16_SOURCE:
        lib.abf_block_bf16_route.argtypes = [i32] * 6
        lib.abf_block_bf16_route.restype = i32
        lib.abf_block_bf16_bwd_blocks.argtypes = [i32] * 5
        lib.abf_block_bf16_bwd_blocks.restype = i32
        lib.abf_block_bf16_bwd_floats.argtypes = [i32] * 4
        lib.abf_block_bf16_bwd_floats.restype = i32
        lib.abf_block_bf16_bwd.argtypes = [ptr] * 17 + [i32] * 9 + [ptr]
        lib.abf_block_bf16_bwd.restype = i32
        lib.abf_block_bf16_fwd.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        lib.abf_block_bf16_fwd.restype = i32
        lib.abf_block_bf16_fwd_scratch_elems.argtypes = [i32] * 2
        lib.abf_block_bf16_fwd_scratch_elems.restype = ctypes.c_long
        return lib
    if source == FWD_SOURCE:
        for fn in (lib.abf_block_fwd, lib.abf_block_fwd_bf16):
            fn.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
            fn.restype = i32
        routes, sizes = ("abf_block_fwd_route", "abf_block_fwd_bf16_route"), (
            "abf_block_fwd_scratch_floats", "abf_block_fwd_bf16_scratch_elems")
    else:
        lib.abf_block_bwd_blocks.argtypes = [i32] * 3
        lib.abf_block_bwd_blocks.restype = i32
        lib.abf_block_bwd_wgrad_chunks.argtypes = [i32] * 3
        lib.abf_block_bwd_wgrad_chunks.restype = i32
        for fn in (lib.abf_block_bwd, lib.abf_block_bwd_bf16):
            fn.argtypes = [ptr] * 19 + [i32] * 9 + [ptr]
            fn.restype = i32
        routes, sizes = ("abf_block_bwd_route", "abf_block_bwd_bf16_route"), (
            "abf_block_bwd_split_floats", "abf_block_bwd_bf16_pack_elems")
    for name in routes:
        getattr(lib, name).argtypes = [i32] * 2
        getattr(lib, name).restype = i32
    for name in sizes:
        getattr(lib, name).argtypes = [i32] * 2
        getattr(lib, name).restype = ctypes.c_long
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def abf_block_fwd(tap, res, w1a, bvec, wxt, wy, zoff, w2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xf [B, D, T, M], out [B, D, T, O])`` in the tap's dtype: the K5f
    kernel on CUDA tensors (counted in ``abf_block_fwd.launches``, the bf16
    instantiation in ``abf_block_fwd.launches_bf16``), ``abf_block_reference``
    on CPU tensors."""
    Cs, M, O = _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, "abf_block")
    if tap.device.type == "cpu":
        return abf_block_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2)
    if res is None:
        wxt = wy = zoff = None
    B, D, T, _ = tap.shape
    dt = tap.dtype
    bf16 = dt == torch.bfloat16
    Dp = D if res is None else res.shape[1]
    if bf16 and on16(tap, res) and _bf16_fused_route(Cs, D, M, O, D // Dp, res is not None):
        return _fwd_fused(tap, res, w1a, bvec, wxt, wy, zoff, w2)
    abf_block_fwd.route = abf_block_fwd_route(M, O, dt)
    tap, res = aligned(tap), aligned(res)
    lib = _library(FWD_SOURCE)
    xf = torch.empty(B, D, T, M, device=tap.device, dtype=dt)
    out = torch.empty(B, D, T, O, device=tap.device, dtype=dt)
    # route "mma": w2 split into TF32 parts (float32) or packed (bf16), in the
    # tensor-core tile's layout
    n_scratch = (lib.abf_block_fwd_bf16_scratch_elems if bf16
                 else lib.abf_block_fwd_scratch_floats)(M, O)
    scratch = torch.empty(n_scratch, device=tap.device, dtype=dt) if n_scratch else None
    with torch.cuda.device(tap.device):
        err = (lib.abf_block_fwd_bf16 if bf16 else lib.abf_block_fwd)(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2.data_ptr(), _ptr(scratch), xf.data_ptr(), out.data_ptr(), B, D,
            D if res is None else res.shape[1], T, Cs, M, O,
            torch.cuda.current_stream(tap.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_fwd launch failed ({dt}): CUDA error {err}")
    if bf16:
        abf_block_fwd.launches_bf16 += 1
    else:
        abf_block_fwd.launches += 1
    return xf, out


abf_block_fwd.launches = 0
abf_block_fwd.launches_bf16 = 0
abf_block_fwd.route = None


def _fwd_fused(tap, res, w1a, bvec, wxt, wy, zoff, w2):
    """The bf16 K5f on route ``"fused"`` (``csrc/abf_block_bf16.cu``; its
    kernels by shape as the module's docstring states)."""
    B, D, T, Cs = tap.shape
    M, O = w2.shape[2], w2.shape[3]
    lib = _library(BF16_SOURCE)
    xf = torch.empty(B, D, T, M, device=tap.device, dtype=tap.dtype)
    out = torch.empty(B, D, T, O, device=tap.device, dtype=tap.dtype)
    scratch = torch.empty(lib.abf_block_bf16_fwd_scratch_elems(M, O), device=tap.device,
                          dtype=tap.dtype)
    with torch.cuda.device(tap.device):
        err = lib.abf_block_bf16_fwd(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2.data_ptr(), scratch.data_ptr(), xf.data_ptr(), out.data_ptr(), B, D,
            D if res is None else res.shape[1], T, Cs, M, O,
            torch.cuda.current_stream(tap.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_fwd launch failed (bfloat16, route fused): CUDA error {err}")
    abf_block_fwd.launches_bf16 += 1
    abf_block_fwd.route = "fused"
    return xf, out


ROUTES = ("direct", "mma", "wgmma", "fused")


def abf_block_fwd_route(M: int, O: int, dtype: torch.dtype = torch.float32,
                        Cs: Optional[int] = None, D: Optional[int] = None, k: int = 1,
                        fuse: bool = True, aligned: bool = True) -> str:
    """The route K5f takes for Cs tap, M mid and O output channels (k-fold
    ``k``, with or without the fuse; ``aligned``: every map on 16 bytes) in
    ``dtype``, as its C entries choose it.  In float32 ``"mma"`` or
    ``"direct"`` by M and O; in bf16 ``"fused"`` where Cs and D are given
    and the shape takes it, else ``"wgmma"``, ``"mma"`` or ``"direct"`` by M
    and O (the rules in the module's docstring).  Asks the built library, so
    it needs the CUDA toolkit."""
    if dtype == torch.bfloat16 and aligned and _bf16_fused_route(Cs, D, M, O, k, fuse):
        return "fused"
    lib = _library(FWD_SOURCE)
    if dtype == torch.bfloat16:
        return ROUTES[lib.abf_block_fwd_bf16_route(M, O)]
    return ROUTES[lib.abf_block_fwd_route(M, O)]


def _bf16_fused_route(Cs: Optional[int], D: Optional[int], M: int, O: int, k: int,
                      fuse: bool) -> int:
    """``csrc/abf_block_bf16.cu``'s route of a shape, for K5f and K5b alike:
    1 wide, 2 narrow (the mask block), 0 neither (Cs or D not given)."""
    if Cs is None or D is None:
        return 0
    return _library(BF16_SOURCE).abf_block_bf16_route(Cs, M, O, k if fuse else 1, int(fuse), D)


def abf_block_bwd_route(M: int, O: int, dtype: torch.dtype = torch.float32,
                        Cs: Optional[int] = None, D: Optional[int] = None, k: int = 1,
                        fuse: bool = True, aligned: bool = True) -> str:
    """The route K5b takes, as ``abf_block_fwd_route`` for K5f: in bf16
    ``"fused"`` where Cs and D are given and the shape takes it, else the
    route of its conv adjoint into a scratch dxf, ``"wgmma"``, ``"mma"`` or
    ``"direct"`` (formed in the pixel pass) by M and O; in float32 ``"mma"``
    or ``"direct"``.  Asks the built library, so it needs the CUDA
    toolkit."""
    if dtype == torch.bfloat16:
        if aligned and _bf16_fused_route(Cs, D, M, O, k, fuse):
            return "fused"
        return ROUTES[_library(BWD_SOURCE).abf_block_bwd_bf16_route(M, O)]
    return ROUTES[_library(BWD_SOURCE).abf_block_bwd_route(M, O)]


def abf_block_bwd(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout):
    """``(g_tap, g_res, dw1a [Cs, M], dbvec [M], dwxt [Cs, 2], dwy [M, 2],
    dzoff [2], dw2 [3, 3, M, O])`` for the incoming ``gxf [B, D, T, M]`` and
    ``gout [B, D, T, O]``, from the forward's inputs and its ``xf`` (without
    a residual ``g_res``, ``dwxt``, ``dwy`` and ``dzoff`` are ``None``);
    ``g_tap`` and ``g_res`` in the tap's dtype, the parameter gradients
    float32: the K5b kernel on CUDA tensors (counted in
    ``abf_block_bwd.launches``, the bf16 instantiation in
    ``abf_block_bwd.launches_bf16``; the parameter gradients are per-block
    partials added in a fixed order, so repeated runs give the same bits),
    ``abf_block_bwd_reference`` on CPU tensors."""
    Cs, M, O = _check_inputs(tap, res, w1a, bvec, wxt, wy, zoff, w2, "abf_block")
    B, D, T, _ = tap.shape
    for name, t, c in (("xf", xf, M), ("gxf", gxf, M), ("gout", gout, O)):
        if tuple(t.shape) != (B, D, T, c):
            raise ValueError(f"{name} must be [{B}, {D}, {T}, {c}], got {tuple(t.shape)}")
    check_tensors((("xf", xf), ("gxf", gxf), ("gout", gout)), tap.device, "abf_block", tap.dtype)
    if tap.device.type == "cpu":
        return abf_block_bwd_reference(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout)
    fuse = res is not None
    if not fuse:
        wxt = wy = zoff = None
    Dp = res.shape[1] if fuse else D
    dt = tap.dtype
    bf16 = dt == torch.bfloat16
    if (bf16 and on16(tap, res, xf, gxf, gout)
            and _bf16_fused_route(Cs, D, M, O, D // Dp, fuse)):
        return _bwd_fused(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout)
    abf_block_bwd.route = abf_block_bwd_route(M, O, dt)
    tap, res, xf, gxf, gout = (aligned(t) for t in (tap, res, xf, gxf, gout))
    lib = _library(BWD_SOURCE)
    blocks = lib.abf_block_bwd_blocks(B, Dp, T)
    chunks = lib.abf_block_bwd_wgrad_chunks(M, O, B * D)
    dev = tap.device
    # route "mma": the adjoint (with g_xf added) goes through a float32
    # scratch dxf, and w2f split into TF32 parts (float32) or packed (bf16)
    n_split = (lib.abf_block_bwd_bf16_pack_elems if bf16
               else lib.abf_block_bwd_split_floats)(M, O)
    split = torch.empty(n_split, device=dev, dtype=dt) if n_split else None
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
        err = (lib.abf_block_bwd_bf16 if bf16 else lib.abf_block_bwd)(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2f.data_ptr(), xf.data_ptr(), gxf.data_ptr(), gout.data_ptr(),
            gtap.data_ptr(), _ptr(gres), grads.data_ptr(), partial.data_ptr(), dw2.data_ptr(),
            wscratch.data_ptr(), _ptr(dxf), _ptr(split), B, D, Dp, T, Cs, M, O, blocks, chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_bwd launch failed ({dt}): CUDA error {err}")
    if bf16:
        abf_block_bwd.launches_bf16 += 1
    else:
        abf_block_bwd.launches += 1
    return (gtap, gres) + _grads_out(grads, Cs, M, fuse) + (dw2,)


abf_block_bwd.launches = 0
abf_block_bwd.launches_bf16 = 0
abf_block_bwd.route = None


def _grads_out(grads, Cs, M, fuse):
    """``(dw1a, dbvec, dwxt, dwy, dzoff)`` views of the reduced partial
    ``[dw1a | dbvec | dwxt | dwy | dzoff ...]`` (without a residual the
    last three ``None``)."""
    dw1a = grads[:Cs * M].view(Cs, M)
    dbvec = grads[Cs * M:Cs * M + M]
    if not fuse:
        return dw1a, dbvec, None, None, None
    rest = grads[Cs * M + M:]
    return (dw1a, dbvec, rest[:2 * Cs].view(Cs, 2), rest[2 * Cs:2 * Cs + 2 * M].view(M, 2),
            rest[2 * Cs + 2 * M:2 * Cs + 2 * M + 2])


def _bwd_fused(tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, gxf, gout):
    """The bf16 K5b on route ``"fused"`` (``csrc/abf_block_bf16.cu``): one
    kernel for the adjoint and the pixel pass (no dxf scratch), the blocks'
    partials added in order, then dw2 (the bf16 K3w's wgmma route; on the
    narrow route folded into the kernel's partials)."""
    B, D, T, Cs = tap.shape
    M, O = w2.shape[2], w2.shape[3]
    fuse = res is not None
    Dp = res.shape[1] if fuse else D
    k = D // Dp
    dev = tap.device
    lib = _library(BF16_SOURCE)
    narrow = lib.abf_block_bf16_route(Cs, M, O, k, int(fuse), D) == 2
    blocks = lib.abf_block_bf16_bwd_blocks(B, D, k, T, int(fuse))
    n = lib.abf_block_bf16_bwd_floats(Cs, M, O, int(narrow))
    chunks = 1 if narrow else _library(BWD_SOURCE).abf_block_bwd_wgrad_chunks(M, O, B * D)
    gtap = torch.empty_like(tap)
    gres = torch.empty_like(res) if fuse else None
    grads = torch.empty(n, device=dev, dtype=torch.float32)
    partial = torch.empty(blocks, n, device=dev, dtype=torch.float32)
    # the narrow route folds dw2 into the partials
    dw2 = None if narrow else torch.empty(3, 3, M, O, device=dev, dtype=torch.float32)
    wscratch = None if narrow else torch.empty(chunks, 9 * M * O, device=dev,
                                               dtype=torch.float32)
    w2f = _flip(w2)
    with torch.cuda.device(dev):
        err = lib.abf_block_bf16_bwd(
            tap.data_ptr(), _ptr(res), w1a.data_ptr(), bvec.data_ptr(), _ptr(wxt), _ptr(wy),
            _ptr(zoff), w2f.data_ptr(), xf.data_ptr(), gxf.data_ptr(), gout.data_ptr(),
            gtap.data_ptr(), _ptr(gres), grads.data_ptr(), partial.data_ptr(), _ptr(dw2),
            _ptr(wscratch), B, D, Dp, T, Cs, M, O, blocks, chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"abf_block_bwd launch failed (bfloat16, route fused): CUDA error {err}")
    abf_block_bwd.launches_bf16 += 1
    abf_block_bwd.route = "fused"
    if narrow:
        dw2 = grads[Cs * M + 3 * M + 2 * Cs + 2:].view(3, 3, M, O)
    return (gtap, gres) + _grads_out(grads, Cs, M, fuse) + (dw2,)


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
        saved = ctx.saved_tensors
        grads = abf_block_bwd(*saved, gxf.contiguous(), gout.contiguous())
        # the parameter gradients' float32 sums in their inputs' dtypes, as
        # the JAX VJP casts them
        return tuple(g if g is None or x is None else g.to(x.dtype)
                     for g, x in zip(grads, saved[:8]))


def abf_block(tap: torch.Tensor, res: Optional[torch.Tensor], w1a: torch.Tensor,
              bvec: torch.Tensor, wxt: Optional[torch.Tensor], wy: Optional[torch.Tensor],
              zoff: Optional[torch.Tensor], w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole ABF block (module docstring): ``(xf, out)``.  With ``res``
    ``None`` (no fuse) ``wxt``, ``wy`` and ``zoff`` are not used."""
    if res is None:
        wxt = wy = zoff = None
    return _ABFBlock.apply(tap, res, w1a, bvec, wxt, wy, zoff, w2)
