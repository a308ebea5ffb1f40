#!/usr/bin/env python3
"""Times the redesigned kernels of one source tree on one NVIDIA GPU, so that
two trees (a parent commit unpacked beside this one, and this one) can be
compared in one call on one card, in turns: parent, change, change, parent.

    python3 scripts/kernel_pair_timing.py --root DIR --label NAME [--out FILE]

Imports ``speech_enhancement_clskd_tpu_torch`` from ``--root`` (the tree to
time; this script's own tree by default), builds its kernels there, and
prints one JSON line per shape, then writes them all to ``--out``:

- K1b (``lstm_seq_bwd``) at the spkd step's student LSTM on 33 s clips
  (T=5283, N=32, H=32), the clskd step's (T=483, N=64, H=32) and the
  teacher's width (T=483, N=64, H=128; no main path trains it), beside the
  backward of cuDNN's ``torch.nn.LSTM`` (f32, TF32 off), and a hash of its
  outputs' bits (the forward's y and c come from the tree's own K1f);
- K3f (``conv3x3_fwd``) at phase 8's reference conv (x [32, 64, 483, 64]
  -> 64) and the deepest blocks' (x [32, 4, 483, 64] -> 256);
- K3w (``conv3x3_wgrad``) at each distinct weight-gradient shape of the
  kernel-config step (x [32, D, 483, 64], g [32, D, 483, O]), beside
  ``torch.nn.grad.conv2d_weight`` (TF32 off);
- K5f (``abf_block_fwd``) and K5b (``abf_block_bwd``) at each distinct block
  shape of the block-config step (``chip_smoke.STEP_BLOCKS``: B=32, T=483,
  M=64), each with a hash of its outputs' bits (K5b's xf from the tree's
  own K5f);
- the bf16 K3f (``conv3x3_fwd`` on bf16 maps) at each distinct (D, C, O)
  of the kernel-config step's forwards (B=32, T=483, C=64) and of their dx
  passes (C and O swapped), and the bf16 K3w (``conv3x3_wgrad``) at each
  forward's (D, C, O), each with the route its tree reports, a hash of its
  output's bits, and cuDNN's bf16 ``F.conv2d`` / ``conv2d_weight`` on the
  same inputs;
- the bf16 K5f and K5b at each block of ``chip_smoke.STEP_BLOCKS`` (maps and
  weights in bf16, bvec and zoff float32), with hashes of their outputs and
  the route each took where the tree records it (``abf_block_fwd.route``,
  ``abf_block_bwd.route``);
- the bf16 K4f and K4b (``attention_fuse_fwd`` / ``attention_fuse_bwd`` on
  bf16 maps) at each distinct fuse of the kernel-config step (x [32, D,
  483, 64] with the residual at D / 2, ``chip_smoke.STEP_FUSE_D``), beside
  their bytes bounds (this script's own tree's ``chip_smoke.py``), with
  hashes of their outputs' bits;
- K2 (``gram_pair_fwd``) at B in {8, 16, 32, 64} x 528,000 columns (the
  spkd step's 33 s waveforms), with ``gram_times`` of this script's own
  tree's ``chip_smoke.py`` (loaded by path, so both trees are timed with the
  same code): the profiler's device time of both passes and of each, CUDA
  events and host time a call, L2 flushed between launches where the inputs
  fit in it (B = 8), beside two ``torch.mm(Z, Z.T)`` (TF32 off), with a hash
  of the output's bits; then a hash of the Grams' bits at each shape of
  ``chip_smoke.GRAM_CASES`` (phase 12's), on phase 12's inputs;
- the bf16 K2 (``gram_pair_fwd`` on bf16 inputs) at B in {8, 16, 32, 64} x
  528,000 columns, timed as K2, beside its bytes bound (and its share of the
  time) and cuBLAS's bf16 ``torch.mm(Z, Z.T, out_dtype=torch.float32)``
  pair, with a hash of the output's bits and whether a second call gave the
  same bits.

Except K2's device times, each time is CUDA events over repeated launches
after a warm-up; inputs come from seeded generators, so both trees see the
same data.  ``--kernels`` names the groups to time (``k1b k3f k3w k5 k2
bf16_conv bf16_k5 bf16_k4 bf16_k2``; all by default).  Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

K1B_SHAPES = [(5283, 32, 32), (483, 64, 32), (483, 64, 128)]
# (D, C, O) of the kernel-config step's weight gradients, at batch 32, T=483
K3W_SHAPES = [(4, 64, 256), (8, 64, 256), (16, 64, 256), (32, 64, 128), (64, 64, 64),
              (128, 64, 32), (256, 64, 2)]
# (D, C, O) of K3f at batch 32, T=483
K3F_SHAPES = [(64, 64, 64), (4, 64, 256)]
# (fuse, D, Cs, O) of the block-config step's distinct blocks (B=32, T=483,
# M=64, k=2 where a block fuses), as chip_smoke.STEP_BLOCKS
K5_SHAPES = [(False, 4, 64, 256), (True, 8, 64, 256), (True, 16, 64, 256), (True, 32, 32, 128),
             (True, 64, 16, 64), (True, 128, 8, 32), (False, 8, 64, 256), (True, 256, 2, 2)]
# (D, C, O) of the bf16 K3f's forwards at batch 32, T=483 (the dx passes
# swap C and O; the weight gradients run at the forwards' shapes)
BF16_CONV_SHAPES = [(4, 64, 256), (8, 64, 256), (16, 64, 256), (32, 64, 128), (64, 64, 64),
                    (128, 64, 32), (256, 64, 2)]
# K2's batches on the spkd step's 33 s waveforms
K2_BATCHES = [8, 16, 32, 64]
K2_COLUMNS = 528000


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1b(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_bwd
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    for T, N, H in K1B_SHAPES:
        g = torch.Generator().manual_seed(2000 * H + N)
        xw = torch.randn(T, N, 4 * H, generator=g).cuda()
        w_hh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5).cuda()
        dy = torch.randn(T, N, H, generator=g).cuda()
        with torch.no_grad():
            y, c = lstm_seq(xw, w_hh)
        ms = _time_ms(lambda: lstm_seq_bwd(xw, w_hh, y, c, dy), 20)
        # the bits of dxw and dW_hh, to see whether two trees compute the same
        bits = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                       for t in lstm_seq_bwd(xw, w_hh, y, c, dy))).hexdigest()
        lib = torch.nn.LSTM(4 * H, H).cuda()
        with float32_math():
            with torch.no_grad():
                lib.weight_ih_l0.copy_(torch.eye(4 * H))
                lib.weight_hh_l0.copy_(w_hh.t())
                lib.bias_ih_l0.zero_()
                lib.bias_hh_l0.zero_()
            x_in = xw.clone().requires_grad_(True)
            lib_y = lib(x_in)[0]
            library_ms = _time_ms(lambda: torch.autograd.grad(
                lib_y, (x_in, lib.weight_hh_l0), dy, retain_graph=True), 20)
        emit(kernel="lstm_seq_bwd", T=T, N=N, H=H, ms=ms, library_ms=library_ms,
             sha256_dxw_dw=bits[:16])


def k3w(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_wgrad
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    for D, C, O in K3W_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(D + C + O)
        x = torch.randn(32, D, 483, C, device="cuda", generator=g)
        gy = torch.randn(32, D, 483, O, device="cuda", generator=g)
        ms = _time_ms(lambda: conv3x3_wgrad(x, gy), 10)
        with float32_math():
            library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (O, C, 3, 3), gy.permute(0, 3, 1, 2), padding=1), 5)
        emit(kernel="conv3x3_wgrad", B=32, D=D, T=483, C=C, O=O, ms=ms, library_ms=library_ms)
        del x, gy
        torch.cuda.empty_cache()


def k3f(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd

    for D, C, O in K3F_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(D + C + O)
        x = torch.randn(32, D, 483, C, device="cuda", generator=g)
        w = torch.randn(3, 3, C, O, device="cuda", generator=g) / (3 * C ** 0.5)
        ms = _time_ms(lambda: conv3x3_fwd(x, w), 10)
        emit(kernel="conv3x3_fwd", B=32, D=D, T=483, C=C, O=O, ms=ms,
             sha256_out=_bits(conv3x3_fwd(x, w)))
        del x
        torch.cuda.empty_cache()


def _bits(*tensors) -> str:
    """A hash of the tensors' bits (``None`` skipped; bf16 as its bytes)."""
    import torch

    return hashlib.sha256(b"".join(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
                                   for t in tensors if t is not None)).hexdigest()[:16]


def k5(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd

    B, T, M = 32, 483, 64
    for fuse, D, Cs, O in K5_SHAPES:
        k = 2 if fuse else 1
        g = torch.Generator(device="cuda").manual_seed(B * D + k + Cs + O)

        def r(*shape, scale=1.0):
            return scale * torch.randn(*shape, device="cuda", generator=g)

        kw = dict(tap=r(B, D, T, Cs), res=r(B, D // k, T, M) if fuse else None,
                  w1a=r(Cs, M, scale=Cs ** -0.5), bvec=r(M, scale=0.2), wxt=r(Cs, 2, scale=0.3),
                  wy=r(M, 2, scale=0.3), zoff=r(2, scale=0.1),
                  w2=r(3, 3, M, O, scale=1 / (3 * M ** 0.5)))
        gxf, gout = r(B, D, T, M), r(B, D, T, O)
        shape = dict(fuse=fuse, B=B, D=D, k=k, T=T, Cs=Cs, M=M, O=O)
        ms = _time_ms(lambda: abf_block_fwd(**kw), 5)
        xf, out = abf_block_fwd(**kw)
        emit(kernel="abf_block_fwd", **shape, ms=ms, sha256_xf_out=_bits(xf, out))
        del out
        ms = _time_ms(lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout), 5)
        emit(kernel="abf_block_bwd", **shape, ms=ms,
             sha256_grads=_bits(*abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)))
        del kw, gxf, gout, xf
        torch.cuda.empty_cache()


def bf16_conv(emit) -> None:
    import torch
    import torch.nn.functional as F

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
        conv3x3_fwd,
        conv3x3_fwd_route,
        conv3x3_wgrad,
        conv3x3_wgrad_route,
    )

    B, T = 32, 483
    for D, C, O in BF16_CONV_SHAPES:
        for pass_, (ci, co) in (("fwd", (C, O)), ("dx", (O, C))):
            g = torch.Generator(device="cuda").manual_seed(D + ci + 3 * co)
            x = torch.randn(B, D, T, ci, device="cuda", generator=g).bfloat16()
            w = (torch.randn(3, 3, ci, co, device="cuda", generator=g) / (3 * ci ** 0.5)).bfloat16()
            shape = dict(B=B, D=D, T=T, C=ci, O=co)
            ms = _time_ms(lambda: conv3x3_fwd(x, w), 20)
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
            library_ms = _time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), 20)
            emit(kernel="conv3x3_fwd_bf16", pass_=pass_, **shape,
                 route=conv3x3_fwd_route(ci, co, torch.bfloat16), ms=ms, library_ms=library_ms,
                 sha256_out=_bits(conv3x3_fwd(x, w)))
            if pass_ == "fwd":
                gy = torch.randn(B, D, T, co, device="cuda", generator=g).bfloat16()
                ms = _time_ms(lambda: conv3x3_wgrad(x, gy), 20)
                library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, (co, ci, 3, 3), gy.permute(0, 3, 1, 2), padding=1), 20)
                emit(kernel="conv3x3_wgrad_bf16", **shape,
                     route=conv3x3_wgrad_route(ci, co, torch.bfloat16), ms=ms,
                     library_ms=library_ms, sha256_dw=_bits(conv3x3_wgrad(x, gy)))
                del gy
            del x, w
            torch.cuda.empty_cache()


def bf16_k5(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd

    B, T, M = 32, 483, 64
    for fuse, D, Cs, O in K5_SHAPES:
        k = 2 if fuse else 1
        g = torch.Generator(device="cuda").manual_seed(B * D + k + Cs + O + 1)

        def r(*shape, scale=1.0, dtype=torch.bfloat16):
            return (scale * torch.randn(*shape, device="cuda", generator=g)).to(dtype)

        kw = dict(tap=r(B, D, T, Cs), res=r(B, D // k, T, M) if fuse else None,
                  w1a=r(Cs, M, scale=Cs ** -0.5), bvec=r(M, scale=0.2, dtype=torch.float32),
                  wxt=r(Cs, 2, scale=0.3), wy=r(M, 2, scale=0.3),
                  zoff=r(2, scale=0.1, dtype=torch.float32),
                  w2=r(3, 3, M, O, scale=1 / (3 * M ** 0.5)))
        gxf, gout = r(B, D, T, M), r(B, D, T, O)
        shape = dict(fuse=fuse, B=B, D=D, k=k, T=T, Cs=Cs, M=M, O=O)
        ms = _time_ms(lambda: abf_block_fwd(**kw), 10)
        xf, out = abf_block_fwd(**kw)
        emit(kernel="abf_block_fwd_bf16", **shape, ms=ms, route=getattr(abf_block_fwd, "route", None),
             sha256_xf_out=_bits(xf, out))
        del out
        ms = _time_ms(lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout), 10)
        grads = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
        emit(kernel="abf_block_bwd_bf16", **shape, ms=ms,
             route=getattr(abf_block_bwd, "route", None), sha256_grads=_bits(*grads))
        del grads
        del kw, gxf, gout, xf
        torch.cuda.empty_cache()


def _smoke():
    """This script's own tree's ``chip_smoke.py``, loaded by path (so both
    trees are timed and bounded with the same code)."""
    spec = importlib.util.spec_from_file_location("pair_timing_chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_k4(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_fwd,
    )

    smoke = _smoke()
    B, T, C = 32, 483, 64
    for D in dict.fromkeys(smoke.STEP_FUSE_D):
        Dp = D // 2
        g = torch.Generator(device="cuda").manual_seed(B * D + C)
        x, res, wx, wy, bias, gy = (t.bfloat16() for t in (
            torch.randn(B, D, T, C, device="cuda", generator=g),
            torch.randn(B, Dp, T, C, device="cuda", generator=g),
            0.3 * torch.randn(C, 2, device="cuda", generator=g),
            0.3 * torch.randn(C, 2, device="cuda", generator=g),
            0.1 * torch.randn(2, device="cuda", generator=g),
            torch.randn(B, D, T, C, device="cuda", generator=g)))
        shape = dict(B=B, D=D, Dp=Dp, T=T, C=C, launches=smoke.STEP_FUSE_D.count(D))
        fwd_bound, bwd_bound = smoke._bf16_fuse_bounds(B, D, Dp, T, C)
        ms = _time_ms(lambda: attention_fuse_fwd(x, res, wx, wy, bias), 20)
        out, z = attention_fuse_fwd(x, res, wx, wy, bias)
        emit(kernel="attfuse_fwd_bf16", **shape, ms=ms, bound_ms=fwd_bound[0],
             sha256_out_z=_bits(out, z))
        ms = _time_ms(lambda: attention_fuse_bwd(x, res, z, gy, wx, wy), 20)
        emit(kernel="attfuse_bwd_bf16", **shape, ms=ms, bound_ms=bwd_bound[0],
             sha256_grads=_bits(*attention_fuse_bwd(x, res, z, gy, wx, wy)))
        del x, res, gy, out, z
        torch.cuda.empty_cache()


def k2(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    timing = _smoke()
    for B in K2_BATCHES:
        g = torch.Generator(device="cuda").manual_seed(B)
        s = (0.3 * torch.randn(B, K2_COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        t = (0.3 * torch.randn(B, K2_COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        nbytes = 4 * B * 2 * K2_COLUMNS
        times = timing.gram_times(lambda: gram_pair_fwd(s, t), nbytes)
        with float32_math():
            library_ms = timing._event_ms(lambda: (torch.mm(s, s.T), torch.mm(t, t.T)), 20,
                                          timing._flusher(nbytes))
        emit(kernel="gram_pair_fwd", B=B, Ds=K2_COLUMNS, Dt=K2_COLUMNS, **times,
             library_ms=library_ms, sha256_gs_gt=_bits(*gram_pair_fwd(s, t)))
        del s, t
        torch.cuda.empty_cache()
    # the bits at phase 12's shapes, on the inputs chip_smoke._gram_case makes
    for B, ds, dt, _ in timing.GRAM_CASES:
        g = torch.Generator(device="cuda").manual_seed(B + ds + dt)
        s = (0.3 * torch.randn(B, ds, device="cuda", generator=g)).clamp(-1, 1)
        t = (0.3 * torch.randn(B, dt, device="cuda", generator=g)).clamp(-1, 1)
        emit(kernel="gram_pair_fwd", phase12_bits=True, B=B, Ds=ds, Dt=dt,
             sha256_gs_gt=_bits(*gram_pair_fwd(s, t)))
        del s, t
        torch.cuda.empty_cache()


def bf16_k2(emit) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd

    timing = _smoke()
    for B in K2_BATCHES:
        g = torch.Generator(device="cuda").manual_seed(B)
        s = (0.3 * torch.randn(B, K2_COLUMNS, device="cuda", generator=g)).clamp(-1, 1).bfloat16()
        t = (0.3 * torch.randn(B, K2_COLUMNS, device="cuda", generator=g)).clamp(-1, 1).bfloat16()
        nbytes = 2 * B * 2 * K2_COLUMNS
        times = timing.gram_times(lambda: gram_pair_fwd(s, t), nbytes)
        bound_ms, bound_by = timing._bound_bf16(nbytes, 1.0 * B * (B + 1) * 2 * K2_COLUMNS)
        library_ms = timing._event_ms(
            lambda: (torch.mm(s, s.T, out_dtype=torch.float32),
                     torch.mm(t, t.T, out_dtype=torch.float32)), 20, timing._flusher(nbytes))
        bits = _bits(*gram_pair_fwd(s, t))
        emit(kernel="gram_pair_fwd_bf16", B=B, Ds=K2_COLUMNS, Dt=K2_COLUMNS, **times,
             bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / times["ms"],
             library_ms=library_ms, sha256_gs_gt=bits,
             bitwise_repeat=bits == _bits(*gram_pair_fwd(s, t)))
        del s, t
        torch.cuda.empty_cache()


GROUPS = {"k1b": k1b, "k3f": k3f, "k3w": k3w, "k5": k5, "k2": k2, "bf16_conv": bf16_conv,
          "bf16_k5": bf16_k5, "bf16_k4": bf16_k4, "bf16_k2": bf16_k2}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="the source tree to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", nargs="+", default=list(GROUPS), choices=list(GROUPS),
                    help="the groups of kernels to time")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_pair_timing: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    records = []

    def emit(**rec):
        rec = {"label": args.label, "card": card, **rec}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    for name in args.kernels:
        GROUPS[name](emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
