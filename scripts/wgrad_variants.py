#!/usr/bin/env python3
"""The measurements behind the split of K3w's operands (the 3x3 conv's weight
gradient, ``speech_enhancement_clskd_tpu_torch/kernels/csrc/conv3x3_tiles.cuh``,
route "mma"), on one NVIDIA GPU.

    python3 scripts/wgrad_variants.py [--out FILE]

Copies the kernel sources into ``kernels/build/wgrad_variants/<variant>/``,
rewrites ``split_tf32`` of ``tf32x3.cuh`` there for each variant of
``VARIANTS``, builds ``conv3x3_wgrad.cu`` from each copy, and times each
library at the kernel-config step's weight-gradient shapes (CUDA events,
the same inputs for all) in turns, with its relative L2 error against the
plain version and a bitwise repeat.  The variants:

- ``rna``: the kernel as built, hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi);
- ``lo_raw``: lo = a - hi as an f32 value, its low 13 bits left for the
  tensor core to drop (one conversion a value instead of two);
- ``trunc``: hi = a with its low 13 mantissa bits cleared, lo = a - hi
  (exact in f32) likewise left to the tensor core (no conversion).

Prints one JSON line per measurement and writes them all to ``--out``.
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SPLIT_RNA = """  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));"""
VARIANTS = {
    "rna": SPLIT_RNA,
    "lo_raw": """  hi = to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));""",
    "trunc": """  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));""",
}
# (D, C, O) of the kernel-config step's weight gradients at batch 32, T = 483
# (O = 2 takes the narrow route, which no variant changes)
SHAPES = [(16, 64, 256), (32, 64, 128), (64, 64, 64), (128, 64, 32)]
ROUNDS = 2


def emit(records: list, **rec) -> None:
    print(json.dumps(rec), flush=True)
    records.append(rec)


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


def build(name: str, split: str) -> ctypes.CDLL:
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    src_dir = _build.BUILD_DIR / "wgrad_variants" / name
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src_dir)
    header = src_dir / "tf32x3.cuh"
    text = header.read_text()
    if SPLIT_RNA not in text:
        raise RuntimeError("tf32x3.cuh's split_tf32 is not the one this script rewrites")
    header.write_text(text.replace(SPLIT_RNA, split))
    lib_path = src_dir / "libconv3x3_wgrad.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src_dir / "conv3x3_wgrad.cu")], check=True, capture_output=True,
                   text=True, timeout=900)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_wgrad_chunks.argtypes = [i32] * 3
    lib.conv3x3_wgrad_chunks.restype = i32
    lib.conv3x3_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.conv3x3_wgrad.restype = i32
    return lib


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_wgrad_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "results" / "wgrad_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wgrad_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    records = [{"card": card}]
    print(card, flush=True)
    libs = {name: build(name, split) for name, split in VARIANTS.items()}
    stream = torch.cuda.current_stream().cuda_stream
    for D, C, O in SHAPES:
        B, T = 32, 483
        g = torch.Generator(device="cuda").manual_seed(D + C + O)
        x = torch.randn(B, D, T, C, device="cuda", generator=g)
        gy = torch.randn(B, D, T, O, device="cuda", generator=g)
        with float32_math():
            want = conv3x3_wgrad_reference(x, gy)
        for rnd in range(ROUNDS):
            order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
            for name in order:
                lib = libs[name]
                chunks = lib.conv3x3_wgrad_chunks(C, O, B * D)
                scratch = torch.empty(chunks, 9 * C * O, device="cuda")
                outs = [torch.empty(3, 3, C, O, device="cuda") for _ in range(2)]

                def run(out=outs[0]):
                    err = lib.conv3x3_wgrad(x.data_ptr(), gy.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), B, D, T, C, O, chunks, stream)
                    if err != 0:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")
                run(outs[0])
                run(outs[1])
                torch.cuda.synchronize()
                rel = ((outs[0] - want).norm() / want.norm()).item()
                emit(records, variant=name, round=rnd, B=B, D=D, T=T, C=C, O=O,
                     ms=_time_ms(run, 10), rel_l2=rel,
                     bitwise_repeat=bool(torch.equal(outs[0], outs[1])))
        del x, gy, want
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
