#!/usr/bin/env python3
"""Probes of the bf16 3x3 conv tile on TMA and wgmma (the bf16 K3f and K3w,
``speech_enhancement_clskd_tpu_torch/kernels/csrc/conv3x3_bf16.cuh``, route
"wgmma"), on one NVIDIA GPU: where the tile's time goes.

    python3 scripts/conv_bf16_variants.py [--out FILE] [--variants NAME ...]

Copies the kernel sources into ``kernels/build/conv_bf16_variants/<variant>/``,
rewrites ``conv3x3_bf16.cuh`` there for each variant of ``VARIANTS`` (a
substitution not found stops the script), builds ``conv3x3_bf16.cu`` from
every copy at once, and times the forward and the weight gradient of each
library in turns at ``SHAPES`` (CUDA events, the same inputs for all), with
a hash of the output's bits and whether two runs agree.  The variants
``no_*`` and ``one_*`` compute wrong values on purpose: each takes one piece
of work out to show what that piece costs.

- ``base``: the tile as built;
- ``no_wgmma``: the products replaced by one f32 add a product (no
  tensor-core work, no reads of A or B by the tensor cores), in both kernels;
- ``no_store``: the forward writes no output;
- ``one_halo_row``: the forward copies only the halo's middle row d (a
  third of its TMA bytes; the rows d - 1 and d + 1 stale);
- ``ldmatrix_a``: the forward's A loaded by ldmatrix.x4 from the shifted
  halo rows into registers (m64nNk16 with A from registers), each group
  waited for before the next one's loads; its output's bits equal
  ``base``'s, so the tile's shifted descriptors read the right rows.

Prints one JSON line per measurement and writes them all to ``--out``.
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "conv3x3_bf16.cuh"

FWD_SS = """          wg_fence();
#pragma unroll
          for (int k = 0; k < 9; ++k)  // shift (dd, tt) = (k / 3, k % 3)
            wgmma_ss_bn<BN>(
                part[kk & 1],
                sw128_desc(xs + (k / 3) * kHaloPitch + (k % 3) * kSwRow + 32 * kk, 16, 1024),
                wdesc + (uint64_t)((((kc * 9 + k) * BN * kSwRow) + 32 * kk) >> 4), k);
          wg_commit();"""
# A by ldmatrix.x4 from the shifted rows into registers, each group waited
# for before the next group's loads (loads into A's registers while a group
# is in flight make ptxas serialize the wgmma, C7513)
FWD_RS = """          uint32_t a[9][4];
          const int lrow = 16 * ((threadIdx.x / 32) % 4) + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int k = 0; k < 9; ++k)
            ldsm_x4(a[k], sw128(xs + (k / 3) * kHaloPitch, lrow + k % 3, 2 * kk + (lane >> 4)));
          wg_fence();
#pragma unroll
          for (int k = 0; k < 9; ++k)
            wgmma_rs_bn<BN>(part[kk & 1], a[k],
                            wdesc + (uint64_t)((((kc * 9 + k) * BN * kSwRow) + 32 * kk) >> 4), k);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int k = 0; k < 9; ++k) pin(a[k]);"""
RS_WRAPPERS = r"""__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs_bn(float (&d)[BN / 2], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  if constexpr (BN == 64)
    wgmma_rs_n64(d, a, desc, scale_d);
  else
    wgmma_n32<0>(d, a, desc, scale_d);
}

"""
ANCHOR = "template <int BN>\n__device__ __forceinline__ void wgmma_ss_bn("
FWD_WGMMA = ("            wgmma_ss_bn<BN>(\n"
             "                part[kk & 1],\n"
             "                sw128_desc(xs + (k / 3) * kHaloPitch + (k % 3) * kSwRow + 32 * kk, "
             "16, 1024),\n"
             "                wdesc + (uint64_t)((((kc * 9 + k) * BN * kSwRow) + 32 * kk) >> 4), "
             "k);")
FWD_STORE = "        if (t >= T) continue;\n        const long row = (bd * T + t) * (long)O;"
FWD_HALO = ("          mbar_expect_tx(&full[slot], 3 * kHaloBox);\n"
            "          uint8_t* st = ring + slot * kHaloStage;\n"
            "          for (int r = 0; r < 3; ++r)")
WG_WGMMA = ("            wgmma_n32<1>(part, a[ks], gdesc + (uint64_t)((ks * 2048 + 64 * hf) >> 4), "
            "ks);")
NO_FWD_STORE = (FWD_STORE, "        if (t >= T || T > 0) continue;\n"
                           "        const long row = (bd * T + t) * (long)O;")

VARIANTS = {
    "base": [],
    "no_wgmma": [
        (FWD_WGMMA, "            part[kk & 1][k % (BN / 2)] += (float)(xs + k);"),
        (WG_WGMMA, "            part[ks] += __uint_as_float((a[ks][0] ^ a[ks][1] ^ a[ks][2] ^ "
                   "a[ks][3]) & 0x3fffffffu);"),
    ],
    "no_store": [NO_FWD_STORE],
    "one_halo_row": [
        (FWD_HALO, "          mbar_expect_tx(&full[slot], kHaloBox);\n"
                   "          uint8_t* st = ring + slot * kHaloStage;\n"
                   "          for (int r = 1; r < 2; ++r)"),
    ],
    "ldmatrix_a": [(ANCHOR, RS_WRAPPERS + ANCHOR), (FWD_SS, FWD_RS)],
}
# (B, D, T, C, O): the reference shape, the dx pass at C = 32 and the weight
# gradient at O = 32 (the step's shapes where the tile did worst)
SHAPES = [(32, 64, 483, 64, 64), (32, 128, 483, 32, 64), (32, 128, 483, 64, 32)]
ROUNDS = 2
REPEATS = 6


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


def _bits(t) -> str:
    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def build_all(names) -> dict:
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    procs = {}
    for name in names:
        src_dir = _build.BUILD_DIR / "conv_bf16_variants" / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, src_dir)
        header = src_dir / HEADER
        text = header.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: substitution not found: {old[:60]!r}")
            text = text.replace(old, new)
        header.write_text(text)
        lib_path = src_dir / "libconv3x3_bf16.so"
        procs[name] = (lib_path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
             str(src_dir / "conv3x3_bf16.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_bf16_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.conv3x3_bf16_fwd.restype = i32
        lib.conv3x3_bf16_fwd_scratch_elems.argtypes = [i32] * 2
        lib.conv3x3_bf16_fwd_scratch_elems.restype = ctypes.c_long
        lib.conv3x3_bf16_wgrad_chunks.argtypes = [i32] * 3
        lib.conv3x3_bf16_wgrad_chunks.restype = i32
        lib.conv3x3_bf16_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.conv3x3_bf16_wgrad.restype = i32
        libs[name] = lib
    return libs


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "results" / "conv_bf16_variants.json"))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("conv_bf16_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    records = [{"card": card}]
    print(card, flush=True)
    libs = build_all(args.variants)
    stream = torch.cuda.current_stream().cuda_stream
    for B, D, T, C, O in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(D + C + O)
        x = torch.randn(B, D, T, C, device="cuda", generator=g).bfloat16()
        w = (torch.randn(3, 3, C, O, device="cuda", generator=g) / (3 * C ** 0.5)).bfloat16()
        gy = torch.randn(B, D, T, O, device="cuda", generator=g).bfloat16()
        for rnd in range(ROUNDS):
            order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
            for name in order:
                lib = libs[name]
                pack = torch.empty(lib.conv3x3_bf16_fwd_scratch_elems(C, O), device="cuda",
                                   dtype=torch.bfloat16)
                outs = [torch.empty(B, D, T, O, device="cuda", dtype=torch.bfloat16)
                        for _ in range(REPEATS)]
                chunks = lib.conv3x3_bf16_wgrad_chunks(C, O, B * D)
                part = torch.empty(chunks, 9 * C * O, device="cuda")
                dws = [torch.empty(3, 3, C, O, device="cuda") for _ in range(REPEATS)]

                def fwd(out=outs[0]):
                    err = lib.conv3x3_bf16_fwd(x.data_ptr(), w.data_ptr(), pack.data_ptr(),
                                               out.data_ptr(), B, D, T, C, O, stream)
                    if err != 0:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")

                def wgrad(dw=dws[0]):
                    err = lib.conv3x3_bf16_wgrad(x.data_ptr(), gy.data_ptr(), dw.data_ptr(),
                                                 part.data_ptr(), B, D, T, C, O, chunks, stream)
                    if err != 0:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")

                for i in range(REPEATS):
                    fwd(outs[i])
                    wgrad(dws[i])
                torch.cuda.synchronize()
                differ = [int((outs[i] != outs[0]).sum()) for i in range(1, REPEATS)]
                where = []
                if any(differ):
                    i = next(k for k, n in enumerate(differ, 1) if n)
                    idx = (outs[i] != outs[0]).nonzero()[:4].tolist()
                    where = [(ix, float(outs[0][tuple(ix)]), float(outs[i][tuple(ix)]))
                             for ix in idx]
                emit(records, variant=name, round=rnd, B=B, D=D, T=T, C=C, O=O,
                     fwd_ms=_time_ms(fwd, 20), wgrad_ms=_time_ms(wgrad, 20),
                     fwd_bits=_bits(outs[0]), wgrad_bits=_bits(dws[0]),
                     fwd_elements_differing=differ, fwd_differ_at=where,
                     wgrad_repeat=all(torch.equal(d, dws[0]) for d in dws))
                del outs, dws, part, pack
        del x, w, gy
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
