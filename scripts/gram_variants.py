#!/usr/bin/env python3
"""Times variants of K2's designs (``kernels/csrc/gram_pair_fwd.cu``, float32,
and ``kernels/csrc/gram_pair_bf16.cu``, bf16 with ``--dtype bf16``) on one
NVIDIA GPU, each built from the source with text substitutions, so that a
choice of the design (the pairing of the diagonal tiles, stage widths, the
ring, the consumer warps, the dependent launch of pass 2) rests on a
measurement, and probes that drop the copies or the arithmetic, to show which
of the two holds pass 1.  A substitution whose text is not once in the source
stops the script.

    python3 scripts/gram_variants.py [--dtype f32|bf16] [--batches 8,16,32,64] [--out FILE]

Each variant is compiled with ``nvcc`` into its own library under
``kernels/build/variants/`` (flags as ``kernels/_build.py``), loaded with
ctypes and called on the same seeded waveform-like inputs (B x 528,000 each
side, rounded to bf16 for the bf16 source).  Every variant's Grams are held
to ``chip_smoke.GRAM_TOL`` of the largest element of ``gram_pair_reference``
(bf16: ``chip_smoke.BF16_KERNEL_REL_L2``, relative L2) and must be exactly
symmetric (but the probes', which time a part of the work and are wrong by
design);
its times are ``chip_smoke.gram_times`` (the profiler's device time of both
passes and of each, L2 flushed where the inputs fit in it).  One JSON line a
variant and batch, beside the card's name and power limit, and for each batch
the time of ``torch.sum`` over both inputs (CUDA events), the card's read rate
on the same bytes.  With ``--clocks`` each variant also runs back to back for
1.5 s while ``nvidia-smi`` samples the SM clock and the power draw.  Needs
CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
COLUMNS = 528000

# name -> (old text, new text), or a list of them, in the source; "base" is
# the source as is.  The float32 kernel's (gram_pair_fwd.cu):
F32_VARIANTS = {
    "base": None,
    # the diagonal blocks as whole R x R tiles at every B (warps of unequal
    # work above B = 32), or in pairs at every B (fewer warps to B = 32)
    "unpaired": ("static constexpr int kPairs = L < 32 && NB % 2 == 0 ? NB / 2 : 0;",
                 "static constexpr int kPairs = 0;"),
    "paired": ("static constexpr int kPairs = L < 32 && NB % 2 == 0 ? NB / 2 : 0;",
               "static constexpr int kPairs = NB % 2 == 0 ? NB / 2 : 0;"),
    # 256 columns a stage at B <= 32 (1 KB row copies, six stages), 128 at B = 64
    # (512-byte row copies, six stages), and a ring of half the shared memory
    "b32_kt256": ("Plan<8, 4, 32, 512>>(3", "Plan<8, 4, 32, 256>>(3"),
    "b64_kt128": ("Plan<8, 8, 8, 256>>(5", "Plan<8, 8, 8, 128>>(5"),
    "ring_100k": ("constexpr int kRingBudget = 200 * 1024;", "constexpr int kRingBudget = 100 * 1024;"),
    "no_dependent_launch": ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
    # pass 2: 256 chunks staged at a time (528,000 columns in two spans) and
    # the in-order adds unrolled by 8
    "sum_span256_unroll8": [("constexpr int kSumSpan = 320;", "constexpr int kSumSpan = 256;"),
                            ("#pragma unroll 32\n      for (int c = 0; c < span; ++c)",
                             "#pragma unroll 8\n      for (int c = 0; c < span; ++c)")],
    # probes, not candidates (their Grams are wrong): no arithmetic (the copies
    # alone), and no copies (the arithmetic alone, on whatever the stages hold)
    "probe_no_compute": ("for (int gi = l; gi < groups; gi += L) {", "for (int gi = l; gi < 0; gi += L) {"),
    "probe_no_copy": [("mbar_arrive_expect_tx(&full[slot], (uint32_t)(B * n * 4));",
                       "mbar_arrive(&full[slot]);"),
                      ("for (int r = lane; r < B; r += 32)\n          bulk_copy(",
                       "for (int r = lane; r < 0; r += 32)\n          bulk_copy(")],
}
# the bf16 kernel's (gram_pair_bf16.cu): 2 consumer warps (k-slices) at B <=
# 32 and B <= 64; other stage widths at B <= 16, 32 and 64; rings of 110,
# 150 and 220 KB (at 220 KB pass 2's block no longer fits beside pass 1's),
# and the runtime's own shared-memory carveout for pass 1
BF16_VARIANTS = {
    "base": None,
    "warps2": [("Plan<2, 512, 4>>(1", "Plan<2, 512, 2>>(1"), ("Plan<4, 256, 4>>(3", "Plan<4, 256, 2>>(3")],
    "b16_kt512": ("Plan<1, 1024, 4>>(0", "Plan<1, 512, 4>>(0"),
    "b32_kt256": ("Plan<2, 512, 4>>(1", "Plan<2, 256, 4>>(1"),
    "b32_kt1024": ("Plan<2, 512, 4>>(1", "Plan<2, 1024, 4>>(1"),
    "b64_kt128": ("Plan<4, 256, 4>>(3", "Plan<4, 128, 4>>(3"),
    "b64_kt512": ("Plan<4, 256, 4>>(3", "Plan<4, 512, 4>>(3"),
    "ring_110k": ("constexpr int kSmemBudget = 184 * 1024;", "constexpr int kSmemBudget = 110 * 1024;"),
    "ring_150k": ("constexpr int kSmemBudget = 184 * 1024;", "constexpr int kSmemBudget = 150 * 1024;"),
    # pass 1 without its carveout preference (the runtime's choice for its
    # shared memory alone)
    "carveout_default": ("""      err = cudaFuncSetAttribute(gram_partial_mma_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);""", "      err = cudaSuccess;"),
    "ring_220k": ("constexpr int kSmemBudget = 184 * 1024;", "constexpr int kSmemBudget = 220 * 1024;"),
    "no_dependent_launch": ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
    # probes (wrong Grams by design): the copies alone, and the arithmetic alone
    "probe_no_compute": ("for (int k = warp * P::kSlice; k < end; ++k) {",
                         "for (int k = warp * P::kSlice; k < 0; ++k) {"),
    "probe_no_copy": [("mbar_arrive_expect_tx(&full[slot], (uint32_t)(boxes * P::kBoxBytes));",
                       "mbar_arrive(&full[slot]);"),
                      ("for (int b = 0; b < boxes; ++b)\n        tma_load_2d(",
                       "for (int b = 0; b < 0; ++b)\n        tma_load_2d(")],
}
# --dtype -> (source, C entry, variants)
DESIGNS = {"f32": ("gram_pair_fwd.cu", "gram_pair_fwd", F32_VARIANTS),
           "bf16": ("gram_pair_bf16.cu", "gram_pair_fwd_bf16", BF16_VARIANTS)}


def build_all(dtype: str, names) -> dict:
    """One library a variant of ``dtype``'s source, all ``nvcc`` started
    together."""
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    source, entry, variants = DESIGNS[dtype]
    base = (_build.CSRC_DIR / source).read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = base
        subs = variants[name] or []
        for old, new in [subs] if isinstance(subs, tuple) else subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in the source")
            src = src.replace(old, new)
        cu = out_dir / f"gram_{dtype}_{name}_{hashlib.sha1(src.encode()).hexdigest()[:10]}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn.ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = fn
    return libs


def sustained_clocks(call, seconds: float = 1.5) -> dict:
    """The SM clock and power draw (``nvidia-smi``, sampled every 100 ms)
    while ``call`` runs back to back for ``seconds``, and the device ms a
    call over that window (CUDA events)."""
    import statistics
    import time

    import torch

    probe = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader,nounits", "-lms", "100"],
                             stdout=subprocess.PIPE, text=True)
    try:
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                call()
            n += 50
            torch.cuda.synchronize()
        end.record()
        torch.cuda.synchronize()
    finally:
        probe.terminate()
        out, _ = probe.communicate(timeout=30)
    samples = [[float(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    samples = samples[len(samples) // 4:]  # past the ramp
    return {"calls": n, "ms": start.elapsed_time(end) / n,
            "sm_mhz_median": statistics.median(x[0] for x in samples),
            "power_w_median": statistics.median(x[1] for x in samples)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="f32", choices=list(DESIGNS))
    ap.add_argument("--batches", default="8,16,32,64")
    ap.add_argument("--variants", default=None, help="comma-separated; all of --dtype's by default")
    ap.add_argument("--out", default=None)
    ap.add_argument("--clocks", action="store_true",
                    help="also run each variant back to back for 1.5 s and record the SM clock "
                         "and power draw over that window")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    from chip_smoke import BF16_KERNEL_REL_L2, GRAM_TOL, _event_ms, _flusher, _rel_l2, gram_times
    from speech_enhancement_clskd_tpu_torch.kernels.gram import CHUNK, gram_pair_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    if not torch.cuda.is_available():
        sys.exit("gram_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    variants = DESIGNS[args.dtype][2]
    libs = build_all(args.dtype, args.variants.split(",") if args.variants else list(variants))
    probes = {name for name in variants if name.startswith("probe_")}
    bf16 = args.dtype == "bf16"
    elem = 2 if bf16 else 4
    records = []
    for B in (int(b) for b in args.batches.split(",")):
        g = torch.Generator(device="cuda").manual_seed(B)
        s = (0.3 * torch.randn(B, COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        t = (0.3 * torch.randn(B, COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        if bf16:
            s, t = s.bfloat16(), t.bfloat16()
        with float32_math():
            want = gram_pair_reference(s, t)
        # the card's read rate on the same inputs: one reduction reading each once
        read_ms = _event_ms(lambda: (s.sum(), t.sum()), 20, _flusher(elem * B * 2 * COLUMNS))
        print(json.dumps({"variant": "torch_sum_read", "dtype": args.dtype, "card": card, "B": B,
                          "D": COLUMNS, "ms": read_ms}), flush=True)
        chunks = 2 * -(-COLUMNS // CHUNK)
        out = torch.empty(2 * B * B + chunks * B * (B + 1) // 2, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(s.data_ptr(), t.data_ptr(), out.data_ptr(), B, COLUMNS, COLUMNS, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            got = out[:B * B].view(B, B), out[B * B:2 * B * B].view(B, B)
            err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
            rel_l2 = max(_rel_l2(a, b) for a, b in zip(got, want))
            symmetric = all(bool(torch.equal(a, a.T)) for a in got)
            wrong = rel_l2 > BF16_KERNEL_REL_L2 if bf16 else err > GRAM_TOL
            if (wrong or not symmetric) and name not in probes:
                raise RuntimeError(f"{name} at B={B}: error {err}, relative L2 {rel_l2}, "
                                   f"symmetric {symmetric}")
            rec = {"variant": name, "dtype": args.dtype, "card": card, "B": B, "D": COLUMNS,
                   "max_rel_err": err, "rel_l2": rel_l2,
                   **gram_times(call, elem * B * 2 * COLUMNS), "ptxas": fn.ptxas}
            if args.clocks:
                rec["sustained"] = sustained_clocks(call)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del s, t, out
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
