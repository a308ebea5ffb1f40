#!/usr/bin/env python3
"""Times variants of K2's design (``kernels/csrc/gram_pair_fwd.cu``) on one
NVIDIA GPU, each built from the source with text substitutions, so that a
choice of the design (the pairing of the diagonal tiles, stage widths, the
ring, the dependent launch of pass 2) rests on a measurement, and probes that
drop the copies or the arithmetic, to show which of the two holds pass 1.
A substitution whose text is not once in the source stops the script.

    python3 scripts/gram_variants.py [--batches 8,16,32,64] [--out FILE]

Each variant is compiled with ``nvcc`` into its own library under
``kernels/build/variants/`` (flags as ``kernels/_build.py``), loaded with
ctypes and called on the same seeded waveform-like inputs (B x 528,000 each
side).  Every variant's Grams are held to ``chip_smoke.GRAM_TOL`` of the
largest element of ``gram_pair_reference`` and must be exactly symmetric
(but the probes', which time a part of the work and are wrong by design);
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

# name -> (old text, new text), or a list of them, in gram_pair_fwd.cu; "base"
# is the source as is
VARIANTS = {
    "base": None,
    # the diagonal blocks as whole R x R tiles at every B (warps of unequal
    # work above B = 32), or in pairs at every B (fewer warps to B = 32)
    "unpaired": ("static constexpr int kPairs = L < 32 && NB % 2 == 0 ? NB / 2 : 0;",
                 "static constexpr int kPairs = 0;"),
    "paired": ("static constexpr int kPairs = L < 32 && NB % 2 == 0 ? NB / 2 : 0;",
               "static constexpr int kPairs = NB % 2 == 0 ? NB / 2 : 0;"),
    # 256 columns a stage at B <= 32 (1 KB row copies, six stages), 128 at B = 64
    # (512-byte row copies, six stages), and a ring of half the shared memory
    "b32_kt256": ("Plan<8, 4, 32, 512, E>>(p0 + 3", "Plan<8, 4, 32, 256, E>>(p0 + 3"),
    "b64_kt128": ("Plan<8, 8, 8, 256, E>>(p0 + 5", "Plan<8, 8, 8, 128, E>>(p0 + 5"),
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
    "probe_no_copy": [("mbar_arrive_expect_tx(&full[slot], (uint32_t)(B * n * (int)sizeof(E)));",
                       "mbar_arrive(&full[slot]);"),
                      ("for (int r = lane; r < B; r += 32)\n          bulk_copy(",
                       "for (int r = lane; r < 0; r += 32)\n          bulk_copy(")],
}
PROBES = {name for name in VARIANTS if name.startswith("probe_")}


def build_all(names) -> dict:
    """One library a variant, all ``nvcc`` started together."""
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    base = (_build.CSRC_DIR / "gram_pair_fwd.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = base
        subs = VARIANTS[name] or []
        for old, new in [subs] if isinstance(subs, tuple) else subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in the source")
            src = src.replace(old, new)
        cu = out_dir / f"gram_{name}_{hashlib.sha1(src.encode()).hexdigest()[:10]}.cu"
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
        lib = ctypes.CDLL(str(so))
        lib.gram_pair_fwd.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.gram_pair_fwd.restype = ctypes.c_int
        lib.ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = lib
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
    ap.add_argument("--batches", default="8,16,32,64")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--clocks", action="store_true",
                    help="also run each variant back to back for 1.5 s and record the SM clock "
                         "and power draw over that window")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    from chip_smoke import GRAM_TOL, _event_ms, _flusher, gram_times
    from speech_enhancement_clskd_tpu_torch.kernels.gram import CHUNK, gram_pair_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    if not torch.cuda.is_available():
        sys.exit("gram_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_all(args.variants.split(","))
    records = []
    for B in (int(b) for b in args.batches.split(",")):
        g = torch.Generator(device="cuda").manual_seed(B)
        s = (0.3 * torch.randn(B, COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        t = (0.3 * torch.randn(B, COLUMNS, device="cuda", generator=g)).clamp(-1, 1)
        with float32_math():
            want = gram_pair_reference(s, t)
        # the card's read rate on the same inputs: one reduction reading each once
        read_ms = _event_ms(lambda: (s.sum(), t.sum()), 20, _flusher(4 * B * 2 * COLUMNS))
        print(json.dumps({"variant": "torch_sum_read", "card": card, "B": B, "D": COLUMNS,
                          "ms": read_ms}), flush=True)
        chunks = 2 * -(-COLUMNS // CHUNK)
        out = torch.empty(2 * B * B + chunks * B * (B + 1) // 2, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.gram_pair_fwd(s.data_ptr(), t.data_ptr(), out.data_ptr(), B, COLUMNS,
                                        COLUMNS, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            got = out[:B * B].view(B, B), out[B * B:2 * B * B].view(B, B)
            err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
            symmetric = all(bool(torch.equal(a, a.T)) for a in got)
            if (err > GRAM_TOL or not symmetric) and name not in PROBES:
                raise RuntimeError(f"{name} at B={B}: error {err}, symmetric {symmetric}")
            rec = {"variant": name, "card": card, "B": B, "D": COLUMNS, "max_rel_err": err,
                   **gram_times(call, 4 * B * 2 * COLUMNS), "ptxas": lib.ptxas}
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
