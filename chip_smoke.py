#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds every hand-written kernel of the serving and training paths from the
sources in the checkout, holds each against its plain PyTorch version on the
card, then drives both paths through their entry points:

1. device: the card's name and power limit, and the TF32 flags as found
   (left alone: the float32 model and trainer turn TF32 off for their own
   calls);
2. build: one ``nvcc`` per CUDA source, all started together, and the
   tensor-core instructions in the mma kernels of K3f's, K3w's, K5f's and
   K5b's libraries (``cuobjdump -sass``, or the PTX where the toolkit has no
   cuobjdump);
3. forward kernel vs plain: ``lstm_seq`` against ``lstm_seq_reference`` at
   the shapes the serving and training paths give it, each with the plan
   K1f takes, with times, the bound and a one-call PyTorch yardstick
   (``torch.nn.LSTM``, cuDNN; never used by the port);
4. serving, student: ``StreamingEnhancer`` on the trained r4 bundle answers
   four requests; per-chunk latency, real-time factor, launch count, and
   agreement with the same engine on the CPU;
5. serving, teacher at full width (``dccrn-cl``, seeded weights): offline
   forward on 32 x 3 s; real-time factor, peak memory, agreement with the
   CPU on one utterance;
6. backward kernel vs plain: ``lstm_seq_bwd`` against
   ``lstm_seq_bwd_reference`` at the training step's shape and others, each
   with the plan K1b takes; two runs must give the same bits; times, the
   bound and the backward of cuDNN's ``torch.nn.LSTM`` as the yardstick;
7. training at full width: ``Trainer(TrainConfig())`` (teacher ``dccrn-cl``,
   student ``dccrn-cl-test``, seeded) takes one warm-up and 10 timed CLSKD
   steps on 32 x 3 s synthetic batches; step time, audio-seconds per second,
   peak memory, every step's loss, launches per step; then one step on the
   card against one on the CPU from the same weights (4 x 1 s): the loss on
   white-noise and on synthetic-speech batches, the gradients on the
   white-noise batch (on speech at random init the log-magnitude loss's
   gradient is ill-conditioned; its error there is reported, not held);
8. ABF kernels vs plain: the 3x3 conv (``conv3x3_fwd``, K3f; also its dx
   pass), its weight gradient (``conv3x3_wgrad``, K3w), the attention fuse
   (``attention_fuse_fwd``, K4f) and its backward (``attention_fuse_bwd``,
   K4b) against their plain versions at the training step's shapes and at
   small ragged ones, K3f alone at each (D, C, O) of the kernel-config
   step's 12 ABF conv2 forwards and 12 dx passes, and K3w alone at each
   distinct shape of its 12 weight gradients, each labelled with its route;
   two runs of K3f and of each backward must give the same bits; times, the
   bound and a one-call PyTorch yardstick where one exists (``F.conv2d`` and
   ``torch.nn.grad.conv2d_weight``, TF32 off; ``F.conv2d`` with TF32 on,
   PyTorch's default, beside it);
9. training with the kernels: ``Trainer(TrainConfig(distill=DistillConfig(
   abf_conv_pallas=True, abf_attfuse_pallas=True)))`` as phase 7 (one
   warm-up and 5 timed steps, launches per step: K3f 24, K3w 12, K4f 10,
   K4b 10, K1f 8, K1b 4) and its card-vs-CPU step, held as phase 7's;
10. whole-ABF-block kernels vs plain: ``abf_block_fwd`` (K5f) and
    ``abf_block_bwd`` (K5b) against their plain versions at the training
    step's reference block, its decoder mask block, its deepest (no-fuse)
    block and small ragged ones (k = 1, 2, 4; T past the tiles; D of one
    row), each labelled with its routes; two runs of each must give the same
    bits; times, the bound, and the time of the per-op kernels it replaces
    on the same block (the xhat matmul, K4f and K3f; K3f's dx pass, K3w, K4b
    and the 1x1 conv's two matmuls); then K5f, K5b and the per-op path alone
    at each distinct block shape of the block-config step, and their sums
    weighted by each shape's blocks a step;
11. training with the whole-block kernel: ``Trainer(TrainConfig(distill=
    DistillConfig(abf_block_pallas=True)))`` as phase 9 (launches per step:
    K5f 12, K5b 12, K1f 8, K1b 4, and no K3/K4) and its card-vs-CPU step;
12. the fused Gram pair vs plain: ``gram_pair_fwd`` (K2) against
    ``gram_pair_reference`` on the ``spkd`` strategy's 33 s waveforms
    (528,000 samples) at every batch phase 13 may settle on and at the
    gate's largest (64), the 3 s waveforms at batch 32 (forced; the JAX
    gate's TPU crossover read on this card), a ragged tail (2^19 + 1),
    Ds != Dt and B = 2; each held to 1e-6 of its largest element, two runs
    giving the same bits and the output exactly symmetric; times (the
    profiler's device time of both passes and of each, CUDA events, host
    time a call; L2 flushed between launches where the inputs fit in it),
    the bound (bytes, or f32 FMA over the upper triangles) and two
    ``torch.mm(Z, Z.T)`` calls (TF32 off) as the yardstick;
13. the ``spkd`` strategy: ``Trainer(TrainConfig(distill=DistillConfig(
    strategy="spkd")))`` on 33 s clips, where the JAX auto gate sends the
    waveforms' SPKD loss to K2, as phase 7 (one warm-up and 5 timed steps,
    batch halved from 32 while it does not fit; launches per step: K2 1,
    K1f 8, K1b 4) and its card-vs-CPU step at 2 x 33 s, the least batch
    SPKD takes; then one step each of the ``mse`` and ``stft`` strategies
    at 32 x 3 s (K1f 8, K1b 4, no K2);
14. the fit loop: ``Trainer(TrainConfig()).fit`` on the card at full width
    (32 x 3 s synthetic, an epoch of 2 steps, 2 epochs, ``keep_top_k=1``,
    checkpoints in a temporary directory), then ``cli.bundle_best`` as the
    ``distill`` subcommand runs it: the final state's ``validate`` (SI-SDR
    and STOI on the card) against the same weights' on the CPU; the one
    checkpoint kept is the step with the best ``stoi`` of the two epochs; a
    restore gives the saved state bit for bit; the bundle, read by
    ``load_bundle`` into a fresh student, serves the restored student's bits;
    K1f and K1b launches across the fit (8 and 4 a step, 4 K1f a validation
    batch); the fit's audio-seconds per second beside phase 7's, and where
    the loop's time beyond the steps goes (the loader alone, validation).

Each phase prints one line.  The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero and prints no result; so does a machine
without CUDA, or a directory that holds this file and nothing else of the
repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUNDLE = ROOT / "artifacts" / "r4_distill" / "the_best_model.npz"
# the serving and training configurations, shared with
# scripts/profile_serving_torch.py
CHUNK_FRAMES, CONTEXT_FRAMES = 48, 64
TEACHER_BATCH, TEACHER_SECONDS = 32, 3.0
TRAIN_SECONDS, TRAIN_STEPS = 3.0, 10
KERNEL_TRAIN_STEPS = 5
# the ABF kernel paths of phase 9, shared with scripts/profile_serving_torch.py
ABF_KERNEL_FLAGS = dict(abf_conv_pallas=True, abf_attfuse_pallas=True)
# the whole-block kernel path of phase 11, shared with the profile script
ABF_BLOCK_FLAGS = dict(abf_block_pallas=True)
# card vs CPU training step: 4 x 1 s at full width
CHECK_BATCH, CHECK_SECONDS = 4, 1.0
# the spkd strategy of phase 13, on clips long enough (>= 2^19 samples) for
# the JAX auto gate to send its waveform Grams to K2; its card-vs-CPU step at
# the least batch SPKD takes
SPKD_SECONDS, SPKD_STEPS = 33.0, 5
SPKD_SAMPLES = int(SPKD_SECONDS * 16000)
SPKD_CHECK_BATCH = 2
# T of the STFT frames of a 33 s clip (the LSTM kernels' T in phase 13)
SPKD_FRAMES = 5283

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# dense TF32 on the tensor cores (K3f's "mma" route takes three products)
PEAK_TF32_FLOP_S = 495e12

# float32 on both sides; the kernel sums h @ W_hh in another order than
# cuBLAS, and the error carried through T=483 steps stays near 1e-6.
KERNEL_ATOL = 1e-4
# K5f/K5b vs plain: the same f32 sums in another order; the forward by max
# abs error over max(1, the largest output) (the deepest block's outputs
# reach ~10, its error 2e-5), every backward output by relative L2 error
BLOCK_FWD_TOL = 1e-5
BLOCK_REL_L2 = 1e-5
# card (cuDNN f32, no TF32) vs CPU port on the enhanced waveform in [-1, 1]
SERVING_ATOL = 1e-4
# card vs CPU training step: the loss, and each gradient tensor by relative
# L2 error (float32 both sides, sums in another order; measured worst 1.4e-7
# on the loss and, with cuDNN's deterministic algorithms, ~7e-5 on a PReLU
# slope's gradient, NVIDIA H100 80GB HBM3, 700 W)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4
# a gradient that is zero in exact arithmetic (a conv bias in front of a
# batch-statistics BN), against the global gradient norm
ZERO_GRAD = 1e-6
# the spkd, mse and stft steps' gradients come mostly from the base loss, an
# L1 distance of log magnitudes whose gradient flips sign where the student's
# bin meets the clean one.  At 2 x 33 s on white noise one rounding of the
# input moves the CPU's own gradients by up to 1.02e-3 (enc5_conv.wi), and
# the card differs from the CPU by 1.08e-3 on the same tensor (NVIDIA H100
# 80GB HBM3, 700 W).  Phase 13 holds them to this many times that floor,
# measured in the run (``_card_vs_cpu``), where it is above
# TRAIN_GRAD_REL_L2.
ROUNDING_FACTOR = 2.0
# K2 vs plain: the same chunks of 2048 columns added in the same order, each
# chunk's product summed in another order; of the largest |G| element
GRAM_TOL = 1e-6
# the fit of phase 14: epochs of this many steps of TEACHER_BATCH clips
FIT_EPOCHS, FIT_STEPS_PER_EPOCH = 2, 2
# its validation on the card against the CPU on the same weights: STOI
# (absolute) and SI-SDR (dB)
FIT_STOI_ATOL = 2e-4
FIT_SI_SDR_ATOL = 1e-3


# Each kernel's design: K1f, K1b, K2, K3f, K3w, K5f and K5b are in their
# second, K4f and K4b in their first (PERF.md section 6 keeps each design's times).
DESIGNS = {
    "lstm_seq_fwd": "register-cluster",
    "lstm_seq_bwd": "gate-prepass-register-chain",
    "conv3x3_fwd": "3xtf32-mma",
    "conv3x3_wgrad": "3xtf32-mma",
    "attfuse_fwd": "warp-row",
    "attfuse_bwd": "warp-row",
    "abf_block_fwd": "xf-pass-3xtf32-mma",
    "abf_block_bwd": "mma-adjoint-pixel-pass",
    "gram_pair_fwd": "bulk-copy-ring-fma-tiles",
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", card=card, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    from speech_enhancement_clskd_tpu_torch.kernels import (
        _build,
        abf_block,
        attfuse,
        conv3x3,
        gram,
        lstm,
    )

    sources = (lstm.SOURCES + conv3x3.SOURCES + attfuse.SOURCES + abf_block.SOURCES
               + gram.SOURCES)
    t0 = time.perf_counter()
    paths = _build.build_all(sources)
    seconds = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in _build.log_path(src).read_text().splitlines()
                   if "registers" in ln or "spill" in ln] for src in sources}
    tensor_cores = {name: _tensor_core_check(paths[sources.index(source)], source)
                    for name, source in (("k3f", conv3x3.FWD_SOURCE),
                                         ("k3w", conv3x3.WGRAD_SOURCE),
                                         ("k5f", abf_block.FWD_SOURCE),
                                         ("k5b", abf_block.BWD_SOURCE))}
    say("build", seconds=round(seconds, 3),
        libraries=[str(p.relative_to(ROOT)) for p in paths], ptxas=ptxas,
        tensor_cores=tensor_cores)
    for name, found in tensor_cores.items():
        if found["count"] == 0:
            raise RuntimeError(f"{name}'s mma kernels use no tensor-core instruction: {found}")


def _tensor_core_check(library: Path, source: str) -> dict:
    """The tensor-core instructions in the mma kernels (``*mma_kernel*``) of
    ``source``'s library (K3f's, K3w's, K5f's, K5b's): HMMA/HGMMA in
    ``cuobjdump -sass`` of the built library where the toolkit has
    cuobjdump, else mma/wgmma in the PTX that nvcc gives for the source."""
    import os
    import re
    import shutil

    from speech_enhancement_clskd_tpu_torch.kernels import _build

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    if os.access(tool, os.X_OK):
        sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                              text=True, timeout=300).stdout
        funcs = re.split(r"\n\s*Function : ", sass)
        count = sum(len(re.findall(r"\bH(?:G)?MMA\b", f)) for f in funcs
                    if "mma_kernel" in f.split("\n", 1)[0])
        return {"checked": "sass (cuobjdump)", "instruction": "HMMA/HGMMA", "count": count}
    ptx = _build.BUILD_DIR / (Path(source).stem + ".ptx")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=compute_90a",
                    "-std=c++17", "-O3", "-ptx", "-o", str(ptx),
                    str(_build.CSRC_DIR / source)], check=True, capture_output=True,
                   text=True, timeout=300)
    count = len(re.findall(r"\b(?:mma|wgmma)\.", ptx.read_text()))
    return {"checked": "ptx (nvcc -ptx; no cuobjdump)", "instruction": "mma/wgmma",
            "count": count}


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _lstm_bound_ms(T: int, N: int, H: int) -> tuple:
    """Least time for the same work: each input read once (xw, W_hh), each
    output written once (y, c), and the f32 operations (h @ W_hh plus ~12
    elementwise ops per unit) at the card's peak."""
    nbytes = 4 * (T * N * 4 * H + H * 4 * H + 2 * T * N * H)
    flops = T * N * (2 * H * 4 * H + 12 * H)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lstm_bwd_bound_ms(T: int, N: int, H: int) -> tuple:
    """Least time for the backward's work: xw, W_hh, y, c and dy read once,
    dxw and dW_hh written once; per row and step 24H^2 + 30H operations (the
    gates recomputed, dh = dgates @ W_hh^T and h^T dgates into dW_hh, each
    2 x H x 4H, plus the elementwise gate gradients)."""
    nbytes = 4 * (2 * T * N * 4 * H + 2 * H * 4 * H + 3 * T * N * H)
    flops = T * N * (24 * H * H + 30 * H)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_vs_plain():
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import (
        lstm_seq,
        lstm_seq_fwd_plan,
        lstm_seq_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    dev = torch.device("cuda")
    # (T, N=2B, H): offline 3 s (T=483) at serving batch 1 and batch 32, for
    # the student (H=32) and the teacher (H=128); the streaming window
    # (T=118); odd row counts, which leave the last block of 1, 2 or 4 rows
    # ragged; a call with an initial state; and the spkd step's 33 s clips
    # (T=5283) at batch 16 for both widths.
    shapes = [(483, 2, 32, False), (483, 64, 32, False), (483, 2, 128, False),
              (483, 64, 128, False), (118, 2, 32, False), (57, 3, 128, False),
              (20, 266, 32, False), (20, 201, 128, False), (118, 6, 32, True),
              (SPKD_FRAMES, 32, 32, False), (SPKD_FRAMES, 32, 128, False)]
    results = []
    for T, N, H, with_state in shapes:
        g = torch.Generator().manual_seed(1000 * H + N)
        xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
        bound = 1.0 / H ** 0.5
        w_hh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) * bound).to(dev)
        h0 = c0 = None
        if with_state:
            h0 = (torch.rand(N, H, generator=g) * 2 - 1).to(dev)
            c0 = torch.randn(N, H, generator=g).to(dev)
        before = lstm_seq.launches
        y, c = lstm_seq(xw, w_hh, h0, c0)
        if lstm_seq.launches != before + 1:
            raise RuntimeError("lstm_seq did not count its launch")
        with float32_math():
            ry, rc = lstm_seq_reference(xw, w_hh, h0, c0)
        torch.cuda.synchronize()
        err_y = (y - ry).abs().max().item()
        err_c = (c - rc).abs().max().item() / max(1.0, rc.abs().max().item())
        ok = err_y <= KERNEL_ATOL and err_c <= KERNEL_ATOL
        rec = {"T": T, "N": N, "H": H, "initial_state": with_state,
               "plan": lstm_seq_fwd_plan(N, H), "max_abs_err_y": err_y,
               "max_rel_err_c": err_c, "tol": KERNEL_ATOL}
        if not with_state:
            ms = _time_ms(lambda: lstm_seq(xw, w_hh), iters=20)
            plain_ms = _time_ms(lambda: lstm_seq_reference(xw, w_hh), iters=1 if T > 1000 else 3)
            lib = torch.nn.LSTM(4 * H, H).to(dev)
            with torch.no_grad(), float32_math():  # cuDNN's LSTM would take TF32 too
                lib.weight_ih_l0.copy_(torch.eye(4 * H))
                lib.weight_hh_l0.copy_(w_hh.t())
                lib.bias_ih_l0.zero_()
                lib.bias_hh_l0.zero_()
                lib_y = lib(xw)[0]
                library_ms = _time_ms(lambda: lib(xw), iters=20)
            bound_ms, bound_by = _lstm_bound_ms(T, N, H)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       faster_than_library=ms < library_ms,
                       library_max_abs_err=(lib_y - ry).abs().max().item(),
                       bound_ms=bound_ms, bound_by=bound_by)
        say("kernel_vs_plain", **rec)
        if not ok:
            raise RuntimeError(f"lstm_seq disagrees with its plain version: {rec}")
        results.append(rec)
    return results


def student_engine(device: str):
    """``StreamingEnhancer`` on ``device`` with the trained r4 student."""
    from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    cfg, variables, _ = load_bundle(str(BUNDLE))
    return StreamingEnhancer(cfg, torch_state_from_flax(variables), device=device,
                             chunk_frames=CHUNK_FRAMES, context_frames=CONTEXT_FRAMES)


def teacher_batch():
    """The offline teacher's input: ``TEACHER_BATCH`` synthetic noisy
    utterances of ``TEACHER_SECONDS``, float32 numpy ``[B, T]``."""
    import numpy as np

    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    ds = SyntheticEnhancementDataset(size=TEACHER_BATCH, segment=TEACHER_SECONDS, seed=1)
    return np.stack([ds[i][0] for i in range(TEACHER_BATCH)])


def _requests():
    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    ds = SyntheticEnhancementDataset(size=4, segment=10.0, seed=0)
    # 3-10 s utterances with odd lengths
    lengths = [3 * 16000 + 77, 5 * 16000 + 1301, 7 * 16000 + 4099, 10 * 16000]
    return [ds[i][0][:n] for i, n in enumerate(lengths)]


def phase_serving_student():
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq

    eng = student_engine("cuda")
    eng.stream(np.zeros(eng.chunk_samples, np.float32))  # warm-up
    torch.cuda.synchronize()
    reqs = _requests()
    audio_s = sum(len(w) for w in reqs) / eng.cfg.stft.sample_rate

    lstm_seq.launches = 0
    forwards = 0
    outs, wall = [], 0.0
    for wav in reqs:  # whole requests through the entry point
        t0 = time.perf_counter()
        outs.append(eng.stream(wav))
        wall += time.perf_counter() - t0
        forwards += -(-len(wav) // eng.chunk_samples)
    # the same requests chunk by chunk, as a live stream arrives: window to
    # the card, one fixed-shape step, chunk back to the host
    chunk_ms = []
    for wav in reqs:
        pad_t = (-len(wav)) % eng.chunk_samples
        xp = np.pad(wav, (eng.context * eng.hop, pad_t + eng.guard))[None]
        for start in range(0, len(wav) + pad_t, eng.chunk_samples):
            t0 = time.perf_counter()
            window = torch.from_numpy(xp[:, start: start + eng.window_samples]).cuda()
            eng.step(window).cpu()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
    launches = lstm_seq.launches
    if launches == 0 or launches != 4 * forwards:
        raise RuntimeError(f"LSTM kernel launches {launches} != 4 x {forwards} forwards")

    cpu = student_engine("cpu")
    err = max(float(np.abs(cpu.stream(w) - o).max()) for w, o in zip(reqs, outs))
    finite = all(np.isfinite(o).all() and o.shape == w.shape for w, o in zip(reqs, outs))
    say("serving_student", bundle=str(BUNDLE.relative_to(ROOT)), requests=len(reqs),
        audio_s=audio_s, chunk_frames=eng.chunk, context_frames=eng.context,
        latency_ms_algorithmic=eng.latency_ms,
        chunk_ms_median=float(np.median(chunk_ms)),
        chunk_ms_p99=float(np.percentile(chunk_ms, 99)), chunks_timed=len(chunk_ms),
        rtf_stream=wall / audio_s, forwards=forwards, lstm_launches=launches,
        max_abs_err_vs_cpu=err, tol=SERVING_ATOL, finite=finite)
    if not finite or err > SERVING_ATOL:
        raise RuntimeError("streaming output on the card disagrees with the CPU")
    return launches


def phase_serving_teacher():
    import torch

    from speech_enhancement_clskd_tpu_torch.config import TEACHER
    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model

    batch, seconds, iters = TEACHER_BATCH, TEACHER_SECONDS, 3
    wav = torch.from_numpy(teacher_batch()).cuda()
    model = make_model(TEACHER, device="cuda", seed=0)
    with torch.inference_mode():
        model(wav)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lstm_seq.launches = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(wav)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        launches = lstm_seq.launches
        peak = torch.cuda.max_memory_allocated()
        if launches == 0 or launches != 4 * iters:
            raise RuntimeError(f"LSTM kernel launches {launches} != 4 x {iters} forwards")
        cpu_model = make_model(TEACHER, device="cpu", seed=0)
        ref = cpu_model(wav[:1].cpu())
    got = out.wav[:1].cpu()
    err = (got - ref.wav).abs().max().item()
    taps = list(out.taps.encoder) + list(out.taps.decoder) + [out.taps.lstm_real]
    finite = bool(torch.isfinite(out.wav).all()) and all(bool(torch.isfinite(t).all()) for t in taps)
    shape_ok = tuple(out.wav.shape) == (batch, int(seconds * 16000))
    say("serving_teacher", config=TEACHER.name, batch=batch, seconds=seconds,
        forward_ms=wall * 1e3, rtf=wall / (batch * seconds), peak_mem_bytes=peak,
        lstm_launches=launches, max_abs_err_vs_cpu=err, tol=SERVING_ATOL,
        wav_absmax=float(out.wav.abs().max()), finite=finite, shape_ok=shape_ok)
    if not (finite and shape_ok) or err > SERVING_ATOL:
        raise RuntimeError("teacher forward on the card is wrong")
    return launches


def phase_backward_vs_plain():
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import (
        lstm_seq_bwd,
        lstm_seq_bwd_plan,
        lstm_seq_bwd_reference,
        lstm_seq_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    dev = torch.device("cuda")
    # (T, N=2B, H, initial state): the training step's student LSTM (T=483,
    # batch 32 -> N=64, H=32), batch 1, the teacher's width, ragged tiles of
    # 1, 2 and 4 rows, a call with an initial state, and the spkd step's
    # student LSTM on 33 s clips (T=5283) at batch 16 and at its card-vs-CPU
    # batch 2
    shapes = [(483, 64, 32, False), (483, 2, 32, False), (483, 64, 128, False),
              (20, 201, 128, False), (57, 3, 32, False), (118, 6, 32, True),
              (SPKD_FRAMES, 32, 32, False), (SPKD_FRAMES, 4, 32, False)]
    results = []
    for T, N, H, with_state in shapes:
        g = torch.Generator().manual_seed(2000 * H + N)
        xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
        w_hh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5).to(dev)
        dy = torch.randn(T, N, H, generator=g).to(dev)
        h0 = c0 = None
        if with_state:
            h0 = (torch.rand(N, H, generator=g) * 2 - 1).to(dev)
            c0 = torch.randn(N, H, generator=g).to(dev)
        with float32_math():
            y, c = lstm_seq_reference(xw, w_hh, h0, c0)
        before = lstm_seq_bwd.launches
        dxw, dw = lstm_seq_bwd(xw, w_hh, y, c, dy, h0, c0)
        again = lstm_seq_bwd(xw, w_hh, y, c, dy, h0, c0)
        if lstm_seq_bwd.launches != before + 2:
            raise RuntimeError("lstm_seq_bwd did not count its launches")
        with float32_math():
            rdxw, rdw = lstm_seq_bwd_reference(xw, w_hh, y, c, dy, h0, c0)
        torch.cuda.synchronize()
        err_dxw = (dxw - rdxw).abs().max().item()
        err_dw = (dw - rdw).abs().max().item() / max(1.0, rdw.abs().max().item())
        repeat = bool(torch.equal(dxw, again[0]) and torch.equal(dw, again[1]))
        ok = err_dxw <= KERNEL_ATOL and err_dw <= KERNEL_ATOL and repeat
        rec = {"T": T, "N": N, "H": H, "initial_state": with_state,
               "plan": lstm_seq_bwd_plan(H), "max_abs_err_dxw": err_dxw,
               "max_rel_err_dw_hh": err_dw, "tol": KERNEL_ATOL, "bitwise_repeat": repeat}
        del again
        if not with_state:
            ms = _time_ms(lambda: lstm_seq_bwd(xw, w_hh, y, c, dy), iters=20)
            with float32_math():
                plain_ms = _time_ms(lambda: lstm_seq_bwd_reference(xw, w_hh, y, c, dy),
                                    iters=1 if T > 1000 else 3)
            lib = torch.nn.LSTM(4 * H, H).to(dev)
            with float32_math():  # cuDNN's LSTM would take TF32 too
                with torch.no_grad():
                    lib.weight_ih_l0.copy_(torch.eye(4 * H))
                    lib.weight_hh_l0.copy_(w_hh.t())
                    lib.bias_ih_l0.zero_()
                    lib.bias_hh_l0.zero_()
                x_in = xw.clone().requires_grad_(True)
                lib_y = lib(x_in)[0]
                lib_dx, lib_dw = torch.autograd.grad(lib_y, (x_in, lib.weight_hh_l0), dy,
                                                     retain_graph=True)
                library_ms = _time_ms(lambda: torch.autograd.grad(
                    lib_y, (x_in, lib.weight_hh_l0), dy, retain_graph=True), iters=20)
            bound_ms, bound_by = _lstm_bwd_bound_ms(T, N, H)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       library_max_abs_err_dxw=(lib_dx - rdxw).abs().max().item(),
                       library_max_abs_err_dw_hh=(lib_dw.t() - rdw).abs().max().item(),
                       bound_ms=bound_ms, bound_by=bound_by)
        say("backward_vs_plain", **rec)
        if not ok:
            raise RuntimeError(f"lstm_seq_bwd disagrees with its plain version: {rec}")
        results.append(rec)
    return results


def train_batch(batch: int, seconds: float, seed: int = 2):
    """``batch`` synthetic (mixture, clean) pairs of ``seconds``, float32
    numpy ``[B, T]`` each."""
    import numpy as np

    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    ds = SyntheticEnhancementDataset(size=batch, segment=seconds, seed=seed)
    pairs = [ds[i] for i in range(batch)]
    return (np.stack([m for m, _ in pairs]), np.stack([c[0] for _, c in pairs]))


def train_config(batch: int, seconds: float, distill: dict = None):
    """``TrainConfig()`` at ``batch`` x ``seconds``, with the ``distill``
    fields (e.g. ``ABF_KERNEL_FLAGS``) set."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import DistillConfig, TrainConfig

    cfg = TrainConfig(distill=DistillConfig(**(distill or {})))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=batch, segment=seconds))


def _grads(trainer):
    return {f"{part}.{n}": p.grad.detach().cpu()
            for part, m in trainer.trainable().items() for n, p in m.named_parameters()}


def _grad_errors(card, cpu, grad_norm):
    """Relative L2 error of every gradient tensor, card against CPU: the
    worst and its tensor's name, and the worst of the exempt ones.  Two kinds
    are held otherwise (tests/test_torch_trainer.py says why): a conv bias in
    front of a batch-statistics BN has a zero gradient in exact arithmetic
    (rounding noise on both sides: held to ZERO_GRAD of the global norm), and
    an ABF bn2 bias is a sum of cancelling terms (held against the same
    block's bn2.scale gradient)."""
    import re

    worst, worst_name, exempt = 0.0, None, 0.0
    for name, want in cpu.items():
        got = card[name]
        if re.fullmatch(r"student\.(enc|dec)\d+_conv\.b[ri]", name) and \
                name.replace("_conv.br", "_bn.scale").replace("_conv.bi", "_bn.scale") in cpu:
            exempt = max(exempt, got.abs().max().item() / grad_norm,
                         want.abs().max().item() / grad_norm)
            continue
        ref = cpu[name[:-len("bias")] + "scale"] if name.endswith("bn2.bias") else want
        err = ((got - want).norm() / max(ref.norm(), 1e-30)).item()
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, exempt


def gaussian_batch(batch: int, seconds: float, seed: int = 0):
    """White-noise (mixture, clean) pairs at 0.1 scale, as the CPU tests
    use: flat spectra keep the log-magnitude loss well conditioned."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((batch, int(seconds * 16000)))).astype(np.float32)
    return clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32), clean


def _card_vs_cpu(mix, clean, distill: dict = None, rounding_floor: bool = False) -> dict:
    """One step on the card and one on the CPU from the same seeded weights
    (cuDNN set to deterministic algorithms for this step, so the comparison
    repeats) on ``mix``/``clean`` ``[B, T]``: the loss's relative error and
    the gradients' (``_grad_errors``), and the CPU step's seconds.

    ``rounding_floor``: also take the CPU step on the input rounded once
    more (each sample times 1 + 2^-23 in float32), and report the largest
    relative change of a gradient tensor that gives (``_grad_errors`` again):
    the floor below which no two float32 runs of the step can agree.  The
    gradients are then held to ``ROUNDING_FACTOR`` times it where that is
    above ``TRAIN_GRAD_REL_L2``."""
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    batch, samples = mix.shape
    cfg = train_config(batch, samples / 16000, distill)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card = Trainer(cfg, device="cuda").init_state(1)
        card_logs = card.train_step(mix, clean)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    t0 = time.perf_counter()
    cpu = Trainer(cfg, device="cpu").init_state(1)
    cpu_logs = cpu.train_step(mix, clean)
    cpu_seconds = time.perf_counter() - t0
    want = float(cpu_logs["train_loss"])
    grad_norm = float(cpu_logs["grad_norm"])
    cpu_grads = _grads(cpu)
    grad_err, grad_worst, zero_grad = _grad_errors(_grads(card), cpu_grads, grad_norm)
    rec = {"batch": batch, "seconds": samples / 16000,
           "loss_rel_err": abs(float(card_logs["train_loss"]) - want) / abs(want),
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_max_rel_l2": grad_err, "grad_worst": grad_worst,
           "grad_tol": TRAIN_GRAD_REL_L2, "zero_grad_max": zero_grad, "zero_grad_tol": ZERO_GRAD,
           "cpu_step_s": cpu_seconds}
    if rounding_floor:
        again = Trainer(cfg, device="cpu").init_state(1)
        again.train_step((mix * np.float32(1 + 2 ** -23)).astype(np.float32), clean)
        floor, floor_worst, _ = _grad_errors(_grads(again), cpu_grads, grad_norm)
        rec.update(rounding_floor=floor, rounding_floor_worst=floor_worst,
                   grad_tol=max(TRAIN_GRAD_REL_L2, ROUNDING_FACTOR * floor))
    return rec


def _kernel_counters() -> dict:
    """Every kernel wrapper of the training step, by kernel name."""
    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd
    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_fwd,
    )
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_wgrad
    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd
    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_bwd

    return {"lstm_seq_fwd": lstm_seq, "lstm_seq_bwd": lstm_seq_bwd,
            "conv3x3_fwd": conv3x3_fwd, "conv3x3_wgrad": conv3x3_wgrad,
            "attfuse_fwd": attention_fuse_fwd, "attfuse_bwd": attention_fuse_bwd,
            "abf_block_fwd": abf_block_fwd, "abf_block_bwd": abf_block_bwd,
            "gram_pair_fwd": gram_pair_fwd}


def fitting_trainer(distill: dict, seconds: float):
    """A ``Trainer`` on the card at full width on clips of ``seconds``, after
    one warm-up step, at the largest batch from 32 down, halving, that fits:
    ``(trainer, batch, cut, mix, clean)``, ``cut`` listing each halving."""
    import torch

    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    batch, cut = TEACHER_BATCH, []
    while True:
        mix, clean = train_batch(batch, seconds)
        trainer = Trainer(train_config(batch, seconds, distill), device="cuda").init_state(0)
        try:
            trainer.train_step(mix, clean)  # warm-up
            torch.cuda.synchronize()
            return trainer, batch, cut, mix, clean
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
        # out of the handler, so the failed step's tensors are released first
        del trainer
        torch.cuda.empty_cache()
        cut.append(f"batch {batch} does not fit; halved")
        batch //= 2


def _training(phase: str, config: str, distill: dict, steps: int, expected: dict,
              seconds: float = TRAIN_SECONDS, check_batch: int = CHECK_BATCH,
              check_seconds: float = CHECK_SECONDS, rounding_floor: bool = False) -> dict:
    """One warm-up and ``steps`` timed steps at full width on 32 clips of
    ``seconds`` (batch halved while it does not fit), launches per step held
    to ``expected`` (every other kernel: none), then the card-vs-CPU step on
    ``check_batch`` clips of ``check_seconds`` (``rounding_floor``: its
    gradients held against their own rounding floor, ``_card_vs_cpu``)."""
    import numpy as np
    import torch

    counters = _kernel_counters()
    trainer, batch, cut, mix, clean = fitting_trainer(distill, seconds)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for fn in counters.values():
        fn.launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        logs = trainer.train_step(mix, clean)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["train_loss"]))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in launches.items()}
    finite = bool(np.isfinite(losses).all()) and all(
        bool(torch.isfinite(v).all()) for v in logs.values())
    median_s = float(np.median(step_ms)) / 1e3
    rec = dict(config=config, batch=batch, seconds=seconds, cut=cut,
               steps=steps, step_ms_median=median_s * 1e3,
               step_ms_p90=float(np.percentile(step_ms, 90)), step_ms=step_ms,
               audio_s_per_s=batch * seconds / median_s, peak_mem_bytes=peak,
               losses=losses, logs_last={k: float(v) for k, v in logs.items()},
               launches=launches, launches_per_step=per_step, finite=finite)
    del trainer
    torch.cuda.empty_cache()

    # one step on the card against one on the CPU from the same seeded weights
    rec["card_vs_cpu"] = {
        "gaussian": _card_vs_cpu(*gaussian_batch(check_batch, check_seconds), distill,
                                 rounding_floor),
        "speech": _card_vs_cpu(*train_batch(check_batch, check_seconds, seed=3), distill)}
    say(phase, **rec)
    want = {name: expected.get(name, 0) for name in counters}
    if per_step != want:
        raise RuntimeError(f"kernel launches per step {per_step}, expected {want}")
    if not finite:
        raise RuntimeError("a training step gave a non-finite value")
    gate = rec["card_vs_cpu"]["gaussian"]
    if (any(c["loss_rel_err"] > TRAIN_LOSS_RTOL for c in rec["card_vs_cpu"].values())
            or gate["grad_max_rel_l2"] > gate["grad_tol"] or gate["zero_grad_max"] > ZERO_GRAD):
        raise RuntimeError("the training step on the card disagrees with the CPU")
    return rec


def phase_training():
    return _training("training", "clskd TrainConfig()", {}, TRAIN_STEPS,
                     {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4})


def phase_training_kernels():
    return _training("training_kernels", "clskd TrainConfig(distill=DistillConfig("
                     "abf_conv_pallas=True, abf_attfuse_pallas=True))", ABF_KERNEL_FLAGS,
                     KERNEL_TRAIN_STEPS,
                     {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4, "conv3x3_fwd": 24,
                      "conv3x3_wgrad": 12, "attfuse_fwd": 10, "attfuse_bwd": 10})


def phase_training_block():
    return _training("training_block", "clskd TrainConfig(distill=DistillConfig("
                     "abf_block_pallas=True))", ABF_BLOCK_FLAGS, KERNEL_TRAIN_STEPS,
                     {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4, "abf_block_fwd": 12,
                      "abf_block_bwd": 12})


def _bound(nbytes: float, flops: float) -> tuple:
    """The least time for ``nbytes`` moved and ``flops`` f32 operations."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_3xtf32(nbytes: float, flops: float) -> tuple:
    """The least time for ``nbytes`` moved and ``flops`` f32 operations done
    as three TF32 tensor-core products each."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _conv_case(B, D, T, C, O, timed: bool) -> dict:
    """K3f and K3w against their plain versions at x [B, D, T, C] -> O."""
    import torch
    import torch.nn.functional as F

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
        conv3x3_fwd,
        conv3x3_fwd_route,
        conv3x3_reference,
        conv3x3_wgrad,
        conv3x3_wgrad_reference,
        conv3x3_wgrad_route,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + C + O)
    x = torch.randn(B, D, T, C, device="cuda", generator=g)
    w = torch.randn(3, 3, C, O, device="cuda", generator=g) / (3 * C ** 0.5)
    gy = torch.randn(B, D, T, O, device="cuda", generator=g)
    before = (conv3x3_fwd.launches, conv3x3_wgrad.launches)
    out = conv3x3_fwd(x, w)
    out_again = conv3x3_fwd(x, w)
    dw = conv3x3_wgrad(x, gy)
    dw_again = conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    if (conv3x3_fwd.launches, conv3x3_wgrad.launches) != (before[0] + 2, before[1] + 2):
        raise RuntimeError("conv3x3 kernels did not count their launches")
    with float32_math():
        ref = conv3x3_reference(x, w)
        err_fwd = (out - ref).abs().max().item()
        del ref
        err_dw = _rel_l2(dw, conv3x3_wgrad_reference(x, gy))
    rec = {"B": B, "D": D, "T": T, "C": C, "O": O, "fwd_route": conv3x3_fwd_route(C, O),
           "wgrad_route": conv3x3_wgrad_route(C, O),
           "fwd_max_abs_err": err_fwd, "fwd_bitwise_repeat": bool(torch.equal(out, out_again)),
           "wgrad_rel_l2": err_dw, "wgrad_bitwise_repeat": bool(torch.equal(dw, dw_again)),
           "tol": KERNEL_ATOL}
    del out_again
    if timed:
        rows = B * D * T
        flops = 2.0 * rows * 9 * C * O
        x_nchw, gy_nchw = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        with float32_math():  # cuDNN would take TF32 otherwise
            fwd_library_ms = _time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), iters=5)
            wgrad_library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, w_oihw.shape, gy_nchw, padding=1), iters=5)
            fwd_plain_ms = _time_ms(lambda: conv3x3_reference(x, w), iters=2)
            wgrad_plain_ms = _time_ms(lambda: conv3x3_wgrad_reference(x, gy), iters=2)
        # cuDNN in TF32, what PyTorch gives by default; not the yardstick
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=True):
            fwd_library_tf32_ms = _time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1),
                                           iters=5)
        fwd_bytes = 4.0 * (rows * C + 9 * C * O + rows * O)
        fwd_bound_f32 = _bound(fwd_bytes, flops)
        # route "mma" does each multiply-add as three TF32 products on the
        # tensor cores: its operations, at their peak, bound it
        fwd_bound = (_bound_3xtf32(fwd_bytes, flops) if rec["fwd_route"] == "mma"
                     else fwd_bound_f32)
        wgrad_bytes = 4.0 * (rows * C + rows * O + 9 * C * O)
        wgrad_bound_f32 = _bound(wgrad_bytes, flops)
        wgrad_bound = (_bound_3xtf32(wgrad_bytes, flops) if rec["wgrad_route"] == "mma"
                       else wgrad_bound_f32)
        rec.update(
            fwd_ms=_time_ms(lambda: conv3x3_fwd(x, w), iters=5), fwd_plain_ms=fwd_plain_ms,
            fwd_library_ms=fwd_library_ms, fwd_library_tf32_ms=fwd_library_tf32_ms,
            fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
            fwd_bound_f32_ms=fwd_bound_f32[0],
            wgrad_ms=_time_ms(lambda: conv3x3_wgrad(x, gy), iters=5),
            wgrad_plain_ms=wgrad_plain_ms, wgrad_library_ms=wgrad_library_ms,
            wgrad_bound_ms=wgrad_bound[0], wgrad_bound_by=wgrad_bound[1],
            wgrad_bound_f32_ms=wgrad_bound_f32[0])
    return rec


def _step_conv_case(B, D, T, C, O) -> dict:
    """K3f alone at one of the kernel-config step's conv shapes: its route,
    error against the plain version, a bitwise repeat, and its time beside
    cuDNN's ``F.conv2d`` (TF32 off)."""
    import torch
    import torch.nn.functional as F

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
        conv3x3_fwd,
        conv3x3_fwd_route,
        conv3x3_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + C + O)
    x = torch.randn(B, D, T, C, device="cuda", generator=g)
    w = torch.randn(3, 3, C, O, device="cuda", generator=g) / (3 * C ** 0.5)
    before = conv3x3_fwd.launches
    out = conv3x3_fwd(x, w)
    repeat = bool(torch.equal(out, conv3x3_fwd(x, w)))
    if conv3x3_fwd.launches != before + 2:
        raise RuntimeError("conv3x3_fwd did not count its launches")
    with float32_math():
        err = (out - conv3x3_reference(x, w)).abs().max().item()
        del out
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        library_ms = _time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), iters=5)
    return {"B": B, "D": D, "T": T, "C": C, "O": O, "fwd_route": conv3x3_fwd_route(C, O),
            "fwd_max_abs_err": err, "fwd_bitwise_repeat": repeat, "tol": KERNEL_ATOL,
            "fwd_ms": _time_ms(lambda: conv3x3_fwd(x, w), iters=5),
            "fwd_library_ms": library_ms}


def _step_wgrad_case(B, D, T, C, O) -> dict:
    """K3w alone at one of the kernel-config step's weight-gradient shapes
    (x [B, D, T, C], g [B, D, T, O]): its route, relative L2 error against
    the plain version, a bitwise repeat, its launches, and its time beside
    the bound and ``torch.nn.grad.conv2d_weight`` (TF32 off)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
        conv3x3_wgrad,
        conv3x3_wgrad_reference,
        conv3x3_wgrad_route,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + C + O + 1)
    x = torch.randn(B, D, T, C, device="cuda", generator=g)
    gy = torch.randn(B, D, T, O, device="cuda", generator=g)
    before = conv3x3_wgrad.launches
    dw = conv3x3_wgrad(x, gy)
    repeat = bool(torch.equal(dw, conv3x3_wgrad(x, gy)))
    torch.cuda.synchronize()
    launched = conv3x3_wgrad.launches - before
    with float32_math():
        err = _rel_l2(dw, conv3x3_wgrad_reference(x, gy))
        del dw
        x_nchw, gy_nchw = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (O, C, 3, 3), gy_nchw, padding=1), iters=5)
    route = conv3x3_wgrad_route(C, O)
    rows = B * D * T
    nbytes, flops = 4.0 * (rows * C + rows * O + 9 * C * O), 2.0 * rows * 9 * C * O
    bound = _bound_3xtf32(nbytes, flops) if route == "mma" else _bound(nbytes, flops)
    return {"B": B, "D": D, "T": T, "C": C, "O": O, "wgrad_route": route,
            "wgrad_rel_l2": err, "wgrad_bitwise_repeat": repeat, "tol": KERNEL_ATOL,
            "wgrad_launches": launched,
            "wgrad_ms": _time_ms(lambda: conv3x3_wgrad(x, gy), iters=5),
            "wgrad_library_ms": library_ms, "wgrad_bound_ms": bound[0],
            "wgrad_bound_by": bound[1], "wgrad_bound_f32_ms": _bound(nbytes, flops)[0]}


def _fuse_case(B, D, Dp, T, C, timed: bool) -> dict:
    """K4f and K4b against their plain versions at x [B, D, T, C] with the
    residual [B, Dp, T, C]."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_bwd_reference,
        attention_fuse_fwd,
        attention_fuse_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + Dp + C)
    x = torch.randn(B, D, T, C, device="cuda", generator=g)
    res = torch.randn(B, Dp, T, C, device="cuda", generator=g)
    wx = 0.3 * torch.randn(C, 2, device="cuda", generator=g)
    wy = 0.3 * torch.randn(C, 2, device="cuda", generator=g)
    bias = 0.1 * torch.randn(2, device="cuda", generator=g)
    gy = torch.randn(B, D, T, C, device="cuda", generator=g)
    before = (attention_fuse_fwd.launches, attention_fuse_bwd.launches)
    out, z = attention_fuse_fwd(x, res, wx, wy, bias)
    grads = attention_fuse_bwd(x, res, z, gy, wx, wy)
    again = attention_fuse_bwd(x, res, z, gy, wx, wy)
    torch.cuda.synchronize()
    if (attention_fuse_fwd.launches, attention_fuse_bwd.launches) != (before[0] + 1,
                                                                      before[1] + 2):
        raise RuntimeError("attention fuse kernels did not count their launches")
    with float32_math():
        rout, rz = attention_fuse_reference(x, res, wx, wy, bias)
        err_fwd = max((out - rout).abs().max().item(), (z - rz).abs().max().item())
        del rout, rz
        want = attention_fuse_bwd_reference(x, res, z, gy, wx, wy)
    err_maps = max((a - b).abs().max().item() for a, b in zip(grads[:2], want[:2]))
    err_params = max(_rel_l2(a, b) for a, b in zip(grads[2:], want[2:]))
    del want
    rec = {"B": B, "D": D, "Dp": Dp, "T": T, "C": C, "fwd_max_abs_err": err_fwd,
           "bwd_max_abs_err_dx_dres": err_maps, "bwd_rel_l2_dwx_dwy_db": err_params,
           "bwd_bitwise_repeat": all(bool(torch.equal(a, b)) for a, b in zip(grads, again)),
           "tol": KERNEL_ATOL}
    if timed:
        rows, res_rows = B * D * T, B * Dp * T
        fwd_bound = _bound(4.0 * (2 * rows * C + res_rows * C + 4 * C + 2 + 2 * rows),
                           rows * (8.0 * C + 10))
        bwd_bound = _bound(4.0 * (3 * rows * C + 2 * res_rows * C + 2 * rows + 8 * C + 2),
                           rows * (14.0 * C + 10))
        with float32_math():
            fwd_plain_ms = _time_ms(lambda: attention_fuse_reference(x, res, wx, wy, bias),
                                    iters=3)
            bwd_plain_ms = _time_ms(
                lambda: attention_fuse_bwd_reference(x, res, z, gy, wx, wy), iters=3)
        rec.update(
            fwd_ms=_time_ms(lambda: attention_fuse_fwd(x, res, wx, wy, bias), iters=10),
            fwd_plain_ms=fwd_plain_ms, fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
            bwd_ms=_time_ms(lambda: attention_fuse_bwd(x, res, z, gy, wx, wy), iters=10),
            bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
    return rec


# phase 8's shapes.  Conv (B, D, T, C, O, timed): the shallowest encoder
# block (D=4 -> 256), the table's reference shape (D=64, 64 -> 64), the
# decoder's mask block (D=256 -> 2), the dx pass of a 256-channel block
# (C=256 -> 64) and small ragged ones.  Fuse (B, D, Dp, T, C, timed): the
# table's reference shape (k=2) and small ragged ones with k=1 and k=4.
CONV_CASES = [(32, 4, 483, 64, 256, False), (32, 64, 483, 64, 64, True),
              (32, 256, 483, 64, 2, False), (32, 16, 483, 256, 64, False),
              (3, 5, 37, 64, 32, False), (2, 3, 19, 2, 64, False)]
CONV_REF = (32, 64, 483, 64, 64)
# The 12 ABF conv2 forwards of the kernel-config step at 32 x 3 s (D, C, O):
# mid C = 64 to each teacher tap's O, the encoder chain's blocks deepest first
# (D 4 .. 128) and the decoder chain's (D 8 .. 256); their dx passes swap C
# and O.  Each (D, C, O) with its count a step.
STEP_CONV_FWD = [(4, 64, 256), (8, 64, 256), (16, 64, 256), (32, 64, 128), (64, 64, 64),
                 (128, 64, 32), (8, 64, 256), (16, 64, 256), (32, 64, 128), (64, 64, 64),
                 (128, 64, 32), (256, 64, 2)]
FUSE_CASES = [(32, 128, 64, 483, 64, True), (3, 5, 5, 37, 64, False),
              (2, 16, 4, 29, 64, False)]
FUSE_REF = (32, 128, 64, 483, 64)


def phase_abf_kernels_vs_plain():
    import torch

    conv, fuse = [], []
    for *shape, timed in CONV_CASES:
        rec = _conv_case(*shape, timed=timed)
        say("abf_kernels_vs_plain", kernel="conv3x3", **rec)
        conv.append(rec)
        torch.cuda.empty_cache()
        if not (rec["fwd_max_abs_err"] <= KERNEL_ATOL and rec["wgrad_rel_l2"] <= KERNEL_ATOL
                and rec["fwd_bitwise_repeat"] and rec["wgrad_bitwise_repeat"]):
            raise RuntimeError(f"conv3x3 kernels disagree with their plain versions: {rec}")
    step_convs = {}
    for D, C, O in STEP_CONV_FWD:
        for pass_, (c, o) in (("fwd", (C, O)), ("dx", (O, C))):
            key = (D, c, o)
            step_convs.setdefault(key, {"passes": [], "count": 0})
            step_convs[key]["passes"].append(pass_)
            step_convs[key]["count"] += 1
    for (D, C, O), use in step_convs.items():
        rec = _step_conv_case(TEACHER_BATCH, D, 483, C, O)
        rec.update(use)
        say("abf_kernels_vs_plain", kernel="conv3x3_fwd", step_shape=True, **rec)
        conv.append(rec)
        torch.cuda.empty_cache()
        if not (rec["fwd_max_abs_err"] <= KERNEL_ATOL and rec["fwd_bitwise_repeat"]):
            raise RuntimeError(f"conv3x3_fwd disagrees with its plain version: {rec}")
    for D, C, O in dict.fromkeys(STEP_CONV_FWD):  # the distinct wgrad shapes, in order
        rec = _step_wgrad_case(TEACHER_BATCH, D, 483, C, O)
        rec["count"] = STEP_CONV_FWD.count((D, C, O))
        say("abf_kernels_vs_plain", kernel="conv3x3_wgrad", step_shape=True, **rec)
        conv.append(rec)
        torch.cuda.empty_cache()
        if not (rec["wgrad_rel_l2"] <= KERNEL_ATOL and rec["wgrad_bitwise_repeat"]
                and rec["wgrad_launches"] == 2):
            raise RuntimeError(f"conv3x3_wgrad disagrees with its plain version: {rec}")
    for *shape, timed in FUSE_CASES:
        rec = _fuse_case(*shape, timed=timed)
        say("abf_kernels_vs_plain", kernel="attention_fuse", **rec)
        fuse.append(rec)
        torch.cuda.empty_cache()
        if not (rec["fwd_max_abs_err"] <= KERNEL_ATOL
                and rec["bwd_max_abs_err_dx_dres"] <= KERNEL_ATOL
                and rec["bwd_rel_l2_dwx_dwy_db"] <= KERNEL_ATOL and rec["bwd_bitwise_repeat"]):
            raise RuntimeError(f"attention fuse kernels disagree with their plain versions: {rec}")
    return conv, fuse


def _block_bounds(fuse, B, D, k, T, Cs, M, O) -> dict:
    """K5f's and K5b's bounds: each input read once and each output written
    once; the operations of the 1x1 conv (2 Cs M a pixel), the attention
    (4 Cs + 4 M logits, ~3 M blend and ~8 sigmoid a pixel) and the 3x3 conv
    (18 M O a pixel) forward; backward the conv adjoint and dw2 (18 M O
    each), xhat again, g_tap and dw1a (6 Cs M) and the attention's ~4 Cs +
    16 M.  A 3x3 conv on a tensor-core route (K5f's conv and K5b's adjoint
    on route "mma", dw2 on K3w's) counts three TF32 products a multiply-add
    at their peak, the rest f32 at its peak ("the design's" bound, as K3f's);
    the all-f32 bound beside it."""
    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
        abf_block_bwd_route,
        abf_block_fwd_route,
    )
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_wgrad_route

    rows, res_rows = B * D * T, (B * D * T // k if fuse else 0)
    small = Cs * M + 3 * M + 2 * Cs + 2 + 9 * M * O
    conv = rows * 18.0 * M * O
    fwd_rest = rows * (2.0 * Cs * M + ((4 * Cs + 7 * M + 8) if fuse else M))
    bwd_rest = rows * (6.0 * Cs * M + ((4 * Cs + 16 * M) if fuse else M))
    fwd_bytes = 4.0 * (rows * Cs + res_rows * M + small + rows * M + rows * O)
    bwd_bytes = 4.0 * (2 * rows * Cs + 2 * res_rows * M + 2 * rows * M + rows * O + 2 * small)

    def bound(nbytes, tf32_flops, f32_flops):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = (3 * tf32_flops / PEAK_TF32_FLOP_S + f32_flops / PEAK_F32_FLOP_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    fwd_mma = abf_block_fwd_route(M, O) == "mma"
    adj_mma = abf_block_bwd_route(M, O) == "mma"
    dw2_mma = conv3x3_wgrad_route(M, O) == "mma"
    fwd_tc = conv if fwd_mma else 0.0
    bwd_tc = conv * (adj_mma + dw2_mma)
    return {"fwd": bound(fwd_bytes, fwd_tc, conv + fwd_rest - fwd_tc),
            "fwd_f32": _bound(fwd_bytes, conv + fwd_rest),
            "bwd": bound(bwd_bytes, bwd_tc, 2 * conv + bwd_rest - bwd_tc),
            "bwd_f32": _bound(bwd_bytes, 2 * conv + bwd_rest),
            "fwd_route": "mma" if fwd_mma else "direct",
            "bwd_route": "mma" if adj_mma else "direct"}


def _block_inputs(fuse, B, D, k, T, Cs, M, O):
    """Seeded inputs of one block on the card: ``(kwargs of abf_block, g_xf,
    g_out)``, w1a at the scale bn1 gives it (xhat of unit variance)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(B * D + k + Cs + O)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=g)

    kw = dict(tap=r(B, D, T, Cs), res=r(B, D // k, T, M) if fuse else None,
              w1a=r(Cs, M, scale=Cs ** -0.5), bvec=r(M, scale=0.2), wxt=r(Cs, 2, scale=0.3),
              wy=r(M, 2, scale=0.3), zoff=r(2, scale=0.1),
              w2=r(3, 3, M, O, scale=1 / (3 * M ** 0.5)))
    return kw, r(B, D, T, M), r(B, D, T, O)


def _per_op(kw, xf, gxf, gout):
    """The per-op kernel path on the same block, forward and backward: the
    xhat matmul, K4f and K3f; K3f's dx pass (+ g_xf), K3w, K4b and the 1x1
    conv's two matmuls (raw attention weights drawn here)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_fwd,
    )
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_wgrad

    fuse = kw["res"] is not None
    Cs, M = kw["w1a"].shape
    g = torch.Generator(device="cuda").manual_seed(M + Cs)
    wx = 0.3 * torch.randn(M, 2, device="cuda", generator=g)
    bias = 0.1 * torch.randn(2, device="cuda", generator=g)
    wy = kw["wy"]
    w2f = kw["w2"].flip(0, 1).transpose(2, 3).contiguous()
    xhat = kw["tap"] @ kw["w1a"] + kw["bvec"]
    z = attention_fuse_fwd(xhat, kw["res"], wx, wy, bias)[1] if fuse else None
    tap2 = kw["tap"].reshape(-1, Cs)

    def fwd():
        xh = kw["tap"] @ kw["w1a"] + kw["bvec"]
        xff = attention_fuse_fwd(xh, kw["res"], wx, wy, bias)[0] if fuse else xh
        return conv3x3_fwd(xff, kw["w2"])

    def bwd():
        dxf = conv3x3_fwd(gout, w2f) + gxf
        conv3x3_wgrad(xf, gout)
        gx = attention_fuse_bwd(xhat, kw["res"], z, dxf, wx, wy)[0] if fuse else dxf
        gx2 = gx.reshape(-1, M)
        return gx2 @ kw["w1a"].T, tap2.T @ gx2

    return fwd, bwd


def _block_case(fuse, B, D, k, T, Cs, M, O, timed: bool) -> dict:
    """K5f and K5b against their plain versions at tap [B, D, T, Cs], the
    residual [B, D/k, T, M] (or none), mid M and O output channels; two runs
    of each give the same bits."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
        abf_block_bwd,
        abf_block_bwd_reference,
        abf_block_fwd,
        abf_block_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    kw, gxf, gout = _block_inputs(fuse, B, D, k, T, Cs, M, O)
    before = (abf_block_fwd.launches, abf_block_bwd.launches)
    xf, out = abf_block_fwd(**kw)
    xf_again, out_again = abf_block_fwd(**kw)
    fwd_repeat = bool(torch.equal(xf, xf_again)) and bool(torch.equal(out, out_again))
    del xf_again, out_again
    grads = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    again = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    torch.cuda.synchronize()
    if (abf_block_fwd.launches, abf_block_bwd.launches) != (before[0] + 2, before[1] + 2):
        raise RuntimeError("abf_block kernels did not count their launches")
    names = ("g_tap", "g_res", "dw1a", "dbvec", "dwxt", "dwy", "dzoff", "dw2")
    with float32_math():
        rxf, rout = abf_block_reference(**kw)
        err_fwd = max((xf - rxf).abs().max().item(), (out - rout).abs().max().item())
        rel_fwd = max((xf - rxf).abs().max().item() / max(1.0, rxf.abs().max().item()),
                      (out - rout).abs().max().item() / max(1.0, rout.abs().max().item()))
        del rout
        want = abf_block_bwd_reference(**kw, xf=rxf, gxf=gxf, gout=gout)
        del rxf
    bwd_rel = {n: _rel_l2(a, b) for n, a, b in zip(names, grads, want) if b is not None}
    bwd_abs = max((a - b).abs().max().item() for a, b in zip(grads[:2], want[:2])
                  if b is not None)
    del want
    bounds = _block_bounds(fuse, B, D, k, T, Cs, M, O)
    rec = {"fuse": fuse, "B": B, "D": D, "k": k, "T": T, "Cs": Cs, "M": M, "O": O,
           "fwd_route": bounds["fwd_route"], "bwd_route": bounds["bwd_route"],
           "fwd_max_abs_err": err_fwd, "fwd_max_rel_err": rel_fwd,
           "fwd_bitwise_repeat": fwd_repeat, "bwd_rel_l2": bwd_rel,
           "bwd_max_rel_l2": max(bwd_rel.values()), "bwd_max_abs_err_g_tap_g_res": bwd_abs,
           "bwd_bitwise_repeat": all(a is None or bool(torch.equal(a, b))
                                     for a, b in zip(grads, again)),
           "fwd_tol": BLOCK_FWD_TOL, "bwd_tol": BLOCK_REL_L2}
    del grads, again
    if timed:
        per_op_fwd, per_op_bwd = _per_op(kw, xf, gxf, gout)
        with float32_math():
            rec.update(
                fwd_ms=_time_ms(lambda: abf_block_fwd(**kw), iters=5),
                fwd_plain_ms=_time_ms(lambda: abf_block_reference(**kw), iters=2),
                fwd_per_op_ms=_time_ms(per_op_fwd, iters=5),
                fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
                fwd_bound_f32_ms=bounds["fwd_f32"][0],
                bwd_ms=_time_ms(lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout), iters=5),
                bwd_plain_ms=_time_ms(lambda: abf_block_bwd_reference(
                    **kw, xf=xf, gxf=gxf, gout=gout), iters=2),
                bwd_per_op_ms=_time_ms(per_op_bwd, iters=5),
                bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
                bwd_bound_f32_ms=bounds["bwd_f32"][0])
    return rec


def _step_block_case(fuse, D, Cs, O) -> dict:
    """K5f, K5b and the per-op path alone at one of the block-config step's
    block shapes (B=32, T=483, M=64, k=2 where it fuses): kernel times and
    routes, no plain version."""
    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    B, T, M, k = TEACHER_BATCH, 483, 64, (2 if fuse else 1)
    kw, gxf, gout = _block_inputs(fuse, B, D, k, T, Cs, M, O)
    xf, _ = abf_block_fwd(**kw)
    per_op_fwd, per_op_bwd = _per_op(kw, xf, gxf, gout)
    bounds = _block_bounds(fuse, B, D, k, T, Cs, M, O)
    with float32_math():
        return {"fuse": fuse, "B": B, "D": D, "k": k, "T": T, "Cs": Cs, "M": M, "O": O,
                "fwd_route": bounds["fwd_route"], "bwd_route": bounds["bwd_route"],
                "fwd_ms": _time_ms(lambda: abf_block_fwd(**kw), iters=5),
                "fwd_per_op_ms": _time_ms(per_op_fwd, iters=5),
                "fwd_bound_ms": bounds["fwd"][0],
                "bwd_ms": _time_ms(lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout),
                                   iters=5),
                "bwd_per_op_ms": _time_ms(per_op_bwd, iters=5),
                "bwd_bound_ms": bounds["bwd"][0]}


# phase 10's shapes (fuse, B, D, k, T, Cs, M, O, timed): the training step's
# reference block (encoder D=64, Cs=16 -> 64; its conv is phase 8's reference
# conv), the decoder's mask block (D=256, Cs=2 -> 2: xf has 253 M elements),
# the deepest encoder block (no fuse, D=4, Cs=64 -> 256), and small ragged
# ones: k = 1 and 4, T past the tiles, D of one row with k = 2, no fuse
BLOCK_CASES = [(True, 32, 64, 2, 483, 16, 64, 64, True),
               (True, 32, 256, 2, 483, 2, 64, 2, True),
               (False, 32, 4, 1, 483, 64, 64, 256, True),
               (True, 3, 5, 1, 37, 16, 64, 32, False), (True, 2, 16, 4, 29, 8, 64, 16, False),
               (True, 2, 2, 2, 70, 4, 64, 5, False), (False, 2, 1, 1, 11, 3, 8, 7, False)]
BLOCK_REF = (True, 32, 64, 2, 483, 16, 64, 64)
# The 12 ABF blocks of the block-config step at 32 x 3 s (fuse, D, Cs, O):
# the student tap's Cs to each teacher tap's O through mid 64, the encoder
# chain's blocks deepest first (D 4 .. 128) and the decoder chain's (D 8 ..
# 256, its last the mask block); k = 2 wherever a block fuses.  The same
# blocks as STEP_CONV_FWD.
STEP_BLOCKS = [(False, 4, 64, 256), (True, 8, 64, 256), (True, 16, 64, 256),
               (True, 32, 32, 128), (True, 64, 16, 64), (True, 128, 8, 32),
               (False, 8, 64, 256), (True, 16, 64, 256), (True, 32, 32, 128),
               (True, 64, 16, 64), (True, 128, 8, 32), (True, 256, 2, 2)]


def phase_abf_block_vs_plain():
    import torch

    cases = []
    for *shape, timed in BLOCK_CASES:
        rec = _block_case(*shape, timed=timed)
        say("abf_block_vs_plain", **rec)
        cases.append(rec)
        torch.cuda.empty_cache()
        if not (rec["fwd_max_rel_err"] <= BLOCK_FWD_TOL and rec["bwd_max_rel_l2"] <= BLOCK_REL_L2
                and rec["fwd_bitwise_repeat"] and rec["bwd_bitwise_repeat"]):
            raise RuntimeError(f"abf_block kernels disagree with their plain versions: {rec}")
    steps = []
    for shape in dict.fromkeys(STEP_BLOCKS):  # the distinct step shapes, in order
        rec = _step_block_case(*shape)
        rec["count"] = STEP_BLOCKS.count(shape)
        say("abf_block_vs_plain", step_shape=True, **rec)
        steps.append(rec)
        torch.cuda.empty_cache()
    per_step = {key: sum(r["count"] * r[key] for r in steps)
                for key in ("fwd_ms", "bwd_ms", "fwd_per_op_ms", "bwd_per_op_ms")}
    say("abf_block_vs_plain", step_sums_ms=per_step, blocks_a_step=len(STEP_BLOCKS))
    return cases, steps, per_step


# K2's timing (phase 12, scripts/kernel_pair_timing.py): where both inputs
# together are smaller than the card's 50 MB L2, a write over FLUSH_BYTES,
# read back, evicts them between launches and leaves no dirty line to write
# back during the kernel (in the step they arrive from the iSTFT)
L2_BYTES = 50 * 2 ** 20
FLUSH_BYTES = 128 * 2 ** 20
# cycles of a device-side wait that holds the profiled loop's launches back
# until all are queued, so host gaps do not count as device time (~5 ms)
QUEUE_CYCLES = 10_000_000


def _flusher(nbytes: int):
    """A function that writes over ``FLUSH_BYTES`` of the card and reads it
    back where ``nbytes`` of inputs would stay in L2 between launches, else
    None."""
    import torch

    if nbytes >= L2_BYTES:
        return None
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
        scratch.max()

    return flush


def _event_ms(fn, iters: int, flush=None) -> float:
    """CUDA-event ms a call of ``fn``: back to back, or, with ``flush``, each
    call alone after a flush (events around the call only)."""
    import torch

    if flush is None:
        return _time_ms(fn, iters)
    fn()
    pairs = []
    for _ in range(iters):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def gram_times(fn, nbytes: int, iters: int = 20) -> dict:
    """K2's times for ``fn`` (one ``gram_pair_fwd`` call on ``nbytes`` of
    inputs), L2 flushed between launches where the inputs fit in it:

    - ``ms``: device time a call, from the profiler's device events: the
      first pass's start to the second pass's end (``gram_*`` kernels, two
      a call; the calls queued behind a device-side wait, so that none waits
      for the host), with ``pass1_ms`` and ``pass2_ms`` (the second pass
      from where the first ends, as it may start earlier and wait);
    - ``event_ms``: CUDA events (back to back without a flush, so a
      host-bound loop shows here and not in ``ms``);
    - ``host_ms``: host time to enqueue one call."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = _flusher(nbytes)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and "gram_" in e.name), key=lambda e: e.time_range.start)
    if len(events) != 2 * iters:
        raise RuntimeError(f"the profiler saw {len(events)} gram_* kernels for {iters} calls: "
                           f"{sorted({e.name for e in events})}")
    firsts, seconds = events[0::2], events[1::2]
    us = 1e3 * iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return {
        "ms": sum(b.time_range.end - a.time_range.start for a, b in zip(firsts, seconds)) / us,
        "pass1_ms": sum(a.time_range.end - a.time_range.start for a in firsts) / us,
        "pass2_ms": sum(b.time_range.end - max(b.time_range.start, a.time_range.end)
                        for a, b in zip(firsts, seconds)) / us,
        "kernels": sorted({re.search(r"gram_\w+", e.name).group(0) for e in events}),
        "event_ms": _event_ms(fn, iters),
        "host_ms": host_ms,
        "l2_flushed": flush is not None,
    }


def _gram_case(B: int, ds: int, dt: int, timed: bool) -> dict:
    """K2 against its plain version on s [B, ds] and t [B, dt] (waveform-like
    values in [-1, 1])."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd, gram_pair_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B + ds + dt)
    s = (0.3 * torch.randn(B, ds, device="cuda", generator=g)).clamp(-1, 1)
    t = (0.3 * torch.randn(B, dt, device="cuda", generator=g)).clamp(-1, 1)
    before = gram_pair_fwd.launches
    got = gram_pair_fwd(s, t)
    again = gram_pair_fwd(s, t)
    torch.cuda.synchronize()
    if gram_pair_fwd.launches != before + 2:
        raise RuntimeError("gram_pair_fwd did not count its launches")
    with float32_math():
        want = gram_pair_reference(s, t)
        exact = [(z.double() @ z.double().T) for z in (s, t)]

    def rel(pair, truth):
        return max(((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
                   for a, b in zip(pair, truth))

    abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    rel_err = rel(got, want)
    # beside the tolerance: the kernel's and the plain version's own errors
    # against the float64 Gram
    rec = {"B": B, "Ds": ds, "Dt": dt, "max_abs_err": abs_err, "max_rel_err": rel_err,
           "rel_err_f64": rel(got, exact), "plain_rel_err_f64": rel(want, exact),
           "tol": GRAM_TOL, "bitwise_repeat": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
           "symmetric": all(bool(torch.equal(a, a.T)) for a in got)}
    if timed:
        nbytes = 4 * B * (ds + dt)
        # f32 FMA over the upper triangles: B (B + 1) / 2 multiply-adds a column
        bound_ms, bound_by = _bound(nbytes, 1.0 * B * (B + 1) * (ds + dt))
        flush = _flusher(nbytes)
        with float32_math():  # the yardstick in full float32, as the port's matmuls
            plain_ms = _event_ms(lambda: gram_pair_reference(s, t), 3, flush)
            library_ms = _event_ms(lambda: (torch.mm(s, s.T), torch.mm(t, t.T)), 20, flush)
        rec.update(gram_times(lambda: gram_pair_fwd(s, t), nbytes), plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        del flush
    return rec


# phase 12's shapes (B, Ds, Dt, timed): the spkd step's 33 s waveforms at each
# batch phase 13 may settle on (32, 16, 8), at the largest batch the gate
# admits (64) and at its card-vs-CPU batch 2; the 3 s waveforms at batch 32
# (below the gate: forced); a ragged tail; Ds != Dt with lengths that rule
# out the bulk copies on one side
GRAM_CASES = [(32, SPKD_SAMPLES, SPKD_SAMPLES, True), (16, SPKD_SAMPLES, SPKD_SAMPLES, True),
              (8, SPKD_SAMPLES, SPKD_SAMPLES, True), (64, SPKD_SAMPLES, SPKD_SAMPLES, True),
              (32, 48000, 48000, True), (4, (1 << 19) + 1, (1 << 19) + 1, False),
              (8, SPKD_SAMPLES, 100003, False), (SPKD_CHECK_BATCH, SPKD_SAMPLES, SPKD_SAMPLES, True)]


def phase_gram_vs_plain():
    import torch

    cases = []
    for *shape, timed in GRAM_CASES:
        rec = _gram_case(*shape, timed=timed)
        say("gram_vs_plain", **rec)
        cases.append(rec)
        torch.cuda.empty_cache()
        if not (rec["max_rel_err"] <= GRAM_TOL and rec["bitwise_repeat"] and rec["symmetric"]):
            raise RuntimeError(f"gram_pair_fwd disagrees with its plain version: {rec}")
    return cases


def _one_step(strategy: str) -> dict:
    """One step of ``strategy`` at full width on 32 x 3 s, with its launches."""
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    counters = _kernel_counters()
    batch = TEACHER_BATCH
    mix, clean = train_batch(batch, TRAIN_SECONDS)
    trainer = Trainer(train_config(batch, TRAIN_SECONDS, dict(strategy=strategy)),
                      device="cuda").init_state(0)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logs = trainer.train_step(mix, clean)
    torch.cuda.synchronize()
    rec = dict(strategy=strategy, batch=batch, seconds=TRAIN_SECONDS,
               step_ms=(time.perf_counter() - t0) * 1e3,
               logs={k: float(v) for k, v in logs.items()},
               launches={name: fn.launches for name, fn in counters.items()},
               finite=all(bool(np.isfinite(float(v))) for v in logs.values()))
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_training_spkd():
    rec = _training("training_spkd", "spkd TrainConfig(distill=DistillConfig(strategy='spkd')), "
                    f"{SPKD_SECONDS} s clips", dict(strategy="spkd"), SPKD_STEPS,
                    {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4, "gram_pair_fwd": 1},
                    seconds=SPKD_SECONDS, check_batch=SPKD_CHECK_BATCH,
                    check_seconds=SPKD_SECONDS, rounding_floor=True)
    others = [_one_step(strategy) for strategy in ("mse", "stft")]
    say("training_mse_stft", steps=others)
    want = {name: {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}.get(name, 0) for name in _kernel_counters()}
    for step in others:
        if step["launches"] != want or not step["finite"]:
            raise RuntimeError(f"the {step['strategy']} step is wrong: {step}")
    return rec


def _cpu_copy(tree):
    """A copy of a checkpoint's tree (``utils.serialization.trainer_state``)
    with every tensor cloned to the CPU."""
    import torch

    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def _bit_diffs(got, want, path="") -> list:
    """The paths where two checkpoint trees differ in any bit."""
    import torch

    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(map(str, got))} != {sorted(map(str, want))}"]
        return [d for k in want for d in _bit_diffs(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: length"]
        return [d for i, (g, w) in enumerate(zip(got, want)) for d in _bit_diffs(g, w, f"{path}/{i}")]
    if isinstance(want, torch.Tensor):
        g = got.detach().cpu()
        same = (g.dtype == want.dtype and g.shape == want.shape and torch.equal(
            g.reshape(-1).contiguous().view(torch.uint8),
            want.reshape(-1).contiguous().view(torch.uint8)))
        return [] if same else [path]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def fit_config(directory: str, **fields):
    """``TrainConfig()`` on synthetic clips, an epoch of FIT_STEPS_PER_EPOCH
    steps, FIT_EPOCHS epochs, one checkpoint kept, a log line an epoch;
    ``fields`` override (the CPU rehearsal shrinks the models)."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import TrainConfig

    cfg = dataclasses.replace(TrainConfig(), max_epochs=FIT_EPOCHS, keep_top_k=1,
                              log_every=FIT_STEPS_PER_EPOCH, ckpt_dir=directory)
    data = dataclasses.replace(cfg.data, synthetic=True, batch_size=TEACHER_BATCH,
                               segment=TRAIN_SECONDS,
                               synthetic_size=TEACHER_BATCH * FIT_STEPS_PER_EPOCH)
    return dataclasses.replace(cfg, data=data, **fields)


def fit_checks(cfg, device: str, counters: dict) -> dict:
    """``Trainer(cfg).fit`` on ``device`` with top-k checkpoints in
    ``cfg.ckpt_dir``, then the CLI's ``bundle_best``, and every check of
    phase 14 but the launch counts, which it reads (``counters``, set to 0
    just before the fit and read just after): the record, with
    ``failures`` listing what did not hold.  tests/test_torch_fit.py
    rehearses it at tiny widths on the CPU."""
    import json as json_

    import torch

    from speech_enhancement_clskd_tpu_torch.cli import bundle_best
    from speech_enhancement_clskd_tpu_torch.data.loader import make_loader
    from speech_enhancement_clskd_tpu_torch.models.dccrn import DCCRN
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
    from speech_enhancement_clskd_tpu_torch.utils.observability import MetricWriter
    from speech_enhancement_clskd_tpu_torch.utils.serialization import (
        CheckpointManager,
        load_bundle,
        trainer_state,
    )

    class RecordingManager(CheckpointManager):
        """Keeps a CPU copy of every state it keeps, to hold restores to."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.saved = {}

        def save(self, trainer, metrics):
            kept = super().save(trainer, metrics)
            if kept:
                self.saved[trainer.step] = _cpu_copy(trainer_state(trainer))
            return kept

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out, failures = cfg.ckpt_dir, []
    trainer = Trainer(cfg, device=device).init_state(0)
    mgr = RecordingManager(out, monitor=cfg.monitor, keep_top_k=cfg.keep_top_k)
    writer = MetricWriter(f"{out}/metrics.jsonl")
    lines = []
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(log_fn=lines.append, checkpoint_manager=mgr, metric_writer=writer)
    sync()
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    writer.close()
    records = MetricWriter.read(f"{out}/metrics.jsonl")
    val = [r for r in records if r["scope"] == "val"]
    steps, epochs = trainer.step, trainer.epoch

    # the loader alone over one epoch, and validation alone, on this host
    train_ds, val_ds = trainer.make_datasets()
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in make_loader(train_ds, cfg.data.batch_size, seed=cfg.seed))
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final = trainer.validate(val_ds)
    validate_s = time.perf_counter() - t0

    # validation: the final state on the CPU
    cpu = Trainer(cfg, device="cpu").init_state(0)
    cpu.student.load_state_dict(trainer.student.state_dict())
    t0 = time.perf_counter()
    on_cpu = cpu.validate(val_ds)
    cpu_validate_s = time.perf_counter() - t0
    stoi_err = max(abs(final[k] - on_cpu[k]) for k in final if "stoi" in k)
    si_sdr_err = max(abs(final[k] - on_cpu[k]) for k in final if "si_sdr" in k)
    if not (stoi_err <= FIT_STOI_ATOL and si_sdr_err <= FIT_SI_SDR_ATOL):
        failures.append("validation on the card disagrees with the CPU")

    # top-k: the one kept checkpoint is the best stoi of the epochs (the
    # first of equal scores, as the manager keeps it)
    with open(f"{out}/index.json") as f:
        index = json_.load(f)
    best = max(val, key=lambda r: r["stoi"])["step"]
    kept = [int(s) for s in index["scores"]]
    if kept != [best] or index["monitor"] != "stoi":
        failures.append(f"index.json keeps {kept}, the best stoi was step {best}")

    # restore: a fresh trainer (other seed) takes the saved bits
    restored = Trainer(cfg, device=device).init_state(1)
    mgr.restore(restored)
    restore_diffs = _bit_diffs(_cpu_copy(trainer_state(restored)), mgr.saved[best])
    if restore_diffs:
        failures.append(f"restored state differs from the saved one at {restore_diffs[:5]}")

    # the CLI's bundling: restores the best into the trainer, then writes
    bundle = bundle_best(trainer, mgr, history, out, log_fn=lines.append)
    if _bit_diffs(_cpu_copy(trainer_state(trainer)), mgr.saved[best]):
        failures.append("bundle_best did not restore the best state")
    bcfg, variables, meta = load_bundle(bundle)
    served = DCCRN(bcfg).to(device).eval()
    served.load_state_dict(torch_state_from_flax(variables), strict=True)
    mix, _ = next(iter(make_loader(val_ds, len(val_ds), shuffle=False)))
    wav = torch.from_numpy(mix).to(device)
    # cuDNN's default forward algorithms do not repeat their bits: one module
    # run twice on the card differs by ~3e-8.  Its deterministic ones do.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            served_wav = served(wav).wav
            restored_wav = restored.student(wav, training=False).wav
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same_bits = torch.equal(served_wav, restored_wav)
    bundle_diff = (served_wav - restored_wav).abs().max().item()
    if bcfg != cfg.student or not same_bits:
        failures.append("the bundle's student does not serve the restored student's bits")
    sync()

    epoch_s = [r["epoch_time_s"] for r in val]
    return dict(
        config=f"TrainConfig(), data.synthetic, {cfg.data.batch_size} x {cfg.data.segment} s, "
               f"{FIT_STEPS_PER_EPOCH} steps an epoch, {cfg.max_epochs} epochs, keep_top_k 1",
        steps=steps, epochs=epochs, fit_s=fit_s, launches=launches,
        epoch_time_s=epoch_s, audio_s_per_s=[r["audio_s_per_s"] for r in val],
        loader_epoch_s=loader_s, loader_batches=n_batches,
        validate_s=validate_s, cpu_validate_s=cpu_validate_s,
        val_stoi=[r["stoi"] for r in val], val_si_sdr=[r["si_sdr"] for r in val],
        final=final, cpu_final=on_cpu, stoi_abs_err=stoi_err, stoi_tol=FIT_STOI_ATOL,
        si_sdr_abs_err_db=si_sdr_err, si_sdr_tol_db=FIT_SI_SDR_ATOL,
        kept=kept, best_step=best, restore_bit_equal=not restore_diffs,
        bundle_serves_restored_bits=same_bits, bundle_max_abs_diff=bundle_diff,
        bundle_software=meta["infos"]["software_versions"], log=lines, failures=failures)


def phase_fit(step_ms_median: float, step_audio_s_per_s: float) -> dict:
    """Phase 14 on the card: ``fit_checks`` at full width, its K1f and K1b
    launches held (8 and 4 a step, 4 K1f a validation batch of 8 clips, one
    an epoch), and the loop's time a step over phase 7's median step."""
    import tempfile

    counters = _kernel_counters()
    with tempfile.TemporaryDirectory() as directory:
        rec = fit_checks(fit_config(directory), "cuda", counters)
    expected = {"lstm_seq_fwd": 8 * rec["steps"] + 4 * rec["epochs"],
                "lstm_seq_bwd": 4 * rec["steps"]}
    want = {name: expected.get(name, 0) for name in counters}
    per_step_ms = [t * 1e3 / FIT_STEPS_PER_EPOCH for t in rec["epoch_time_s"]]
    rec.update(step_ms_phase7=step_ms_median, audio_s_per_s_phase7=step_audio_s_per_s,
               epoch_step_ms=per_step_ms,
               loop_overhead=[t / step_ms_median - 1 for t in per_step_ms])
    say("fit", **rec)
    if rec["launches"] != want:
        raise RuntimeError(f"kernel launches in the fit {rec['launches']}, expected {want}")
    if rec["steps"] != FIT_EPOCHS * FIT_STEPS_PER_EPOCH or rec["failures"]:
        raise RuntimeError(f"the fit phase failed: {rec['failures']}")
    return rec

def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import speech_enhancement_clskd_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device()
    phase_build()
    fwd_shapes = phase_kernel_vs_plain()
    serving_launches = phase_serving_student() + phase_serving_teacher()
    bwd_shapes = phase_backward_vs_plain()
    training = phase_training()
    conv_shapes, fuse_shapes = phase_abf_kernels_vs_plain()
    kernel_training = phase_training_kernels()
    block_shapes, block_steps, block_step_sums = phase_abf_block_vs_plain()
    block_training = phase_training_block()
    gram_shapes = phase_gram_vs_plain()
    spkd_training = phase_training_spkd()
    fit = phase_fit(training["step_ms_median"], training["audio_s_per_s"])
    fwd = next(r for r in fwd_shapes if (r["T"], r["N"], r["H"]) == (483, 64, 128))
    bwd = next(r for r in bwd_shapes if (r["T"], r["N"], r["H"]) == (483, 64, 32))
    conv = next(r for r in conv_shapes if (r["B"], r["D"], r["T"], r["C"], r["O"]) == CONV_REF)
    fuse = next(r for r in fuse_shapes if (r["B"], r["D"], r["Dp"], r["T"], r["C"]) == FUSE_REF)
    trained = {name: training["launches"][name] + kernel_training["launches"][name]
               + block_training["launches"][name] + spkd_training["launches"][name]
               for name in training["launches"]}
    src = "speech_enhancement_clskd_tpu_torch/kernels/csrc/"
    pallas = "speech_enhancement_clskd_tpu/ops/pallas/"
    kernels = [{
        "name": "lstm_seq_fwd",
        "route": "cuda",
        "source": src + "lstm_seq_fwd.cu",
        "replaces": pallas + "lstm.py:36",
        "launches": serving_launches + trained["lstm_seq_fwd"],
        "max_abs_err": max(r["max_abs_err_y"] for r in fwd_shapes),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "shape": {"T": 483, "N": 64, "H": 128},
        "launches_by_path": {"serving": serving_launches,
                             "training": training["launches"]["lstm_seq_fwd"],
                             "training_kernels": kernel_training["launches"]["lstm_seq_fwd"],
                             "training_block": block_training["launches"]["lstm_seq_fwd"],
                             "training_spkd": spkd_training["launches"]["lstm_seq_fwd"],
                             "fit": fit["launches"]["lstm_seq_fwd"]},
        "per_shape": fwd_shapes,
    }, {
        "name": "lstm_seq_bwd",
        "route": "cuda",
        "source": src + "lstm_seq_bwd.cu",
        "replaces": pallas + "lstm.py:60",
        "launches": trained["lstm_seq_bwd"],
        "max_abs_err": max(max(r["max_abs_err_dxw"], r["max_rel_err_dw_hh"])
                           for r in bwd_shapes),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "shape": {"T": 483, "N": 64, "H": 32},
        "launches_by_path": {"training": training["launches"]["lstm_seq_bwd"],
                             "training_kernels": kernel_training["launches"]["lstm_seq_bwd"],
                             "training_block": block_training["launches"]["lstm_seq_bwd"],
                             "training_spkd": spkd_training["launches"]["lstm_seq_bwd"],
                             "fit": fit["launches"]["lstm_seq_bwd"]},
        "per_shape": bwd_shapes,
    }]
    conv_shape = dict(zip(("B", "D", "T", "C", "O"), CONV_REF))
    fuse_shape = dict(zip(("B", "D", "Dp", "T", "C"), FUSE_REF))
    for name, source, line, cases, shape, key, err in (
            ("conv3x3_fwd", "conv3x3_fwd.cu", "conv3x3.py:120", conv_shapes, conv, "fwd",
             "fwd_max_abs_err"),
            ("conv3x3_wgrad", "conv3x3_wgrad.cu", "conv3x3.py:135", conv_shapes, conv, "wgrad",
             "wgrad_rel_l2"),
            ("attfuse_fwd", "attfuse_fwd.cu", "attfuse.py:99", fuse_shapes, fuse, "fwd",
             "fwd_max_abs_err"),
            ("attfuse_bwd", "attfuse_bwd.cu", "attfuse.py:113", fuse_shapes, fuse, "bwd",
             "bwd_max_abs_err_dx_dres")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": pallas + line,
            "launches": kernel_training["launches"][name],
            "max_abs_err": max(r[err] for r in cases if err in r),
            "ms": shape[f"{key}_ms"],
            "plain_ms": shape[f"{key}_plain_ms"],
            "bound_ms": shape[f"{key}_bound_ms"],
            "bound_by": shape[f"{key}_bound_by"],
            "library_ms": shape.get(f"{key}_library_ms"),
            "shape": conv_shape if name.startswith("conv") else fuse_shape,
            "per_shape": cases,
        })
    block = next(r for r in block_shapes if tuple(
        r[n] for n in ("fuse", "B", "D", "k", "T", "Cs", "M", "O")) == BLOCK_REF)
    block_shape = dict(zip(("fuse", "B", "D", "k", "T", "Cs", "M", "O"), BLOCK_REF))
    for name, source, line, key, err in (
            ("abf_block_fwd", "abf_block_fwd.cu", "abf_block.py:196", "fwd", "fwd_max_abs_err"),
            ("abf_block_bwd", "abf_block_bwd.cu", "abf_block.py:220", "bwd", "bwd_max_rel_l2")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": pallas + line,
            "launches": block_training["launches"][name],
            "max_abs_err": max(r[err] for r in block_shapes),
            "ms": block[f"{key}_ms"],
            "plain_ms": block[f"{key}_plain_ms"],
            "bound_ms": block[f"{key}_bound_ms"],
            "bound_by": block[f"{key}_bound_by"],
            "bound_f32_ms": block[f"{key}_bound_f32_ms"],
            "library_ms": None,
            "per_op_ms": block[f"{key}_per_op_ms"],
            "step_ms": block_step_sums[f"{key}_ms"],
            "step_per_op_ms": block_step_sums[f"{key}_per_op_ms"],
            "routes": {r: sum(c["count"] for c in block_steps if c[f"{key}_route"] == r)
                       for r in ("mma", "direct")},
            "shape": block_shape,
            "per_shape": block_shapes,
            "per_step_shape": block_steps,
        })
    spkd_batch = spkd_training["batch"]
    gram_ref = next(r for r in gram_shapes
                    if (r["B"], r["Ds"], r["Dt"]) == (spkd_batch, SPKD_SAMPLES, SPKD_SAMPLES))
    kernels.append({
        "name": "gram_pair_fwd",
        "route": "cuda",
        "source": src + "gram_pair_fwd.cu",
        "replaces": pallas + "gram.py:41",
        "launches": spkd_training["launches"]["gram_pair_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in gram_shapes),
        "max_rel_err": max(r["max_rel_err"] for r in gram_shapes),
        "ms": gram_ref["ms"],
        "plain_ms": gram_ref["plain_ms"],
        "bound_ms": gram_ref["bound_ms"],
        "bound_by": gram_ref["bound_by"],
        "library_ms": gram_ref["library_ms"],
        "times": {k: gram_ref[k] for k in ("pass1_ms", "pass2_ms", "event_ms", "host_ms",
                                           "l2_flushed")},
        "shape": {"B": spkd_batch, "Ds": SPKD_SAMPLES, "Dt": SPKD_SAMPLES},
        "per_shape": gram_shapes,
    })
    for k in kernels:
        k["design"] = DESIGNS[k["name"]]
        if k["name"] == "conv3x3_fwd":  # bound_ms is 3xTF32's; f32 FMA's, and TF32 cuDNN
            k.update(bound_f32_ms=conv["fwd_bound_f32_ms"],
                     library_tf32_ms=conv["fwd_library_tf32_ms"],
                     routes={r: sum(1 for c in conv_shapes if c.get("fwd_route") == r)
                             for r in ("mma", "fma")})
        if k["name"] == "conv3x3_wgrad":  # bound_ms is 3xTF32's; f32 FMA's beside it
            k.update(bound_f32_ms=conv["wgrad_bound_f32_ms"],
                     routes={r: sum(1 for c in conv_shapes if c.get("wgrad_route") == r)
                             for r in ("mma", "narrow")})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
