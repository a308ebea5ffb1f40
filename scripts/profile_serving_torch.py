#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's serving and training paths on
one NVIDIA GPU.

    python3 scripts/profile_serving_torch.py [--trace-dir DIR] [--root DIR]
                                             [--configs NAME ...]

Ten configurations, built as ``chip_smoke.py`` builds them:

- student streaming: the r4 bundle, batch 1, one fixed-shape chunk step
  (chunk 48, context 64) repeated 40 times;
- teacher offline: ``dccrn-cl`` with seeded weights, 32 x 3 s, 3 forwards;
- clskd train step: ``Trainer(TrainConfig())`` with seeded weights, 32 x 3 s
  synthetic batches, 3 optimizer steps;
- clskd train step with the ABF kernels: the same with
  ``DistillConfig(abf_conv_pallas=True, abf_attfuse_pallas=True)``;
- clskd train step with the whole-ABF-block kernel: the same with
  ``DistillConfig(abf_block_pallas=True)``;
- spkd train step: ``DistillConfig(strategy="spkd")`` on 33 s clips (the
  fused Gram pair K2 on the waveforms), at the batch ``chip_smoke.py``'s
  phase 13 settles on (the largest from 32, halving, that fits);
- the bf16 clskd step (``chip_smoke.bf16_models()``: both models computing
  in bf16, ``BF16_DISTILL``: bf16 taps) at 32 x 3 s;
- the bf16 kernel-config step (``BF16_KERNEL_DISTILL``: the bf16 K3f, K3w,
  K4f and K4b) at 32 x 3 s;
- the bf16 block-config step (``BF16_BLOCK_DISTILL``: the whole-block
  kernels K5f and K5b on bf16) at 32 x 3 s;
- the bf16 block step at ``bench.py``'s batch 64 with ``abf_remat`` and
  ``spkd_bn2_fold`` (``BF16_BENCH_DISTILL``; K5f runs twice a block).

``--root DIR`` imports the package from another tree (e.g. a parent commit
unpacked with ``git archive HEAD speech_enhancement_clskd_tpu_torch | tar -x
-C DIR``), so that two trees' steps are profiled with the same script; the
configurations are this tree's ``chip_smoke.py``'s.  ``--configs`` names the
configurations to run (all by default).

For each it prints one JSON line: wall ms per step (host clock around
synchronised steps, profiler off); from one profiled run of the same steps,
the trace window per step (first to last device event), the device busy ms
per step (the summed durations of the device events in that window) and the
device idle share ``1 - busy / window``; the kernels that take the most
device time; and the device time of each of the port's hand-written
kernels.  ``--trace-dir`` also writes each run's Chrome trace there.
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STUDENT_CHUNKS = 40
TEACHER_ITERS = 3
TRAIN_ITERS = 3
# the port's hand-written kernels by name; reduce_partials_kernel is the
# fixed-order sum of K3w's and K5b's partials
PORT_KERNEL_PREFIXES = ("lstm_", "conv3x3_", "attfuse_", "abf_block_", "reduce_partials",
                        "gram_")


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value:
            return float(value)
    return 0.0


def breakdown(label: str, step, iters: int, trace_dir: str | None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{label}.json"))
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    window_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy_us = sum(e.time_range.end - e.time_range.start for e in events)
    if busy_us > window_us:
        raise RuntimeError(f"device events sum to {busy_us} us in a {window_us} us window: "
                           "they overlap or are miscounted")
    per_name = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(per_name, key=_self_device_us, reverse=True)[:12]
    # the port's hand-written kernels (kernels/csrc/*.cu, each named after its
    # source), summed over template instances; a name may carry namespaces,
    # and its parameter list types of an anonymous namespace
    port = {}
    for e in per_name:
        name = (e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
                .split("::")[-1].split()[-1])
        if name.startswith(PORT_KERNEL_PREFIXES):
            ms, calls = port.get(name, (0.0, 0.0))
            port[name] = (ms + _self_device_us(e) / 1e3 / iters, calls + e.count / iters)
    return {
        "config": label, "iters": iters, "wall_ms": wall_ms,
        "trace_window_ms": window_us / 1e3 / iters, "device_busy_ms": busy_us / 1e3 / iters,
        "device_idle_share": 1.0 - busy_us / window_us,
        "device_events_per_step": len(events) / iters,
        "top": [{"name": e.key[:90], "ms_per_step": _self_device_us(e) / 1e3 / iters,
                 "share": _self_device_us(e) / busy_us, "calls_per_step": e.count / iters}
                for e in top],
        "port_kernels": {name: {"ms_per_step": ms, "calls_per_step": calls}
                         for name, (ms, calls) in sorted(port.items())},
    }


CONFIGS = ("student_stream_chunk", "teacher_offline_32x3s", "clskd_train_step",
           "clskd_train_step_abf_kernels", "clskd_train_step_abf_block", "spkd_train_step",
           "clskd_train_step_bf16", "clskd_train_step_bf16_kernels",
           "clskd_train_step_bf16_block",
           "clskd_train_step_bf16_block_remat_fold_b64")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--root", default=None, help="the tree whose package to import")
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=CONFIGS)
    args = ap.parse_args()
    run = set(args.configs)

    sys.path.insert(0, str(ROOT))
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from chip_smoke import (
        ABF_BLOCK_FLAGS,
        ABF_KERNEL_FLAGS,
        BF16_BATCH,
        BF16_BENCH_DISTILL,
        BF16_BLOCK_DISTILL,
        BF16_DISTILL,
        BF16_KERNEL_DISTILL,
        SPKD_SECONDS,
        TEACHER_BATCH,
        bf16_models,
        fitting_trainer,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import speech_enhancement_clskd_tpu_torch as pkg

    print(torch.cuda.get_device_name(0), Path(pkg.__file__).parent, flush=True)

    if "student_stream_chunk" in run:
        _student(args.trace_dir)
    if "teacher_offline_32x3s" in run:
        _teacher(args.trace_dir)
    for label, distill in (("clskd_train_step", {}),
                           ("clskd_train_step_abf_kernels", ABF_KERNEL_FLAGS),
                           ("clskd_train_step_abf_block", ABF_BLOCK_FLAGS)):
        if label in run:
            _train(label, distill, TEACHER_BATCH, None, args.trace_dir)
    if "spkd_train_step" in run:
        trainer, batch, _, mix, clean = fitting_trainer(dict(strategy="spkd"), SPKD_SECONDS)
        mix, clean = torch.from_numpy(mix).cuda(), torch.from_numpy(clean).cuda()

        def spkd_step():
            trainer.train_step(mix, clean)

        rec = breakdown("spkd_train_step", spkd_step, TRAIN_ITERS, args.trace_dir)
        print(json.dumps(dict(rec, batch=batch, seconds=SPKD_SECONDS)), flush=True)
        del trainer
        torch.cuda.empty_cache()
    for label, distill, batch in (
            ("clskd_train_step_bf16", BF16_DISTILL, TEACHER_BATCH),
            ("clskd_train_step_bf16_kernels", BF16_KERNEL_DISTILL, TEACHER_BATCH),
            ("clskd_train_step_bf16_block", BF16_BLOCK_DISTILL, TEACHER_BATCH),
            ("clskd_train_step_bf16_block_remat_fold_b64", BF16_BENCH_DISTILL, BF16_BATCH)):
        if label in run:
            _train(label, distill, batch, bf16_models(), args.trace_dir)


def _student(trace_dir) -> None:
    import numpy as np
    import torch

    from chip_smoke import student_engine
    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    eng = student_engine("cuda")
    wav = SyntheticEnhancementDataset(size=1, segment=1.0, seed=0)[0][0]
    window = np.zeros(eng.window_samples, np.float32)
    window[: len(wav)] = wav[: eng.window_samples]

    def student_step():
        eng.step(torch.from_numpy(window[None]).cuda()).cpu()

    print(json.dumps(breakdown("student_stream_chunk", student_step, STUDENT_CHUNKS,
                               trace_dir)), flush=True)


def _teacher(trace_dir) -> None:
    import torch

    from chip_smoke import teacher_batch
    from speech_enhancement_clskd_tpu_torch.config import TEACHER
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model

    batch = torch.from_numpy(teacher_batch()).cuda()
    model = make_model(TEACHER, device="cuda", seed=0)

    def teacher_step():
        with torch.inference_mode():
            model(batch)

    print(json.dumps(breakdown("teacher_offline_32x3s", teacher_step, TEACHER_ITERS,
                               trace_dir)), flush=True)


def _train(label: str, distill: dict, batch: int, models, trace_dir) -> None:
    """A train step at ``batch`` x 3 s with ``distill`` (and the ``models``
    of ``chip_smoke.bf16_models`` for the bf16 steps), profiled; the peak
    device memory of the profiled steps beside it."""
    import torch

    from chip_smoke import TRAIN_SECONDS, train_batch, train_config
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    cfg = train_config(batch, TRAIN_SECONDS, distill, **(models or {}))
    trainer = Trainer(cfg, device="cuda").init_state(0)
    mix, clean = (torch.from_numpy(a).cuda() for a in train_batch(batch, TRAIN_SECONDS))

    def train_step():
        trainer.train_step(mix, clean)

    torch.cuda.reset_peak_memory_stats()
    rec = breakdown(label, train_step, TRAIN_ITERS, trace_dir)
    print(json.dumps(dict(rec, batch=batch, seconds=TRAIN_SECONDS,
                          peak_mem_bytes=torch.cuda.max_memory_allocated())), flush=True)
    del trainer
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
