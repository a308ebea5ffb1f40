#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's serving and training paths on
one NVIDIA GPU.

    python3 scripts/profile_serving_torch.py [--trace-dir DIR]

Six configurations, built as ``chip_smoke.py`` builds them:

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
  phase 13 settles on (the largest from 32, halving, that fits).

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import (
        ABF_BLOCK_FLAGS,
        ABF_KERNEL_FLAGS,
        SPKD_SECONDS,
        TEACHER_BATCH,
        TRAIN_SECONDS,
        fitting_trainer,
        train_config,
        student_engine,
        teacher_batch,
        train_batch,
    )
    from speech_enhancement_clskd_tpu_torch.config import TEACHER
    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)

    eng = student_engine("cuda")
    wav = SyntheticEnhancementDataset(size=1, segment=1.0, seed=0)[0][0]
    window = np.zeros(eng.window_samples, np.float32)
    window[: len(wav)] = wav[: eng.window_samples]

    def student_step():
        eng.step(torch.from_numpy(window[None]).cuda()).cpu()

    print(json.dumps(breakdown("student_stream_chunk", student_step, STUDENT_CHUNKS,
                               args.trace_dir)), flush=True)

    batch = torch.from_numpy(teacher_batch()).cuda()
    model = make_model(TEACHER, device="cuda", seed=0)

    def teacher_step():
        with torch.inference_mode():
            model(batch)

    print(json.dumps(breakdown("teacher_offline_32x3s", teacher_step, TEACHER_ITERS,
                               args.trace_dir)), flush=True)
    del model, batch

    for label, distill in (("clskd_train_step", {}),
                           ("clskd_train_step_abf_kernels", ABF_KERNEL_FLAGS),
                           ("clskd_train_step_abf_block", ABF_BLOCK_FLAGS)):
        cfg = train_config(TEACHER_BATCH, TRAIN_SECONDS, distill)
        trainer = Trainer(cfg, device="cuda").init_state(0)
        mix, clean = (torch.from_numpy(a).cuda()
                      for a in train_batch(cfg.data.batch_size, TRAIN_SECONDS))

        def train_step():
            trainer.train_step(mix, clean)

        print(json.dumps(breakdown(label, train_step, TRAIN_ITERS, args.trace_dir)), flush=True)
        del trainer
        torch.cuda.empty_cache()

    trainer, batch, _, mix, clean = fitting_trainer(dict(strategy="spkd"), SPKD_SECONDS)
    mix, clean = torch.from_numpy(mix).cuda(), torch.from_numpy(clean).cuda()

    def spkd_step():
        trainer.train_step(mix, clean)

    rec = breakdown("spkd_train_step", spkd_step, TRAIN_ITERS, args.trace_dir)
    print(json.dumps(dict(rec, batch=batch, seconds=SPKD_SECONDS)), flush=True)


if __name__ == "__main__":
    main()
