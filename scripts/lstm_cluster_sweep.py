#!/usr/bin/env python3
"""The measurements behind the LSTM kernels' plans (K1f,
``speech_enhancement_clskd_tpu_torch/kernels/csrc/lstm_seq_fwd.cu``, and
K1b, ``lstm_seq_bwd.cu``), on one NVIDIA GPU.

    python3 scripts/lstm_cluster_sweep.py [--out FILE]

1. barrier: the cost of one barrier a step, from a small kernel built here
   (``BARRIER_SOURCE``): a loop of ``barrier.cluster.arrive.release`` /
   ``wait.acquire`` in clusters of P = 2, 4 and 8 CTAs of 512 threads (one
   cluster per 8 SMs of the card), alone and with each owner lane storing one
   float into every peer's shared memory first, as the kernel's h exchange
   does; and ``__syncthreads`` in one CTA, for P = 1.  Time per iteration
   from CUDA events over 100,000 iterations.
2. plans: the kernel's source built here with every plan of ``PLANS``
   beside its own (``VARIANT_SOURCE``, which includes the source and adds
   one entry that runs any plan); each plan that fits the width, at the
   shapes of the serving and training paths, against its plain version (max
   abs error of y) and against cuDNN's ``torch.nn.LSTM`` (f32, TF32 off) in
   the same run, at 1, 2 and 4 batch rows a cluster.
3. bwd_plans: K1b's source built here with every plan of ``BWD_PLANS``
   (``BWD_VARIANT_SOURCE``), each at the student's width on the spkd and
   clskd steps' shapes, against its plain version (max abs error of dxw) and
   cuDNN's LSTM backward (f32, TF32 off) in the same run.
4. step: ``chip_smoke.py`` phase 7's card-vs-CPU check (one clskd step of
   ``TrainConfig()`` on the card and on the CPU, white-noise batch, the
   gradients held to ``TRAIN_GRAD_REL_L2``) with the kernels' own plans and
   with sums split over KS = 2 lanes (``STEP_VARIANTS``: K1f's gate columns,
   K1b's quarters of dh), the wrappers' libraries swapped for the variants'
   in this process only.

Prints one JSON line per measurement and writes them all to ``--out``.
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BARRIER_SOURCE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// iters cluster barriers; with `store`, thread i < 32 of each CTA first
// stores one float into every peer's shared memory
__global__ void cluster_loop(int iters, int store, float* sink) {
  __shared__ float buf[2][8 * 32];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned p = cl.num_blocks(), rank = cl.block_rank();
  buf[0][threadIdx.x % 256] = 0.0f;
  cluster_barrier();
  for (int it = 0; it < iters; ++it) {
    if (store && threadIdx.x < 32)
      for (unsigned q = 0; q < p; ++q)
        cl.map_shared_rank(&buf[it & 1][0], q)[rank * 32 + threadIdx.x] = (float)it;
    cluster_barrier();
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = buf[(iters - 1) & 1][rank * 32];
}

__global__ void block_loop(int iters, float* sink) {
  __shared__ float buf[2][256];
  float v = 0.0f;
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x < 32) buf[it & 1][threadIdx.x] = (float)it;
    __syncthreads();
    v += buf[it & 1][(threadIdx.x + 1) % 32];
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = v;
}

extern "C" int run_cluster(int p, int clusters, int iters, int store, float* sink, void* s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p * clusters);
  cfg.blockDim = dim3(512);
  cfg.stream = (cudaStream_t)s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_loop, iters, store, sink);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int run_block(int blocks, int iters, float* sink, void* s) {
  block_loop<<<blocks, 512, 0, (cudaStream_t)s>>>(iters, sink);
  return (int)cudaGetLastError();
}
"""

VARIANT_SOURCE = r"""
#include "{source}"

// plan `plan` of the sweep's table at `rows` batch rows a cluster (0: the
// kernel's own rule)
extern "C" int sweep_lstm_fwd(const void* xw, const void* w_hh, const void* h0,
                              const void* c0, void* y, void* c, int T, int N, int H,
                              int plan, int rows, void* stream) {{
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  const float* a = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(w_hh);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* yo = static_cast<float*>(y);
  float* co = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""
CASE = ("    case {i}: return (int)launch_plan<{p}, {ks}, {wpt}>(rows ? rows : rows_of({p}, N, "
        "sms), a, w, hi, ci, yo, co, T, N, H, dev, s);")

# (T, N, H): streaming chunk (T=118, N=2), offline batch 1 and 32 (T=483),
# the clskd step (N=64 at T=483), and the spkd step's 33 s clips (T=5283) at
# batch 16 and 32, for the student (H=32) and the teacher (H=128)
SHAPES = [(118, 2, 32), (483, 2, 32), (483, 64, 32), (5283, 32, 32), (5283, 64, 32),
          (483, 2, 128), (483, 64, 128), (5283, 32, 128), (5283, 64, 128)]
# (P, KS, WPT): the kernel's own plan for each width of SHAPES (lstm_seq_fwd.cu,
# kPlans), then other cluster sizes and K splits.  A plan takes H <= KS * WPT
# and runs at the shapes with H in (KS * WPT / 2, KS * WPT].
PLANS = [(1, 1, 32), (2, 1, 128),
         (2, 1, 32), (1, 2, 16), (1, 4, 8), (1, 8, 4),
         (4, 1, 128), (8, 1, 128), (2, 2, 64), (4, 4, 32), (4, 8, 16), (8, 8, 16)]
# K1b's plans (KS, WPT): the kernel's own at H = 32 (lstm_seq_bwd.cu, kPlans),
# then each quarter of dh split over two lanes
BWD_PLANS = [(1, 32), (2, 16)]
BWD_SHAPES = [(5283, 32, 32), (483, 64, 32)]
BWD_VARIANT_SOURCE = r"""
#include "{source}"

// plan `plan` of the sweep's K1b table
extern "C" int sweep_lstm_bwd(const void* xw, const void* w_hh, const void* y, const void* c,
                              const void* dy, const void* h0, const void* c0, void* dxw,
                              void* dw_hh, void* scratch, int T, int N, int H, int chunk_rows,
                              int plan, void* stream) {{
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = lstm_common::rows_per_block(N, sms);
  const float* a = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(w_hh);
  const float* yo = static_cast<const float*>(y);
  const float* co = static_cast<const float*>(c);
  const float* d = static_cast<const float*>(dy);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* dx = static_cast<float*>(dxw);
  float* dw = static_cast<float*>(dw_hh);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""
BWD_CASE = ("    case {i}: return (int)run_plan<{ks}, {wpt}>(rows, a, w, yo, co, d, hi, ci, dx, "
            "dw, sc, T, N, H, chunk_rows, s);")
# the step check's variants: K1f's and K1b's plan of each width (None: the
# kernel as the port builds it)
STEP_VARIANTS = {"kernel": {"fwd": None, "bwd": None},
                 "ks2_student": {"fwd": {32: (1, 2, 16), 128: (2, 1, 128)}, "bwd": None},
                 "ks2": {"fwd": {32: (1, 2, 16), 128: (2, 2, 64)}, "bwd": None},
                 "bwd_ks2_student": {"fwd": None, "bwd": {32: (2, 16)}}}
ITERS = 100_000


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


def barriers(records: list) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels import _build

    build = _build.BUILD_DIR / "sweep"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "cluster_barrier.cu", build / "libcluster_barrier.so"
    src.write_text(BARRIER_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.run_cluster.argtypes = [i32] * 4 + [ptr, ptr]
    lib.run_block.argtypes = [i32] * 2 + [ptr, ptr]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err != 0:
            raise RuntimeError(f"barrier loop failed: CUDA error {err}")

    ms = _time_ms(lambda: check(lib.run_block(sms, ITERS, sink.data_ptr(), stream)), 3)
    emit(records, phase="barrier", P=1, kind="__syncthreads", blocks=sms,
         us_per_iter=ms * 1e3 / ITERS)
    for p in (2, 4, 8):
        for store in (0, 1):
            clusters = sms // 8
            ms = _time_ms(lambda: check(lib.run_cluster(p, clusters, ITERS, store,
                                                        sink.data_ptr(), stream)), 3)
            emit(records, phase="barrier", P=p, kind="cluster", dsmem_store=bool(store),
                 clusters=clusters, us_per_iter=ms * 1e3 / ITERS)


def variant_library() -> ctypes.CDLL:
    """The kernel's source with ``sweep_lstm_fwd``, built here."""
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    build = _build.BUILD_DIR / "sweep"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "lstm_seq_fwd_plans.cu", build / "liblstm_seq_fwd_plans.so"
    cases = "\n".join(CASE.format(i=i, p=p, ks=ks, wpt=wpt)
                      for i, (p, ks, wpt) in enumerate(PLANS))
    src.write_text(VARIANT_SOURCE.format(source=_build.CSRC_DIR / "lstm_seq_fwd.cu",
                                         cases=cases))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sweep_lstm_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.sweep_lstm_fwd.restype = i32
    return lib


def plans(records: list, lib: ctypes.CDLL) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels import lstm
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    dev = torch.device("cuda")
    for T, N, H in SHAPES:
        g = torch.Generator().manual_seed(1000 * H + N)
        xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
        w_hh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5).to(dev)
        with float32_math():
            ry, _ = lstm.lstm_seq_reference(xw, w_hh)
        lstm_lib = torch.nn.LSTM(4 * H, H).to(dev)
        with torch.no_grad(), float32_math():
            lstm_lib.weight_ih_l0.copy_(torch.eye(4 * H))
            lstm_lib.weight_hh_l0.copy_(w_hh.t())
            lstm_lib.bias_ih_l0.zero_()
            lstm_lib.bias_hh_l0.zero_()
            library_ms = _time_ms(lambda: lstm_lib(xw), 10)
        y, c = torch.empty(T, N, H, device=dev), torch.empty(T, N, H, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for plan, shape in enumerate(PLANS):
            if not shape[1] * shape[2] // 2 < H <= shape[1] * shape[2]:
                continue
            for rows in (1, 2, 4):
                def run():
                    err = lib.sweep_lstm_fwd(xw.data_ptr(), w_hh.data_ptr(), None, None,
                                             y.data_ptr(), c.data_ptr(), T, N, H, plan, rows,
                                             stream)
                    if err != 0:
                        raise RuntimeError(f"plan {shape} rows {rows}: CUDA error {err}")
                y.zero_()
                run()
                torch.cuda.synchronize()
                err = (y - ry).abs().max().item()
                emit(records, phase="plan", T=T, N=N, H=H, plan=plan,
                     P_KS_WPT=shape, rows=rows, ms=_time_ms(run, 10), max_abs_err=err,
                     library_ms=library_ms)


def bwd_variant_library() -> ctypes.CDLL:
    """K1b's source with ``sweep_lstm_bwd``, built here."""
    from speech_enhancement_clskd_tpu_torch.kernels import _build

    build = _build.BUILD_DIR / "sweep"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "lstm_seq_bwd_plans.cu", build / "liblstm_seq_bwd_plans.so"
    cases = "\n".join(BWD_CASE.format(i=i, ks=ks, wpt=wpt)
                      for i, (ks, wpt) in enumerate(BWD_PLANS))
    src.write_text(BWD_VARIANT_SOURCE.format(source=_build.CSRC_DIR / "lstm_seq_bwd.cu",
                                             cases=cases))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sweep_lstm_bwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.sweep_lstm_bwd.restype = i32
    lib.lstm_seq_bwd_scratch_floats.argtypes = [i32] * 4
    lib.lstm_seq_bwd_scratch_floats.restype = ctypes.c_long
    return lib


def bwd_plans(records: list, lib: ctypes.CDLL) -> None:
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels import lstm
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    dev = torch.device("cuda")
    for T, N, H in BWD_SHAPES:
        g = torch.Generator().manual_seed(2000 * H + N)
        xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
        w_hh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5).to(dev)
        dy = torch.randn(T, N, H, generator=g).to(dev)
        with float32_math():
            y, c = lstm.lstm_seq_reference(xw, w_hh)
            rdxw, _ = lstm.lstm_seq_bwd_reference(xw, w_hh, y, c, dy)
        lstm_lib = torch.nn.LSTM(4 * H, H).to(dev)
        with float32_math():
            with torch.no_grad():
                lstm_lib.weight_ih_l0.copy_(torch.eye(4 * H))
                lstm_lib.weight_hh_l0.copy_(w_hh.t())
                lstm_lib.bias_ih_l0.zero_()
                lstm_lib.bias_hh_l0.zero_()
            x_in = xw.clone().requires_grad_(True)
            lib_y = lstm_lib(x_in)[0]
            library_ms = _time_ms(lambda: torch.autograd.grad(
                lib_y, (x_in, lstm_lib.weight_hh_l0), dy, retain_graph=True), 10)
        chunk_rows = max(lstm.DW_CHUNK_ROWS, -(-T * N // lstm.MAX_DW_CHUNKS))
        dxw, dw = torch.empty_like(xw), torch.empty_like(w_hh)
        scratch = torch.empty(lib.lstm_seq_bwd_scratch_floats(T, N, H, chunk_rows), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for plan, shape in enumerate(BWD_PLANS):
            if not shape[0] * shape[1] // 2 < H <= shape[0] * shape[1]:
                continue

            def run():
                err = lib.sweep_lstm_bwd(xw.data_ptr(), w_hh.data_ptr(), y.data_ptr(),
                                         c.data_ptr(), dy.data_ptr(), None, None,
                                         dxw.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
                                         T, N, H, chunk_rows, plan, stream)
                if err != 0:
                    raise RuntimeError(f"K1b plan {shape}: CUDA error {err}")
            dxw.zero_()
            run()
            torch.cuda.synchronize()
            emit(records, phase="bwd_plan", T=T, N=N, H=H, plan=plan, KS_WPT=shape,
                 ms=_time_ms(run, 20), max_abs_err_dxw=(dxw - rdxw).abs().max().item(),
                 library_ms=library_ms)


class _VariantFwd:
    """Stands in for K1f's library in ``kernels.lstm``: each width runs the
    plan ``plan_by_width`` gives it, at the kernel's own rows a cluster."""

    def __init__(self, lib: ctypes.CDLL, plan_by_width: dict):
        self.lib, self.plan_by_width = lib, plan_by_width

    def lstm_seq_fwd(self, xw, w_hh, h0, c0, y, c, T, N, H, stream):
        return self.lib.sweep_lstm_fwd(xw, w_hh, h0, c0, y, c, T, N, H,
                                       PLANS.index(self.plan_by_width[H]), 0, stream)


class _VariantBwd:
    """Stands in for K1b's library in ``kernels.lstm``: each width of
    ``plan_by_width`` runs that plan, the others the kernel's own."""

    def __init__(self, lib: ctypes.CDLL, kernel_lib, plan_by_width: dict):
        self.lib, self.kernel_lib, self.plan_by_width = lib, kernel_lib, plan_by_width
        self.lstm_seq_bwd_scratch_floats = lib.lstm_seq_bwd_scratch_floats

    def lstm_seq_bwd(self, *args):
        H = args[12]
        if H not in self.plan_by_width:
            return self.kernel_lib.lstm_seq_bwd(*args)
        return self.lib.sweep_lstm_bwd(*args[:14], BWD_PLANS.index(self.plan_by_width[H]),
                                       args[14])


def step(records: list, lib: ctypes.CDLL, bwd_lib: ctypes.CDLL) -> None:
    from unittest import mock

    import chip_smoke
    from speech_enhancement_clskd_tpu_torch.kernels import lstm

    library = lstm._library
    for name, variant in STEP_VARIANTS.items():
        def swapped(source, variant=variant):
            if source == lstm.FWD_SOURCE and variant["fwd"] is not None:
                return _VariantFwd(lib, variant["fwd"])
            if source == lstm.BWD_SOURCE and variant["bwd"] is not None:
                return _VariantBwd(bwd_lib, library(source), variant["bwd"])
            return library(source)

        with mock.patch.object(lstm, "_library", swapped):
            cfg = chip_smoke.train_config(chip_smoke.CHECK_BATCH, chip_smoke.CHECK_SECONDS)
            rec = chip_smoke.synced_steps(cfg, *chip_smoke.gaussian_batch(
                chip_smoke.CHECK_BATCH, chip_smoke.CHECK_SECONDS), "cuda", 1)["steps"][0]
        emit(records, phase="step", variant=name,
             fwd_P_KS_WPT_by_width=variant["fwd"], bwd_KS_WPT_by_width=variant["bwd"],
             within_tol=rec["grad_max_rel_l2"] <= rec["grad_tol"], **rec)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "results" / "lstm_cluster_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_cluster_sweep: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    records = [{"card": card}]
    print(card, flush=True)
    barriers(records)
    lib = variant_library()
    plans(records, lib)
    bwd_lib = bwd_variant_library()
    bwd_plans(records, bwd_lib)
    step(records, lib, bwd_lib)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
