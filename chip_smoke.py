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
   tensor-core instructions in the mma kernels of K3f's, K3w's, the bf16
   K3's, K5f's, K5b's and the bf16 K2's libraries, with HGMMA in the bf16 conv tile's TMA
   kernels (``*wgmma_kernel*``) of the bf16 K3's and K5's
   (``cuobjdump -sass``, or the PTX where the toolkit has no cuobjdump);
3. forward kernel vs plain: ``lstm_seq`` against ``lstm_seq_reference`` at
   the shapes the serving, training and evaluation paths give it (among
   them offline evaluation's N = 2 on a 10 s utterance, T = 1603, the
   asteroid DCCRNet family's T = 471 at N = 64, H = 128 and 32, and phase
   25's real-LSTM bottleneck at N = 32, H = 256), each with the plan K1f
   takes, two runs giving the same bits, with times, the bound and a
   one-call PyTorch yardstick (``torch.nn.LSTM``, cuDNN; never used by the
   port);
4. serving, student: ``StreamingEnhancer`` on the trained r4 bundle answers
   four requests; per-chunk latency, real-time factor, launch count, and
   agreement with the same engine on the CPU;
5. serving, teacher at full width (``dccrn-cl``, seeded weights): offline
   forward on 32 x 3 s; real-time factor, peak memory, agreement with the
   CPU on one utterance;
6. backward kernel vs plain: ``lstm_seq_bwd`` against
   ``lstm_seq_bwd_reference`` at the training step's shape and others (the
   DCCRNet student's of phase 24 among them: T = 471, N = 64, H = 32, and
   the two that phase 25 trains: the teacher's complex LSTM, N = 64, H =
   128, and its real-LSTM bottleneck, N = 32, H = 256), each with the plan
   K1b takes; two runs must give the same bits; times, the bound and the
   backward of cuDNN's ``torch.nn.LSTM`` as the yardstick;
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
    the loop's time beyond the steps goes (the loader alone, validation);
15. the ``reviewkd`` strategy: ``Trainer(TrainConfig(distill=DistillConfig(
    strategy="reviewkd")))`` (HCL over the fused taps; SPKD on the LSTM taps
    of unequal widths) as phase 9 (one warm-up and 5 timed steps; launches
    per step: K1f 8, K1b 4, no other kernel) beside phase 7's step, and its
    card-vs-CPU step on white noise (loss, and gradients against their
    rounding floor as phase 13's) and speech (loss);
16. the options of a tuned run on the kernel path: clskd with
    ``abf_block_pallas``, ``abf_remat`` and ``spkd_bn2_fold``, AdamW with
    weight decay, a gradient clip below the step's norm and the cosine
    schedule after a warmup of 2 (``OPTION_DISTILL``, ``OPTION_OPTIM``) as
    phase 11 (launches per step: K5f 24, its forward recomputed in the
    backward, K5b 12, K1f 8, K1b 4) beside phase 11's step and peak memory;
    then 3 steps card against CPU, each from the card's state (learning
    rates 0, lr / 2, lr, every step clipped), and one step of the nine-dot
    conv with the ABF re-init on the chain's per-op path (K1f 8, K1b 4)
    (``option_checks``);
17. the bf16 kernels vs plain: the bf16 instantiations of K3f (and its dx
    pass), K3w, K4f and K4b against their plain bf16 versions at phase 8's
    shapes and each distinct conv shape of the kernel-config step, held by
    ``kernels.bf16_check`` (bf16 outputs within one bf16 spacing, or the
    float32 rounding of their terms where a sum cancels; float32 outputs to
    1e-5 relative L2), two runs giving the same bits; times at the
    reference shapes, the bound (bf16 tensor-core peak or bytes) and cuDNN's
    bf16 ``F.conv2d`` and ``conv2d_weight``; the bf16 K3f, its dx pass and
    K3w at each distinct step shape (kernel, cuDNN's bf16, bound, route:
    "wgmma" wherever C and O >= 8) and summed by the step's launches;
18. bf16 training: teacher and student ``compute_dtype`` and
    ``distill.taps_dtype`` bfloat16 (``bench.py``'s headline form) as phase
    9 at 32 x 3 s beside phase 7's step, with its card-vs-CPU step (the
    gradients against their bf16 rounding floor) and its losses against
    float32's over 4 steps; at batch 64; and on the K3/K4 path (launches per
    step: bf16 K3f 24, K3w 12, K4f 10, K4b 10, K1f 8, K1b 4) with its own
    card-vs-CPU step;
19. the bf16 teacher offline on 32 x 3 s beside phase 5: RTF, peak
    memory, the waveform against the CPU's bf16 forward;
20. the bf16 whole-block kernels and the bf16 Gram pair vs plain: K5f and
    K5b on bf16 maps and weights (bvec, zoff float32) at the reference
    block (timed, with the plain versions and the bound) and at each
    distinct block shape of the block-config step (the mask block among
    them), each on route "fused" (csrc/abf_block_bf16.cu; kernel times
    and each pass's summed by blocks a step, each pass beside its bytes
    bound), and with the tap one element into its buffer at the reference
    block and the mask block (the earlier routes "wgmma" and "direct"), the
    backward on the kernel's own xf: xf, out, g_tap and g_res by
    ``kernels.bf16_check``
    with ``abf_block_bf16_scales``, the float32 parameter gradients by
    relative L2 (dw1a, dwxt and dwy, sums of values rounded to bf16 inside
    the kernel, to 1e-4; the others to 1e-5), two runs giving the same bits;
    K2 on bf16 (csrc/gram_pair_bf16.cu, bf16 products on the tensor cores)
    at B = 32, 64 and 16 x 528,000 and at a tail shape (D off multiples of
    8 and of 2048, padded by the wrapper, whose copy ``ms`` leaves out and
    ``event_ms`` counts; each Gram to 1e-5 relative L2, both sides' distance
    from the float64 Gram beside it, two runs' bits, exact symmetry; times
    as phase 12's, each pass apart, the share of the bound and cuBLAS's bf16
    product with a float32 result); then
    ``losses.kd.spkd_loss`` on bf16 [32, 528,000] inputs, the route bf16
    takes to K2 (the auto gate), forward and backward: one bf16 K2 launch;
21. bf16 training on the whole-block kernel: phase 18's bf16 models with
    ``abf_block_pallas`` at 32 x 3 s (launches per step: bf16 K5f 12, K5b
    12, K1f 8, K1b 4) and its card-vs-CPU step (phase 18's bf16 holds),
    beside phase 18's bf16 default step and phase 11's float32 block step;
    then ``bench.py``'s ``--block-pallas --abf-remat --bn2-fold`` form at
    its batch 64 (bf16 K5f 24, K5b 12).
22. offline evaluation: ``eval.evaluate_model`` on the r4 bundle over
    phase 4's four requests with their clean sources (3-10 s, odd lengths,
    bucketed to whole seconds), with PESQ, on the card and on the CPU from
    the same bundle (``evaluation_checks``): the summary and every
    per-utterance row card against CPU (STOI 1e-4, SI-SDR/SDR/SAR 1e-3 dB,
    PESQ 1e-3), the example wavs read back, K1f 4 a forward and no other
    kernel; the time an utterance split into forward, STOI, BSS and PESQ,
    and audio-seconds per second; then again with ``bn_batch_stats=True``
    (the reference's eval);
23. the asteroid DCCRNet family: seeded asteroid-schema ``.pth`` bundles
    (``write_asteroid_pth``) of ``DCCRN-CL`` and ``DCCRN-CL-test``; the
    ``DCCRN-CL`` teacher through ``load_reference_bundle`` offline on 32 x
    3 s (RTF, peak memory, K1f 4 a forward at H = 128 with its plan, card
    against CPU on one utterance); the ``DCCRN-CL-test`` student streaming
    phase 4's requests (chunk latency, card against CPU); and the CLI:
    ``import-torch`` of the ``.pth``, then ``evaluate --reference-bn`` on
    the ``.pth`` and on the ``.npz`` on the card, which must agree as the
    card and the CPU do, and on the ``.npz`` once more, which says whether
    the card repeats its bits (``asteroid_cli_checks``);
24. CLSKD training of the asteroid family at the paper's full width:
    teacher phase 23's seeded ``DCCRN-CL`` ``.pth``, student
    ``DCCRN-CL-test`` (``dccrnet_models``), as phase 7 (one warm-up and 10
    timed steps at 32 x 3 s; K1f 8, K1b 4 a step; its card-vs-CPU step)
    beside phase 7; with ``abf_conv_pallas`` + ``abf_attfuse_pallas`` and
    with ``abf_block_pallas`` as phases 9 and 11, launches per step held to
    the gates' counts on these taps (``abf_gate_counts``: the residuals are
    one frame short of each map, so no K4, and K5 only on each chain's
    unfused first block), each form's card loss against the default
    form's on the check batches; in bf16 as phase 18; then the CLI loop
    (``dccrnet_cli_checks``): ``import-torch`` of the teacher's ``.pth``,
    ``distill --teacher-bundle`` with the dccrnet presets (an epoch of 2
    steps at 4 x 1 s), ``evaluate`` of the best bundle card against CPU
    (phase 22's tolerances), and the bundle streaming a request;
25. pretraining the teacher (``PretrainTrainer``, ``TrainConfig()``'s
    ``dccrn-cl`` at full width, ``SDR+PMSQE``, plain Adam): in float32 at
    32 x 3 s (one warm-up and 5 timed steps; K1f 4, K1b 4 a step at N = 64,
    H = 128) beside phase 7's step, with its card-vs-CPU step (4 x 1 s; the
    gradients against a rounding floor, the largest move over three random
    roundings of the input, each sample to a neighbouring float32, and a
    tensor above the hold against twice its own floor); in bf16 compute,
    held as phase 18 holds its step (its floor over three random one-bf16-
    spacing roundings, a tensor above the cap against twice its own floor
    as in phase 24); with complex BN and the
    real-LSTM bottleneck (``use_cbn=True, use_clstm=False``: K1f 2, K1b 2 a
    step at N = 32, H = 256) and its card-vs-CPU step; then the CLI chain
    (``pretrain_cli_checks``): ``pretrain --model teacher`` (an epoch of 2
    steps at 4 x 1 s), ``distill --teacher-bundle <out>/teacher_model.npz``
    (an epoch), ``evaluate`` of the pretrained bundle card against CPU
    (phase 22's tolerances);
26. parallel (``phase_parallel``, ``parallel_checks``): (a) a process group
    of one over NCCL in this process: the data-parallel ``clskd`` step
    (default and block forms, ``spkd_gram_groups`` 1 and 2) and the
    data-parallel pretraining step from phase 7's weights on phase 7's
    batch against the one-process step, bit for bit where that repeats its
    own bits, the ``_g1`` forms timed (5 steps) beside phase 7; (b) two
    worker processes (``chip_smoke.py parallel-worker``) in a gloo group on
    the one card, 16 rows each: after one step the loss within 1e-5 of
    (a)'s and every gradient within 1e-4 or twice its rounding floor; (c)
    ``sharded_utterance_forward`` over two gloo ranks on 2 x 64 s (the r4
    student and the seeded teacher): each span against its window run
    alone, the interior against the whole offline forward, wall ms beside
    it.  The NCCL version, world sizes and backends are printed;
27. tensor parallelism (``phase_tensor_parallel``, ``tp_checks``): two
    worker processes (``chip_smoke.py parallel-worker``) in a gloo group on
    the one card at ``data=1, model=2``, each with all 16 rows x 3 s, the
    student and teacher cut by the JAX rule (the complex convs and
    products column-parallel, K1f/K1b on the gathered W_hh): the default
    ``clskd`` step (3 steps) and the pretraining step (2 steps) from phase
    7's weights against the one-process step on the same rows: every loss
    within 1e-5, every gathered gradient of step 1 within 1e-4 or twice
    its rounding floor, the whole leaves and statistics equal bit for bit
    on the two ranks, half of every sharded leaf and of its Adam moments
    on each rank (their bytes printed), launches a step as one process's;
    the step ms and each rank's peak memory beside the one-process step's.
    NCCL across cards is not measured (one card; NCCL refuses two ranks on
    one device).

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
# T at the LSTM of a 10 s utterance in offline evaluation (phase 22), and
# of a 3 s clip in the asteroid DCCRNet family (phase 23)
EVAL_FRAMES = 1603
DCCRNET_FRAMES = 471
# (T, N, H) of the real-LSTM bottleneck (use_clstm=False) at the teacher's
# width on 32 x 3 s: N = 32 rows (no real/imaginary stacking), H = rnn 256
REAL_LSTM_SHAPE = (483, 32, 256)

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
# measured in the run (``synced_steps``), where it is above
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
# phase 4's requests: 3-10 s of odd lengths
REQUEST_LENGTHS = (3 * 16000 + 77, 5 * 16000 + 1301, 7 * 16000 + 4099, 10 * 16000)
# phases 22-23, evaluation card against CPU on the same bundle: STOI
# (absolute), SI-SDR, SDR and SAR (dB), PESQ (MOS); the estimate's example
# wav read back as PCM16 (the waveform's 1e-4 times the estimate's peak
# scaling, plus rounding)
EVAL_STOI_ATOL = 1e-4
EVAL_DB_ATOL = 1e-3
EVAL_PESQ_ATOL = 1e-3
EVAL_WAV_ATOL = 1e-3
# phase 23's seeded asteroid bundles and the CLI's test set
ASTEROID_TEACHER, ASTEROID_STUDENT = "DCCRN-CL", "DCCRN-CL-test"
ASTEROID_CLI_OVERRIDES = ("data.synthetic=true", "data.synthetic_size=4", "data.segment=3.0")
# phase 24's CLI loop: the dccrnet presets (config.DCCRNET_TEACHER and
# DCCRNET_STUDENT) as overrides of the default teacher and student, whose
# widths they share; and its run: one epoch of 2 steps of 4 x 1 s (the
# synthetic set's validation split is max(8, size / 16) clips: 8, two
# batches), the top-1 checkpoint
DCCRNET_PRESETS = ("teacher.family=dccrnet", "teacher.name=dccrn-cl",
                   "teacher.stft.window=sqrthann", "student.family=dccrnet",
                   "student.name=dccrnet-cl-test", "student.stft.window=sqrthann")
DCCRNET_CLI_OVERRIDES = ("data.synthetic=true", "data.synthetic_size=8", "data.segment=1.0",
                         "data.batch_size=4", "max_epochs=1", "keep_top_k=1")
# phase 25: timed pretraining steps (float32, bf16; the complex-BN and
# real-LSTM form), and the pretraining CLI's run: one epoch of 2 steps of
# 4 x 1 s (validation 8 clips, two batches), the top-1 checkpoint
PRETRAIN_STEPS, PRETRAIN_REAL_STEPS = 5, 3
# its card-vs-CPU steps' rounding floors: the largest move of the CPU's
# gradients over this many random roundings of the input.  In bf16 at
# random init one rounding moved nearly every gradient by 0.15-0.2, and
# one draw gave enc5_prelu.alpha a floor under half its card-vs-CPU error
# of 0.214 (NVIDIA H100 80GB HBM3, 700 W)
FLOOR_SEEDS = (7, 8, 9)
PRETRAIN_CLI_OVERRIDES = DCCRNET_CLI_OVERRIDES


# bf16 (phases 17-19): bench.py's headline form, teacher and student
# compute_dtype and distill.taps_dtype bfloat16, at batch 32 beside phase 7
# and at bench.py's default batch 64; the dense bf16 tensor-core peak
BF16 = "bfloat16"
PEAK_BF16_FLOP_S = 989e12
BF16_DISTILL = dict(taps_dtype=BF16)
BF16_KERNEL_DISTILL = dict(taps_dtype=BF16, **ABF_KERNEL_FLAGS)
BF16_BATCH = 64
# the kernels with a bf16 instantiation (their counters' names end in _bf16)
BF16_KERNELS = ("conv3x3_fwd", "conv3x3_wgrad", "attfuse_fwd", "attfuse_bwd", "abf_block_fwd",
                "abf_block_bwd", "gram_pair_fwd")
# the bf16 losses against the float32 ones over this many steps from the
# same seeded state: the JAX package's bounds (tests/test_train.py's
# test_bf16_loss_parity_with_f32)
BF16_PARITY_STEPS = 4
# the bf16 kernels' float32 outputs (K3w's dw, K4b's parameter gradients)
# against their plain versions, relative L2: float32 sums in another order
BF16_KERNEL_REL_L2 = 1e-5
PARITY_RTOL, PARITY_ATOL = 0.05, 5e-3
# card vs CPU under bf16: every op rounds to bf16 on both sides, and where
# an op's float32 sum falls on the other side of a rounding boundary the two
# part by one bf16 spacing (2^-8 relative) and carry it on.  Measured on an
# NVIDIA H100 80GB HBM3 at 700 W (4 x 1 s, full width): the loss 2.6e-5 and
# 7.6e-5 (default and K3/K4 path); the gradients 0.040 (an ABF bn2 bias, a
# cancelling sum) and 0.037, against a rounding floor of 0.32 (the input
# times 1 + 2^-8, one bf16 spacing: a PReLU slope's gradient); a conv bias
# in front of a batch-statistics BN 2.0e-3 of the global norm.  Held: the
# loss to BF16_LOSS_RTOL, the gradients to ROUNDING_FACTOR times their floor
# but at most BF16_GRAD_REL_L2, the zero gradients to BF16_ZERO_GRAD.
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_REL_L2 = 0.1
BF16_ZERO_GRAD = 1e-2
# the bf16 teacher's enhanced waveform, card against CPU (max abs; measured
# 5.1e-4)
BF16_SERVING_ATOL = 5e-3


# Each kernel's design: K1f, K1b, K2, K3f, K3w, K5f and K5b are in their
# second, K4f and K4b in their first, and of the bf16 kernels K3f and K3w in
# their second (the bf16 conv tile on TMA and wgmma), K4f and K4b in their
# second (csrc/attfuse_bf16.cu: a persistent block walks residual strips,
# bulk-copied into a ring of stages on mbarriers, 8 channels a lane), K5f
# and K5b in their third (csrc/abf_block_bf16.cu: K5b's adjoint consumed in
# the same kernel, K5f's xf formed in shared memory and convolved there), K2
# in its second (csrc/gram_pair_bf16.cu: the float32 K2's persistent walk,
# its ring filled by TMA boxes, the products on mma.sync m16n8k16 over a
# k-slice a warp, the warps' tiles added in a fixed tree) (PERF.md section 6
# keeps each design's times).
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
    "conv3x3_fwd_bf16": "tma-ring-resident-weights-wgmma",
    "conv3x3_wgrad_bf16": "tma-ring-wgmma",
    "attfuse_fwd_bf16": "residual-strip-items-bulk-copy-ring-16-byte-lanes",
    "attfuse_bwd_bf16": "residual-strip-items-bulk-copy-ring-16-byte-lanes",
    "abf_block_fwd_bf16": "xf-formed-in-smem-ring-wgmma-conv",
    "abf_block_bwd_bf16": "fused-wgmma-adjoint-register-pass",
    "gram_pair_fwd_bf16": "tma-box-ring-mma-sync-k-slices",
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
                                         ("k3_bf16", conv3x3.BF16_SOURCE),
                                         ("k5f", abf_block.FWD_SOURCE),
                                         ("k5b", abf_block.BWD_SOURCE),
                                         ("k5_bf16", abf_block.BF16_SOURCE),
                                         ("k2_bf16", gram.BF16_SOURCE))}
    say("build", seconds=round(seconds, 3),
        libraries=[str(p.relative_to(ROOT)) for p in paths], ptxas=ptxas,
        tensor_cores=tensor_cores)
    for name, found in tensor_cores.items():
        if found["count"] == 0:
            raise RuntimeError(f"{name}'s mma kernels use no tensor-core instruction: {found}")
        # the bf16 conv tile's TMA route (in K3's bf16 library and K5's) and
        # the fused bf16 K5b's adjoint on wgmma
        if name in ("k3_bf16", "k5f", "k5b", "k5_bf16") and found["wgmma_count"] == 0:
            raise RuntimeError(f"{name}'s wgmma kernels use no wgmma instruction: {found}")


def _tensor_core_check(library: Path, source: str) -> dict:
    """The tensor-core instructions in the mma kernels (``*mma_kernel*``) of
    ``source``'s library (K3f's, K3w's, the bf16 K3's, K5f's, K5b's, the bf16
    K2's): HMMA or HGMMA in ``cuobjdump -sass`` of the built library where
    the toolkit has cuobjdump (``count``), and HGMMA alone in the bf16 tile's
    TMA kernels (``*wgmma_kernel*``, ``wgmma_count``); else mma/wgmma in the
    PTX that nvcc gives for the source."""
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
        wgmma = sum(len(re.findall(r"\bHGMMA\b", f)) for f in funcs
                    if "wgmma_kernel" in f.split("\n", 1)[0])
        return {"checked": "sass (cuobjdump)", "instruction": "HMMA/HGMMA", "count": count,
                "wgmma_count": wgmma}
    ptx = _build.BUILD_DIR / (Path(source).stem + ".ptx")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=compute_90a",
                    "-std=c++17", "-O3", "-ptx", "-o", str(ptx),
                    str(_build.CSRC_DIR / source)], check=True, capture_output=True,
                   text=True, timeout=300)
    text = ptx.read_text()
    return {"checked": "ptx (nvcc -ptx; no cuobjdump)", "instruction": "mma/wgmma",
            "count": len(re.findall(r"\b(?:mma|wgmma)\.", text)),
            "wgmma_count": len(re.findall(r"\bwgmma\.mma_async\b", text))}


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
    # ragged; a call with an initial state; the spkd step's 33 s clips
    # (T=5283) at batch 16 for both widths; offline evaluation of a 10 s
    # utterance at batch 1 (T=1603, phase 22); and the asteroid DCCRNet
    # family at 32 x 3 s (T=471: one frame less a layer of its 6 encoders,
    # phase 23) for the teacher (H=128) and the student (H=32); and the
    # real-LSTM bottleneck of phase 25 (use_clstm=False) at the teacher's
    # width, 32 x 3 s (N=32, H=256: 4H = MAX_GATES, the widest plan).
    shapes = [(483, 2, 32, False), (483, 64, 32, False), (483, 2, 128, False),
              (483, 64, 128, False), (118, 2, 32, False), (57, 3, 128, False),
              (20, 266, 32, False), (20, 201, 128, False), (118, 6, 32, True),
              (SPKD_FRAMES, 32, 32, False), (SPKD_FRAMES, 32, 128, False),
              (EVAL_FRAMES, 2, 32, False), (DCCRNET_FRAMES, 64, 128, False),
              (DCCRNET_FRAMES, 64, 32, False), REAL_LSTM_SHAPE + (False,)]
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
        again = lstm_seq(xw, w_hh, h0, c0)
        if lstm_seq.launches != before + 2:
            raise RuntimeError("lstm_seq did not count its launches")
        with float32_math():
            ry, rc = lstm_seq_reference(xw, w_hh, h0, c0)
        torch.cuda.synchronize()
        err_y = (y - ry).abs().max().item()
        err_c = (c - rc).abs().max().item() / max(1.0, rc.abs().max().item())
        repeat = bool(torch.equal(y, again[0]) and torch.equal(c, again[1]))
        ok = err_y <= KERNEL_ATOL and err_c <= KERNEL_ATOL and repeat
        del again
        rec = {"T": T, "N": N, "H": H, "initial_state": with_state,
               "plan": lstm_seq_fwd_plan(N, H), "max_abs_err_y": err_y,
               "max_rel_err_c": err_c, "tol": KERNEL_ATOL, "bitwise_repeat": repeat}
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


def eval_requests():
    """Phase 4's requests with their clean sources, as an evaluation set:
    ``(mixture [T], sources [1, T], id)`` each."""
    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    ds = SyntheticEnhancementDataset(size=len(REQUEST_LENGTHS), segment=10.0, seed=0)
    return [(ds[i][0][:n], ds[i][1][:, :n], f"request{i}")
            for i, n in enumerate(REQUEST_LENGTHS)]


def _requests():
    return [mix for mix, _, _ in eval_requests()]


def streaming_record(eng, cpu) -> dict:
    """``eng`` (on the card) streams phase 4's requests whole and then chunk
    by chunk as a live stream arrives; ``cpu``, the same engine on the CPU,
    streams them whole.  The record, with K1f's launches held to 4 a chunk's
    forward."""
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq

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

    err = max(float(np.abs(cpu.stream(w) - o).max()) for w, o in zip(reqs, outs))
    finite = all(np.isfinite(o).all() and o.shape == w.shape for w, o in zip(reqs, outs))
    return dict(requests=len(reqs), audio_s=audio_s, chunk_frames=eng.chunk,
                context_frames=eng.context, latency_ms_algorithmic=eng.latency_ms,
                chunk_ms_median=float(np.median(chunk_ms)),
                chunk_ms_p99=float(np.percentile(chunk_ms, 99)), chunks_timed=len(chunk_ms),
                rtf_stream=wall / audio_s, forwards=forwards, lstm_launches=launches,
                max_abs_err_vs_cpu=err, tol=SERVING_ATOL, finite=finite)


def phase_serving_student():
    rec = streaming_record(student_engine("cuda"), student_engine("cpu"))
    say("serving_student", bundle=str(BUNDLE.relative_to(ROOT)), **rec)
    if not rec["finite"] or rec["max_abs_err_vs_cpu"] > SERVING_ATOL:
        raise RuntimeError("streaming output on the card disagrees with the CPU")
    return rec["lstm_launches"]


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
    return launches, {"forward_ms": wall * 1e3, "rtf": wall / (batch * seconds),
                      "peak_mem_bytes": peak}


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
    # batch 2, the DCCRNet student's of phase 24 (T=471 at 3 s), and the
    # two LSTMs phase 25 trains: the teacher's complex LSTM (N=64, H=128,
    # the pretraining path's) and its real-LSTM bottleneck (N=32, H=256)
    shapes = [(483, 64, 32, False), (483, 2, 32, False), (483, 64, 128, False),
              (20, 201, 128, False), (57, 3, 32, False), (118, 6, 32, True),
              (SPKD_FRAMES, 32, 32, False), (SPKD_FRAMES, 4, 32, False),
              (DCCRNET_FRAMES, 64, 32, False), REAL_LSTM_SHAPE + (False,)]
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


def train_config(batch: int, seconds: float, distill: dict = None, optim: dict = None,
                 **fields):
    """``TrainConfig()`` at ``batch`` x ``seconds``, with the ``distill``
    fields (e.g. ``ABF_KERNEL_FLAGS``) and the ``optim`` fields set;
    ``fields`` override the rest (the CPU rehearsals shrink the models)."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import (
        DistillConfig,
        OptimConfig,
        TrainConfig,
    )

    cfg = TrainConfig(distill=DistillConfig(**(distill or {})),
                      optim=OptimConfig(**(optim or {})), **fields)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=batch, segment=seconds))


def _grads(trainer):
    return {f"{part}.{n}": p.grad.detach().cpu()
            for part, m in trainer.trainable().items() for n, p in m.named_parameters()}


def _grad_errors(card, cpu, grad_norm):
    """Relative L2 error of every gradient tensor, card against CPU, by
    tensor name, and the worst of the exempt ones.  Two kinds are held
    otherwise (tests/test_torch_trainer.py says why): a conv bias in front of
    a batch-statistics BN (real or complex) has a zero gradient in exact
    arithmetic (rounding noise on both sides: held to ZERO_GRAD of the
    global norm), and an ABF bn2 bias is a sum of cancelling terms (held
    against the same block's bn2.scale gradient)."""
    import re

    errors, exempt = {}, 0.0
    for name, want in cpu.items():
        got = card[name]
        m = re.fullmatch(r"(student|model)\.((enc|dec)\d+)_conv\.b[ri]", name)
        if m and any(n.startswith(f"{m.group(1)}.{m.group(2)}_bn.") for n in cpu):
            exempt = max(exempt, got.abs().max().item() / grad_norm,
                         want.abs().max().item() / grad_norm)
            continue
        ref = cpu[name[:-len("bias")] + "scale"] if name.endswith("bn2.bias") else want
        errors[name] = ((got - want).norm() / max(ref.norm(), 1e-30)).item()
    return errors, exempt


def gaussian_batch(batch: int, seconds: float, seed: int = 0):
    """White-noise (mixture, clean) pairs at 0.1 scale, as the CPU tests
    use: flat spectra keep the log-magnitude loss well conditioned."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((batch, int(seconds * 16000)))).astype(np.float32)
    return clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32), clean


def _kernel_counters() -> dict:
    """Every kernel of the training step, by kernel name: ``(wrapper, its
    counter's attribute)``; a wrapper counts its bf16 instantiation's
    launches in ``launches_bf16``."""
    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd
    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_fwd,
    )
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_wgrad
    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd
    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_bwd

    wrappers = {"lstm_seq_fwd": lstm_seq, "lstm_seq_bwd": lstm_seq_bwd,
                "conv3x3_fwd": conv3x3_fwd, "conv3x3_wgrad": conv3x3_wgrad,
                "attfuse_fwd": attention_fuse_fwd, "attfuse_bwd": attention_fuse_bwd,
                "abf_block_fwd": abf_block_fwd, "abf_block_bwd": abf_block_bwd,
                "gram_pair_fwd": gram_pair_fwd}
    counters = {name: (fn, "launches") for name, fn in wrappers.items()}
    counters.update({f"{name}_bf16": (wrappers[name], "launches_bf16") for name in BF16_KERNELS})
    return counters


def _zero_counts(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _counts(counters: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def seeded_trainer(cfg, device: str, seed: int, teacher_variables: dict = None,
                   pretrain: bool = False):
    """``Trainer(cfg)`` on ``device`` with seeded weights (the teacher's
    ``teacher_variables`` where given), or with ``pretrain`` a
    ``PretrainTrainer`` of ``cfg``'s teacher."""
    if pretrain:
        from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer

        return PretrainTrainer(cfg, device=device).init_state(seed)
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    return Trainer(cfg, device=device).init_state(seed, teacher_variables=teacher_variables)


def fitting_trainer(distill: dict, seconds: float, optim: dict = None,
                    batch: int = TEACHER_BATCH, models: dict = None,
                    teacher_variables: dict = None, pretrain: bool = False):
    """A ``Trainer`` on the card at full width on clips of ``seconds``, after
    one warm-up step, at the largest batch from ``batch`` down, halving,
    that fits: ``(trainer, batch, cut, mix, clean)``, ``cut`` listing each
    halving.  ``models``: the teacher and student configs (``bf16_models``),
    the defaults' otherwise; ``teacher_variables``: the teacher's weights
    (a flax-layout tree), seeded ones otherwise; ``pretrain``: a
    ``PretrainTrainer`` of the teacher in its place."""
    import torch

    cut = []
    while True:
        mix, clean = train_batch(batch, seconds)
        trainer = seeded_trainer(train_config(batch, seconds, distill, optim, **(models or {})),
                                 "cuda", 0, teacher_variables, pretrain)
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
              check_seconds: float = CHECK_SECONDS, rounding_floor: bool = False,
              optim: dict = None, check=None, beside: dict = None,
              batch: int = TEACHER_BATCH, models: dict = None,
              teacher_variables: dict = None, own_floor: bool = False,
              pretrain: bool = False, floor_seeds: tuple = ()) -> dict:
    """One warm-up and ``steps`` timed steps at full width on ``batch`` clips
    of ``seconds`` (batch halved while it does not fit; ``models``,
    ``teacher_variables`` and ``pretrain`` as ``fitting_trainer`` takes
    them), launches per step held to ``expected``
    (every other kernel: none), then the card-vs-CPU step on ``check_batch``
    clips of ``check_seconds`` (``card_vs_cpu_checks``; ``rounding_floor``:
    its gradients held against their rounding floor; ``own_floor`` as
    ``synced_steps`` takes it), or ``check()`` in
    its place; the check's ``failures`` fail the phase.  ``beside``: another
    phase's numbers, printed in the record."""
    import numpy as np
    import torch

    counters = _kernel_counters()
    trainer, batch, cut, mix, clean = fitting_trainer(distill, seconds, optim, batch, models,
                                                      teacher_variables, pretrain)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    _zero_counts(counters)
    for _ in range(steps):
        t0 = time.perf_counter()
        logs = trainer.train_step(mix, clean)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["train_loss"]))
    launches = _counts(counters)
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
               launches=launches, launches_per_step=per_step, finite=finite,
               **({"beside": beside} if beside else {}))
    del trainer
    torch.cuda.empty_cache()

    if check is None:
        cfg = train_config(check_batch, check_seconds, distill, optim, **(models or {}))
        rec["card_vs_cpu"] = card_vs_cpu_checks(cfg, "cuda", rounding_floor, teacher_variables,
                                                own_floor, pretrain, floor_seeds)
    else:
        rec["card_vs_cpu"] = check()
    say(phase, **rec)
    want = {name: expected.get(name, 0) for name in counters}
    if per_step != want:
        raise RuntimeError(f"kernel launches per step {per_step}, expected {want}")
    if not finite:
        raise RuntimeError("a training step gave a non-finite value")
    if rec["card_vs_cpu"]["failures"]:
        raise RuntimeError(f"the training step on the card disagrees with the CPU: "
                           f"{rec['card_vs_cpu']['failures']}")
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
# The attention fuses of the kernel-config step at 32 x 3 s: one a fusing
# block of STEP_BLOCKS, x [32, D, 483, 64] with the residual at D / 2 (k =
# 2): D 8 .. 128 in the encoder chain, 16 .. 256 in the decoder's.
STEP_FUSE_D = [D for fuse, D, _, _ in STEP_BLOCKS if fuse]


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
PROFILE_ATTEMPTS = 3


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


def _gram_calls(events) -> list:
    """The complete calls among K2's profiled kernels, in start order: each
    first pass (``gram_partial``) directly followed by its second pass
    (``gram_sum``). A call of which the profiler lost a record is left out."""
    calls = []
    for a, b in zip(events, events[1:]):
        if "gram_partial" in a.name and "gram_sum" in b.name:
            calls.append((a, b))
    return calls


def gram_times(fn, nbytes: int, iters: int = 20) -> dict:
    """K2's times for ``fn`` (one ``gram_pair_fwd`` call on ``nbytes`` of
    inputs), L2 flushed between launches where the inputs fit in it:

    - ``ms``: device time a call, from the profiler's device events: the
      first pass's start to the second pass's end (``gram_*`` kernels, two
      a call; the calls queued behind a device-side wait, so that none waits
      for the host), with ``pass1_ms`` and ``pass2_ms`` (the second pass
      from where the first ends, as it may start earlier and wait), over the
      ``calls_timed`` calls whose two records the profiler kept;
    - ``event_ms``: CUDA events (back to back without a flush, so a
      host-bound loop shows here and not in ``ms``);
    - ``host_ms``: host time to enqueue one call.

    The profiler loses some kernel records now and then (on the card: the
    first profile of each bf16 case, 28 of 40 records in all three profiles
    of one run). A profile that keeps fewer than half the calls whole is
    taken again, up to ``PROFILE_ATTEMPTS`` times; if none does, ``ms`` is
    read from CUDA events around each call queued behind the same wait (with
    the flush before each), ``timing`` says which, and the pass split is
    None."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = _flusher(nbytes)
    fn()
    torch.cuda.synchronize()
    calls, names, seen = [], set(), []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(QUEUE_CYCLES)
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and "gram_" in e.name), key=lambda e: e.time_range.start)
        seen.append(len(events))
        names |= {re.search(r"gram_\w+", e.name).group(0) for e in events}
        calls = _gram_calls(events)
        if 2 * len(calls) >= iters and len(calls) <= iters:
            break
    else:
        calls = []
    rec = {"kernels": sorted(names), "profile_attempts": attempt,
           "profiled_records": seen, "calls_timed": len(calls)}
    if calls:
        us = 1e3 * len(calls)
        rec.update(
            timing="profiler",
            ms=sum(b.time_range.end - a.time_range.start for a, b in calls) / us,
            pass1_ms=sum(a.time_range.end - a.time_range.start for a, _ in calls) / us,
            pass2_ms=sum(b.time_range.end - max(b.time_range.start, a.time_range.end)
                         for a, b in calls) / us)
    else:
        pairs = []
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(iters):
            if flush is not None:
                flush()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        rec.update(timing="cuda_events", calls_timed=iters,
                   ms=sum(a.elapsed_time(b) for a, b in pairs) / iters,
                   pass1_ms=None, pass2_ms=None)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    rec.update(event_ms=_event_ms(fn, iters), host_ms=host_ms, l2_flushed=flush is not None)
    return rec


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
    _zero_counts(counters)
    t0 = time.perf_counter()
    logs = trainer.train_step(mix, clean)
    torch.cuda.synchronize()
    rec = dict(strategy=strategy, batch=batch, seconds=TRAIN_SECONDS,
               step_ms=(time.perf_counter() - t0) * 1e3,
               logs={k: float(v) for k, v in logs.items()},
               launches=_counts(counters),
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


# the reviewkd strategy of phase 15
REVIEWKD = dict(strategy="reviewkd")
# phase 16: the options of a tuned clskd run on the whole-block kernel path
# (remat doubles K5f's launches), its optimizer (the clip far below the
# step's gradient norm, so every step clips; a warmup of 2 steps, so the
# check's 3 steps take lr 0, lr / 2 and lr), and the XLA-route options
OPTION_DISTILL = dict(abf_block_pallas=True, abf_remat=True, spkd_bn2_fold=True)
OPTION_OPTIM = dict(optimizer="adamw", weight_decay=1e-2, grad_clip=0.05,
                    lr_schedule="cosine", warmup_steps=2)
OPTION_CHECK_STEPS = 3
XLA_ROUTE_DISTILL = dict(abf_conv_ninedot=True, abf_reinit_each_step=True)


def _mirror(dst, src) -> None:
    """``src``'s weights, statistics, optimizer state and counters into
    ``dst`` (another device)."""
    from speech_enhancement_clskd_tpu_torch.utils.bridge import trainer_parts

    for part in trainer_parts(src):
        getattr(dst, part).load_state_dict(getattr(src, part).state_dict())
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    dst.step, dst.epoch = src.step, src.epoch


def neighbour_rounding(mix, seed: int, bf16: bool = False):
    """``mix`` rounded once more in a way the model sees: each sample moved
    up or down at random (by ``seed``) to a float32 neighbour, or under
    bf16 compute by one bf16 spacing (times 1 +- 2^-8).  A uniform scaling
    is taken out by the first BN and by the scale-invariant losses."""
    import numpy as np

    up = np.random.default_rng(seed).random(mix.shape) < 0.5
    if bf16:
        return (mix * np.where(up, 1 + 2.0 ** -8, 1 - 2.0 ** -8)).astype(np.float32)
    return np.nextafter(mix, np.where(up, np.inf, -np.inf).astype(np.float32))


def synced_steps(cfg, mix, clean, device: str, steps: int, grads: bool = True,
                 rounding_floor: bool = False, teacher_variables: dict = None,
                 own_floor: bool = False, pretrain: bool = False,
                 floor_seeds: tuple = ()) -> dict:
    """``steps`` steps of ``Trainer(cfg)`` on ``device`` from seeded weights
    (the teacher's ``teacher_variables`` where given; with ``pretrain`` a
    ``PretrainTrainer`` of ``cfg``'s teacher, ``seeded_trainer``),
    each mirrored by a CPU trainer loaded with the device trainer's state
    just before it (weights, statistics, the optimizer's moments and step),
    so every step is compared at one point (cuDNN on deterministic
    algorithms): per step the loss's relative error and, with ``grads``, the
    gradients' (``_grad_errors``, of the clipped gradients, the exempt ones
    against the clipped norm), the learning rate, the gradient norm before
    clipping and after, and the device's kernel launches.  With
    ``rounding_floor`` a third trainer, mirrored alike, takes the step on
    the input rounded once more (each sample times 1 + 2^-23; under bf16
    compute 1 + 2^-8, one bf16 spacing, which moves the bf16 spectrum by a
    rounding; with ``floor_seeds``, one more trainer a seed, each on
    ``neighbour_rounding`` of the input, and each tensor's floor the
    largest of their moves), and the gradients are held to
    ``ROUNDING_FACTOR`` times the
    largest change that gives where that is above ``TRAIN_GRAD_REL_L2``
    (under bf16 at most ``BF16_GRAD_REL_L2``).  With ``own_floor`` as well,
    a tensor above that is held to ``ROUNDING_FACTOR`` times its own floor
    instead (the input rounded once more moved that tensor by as much), and
    is listed in ``admitted_by_own_floor``.
    The loss is held to ``TRAIN_LOSS_RTOL``, under bf16 compute to
    ``BF16_LOSS_RTOL``.  ``failures`` lists what was not held."""
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.train.trainer import _global_norm

    counters = _kernel_counters()
    on_card = device == "cuda"
    def make(dev):
        return seeded_trainer(cfg, dev, 1, teacher_variables if dev == device else None,
                              pretrain)

    card = make(device)
    cpu = make("cpu")
    # the input's roundings of the floor: the uniform scaling, or one a seed
    roundings = list(floor_seeds) or [None]
    agains = [make("cpu") for _ in roundings] if grads and rounding_floor else []
    again = agains[0] if agains else None
    clip = cfg.optim.grad_clip
    # the trained model's dtype: the student's, or a pretrained model's
    bf16 = getattr(card, "model_cfg", cfg.student).compute_dtype == "bfloat16"
    loss_rtol = BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
    rounding = 2.0 ** -8 if bf16 else 2.0 ** -23
    recs, failures = [], []
    deterministic = torch.backends.cudnn.deterministic
    for k in range(steps):
        _mirror(cpu, card)
        for a in agains:
            _mirror(a, card)
        _zero_counts(counters)
        torch.backends.cudnn.deterministic = True
        try:
            card_logs = card.train_step(mix, clean)
            if on_card:
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches = _counts(counters)
        t0 = time.perf_counter()
        cpu_logs = cpu.train_step(mix, clean)
        want = float(cpu_logs["train_loss"])
        norm = float(cpu_logs["grad_norm"])
        rec = {"step": k, "lr": card.optimizer.param_groups[0]["lr"],
               "loss": float(card_logs["train_loss"]),
               "loss_rel_err": abs(float(card_logs["train_loss"]) - want) / abs(want),
               "grad_norm": norm, "cpu_step_s": time.perf_counter() - t0, "launches": launches}
        if clip:
            rec["clipped_norm"] = float(_global_norm(
                p for m in card.trainable().values() for p in m.parameters()))
            if not (norm > clip and abs(rec["clipped_norm"] - clip) <= 1e-5 * clip):
                failures.append(f"step {k}: norm {norm} not clipped to {clip}")
        if rec["loss_rel_err"] > loss_rtol:
            failures.append(f"step {k}: loss rel err {rec['loss_rel_err']}")
        if grads:
            scale = min(norm, clip or norm)
            cpu_grads = _grads(cpu)
            errors, zero = _grad_errors(_grads(card), cpu_grads, scale)
            worst = max(errors, key=errors.get)
            tol = TRAIN_GRAD_REL_L2
            if again is not None:
                floors = {}
                for a, seed in zip(agains, roundings):
                    a.train_step((mix * np.float32(1 + rounding)).astype(np.float32)
                                 if seed is None else neighbour_rounding(mix, seed, bf16), clean)
                    moved, _ = _grad_errors(_grads(a), cpu_grads, scale)
                    floors = {n: max(e, floors.get(n, 0.0)) for n, e in moved.items()}
                floor_worst = max(floors, key=floors.get)
                tol = max(TRAIN_GRAD_REL_L2, ROUNDING_FACTOR * floors[floor_worst])
                if bf16:
                    tol = min(tol, BF16_GRAD_REL_L2)
                rec.update(rounding_floor=floors[floor_worst], rounding_floor_worst=floor_worst)
            over = {n: e for n, e in errors.items() if e > tol}
            if own_floor and again is not None:
                rec["admitted_by_own_floor"] = {
                    n: {"err": e, "own_floor": floors[n]} for n, e in over.items()
                    if e <= ROUNDING_FACTOR * floors[n]}
                over = {n: e for n, e in over.items() if n not in rec["admitted_by_own_floor"]}
            rec.update(grad_max_rel_l2=errors[worst], grad_worst=worst, grad_tol=tol,
                       zero_grad_max=zero)
            zero_tol = BF16_ZERO_GRAD if bf16 else ZERO_GRAD
            rec["zero_grad_tol"] = zero_tol
            if over or zero > zero_tol:
                failures.append(f"step {k}: gradients {over} against {tol}, zero {zero}")
        recs.append(rec)
    return {"batch": mix.shape[0], "seconds": mix.shape[1] / 16000, "steps": recs,
            "loss_rtol": loss_rtol, "zero_grad_tol": ZERO_GRAD, "failures": failures}


def card_vs_cpu_checks(cfg, device: str, rounding_floor: bool = False,
                       teacher_variables: dict = None, own_floor: bool = False,
                       pretrain: bool = False, floor_seeds: tuple = ()) -> dict:
    """The training phases' check: one step of ``cfg`` on ``device`` against
    the CPU from the same seeded weights (``synced_steps``; the teacher's
    ``teacher_variables`` where given; ``own_floor``, ``pretrain`` and
    ``floor_seeds`` as there) on white noise
    (the loss and the gradients held; ``rounding_floor`` as there) and on
    synthetic speech (the loss held: at random init on speech the
    log-magnitude loss's gradient is ill-conditioned), at ``cfg``'s batch
    and clip length."""
    batch, seconds = cfg.data.batch_size, cfg.data.segment
    rec = {"gaussian": synced_steps(cfg, *gaussian_batch(batch, seconds), device, 1,
                                    rounding_floor=rounding_floor,
                                    teacher_variables=teacher_variables, own_floor=own_floor,
                                    pretrain=pretrain, floor_seeds=floor_seeds),
           "speech": synced_steps(cfg, *train_batch(batch, seconds, seed=3), device, 1,
                                  grads=False, teacher_variables=teacher_variables,
                                  pretrain=pretrain)}
    rec["failures"] = [f"{name}: {f}" for name, r in rec.items() for f in r["failures"]]
    return rec


def option_checks(cfg, xla_cfg, device: str) -> dict:
    """Phase 16's check: ``OPTION_CHECK_STEPS`` steps of ``cfg`` on
    ``device`` against the CPU, each from the device's state (the learning
    rates 0, lr / 2, lr of the warmup, every step clipped), then one step
    of ``xla_cfg`` (the nine-dot conv, the ABF re-init), on white noise;
    the launches of each device step."""
    batch, seconds = cfg.data.batch_size, cfg.data.segment
    mix, clean = gaussian_batch(batch, seconds)
    rec = {"options": synced_steps(cfg, mix, clean, device, OPTION_CHECK_STEPS,
                                   rounding_floor=True),
           "xla_route": synced_steps(xla_cfg, mix, clean, device, 1, rounding_floor=True)}
    lrs = [r["lr"] for r in rec["options"]["steps"]]
    lr = cfg.optim.lr
    failures = [f"{name}: {f}" for name, r in rec.items() for f in r["failures"]]
    if not (lrs[0] == 0.0 and abs(lrs[1] - lr / 2) <= 1e-12 and abs(lrs[2] - lr) <= 1e-12):
        failures.append(f"learning rates {lrs}, expected 0, {lr / 2}, {lr}")
    rec["failures"] = failures
    return rec


def phase_training_reviewkd(phase7: dict) -> dict:
    """Phase 15: the ``reviewkd`` strategy as phase 9 (launches per step: K1f
    8, K1b 4) beside phase 7's step; its card-vs-CPU gradients held against
    their rounding floor (a PReLU slope's read 1.36e-4 on the card, where
    one rounding of the input moves another's by 9.1e-4 on the CPU; NVIDIA
    H100 80GB HBM3, 700 W)."""
    return _training("training_reviewkd", "reviewkd TrainConfig(distill=DistillConfig("
                     "strategy='reviewkd'))", REVIEWKD, KERNEL_TRAIN_STEPS,
                     {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}, rounding_floor=True,
                     beside=_beside("phase 7 (clskd)", phase7))


def phase_training_options(block: dict) -> dict:
    """Phase 16: clskd with ``OPTION_DISTILL`` and ``OPTION_OPTIM`` as phase
    11 (launches per step: K5f 24, K5b 12, K1f 8, K1b 4), its check
    ``option_checks``, beside phase 11's step and peak memory."""
    cfg = train_config(CHECK_BATCH, CHECK_SECONDS, OPTION_DISTILL, OPTION_OPTIM)
    xla_cfg = train_config(CHECK_BATCH, CHECK_SECONDS, XLA_ROUTE_DISTILL)
    rec = _training("training_options", f"clskd TrainConfig(distill=DistillConfig("
                    f"**{OPTION_DISTILL}), optim=OptimConfig(**{OPTION_OPTIM}))",
                    OPTION_DISTILL, KERNEL_TRAIN_STEPS,
                    {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4, "abf_block_fwd": 24,
                     "abf_block_bwd": 12}, optim=OPTION_OPTIM,
                    check=lambda: option_checks(cfg, xla_cfg, "cuda"),
                    beside=_beside("phase 11 (abf_block_pallas)", block))
    want = {name: {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}.get(name, 0) for name in _kernel_counters()}
    got = rec["card_vs_cpu"]["xla_route"]["steps"][0]["launches"]
    if got != want:
        raise RuntimeError(f"the XLA-route options' step launched {got}, expected {want}")
    return rec


def _beside(label: str, rec: dict) -> dict:
    return {"phase": label, "step_ms_median": rec["step_ms_median"],
            "audio_s_per_s": rec["audio_s_per_s"], "peak_mem_bytes": rec["peak_mem_bytes"]}


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
    _zero_counts(counters)
    t0 = time.perf_counter()
    history = trainer.fit(log_fn=lines.append, checkpoint_manager=mgr, metric_writer=writer)
    sync()
    fit_s = time.perf_counter() - t0
    launches = _counts(counters)
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


# ------------------------------------------------------------------ bf16


def bf16_models() -> dict:
    """The default teacher and student, computing in bf16."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import STUDENT, TEACHER

    return {"teacher": dataclasses.replace(TEACHER, compute_dtype=BF16),
            "student": dataclasses.replace(STUDENT, compute_dtype=BF16)}


def _bound_bf16(nbytes: float, flops: float) -> tuple:
    """The least time for ``nbytes`` moved and ``flops`` operations as bf16
    tensor-core products."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_conv_case(B, D, T, C, O, timed: bool, dx: bool = False,
                    step: bool = False) -> dict:
    """The bf16 K3f (or its dx pass, ``dx``: the same kernel, C and O of the
    incoming gradient and the block's input) and K3w at x [B, D, T, C] -> O
    against their plain bf16 versions: the bf16 output by ``bf16_check``
    (one bf16 spacing, or ``SUM_REL`` of the sum of the products' magnitudes
    where the sum cancels), dw by relative L2, two runs' bits; timed: the
    kernels, their plain versions, the bound and cuDNN's bf16
    ``F.conv2d``/``conv2d_weight``; ``step`` (a shape of the kernel-config
    step): the kernels, the bound and cuDNN's, without the plain versions."""
    import torch
    import torch.nn.functional as F

    from speech_enhancement_clskd_tpu_torch.kernels import SUM_REL, bf16_check
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import (
        conv3x3_fwd,
        conv3x3_fwd_route,
        conv3x3_reference,
        conv3x3_wgrad,
        conv3x3_wgrad_reference,
        conv3x3_wgrad_route,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + C + O + 7)
    x = torch.randn(B, D, T, C, device="cuda", generator=g).bfloat16()
    w = (torch.randn(3, 3, C, O, device="cuda", generator=g) / (3 * C ** 0.5)).bfloat16()
    gy = torch.randn(B, D, T, O, device="cuda", generator=g).bfloat16()
    before = (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16)
    out = conv3x3_fwd(x, w)
    repeat = bool(torch.equal(out, conv3x3_fwd(x, w)))
    dw = conv3x3_wgrad(x, gy)
    dw_repeat = bool(torch.equal(dw, conv3x3_wgrad(x, gy)))
    torch.cuda.synchronize()
    if (conv3x3_fwd.launches_bf16, conv3x3_wgrad.launches_bf16) != (before[0] + 2,
                                                                     before[1] + 2):
        raise RuntimeError("the bf16 conv3x3 kernels did not count their launches")
    with float32_math():
        check = bf16_check(out, conv3x3_reference(x, w),
                           conv3x3_reference(x.abs().float(), w.abs().float()), SUM_REL)
        err_dw = _rel_l2(dw, conv3x3_wgrad_reference(x, gy))
    del out, dw
    rec = {"B": B, "D": D, "T": T, "C": C, "O": O, "pass": "dx" if dx else "fwd",
           "fwd_route": conv3x3_fwd_route(C, O, torch.bfloat16),
           "wgrad_route": conv3x3_wgrad_route(C, O, torch.bfloat16),
           "fwd_check": check, "fwd_max_abs_err": check["max_abs_err"],
           "fwd_bitwise_repeat": repeat, "wgrad_rel_l2": err_dw,
           "wgrad_bitwise_repeat": dw_repeat, "wgrad_tol": BF16_KERNEL_REL_L2}
    if timed or step:
        rows = B * D * T
        flops = 2.0 * rows * 9 * C * O
        fwd_bytes = 2.0 * (rows * C + 9 * C * O + rows * O)
        wgrad_bytes = 2.0 * (rows * C + rows * O) + 4.0 * 9 * C * O
        tensor_cores = ("mma", "wgmma")
        fwd_bound = (_bound_bf16 if rec["fwd_route"] in tensor_cores else _bound)(fwd_bytes,
                                                                                 flops)
        wgrad_bound = (_bound_bf16 if rec["wgrad_route"] in tensor_cores else _bound)(
            wgrad_bytes, flops)
        x_nchw, gy_nchw = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        with float32_math():
            rec.update(
                fwd_ms=_time_ms(lambda: conv3x3_fwd(x, w), iters=10),
                fwd_library_ms=_time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), iters=10),
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                wgrad_ms=_time_ms(lambda: conv3x3_wgrad(x, gy), iters=10),
                wgrad_library_ms=_time_ms(lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, w_oihw.shape, gy_nchw, padding=1), iters=10),
                wgrad_bound_ms=wgrad_bound[0], wgrad_bound_by=wgrad_bound[1])
            if timed:
                rec.update(
                    fwd_plain_ms=_time_ms(lambda: conv3x3_reference(x, w), iters=2),
                    wgrad_plain_ms=_time_ms(lambda: conv3x3_wgrad_reference(x, gy), iters=2))
    return rec


def _bf16_fuse_bounds(B, D, Dp, T, C):
    """The bf16 K4f's and K4b's bounds, ``(ms, "bytes" or "operations")``
    each: K4f reads x, res, the parameters and writes out and z; K4b reads
    x, res, z, g and the weights and writes dx, dres and the float32
    parameter gradients; about 8C and 14C operations a row."""
    rows, res_rows = B * D * T, B * Dp * T
    return (_bound(2.0 * (2 * rows * C + res_rows * C + 4 * C + 2 + 2 * rows),
                   rows * (8.0 * C + 10)),
            _bound(2.0 * (3 * rows * C + 2 * res_rows * C + 2 * rows + 4 * C)
                   + 4.0 * (4 * C + 2), rows * (14.0 * C + 10)))


def _bf16_fuse_case(B, D, Dp, T, C, timed: bool, step: bool = False) -> dict:
    """The bf16 K4f and K4b against their plain bf16 versions at x [B, D, T,
    C] with the residual [B, Dp, T, C]: out by ``bf16_check`` with
    ``BLEND_REL`` of the blend's terms (one bf16 spacing of z carried
    through), z by one spacing, dx and dres with ``SUM_REL`` of their terms'
    magnitudes, the float32 parameter gradients by relative L2, two runs'
    bits; timed or a step shape: the kernels and the bound; timed: their
    plain versions too."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels import BLEND_REL, SUM_REL, bf16_check
    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
        attention_fuse_bwd,
        attention_fuse_bwd_reference,
        attention_fuse_fwd,
        attention_fuse_reference,
    )
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B * D + Dp + C + 7)
    x, res, wx, wy, bias, gy = (t.bfloat16() for t in (
        torch.randn(B, D, T, C, device="cuda", generator=g),
        torch.randn(B, Dp, T, C, device="cuda", generator=g),
        0.3 * torch.randn(C, 2, device="cuda", generator=g),
        0.3 * torch.randn(C, 2, device="cuda", generator=g),
        0.1 * torch.randn(2, device="cuda", generator=g),
        torch.randn(B, D, T, C, device="cuda", generator=g)))
    before = (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16)
    out, z = attention_fuse_fwd(x, res, wx, wy, bias)
    again_out, again_z = attention_fuse_fwd(x, res, wx, wy, bias)
    fwd_repeat = bool(torch.equal(out, again_out) and torch.equal(z, again_z))
    del again_out, again_z
    grads = attention_fuse_bwd(x, res, z, gy, wx, wy)
    again = attention_fuse_bwd(x, res, z, gy, wx, wy)
    bwd_repeat = all(bool(torch.equal(a, b)) for a, b in zip(grads, again))
    del again
    torch.cuda.synchronize()
    if (attention_fuse_fwd.launches_bf16, attention_fuse_bwd.launches_bf16) != (
            before[0] + 2, before[1] + 2):
        raise RuntimeError("the bf16 attention fuse kernels did not count their launches")
    with float32_math():
        rout, rz = attention_fuse_reference(x, res, wx, wy, bias)
        y = torch.repeat_interleave(res, D // Dp, dim=1)
        blend = x.float().abs() * rz[..., 0:1].float() + y.float().abs() * rz[..., 1:2].float()
        del y
        out_check = bf16_check(out, rout, blend, BLEND_REL)
        z_check = bf16_check(z, rz)
        del rout, rz, blend, out
        want = attention_fuse_bwd_reference(x, res, z, gy, wx, wy)
        scales = attention_fuse_bwd_reference(*(t.abs() for t in (x, res, z, gy, wx, wy)))
        map_checks = [bf16_check(a, b, c, SUM_REL) for a, b, c in zip(grads[:2], want[:2],
                                                                       scales[:2])]
        err_params = max(_rel_l2(a, b) for a, b in zip(grads[2:], want[2:]))
        del want, scales, grads
    rec = {"B": B, "D": D, "Dp": Dp, "T": T, "C": C, "out_check": out_check,
           "z_check": z_check, "dx_check": map_checks[0], "dres_check": map_checks[1],
           "fwd_max_abs_err": max(out_check["max_abs_err"], z_check["max_abs_err"]),
           "bwd_max_abs_err_dx_dres": max(c["max_abs_err"] for c in map_checks),
           "bwd_rel_l2_dwx_dwy_db": err_params, "fwd_bitwise_repeat": fwd_repeat,
           "bwd_bitwise_repeat": bwd_repeat, "params_tol": BF16_KERNEL_REL_L2,
           "within": all(c["within"] for c in [out_check, z_check] + map_checks)}
    if timed or step:
        fwd_bound, bwd_bound = _bf16_fuse_bounds(B, D, Dp, T, C)
        with float32_math():
            rec.update(
                fwd_ms=_time_ms(lambda: attention_fuse_fwd(x, res, wx, wy, bias), iters=10),
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                bwd_ms=_time_ms(lambda: attention_fuse_bwd(x, res, z, gy, wx, wy), iters=10),
                bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
            if timed:
                rec.update(
                    fwd_plain_ms=_time_ms(
                        lambda: attention_fuse_reference(x, res, wx, wy, bias), iters=3),
                    bwd_plain_ms=_time_ms(
                        lambda: attention_fuse_bwd_reference(x, res, z, gy, wx, wy), iters=3))
    return rec


def _bf16_conv_step_sums(conv: list) -> dict:
    """The bf16 K3f, its dx pass and K3w summed over the kernel-config step's
    launches (each conv of ``STEP_CONV_FWD`` a forward, a dx pass and a weight
    gradient): the kernels, cuDNN's bf16 and the bounds, from ``conv``'s
    timed records at each step shape."""
    def rec_of(D, C, O, dx):
        return next(r for r in conv if (r["B"], r["D"], r["T"], r["C"], r["O"]) == (
            TEACHER_BATCH, D, 483, C, O) and (r["pass"] == "dx") == dx and "fwd_ms" in r)

    sums = {}
    for name, pick in (("fwd", lambda D, C, O: (rec_of(D, C, O, False), "fwd")),
                       ("dx", lambda D, C, O: (rec_of(D, O, C, True), "fwd")),
                       ("wgrad", lambda D, C, O: (rec_of(D, C, O, False), "wgrad"))):
        parts = [pick(D, C, O) for D, C, O in STEP_CONV_FWD]
        sums[name] = {k: sum(r[f"{key}_{k}"] for r, key in parts)
                      for k in ("ms", "library_ms", "bound_ms")}
        sums[name]["launches"] = len(parts)
        sums[name]["routes"] = {route: sum(1 for r, key in parts if r[f"{key}_route"] == route)
                                for route in ("wgmma", "mma", "fma", "narrow")}
    return sums


def _bf16_fuse_step_sums(fuse: list) -> dict:
    """The bf16 K4f and K4b summed over the kernel-config step's launches
    (one of each for each D of ``STEP_FUSE_D``): the kernels and their bounds,
    from ``fuse``'s timed records at each step shape."""
    def rec_of(D):
        return next(r for r in fuse if (r["B"], r["D"], r["Dp"], r["T"], r["C"]) == (
            TEACHER_BATCH, D, D // 2, 483, 64) and "fwd_ms" in r)

    parts = [rec_of(D) for D in STEP_FUSE_D]
    return {key: {"ms": sum(r[f"{key}_ms"] for r in parts),
                  "bound_ms": sum(r[f"{key}_bound_ms"] for r in parts),
                  "launches": len(parts)} for key in ("fwd", "bwd")}


def phase_bf16_kernels_vs_plain():
    """Phase 17: the bf16 K3f (and its dx pass), K3w, K4f and K4b against
    their plain bf16 versions at phase 8's shapes and at each distinct conv
    and fuse shape of the kernel-config step (the conv's forward and dx),
    with times at the reference shapes and at each step shape (kernel,
    cuDNN's bf16 for the conv, bound, route; the step's sums by launches);
    every step shape with C and O >= 8 takes route "wgmma" (the weight
    gradient where O > 8)."""
    import torch

    conv, fuse = [], []
    step = {}
    for D, C, O in STEP_CONV_FWD:
        step.setdefault((TEACHER_BATCH, D, 483, C, O, False, False), None)
        step.setdefault((TEACHER_BATCH, D, 483, O, C, False, True), None)
    cases = [(*shape, False, False, False) for *shape, _ in CONV_CASES
             if tuple(shape) != CONV_REF]
    cases = ([(*CONV_REF, True, False, True), (*CONV_REF, False, True, True)] + cases
             + [(*c, True) for c in step if c[:5] != CONV_REF])
    for B, D, T, C, O, timed, dx, on_step in cases:
        rec = _bf16_conv_case(B, D, T, C, O, timed, dx, step=on_step)
        say("bf16_kernels_vs_plain", kernel="conv3x3_bf16", **rec)
        conv.append(rec)
        torch.cuda.empty_cache()
        if not (rec["fwd_check"]["within"] and rec["fwd_bitwise_repeat"]
                and rec["wgrad_rel_l2"] <= BF16_KERNEL_REL_L2 and rec["wgrad_bitwise_repeat"]):
            raise RuntimeError(f"the bf16 conv3x3 kernels disagree with their plain versions: "
                               f"{rec}")
        if on_step and min(C, O) >= 8 and (rec["fwd_route"] != "wgmma" or (
                O > 8 and not dx and rec["wgrad_route"] != "wgmma")):
            raise RuntimeError(f"a step shape off route wgmma: {rec}")
    sums = _bf16_conv_step_sums(conv)
    say("bf16_kernels_vs_plain", kernel="conv3x3_bf16", step_sums=sums)
    step_fuse = [(TEACHER_BATCH, D, D // 2, 483, 64) for D in dict.fromkeys(STEP_FUSE_D)]
    for *shape, timed, on_step in ([(*c, False) for c in FUSE_CASES]
                                   + [(*c, False, True) for c in step_fuse if c != FUSE_REF]):
        rec = _bf16_fuse_case(*shape, timed=timed, step=on_step)
        if tuple(shape) in step_fuse:
            rec["step_launches"] = STEP_FUSE_D.count(shape[1])
        say("bf16_kernels_vs_plain", kernel="attention_fuse_bf16", **rec)
        fuse.append(rec)
        torch.cuda.empty_cache()
        if not (rec["within"] and rec["bwd_rel_l2_dwx_dwy_db"] <= BF16_KERNEL_REL_L2
                and rec["fwd_bitwise_repeat"] and rec["bwd_bitwise_repeat"]):
            raise RuntimeError(f"the bf16 attention fuse kernels disagree with their plain "
                               f"versions: {rec}")
    fuse_sums = _bf16_fuse_step_sums(fuse)
    say("bf16_kernels_vs_plain", kernel="attention_fuse_bf16", step_sums=fuse_sums)
    return conv, fuse, sums, fuse_sums


def bf16_parity() -> dict:
    """The bf16 trainer's losses against the float32 trainer's over
    ``BF16_PARITY_STEPS`` steps from the same seed on one batch of speech
    (``CHECK_BATCH`` clips of ``TRAIN_SECONDS``): held to the JAX package's
    bounds, and the bf16 loss descends."""
    import numpy as np

    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    batch, seconds = CHECK_BATCH, TRAIN_SECONDS
    mix, clean = train_batch(batch, seconds)
    losses = {}
    for name, distill, models in (("float32", {}, {}), (BF16, BF16_DISTILL, bf16_models())):
        trainer = Trainer(train_config(batch, seconds, distill, **models),
                          device="cuda").init_state(0)
        losses[name] = [float(trainer.train_step(mix, clean)["train_loss"])
                        for _ in range(BF16_PARITY_STEPS)]
        del trainer
    f32, bf16 = np.array(losses["float32"]), np.array(losses[BF16])
    failures = []
    if not np.isfinite(bf16).all():
        failures.append("a bf16 loss is not finite")
    if not np.allclose(bf16, f32, rtol=PARITY_RTOL, atol=PARITY_ATOL):
        failures.append(f"bf16 losses {bf16.tolist()} against float32 {f32.tolist()}")
    if not bf16[-1] < bf16[0] + 1e-3:
        failures.append(f"bf16 losses do not descend: {bf16.tolist()}")
    return {"batch": batch, "seconds": seconds, "losses": losses,
            "max_rel_diff": float(np.max(np.abs(bf16 - f32) / np.abs(f32))),
            "rtol": PARITY_RTOL, "atol": PARITY_ATOL, "failures": failures}


def phase_training_bf16(phase7: dict) -> dict:
    """Phase 18: bf16 compute and taps (``bf16_models``, ``BF16_DISTILL``)
    as phase 7 at 32 x 3 s beside phase 7's step, with its card-vs-CPU step
    (the loss to ``BF16_LOSS_RTOL``, the gradients on white noise against
    their bf16 rounding floor) and the parity of its losses with float32
    over ``BF16_PARITY_STEPS`` steps; at bench.py's batch 64; and on the
    K3/K4 kernel path (launches per step: bf16 K3f 24, K3w 12, K4f 10, K4b
    10, K1f 8, K1b 4) with its own card-vs-CPU step."""
    models = bf16_models()
    lstm = {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}
    b32 = _training("training_bf16", "clskd bf16 (teacher/student compute_dtype and "
                    "distill.taps_dtype bfloat16)", BF16_DISTILL, KERNEL_TRAIN_STEPS, lstm,
                    rounding_floor=True, models=models,
                    beside=_beside("phase 7 (clskd, float32)", phase7))
    parity = bf16_parity()
    say("training_bf16_parity", **parity)
    if parity["failures"]:
        raise RuntimeError(f"bf16 losses do not track float32: {parity['failures']}")
    b64 = _training("training_bf16_batch64", "clskd bf16, batch 64 (bench.py's default)",
                    BF16_DISTILL, KERNEL_TRAIN_STEPS, lstm, batch=BF16_BATCH, models=models,
                    check=lambda: {"failures": [], "checked": "at batch 32 (training_bf16)"})
    kernels = _training("training_bf16_kernels", "clskd bf16 with abf_conv_pallas and "
                        "abf_attfuse_pallas", BF16_KERNEL_DISTILL, KERNEL_TRAIN_STEPS,
                        {**lstm, "conv3x3_fwd_bf16": 24, "conv3x3_wgrad_bf16": 12,
                         "attfuse_fwd_bf16": 10, "attfuse_bwd_bf16": 10},
                        rounding_floor=True, models=models,
                        beside=_beside("training_bf16", b32))
    return {"batch32": b32, "parity": parity, "batch64": b64, "kernels": kernels}


def phase_serving_teacher_bf16(phase5: dict) -> dict:
    """Phase 19: the teacher (``dccrn-cl``, seeded) computing in bf16,
    offline on 32 x 3 s as phase 5: real-time factor beside phase 5's, peak
    memory, K1f launches (4 a forward), the float32 waveform against the
    CPU's bf16 forward on one utterance."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model

    cfg = bf16_models()["teacher"]
    iters = 3
    wav = torch.from_numpy(teacher_batch()).cuda()
    model = make_model(cfg, device="cuda", seed=0)
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
        ref = make_model(cfg, device="cpu", seed=0)(wav[:1].cpu())
    err = (out.wav[:1].cpu() - ref.wav).abs().max().item()
    taps = list(out.taps.encoder) + list(out.taps.decoder) + [out.taps.lstm_real]
    finite = bool(torch.isfinite(out.wav).all()) and all(bool(torch.isfinite(t).all())
                                                         for t in taps)
    dtypes_ok = out.wav.dtype == torch.float32 and all(t.dtype == torch.bfloat16 for t in taps)
    rec = dict(config=f"{cfg.name} compute_dtype={cfg.compute_dtype}", batch=TEACHER_BATCH,
               seconds=TEACHER_SECONDS, forward_ms=wall * 1e3,
               rtf=wall / (TEACHER_BATCH * TEACHER_SECONDS), peak_mem_bytes=peak,
               lstm_launches=launches, max_abs_err_vs_cpu=err, tol=BF16_SERVING_ATOL,
               finite=finite, dtypes_ok=dtypes_ok,
               beside={"phase": "phase 5 (float32)", "forward_ms": phase5["forward_ms"],
                       "rtf": phase5["rtf"], "peak_mem_bytes": phase5["peak_mem_bytes"]})
    say("serving_teacher_bf16", **rec)
    if not (finite and dtypes_ok) or launches != 4 * iters or err > BF16_SERVING_ATOL:
        raise RuntimeError(f"the bf16 teacher forward on the card is wrong: {rec}")
    return rec


# bf16 K5 and K2 (phases 20-21): the block-config step on bf16 taps, its
# launches a step (K5f 24 under abf_remat, its forward recomputed in the
# backward), bench.py's --block-pallas --abf-remat --bn2-fold form at its
# batch 64, and the bf16 K5b's float32 sums of values rounded to bf16 inside
# the kernel (dw1a from bf16(g_xhat), dwxt and dwy from bf16(dp)), where a
# float32 value near a rounding midpoint rounds the other way on the two
# sides and moves its term by one bf16 spacing (2.4e-5 relative L2 on dw1a in
# the card tests, NVIDIA H100 80GB HBM3, 700 W)
BF16_BLOCK_DISTILL = dict(taps_dtype=BF16, **ABF_BLOCK_FLAGS)
BF16_BENCH_DISTILL = dict(BF16_BLOCK_DISTILL, abf_remat=True, spkd_bn2_fold=True)
BF16_ROUNDED_REL_L2 = 1e-4
BLOCK_ROUNDED = ("dw1a", "dwxt", "dwy")
# K2's bf16 shapes (B, Ds, Dt): the spkd strategy's 33 s waveforms at batch 32,
# at the gate's largest, 64, and at 16; a tail shape (Ds and Dt off multiples
# of 8 and of 2048: the wrapper pads them to whole 16-byte rows)
BF16_GRAM_CASES = [(TEACHER_BATCH, SPKD_SAMPLES, SPKD_SAMPLES),
                   (64, SPKD_SAMPLES, SPKD_SAMPLES), (16, SPKD_SAMPLES, SPKD_SAMPLES),
                   (TEACHER_BATCH, SPKD_SAMPLES + 3, 100003)]


def _bf16_block_inputs(fuse, B, D, k, T, Cs, M, O):
    """``_block_inputs`` as the bf16 path hands them to the kernel: the maps
    and w1a, wxt, wy, w2 in bf16, bvec and zoff float32."""
    import torch

    kw, gxf, gout = _block_inputs(fuse, B, D, k, T, Cs, M, O)
    kw = {n: t if t is None or n in ("bvec", "zoff") else t.to(torch.bfloat16)
          for n, t in kw.items()}
    return kw, gxf.to(torch.bfloat16), gout.to(torch.bfloat16)


def _bf16_block_bounds(fuse, B, D, k, T, Cs, M, O) -> dict:
    """The bf16 K5f's and K5b's bounds: the bytes of ``_block_bounds`` at 2
    bytes an element of every map and bf16 weight (bvec, zoff and the
    parameter gradients 4), and every operation a product of bf16 operands
    at the bf16 tensor-core peak."""
    rows, res_rows = B * D * T, (B * D * T // k if fuse else 0)
    w16 = Cs * M + 2 * Cs + 2 * M + 9 * M * O
    w32 = M + 2
    conv = rows * 18.0 * M * O
    fwd_ops = conv + rows * (2.0 * Cs * M + ((4 * Cs + 7 * M + 8) if fuse else M))
    bwd_ops = 2 * conv + rows * (6.0 * Cs * M + ((4 * Cs + 16 * M) if fuse else M))
    fwd_bytes = 2.0 * (rows * Cs + res_rows * M + w16 + rows * M + rows * O) + 4.0 * w32
    bwd_bytes = (2.0 * (2 * rows * Cs + 2 * res_rows * M + 2 * rows * M + rows * O + w16)
                 + 4.0 * (w32 + w16 + w32))
    return {"fwd": _bound_bf16(fwd_bytes, fwd_ops), "bwd": _bound_bf16(bwd_bytes, bwd_ops)}


# Phase 20's passes of the bf16 K5f and K5b, by the device kernels' names (a
# prefix after any namespace); the rest (w2's flip, copies) is "other"
K5_PASSES = {"fwd": (("abf_block_bf16_fwd_fused", "fused"), ("abf_block_bf16_xf", "xf"),
                     ("abf_block_xf", "xf"), ("abf_block_direct", "direct"),
                     ("abf_block_bf16_conv", "conv"), ("conv3x3_bf16_pack", "pack"),
                     ("conv3x3_bf16_fwd", "conv")),
             "bwd": (("abf_block_bf16_bwd", "pass"), ("abf_block_bwd_pass", "pass"),
                     ("conv3x3_bf16_pack", "adjoint"), ("conv3x3_bf16_fwd", "adjoint"),
                     ("conv3x3_bf16_wgrad", "dw2"), ("reduce_partials", "reductions"))}


def _k5_pass_of(kernel: str, key: str) -> str:
    """The phase-20 pass of the device kernel named ``kernel`` in the bf16
    K5f (``key`` "fwd") or K5b ("bwd")."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    name = name.split("::")[-1].split()[-1]
    return next((p for prefix, p in K5_PASSES[key] if name.startswith(prefix)), "other")


def _k5_pass_times(fn, key: str, iters: int = 5) -> dict:
    """The device ms a call of ``fn`` spends in each pass (``_k5_pass_of``),
    from the profiler's device events over ``iters`` calls after a warm-up.
    The profiler loses kernel records now and then (see ``gram_times``): a
    profile in which some kernel's records are not a whole multiple of the
    calls is taken again, up to ``PROFILE_ATTEMPTS`` times; if none is
    whole, each kernel's mean time is counted once for each of its launches
    a call, and ``"whole"`` is False."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        count, total = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count[e.name] = count.get(e.name, 0) + 1
                total[e.name] = total.get(e.name, 0.0) + e.time_range.end - e.time_range.start
        whole = bool(count) and all(c % iters == 0 for c in count.values())
        if best is None or whole or sum(count.values()) > sum(best[0].values()):
            best = (count, total, whole)
        if whole:
            break
    count, total, whole = best
    if not count:
        raise RuntimeError("the profiler recorded no device events for the bf16 K5")
    out = {"whole": whole}
    for name, us in total.items():
        p = _k5_pass_of(name, key)
        per_call = us / 1e3 / iters if whole else us / 1e3 / count[name] * math.ceil(
            count[name] / iters)
        out[p] = out.get(p, 0.0) + per_call
    return out


# csrc/abf_block_bf16.cu's K5f forms xf and convolves it in one kernel up
# to this many output channels (kFfMaxO), in two passes above
K5F_FUSED_MAX_O = 64


def _bf16_block_pass_bounds(fuse, B, D, k, T, Cs, M, O) -> dict:
    """Each pass's bytes bound (ms) on route "fused" as the shape takes it:
    every map the pass must read once and write once, 2 bytes an element
    (dw2 4).  K5f: for 8 <= O <= ``K5F_FUSED_MAX_O`` one kernel ("fused":
    tap, res, w2 -> xf, out), else the xf pass (tap, res -> xf) and the conv
    (xf, w2 -> out).  K5b: the pass (tap, res, g_xf, g_out -> g_tap, g_res)
    and dw2 (xf, g_out -> dw2); on the narrow route (the mask block, O < 8)
    dw2 is folded into the pass, which also reads xf and writes dw2, and has
    no pass of its own."""
    rows, res_rows = B * D * T, (B * D * T // k if fuse else 0)
    ms = lambda nbytes: nbytes / PEAK_BYTES_S * 1e3  # noqa: E731
    xf_in = rows * Cs + res_rows * M
    pass_b = 2.0 * (2 * rows * Cs + 2 * res_rows * M + rows * M + rows * O)
    dw2_b = 2.0 * (rows * M + rows * O) + 4.0 * 9 * M * O
    if 8 <= O <= K5F_FUSED_MAX_O:
        fwd = {"fused": ms(2.0 * (xf_in + rows * M + rows * O + 9 * M * O))}
    else:
        fwd = {"xf": ms(2.0 * (xf_in + rows * M)), "conv": ms(2.0 * (rows * M + rows * O
                                                                  + 9 * M * O))}
    if O < 8:
        bwd = {"pass": ms(pass_b + 2.0 * rows * M + 4.0 * 9 * M * O)}
    else:
        bwd = {"pass": ms(pass_b), "dw2": ms(dw2_b)}
    return {"fwd": fwd, "bwd": bwd}


def _bf16_block_step_sums(steps: list) -> dict:
    """The bf16 K5f and K5b summed over the block-config step's blocks
    (``STEP_BLOCKS``, each distinct shape weighted by its blocks): the
    kernels' times, their bounds, each pass's time and bytes bound, and the
    routes by launches, from ``steps``' records at each step shape."""
    def rec_of(fuse, D, Cs, O):
        return next(r for r in steps if (r["fuse"], r["D"], r["Cs"], r["O"]) == (fuse, D, Cs, O)
                    and "fwd_passes" in r)

    parts = [rec_of(*shape) for shape in STEP_BLOCKS]
    sums = {}
    for key in ("fwd", "bwd"):
        names = sorted({p for r in parts for p in r[f"{key}_passes"] if p != "whole"})
        sums[key] = {"ms": sum(r[f"{key}_ms"] for r in parts),
                     "bound_ms": sum(r[f"{key}_bound_ms"] for r in parts),
                     "launches": len(parts),
                     "passes_ms": {p: sum(r[f"{key}_passes"].get(p, 0.0) for r in parts)
                                   for p in names},
                     "pass_bounds_ms": {p: sum(r[f"{key}_pass_bounds"].get(p, 0.0)
                                               for r in parts)
                                        for p in sorted({p for r in parts
                                                         for p in r[f"{key}_pass_bounds"]})},
                     "routes": {route: sum(1 for r in parts if r[f"{key}_route"] == route)
                                for route in ("fused", "wgmma", "mma", "direct")}}
    return sums


def _bf16_block_case(fuse, B, D, k, T, Cs, M, O, timed: bool, unaligned: bool = False) -> dict:
    """The bf16 K5f and K5b against their plain bf16 versions on the same
    inputs (the backward on the kernel's own xf): xf, g_tap and g_res by
    ``bf16_check`` with ``abf_block_bf16_scales``, out against the plain conv
    on the kernel's own xf; the float32 parameter gradients by relative L2
    (``BLOCK_ROUNDED`` to ``BF16_ROUNDED_REL_L2``, the others to
    ``BF16_KERNEL_REL_L2``); two runs' bits; the kernels' times, each pass's
    (route "fused") and timed: the plain versions' and the bound.
    ``unaligned``: the tap one element into its buffer (off the 16 bytes TMA
    needs), which sends both kernels to the earlier routes."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels import bf16_check
    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
        abf_block_bf16_scales,
        abf_block_bwd,
        abf_block_bwd_reference,
        abf_block_bwd_route,
        abf_block_fwd,
        abf_block_fwd_route,
        abf_block_reference,
    )
    from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    kw, gxf, gout = _bf16_block_inputs(fuse, B, D, k, T, Cs, M, O)
    if unaligned:
        buf = torch.empty(kw["tap"].numel() + 1, device="cuda", dtype=torch.bfloat16)
        kw["tap"] = buf[1:].view(kw["tap"].shape).copy_(kw["tap"])
    before = (abf_block_fwd.launches_bf16, abf_block_bwd.launches_bf16)
    xf, out = abf_block_fwd(**kw)
    xf_again, out_again = abf_block_fwd(**kw)
    fwd_repeat = bool(torch.equal(xf, xf_again)) and bool(torch.equal(out, out_again))
    del xf_again, out_again
    grads = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    again = abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout)
    bwd_repeat = all(a is None or bool(torch.equal(a, b)) for a, b in zip(grads, again))
    del again
    torch.cuda.synchronize()
    if (abf_block_fwd.launches_bf16, abf_block_bwd.launches_bf16) != (before[0] + 2,
                                                                     before[1] + 2):
        raise RuntimeError("the bf16 abf_block kernels did not count their launches")
    names = ("g_tap", "g_res", "dw1a", "dbvec", "dwxt", "dwy", "dzoff", "dw2")
    with float32_math():
        scales = abf_block_bf16_scales(**kw, xf=xf, gxf=gxf, gout=gout)
        checks = {"xf": bf16_check(xf, abf_block_reference(**kw)[0], *scales["xf"]),
                  "out": bf16_check(out, conv3x3_reference(xf, kw["w2"]), *scales["out"])}
        want = abf_block_bwd_reference(**kw, xf=xf, gxf=gxf, gout=gout)
        for n, a, b in zip(names[:2], grads, want):
            if b is not None:
                checks[n] = bf16_check(a, b, *scales[n])
        del scales
        rel = {n: _rel_l2(a, b) for n, a, b in zip(names[2:], grads[2:], want[2:])
               if b is not None}
    del want, grads
    tols = {n: BF16_ROUNDED_REL_L2 if n in BLOCK_ROUNDED else BF16_KERNEL_REL_L2 for n in rel}
    route_of = dict(Cs=Cs, D=D, k=k, fuse=fuse, aligned=not unaligned)
    rec = {"fuse": fuse, "B": B, "D": D, "k": k, "T": T, "Cs": Cs, "M": M, "O": O,
           "unaligned": unaligned,
           "fwd_route": abf_block_fwd_route(M, O, torch.bfloat16, **route_of),
           "bwd_route": abf_block_bwd_route(M, O, torch.bfloat16, **route_of),
           "routes_taken": {"fwd": abf_block_fwd.route, "bwd": abf_block_bwd.route},
           "checks": checks, "fwd_max_abs_err": max(checks[n]["max_abs_err"] for n in ("xf", "out")),
           "bwd_max_abs_err_g_tap_g_res": max(c["max_abs_err"] for n, c in checks.items()
                                              if n.startswith("g_")),
           "bwd_rel_l2": rel, "bwd_tol": tols, "fwd_bitwise_repeat": fwd_repeat,
           "bwd_bitwise_repeat": bwd_repeat,
           "within": all(c["within"] for c in checks.values())
           and all(rel[n] <= tols[n] for n in rel)}
    bounds = _bf16_block_bounds(fuse, B, D, k, T, Cs, M, O)
    with float32_math():
        rec.update(fwd_ms=_time_ms(lambda: abf_block_fwd(**kw), iters=5),
                   bwd_ms=_time_ms(lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout),
                                   iters=5),
                   fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
                   bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1])
        if not unaligned:
            passes = _bf16_block_pass_bounds(fuse, B, D, k, T, Cs, M, O)
            rec.update(fwd_passes=_k5_pass_times(lambda: abf_block_fwd(**kw), "fwd"),
                       bwd_passes=_k5_pass_times(
                           lambda: abf_block_bwd(**kw, xf=xf, gxf=gxf, gout=gout), "bwd"),
                       fwd_pass_bounds=passes["fwd"], bwd_pass_bounds=passes["bwd"])
        if timed:
            rec.update(
                fwd_plain_ms=_time_ms(lambda: abf_block_reference(**kw), iters=2),
                bwd_plain_ms=_time_ms(lambda: abf_block_bwd_reference(
                    **kw, xf=xf, gxf=gxf, gout=gout), iters=2))
    return rec


def _bf16_gram_case(B: int, ds: int, dt: int) -> dict:
    """The bf16 K2 against its plain version on bf16 s [B, ds] and t [B, dt]:
    each float32 Gram by relative L2 (``BF16_KERNEL_REL_L2``), both sides'
    distance from the float64 Gram beside it, two runs' bits, symmetry;
    times as phase 12's (``gram_times``: both passes, and each apart), the
    plain version's, the bound and its share of the time, and cuBLAS's bf16
    product with a float32 result where this torch has one
    (``torch.mm(..., out_dtype=torch.float32)``)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair_fwd, gram_pair_reference
    from speech_enhancement_clskd_tpu_torch.utils.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(B + ds + dt)
    s = (0.3 * torch.randn(B, ds, device="cuda", generator=g)).clamp(-1, 1).bfloat16()
    t = (0.3 * torch.randn(B, dt, device="cuda", generator=g)).clamp(-1, 1).bfloat16()
    before = gram_pair_fwd.launches_bf16
    got = gram_pair_fwd(s, t)
    again = gram_pair_fwd(s, t)
    torch.cuda.synchronize()
    if gram_pair_fwd.launches_bf16 != before + 2:
        raise RuntimeError("the bf16 gram_pair_fwd did not count its launches")
    with float32_math():
        want = gram_pair_reference(s, t)
        exact = [(z.double() @ z.double().T) for z in (s, t)]

    def rel(pair, truth):
        return max(((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
                   for a, b in zip(pair, truth))

    rec = {"B": B, "Ds": ds, "Dt": dt, "dtype": BF16,
           "rel_l2": max(_rel_l2(a, b) for a, b in zip(got, want)),
           "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got, want)),
           "max_rel_err": rel(got, want), "rel_err_f64": rel(got, exact),
           "plain_rel_err_f64": rel(want, exact), "tol": BF16_KERNEL_REL_L2,
           "bitwise_repeat": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
           "symmetric": all(bool(torch.equal(a, a.T)) for a in got)}
    del exact, want
    nbytes = 2 * B * (ds + dt)
    # the upper triangles' B (B + 1) / 2 multiply-adds a column, bf16 products
    bound_ms, bound_by = _bound_bf16(nbytes, 1.0 * B * (B + 1) * (ds + dt))
    flush = _flusher(nbytes)
    try:
        torch.mm(s, s.T, out_dtype=torch.float32)
        library = lambda: (torch.mm(s, s.T, out_dtype=torch.float32),  # noqa: E731
                           torch.mm(t, t.T, out_dtype=torch.float32))
    except (TypeError, RuntimeError) as e:  # no out_dtype here: no one-call yardstick
        library, rec["library_note"] = None, f"torch.mm has no out_dtype here: {e}"
    with float32_math():
        rec.update(plain_ms=_event_ms(lambda: gram_pair_reference(s, t), 3, flush),
                   library_ms=None if library is None else _event_ms(library, 20, flush))
    rec.update(gram_times(lambda: gram_pair_fwd(s, t), nbytes), bound_ms=bound_ms,
               bound_by=bound_by)
    rec["bound_share"] = bound_ms / rec["ms"]
    return rec


def _bf16_spkd_entry() -> dict:
    """K2's bf16 entry path: ``losses.kd.spkd_loss`` on bf16 ``[B, D]``
    inputs with D >= 2^19 (the spkd strategy's 33 s waveforms at batch 32),
    routed by the JAX auto gate, forward and backward, the counters zeroed
    just before and read just after (no training step hands K2 bf16: the
    waveforms stay float32 under bf16 compute)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.losses.kd import spkd_loss

    counters = _kernel_counters()
    g = torch.Generator(device="cuda").manual_seed(21)
    s = (0.3 * torch.randn(TEACHER_BATCH, SPKD_SAMPLES, device="cuda", generator=g)).bfloat16()
    t = (0.3 * torch.randn(TEACHER_BATCH, SPKD_SAMPLES, device="cuda", generator=g)).bfloat16()
    s.requires_grad_(True)
    _zero_counts(counters)
    loss = spkd_loss(s, t)
    loss.backward()
    torch.cuda.synchronize()
    launches = _counts(counters)
    rec = {"entry": "losses.kd.spkd_loss (auto gate)", "B": TEACHER_BATCH, "D": SPKD_SAMPLES,
           "loss": float(loss), "loss_dtype": str(loss.dtype), "grad_dtype": str(s.grad.dtype),
           "finite": bool(torch.isfinite(loss)) and bool(torch.isfinite(s.grad.float()).all()),
           "launches": launches}
    want = {name: 1 if name == "gram_pair_fwd_bf16" else 0 for name in counters}
    if launches != want or not rec["finite"] or s.grad.dtype != torch.bfloat16:
        raise RuntimeError(f"spkd_loss on bf16 did not take the bf16 K2: {rec}")
    return rec


# Phase 20's blocks off route "fused": a tap one element into its buffer
# sends the reference block to the earlier "wgmma" routes and the mask block
# to the earlier "direct" kernels, which are held to their plain versions too
OFF_ROUTE_BLOCKS = [(BLOCK_REF, "wgmma"),
                    ((True, TEACHER_BATCH, 256, 2, 483, 2, 64, 2), "direct")]


def phase_bf16_block_kernels_vs_plain() -> dict:
    """Phase 20: the bf16 K5f and K5b against their plain bf16 versions at
    the reference block (timed, with plain times and the bound) and at each
    distinct block shape of the block-config step (the mask block among
    them), their kernel times summed by blocks a step, and on the earlier
    routes (``OFF_ROUTE_BLOCKS``); the bf16 K2 at B = 32 and 64 x 528,000;
    and K2's bf16 entry path (``_bf16_spkd_entry``)."""
    import torch

    ref = _bf16_block_case(*BLOCK_REF, timed=True)
    say("bf16_block_kernels_vs_plain", reference=True, **ref)
    cases = [ref]
    steps = []
    for fuse, D, Cs, O in dict.fromkeys(STEP_BLOCKS):
        rec = _bf16_block_case(fuse, TEACHER_BATCH, D, 2 if fuse else 1, 483, Cs, 64, O,
                               timed=False)
        rec["count"] = STEP_BLOCKS.count((fuse, D, Cs, O))
        say("bf16_block_kernels_vs_plain", step_shape=True, **rec)
        cases.append(rec)
        steps.append(rec)
        torch.cuda.empty_cache()
    off_route = []
    for shape, route in OFF_ROUTE_BLOCKS:
        rec = _bf16_block_case(*shape, timed=False, unaligned=True)
        say("bf16_block_kernels_vs_plain", off_route=True, **rec)
        off_route.append(rec)
        torch.cuda.empty_cache()
        if (rec["fwd_route"], rec["bwd_route"]) != (route, route) or rec["routes_taken"] != {
                "fwd": route, "bwd": route}:
            raise RuntimeError(f"an unaligned block off the route {route}: {rec}")
    for rec in cases:
        # every block of the step (the mask block too) on route "fused"
        if (rec["fwd_route"], rec["bwd_route"]) != ("fused", "fused") or rec["routes_taken"] != {
                "fwd": "fused", "bwd": "fused"}:
            raise RuntimeError(f"a block shape of the step off route fused: {rec}")
    cases += off_route
    for rec in cases:
        if not (rec["within"] and rec["fwd_bitwise_repeat"] and rec["bwd_bitwise_repeat"]):
            raise RuntimeError(f"the bf16 abf_block kernels disagree with their plain versions: "
                               f"{rec}")
    per_step = {key: sum(r["count"] * r[key] for r in steps) for key in ("fwd_ms", "bwd_ms")}
    detail = _bf16_block_step_sums(steps)
    say("bf16_block_kernels_vs_plain", step_sums_ms=per_step, blocks_a_step=len(STEP_BLOCKS),
        step_sums=detail)
    grams = []
    for shape in BF16_GRAM_CASES:
        rec = _bf16_gram_case(*shape)
        say("bf16_gram_vs_plain", **rec)
        grams.append(rec)
        torch.cuda.empty_cache()
        if not (rec["rel_l2"] <= BF16_KERNEL_REL_L2 and rec["bitwise_repeat"]
                and rec["symmetric"]):
            raise RuntimeError(f"the bf16 gram_pair_fwd disagrees with its plain version: {rec}")
    entry = _bf16_spkd_entry()
    say("bf16_gram_entry", **entry)
    return {"blocks": cases, "block_steps": steps, "block_step_sums": per_step,
            "block_step_detail": detail, "grams": grams, "gram_entry": entry}


def phase_training_bf16_block(bf16_phase: dict, block: dict) -> dict:
    """Phase 21: the block-config step on bf16 (``BF16_BLOCK_DISTILL``,
    ``bf16_models``) at 32 x 3 s as phase 18 (launches per step: bf16 K5f
    12, K5b 12, K1f 8, K1b 4) with its card-vs-CPU step (phase 18's bf16
    holds), beside phase 18's bf16 default step and phase 11's float32 block
    step; then ``bench.py``'s batch 64 with ``abf_remat`` and
    ``spkd_bn2_fold`` (K5f 24)."""
    models = bf16_models()
    lstm = {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}
    b32 = _training("training_bf16_block", "clskd bf16 with abf_block_pallas",
                    BF16_BLOCK_DISTILL, KERNEL_TRAIN_STEPS,
                    {**lstm, "abf_block_fwd_bf16": 12, "abf_block_bwd_bf16": 12},
                    rounding_floor=True, models=models,
                    beside={"phase 18 (clskd bf16)": _beside("training_bf16", bf16_phase),
                            "phase 11 (abf_block_pallas, float32)": _beside("training_block",
                                                                            block)})
    b64 = _training("training_bf16_block_bench", "clskd bf16 with abf_block_pallas, abf_remat "
                    "and spkd_bn2_fold, batch 64 (bench.py --block-pallas --abf-remat "
                    "--bn2-fold)", BF16_BENCH_DISTILL, KERNEL_TRAIN_STEPS,
                    {**lstm, "abf_block_fwd_bf16": 24, "abf_block_bwd_bf16": 12},
                    batch=BF16_BATCH, models=models,
                    check=lambda: {"failures": [], "checked": "the block path at batch 32 "
                                   "(training_bf16_block); remat and the fold bit for bit on "
                                   "the CPU (tests)"})
    return {"batch32": b32, "bench": b64}


# ------------------------------------------------------------ evaluation


def _eval_errors(got: dict, want: dict) -> dict:
    """The largest |got - want| by metric kind (``stoi``, ``db`` for SI-SDR,
    SDR, SIR and SAR, ``pesq``) over the keys both carry, and whether the
    two carry the same keys with the same infinities."""
    import math

    errs = {"stoi": 0.0, "db": 0.0, "pesq": 0.0}
    same = set(got) == set(want)
    for key, w in want.items():
        g = got.get(key)
        if not isinstance(w, float) or not isinstance(g, float):
            same = same and g == w
            continue
        if math.isinf(w) or math.isinf(g):
            same = same and g == w
            continue
        kind = "stoi" if key.endswith("stoi") else "pesq" if key.endswith("pesq") else "db"
        errs[kind] = max(errs[kind], abs(g - w))
    return {"same_keys": same, **errs}


def _eval_within(errs: dict) -> bool:
    return (errs["same_keys"] and errs["stoi"] <= EVAL_STOI_ATOL and errs["db"] <= EVAL_DB_ATOL
            and errs["pesq"] <= EVAL_PESQ_ATOL)


def evaluation_checks(cfg, variables, dataset, device: str, directory: str,
                      bn_batch_stats=None, compute_pesq: bool = True) -> dict:
    """``eval.evaluate_model`` of ``(cfg, variables)`` over ``dataset`` on
    ``device`` and on the CPU, each writing its summary, per-utterance rows
    and example wavs under ``directory``: the record of phase 22, with
    ``failures`` listing what did not hold (the summary and every row card
    against CPU; the wavs read back whole, finite and alike; on the card K1f
    4 a forward and no other kernel).  tests/test_torch_eval.py rehearses it
    at tiny widths on the CPU."""
    import numpy as np

    from speech_enhancement_clskd_tpu_torch.data.wav import read_wav
    from speech_enhancement_clskd_tpu_torch.eval import evaluate_model

    counters = _kernel_counters()
    runs = {}
    for label, dev in (("device", device), ("cpu", "cpu")):
        out = Path(directory) / label
        timings = {}
        _zero_counts(counters)
        t0 = time.perf_counter()
        summary = evaluate_model(
            cfg, variables, dataset, sample_rate=cfg.stft.sample_rate,
            n_save_ex=len(dataset), ex_save_dir=str(out / "examples"),
            results_path=str(out / "summary.json"), per_utt_path=str(out / "per_utt.jsonl"),
            compute_pesq=compute_pesq, bn_batch_stats=bn_batch_stats, device=dev,
            timings=timings, log_fn=lambda *_: None)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _counts(counters).items() if v}
        rows = [json.loads(line) for line in (out / "per_utt.jsonl").read_text().splitlines()]
        wavs = {str(f.relative_to(out / "examples")): read_wav(str(f))
                for f in sorted((out / "examples").rglob("*.wav"))}
        runs[label] = dict(summary=summary, rows=rows, wavs=wavs, wall=wall,
                           timings=timings, launches=launches,
                           written=json.loads((out / "summary.json").read_text()))
    run, cpu = runs["device"], runs["cpu"]
    failures = []
    n = len(dataset)
    audio_s = sum(len(item[0]) for item in dataset) / cfg.stft.sample_rate
    summary_err = _eval_errors(run["summary"], cpu["summary"])
    row_errs = [_eval_errors(g, w) for g, w in zip(run["rows"], cpu["rows"])]
    row_err = {k: (all(e[k] for e in row_errs) if k == "same_keys"
                   else max(e[k] for e in row_errs)) for k in summary_err}
    if not _eval_within(summary_err):
        failures.append(f"summary card vs CPU {summary_err}")
    if len(run["rows"]) != n or not _eval_within(row_err):
        failures.append(f"per-utterance rows card vs CPU {row_err}")
    if [r["utt_id"] for r in run["rows"]] != [str(item[2]) for item in dataset]:
        failures.append("per-utterance ids")
    if run["written"] != run["summary"]:
        failures.append("the summary file differs from the returned summary")
    finite = all(np.isfinite(v) for r in run["rows"] for k, v in r.items()
                 if k != "utt_id" and not k.endswith("sir"))
    if not finite:
        failures.append("a metric is not finite")
    # the example wavs: every utterance's mixture, source and estimate, whole
    wav_err, whole = 0.0, set(run["wavs"]) == set(cpu["wavs"]) and len(run["wavs"]) == 3 * n
    for name, (x, rate) in run["wavs"].items():
        idx = int(name.split("/")[0].split("_")[1])
        whole = whole and rate == cfg.stft.sample_rate and x.shape == (len(dataset[idx][0]),)
        if name in cpu["wavs"]:
            diff = float(np.abs(x - cpu["wavs"][name][0]).max())
            if name.endswith("estimate.wav"):
                wav_err = max(wav_err, diff)
            elif diff != 0.0:
                whole = False
    if not whole or wav_err > EVAL_WAV_ATOL:
        failures.append(f"example wavs (whole and alike: {whole}, estimate {wav_err})")
    fwd = run["launches"].get("lstm_seq_fwd", 0)
    if device == "cuda" and (run["launches"] != {"lstm_seq_fwd": 4 * n}):
        failures.append(f"kernel launches {run['launches']}, expected K1f {4 * n}")
    return dict(
        config=cfg.name, utterances=n, audio_s=audio_s, bn_batch_stats=bn_batch_stats,
        pesq=compute_pesq, summary=run["summary"], lstm_launches=fwd,
        launches=run["launches"], wall_s=run["wall"], audio_s_per_s=audio_s / run["wall"],
        ms_per_utterance={k: 1e3 * v / n for k, v in run["timings"].items()},
        cpu_wall_s=cpu["wall"], summary_err=summary_err, row_err=row_err,
        estimate_wav_max_abs_diff=wav_err, wavs_read_back=len(run["wavs"]),
        tol={"stoi": EVAL_STOI_ATOL, "db": EVAL_DB_ATOL, "pesq": EVAL_PESQ_ATOL,
             "estimate_wav": EVAL_WAV_ATOL},
        failures=failures)


def phase_evaluation() -> dict:
    """Phase 22: ``evaluation_checks`` on the card for the r4 bundle over
    phase 4's requests, with the running statistics and then with
    ``bn_batch_stats=True``; a first pass over the requests builds the PESQ
    library and warms the path at each length."""
    import tempfile

    from speech_enhancement_clskd_tpu_torch.eval import evaluate_model
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    cfg, variables, _ = load_bundle(str(BUNDLE))
    data = eval_requests()
    recs = {}
    with tempfile.TemporaryDirectory() as directory:
        evaluate_model(cfg, variables, data, device="cuda", log_fn=lambda *_: None)
        for key, bn in (("running_stats", None), ("bn_batch_stats", True)):
            recs[key] = evaluation_checks(cfg, variables, data, "cuda",
                                          str(Path(directory) / key), bn_batch_stats=bn)
            say("evaluation", bundle=str(BUNDLE.relative_to(ROOT)), **recs[key])
    failed = {k: r["failures"] for k, r in recs.items() if r["failures"]}
    if failed:
        raise RuntimeError(f"the evaluation phase failed: {failed}")
    return recs


# -------------------------------------------------- the asteroid family


def write_asteroid_pth(path: str, architecture: str, seed: int = 0) -> str:
    """Write a seeded asteroid publishable bundle (``torch.save``) of
    ``architecture`` to ``path``: every masker tensor that
    ``models.dccrnet.params_from_asteroid_state_dict`` reads, the BN
    counters, ``encoder.filterbank._filters``, ``model_name``,
    ``model_args`` and ``infos`` (with the ``TorchVersion`` a real bundle
    carries), in the layouts of the reference's ``DCCRNet_mini``."""
    from collections import OrderedDict

    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.models.dccrnet import (
        ARCHITECTURES,
        asteroid_filterbank,
    )

    geom = ARCHITECTURES[architecture]
    kn, H, ks = geom["kernel_num"], geom["rnn_units"] // 2, 5
    rng = np.random.default_rng(seed)
    sd = OrderedDict()

    def put(key, shape, kind):
        if kind == "conv":
            a = rng.normal(0.0, 0.05, shape)
        elif kind == "uniform":
            a = rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[-1])
        elif kind == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif kind == "prelu":
            a = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))

    def parts(pre, leaf, shape, kind):
        for m in ("re_module", "im_module"):
            put(f"{pre}.{m}.{leaf}", shape, kind)

    def bn_prelu(pre, c):
        for leaf, kind in (("weight", "scale"), ("bias", "small"), ("running_mean", "small"),
                           ("running_var", "var")):
            parts(f"{pre}.norm", leaf, (c,), kind)
        for m in ("re_module", "im_module"):
            sd[f"{pre}.norm.{m}.num_batches_tracked"] = torch.tensor(1000 + seed)
        parts(f"{pre}.activation", "weight", (1,), "prelu")

    n, D = len(kn), 256
    chans = (2,) + tuple(kn)
    for i in range(n):
        parts(f"masker.encoders.{i}.conv", "weight", (kn[i] // 2, chans[i] // 2, ks, 2), "conv")
        bn_prelu(f"masker.encoders.{i}", kn[i] // 2)
        D = (D - 1) // 2 + 1
    feat = kn[-1] // 2 * D
    for li in range(2):
        pre = f"masker.encoders.{n}.rnn.rnns.{li}"
        parts(pre, "rnn.weight_ih_l0", (4 * H, feat if li == 0 else H), "uniform")
        parts(pre, "rnn.weight_hh_l0", (4 * H, H), "uniform")
        parts(pre, "rnn.bias_ih_l0", (4 * H,), "small")
        parts(pre, "rnn.bias_hh_l0", (4 * H,), "small")
    parts(f"masker.encoders.{n}.linear", "weight", (feat, H), "uniform")
    parts(f"masker.encoders.{n}.linear", "bias", (feat,), "small")
    for i in range(1, n):
        parts(f"masker.decoders.{i}.deconv", "weight", (kn[n - i], kn[n - 1 - i] // 2, ks, 2),
              "conv")
        bn_prelu(f"masker.decoders.{i}", kn[n - 1 - i] // 2)
    parts("masker.output_layer.0", "weight", (kn[0], 1, ks, 2), "conv")
    parts("masker.output_layer.0", "bias", (1,), "small")
    fb = torch.from_numpy(np.ascontiguousarray(asteroid_filterbank().T[:, None, :]))
    sd["encoder.filterbank._filters"] = fb
    sd["decoder.filterbank._filters"] = fb.clone()
    torch.save({
        "model_name": "DCCRNet_mini" if architecture != "DCCRN-CL" else "DCCRNet",
        "model_args": {"architecture": architecture, "stft_n_filters": 512,
                       "stft_kernel_size": 400, "stft_stride": 100, "sample_rate": 16000,
                       "n_src": 1, "masking_mode": "C"},
        "state_dict": sd,
        "infos": {"software_versions": {"torch_version": torch.__version__},
                  "seed": seed},
    }, path)
    return path


def asteroid_cli_checks(pth: str, directory: str, device: str,
                        overrides=ASTEROID_CLI_OVERRIDES) -> dict:
    """The CLI on an asteroid ``.pth``: ``import-torch`` to an ``.npz``, then
    ``evaluate --reference-bn --device <device>`` on the ``.pth`` and twice
    on the ``.npz`` over the synthetic test set of ``overrides``; the
    ``.pth`` and the first ``.npz`` run must agree as phase 22's card and
    CPU do.  ``bit_equal`` says whether they agree bit for bit, and
    ``repeat_bit_equal`` whether the two ``.npz`` runs do (the device's own
    repeatability).  The record, with ``failures``."""
    import contextlib
    import io

    from speech_enhancement_clskd_tpu_torch.cli import main as cli
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    counters = _kernel_counters()
    out = Path(directory)
    npz = str(out / "imported.npz")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc_import = cli(["import-torch", "--pth", pth, "--out", npz])
    results, rcs, rows, launches = {}, [rc_import], {}, 0
    for label, bundle in (("pth", pth), ("npz", npz), ("npz_repeat", npz)):
        _zero_counts(counters)
        with contextlib.redirect_stdout(log):
            rcs.append(cli(["evaluate", "--bundle", bundle, "--device", device,
                            "--reference-bn", "--results", str(out / f"{label}.json"),
                            *overrides]))
        launches += counters["lstm_seq_fwd"][0].launches
        results[label] = json.loads((out / f"{label}.json").read_text())
        rows[label] = [json.loads(line) for line in
                       (out / f"{label}_per_utt.jsonl").read_text().splitlines()]
    cfg, _, meta = load_bundle(npz)
    err = _eval_errors(results["pth"], results["npz"])
    row_errs = [_eval_errors(g, w) for g, w in zip(rows["pth"], rows["npz"])]
    failures = []
    if rcs != [0] * 4:
        failures.append(f"exit codes {rcs}")
    if cfg.family != "dccrnet" or meta["model_args"]["architecture"] != cfg.name:
        failures.append(f"imported bundle config {cfg}")
    if not _eval_within(err) or not all(_eval_within(e) for e in row_errs):
        failures.append(f".pth against .npz {err}")
    if not rows["pth"] or len(rows["pth"]) != len(rows["npz"]):
        failures.append("per-utterance rows")
    return dict(architecture=cfg.name, summary=results["pth"], summary_err=err,
                bit_equal=results["pth"] == results["npz"] and rows["pth"] == rows["npz"],
                repeat_bit_equal=(results["npz"] == results["npz_repeat"]
                                  and rows["npz"] == rows["npz_repeat"]),
                utterances=len(rows["pth"]), lstm_launches=launches, failures=failures)


def phase_asteroid(directory: str) -> dict:
    """Phase 23: the asteroid DCCRNet family from seeded ``.pth`` bundles
    written into ``directory`` (phase 24 trains from the teacher's): the
    ``DCCRN-CL`` teacher offline, the ``DCCRN-CL-test`` student streaming,
    and the CLI's ``import-torch`` and ``evaluate``."""
    import torch

    from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
    from speech_enhancement_clskd_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_fwd_plan
    from speech_enhancement_clskd_tpu_torch.models.dccrnet import (
        load_reference_bundle,
        read_reference_bundle,
    )
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax

    teacher_pth = write_asteroid_pth(str(Path(directory) / "dccrn_cl.pth"),
                                     ASTEROID_TEACHER, seed=0)
    student_pth = write_asteroid_pth(str(Path(directory) / "dccrn_cl_test.pth"),
                                     ASTEROID_STUDENT, seed=1)

    # the teacher offline at full width, as phase 5
    batch, seconds, iters = TEACHER_BATCH, TEACHER_SECONDS, 3
    wav = torch.from_numpy(teacher_batch()).cuda()
    model, _ = load_reference_bundle(teacher_pth, device="cuda")
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
        t_launches = lstm_seq.launches
        peak = torch.cuda.max_memory_allocated()
        cpu_model, _ = load_reference_bundle(teacher_pth, device="cpu")
        ref = cpu_model(wav[:1].cpu())
    T = out.taps.lstm_real.shape[0]
    t_err = (out.wav[:1].cpu() - ref.wav).abs().max().item()
    t_ok = (bool(torch.isfinite(out.wav).all())
            and tuple(out.wav.shape) == (batch, int(seconds * 16000)))
    teacher = dict(config=model.cfg.name, batch=batch, seconds=seconds,
                   forward_ms=wall * 1e3, rtf=wall / (batch * seconds),
                   peak_mem_bytes=peak, lstm_launches=t_launches, lstm_T=T,
                   lstm_N=2 * batch, lstm_H=model.cfg.rnn_units // 2,
                   plan=lstm_seq_fwd_plan(2 * batch, model.cfg.rnn_units // 2),
                   max_abs_err_vs_cpu=t_err, tol=SERVING_ATOL,
                   wav_absmax=float(out.wav.abs().max()), finite_and_shaped=t_ok)
    say("asteroid_teacher", **teacher)
    if not t_ok or t_err > SERVING_ATOL or t_launches != 4 * iters:
        raise RuntimeError(f"the asteroid teacher on the card is wrong: {teacher}")

    # the student streaming, as phase 4
    cfg, variables, _ = read_reference_bundle(student_pth)
    state = torch_state_from_flax(variables)
    engines = [StreamingEnhancer(cfg, state, device=dev, chunk_frames=CHUNK_FRAMES,
                                 context_frames=CONTEXT_FRAMES) for dev in ("cuda", "cpu")]
    streaming = dict(config=cfg.name, **streaming_record(*engines))
    say("asteroid_streaming", **streaming)
    if not streaming["finite"] or streaming["max_abs_err_vs_cpu"] > SERVING_ATOL:
        raise RuntimeError("asteroid streaming on the card disagrees with the CPU")

    cli = asteroid_cli_checks(student_pth, directory, "cuda")
    say("asteroid_cli", **cli)
    if cli["failures"]:
        raise RuntimeError(f"the asteroid CLI checks failed: {cli['failures']}")
    return {"teacher": teacher, "streaming": streaming, "cli": cli, "teacher_pth": teacher_pth,
            "lstm_launches": t_launches + streaming["lstm_launches"] + cli["lstm_launches"]}


# ------------------------------------------- training the asteroid family


def dccrnet_models(compute_dtype: str = "float32") -> dict:
    """The paper's pair, teacher ``DCCRN-CL`` and student ``DCCRN-CL-test``
    (``config.DCCRNET_TEACHER``, ``DCCRNET_STUDENT``), computing in
    ``compute_dtype``."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import DCCRNET_STUDENT, DCCRNET_TEACHER

    return {"teacher": dataclasses.replace(DCCRNET_TEACHER, compute_dtype=compute_dtype),
            "student": dataclasses.replace(DCCRNET_STUDENT, compute_dtype=compute_dtype)}


def abf_gate_counts(cfg) -> dict:
    """The ABF kernels' launches a step that the gates give on the student
    taps of ``cfg`` at its batch and clip length (the port's gates keep the
    JAX shape conditions): per block in each chain's order, K5f and K5b
    where ``block_pallas`` and ``abf_block_dispatchable`` take it, else K4f
    and K4b where the block fuses and ``attfuse_pallas`` and
    ``attfuse_dispatchable`` take it, and K3f twice (forward and dx) and
    K3w once where ``conv_pallas`` is on; each counter named as
    ``_kernel_counters`` names it.  The tap shapes come from one forward of
    the student on the CPU."""
    import torch

    from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_dispatchable
    from speech_enhancement_clskd_tpu_torch.kernels.attfuse import attfuse_dispatchable
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
    from speech_enhancement_clskd_tpu_torch.train.trainer import _teacher_tap_channels

    d = cfg.distill
    batch, samples = cfg.data.batch_size, int(cfg.data.segment * cfg.data.sample_rate)
    with torch.no_grad():
        taps = make_model(cfg.student, device="cpu")(torch.zeros(1, samples)).taps
    suffix = "_bf16" if d.taps_dtype == BF16 else ""
    counts = {}

    def add(name, n=1):
        counts[name + suffix] = counts.get(name + suffix, 0) + n

    for maps, outs, reverse in ((taps.encoder, _teacher_tap_channels(cfg.teacher)[0], True),
                                (taps.decoder, _teacher_tap_channels(cfg.teacher)[1], False)):
        shapes = [(batch,) + tuple(t.shape[1:]) for t in maps]
        outs = list(outs)
        if reverse:
            shapes, outs = shapes[::-1], outs[::-1]
        res = None
        for shape, out in zip(shapes, outs):
            if d.abf_block_pallas and abf_block_dispatchable(shape, res, d.abf_mid_channels,
                                                             out):
                add("abf_block_fwd")
                add("abf_block_bwd")
            else:
                xhat = shape[:3] + (d.abf_mid_channels,)
                if res is not None and d.abf_attfuse_pallas and attfuse_dispatchable(xhat, res):
                    add("attfuse_fwd")
                    add("attfuse_bwd")
                if d.abf_conv_pallas:
                    add("conv3x3_fwd", 2)
                    add("conv3x3_wgrad")
            res = shape[:3] + (d.abf_mid_channels,)
    return counts


def dccrnet_cli_checks(teacher_pth: str, directory: str, device: str, overrides=None,
                       request=None, compute_pesq: bool = True) -> dict:
    """The loop a user runs to distill the asteroid family, through the
    CLI on ``device``: ``import-torch`` of the teacher's ``.pth``, ``distill
    --strategy clskd --teacher-bundle`` with the dccrnet presets' overrides
    (``overrides``: the run's data, epochs and widths; by default one epoch
    of 2 steps on 4 x 1 s synthetic clips), ``evaluate`` of the best
    bundle on ``device`` and on the CPU (phase 22's tolerances; PESQ unless
    ``compute_pesq`` is false), and the
    bundle streaming ``request`` (by default phase 4's first) on ``device``
    against the CPU.  The record, with the kernels' launches of each stage
    and ``failures``."""
    import contextlib
    import io

    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.cli import main as cli
    from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    if overrides is None:
        overrides = DCCRNET_CLI_OVERRIDES
    counters = _kernel_counters()
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    teacher_npz = str(out / "teacher.npz")
    run = str(out / "run")
    log = io.StringIO()
    failures, launches = [], {}
    with contextlib.redirect_stdout(log):
        rcs = [cli(["import-torch", "--pth", teacher_pth, "--out", teacher_npz])]
        _zero_counts(counters)
        t0 = time.perf_counter()
        rcs.append(cli(["distill", "--strategy", "clskd", "--teacher-bundle", teacher_npz,
                        "--out", run, "--device", device, *DCCRNET_PRESETS, *overrides]))
        distill_s = time.perf_counter() - t0
        launches["distill"] = {k: v for k, v in _counts(counters).items() if v}
        result = json.loads(log.getvalue().strip().splitlines()[-1])
        bundle = result["bundle"]
        metrics = {}
        for dev in (device, "cpu"):
            _zero_counts(counters)
            rcs.append(cli(["evaluate", "--bundle", bundle, "--device", dev,
                            *([] if compute_pesq else ["--no-pesq"]),
                            "--results", str(out / f"evaluate_{dev}.json"), *overrides]))
            launches[f"evaluate_{dev}"] = {k: v for k, v in _counts(counters).items() if v}
            metrics[dev] = json.loads((out / f"evaluate_{dev}.json").read_text())
    cfg, variables, meta = load_bundle(bundle)
    tcfg = load_bundle(teacher_npz)[0]
    if rcs != [0] * 4:
        failures.append(f"exit codes {rcs}")
    if cfg.family != "dccrnet" or tcfg.family != "dccrnet" or meta["model_name"] != "DCCRNet":
        failures.append(f"bundle families: student {cfg.family}, teacher {tcfg.family}")
    err = _eval_errors(metrics[device], metrics["cpu"])
    if not _eval_within(err):
        failures.append(f"evaluate on {device} against the CPU {err}")
    if not all(np.isfinite(v) for v in result["final_metrics"].values()):
        failures.append(f"fit metrics {result['final_metrics']}")

    wav = _requests()[0] if request is None else request
    state = torch_state_from_flax(variables)
    engines = {dev: StreamingEnhancer(cfg, state, device=dev, chunk_frames=CHUNK_FRAMES,
                                      context_frames=CONTEXT_FRAMES) for dev in (device, "cpu")}
    _zero_counts(counters)
    streamed = engines[device].stream(wav)
    launches["streaming"] = {k: v for k, v in _counts(counters).items() if v}
    stream_err = float(np.abs(streamed - engines["cpu"].stream(wav)).max())
    if not (np.isfinite(streamed).all() and streamed.shape == wav.shape) \
            or stream_err > SERVING_ATOL:
        failures.append(f"streaming the bundle on {device} against the CPU: {stream_err}")
    if device == "cuda":
        torch.cuda.synchronize()
        want = {"lstm_seq_fwd": 8 * 2 + 4 * 2, "lstm_seq_bwd": 4 * 2}  # 2 steps, 2 val batches
        if launches["distill"] != want:
            failures.append(f"distill launched {launches['distill']}, expected {want}")
    return dict(student=cfg.name, teacher=tcfg.name, family=cfg.family, distill_s=distill_s,
                final_metrics=result["final_metrics"], evaluate=metrics[device],
                evaluate_err=err, stream_max_abs_err_vs_cpu=stream_err,
                stream_samples=len(wav), launches=launches,
                lstm_launches=sum(r.get("lstm_seq_fwd", 0) for k, r in launches.items()
                                  if k != "evaluate_cpu"),
                lstm_bwd_launches=launches["distill"].get("lstm_seq_bwd", 0),
                failures=failures)


def phase_dccrnet_training(teacher_pth: str, directory: str, phase7: dict) -> dict:
    """Phase 24: CLSKD training of the asteroid DCCRNet family at the
    paper's full width, teacher phase 23's seeded ``DCCRN-CL`` (its
    ``.pth`` read by ``read_reference_bundle``), student ``DCCRN-CL-test``
    seeded: the default step as phase 7 (one warm-up, 10 timed steps at 32 x
    3 s, K1f 8, K1b 4 a step, its card-vs-CPU step) beside phase 7, its
    gradients held against their rounding floor as phase 15's (at random
    init this step's gradients are worse conditioned than DCCRN's: on the
    CPU one rounding of the input moved ``enc4_conv.wi``'s by 2.5e-3); the
    kernel-config and block-config forms as phases 9 and 11 (launches per
    step the gates' counts on these taps, ``abf_gate_counts``: no K4, the
    residuals one frame short of each map; K5 on the two unfused blocks),
    each form's card loss on the check batches against the default form's;
    the bf16 form as phase 18 with its card-vs-CPU step, where a gradient
    above phase 18's hold is held to twice its own rounding floor
    (``own_floor``: the last decoder's PReLU slope read 0.142 against the
    hold's 0.1 cap, where the input rounded once more moved it by 0.23 on
    the CPU; NVIDIA H100 80GB HBM3, 700 W); then the CLI loop
    (``dccrnet_cli_checks``) in ``directory``."""
    from speech_enhancement_clskd_tpu_torch.models.dccrnet import read_reference_bundle

    _, teacher_vars, _ = read_reference_bundle(teacher_pth)
    models = dccrnet_models()
    lstm = {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4}
    name = "clskd DCCRNet (DCCRN-CL teacher from a seeded .pth, DCCRN-CL-test student)"
    recs = {"default": _training("dccrnet_training", name, {}, TRAIN_STEPS, lstm,
                                 rounding_floor=True, models=models,
                                 teacher_variables=teacher_vars,
                                 beside=_beside("phase 7 (clskd, DCCRN)", phase7))}
    for key, flags in (("kernels", ABF_KERNEL_FLAGS), ("block", ABF_BLOCK_FLAGS)):
        gates = abf_gate_counts(train_config(TEACHER_BATCH, TRAIN_SECONDS, flags, **models))
        rec = _training(f"dccrnet_training_{key}", f"{name} with {flags}", flags,
                        KERNEL_TRAIN_STEPS, {**lstm, **gates}, rounding_floor=True,
                        models=models, teacher_variables=teacher_vars)
        rec["gate_counts"] = gates
        rec["loss_vs_default"] = {
            batch: abs(rec["card_vs_cpu"][batch]["steps"][0]["loss"]
                       - recs["default"]["card_vs_cpu"][batch]["steps"][0]["loss"])
            / abs(recs["default"]["card_vs_cpu"][batch]["steps"][0]["loss"])
            for batch in ("gaussian", "speech")}
        say(f"dccrnet_training_{key}_loss_vs_default", gate_counts=gates,
            loss_rel_err=rec["loss_vs_default"], tol=TRAIN_LOSS_RTOL)
        if max(rec["loss_vs_default"].values()) > TRAIN_LOSS_RTOL:
            raise RuntimeError(f"the {key} form's loss parts from the default form's: "
                               f"{rec['loss_vs_default']}")
        recs[key] = rec
    recs["bf16"] = _training("dccrnet_training_bf16", f"{name}, bf16 compute and taps",
                             BF16_DISTILL, KERNEL_TRAIN_STEPS, lstm, rounding_floor=True,
                             own_floor=True, models=dccrnet_models(BF16),
                             teacher_variables=teacher_vars,
                             beside=_beside("dccrnet_training (float32)", recs["default"]))
    cli = dccrnet_cli_checks(teacher_pth, str(Path(directory) / "dccrnet_cli"), "cuda")
    say("dccrnet_cli", **cli)
    if cli["failures"]:
        raise RuntimeError(f"the DCCRNet training CLI checks failed: {cli['failures']}")
    recs["cli"] = cli
    return recs


# ------------------------------------------------------- pretraining


def _pretraining(phase: str, config: str, teacher: dict, steps: int, expected: dict,
                 plans: dict, beside: dict = None) -> dict:
    """``_training`` of a ``PretrainTrainer`` of ``TrainConfig()``'s teacher
    with ``teacher`` set, at 32 x 3 s, launches per step held to
    ``expected``, with its card-vs-CPU step (4 x 1 s): the loss to 1e-5
    (bf16 1e-3), the gradients against their rounding floor, a tensor above
    the hold against twice its own floor (``own_floor``).  The floor is the
    largest move over ``FLOOR_SEEDS`` random roundings of the input
    (``neighbour_rounding``): the BN after the first conv and PMSQE's level
    alignment take the uniform scaling of the other phases out, and one
    draw of a floor is a noisy estimate of it.  ``plans``: the LSTM
    kernels' plans at these shapes, added to the record."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import TEACHER

    rec = _training(phase, config, {}, steps, expected, rounding_floor=True, own_floor=True,
                    beside=beside, models={"teacher": dataclasses.replace(TEACHER, **teacher)},
                    pretrain=True, floor_seeds=FLOOR_SEEDS)
    say(f"{phase}_lstm_plans", **plans)
    rec["lstm_plans"] = plans
    return rec


def pretrain_cli_checks(directory: str, device: str, overrides=PRETRAIN_CLI_OVERRIDES,
                        compute_pesq: bool = True) -> dict:
    """The workflow that makes a teacher and distills from it, through the
    CLI on ``device``: ``pretrain --model teacher`` (``overrides``: by
    default an epoch of 2 steps on 4 x 1 s synthetic clips, 2 validation
    batches), ``distill --strategy clskd --teacher-bundle
    <out>/teacher_model.npz`` (an epoch), and ``evaluate`` of the
    pretrained teacher's bundle on ``device`` and on the CPU (phase 22's
    tolerances; PESQ unless ``compute_pesq`` is false).  The record, with
    the kernels' launches of each stage and ``failures``."""
    import contextlib
    import io

    import numpy as np

    from speech_enhancement_clskd_tpu_torch.cli import main as cli
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    counters = _kernel_counters()
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    log = io.StringIO()
    launches, metrics, seconds = {}, {}, {}
    with contextlib.redirect_stdout(log):
        _zero_counts(counters)
        t0 = time.perf_counter()
        rcs = [cli(["pretrain", "--model", "teacher", "--out", str(out / "pretrain"),
                    "--device", device, *overrides])]
        seconds["pretrain"] = time.perf_counter() - t0
        launches["pretrain"] = {k: v for k, v in _counts(counters).items() if v}
        pretrained = json.loads(log.getvalue().strip().splitlines()[-1])
        bundle = pretrained["bundle"]
        _zero_counts(counters)
        t0 = time.perf_counter()
        rcs.append(cli(["distill", "--strategy", "clskd", "--teacher-bundle", bundle,
                        "--out", str(out / "distill"), "--device", device, *overrides]))
        seconds["distill"] = time.perf_counter() - t0
        launches["distill"] = {k: v for k, v in _counts(counters).items() if v}
        distilled = json.loads(log.getvalue().strip().splitlines()[-1])
        for dev in (device, "cpu"):
            _zero_counts(counters)
            rcs.append(cli(["evaluate", "--bundle", bundle, "--device", dev,
                            *([] if compute_pesq else ["--no-pesq"]),
                            "--results", str(out / f"evaluate_{dev}.json"), *overrides]))
            launches[f"evaluate_{dev}"] = {k: v for k, v in _counts(counters).items() if v}
            metrics[dev] = json.loads((out / f"evaluate_{dev}.json").read_text())
    cfg, _, meta = load_bundle(bundle)
    failures = []
    if rcs != [0] * 4:
        failures.append(f"exit codes {rcs}")
    if meta["model_name"] != "DCCRN" or set(meta["infos"]) < {"history", "loss_mode"}:
        failures.append(f"bundle {meta['model_name']} with infos {sorted(meta['infos'])}")
    for name, result in (("pretrain", pretrained), ("distill", distilled)):
        if not all(np.isfinite(v) for v in result["final_metrics"].values()):
            failures.append(f"{name} metrics {result['final_metrics']}")
    err = _eval_errors(metrics[device], metrics["cpu"])
    if not _eval_within(err):
        failures.append(f"evaluate on {device} against the CPU {err}")
    if device == "cuda":
        # 2 steps and 2 validation batches each: the teacher's 4 LSTM layers
        # a forward; the distill step also runs the student's 4
        want = {"pretrain": {"lstm_seq_fwd": 4 * 2 + 4 * 2, "lstm_seq_bwd": 4 * 2},
                "distill": {"lstm_seq_fwd": 8 * 2 + 4 * 2, "lstm_seq_bwd": 4 * 2}}
        for stage, counts in want.items():
            if launches[stage] != counts:
                failures.append(f"{stage} launched {launches[stage]}, expected {counts}")
    return dict(model=cfg.name, loss_mode=meta["infos"].get("loss_mode"), seconds=seconds,
                pretrain_metrics=pretrained["final_metrics"],
                distill_metrics=distilled["final_metrics"], evaluate=metrics[device],
                evaluate_err=err, launches=launches,
                lstm_launches=sum(r.get("lstm_seq_fwd", 0) for k, r in launches.items()
                                  if k != "evaluate_cpu"),
                lstm_bwd_launches=sum(r.get("lstm_seq_bwd", 0) for r in launches.values()),
                failures=failures)


def phase_pretraining(phase7: dict, directory: str) -> dict:
    """Phase 25: pretraining the teacher on the card (``PretrainTrainer``,
    ``TrainConfig()``'s ``dccrn-cl`` at full width, ``SDR+PMSQE``, plain
    Adam): (a) float32 at 32 x 3 s (K1f 4, K1b 4 a step: the complex LSTM's
    two layers of two LSTMs at N = 64, H = 128) beside phase 7's
    distillation step, with its card-vs-CPU step; (b) the same in bf16
    compute, held as phase 18 holds its step; (c) complex BN with the
    real-LSTM bottleneck (``use_cbn=True, use_clstm=False``: K1f 2, K1b 2 a
    step at N = 32, H = 256) and its card-vs-CPU step; (d) the CLI chain
    ``pretrain`` -> ``distill --teacher-bundle`` -> ``evaluate``
    (``pretrain_cli_checks``) in ``directory``."""
    from speech_enhancement_clskd_tpu_torch.kernels.lstm import (
        lstm_seq_bwd_plan,
        lstm_seq_fwd_plan,
    )

    complex_plans = {"fwd": lstm_seq_fwd_plan(2 * TEACHER_BATCH, 128),
                     "bwd": lstm_seq_bwd_plan(128)}
    T, N, H = REAL_LSTM_SHAPE
    real_plans = {"fwd": lstm_seq_fwd_plan(N, H), "bwd": lstm_seq_bwd_plan(H)}
    lstm = {"lstm_seq_fwd": 4, "lstm_seq_bwd": 4}
    recs = {"f32": _pretraining("pretraining", "pretrain TrainConfig().teacher (dccrn-cl), "
                                "SDR+PMSQE, float32", {}, PRETRAIN_STEPS, lstm, complex_plans,
                                beside=_beside("phase 7 (clskd distillation step)", phase7))}
    recs["bf16"] = _pretraining("pretraining_bf16", "pretrain dccrn-cl, bf16 compute",
                                {"compute_dtype": BF16}, PRETRAIN_STEPS, lstm, complex_plans,
                                beside=_beside("pretraining (float32)", recs["f32"]))
    recs["cbn_real_lstm"] = _pretraining(
        "pretraining_cbn_real_lstm", "pretrain dccrn-cl with use_cbn=True, use_clstm=False",
        {"use_cbn": True, "use_clstm": False}, PRETRAIN_REAL_STEPS,
        {"lstm_seq_fwd": 2, "lstm_seq_bwd": 2}, real_plans,
        beside=_beside("pretraining (float32)", recs["f32"]))
    cli = pretrain_cli_checks(str(Path(directory) / "pretrain_cli"), "cuda")
    say("pretrain_cli", **cli)
    if cli["failures"]:
        raise RuntimeError(f"the pretraining CLI checks failed: {cli['failures']}")
    recs["cli"] = cli
    return recs


# phase 26: data and sequence parallelism.  (a) world 1 over NCCL in this
# process, (b) world 2 over gloo, two workers on the one card, each with
# half of phase 7's batch, (c) sequence parallel over 2 gloo ranks on the
# card, 2 x 64 s.  The forms of (a) and (b): (ABF flags, spkd_gram_groups).
PARALLEL_FORMS = {"default_g1": ({}, 1), "default_g2": ({}, 2),
                  "block_g1": (ABF_BLOCK_FLAGS, 1), "block_g2": (ABF_BLOCK_FLAGS, 2)}
# the kernels' launches a step of each form, and of the pretraining step
PARALLEL_LAUNCHES = {"default": {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4},
                     "block": {"lstm_seq_fwd": 8, "lstm_seq_bwd": 4, "abf_block_fwd": 12,
                               "abf_block_bwd": 12},
                     "pretrain": {"lstm_seq_fwd": 4, "lstm_seq_bwd": 4}}
PARALLEL_TIMED_STEPS = 5
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT = 300  # seconds a group of workers may take
# the phase's sizes on the card: the device, (a)'s backend, phase 7's batch
# and clips, the models (None: TrainConfig()'s; the CPU rehearsal shrinks
# them), (c)'s utterances, the launches a sequence-parallel forward
PARALLEL_SPEC = {"device": "cuda", "backend": "nccl", "batch": TEACHER_BATCH,
                 "seconds": TRAIN_SECONDS, "teacher": None, "student": None,
                 "sequence_seconds": 64.0, "sequence_lstm_launches": 4}
# the interior's distance from the whole offline forward (the JAX test's
# bound; the first and last 0.5 s left out) and a span's from its window
# run alone
SEQUENCE_INTERIOR = 0.02
SEQUENCE_SPAN_ATOL = 1e-6


def _launched(counters: dict) -> dict:
    """The kernels launched since the counts were set to 0, and how often."""
    return {k: v for k, v in _counts(counters).items() if v}


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _state_copy(trainer) -> dict:
    from speech_enhancement_clskd_tpu_torch.utils.bridge import trainer_parts

    return {part: {k: v.detach().clone() for k, v in getattr(trainer, part).state_dict().items()}
            for part in trainer_parts(trainer)}


def _restart(trainer, initial: dict) -> None:
    """``trainer`` back to the weights and statistics ``initial`` (a
    ``_state_copy``) with a fresh optimizer, at step 0."""
    from speech_enhancement_clskd_tpu_torch.utils.bridge import trainer_parts

    for part in trainer_parts(trainer):
        getattr(trainer, part).load_state_dict(initial[part])
    trainer.optimizer.state.clear()
    trainer.step = 0


def _step_from(trainer, initial: dict, mix, clean) -> dict:
    """One step of ``trainer`` from ``initial`` on cuDNN's deterministic
    algorithms: the loss, the gradient norm, the gradients (on the host)
    and the step's ms."""
    import torch

    _restart(trainer, initial)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _sync(trainer.device)
        t0 = time.perf_counter()
        logs = trainer.train_step(mix, clean)
        _sync(trainer.device)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"loss": float(logs["train_loss"]), "grad_norm": float(logs["grad_norm"]),
            "grads": _grads(trainer), "ms": ms}


def _timed_steps(trainer, mix, clean) -> dict:
    import numpy as np

    ms = []
    for _ in range(PARALLEL_TIMED_STEPS):
        _sync(trainer.device)
        t0 = time.perf_counter()
        trainer.train_step(mix, clean)
        _sync(trainer.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(ms)), "all": ms}


def _bits(got: dict, want: dict) -> dict:
    """Whether ``got``'s loss and gradients equal ``want``'s bit for bit,
    and the largest differences."""
    diffs = {n: (got["grads"][n] - g).abs().max().item() for n, g in want["grads"].items()}
    worst = max(diffs, key=diffs.get)
    return {"bit_exact": got["loss"] == want["loss"] and not any(diffs.values()),
            "loss_diff": abs(got["loss"] - want["loss"]),
            "grad_max_abs_diff": diffs[worst], "grad_worst": worst}


def _parallel_trainer(spec: dict, distill: dict, groups: int, mesh=None, pretrain: bool = False):
    """A trainer of ``spec``'s models (``TrainConfig()``'s by default) at its
    batch and clips, with the ABF flags ``distill`` and
    ``spkd_gram_groups``, seeded with 0 (phase 7's weights), or the
    teacher's ``PretrainTrainer``; on ``mesh`` (the process group's where
    None)."""
    from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig
    from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    models = {k: DCCRNConfig(**spec[k]) for k in ("teacher", "student") if spec[k]}
    cfg = train_config(spec["batch"], spec["seconds"], dict(distill, spkd_gram_groups=groups),
                       **models)
    make = PretrainTrainer if pretrain else Trainer
    return make(cfg, device=spec["device"], mesh=mesh).init_state(0)


def _world_one(spec: dict, form: str, distill: dict, groups: int, mix, clean, timed: bool,
               pretrain: bool = False) -> dict:
    """(a) for one form: the one-process step (twice, to see whether it
    repeats its own bits), the data-parallel step in the group of one from
    the same weights, and the one-process step on ``FLOOR_SEEDS`` roundings
    of the input (the floors (b) is held to); with ``timed``, the median ms
    of ``PARALLEL_TIMED_STEPS`` steps of each and the data-parallel steps'
    launches.  The data-parallel step's loss and gradients must equal the
    one-process step's bit for bit where that repeats its own, else lie
    within ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_REL_L2`` or twice the
    repeat's difference (``failures``).  ``reference``: the data-parallel
    step's loss, gradients and floors, for (b)."""
    from speech_enhancement_clskd_tpu_torch.parallel.mesh import Mesh

    counters = _kernel_counters()
    one = _parallel_trainer(spec, distill, groups, Mesh({"data": 1, "model": 1}), pretrain)
    initial = _state_copy(one)
    ref = _step_from(one, initial, mix, clean)
    again = _step_from(one, initial, mix, clean)
    floors = {}
    for seed in FLOOR_SEEDS:
        moved = _step_from(one, initial, neighbour_rounding(mix, seed), clean)
        errs, _ = _grad_errors(moved["grads"], ref["grads"], ref["grad_norm"])
        floors = {n: max(e, floors.get(n, 0.0)) for n, e in errs.items()}
    rec = {"form": form, "groups": groups, "loss": ref["loss"], "one_process_ms": ref["ms"]}
    if timed:
        _restart(one, initial)
        rec["one_process_step_ms"] = _timed_steps(one, mix, clean)
    del one
    _release(spec["device"])
    dp = _parallel_trainer(spec, distill, groups, None, pretrain)
    if dp.group is None or dp.mesh.shape["data"] != 1:
        raise RuntimeError(f"the data-parallel trainer is not in the group of one: {dp.mesh}")
    _zero_counts(counters)
    got = _step_from(dp, initial, mix, clean)
    rec["dp_step_launches"] = _launched(counters)
    if timed:
        _restart(dp, initial)
        _zero_counts(counters)
        rec["dp_step_ms"] = _timed_steps(dp, mix, clean)
        rec["launches"] = _launched(counters)
    del dp
    _release(spec["device"])
    rec.update(repeat=_bits(again, ref), dp=_bits(got, ref), dp_ms=got["ms"], failures=[],
               why_not_bit_exact=None)
    errors, zero = _grad_errors(got["grads"], ref["grads"], ref["grad_norm"])
    if not rec["dp"]["bit_exact"]:
        if rec["repeat"]["bit_exact"]:
            rec["failures"].append(f"(a) {form}: the group of one changed bits the one-process "
                                   f"step repeats: {rec['dp']}")
        rec["why_not_bit_exact"] = (
            "the one-process step does not repeat its own bits (largest gradient difference "
            f"{rec['repeat']['grad_max_abs_diff']} in {rec['repeat']['grad_worst']})")
        repeat, _ = _grad_errors(again["grads"], ref["grads"], ref["grad_norm"])
        over = {n: e for n, e in errors.items()
                if e > max(TRAIN_GRAD_REL_L2, ROUNDING_FACTOR * repeat[n])}
        loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        if over or loss_err > TRAIN_LOSS_RTOL or zero > ZERO_GRAD:
            rec["failures"].append(f"(a) {form}: data parallel at world 1 against one "
                                   f"process: loss {loss_err}, gradients {over}, zero {zero}")
    rec.update(dp_grad_max_rel_l2=max(errors.values()), floor_max=max(floors.values()))
    want = PARALLEL_LAUNCHES[form.split("_")[0]] if spec["device"] == "cuda" else {}
    for key, steps in (("dp_step_launches", 1), ("launches", PARALLEL_TIMED_STEPS)):
        if key in rec and rec[key] != {k: steps * v for k, v in want.items()}:
            rec["failures"].append(f"(a) {form} {key} {rec[key]}, expected {want} a step")
    rec["reference"] = {"loss": got["loss"], "grads": got["grads"], "floors": floors,
                        "grad_norm": got["grad_norm"]}
    return rec


def _release(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def _workers(job: str, spec: dict, out: Path) -> list:
    """``PARALLEL_WORLD`` ranks of ``chip_smoke.py parallel-worker`` in a
    gloo group on ``spec``'s device, each within ``PARALLEL_TIMEOUT``; their
    records (``OUT/JOB.rRANK.json``)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "parallel-worker",
                               job, str(r), str(PARALLEL_WORLD), port, str(out), json.dumps(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT) for r in range(PARALLEL_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"parallel worker {job} rank {r} exited {p.returncode}:\n"
                               f"{text[-6000:]}")
    return [json.loads((out / f"{job}.r{r}.json").read_text()) for r in range(PARALLEL_WORLD)]


def parallel_worker(argv) -> None:
    """A rank of phase 26 (b) or (c) or of phase 27 (``chip_smoke.py
    parallel-worker JOB RANK WORLD PORT OUT SPEC``): joins the gloo group
    (every rank on the first card) and writes ``OUT/JOB.rRANK.json`` and its
    arrays."""
    sys.path.insert(0, str(ROOT))
    import torch

    from speech_enhancement_clskd_tpu_torch.parallel import distributed

    job, rank, world, port, out, spec = argv
    rank, world, out, spec = int(rank), int(world), Path(out), json.loads(spec)
    if spec["device"] == "cuda":
        torch.cuda.set_device(0)
        spec["device"] = "cuda:0"
    else:
        torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=spec["device"])
    try:
        if job == "dp":
            rec = _dp_worker(spec, rank, out)
        elif job == "tp":
            rec = _tp_worker(spec, rank, out)
        else:
            rec = _sequence_worker(spec, rank, world, out)
        rec["backend"] = torch.distributed.get_backend()
        rec["world"] = torch.distributed.get_world_size()
        distributed.barrier(torch.distributed.group.WORLD)
    finally:
        distributed.leave()
    (out / f"{job}.r{rank}.json").write_text(json.dumps(rec))


def _dp_worker(spec: dict, rank: int, out: Path) -> dict:
    """(b): every form's data-parallel step from phase 7's weights on this
    rank's half of phase 7's batch, then a second, timed step; rank 0
    saves the first step's gradients (``OUT/FORM.pt``)."""
    import torch

    counters = _kernel_counters()
    mix, clean = train_batch(spec["batch"], spec["seconds"])
    recs = {}
    for form, (distill, groups) in PARALLEL_FORMS.items():
        trainer = _parallel_trainer(spec, distill, groups)
        _zero_counts(counters)
        first = _step_from(trainer, _state_copy(trainer), mix, clean)
        _sync(trainer.device)
        t0 = time.perf_counter()
        trainer.train_step(mix, clean)
        _sync(trainer.device)
        recs[form] = {"loss": first["loss"], "grad_norm": first["grad_norm"],
                      "step_ms": [first["ms"], (time.perf_counter() - t0) * 1e3],
                      "launches": _launched(counters),
                      "rows": mix.shape[0] // trainer.mesh.shape["data"]}
        if trainer.device.type == "cuda":
            recs[form]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if rank == 0:
            torch.save(first["grads"], out / f"{form}.pt")
        del trainer
        _release(spec["device"])
    return recs


def sequence_models(spec: dict) -> dict:
    """(c)'s models on ``spec``'s device: the r4 bundle's student and the
    seeded ``dccrn-cl`` teacher (``spec``'s teacher where it names one)."""
    from speech_enhancement_clskd_tpu_torch.config import TEACHER, DCCRNConfig
    from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
    from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
    from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle

    cfg, variables, _ = load_bundle(str(BUNDLE))
    student = make_model(cfg, spec["device"])
    student.load_state_dict(torch_state_from_flax(variables))
    teacher = DCCRNConfig(**spec["teacher"]) if spec["teacher"] else TEACHER
    return {"r4_student": student, "dccrn_cl_teacher": make_model(teacher, spec["device"], seed=0)}


def sequence_signal(seconds: float):
    """2 synthetic mixtures of ``seconds`` (float32 numpy)."""
    import numpy as np

    from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset

    ds = SyntheticEnhancementDataset(size=2, segment=seconds, seed=5)
    return np.stack([ds[i][0] for i in range(2)])


def _sequence_worker(spec: dict, rank: int, world: int, out: Path) -> dict:
    """(c): each model's ``sharded_utterance_forward`` of this rank's span
    (twice, the second timed) against the offline forward of the rank's
    window run alone; the span saved as ``OUT/MODEL.rRANK.npy``."""
    import numpy as np
    import torch

    from speech_enhancement_clskd_tpu_torch.parallel.sequence import sharded_utterance_forward

    counters = _kernel_counters()
    wav = torch.from_numpy(sequence_signal(spec["sequence_seconds"])).to(spec["device"])
    span = wav.shape[1] // world
    lo, hi = rank * span, (rank + 1) * span
    mine = wav[:, lo:hi].contiguous()
    recs = {}
    for name, model in sequence_models(spec).items():
        _zero_counts(counters)
        sharded_utterance_forward(model, mine)
        launches = _launched(counters)
        _sync(spec["device"])
        t0 = time.perf_counter()
        got = sharded_utterance_forward(model, mine)
        _sync(spec["device"])
        ms = (time.perf_counter() - t0) * 1e3
        hop, guard = model.cfg.stft.hop, model.cfg.stft.win_len - model.cfg.stft.hop
        ctx = CONTEXT_FRAMES * hop
        left = wav[:, lo - ctx:lo] if rank else torch.zeros_like(wav[:, :ctx])
        right = wav[:, hi:hi + guard] if rank < world - 1 else torch.zeros_like(wav[:, :guard])
        with torch.no_grad():
            alone = model(torch.cat([left, mine, right], dim=1), training=False).wav
        np.save(out / f"{name}.r{rank}.npy", got.cpu().numpy())
        recs[name] = {"ms": ms, "launches": launches,
                      "span_vs_window_max_abs": (got - alone[:, ctx:ctx + span]).abs().max().item(),
                      "span": span, "context_samples": ctx, "lookahead_samples": guard}
    return recs


def _parallel_launches(recs) -> dict:
    """Each kernel's launches summed over the ``launches`` dicts ``recs``."""
    total = {}
    for launches in recs:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def parallel_checks(spec: dict, out: Path) -> dict:
    """Phase 26's checks on ``spec``'s device (``PARALLEL_SPEC`` on the
    card; the CPU rehearsal shrinks it), the workers' files in ``out``.

    (a) World 1 over ``spec``'s backend in this process: the data-parallel
    ``clskd`` step (``PARALLEL_FORMS``: the default and block forms,
    ``spkd_gram_groups`` 1 and 2) and the pretraining step (phase 25's
    form) from phase 7's weights on phase 7's batch, each against the
    one-process step (``_world_one``), the ``_g1`` forms timed.
    (b) World 2 over gloo, two workers on the one card with half the rows
    each: after one step, the loss within ``TRAIN_LOSS_RTOL`` of (a)'s and
    every gradient within ``TRAIN_GRAD_REL_L2`` or twice its rounding floor
    (phase 7's rule, ``_grad_errors``' exemptions), launches per step as one
    process's; the step ms reported (gloo stages through the host).
    (c) ``sharded_utterance_forward`` over 2 gloo ranks, the r4 student and
    the seeded teacher on 2 utterances of ``sequence_seconds``: each span
    against its window run alone (``SEQUENCE_SPAN_ATOL``), the interior
    against the whole offline forward (``SEQUENCE_INTERIOR``), wall ms
    beside it.  A failed or late worker raises; the other failures are
    listed in ``failures``."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    device = spec["device"]
    mix, clean = train_batch(spec["batch"], spec["seconds"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(spec["backend"], init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, **kw)
    group = {"backend": dist.get_backend(), "world": dist.get_world_size(),
             "nccl": (".".join(str(v) for v in torch.cuda.nccl.version())
                      if spec["backend"] == "nccl" else None)}
    say("parallel_group", **group)
    try:
        one = {form: _world_one(spec, form, distill, groups, mix, clean, timed=groups == 1)
               for form, (distill, groups) in PARALLEL_FORMS.items()}
        one["pretrain"] = _world_one(spec, "pretrain", {}, 1, mix, clean, timed=False,
                                     pretrain=True)
    finally:
        dist.destroy_process_group()
    _release(device)
    failures = [f for r in one.values() for f in r["failures"]]
    rec_a = {form: {k: v for k, v in r.items() if k != "reference"} for form, r in one.items()}

    t0 = time.perf_counter()
    ranks = _workers("dp", spec, out)
    rec_b = {"seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"],
             "world": ranks[0]["world"]}
    for form in PARALLEL_FORMS:
        ref = one[form]["reference"]
        grads = torch.load(out / f"{form}.pt")
        errors, zero = _grad_errors(grads, ref["grads"], ref["grad_norm"])
        tol = {n: max(TRAIN_GRAD_REL_L2, ROUNDING_FACTOR * ref["floors"][n]) for n in errors}
        over = {n: (e, tol[n]) for n, e in errors.items() if e > tol[n]}
        loss = ranks[0][form]["loss"]
        loss_err = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst = max(errors, key=errors.get)
        rec_b[form] = {"loss": loss, "loss_world_one": ref["loss"], "loss_rel_err": loss_err,
                       "grad_max_rel_l2": errors[worst], "grad_worst": worst,
                       "grad_worst_floor": ref["floors"][worst], "zero_grad_max": zero,
                       **{k: [x[form].get(k) for x in ranks]
                          for k in ("step_ms", "peak_mem_bytes", "rows", "launches")}}
        if loss_err > TRAIN_LOSS_RTOL or over or zero > ZERO_GRAD:
            failures.append(f"(b) {form}: loss {loss_err}, gradients {over}, zero {zero}")
        if any(x[form]["loss"] != loss for x in ranks):
            failures.append(f"(b) {form}: the ranks log other losses")
        want = ({k: 2 * v for k, v in PARALLEL_LAUNCHES[form.split("_")[0]].items()}
                if device == "cuda" else {})
        for x in ranks:
            if x[form]["launches"] != want:
                failures.append(f"(b) {form} launches {x[form]['launches']}, expected {want}")

    t0 = time.perf_counter()
    ranks = _workers("sequence", spec, out)
    rec_c = {"seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"],
             "world": ranks[0]["world"], "utterances": [2, spec["sequence_seconds"]]}
    wav = torch.from_numpy(sequence_signal(spec["sequence_seconds"])).to(device)
    edge = int(0.5 * 16000)
    for name, model in sequence_models(spec).items():
        with torch.no_grad():
            model(wav, training=False)
            _sync(device)
            t0 = time.perf_counter()
            offline = model(wav, training=False).wav
            _sync(device)
            offline_ms = (time.perf_counter() - t0) * 1e3
        got = np.concatenate([np.load(out / f"{name}.r{r}.npy")
                              for r in range(PARALLEL_WORLD)], axis=1)
        a, b = offline.cpu().numpy()[:, edge:-edge], got[:, edge:-edge]
        interior = float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2)))
        span_err = max(x[name]["span_vs_window_max_abs"] for x in ranks)
        rec_c[name] = {"interior_rel_rms": interior, "span_vs_window_max_abs": span_err,
                       "sharded_ms": [x[name]["ms"] for x in ranks], "offline_ms": offline_ms,
                       "launches": [x[name]["launches"] for x in ranks],
                       "shape": list(got.shape)}
        if got.shape != tuple(wav.shape) or not np.isfinite(got).all():
            failures.append(f"(c) {name}: spans {got.shape}, finite {np.isfinite(got).all()}")
        if interior >= SEQUENCE_INTERIOR or span_err > SEQUENCE_SPAN_ATOL:
            failures.append(f"(c) {name}: interior {interior}, span vs window {span_err}")
        want = spec["sequence_lstm_launches"] if device == "cuda" else 0
        if any(x[name]["launches"].get("lstm_seq_fwd", 0) != want for x in ranks):
            failures.append(f"(c) {name}: K1f launches {rec_c[name]['launches']}, "
                            f"expected {want} a rank")
    _release(device)
    launches = {
        "parallel_world_one": _parallel_launches(
            [r.get("launches", {}) for r in rec_a.values()]
            + [r["dp_step_launches"] for r in rec_a.values()]),
        "parallel_world_two": _parallel_launches(
            [x for form in PARALLEL_FORMS for x in rec_b[form]["launches"]]),
        "parallel_sequence": _parallel_launches(
            [x for name in ("r4_student", "dccrn_cl_teacher") for x in rec_c[name]["launches"]]),
    }
    return {"group": group, "world_one": rec_a, "world_two": rec_b, "sequence": rec_c,
            "launches": launches, "failures": failures}


def phase_parallel(phase7: dict, pretraining: dict) -> dict:
    """Phase 26: ``parallel_checks`` on the card at full width, the ``_g1``
    forms of (a) beside phase 7's step and the pretraining step beside
    phase 25's; any failure raises."""
    import tempfile

    with tempfile.TemporaryDirectory() as directory:
        rec = parallel_checks(PARALLEL_SPEC, Path(directory))
    for form, r in rec["world_one"].items():
        if form.endswith("_g1"):
            r["beside_phase7_step_ms_median"] = phase7["step_ms_median"]
    rec["world_one"]["pretrain"]["beside_phase25_step_ms_median"] = (
        pretraining["f32"]["step_ms_median"])
    for part in ("world_one", "world_two", "sequence"):
        say(f"parallel_{part}", **rec[part])
    say("parallel_launches", **rec["launches"])
    if rec["failures"]:
        raise RuntimeError(f"phase 26 (parallel) failed: {rec['failures']}")
    return rec

# phase 27: tensor parallelism over mesh.model.  Two gloo ranks on the one
# card at data=1, model=2, each with all of the phase's rows, against the
# one-process step on the same rows.  The forms: (pretraining, steps).
TP_FORMS = {"clskd": (False, 3), "pretrain": (True, 2)}
TP_LAUNCHES = {"clskd": PARALLEL_LAUNCHES["default"], "pretrain": PARALLEL_LAUNCHES["pretrain"]}
# the phase's sizes on the card (the CPU rehearsal shrinks them): the
# device, the rows and clips, the models (None: TrainConfig()'s)
TP_SPEC = {"device": "cuda", "batch": 16, "seconds": TRAIN_SECONDS, "teacher": None,
           "student": None}
TP_MODEL = 2


def _tp_trainer(spec: dict, pretrain: bool, model: int):
    """``TrainConfig()``'s models (``spec``'s where it names them) at
    ``spec``'s rows and clips, seeded with 0: the default ``clskd``
    ``Trainer`` or the teacher's ``PretrainTrainer``, at ``data=1,
    model=model`` over the process group, or in one process (``model``
    1)."""
    import dataclasses

    from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig, MeshConfig
    from speech_enhancement_clskd_tpu_torch.parallel.mesh import Mesh
    from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer
    from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer

    models = {k: DCCRNConfig(**spec[k]) for k in ("teacher", "student") if spec[k]}
    cfg = dataclasses.replace(train_config(spec["batch"], spec["seconds"], {}, **models),
                              mesh=MeshConfig(data=1, model=model))
    mesh = Mesh({"data": 1, "model": 1}) if model == 1 else None
    make = PretrainTrainer if pretrain else Trainer
    return make(cfg, device=spec["device"], mesh=mesh).init_state(0)


def _whole_grads(trainer) -> dict:
    """Every trained gradient on the host, a sliced leaf's gathered whole
    (a collective over the model ranks)."""
    from speech_enhancement_clskd_tpu_torch.models.dccrn import full_tensors

    return {f"{part}.{n}": g.detach().cpu() for part, m in trainer.trainable().items()
            for n, g in full_tensors(m, {n: p.grad for n, p in m.named_parameters()}).items()}


def _tp_steps(trainer, steps: int, mix, clean, counters: dict) -> dict:
    """``steps`` steps of ``trainer`` on cuDNN's deterministic algorithms,
    each timed to its end: the losses, the ms, the first step's gradient
    norm and whole gradients, the launches and the peak memory."""
    import numpy as np
    import torch

    cuda = trainer.device.type == "cuda"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _zero_counts(counters)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = {"losses": [], "ms": []}
    try:
        for k in range(steps):
            _sync(trainer.device)
            t0 = time.perf_counter()
            logs = trainer.train_step(mix, clean)
            _sync(trainer.device)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(logs["train_loss"]))
            if k == 0:
                rec["grad_norm"] = float(logs["grad_norm"])
                rec["grads"] = _whole_grads(trainer)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rec["launches"] = _launched(counters)
    rec["step_ms_median"] = float(np.median(rec["ms"][1:] or rec["ms"]))
    if cuda:
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return rec


def _tp_worker(spec: dict, rank: int, out: Path) -> dict:
    """Phase 27 on one model rank: each form's steps from the seeded weights
    on all of the phase's rows; the bytes of the leaves this rank holds
    sliced (and whole) and of their Adam moments; rank 0 saves the first
    step's whole gradients (``OUT/tp_FORM.pt``), every rank its whole
    leaves and statistics after the last step (``OUT/tp_FORM.rRANK.pt``)."""
    import torch

    from speech_enhancement_clskd_tpu_torch.models.dccrn import full_tensors, model_shards
    from speech_enhancement_clskd_tpu_torch.utils.bridge import trainer_parts

    counters = _kernel_counters()
    mix, clean = train_batch(spec["batch"], spec["seconds"])
    recs = {}
    for form, (pretrain, steps) in TP_FORMS.items():
        trainer = _tp_trainer(spec, pretrain, TP_MODEL)
        rec = _tp_steps(trainer, steps, mix, clean, counters)
        grads = rec.pop("grads")
        if rank == 0:
            torch.save(grads, out / f"tp_{form}.pt")
        held, replicated = {}, {}
        for part in trainer_parts(trainer):
            m = getattr(trainer, part)
            shards = model_shards(m)
            params = dict(m.named_parameters())
            whole = full_tensors(m, {n: params[n] for n in shards})
            for n in shards:
                st = trainer.optimizer.state.get(params[n], {})
                held[f"{part}.{n}"] = {
                    "bytes": params[n].numel() * params[n].element_size(),
                    "whole_bytes": whole[n].numel() * whole[n].element_size(),
                    "adam_bytes": sum(st[k].numel() * st[k].element_size()
                                      for k in ("exp_avg", "exp_avg_sq") if k in st),
                    "trained": part in trainer.trainable()}
            replicated.update({f"{part}.{n}": v.detach().cpu()
                               for n, v in m.state_dict().items() if n not in shards})
        torch.save(replicated, out / f"tp_{form}.r{rank}.pt")
        rec["held"] = held
        rec["rows"] = mix.shape[0] // trainer.mesh.shape["data"]
        rec["mesh"] = trainer.mesh.shape
        recs[form] = rec
        del trainer
        _release(spec["device"])
    return recs


def tp_checks(spec: dict, out: Path) -> dict:
    """Phase 27's checks on ``spec``'s device (``TP_SPEC`` on the card; the
    CPU rehearsal shrinks it), the workers' files in ``out``.  For each form
    (``TP_FORMS``: the default ``clskd`` step, 3 steps, and the pretraining
    step, 2 steps) the one-process trainer takes the steps on the phase's
    rows, and one step on each of ``FLOOR_SEEDS`` roundings of the input
    (its gradients' floors); then two gloo ranks on the one card take the
    same steps at ``data=1, model=2``.  Held: every loss within
    ``TRAIN_LOSS_RTOL`` of the one process's; every gathered gradient of
    step 1 within ``TRAIN_GRAD_REL_L2`` or twice its floor (phase 26 (b)'s
    rule, ``_grad_errors``' exemptions); the whole leaves and statistics
    equal bit for bit on the two ranks; each rank holding half of every
    leaf the rule shards, and of its Adam moments where it trains;
    something sharded; launches a step as one process's on every rank (on
    the card).  A failed or late worker raises; the other failures are
    listed in ``failures``."""
    import torch

    device = spec["device"]
    counters = _kernel_counters()
    mix, clean = train_batch(spec["batch"], spec["seconds"])
    one = {}
    for form, (pretrain, steps) in TP_FORMS.items():
        trainer = _tp_trainer(spec, pretrain, 1)
        initial = _state_copy(trainer)
        rec = _tp_steps(trainer, steps, mix, clean, counters)
        floors = {}
        for seed in FLOOR_SEEDS:
            _restart(trainer, initial)
            trainer.train_step(neighbour_rounding(mix, seed), clean)
            errs, _ = _grad_errors(_whole_grads(trainer), rec["grads"], rec["grad_norm"])
            floors = {n: max(e, floors.get(n, 0.0)) for n, e in errs.items()}
        rec["floors"] = floors
        one[form] = rec
        del trainer
        _release(device)

    t0 = time.perf_counter()
    ranks = _workers("tp", spec, out)
    rec = {"seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"],
           "world": ranks[0]["world"], "mesh": ranks[0]["clskd"]["mesh"],
           "rows_a_rank": ranks[0]["clskd"]["rows"]}
    failures = []
    for form, (_, steps) in TP_FORMS.items():
        ref = one[form]
        got = [x[form] for x in ranks]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], ref["losses"]))
        grads = torch.load(out / f"tp_{form}.pt")
        errors, zero = _grad_errors(grads, ref["grads"], ref["grad_norm"])
        tol = {n: max(TRAIN_GRAD_REL_L2, ROUNDING_FACTOR * ref["floors"][n]) for n in errors}
        over = {n: (e, tol[n]) for n, e in errors.items() if e > tol[n]}
        worst = max(errors, key=errors.get)
        states = [torch.load(out / f"tp_{form}.r{r}.pt") for r in range(PARALLEL_WORLD)]
        unequal = sorted(k for k, v in states[0].items()
                         if any(not torch.equal(s[k], v) for s in states[1:]))
        held = got[0]["held"]
        halves = {n: h for x in got for n, h in x["held"].items()
                  if 2 * h["bytes"] != h["whole_bytes"]
                  or h["adam_bytes"] != (2 * h["bytes"] if h["trained"] else 0)}
        by_part = {}
        for n, h in held.items():
            b = by_part.setdefault(n.split(".")[0], {"leaves": 0, "bytes": 0, "whole_bytes": 0,
                                                     "adam_bytes": 0})
            b["leaves"] += 1
            for k in ("bytes", "whole_bytes", "adam_bytes"):
                b[k] += h[k]
        rec[form] = {
            "steps": steps, "losses": got[0]["losses"], "losses_one_process": ref["losses"],
            "loss_max_rel_err": loss_err, "ranks_same_losses": all(
                x["losses"] == got[0]["losses"] for x in got),
            "grad_max_rel_l2": errors[worst], "grad_worst": worst,
            "grad_worst_floor": ref["floors"][worst], "zero_grad_max": zero,
            "step_ms": [x["ms"] for x in got], "step_ms_median": [x["step_ms_median"] for x in got],
            "one_process_step_ms": ref["ms"], "one_process_step_ms_median": ref["step_ms_median"],
            "peak_mem_bytes": [x.get("peak_mem_bytes") for x in got],
            "one_process_peak_mem_bytes": ref.get("peak_mem_bytes"),
            "sharded_bytes_a_rank": by_part, "replicated_leaves": len(states[0]),
            "replicated_unequal": unequal, "launches": [x["launches"] for x in got],
            "one_process_launches": ref["launches"]}
        if loss_err > TRAIN_LOSS_RTOL or over or zero > ZERO_GRAD:
            failures.append(f"{form}: loss {loss_err}, gradients {over}, zero {zero}")
        if not rec[form]["ranks_same_losses"] or unequal:
            failures.append(f"{form}: the ranks differ: losses {[x['losses'] for x in got]}, "
                            f"whole leaves {unequal[:8]}")
        if not held or halves:
            failures.append(f"{form}: sharded {sorted(held)[:4]}, not halved {halves}")
        want = ({k: steps * v for k, v in TP_LAUNCHES[form].items()}
                if device == "cuda" else {})
        for x in [ref] + got:
            if x["launches"] != want:
                failures.append(f"{form} launches {x['launches']}, expected {want}")
    launches = {"tensor_parallel_one_process": _parallel_launches(
                    [one[f]["launches"] for f in TP_FORMS]),
                "tensor_parallel_ranks": _parallel_launches(
                    [x[f]["launches"] for f in TP_FORMS for x in ranks])}
    return {"tp": rec, "launches": launches, "failures": failures}


def phase_tensor_parallel(phase26: dict) -> dict:
    """Phase 27: ``tp_checks`` on the card at full width, beside phase 26
    (b)'s data-parallel step over the same two gloo ranks; any failure
    raises.  Two ranks on one card run over gloo, which stages each
    collective through the host (NCCL refuses two ranks on one device), so
    the step times say what the collectives cost here, not across cards."""
    import tempfile

    with tempfile.TemporaryDirectory() as directory:
        rec = tp_checks(TP_SPEC, Path(directory))
    rec["tp"]["beside_phase26_world_two_default_g1_step_ms"] = (
        phase26["world_two"]["default_g1"]["step_ms"])
    say("tensor_parallel", **rec["tp"])
    say("tensor_parallel_launches", **rec["launches"])
    if rec["failures"]:
        raise RuntimeError(f"phase 27 (tensor parallelism) failed: {rec['failures']}")
    return rec


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import tempfile

    import speech_enhancement_clskd_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device()
    phase_build()
    fwd_shapes = phase_kernel_vs_plain()
    student_launches = phase_serving_student()
    teacher_launches, teacher = phase_serving_teacher()
    serving_launches = student_launches + teacher_launches
    bwd_shapes = phase_backward_vs_plain()
    training = phase_training()
    conv_shapes, fuse_shapes = phase_abf_kernels_vs_plain()
    kernel_training = phase_training_kernels()
    block_shapes, block_steps, block_step_sums = phase_abf_block_vs_plain()
    block_training = phase_training_block()
    gram_shapes = phase_gram_vs_plain()
    spkd_training = phase_training_spkd()
    fit = phase_fit(training["step_ms_median"], training["audio_s_per_s"])
    reviewkd_training = phase_training_reviewkd(training)
    option_training = phase_training_options(block_training)
    bf16_conv_shapes, bf16_fuse_shapes, bf16_conv_sums, bf16_fuse_sums = (
        phase_bf16_kernels_vs_plain())
    bf16 = phase_training_bf16(training)
    bf16_teacher = phase_serving_teacher_bf16(teacher)
    bf16_kernels_k5_k2 = phase_bf16_block_kernels_vs_plain()
    bf16_block = phase_training_bf16_block(bf16["batch32"], block_training)
    evaluation = phase_evaluation()
    with tempfile.TemporaryDirectory() as directory:
        asteroid = phase_asteroid(directory)
        dccrnet = phase_dccrnet_training(asteroid["teacher_pth"], directory, training)
        pretraining = phase_pretraining(training, directory)
    parallel = phase_parallel(training, pretraining)
    tensor = phase_tensor_parallel(parallel)
    parallel_launches = {**parallel["launches"], **tensor["launches"]}
    bf16_paths = {f"training_bf16_{k}": bf16[k] for k in ("batch32", "batch64", "kernels")}
    bf16_paths.update({f"training_bf16_block_{k}": r for k, r in bf16_block.items()})
    # phase 24's steps, each kernel's launches by form
    dccrnet_paths = {f"dccrnet_training_{k}": dccrnet[k]
                     for k in ("default", "kernels", "block", "bf16")}
    # phase 25's pretraining steps, each kernel's launches by form
    pretrain_paths = {f"pretraining_{k}": pretraining[k] for k in ("f32", "bf16", "cbn_real_lstm")}
    fwd = next(r for r in fwd_shapes if (r["T"], r["N"], r["H"]) == (483, 64, 128))
    bwd = next(r for r in bwd_shapes if (r["T"], r["N"], r["H"]) == (483, 64, 32))
    conv = next(r for r in conv_shapes if (r["B"], r["D"], r["T"], r["C"], r["O"]) == CONV_REF)
    fuse = next(r for r in fuse_shapes if (r["B"], r["D"], r["Dp"], r["T"], r["C"]) == FUSE_REF)
    trained = {name: training["launches"][name] + kernel_training["launches"][name]
               + block_training["launches"][name] + spkd_training["launches"][name]
               + reviewkd_training["launches"][name] + option_training["launches"][name]
               + sum(r["launches"][name] for r in bf16_paths.values())
               + sum(r["launches"][name] for r in dccrnet_paths.values())
               + sum(r["launches"][name] for r in pretrain_paths.values())
               for name in training["launches"]}
    src = "speech_enhancement_clskd_tpu_torch/kernels/csrc/"
    pallas = "speech_enhancement_clskd_tpu/ops/pallas/"
    kernels = [{
        "name": "lstm_seq_fwd",
        "route": "cuda",
        "source": src + "lstm_seq_fwd.cu",
        "replaces": pallas + "lstm.py:36",
        "launches": (serving_launches + bf16_teacher["lstm_launches"] + trained["lstm_seq_fwd"]
                     + sum(r["lstm_launches"] for r in evaluation.values())
                     + asteroid["lstm_launches"] + dccrnet["cli"]["lstm_launches"]
                     + pretraining["cli"]["lstm_launches"]
                     + sum(r.get("lstm_seq_fwd", 0) for r in parallel_launches.values())),
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
                             "fit": fit["launches"]["lstm_seq_fwd"],
                             "training_reviewkd": reviewkd_training["launches"]["lstm_seq_fwd"],
                             "training_options": option_training["launches"]["lstm_seq_fwd"],
                             "serving_teacher_bf16": bf16_teacher["lstm_launches"],
                             **{f"evaluation_{k}": r["lstm_launches"]
                                for k, r in evaluation.items()},
                             "asteroid_teacher": asteroid["teacher"]["lstm_launches"],
                             "asteroid_streaming": asteroid["streaming"]["lstm_launches"],
                             "asteroid_cli": asteroid["cli"]["lstm_launches"],
                             **{k: r["launches"]["lstm_seq_fwd"]
                                for k, r in bf16_paths.items()},
                             **{k: r["launches"]["lstm_seq_fwd"]
                                for k, r in dccrnet_paths.items()},
                             "dccrnet_cli": dccrnet["cli"]["lstm_launches"],
                             **{k: r["launches"]["lstm_seq_fwd"]
                                for k, r in pretrain_paths.items()},
                             "pretrain_cli": pretraining["cli"]["lstm_launches"],
                             **{k: r.get("lstm_seq_fwd", 0)
                                for k, r in parallel_launches.items()}},
        "pretraining_shapes": [r for r in fwd_shapes if (r["T"], r["N"], r["H"]) in (
            (483, 64, 128), REAL_LSTM_SHAPE)],
        "per_shape": fwd_shapes,
    }, {
        "name": "lstm_seq_bwd",
        "route": "cuda",
        "source": src + "lstm_seq_bwd.cu",
        "replaces": pallas + "lstm.py:60",
        "launches": (trained["lstm_seq_bwd"] + dccrnet["cli"]["lstm_bwd_launches"]
                     + pretraining["cli"]["lstm_bwd_launches"]
                     + sum(r.get("lstm_seq_bwd", 0) for r in parallel_launches.values())),
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
                             "fit": fit["launches"]["lstm_seq_bwd"],
                             "training_reviewkd": reviewkd_training["launches"]["lstm_seq_bwd"],
                             "training_options": option_training["launches"]["lstm_seq_bwd"],
                             **{k: r["launches"]["lstm_seq_bwd"]
                                for k, r in bf16_paths.items()},
                             **{k: r["launches"]["lstm_seq_bwd"]
                                for k, r in dccrnet_paths.items()},
                             "dccrnet_cli": dccrnet["cli"]["lstm_bwd_launches"],
                             **{k: r["launches"]["lstm_seq_bwd"]
                                for k, r in pretrain_paths.items()},
                             "pretrain_cli": pretraining["cli"]["lstm_bwd_launches"],
                             **{k: r.get("lstm_seq_bwd", 0)
                                for k, r in parallel_launches.items()}},
        "pretraining_shapes": [r for r in bwd_shapes if (r["T"], r["N"], r["H"]) in (
            (483, 64, 128), REAL_LSTM_SHAPE)],
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
            "launches": (kernel_training["launches"][name]
                         + dccrnet["kernels"]["launches"][name]),
            "launches_by_path": {"training_kernels": kernel_training["launches"][name],
                                 "dccrnet_training_kernels": dccrnet["kernels"]["launches"][name]},
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
            "launches": (block_training["launches"][name] + option_training["launches"][name]
                         + dccrnet["block"]["launches"][name]
                         + sum(r.get(name, 0) for r in parallel_launches.values())),
            "launches_by_path": {"training_block": block_training["launches"][name],
                                 "training_options": option_training["launches"][name],
                                 "dccrnet_training_block": dccrnet["block"]["launches"][name],
                                 **{k: r.get(name, 0) for k, r in parallel_launches.items()}},
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
        "times": {k: gram_ref[k] for k in ("timing", "calls_timed", "pass1_ms", "pass2_ms",
                                           "event_ms", "host_ms", "l2_flushed")},
        "shape": {"B": spkd_batch, "Ds": SPKD_SAMPLES, "Dt": SPKD_SAMPLES},
        "per_shape": gram_shapes,
    })
    bf16_conv = bf16_conv_shapes[0]  # the reference shape, timed
    bf16_fuse = next(r for r in bf16_fuse_shapes
                     if (r["B"], r["D"], r["Dp"], r["T"], r["C"]) == FUSE_REF)
    kernel_bf16 = bf16["kernels"]["launches"]
    for name, source, line, cases, shape, key, err, outs in (
            ("conv3x3_fwd_bf16", "conv3x3_bf16.cu", "conv3x3.py:120", bf16_conv_shapes,
             bf16_conv, "fwd", "fwd_max_abs_err", ("fwd_check",)),
            ("conv3x3_wgrad_bf16", "conv3x3_bf16.cu", "conv3x3.py:135", bf16_conv_shapes,
             bf16_conv, "wgrad", "wgrad_rel_l2", ()),
            ("attfuse_fwd_bf16", "attfuse_bf16.cu", "attfuse.py:99", bf16_fuse_shapes,
             bf16_fuse, "fwd", "fwd_max_abs_err", ("out_check", "z_check")),
            ("attfuse_bwd_bf16", "attfuse_bf16.cu", "attfuse.py:113", bf16_fuse_shapes,
             bf16_fuse, "bwd", "bwd_max_abs_err_dx_dres", ("dx_check", "dres_check"))):
        # the bf16 outputs' distance from the plain version (dw is float32)
        checks = [r[c] for r in cases for c in outs]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": pallas + line,
            "dtype": BF16,
            "launches": kernel_bf16[name],
            "max_abs_err": max(r[err] for r in cases),
            "ms": shape[f"{key}_ms"],
            "plain_ms": shape[f"{key}_plain_ms"],
            "bound_ms": shape[f"{key}_bound_ms"],
            "bound_by": shape[f"{key}_bound_by"],
            "library_ms": shape.get(f"{key}_library_ms"),
            "max_ulps": max((c["max_ulps"] for c in checks), default=None),
            "share_differ": max((c["share_differ"] for c in checks), default=None),
            "share_over_1ulp": max((c["share_over_1ulp"] for c in checks), default=None),
            "shape": conv_shape if name.startswith("conv") else fuse_shape,
            "per_shape": cases,
        })
    bf16_block_ref = bf16_kernels_k5_k2["blocks"][0]
    for name, source, line, key in (("abf_block_fwd_bf16", "abf_block_bf16.cu",
                                     "abf_block.py:196", "fwd"),
                                    ("abf_block_bwd_bf16", "abf_block_bf16.cu",
                                     "abf_block.py:220", "bwd")):
        cases = bf16_kernels_k5_k2["blocks"]
        outs = ("xf", "out") if key == "fwd" else ("g_tap", "g_res")
        checks = [r["checks"][c] for r in cases for c in outs if c in r["checks"]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": pallas + line,
            "dtype": BF16,
            "launches": sum(r["launches"][name] for r in bf16_block.values()),
            "launches_by_path": {f"training_bf16_block_{k}": r["launches"][name]
                                 for k, r in bf16_block.items()},
            "max_abs_err": max(r[f"{key}_max_abs_err" if key == "fwd"
                                 else "bwd_max_abs_err_g_tap_g_res"] for r in cases),
            "bwd_max_rel_l2": (max(max(r["bwd_rel_l2"].values()) for r in cases)
                               if key == "bwd" else None),
            "ms": bf16_block_ref[f"{key}_ms"],
            "plain_ms": bf16_block_ref[f"{key}_plain_ms"],
            "bound_ms": bf16_block_ref[f"{key}_bound_ms"],
            "bound_by": bf16_block_ref[f"{key}_bound_by"],
            "library_ms": None,
            "step_ms": bf16_kernels_k5_k2["block_step_sums"][f"{key}_ms"],
            "routes": bf16_kernels_k5_k2["block_step_detail"][key]["routes"],
            "passes_ms": bf16_block_ref[f"{key}_passes"],
            "pass_bounds_ms": bf16_block_ref[f"{key}_pass_bounds"],
            "step": bf16_kernels_k5_k2["block_step_detail"][key],
            "max_ulps": max(c["max_ulps"] for c in checks),
            "share_differ": max(c["share_differ"] for c in checks),
            "share_over_1ulp": max(c["share_over_1ulp"] for c in checks),
            "shape": block_shape,
            "per_shape": cases,
        })
    bf16_gram = bf16_kernels_k5_k2["grams"][0]
    kernels.append({
        "name": "gram_pair_fwd_bf16",
        "route": "cuda",
        "source": src + "gram_pair_bf16.cu",
        "replaces": pallas + "gram.py:41",
        "dtype": BF16,
        "launches": bf16_kernels_k5_k2["gram_entry"]["launches"]["gram_pair_fwd_bf16"],
        "launches_by_path": {"spkd_loss_bf16_entry": bf16_kernels_k5_k2["gram_entry"]["launches"][
            "gram_pair_fwd_bf16"]},
        "max_abs_err": max(r["max_abs_err"] for r in bf16_kernels_k5_k2["grams"]),
        "rel_l2": max(r["rel_l2"] for r in bf16_kernels_k5_k2["grams"]),
        "ms": bf16_gram["ms"],
        "plain_ms": bf16_gram["plain_ms"],
        "bound_ms": bf16_gram["bound_ms"],
        "bound_by": bf16_gram["bound_by"],
        "library_ms": bf16_gram["library_ms"],
        "bound_share": bf16_gram["bound_share"],
        "times": {k: bf16_gram[k] for k in ("timing", "calls_timed", "pass1_ms", "pass2_ms",
                                            "event_ms", "host_ms", "l2_flushed")},
        "shape": {"B": bf16_gram["B"], "Ds": bf16_gram["Ds"], "Dt": bf16_gram["Dt"]},
        "per_shape": bf16_kernels_k5_k2["grams"],
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
        # the bf16 conv tile's routes at the step's launches and the step's sums
        if k["name"] == "conv3x3_fwd_bf16":
            k.update(routes={"fwd": bf16_conv_sums["fwd"]["routes"],
                             "dx": bf16_conv_sums["dx"]["routes"]},
                     step=bf16_conv_sums["fwd"], step_dx=bf16_conv_sums["dx"])
        if k["name"] == "conv3x3_wgrad_bf16":
            k.update(routes=bf16_conv_sums["wgrad"]["routes"], step=bf16_conv_sums["wgrad"])
        # the bf16 K4's sums over the kernel-config step's fuses
        if k["name"] in ("attfuse_fwd_bf16", "attfuse_bwd_bf16"):
            k.update(step=bf16_fuse_sums[k["name"].split("_")[1]])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["parallel-worker"]:
        parallel_worker(sys.argv[2:])
    else:
        main()
