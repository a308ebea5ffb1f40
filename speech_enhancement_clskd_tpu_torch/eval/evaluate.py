"""Offline evaluation (the reference's eval.py).

Port of ``speech_enhancement_clskd_tpu/eval/evaluate.py``: loads a student,
runs full-length utterances, PIT-reorders the estimates against the
reference sources (identity for one source), computes per-utterance metrics
(si_sdr/sdr/sir/sar/stoi[/pesq]) with their input_* baselines, writes one
JSON row per utterance, the summary JSON (means of the finite values and
``*_imp`` improvement deltas) and n random example wav triptychs
(mixture, s{i}, s{i}_estimate scaled to the mixture's peak).

Each utterance is zero-padded to the next multiple of ``bucket_s`` seconds
before the forward and the estimate cropped back, as the JAX package does:
the padding is part of the result (the convs and the iSTFT see the padded
tail), so the port pads exactly alike.  The forward runs on ``device``; STOI
runs there on the estimate, then the waveforms go to the host once per
utterance for BSS-Eval and PESQ.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ..config import DCCRNConfig
from ..data.wav import write_wav
from ..losses.pit import pit_reorder
from ..metrics.bss import eval_metrics_sources
from ..models.dccrn import make_model
from ..utils.bridge import torch_state_from_flax
from ..utils.serialization import load_bundle

COMPUTE_METRICS = ["si_sdr", "sdr", "sir", "sar", "stoi", "pesq"]


def _bucket_len(T: int, sr: int, bucket_s: float) -> int:
    b = int(bucket_s * sr)
    return -(-T // b) * b


def evaluate_model(
    cfg: DCCRNConfig,
    variables: Mapping[str, Any],
    dataset,
    sample_rate: int = 16000,
    n_save_ex: int = 5,
    ex_save_dir: Optional[str] = None,
    results_path: Optional[str] = None,
    bucket_s: float = 1.0,
    compute_pesq: bool = True,
    seed: int = 0,
    log_fn=print,
    bn_batch_stats: Optional[bool] = None,
    per_utt_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """``variables`` is the flax-layout tree ``{"params", "batch_stats"}``
    (``load_bundle``, ``models.dccrnet.params_from_asteroid_state_dict``).

    ``bn_batch_stats=True`` reproduces the reference eval quirk (its eval.py
    never calls ``model.eval()``, so BN normalizes with per-utterance batch
    statistics).  ``per_utt_path``: one JSON metric row per utterance.
    ``timings``, where given, gathers host seconds per stage (``forward``,
    ``stoi``, ``bss``, ``pesq``), each ended by a device sync.
    ``device="cuda"`` with no GPU raises."""
    model = make_model(cfg, device)
    model.load_state_dict(torch_state_from_flax(variables), strict=True)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def forward(mix_np: np.ndarray) -> torch.Tensor:
        """Model estimates on the device as [n_est, T] (single-output
        models give n_est = 1)."""
        T = len(mix_np)
        pad = np.zeros(_bucket_len(T, sample_rate, bucket_s), np.float32)
        pad[:T] = mix_np
        out = model(torch.from_numpy(pad[None]).to(dev), training=False,
                    bn_batch_stats=bn_batch_stats).wav[0, ..., :T]
        return out if out.ndim == 2 else out[None]

    save_idx = (
        set(random.Random(seed).sample(range(len(dataset)), min(n_save_ex, len(dataset))))
        if ex_save_dir
        else set()
    )

    per_utt_f = None
    if per_utt_path:
        os.makedirs(os.path.dirname(os.path.abspath(per_utt_path)), exist_ok=True)
        per_utt_f = open(per_utt_path, "w")

    rows: List[Dict[str, float]] = []
    try:
        for idx in range(len(dataset)):
            item = dataset[idx]
            mix, sources = np.asarray(item[0]), np.asarray(item[1])
            utt_id = item[2] if len(item) > 2 else str(idx)
            t0 = time.perf_counter()
            ests = forward(mix)
            if ests.shape[0] == sources.shape[0] and sources.shape[0] > 1:
                # PIT reorder before metrics (reference eval.py:67)
                ests, _ = pit_reorder(ests, torch.from_numpy(sources).to(dev))
            elif sources.shape[0] > 1:
                # single-output model on a multi-source task: score vs source 0
                sources = sources[:1]
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timings["forward"] = timings.get("forward", 0.0) + time.perf_counter() - t0
            m = eval_metrics_sources(mix, sources, ests, sample_rate,
                                     compute_pesq=compute_pesq, timings=timings)
            rows.append(m)
            if per_utt_f is not None:
                per_utt_f.write(json.dumps({"utt_id": str(utt_id), **m}) + "\n")
            if idx in save_idx:
                ests_np = ests.cpu().numpy()
                d = os.path.join(ex_save_dir, f"ex_{idx}")
                os.makedirs(d, exist_ok=True)
                write_wav(os.path.join(d, "mixture.wav"), mix, sample_rate)
                for j in range(sources.shape[0]):
                    write_wav(os.path.join(d, f"s{j}.wav"), sources[j], sample_rate)
                    # the estimate at the mixture's scale (asteroid
                    # normalize_estimates, eval.py:75)
                    est_j = ests_np[min(j, ests_np.shape[0] - 1)]
                    scale = np.max(np.abs(mix)) / (np.max(np.abs(est_j)) + 1e-8)
                    write_wav(os.path.join(d, f"s{j}_estimate.wav"), est_j * scale,
                              sample_rate)
            if (idx + 1) % 50 == 0:
                log_fn(f"eval {idx + 1}/{len(dataset)}")
    finally:
        if per_utt_f is not None:
            per_utt_f.close()

    final: Dict[str, float] = {}
    for name in COMPUTE_METRICS:
        vals = [r[name] for r in rows if name in r and np.isfinite(r[name])]
        ivals = [
            r["input_" + name]
            for r in rows
            if "input_" + name in r and np.isfinite(r["input_" + name])
        ]
        if not vals:
            continue
        final[name] = float(np.mean(vals))
        if ivals:
            final[name + "_imp"] = float(np.mean(vals) - np.mean(ivals))
    if results_path:
        os.makedirs(os.path.dirname(os.path.abspath(results_path)), exist_ok=True)
        with open(results_path, "w") as f:
            json.dump(final, f, indent=2)
    return final


def evaluate_bundle(bundle_path: str, dataset, **kw) -> Dict[str, float]:
    """Evaluate a native ``.npz`` bundle or an asteroid publishable torch
    ``.pth``/``.pt``/``.ckpt`` (reference distill.py:280-294 output).
    Keywords go to ``evaluate_model`` (``device`` among them)."""
    if bundle_path.endswith((".pth", ".pt", ".ckpt")):
        from ..models.dccrnet import read_reference_bundle

        cfg, variables, _ = read_reference_bundle(bundle_path)
    else:
        cfg, variables, _ = load_bundle(bundle_path)
    return evaluate_model(cfg, variables, dataset, **kw)
