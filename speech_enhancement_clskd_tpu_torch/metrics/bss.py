"""BSS-Eval metrics (SDR/SIR/SAR) and the evaluation metric bundle.

Copy of ``speech_enhancement_clskd_tpu/metrics/bss.py``: the asteroid
``get_metrics`` surface of the reference's eval loop (si_sdr, sdr, sir,
sar, stoi, pesq and their ``input_*`` baselines).

``bss_eval_single`` is bss_eval_sources for one reference source (mir_eval
semantics): the target projection allows a 512-tap distortion filter,
estimated by a Toeplitz least-squares solve on the host (scipy); with one
source there is no interference, so SIR = inf and SDR = SAR.  The BSS and
SI-SDR parts are numpy host code, as in the JAX package.

``eval_metrics``/``eval_metrics_sources`` take numpy arrays or torch
tensors.  STOI runs through ``metrics.stoi.stoi_batch`` on the device of
the estimate (a CUDA tensor keeps it on the card); the waveforms then go to
the host once for BSS and PESQ.  PESQ raises where its library cannot be
built: ``compute_pesq=False`` skips it.  ``timings``, where given, gathers
host seconds per stage (``stoi``, ``bss``, ``pesq``; STOI's ended by a
device sync).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
from scipy.linalg import solve_toeplitz
from scipy.signal import fftconvolve

from .stoi import stoi_batch

FILT_LEN = 512


def _project(ref: np.ndarray, est: np.ndarray, flen: int = FILT_LEN) -> np.ndarray:
    """Least-squares projection of est onto {ref * h : h has flen taps}."""
    n = len(est)
    # autocorrelation of ref (first flen lags) and cross-correlation
    acorr = fftconvolve(ref, ref[::-1], mode="full")
    mid = len(ref) - 1
    r = acorr[mid : mid + flen].copy()
    r[0] += 1e-10
    xcorr = fftconvolve(est, ref[::-1], mode="full")
    b = xcorr[mid : mid + flen]
    h = solve_toeplitz(r, b)
    proj = fftconvolve(ref, h, mode="full")[:n]
    return proj


def bss_eval_single(ref: np.ndarray, est: np.ndarray) -> Dict[str, float]:
    """SDR/SIR/SAR for one reference source (mir_eval bss_eval_sources)."""
    ref = np.asarray(ref, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    s_target = _project(ref, est)
    e_artif = est - s_target
    num = np.sum(s_target**2)
    den = np.sum(e_artif**2)
    sdr = 10 * np.log10(num / (den + 1e-12) + 1e-12)
    return {"sdr": float(sdr), "sir": float("inf"), "sar": float(sdr)}


def bss_eval_sources(refs: np.ndarray, ests: np.ndarray) -> Dict[str, np.ndarray]:
    """Full multi-source bss_eval_sources (mir_eval semantics) for matched
    (ref_j, est_j) pairs: inputs [n_src, T], already PIT-reordered.

    Decomposition per estimate j (512-tap allowed distortions):
      s_target = P_{ref_j}(est_j)
      e_interf = P_{all refs}(est_j) - s_target
      e_artif  = est_j - P_{all refs}(est_j)
      SDR = 10log10 |s_target|^2 / |e_interf + e_artif|^2
      SIR = 10log10 |s_target|^2 / |e_interf|^2
      SAR = 10log10 |s_target + e_interf|^2 / |e_artif|^2
    """
    refs = np.asarray(refs, np.float64)
    ests = np.asarray(ests, np.float64)
    n_src, T = refs.shape
    if n_src == 1:
        b = bss_eval_single(refs[0], ests[0])
        return {k: np.asarray([v]) for k, v in b.items()}

    flen = FILT_LEN
    # Gram matrix of all lagged refs: G[(i,tau),(j,tau')] = <ref_i(.-tau), ref_j(.-tau')>
    G = np.zeros((n_src * flen, n_src * flen))
    for i in range(n_src):
        for j in range(n_src):
            cc = fftconvolve(refs[i], refs[j][::-1], mode="full")
            mid = T - 1
            # G[(i,tau),(j,tau')] = sum_v ref_i(v) ref_j(v + tau - tau')
            #                     = cc_ij[mid + tau' - tau]
            blk = np.empty((flen, flen))
            for tau in range(flen):
                blk[tau] = cc[mid - tau + np.arange(flen)]
            G[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = blk
    G += 1e-10 * np.eye(n_src * flen)

    sdr = np.empty(n_src)
    sir = np.empty(n_src)
    sar = np.empty(n_src)
    for j in range(n_src):
        est = ests[j]
        s_target = _project(refs[j], est)
        # projection onto span of ALL refs' lag spaces
        d = np.concatenate(
            [
                fftconvolve(est, refs[i][::-1], mode="full")[T - 1 : T - 1 + flen]
                for i in range(n_src)
            ]
        )
        h = np.linalg.solve(G, d)
        p_all = np.zeros(T)
        for i in range(n_src):
            p_all += fftconvolve(refs[i], h[i * flen : (i + 1) * flen],
                                 mode="full")[:T]
        e_interf = p_all - s_target
        e_artif = est - p_all
        eps = 1e-12
        sdr[j] = 10 * np.log10(
            np.sum(s_target**2) / (np.sum((e_interf + e_artif) ** 2) + eps) + eps
        )
        sir[j] = 10 * np.log10(
            np.sum(s_target**2) / (np.sum(e_interf**2) + eps) + eps
        )
        sar[j] = 10 * np.log10(
            np.sum((s_target + e_interf) ** 2) / (np.sum(e_artif**2) + eps) + eps
        )
    return {"sdr": sdr, "sir": sir, "sar": sar}


def si_sdr_np(ref: np.ndarray, est: np.ndarray, eps: float = 1e-12) -> float:
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    alpha = np.dot(ref, est) / (np.dot(ref, ref) + eps)
    proj = alpha * ref
    noise = est - proj
    return float(10 * np.log10(np.sum(proj**2) / (np.sum(noise**2) + eps) + eps))


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Stage:
    """Adds a stage's host seconds to ``timings`` (if given), after a
    device sync for a CUDA device."""

    def __init__(self, timings: Optional[Dict[str, float]], name: str, device: torch.device):
        self.timings, self.name, self.device = timings, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.timings is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[self.name] = (self.timings.get(self.name, 0.0)
                                       + time.perf_counter() - self.t0)


def _stoi_pair(refs, mix_stack, ests, sample_rate: int, device: torch.device) -> np.ndarray:
    """STOI of the mixture and of the estimates against ``refs`` [n, T] in
    one batched call on ``device``: numpy [2, n]."""
    r = _tensor(refs, device)
    d = torch.cat([_tensor(mix_stack, device), _tensor(ests, device)])
    return _host(stoi_batch(torch.cat([r, r]), d, fs=sample_rate)).reshape(2, -1)


def eval_metrics_sources(
    mix,
    sources,
    ests,
    sample_rate: int = 16000,
    compute_pesq: bool = True,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Multi-source per-utterance metrics, averaged over sources (asteroid
    ``get_metrics(average=True)``).  ``sources``/``ests``: [n_src, T], ests
    already PIT-reordered (``losses.pit.pit_reorder``).  input_* metrics use
    the mixture as the estimate of every source."""
    n_src = sources.shape[0]
    if n_src == 1:
        return eval_metrics(mix, sources[0], ests[0], sample_rate,
                            compute_pesq=compute_pesq, timings=timings)
    dev = _device_of(ests)
    with _Stage(timings, "stoi", dev):
        mix_t = _tensor(mix, dev)
        s = _stoi_pair(sources, mix_t.expand(n_src, -1), ests, sample_rate, dev)
    mix, sources, ests = _host(mix), _host(sources), _host(ests)
    out: Dict[str, float] = {}
    mix_stack = np.broadcast_to(mix, sources.shape)
    with _Stage(timings, "bss", dev):
        for row, (name, deg) in enumerate((("input_", mix_stack), ("", ests))):
            out[name + "si_sdr"] = float(
                np.mean([si_sdr_np(sources[j], deg[j]) for j in range(n_src)])
            )
            b = bss_eval_sources(sources, deg)
            out[name + "sdr"] = float(np.mean(b["sdr"]))
            out[name + "sir"] = float(np.mean(b["sir"]))
            out[name + "sar"] = float(np.mean(b["sar"]))
            out[name + "stoi"] = float(np.mean(s[row]))
    if compute_pesq:
        from .pesq import pesq_wb

        with _Stage(timings, "pesq", dev):
            out["input_pesq"] = float(
                np.mean([pesq_wb(sources[j], mix, sample_rate) for j in range(n_src)]))
            out["pesq"] = float(
                np.mean([pesq_wb(sources[j], ests[j], sample_rate) for j in range(n_src)]))
    return out


def eval_metrics(
    mix,
    clean,
    est,
    sample_rate: int = 16000,
    compute_pesq: bool = True,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Per-utterance metric dict with input_* baselines (asteroid
    get_metrics behaviour).  All inputs [T]."""
    dev = _device_of(est)
    with _Stage(timings, "stoi", dev):
        s = _stoi_pair(_tensor(clean, dev)[None], _tensor(mix, dev)[None],
                       _tensor(est, dev)[None], sample_rate, dev)
    mix, clean, est = _host(mix), _host(clean), _host(est)
    out: Dict[str, float] = {}
    with _Stage(timings, "bss", dev):
        for row, (name, deg) in enumerate((("input_", mix), ("", est))):
            out[name + "si_sdr"] = si_sdr_np(clean, deg)
            b = bss_eval_single(clean, deg)
            out[name + "sdr"] = b["sdr"]
            out[name + "sir"] = b["sir"]
            out[name + "sar"] = b["sar"]
            out[name + "stoi"] = float(s[row, 0])
    if compute_pesq:
        from .pesq import pesq_wb

        with _Stage(timings, "pesq", dev):
            out["input_pesq"] = pesq_wb(clean, mix, sample_rate)
            out["pesq"] = pesq_wb(clean, est, sample_rate)
    return out
