"""The port's offline evaluation against the JAX package on the CPU:
BSS-Eval and SI-SDR (the same numpy, exact), PESQ (the same C++ source and
flags, the same bits), word error rate and the WER trackers, the metric
bundles (STOI to 1e-5, 2e-5 where the JAX float32 STOI parts from the
port's by more; the rest exact), ``evaluate_model`` over utterances
of unequal lengths (bucket padding) with and without the reference's batch
statistics, the ``evaluate`` CLI, the card default, and chip_smoke.py's
phase 22 rehearsed at tiny widths."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu import cli as jax_cli
from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.eval import evaluate_model as jax_evaluate_model
from speech_enhancement_clskd_tpu.metrics import bss as jax_bss
from speech_enhancement_clskd_tpu.metrics import wer as jax_wer
from speech_enhancement_clskd_tpu.metrics.pesq import pesq_wb as jax_pesq_wb
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu.utils.serialization import save_bundle as jax_save_bundle
from speech_enhancement_clskd_tpu_torch import cli
from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.data.wav import read_wav
from speech_enhancement_clskd_tpu_torch.eval import evaluate_model
from speech_enhancement_clskd_tpu_torch.metrics import bss, wer
from speech_enhancement_clskd_tpu_torch.metrics.pesq import pesq_wb
from speech_enhancement_clskd_tpu_torch.metrics.stoi import stoi_batch
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.utils.bridge import flax_from_torch_state
from speech_enhancement_clskd_tpu_torch.utils.serialization import save_bundle
from torch_oracle import jitted_jax_stoi, once_per_session, one_cpu_thread

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", kernel_num=(4, 8, 8), rnn_units=16)
# STOI on the device path against the JAX one: float32 on both sides
STOI_ATOL = 1e-5
# evaluate_model against JAX: the estimates differ by float32 rounding
# (~1e-7), which moves SI-SDR/SDR/SAR by ~1e-5 dB and PESQ by ~1e-5
DB_ATOL, PESQ_ATOL = 1e-4, 1e-3
# an example estimate's PCM16 read back: one quantization step
WAV_ATOL = 1.0 / 32768 + 1e-9
# 0.6-0.9 s, each padded to the 1 s bucket by another amount (one bucket:
# the JAX harness compiles its forward once a bucket and mode)
BUCKET_S = 0.5
LENGTHS = (9600 + 37, 12000 + 401, 14400 + 503)


def _pair(n, seed, noise=0.3):
    """(clean, noisy) [n]: synthetic speech and white noise at ``noise`` of
    its level."""
    clean = SyntheticEnhancementDataset(size=1, segment=n / 16000 + 0.01, seed=seed)[0][1][0, :n]
    rng = np.random.default_rng(seed)
    scale = noise * np.sqrt(np.mean(clean ** 2))
    return clean, (clean + scale * rng.standard_normal(n)).astype(np.float32)


def test_bss_eval_and_si_sdr_exact():
    clean, noisy = _pair(4000, 0)
    est = (0.8 * clean + 0.1 * noisy).astype(np.float32)
    assert bss.bss_eval_single(clean, est) == jax_bss.bss_eval_single(clean, est)
    assert bss.si_sdr_np(clean, est) == jax_bss.si_sdr_np(clean, est)
    rng = np.random.default_rng(1)
    refs = rng.standard_normal((2, 3000))
    ests = refs + 0.3 * refs[::-1] + 0.1 * rng.standard_normal((2, 3000))
    got, want = bss.bss_eval_sources(refs, ests), jax_bss.bss_eval_sources(refs, ests)
    assert set(got) == set(want) == {"sdr", "sir", "sar"}
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n,noise", [(16000, 0.1), (24000 + 17, 0.5)])
def test_pesq_wb_same_bits(n, noise):
    clean, noisy = _pair(n, 2, noise)
    got = pesq_wb(clean, noisy)
    assert got == jax_pesq_wb(clean, noisy) and 1.0 <= got <= 4.7


@pytest.mark.parametrize("ref,hyp,rate", [
    ("a b c", "a b c", 0.0), ("a b c", "a x c", 1 / 3), ("a b c", "", 1.0),
    ("", "", 0.0), ("", "a", 1.0), ("the cat sat", "the cat sat down", 1 / 3),
    ("a b", "b a", 1.0), ("one two three four", "one three four five", 0.5)])
def test_word_error_rate(ref, hyp, rate):
    assert wer.word_error_rate(ref, hyp) == jax_wer.word_error_rate(ref, hyp)
    assert wer.word_error_rate(ref, hyp) == pytest.approx(rate, abs=1e-12)


def test_wer_trackers():
    assert wer.MockWERTracker()(mix=0) == {} and wer.MockWERTracker().final_report_as_markdown() == ""
    asr = lambda x, sr: " ".join("loud" if v > 0 else "soft" for v in x[:4])
    x = np.array([0.5, -0.2, 0.1, 0.3], np.float32)
    kw = dict(mix=x, clean=x, estimate=-x, sample_rate=16000, wav_id="u1")
    ours, theirs = wer.WERTracker(asr, {"u1": "Loud Soft Loud Loud"}), jax_wer.WERTracker(
        asr, {"u1": "Loud Soft Loud Loud"})
    assert ours(**kw) == theirs(**kw) == {"wer": 0.75}  # a deletion and two substitutions
    assert ours(**dict(kw, wav_id=None)) == theirs(**dict(kw, wav_id=None))
    assert ours.final_report_as_markdown() == theirs.final_report_as_markdown()


def _check_metrics(got, want, stoi_atol=STOI_ATOL):
    assert list(got) == list(want)
    for k, w in want.items():
        if k.endswith("stoi"):
            assert abs(got[k] - w) <= stoi_atol, (k, got[k], w)
        else:
            assert got[k] == w, (k, got[k], w)


def _single():
    clean, mix = _pair(20000, 3)
    return mix, clean, (0.7 * clean + 0.3 * (mix - clean) * 0.2).astype(np.float32)


def _sources():
    c0, m0 = _pair(16000, 4)
    c1, _ = _pair(16000, 5)
    c1 = np.roll(c1, 3000) * 0.7
    sources = np.stack([c0, c1]).astype(np.float32)
    mix = (m0 + c1).astype(np.float32)
    ests = (sources + 0.05 * np.random.default_rng(6).standard_normal(sources.shape)).astype(
        np.float32)
    return mix, sources, ests


@pytest.fixture(scope="module")
def jax_metrics(tmp_path_factory):
    """The JAX metric bundles on ``_single`` and ``_sources``, computed once
    per session."""
    def compute():
        with jitted_jax_stoi():
            return {"single": jax_bss.eval_metrics(*_single()),
                    "sources": jax_bss.eval_metrics_sources(*_sources())}

    return once_per_session(tmp_path_factory, "jax-eval-metrics", compute)


@pytest.mark.parametrize("inputs", ["numpy", "torch"])
def test_eval_metrics_matches_jax(jax_metrics, inputs):
    mix, clean, est = _single()
    want = jax_metrics["single"]
    args = (mix, clean, est) if inputs == "numpy" else tuple(map(torch.from_numpy, (mix, clean, est)))
    timings = {}
    got = bss.eval_metrics(*args, timings=timings)
    assert "pesq" in got and "input_pesq" in got and got["sir"] == float("inf")
    _check_metrics(got, want)
    assert set(timings) == {"stoi", "bss", "pesq"}


def test_eval_metrics_sources_matches_jax(jax_metrics):
    mix, sources, ests = _sources()
    want = jax_metrics["sources"]
    got = bss.eval_metrics_sources(mix, sources, torch.from_numpy(ests))
    # on these two sources the JAX float32 STOI's mean parts from the
    # port's by 1.1e-5 (measured), while the port's float32 STOI lies within
    # 1e-6 of its float64 value (held below): the mean is held to 2e-5
    _check_metrics(got, want, stoi_atol=2 * STOI_ATOL)
    ms = np.stack([mix, mix])
    f32 = stoi_batch(torch.from_numpy(sources), torch.from_numpy(ms)).numpy()
    f64 = stoi_batch(torch.from_numpy(sources).double(), torch.from_numpy(ms).double()).numpy()
    assert np.abs(f32 - f64).max() <= 1e-6
    assert abs(got["input_stoi"] - float(np.mean(f32))) <= 1e-6


def _tiny_bundle():
    cfg = JaxDCCRNConfig(**TINY)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: jax_make_model(cfg).init(
        k, jnp.zeros((1, 1600)), training=True))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    variables["batch_stats"] = jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    return once_per_session(tmp_path_factory, "evaluate-tiny-bundle", _tiny_bundle)


def _dataset():
    ds = SyntheticEnhancementDataset(size=len(LENGTHS), segment=1.5, seed=11)
    return [(ds[i][0][:n], ds[i][1][:, :n], f"utt{i}") for i, n in enumerate(LENGTHS)]


def _evaluate(fn, directory, variables, **kw):
    out = Path(directory)
    summary = fn(TINY_CFG[fn is jax_evaluate_model], variables, _dataset(), bucket_s=BUCKET_S,
                 ex_save_dir=str(out / "ex"), results_path=str(out / "summary.json"),
                 per_utt_path=str(out / "rows.jsonl"), log_fn=lambda *_: None, **kw)
    rows = [json.loads(line) for line in (out / "rows.jsonl").read_text().splitlines()]
    wavs = {str(f.relative_to(out / "ex")): read_wav(str(f))[0]
            for f in sorted((out / "ex").rglob("*.wav"))}
    return {"summary": summary, "rows": rows, "wavs": wavs,
            "written": json.loads((out / "summary.json").read_text())}


TINY_CFG = {True: JaxDCCRNConfig(**TINY), False: DCCRNConfig(**TINY)}


def _close(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, str) or np.isinf(w):
            assert got[k] == w, k
            continue
        tol = STOI_ATOL if k.startswith(("stoi", "input_stoi")) else (
            PESQ_ATOL if "pesq" in k else DB_ATOL)
        assert abs(got[k] - w) <= tol, (k, got[k], w)


@pytest.mark.parametrize("bn_batch_stats", [None, True])
def test_evaluate_model_matches_jax(tmp_path_factory, tmp_path, tiny_bundle, bn_batch_stats):
    """3 utterances of unequal lengths, each padded to its bucket: the
    summary, every row and the example wavs against the JAX harness."""
    variables = tiny_bundle
    def compute():  # both modes in one oracle, sharing the STOI compiles
        with jitted_jax_stoi():
            return {bn: _evaluate(jax_evaluate_model, tmp_path_factory.mktemp("jax_eval"),
                                  variables, bn_batch_stats=bn) for bn in (None, True)}

    want = once_per_session(tmp_path_factory, "evaluate-model", compute)[bn_batch_stats]
    got = _evaluate(evaluate_model, tmp_path, variables, bn_batch_stats=bn_batch_stats,
                    device="cpu")
    _close(got["summary"], want["summary"])
    assert got["written"] == got["summary"] and "pesq_imp" in got["summary"]
    assert len(got["rows"]) == len(LENGTHS)
    for g, w in zip(got["rows"], want["rows"]):
        _close(g, w)
    assert list(got["wavs"]) == list(want["wavs"]) and len(got["wavs"]) == 3 * len(LENGTHS)
    for name, w in want["wavs"].items():
        assert got["wavs"][name].shape == w.shape, name
        err = np.abs(got["wavs"][name] - w).max()
        assert err <= (WAV_ATOL if name.endswith("estimate.wav") else 0.0), (name, err)


def test_cli_evaluate_matches_jax(tmp_path_factory, tmp_path, tiny_bundle):
    """Both ``evaluate`` CLIs on one tiny bundle over the synthetic test
    set, without PESQ: the summary and the per-utterance rows."""
    bundle = str(tmp_path / "tiny.npz")
    jax_save_bundle(bundle, tiny_bundle["params"], tiny_bundle["batch_stats"],
                    JaxDCCRNConfig(**TINY))
    args = ["--no-pesq", "data.synthetic=true", "data.synthetic_size=2", "data.segment=0.75"]

    def run(main, out, extra=()):
        results = str(Path(out) / "m.json")
        assert main(["evaluate", "--bundle", bundle, "--results", results, *extra, *args]) == 0
        rows = Path(out) / "m_per_utt.jsonl"
        return json.loads(Path(results).read_text()), [
            json.loads(line) for line in rows.read_text().splitlines()]

    def compute():
        with jitted_jax_stoi():
            return run(jax_cli.main, tmp_path_factory.mktemp("jax_cli"))

    want = once_per_session(tmp_path_factory, "evaluate-cli", compute)
    got = run(cli.main, tmp_path, ("--device", "cpu"))
    _close(got[0], want[0])
    assert "pesq" not in got[0] and len(got[1]) == 2
    for g, w in zip(got[1], want[1]):
        _close(g, w)


def test_evaluate_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = TINY_CFG[False]
    variables = flax_from_torch_state(make_model(cfg, device="cpu").state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_model(cfg, variables, _dataset()[:1])  # the card by default
    bundle = str(tmp_path / "tiny.npz")
    save_bundle(bundle, variables["params"], variables["batch_stats"], cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["evaluate", "--bundle", bundle, "--results", str(tmp_path / "m.json"),
                  "data.synthetic=true", "data.synthetic_size=1", "data.segment=0.5"])


def test_chip_smoke_evaluation_phase_rehearsed_on_the_cpu(tmp_path, tiny_bundle):
    """chip_smoke.py's phase 22 checks at tiny widths on the CPU, CPU
    against CPU: no failure, zero errors, every example wav read back."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = _dataset()[:2]
    rec = smoke.evaluation_checks(TINY_CFG[False], tiny_bundle, data, "cpu", str(tmp_path),
                                  bn_batch_stats=True)
    assert rec["failures"] == []
    assert rec["summary_err"] == rec["row_err"] == {"same_keys": True, "stoi": 0.0, "db": 0.0,
                                                    "pesq": 0.0}
    assert rec["estimate_wav_max_abs_diff"] == 0.0 and rec["wavs_read_back"] == 6
    assert set(rec["ms_per_utterance"]) == {"forward", "stoi", "bss", "pesq"}
    assert rec["lstm_launches"] == 0 and "pesq" in rec["summary"]
