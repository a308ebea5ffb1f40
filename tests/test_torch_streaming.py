"""The port's StreamingEnhancer against the JAX one on the r4 student bundle."""

from pathlib import Path

import numpy as np
import pytest

from speech_enhancement_clskd_tpu.eval.streaming import StreamingEnhancer as JaxStreamingEnhancer
from speech_enhancement_clskd_tpu.utils.serialization import load_bundle as jax_load_bundle
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
from speech_enhancement_clskd_tpu_torch.utils.bridge import torch_state_from_flax
from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle
from torch_oracle import one_cpu_thread

BUNDLE = str(Path(__file__).resolve().parents[1] / "artifacts/r4_distill/the_best_model.npz")
# f32 both sides; the offline forward on this bundle agrees to 2e-7
ATOL = 1e-6


@pytest.fixture(scope="module")
def engines():
    jax_cfg, variables, _ = jax_load_bundle(BUNDLE)
    cfg, _, _ = load_bundle(BUNDLE)
    kw = dict(chunk_frames=48, context_frames=64)
    return (JaxStreamingEnhancer(jax_cfg, variables, **kw),
            StreamingEnhancer(cfg, torch_state_from_flax(variables), device="cpu", **kw))


def test_stream_matches_jax_batch1_odd_length(engines):
    jax_eng, eng = engines
    wav = SyntheticEnhancementDataset(size=1, segment=2.0, seed=11)[0][0][:31234]
    want = jax_eng.stream(wav)
    got = eng.stream(wav)
    assert got.shape == want.shape == wav.shape
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_stream_matches_jax_batch2(engines):
    jax_eng, eng = engines
    ds = SyntheticEnhancementDataset(size=2, segment=1.5, seed=12)
    batch = np.stack([ds[0][0], ds[1][0]])[:, :20001]
    want = jax_eng.stream(batch)
    got = eng.stream(batch)
    assert got.shape == want.shape == batch.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_latency_and_window_match_jax(engines):
    jax_eng, eng = engines
    assert eng.window_samples == jax_eng.window_samples == (64 + 48) * 100 + 300
    assert eng.latency_samples == jax_eng.latency_samples == 5100
    assert eng.latency_ms == pytest.approx(318.75)
