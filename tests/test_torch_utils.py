"""The port's small utilities against the JAX package's (a port of
``tests/test_utils.py``): the statistics and index pickers
(``utils/stats.py``), the plots (``utils/plotting.py``, matplotlib imported
inside them), the progress bar (``utils/progress.py``), the ``.npy`` pair
dataset and the synthetic set's ``hard`` profile; the config's
``to_yaml``, ``DCCRNConfig.hidden_freq`` and ``DCCRNConfig.scaled``; and
``utils/observability.py``'s ``StepTimer`` (its summary on the same
recorded times) and ``trace`` (a Chrome trace file).
"""

import dataclasses
import io
import json
import time

import numpy as np
import pytest

from speech_enhancement_clskd_tpu import config as jax_config
from speech_enhancement_clskd_tpu.utils import plotting as jax_plotting
from speech_enhancement_clskd_tpu.utils import stats as jax_stats
from speech_enhancement_clskd_tpu.utils.observability import StepTimer as JaxStepTimer
from speech_enhancement_clskd_tpu_torch import config
from speech_enhancement_clskd_tpu_torch.data.npy_dataset import WaveDataset
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.utils.plotting import (
    plot_error_to_numpy,
    plot_mask_to_numpy,
    plot_spectrogram_to_numpy,
)
from speech_enhancement_clskd_tpu_torch.utils.observability import StepTimer, trace
from speech_enhancement_clskd_tpu_torch.utils.progress import Bar
from speech_enhancement_clskd_tpu_torch.utils.stats import (
    get_mu_sig,
    max_index,
    min_index,
    near_avg_index,
)
from torch_oracle import one_cpu_thread


def test_mu_sig(rng):
    d = [rng.standard_normal((100, 4)).astype(np.float32) * 3 + 1]
    mu, sig = get_mu_sig(d)
    np.testing.assert_allclose(np.float32(mu), d[0].mean(0), atol=1e-2)
    np.testing.assert_allclose(np.float32(sig), d[0].std(0), atol=2e-2)
    jmu, jsig = jax_stats.get_mu_sig(d)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sig, jsig)
    # unit-variance flooring
    _, sig2 = get_mu_sig([np.ones((50, 2), np.float32)])
    np.testing.assert_array_equal(np.float32(sig2), [1.0, 1.0])


def test_index_pickers():
    a = [1.0, 5.0, 3.0, 5.0, 2.0]
    assert near_avg_index(a) == 2  # mean 3.2 -> closest 3.0
    assert max_index(a) == 3  # the last max, as the reference picks it
    assert min_index(a) == 0
    for fn in ("near_avg_index", "max_index", "min_index"):
        assert globals()[fn](a) == getattr(jax_stats, fn)(a)


def test_plotting(rng):
    wav = rng.standard_normal(8000).astype(np.float32) * 0.3
    img = plot_spectrogram_to_numpy(wav)
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jax_plotting.plot_spectrogram_to_numpy(wav))
    mask = rng.random((100, 257)).astype(np.float32)
    assert plot_mask_to_numpy(mask).ndim == 3
    assert plot_error_to_numpy(wav, wav * 0.5).ndim == 3


def test_progress_bar():
    buf = io.StringIO()
    items = list(Bar(range(5), batch_size=2, out=buf))
    assert items == [0, 1, 2, 3, 4]
    s = buf.getvalue()
    assert "10/10" in s and "ETA" in s


def test_npy_dataset(tmp_path, rng):
    pairs = np.array([[rng.standard_normal(100).astype(np.float32),
                       rng.standard_normal(100).astype(np.float32)] for _ in range(4)])
    p = str(tmp_path / "train_dataset.npy")
    np.save(p, pairs)
    ds = WaveDataset(p)
    assert len(ds) == 4
    noisy, clean = ds[1]
    assert noisy.shape == (100,) and clean.shape == (1, 100)
    np.testing.assert_array_equal(noisy, pairs[1][0])


def test_synthetic_hard_profile():
    a = SyntheticEnhancementDataset(size=4, segment=0.5, seed=3)
    b = SyntheticEnhancementDataset(size=4, segment=0.5, seed=3, profile="default")
    np.testing.assert_array_equal(a[1][0], b[1][0])
    hard = SyntheticEnhancementDataset(size=16, segment=0.5, seed=5, profile="hard")
    base = SyntheticEnhancementDataset(size=16, segment=0.5, seed=5)
    differ = 0
    for i in range(16):
        mix, src = hard[i]
        assert np.isfinite(mix).all() and np.abs(mix).max() <= 1.0 + 1e-6
        differ += not np.array_equal(mix, base[i][0])
    assert differ >= 12
    with pytest.raises(ValueError):
        SyntheticEnhancementDataset(profile="nonsense")


def test_config_to_yaml_and_geometry_helpers(tmp_path):
    """``to_yaml`` writes what the JAX one writes and ``load_config`` reads
    it back; ``hidden_freq`` and ``scaled`` give the JAX values."""
    import yaml

    overrides = ["optim.lr=1e-3", "teacher.kernel_num=[8,16,32]"]
    cfg = config.load_config(None, overrides)
    text = config.to_yaml(cfg)
    ours = yaml.safe_load(text)
    theirs = yaml.safe_load(jax_config.to_yaml(jax_config.load_config(None, overrides)))
    assert ours == theirs
    (tmp_path / "cfg.yaml").write_text(text)
    assert config.load_config(str(tmp_path / "cfg.yaml")) == cfg
    for t, jt in ((config.TEACHER, jax_config.TEACHER), (config.STUDENT, jax_config.STUDENT)):
        assert t.hidden_freq == jt.hidden_freq
        s, js = t.scaled(4), jt.scaled(4)
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
        assert s.name == f"{t.name}-div4" and t.scaled(2, name="half").name == "half"


@pytest.mark.parametrize("n", [0, 1, 7, 100])
def test_step_timer_summary_matches_jax(monkeypatch, n):
    """The same recorded step times (a clock that moves by given amounts
    between ``start`` and ``stop``) give the JAX class's summary, key for
    key; ``step()`` times the block; nothing is recorded before a start."""
    rng = np.random.default_rng(n)
    durations = rng.exponential(0.05, n)
    # the clock at each start and stop: a gap, then the step's duration
    ticks = np.cumsum(np.stack([rng.random(n), durations], 1).ravel())
    timers = (StepTimer(), JaxStepTimer())
    for t in timers:
        t.stop()  # no start: nothing recorded
    for t in timers:
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        for _ in range(n):
            with t.step():
                pass
    got, want = (t.summary() for t in timers)
    assert got == want
    if n:
        assert set(got) == {"steps", "mean_s", "p50_s", "p90_s", "p99_s"}
        assert got["steps"] == n
        np.testing.assert_allclose(got["mean_s"], durations.mean(), rtol=1e-9)
    else:
        assert got == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
