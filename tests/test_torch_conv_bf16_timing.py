"""The CPU side of the bf16 conv tile's card measurements: chip_smoke.py's
phase-17 sums over the kernel-config step (each step shape weighted by its
launches, the routes counted), and the bit hashes that
scripts/kernel_pair_timing.py compares between two trees.  Imports no JAX."""

import importlib.util
import hashlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke_sums", ROOT / "chip_smoke.py")


def _records(smoke):
    """Phase 17's timed records at each distinct step shape, forward and dx,
    with times that name their shape and routes as the bf16 entry names
    them."""
    recs = []
    for D, C, O in dict.fromkeys(smoke.STEP_CONV_FWD):
        for dx, (ci, co) in ((False, (C, O)), (True, (O, C))):
            narrow = min(ci, co) < 8
            recs.append({"B": smoke.TEACHER_BATCH, "D": D, "T": 483, "C": ci, "O": co,
                         "pass": "dx" if dx else "fwd",
                         "fwd_route": "fma" if narrow else "wgmma",
                         "wgrad_route": "narrow" if co <= 8 else "wgmma",
                         "fwd_ms": D + ci / 1000, "fwd_library_ms": 2.0 * D,
                         "fwd_bound_ms": D / 10, "wgrad_ms": 3.0 * D + co / 1000,
                         "wgrad_library_ms": 4.0 * D, "wgrad_bound_ms": D / 20})
    # an untimed record of the same shape (phase 8's) is not counted
    recs.append({**recs[0], "fwd_ms": None})
    del recs[-1]["fwd_ms"]
    return recs


def test_phase17_step_sums_weight_each_shape_by_its_launches(smoke):
    sums = smoke._bf16_conv_step_sums(_records(smoke))
    steps = smoke.STEP_CONV_FWD
    assert {k: sums[k]["launches"] for k in sums} == {"fwd": 12, "dx": 12, "wgrad": 12}
    assert sums["fwd"]["ms"] == pytest.approx(sum(D + C / 1000 for D, C, O in steps))
    assert sums["dx"]["ms"] == pytest.approx(sum(D + O / 1000 for D, C, O in steps))
    assert sums["wgrad"]["ms"] == pytest.approx(sum(3.0 * D + O / 1000 for D, C, O in steps))
    assert sums["fwd"]["library_ms"] == pytest.approx(sum(2.0 * D for D, _, _ in steps))
    assert sums["wgrad"]["bound_ms"] == pytest.approx(sum(D / 20 for D, _, _ in steps))
    # the mask block (O = 2) is the one FMA forward, FMA dx pass and narrow
    # weight gradient a step; every other launch is on route "wgmma"
    assert sums["fwd"]["routes"] == {"wgmma": 11, "mma": 0, "fma": 1, "narrow": 0}
    assert sums["dx"]["routes"] == {"wgmma": 11, "mma": 0, "fma": 1, "narrow": 0}
    assert sums["wgrad"]["routes"] == {"wgmma": 11, "mma": 0, "fma": 0, "narrow": 1}


def test_phase17_step_sums_need_every_step_shape(smoke):
    recs = [r for r in _records(smoke) if not (r["D"] == 32 and r["pass"] == "dx")]
    with pytest.raises(StopIteration):
        smoke._bf16_conv_step_sums(recs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pair_timing_hashes_the_bits(dtype):
    timing = _load("pair_timing_bits", ROOT / "scripts" / "kernel_pair_timing.py")
    t = torch.linspace(-3, 3, 37).to(dtype)
    want = hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
    assert timing._bits(t) == want
    assert timing._bits(t, None) == want
    flipped = t.clone()
    flipped.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)[5] ^= 1
    assert timing._bits(flipped) != want
