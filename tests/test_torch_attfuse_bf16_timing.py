"""The CPU side of the bf16 attention fuse's card measurements:
chip_smoke.py's phase-17 sums of the bf16 K4f and K4b over the kernel-config
step, each step shape weighted by its launches.  Imports no JAX and runs no
kernel."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_fuse_sums", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(smoke):
    """Phase 17's fuse records: the reference and ragged cases of
    ``FUSE_CASES`` (the untimed ones carry no times) and a timed record at
    each distinct step shape, with times that name their D."""
    recs = [{"B": B, "D": D, "Dp": Dp, "T": T, "C": C} for B, D, Dp, T, C, _ in smoke.FUSE_CASES]
    for D in dict.fromkeys(smoke.STEP_FUSE_D):
        recs.append({"B": smoke.TEACHER_BATCH, "D": D, "Dp": D // 2, "T": 483, "C": 64,
                     "fwd_ms": D + 0.5, "fwd_bound_ms": D / 10,
                     "bwd_ms": 3.0 * D, "bwd_bound_ms": D / 20})
    return recs


def test_phase17_fuse_sums_weight_each_shape_by_its_launches(smoke):
    steps = smoke.STEP_FUSE_D
    # the kernel-config step's ten fuses: D 16, 32, 64 and 128 twice each
    assert sorted(steps) == [8, 16, 16, 32, 32, 64, 64, 128, 128, 256]
    sums = smoke._bf16_fuse_step_sums(_records(smoke))
    assert {k: sums[k]["launches"] for k in sums} == {"fwd": 10, "bwd": 10}
    assert sums["fwd"]["ms"] == pytest.approx(sum(D + 0.5 for D in steps))
    assert sums["fwd"]["bound_ms"] == pytest.approx(sum(D / 10 for D in steps))
    assert sums["bwd"]["ms"] == pytest.approx(sum(3.0 * D for D in steps))
    assert sums["bwd"]["bound_ms"] == pytest.approx(sum(D / 20 for D in steps))


@pytest.mark.parametrize("missing", [8, 256])
def test_phase17_fuse_sums_need_every_step_shape(smoke, missing):
    recs = [r for r in _records(smoke) if not (r["D"] == missing and "fwd_ms" in r)]
    with pytest.raises(StopIteration):
        smoke._bf16_fuse_step_sums(recs)
