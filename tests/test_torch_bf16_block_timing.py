"""The CPU side of the bf16 K5's card measurements: chip_smoke.py's phase-20
sums over the block-config step (each step shape weighted by its blocks,
each pass summed, the routes counted by launches), the names that sort the
device kernels into passes, and each pass's bytes bound.  Imports no JAX."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k5", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(smoke):
    """Phase 20's records at each distinct step shape, with times that name
    their shape, as ``_bf16_block_case`` writes them."""
    recs = []
    for fuse, D, Cs, O in dict.fromkeys(smoke.STEP_BLOCKS):
        route = "fused"
        # K5f in one pass where every output channel's weights fit, else two;
        # at the mask block dw2 is folded into K5b's pass
        one = 8 <= O <= smoke.K5F_FUSED_MAX_O
        recs.append({"fuse": fuse, "B": smoke.TEACHER_BATCH, "D": D, "k": 2 if fuse else 1,
                     "T": 483, "Cs": Cs, "M": 64, "O": O, "count": smoke.STEP_BLOCKS.count(
                         (fuse, D, Cs, O)),
                     "fwd_route": route, "bwd_route": route,
                     "fwd_ms": D + Cs / 1000, "bwd_ms": 2.0 * D + O / 1000,
                     "fwd_bound_ms": D / 10, "bwd_bound_ms": D / 20,
                     "fwd_passes": ({"fused": 0.75 * D, "pack": 0.001, "whole": True} if one
                                    else {"xf": D / 2, "conv": D / 4, "whole": True}),
                     "bwd_passes": {"pass": 1.5 * D, "reductions": 0.01,
                                    **({"dw2": O / 100} if O >= 8 else {})},
                     "fwd_pass_bounds": ({"fused": 3 * D / 80} if one
                                         else {"xf": D / 40, "conv": D / 80}),
                     "bwd_pass_bounds": {"pass": D / 30, **({"dw2": O / 1000} if O >= 8 else {})}})
    # a record of the same shape without pass times (another phase's) is not counted
    recs.append({k: v for k, v in recs[0].items() if k != "fwd_passes"})
    return recs


def test_phase20_step_sums_weight_each_shape_by_its_blocks(smoke):
    sums = smoke._bf16_block_step_sums(_records(smoke))
    steps = smoke.STEP_BLOCKS
    assert len(steps) == 12 and sums["fwd"]["launches"] == sums["bwd"]["launches"] == 12
    assert sums["fwd"]["ms"] == pytest.approx(sum(D + Cs / 1000 for _, D, Cs, _ in steps))
    assert sums["bwd"]["ms"] == pytest.approx(sum(2.0 * D + O / 1000 for _, D, _, O in steps))
    assert sums["bwd"]["bound_ms"] == pytest.approx(sum(D / 20 for _, D, _, _ in steps))
    one = [(D, O) for _, D, _, O in steps if 8 <= O <= smoke.K5F_FUSED_MAX_O]
    two = [(D, O) for _, D, _, O in steps if not 8 <= O <= smoke.K5F_FUSED_MAX_O]
    assert one and two
    assert sums["fwd"]["passes_ms"] == pytest.approx(
        {"fused": sum(0.75 * D for D, _ in one), "pack": 0.001 * len(one),
         "xf": sum(D / 2 for D, _ in two), "conv": sum(D / 4 for D, _ in two)})
    assert sums["fwd"]["pass_bounds_ms"] == pytest.approx(
        {"fused": sum(3 * D / 80 for D, _ in one), "xf": sum(D / 40 for D, _ in two),
         "conv": sum(D / 80 for D, _ in two)})
    # the mask block has no dw2 pass: its dw2 is in its pass
    assert sums["bwd"]["passes_ms"]["dw2"] == pytest.approx(
        sum(O / 100 for *_, O in steps if O >= 8))
    assert sums["bwd"]["pass_bounds_ms"]["dw2"] == pytest.approx(
        sum(O / 1000 for *_, O in steps if O >= 8))
    assert sums["bwd"]["passes_ms"]["reductions"] == pytest.approx(0.12)
    assert sums["bwd"]["pass_bounds_ms"]["pass"] == pytest.approx(
        sum(D / 30 for _, D, _, _ in steps))
    assert sums["fwd"]["routes"] == {"fused": 12, "wgmma": 0, "mma": 0, "direct": 0}
    assert sums["bwd"]["routes"] == {"fused": 12, "wgmma": 0, "mma": 0, "direct": 0}


def test_phase20_step_sums_need_every_step_shape(smoke):
    recs = [r for r in _records(smoke) if r["D"] != 256]  # no mask block
    with pytest.raises(StopIteration):
        smoke._bf16_block_step_sums(recs)


@pytest.mark.parametrize("kernel, key, want", [
    ("void (anonymous namespace)::abf_block_bf16_fwd_fused_kernel<64>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::FfArgs)", "fwd", "fused"),
    ("void (anonymous namespace)::abf_block_bf16_xf_mma_kernel<false>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::XfArgs)", "fwd", "xf"),
    ("void conv3x3_bf16::conv3x3_bf16_fwd_wgmma_kernel<64, false>(CUtensorMap_st)", "fwd",
     "conv"),
    ("conv3x3_bf16::conv3x3_bf16_pack_weights_kernel(__nv_bfloat16 const*)", "fwd", "pack"),
    ("(anonymous namespace)::abf_block_bf16_conv_n8_mma_kernel(CUtensorMap_st, "
     "__nv_bfloat16 const*)", "fwd", "conv"),
    ("void (anonymous namespace)::abf_block_bf16_bwd_wgmma_kernel<false, false, false, 1>("
     "CUtensorMap_st)", "bwd", "pass"),
    ("void conv3x3_bf16::conv3x3_bf16_fwd_wgmma_kernel<64, true>(CUtensorMap_st)", "bwd",
     "adjoint"),
    ("conv3x3_bf16::conv3x3_bf16_wgrad_wgmma_kernel(CUtensorMap_st)", "bwd", "dw2"),
    ("conv3x3_tiles::reduce_partials_kernel(float const*, float*, int, long)", "bwd",
     "reductions"),
    ("void (anonymous namespace)::abf_block_bwd_pass_kernel<true, __nv_bfloat16>(Args)", "bwd",
     "pass"),
    ("void at::native::elementwise_kernel<128, 4>(int, float)", "bwd", "other"),
])
def test_phase20_sorts_kernels_into_passes(smoke, kernel, key, want):
    assert smoke._k5_pass_of(kernel, key) == want


def test_phase20_pass_bounds_count_each_map_once(smoke):
    B, D, k, T, Cs, M, O = 32, 64, 2, 483, 16, 64, 64
    got = smoke._bf16_block_pass_bounds(True, B, D, k, T, Cs, M, O)
    rows = B * D * T
    gbs = smoke.PEAK_BYTES_S / 1e3
    # the reference block's K5f in one pass: tap, res and w2 in, xf and out out
    assert got["fwd"] == pytest.approx(
        {"fused": 2 * (rows * Cs + rows // k * M + rows * M + rows * O + 9 * M * O) / gbs})
    assert got["bwd"]["pass"] == pytest.approx(
        2 * (2 * rows * Cs + 2 * rows // k * M + rows * M + rows * O) / gbs)
    assert got["bwd"]["dw2"] == pytest.approx((2 * (rows * M + rows * O) + 4 * 9 * M * O) / gbs)
    # no residual: no res read and no g_res written
    bare = smoke._bf16_block_pass_bounds(False, B, D, 1, T, Cs, M, O)
    assert bare["bwd"]["pass"] == pytest.approx(2 * (2 * rows * Cs + rows * M + rows * O) / gbs)
    # O past the fused forward's: the xf pass, then the conv over xf
    wide = smoke._bf16_block_pass_bounds(True, B, D, k, T, 64, M, 256)
    assert wide["fwd"] == pytest.approx(
        {"xf": 2 * (rows * 64 + rows // k * M + rows * M) / gbs,
         "conv": 2 * (rows * M + rows * 256 + 9 * M * 256) / gbs})


def test_phase20_pass_bounds_fold_dw2_into_the_mask_blocks_pass(smoke):
    B, D, k, T, Cs, M, O = 32, 256, 2, 483, 2, 64, 2
    got = smoke._bf16_block_pass_bounds(True, B, D, k, T, Cs, M, O)
    rows = B * D * T
    gbs = smoke.PEAK_BYTES_S / 1e3
    assert set(got["bwd"]) == {"pass"} and set(got["fwd"]) == {"xf", "conv"}
    # the pass also reads xf and writes dw2 (float32)
    assert got["bwd"]["pass"] == pytest.approx(
        (2 * (2 * rows * Cs + 2 * rows // k * M + 2 * rows * M + rows * O) + 4 * 9 * M * O) / gbs)
