"""The bf16 instantiations of the whole ABF block (K5f/K5b,
``kernels/abf_block.py``) and of the SPKD Gram pair (K2, ``kernels/gram.py``)
on the CPU, where their wrappers run their plain versions, against the Pallas
kernels in interpret mode on the same bf16 inputs.

- K5f: ``abf_block(..., interpret=True)`` on bf16 maps and weights, bvec and
  zoff float32, as ``distill/abf.py`` hands them over, for the shapes of
  ``tests/test_torch_abf_block.py``.
- K5b: the Pallas backward ``_bwd_raw(..., interpret=True)`` (``jax.grad``
  through the block's custom VJP fails on a bias-gradient shape), with the
  VJP's casts of the parameter gradients to their inputs' dtypes.
- The autograd function's gradient dtypes, and the wrappers' refusal of
  other dtypes.
- K2: ``gram_pair(..., interpret=True)`` forward and ``jax.grad`` through its
  custom VJP, and ``spkd_loss(..., use_pallas=True)``, on bf16.

Tolerances, measured beside each: the plain versions round where the Pallas
bodies round on bf16 operands and sum the same exact products in float32,
so the bf16 outputs agree bit for bit (held to one bf16 spacing) and the
float32 ones to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_clskd_tpu.losses.kd import spkd_loss as jax_spkd_loss
from speech_enhancement_clskd_tpu.ops.pallas.abf_block import (
    _bwd_raw,
    abf_block as jax_abf_block,
)
from speech_enhancement_clskd_tpu.ops.pallas.gram import gram_pair as jax_gram_pair
from speech_enhancement_clskd_tpu_torch.kernels import bf16_check
from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
    abf_block,
    abf_block_bwd,
    abf_block_fwd,
)
from speech_enhancement_clskd_tpu_torch.kernels.gram import gram_pair, gram_pair_fwd
from speech_enhancement_clskd_tpu_torch.losses.kd import spkd_loss

from test_torch_abf_block import CASES, GRAD_NAMES, _inputs
from torch_oracle import one_cpu_thread

# float32 outputs against interpret mode, relative L2 (measured <= 2.9e-7 for
# K5b's parameter gradients, <= 7.7e-7 for K2's Grams)
F32_REL_L2 = 1e-5
# the SPKD loss on bf16 inputs, relative (measured 1.5e-6); its gradient, a
# float32 chain in another order rounded to bf16 at the end, by relative L2
# within one bf16 rounding (measured 1.1e-4: 0.08 % of the elements a
# spacing apart, one element of a cancelling sum two)
LOSS_RTOL = 1e-5
ROUNDED_REL_L2 = 2.0 ** -8
# the ones the block's VJP casts to their inputs' dtypes (bf16 here)
CAST = {"dw1a", "dwxt", "dwy", "dw2"}


def _bf16_inputs(case, seed):
    """The numpy inputs of ``test_torch_abf_block._inputs`` rounded to bf16
    where the bf16 path hands bf16 over: ``(jax kwargs, torch kwargs, g_xf,
    g_out)``, the incoming gradients bf16."""
    kw, gxf, gout = _inputs(case, seed)
    jkw = {n: None if v is None else (jnp.asarray(v) if n in ("bvec", "zoff")
                                      else jnp.asarray(v).astype(jnp.bfloat16))
           for n, v in kw.items()}
    tkw = {n: None if v is None else _t(v) for n, v in jkw.items()}
    return jkw, tkw, jnp.asarray(gxf).astype(jnp.bfloat16), jnp.asarray(gout).astype(jnp.bfloat16)


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bf16 or float32)."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_bf16_forward_matches_pallas_interpret(case):
    """xf and out in bf16 (measured: bit for bit, the blend's products each
    rounded before their sum)."""
    jkw, tkw, _, _ = _bf16_inputs(case, seed=0)
    want_xf, want_out = jax_abf_block(**jkw, interpret=True)
    xf, out = abf_block_fwd(**tkw)
    assert want_xf.dtype == want_out.dtype == jnp.bfloat16
    assert xf.dtype == out.dtype == torch.bfloat16
    assert bf16_check(xf, _t(want_xf))["max_ulps"] <= 1
    assert bf16_check(out, _t(want_out))["max_ulps"] <= 1


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_bf16_backward_matches_pallas_bwd(case):
    """g_tap and g_res in bf16 (measured: bit for bit), the parameter
    gradients float32 (measured <= 2.9e-7), each in the dtype the JAX VJP
    casts it to."""
    jkw, tkw, gxf, gout = _bf16_inputs(case, seed=1)
    fuse, m = case[0], case[6]
    xf = jax_abf_block(**jkw, interpret=True)[0]
    small = ((jkw["wxt"], jkw["wy"], jkw["zoff"].reshape(1, 2)) if fuse
             else (jnp.zeros((1, 2), jnp.bfloat16),) * 3)
    want = _bwd_raw(jkw["tap"], jkw["res"], jkw["w1a"], jkw["bvec"].reshape(1, m), *small,
                    jkw["w2"], xf, gxf, gout, True)
    got = abf_block_bwd(**tkw, xf=_t(xf), gxf=_t(gxf), gout=_t(gout))
    for name, g, w in zip(GRAD_NAMES, got, want):
        if not fuse and name in ("g_res", "dwxt", "dwy", "dzoff"):
            assert g is None, name
            continue
        if name in ("g_tap", "g_res"):
            assert w.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16, name
            assert bf16_check(g, _t(w))["max_ulps"] <= 1, name
            continue
        # the VJP's cast (abf_block.py:486-493): bf16 weights, float32 offsets
        w = jnp.asarray(w).reshape(g.shape)
        want_dtype = jnp.bfloat16 if name in CAST else jnp.float32
        assert w.astype(want_dtype).dtype == want_dtype and g.dtype == torch.float32, name
        assert _rel_l2(g.numpy(), w.astype(jnp.float32)) <= F32_REL_L2, name


@pytest.mark.parametrize("case", [CASES["fused_k2"], CASES["nofuse"]], ids=["fused", "nofuse"])
def test_bf16_autograd_gradient_dtypes(case):
    """``abf_block`` on bf16 returns each gradient in its input's dtype: the
    maps and the bf16 weights bf16, bvec and zoff float32, as the JAX VJP
    casts them; and the gradients are the plain backward's, cast."""
    _, tkw, gxf, gout = _bf16_inputs(case, seed=2)
    ins = {n: t.requires_grad_(True) for n, t in tkw.items() if t is not None}
    args = {n: ins.get(n) for n in tkw}
    xf, out = abf_block(**args)
    assert xf.dtype == out.dtype == torch.bfloat16
    gxf_t, gout_t = _t(gxf), _t(gout)
    torch.autograd.backward((xf, out), (gxf_t, gout_t))
    want = abf_block_bwd(**{n: None if t is None else t.detach() for n, t in tkw.items()},
                         xf=xf.detach(), gxf=gxf_t, gout=gout_t)
    order = ("tap", "res", "w1a", "bvec", "wxt", "wy", "zoff", "w2")
    for name, w in zip(order, want):
        if w is None:  # no residual: res, wxt, wy and zoff are not used
            assert name not in ins or ins[name].grad is None, name
            continue
        assert ins[name].grad.dtype == ins[name].dtype, name
        assert torch.equal(ins[name].grad, w.to(ins[name].dtype)), name
    assert ins["bvec"].grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("kernel", ["abf_block", "gram_pair"])
def test_wrappers_refuse_other_dtypes(kernel, dtype):
    """K5 and K2 take float32 and bf16, and nothing else."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        if kernel == "gram_pair":
            s = torch.randn(4, 64, dtype=dtype)
            gram_pair_fwd(s, s)
        else:
            _, tkw, _, _ = _bf16_inputs(CASES["fused_k2"], seed=3)
            abf_block_fwd(**{n: None if t is None else t.to(dtype) for n, t in tkw.items()})


# (B, Ds, Dt): Ds != Dt and ragged against the Pallas 2048-column tiles
GRAM_SHAPES = [(4, 5000, 3000), (8, 2048, 4097)]


@pytest.mark.parametrize("shape", GRAM_SHAPES, ids=str)
def test_bf16_gram_pair_matches_pallas_interpret(shape):
    """The Grams float32 from bf16 inputs (measured <= 7.7e-7), and the
    gradients through the custom VJP, cast to bf16 as the JAX VJP casts
    (measured: bit for bit)."""
    B, ds, dt = shape
    rng = np.random.default_rng(sum(shape))
    s = jnp.asarray(0.3 * rng.standard_normal((B, ds)), jnp.float32).astype(jnp.bfloat16)
    t = jnp.asarray(rng.standard_normal((B, dt)), jnp.float32).astype(jnp.bfloat16)
    gs_w = rng.standard_normal((B, B)).astype(np.float32)
    gt_w = rng.standard_normal((B, B)).astype(np.float32)

    def f(a, b):
        gs, gt = jax_gram_pair(a, b, interpret=True)
        return jnp.sum(gs * gs_w) + jnp.sum(gt * gt_w), (gs, gt)

    (_, (want_gs, want_gt)), (ds_w, dt_w) = jax.value_and_grad(f, argnums=(0, 1),
                                                               has_aux=True)(s, t)
    st, tt = _t(s).requires_grad_(True), _t(t).requires_grad_(True)
    gs, gt = gram_pair(st, tt)
    assert gs.dtype == gt.dtype == torch.float32 and want_gs.dtype == jnp.float32
    assert _rel_l2(gs.detach().numpy(), want_gs) <= F32_REL_L2
    assert _rel_l2(gt.detach().numpy(), want_gt) <= F32_REL_L2
    (torch.sum(gs * torch.from_numpy(gs_w)) + torch.sum(gt * torch.from_numpy(gt_w))).backward()
    for got, want in ((st.grad, ds_w), (tt.grad, dt_w)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert bf16_check(got, _t(want))["max_ulps"] <= 1


def test_bf16_spkd_loss_on_the_gram_pair():
    """``spkd_loss(use_pallas=True)`` on bf16 waveforms: the port's fused
    route against the JAX package's, loss and gradients."""
    rng = np.random.default_rng(5)
    s = jnp.asarray(0.3 * rng.standard_normal((4, 6000)), jnp.float32).astype(jnp.bfloat16)
    t = jnp.asarray(0.3 * rng.standard_normal((4, 6000)), jnp.float32).astype(jnp.bfloat16)
    from speech_enhancement_clskd_tpu.ops.pallas import gram as jax_gram

    # the JAX package's fused route, its Gram pair in interpret mode (off the TPU)
    orig = jax_gram.gram_pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gram, "gram_pair", lambda a, b, interpret=False: orig(a, b, True))
        want, want_grad = jax.value_and_grad(
            lambda a: jax_spkd_loss(a, t, use_pallas=True))(s)
    st = _t(s).requires_grad_(True)
    loss = spkd_loss(st, _t(t), use_pallas=True)
    loss.backward()
    assert loss.dtype == torch.float32 and st.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert _rel_l2(st.grad.float().numpy(), want_grad.astype(jnp.float32)) <= ROUNDED_REL_L2


def test_chip_smoke_bf16_block_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 21 check at tiny widths on the CPU (2 clips of
    0.25 s): the card-vs-CPU step of the bf16 block path, the CPU against
    itself from the same state with zero error and the bf16 rounding floor
    measured."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from speech_enhancement_clskd_tpu_torch.config import DCCRNConfig

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tiny = dict(teacher=DCCRNConfig(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32,
                                    compute_dtype=smoke.BF16),
                student=DCCRNConfig(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16,
                                    compute_dtype=smoke.BF16))
    cfg = smoke.train_config(2, 0.25, smoke.BF16_BLOCK_DISTILL, **tiny)
    assert cfg.distill.abf_block_pallas and cfg.distill.taps_dtype == smoke.BF16
    rec = smoke.card_vs_cpu_checks(cfg, "cpu", rounding_floor=True)
    assert rec["failures"] == []
    step = rec["gaussian"]["steps"][0]
    assert step["loss_rel_err"] == 0.0 and step["grad_max_rel_l2"] == 0.0
    assert step["rounding_floor"] > 0.0
    bench = dataclasses.replace(cfg, distill=dataclasses.replace(
        cfg.distill, **smoke.BF16_BENCH_DISTILL))
    assert bench.distill.abf_remat and bench.distill.spkd_bn2_fold
