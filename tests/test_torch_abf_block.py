"""The port's whole-ABF-block kernel module (``kernels/abf_block.py``) on the
CPU, where its wrappers run their plain versions, against the JAX package:
the forward against the Pallas kernel in interpret mode (``abf_block(...,
interpret=True)``), the backward against the Pallas backward itself
(``_bwd_raw(..., interpret=True)``: ``jax.grad`` through the block's custom
VJP fails on a bias-gradient shape, ROADMAP section 3), fused and no-fuse,
with k of 1, 2 and 4, ragged T and one freq tile.  Inputs come from a numpy
seed.  Also: the autograd ``Function`` against autograd of the plain
composition, and the gate on every block of ``TrainConfig()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_clskd_tpu.ops.pallas.abf_block import (
    _bwd_raw,
    abf_block as jax_abf_block,
)
from speech_enhancement_clskd_tpu_torch.kernels.abf_block import (
    MAX_MID_CHANNELS,
    MAX_TAP_CHANNELS,
    abf_block,
    abf_block_bwd,
    abf_block_dispatchable,
    abf_block_fwd,
    abf_block_reference,
)
from torch_oracle import one_cpu_thread

# forward and gradients, as tests/test_pallas_abf_block.py holds them
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
# (fuse, B, D, k, T, Cs, M, O): the Pallas test's shape (T=21 unaligned,
# k=2, several freq tiles), k=1 and k=4, its one-tile case, and no-fuse ones
CASES = {
    "fused_k2": (True, 2, 8, 2, 21, 6, 8, 10),
    "fused_k1": (True, 2, 4, 1, 11, 5, 8, 3),
    "fused_k4": (True, 1, 8, 4, 13, 4, 6, 7),
    "fused_one_tile": (True, 2, 4, 2, 9, 4, 6, 6),
    "nofuse": (False, 2, 8, 1, 21, 6, 8, 10),
    "nofuse_ragged": (False, 1, 5, 1, 7, 3, 4, 9),
}
GRAD_NAMES = ("g_tap", "g_res", "dw1a", "dbvec", "dwxt", "dwy", "dzoff", "dw2")


def _inputs(case, seed=0):
    """numpy inputs in the scales of tests/test_pallas_abf_block.py, plus the
    incoming gradients of xf and out."""
    fuse, b, d, k, t, cs, m, o = case
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    kw = dict(tap=f(b, d, t, cs), res=f(b, d // k, t, m) if fuse else None,
              w1a=f(cs, m) * 0.4, bvec=f(m) * 0.2, wxt=f(cs, 2) * 0.3, wy=f(m, 2) * 0.3,
              zoff=f(2) * 0.1, w2=f(3, 3, m, o) * 0.2)
    return kw, f(b, d, t, m), f(b, d, t, o)


def _torch(kw):
    return {n: None if v is None else torch.from_numpy(v) for n, v in kw.items()}


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_forward_matches_pallas_interpret(case):
    kw, _, _ = _inputs(case)
    jkw = {n: None if v is None else jnp.asarray(v) for n, v in kw.items()}
    want_xf, want_out = jax_abf_block(**jkw, interpret=True)
    got_xf, got_out = abf_block_fwd(**_torch(kw))
    np.testing.assert_allclose(got_xf.numpy(), np.asarray(want_xf), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_backward_matches_pallas_bwd(case):
    kw, gxf, gout = _inputs(case, seed=1)
    fuse, m = case[0], case[6]
    jkw = {n: None if v is None else jnp.asarray(v) for n, v in kw.items()}
    xf = np.array(jax_abf_block(**jkw, interpret=True)[0])
    # the Pallas backward takes bvec and zoff as [1, n]; without a residual,
    # the no-fuse VJP's [1, 2] zeros
    small = ((jkw["wxt"], jkw["wy"], jkw["zoff"].reshape(1, 2)) if fuse
             else (jnp.zeros((1, 2), jnp.float32),) * 3)
    want = _bwd_raw(jkw["tap"], jkw["res"], jkw["w1a"], jkw["bvec"].reshape(1, m), *small,
                    jkw["w2"], jnp.asarray(xf), jnp.asarray(gxf), jnp.asarray(gout), True)
    got = abf_block_bwd(**_torch(kw), xf=torch.from_numpy(xf), gxf=torch.from_numpy(gxf),
                        gout=torch.from_numpy(gout))
    for name, g, w in zip(GRAD_NAMES, got, want):
        if not fuse and name in ("g_res", "dwxt", "dwy", "dzoff"):
            assert g is None, name
            continue
        w = np.asarray(w)
        if name in ("dbvec", "dzoff"):  # the Pallas backward's [1, n]
            w = w[0]
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", [CASES["fused_k2"], CASES["fused_k4"], CASES["nofuse"]],
                         ids=["fused_k2", "fused_k4", "nofuse"])
def test_autograd_matches_autograd_of_the_composition(case):
    kw, gxf, gout = _inputs(case, seed=2)
    fuse = case[0]
    names = [n for n in kw if kw[n] is not None and (fuse or n not in ("wxt", "wy", "zoff"))]

    def leaves():
        return {n: torch.from_numpy(kw[n]).requires_grad_(True) for n in names}

    got, want = leaves(), leaves()
    for fn, ins in ((abf_block, got), (abf_block_reference, want)):
        args = {n: ins.get(n) for n in kw}
        xf, out = fn(**args)
        (torch.vdot(xf.flatten(), torch.from_numpy(gxf).flatten())
         + torch.vdot(out.flatten(), torch.from_numpy(gout).flatten())).backward()
    for n in names:
        assert got[n].grad.shape == want[n].grad.shape, n
        torch.testing.assert_close(got[n].grad, want[n].grad, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=n)
    assert tuple(got["bvec"].grad.shape) == (case[6],)
    if fuse:
        assert tuple(got["zoff"].grad.shape) == (2,)


def test_unused_xf_gets_a_zero_gradient():
    """The last block's xf feeds nothing: autograd hands the backward a
    materialized zero, which it takes."""
    kw, _, gout = _inputs(CASES["fused_k2"], seed=3)
    ins = {n: torch.from_numpy(v).requires_grad_(True) for n, v in kw.items()}
    _, out = abf_block(**ins)
    out.backward(torch.from_numpy(gout))
    ref = {n: torch.from_numpy(v).requires_grad_(True) for n, v in kw.items()}
    abf_block_reference(**ref)[1].backward(torch.from_numpy(gout))
    for n in kw:
        torch.testing.assert_close(ins[n].grad, ref[n].grad, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=n)


# TrainConfig()'s 12 ABF blocks at 3 s (T=483), mid 64, in processing order:
# (D, Cs, O) of the student tap and the teacher's channels; block 0 of each
# chain takes no residual, the others the previous block's xf at D / 2
TRAIN_CHAINS = {
    "encoder": [(4, 64, 256), (8, 64, 256), (16, 64, 256), (32, 32, 128), (64, 16, 64),
                (128, 8, 32)],
    "decoder": [(8, 64, 256), (16, 64, 256), (32, 32, 128), (64, 16, 64), (128, 8, 32),
                (256, 2, 2)],
}


@pytest.mark.parametrize("chain", list(TRAIN_CHAINS))
def test_gate_takes_every_train_config_block(chain):
    prev = None
    for d, cs, o in TRAIN_CHAINS[chain]:
        res = None if prev is None else (32, prev, 483, 64)
        assert abf_block_dispatchable((32, d, 483, cs), res, 64, o), (d, cs, o)
        prev = d


def test_gate_refuses():
    assert abf_block_dispatchable((2, 8, 21, 6), (2, 4, 21, 8), 8, 10)
    assert not abf_block_dispatchable((2, 8, 21, 6), (2, 3, 21, 8), 8, 10)  # 8 % 3
    assert not abf_block_dispatchable((2, 8, 21, 6), (2, 4, 20, 8), 8, 10)  # T differs
    assert not abf_block_dispatchable((2, 8, 21, 6), (1, 4, 21, 8), 8, 10)  # B differs
    assert not abf_block_dispatchable((2, 8, 21, 6), (2, 4, 21, 6), 8, 10)  # rc != mid
    assert abf_block_dispatchable((1, 2, 3, MAX_TAP_CHANNELS), None, MAX_MID_CHANNELS, 5)
    assert not abf_block_dispatchable((1, 2, 3, MAX_TAP_CHANNELS + 1), None, 8, 5)
    assert not abf_block_dispatchable((1, 2, 3, 4), None, MAX_MID_CHANNELS + 1, 5)


def test_wrappers_reject_bad_inputs():
    kw, gxf, gout = _inputs(CASES["fused_k2"], seed=4)
    t = _torch(kw)
    before = (abf_block_fwd.launches, abf_block_bwd.launches)
    with pytest.raises(ValueError, match="abf_block_dispatchable"):
        abf_block(**{**t, "res": t["res"][:, :3]})
    with pytest.raises(ValueError, match="w1a must be"):
        abf_block(**{**t, "w1a": t["w1a"][:4]})
    with pytest.raises(ValueError, match="zoff must be"):
        abf_block(**{**t, "zoff": t["zoff"][None]})
    with pytest.raises(ValueError, match="w2 must be"):
        abf_block(**{**t, "w2": t["w2"][:2]})
    with pytest.raises(TypeError, match="float32"):
        abf_block(**{n: v.double() for n, v in t.items()})
    with pytest.raises(ValueError, match="contiguous"):
        abf_block(**{**t, "wy": t["wy"].T.contiguous().T})
    with pytest.raises(ValueError, match="gout must be"):
        abf_block_bwd(**t, xf=torch.from_numpy(gxf), gxf=torch.from_numpy(gxf),
                      gout=torch.from_numpy(gout)[..., :3])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        abf_block(**{n: v.to("meta") for n, v in t.items()})
    assert (abf_block_fwd.launches, abf_block_bwd.launches) == before
