"""The ReviewKD chains of ABF blocks with the kernel switches of
``DistillConfig`` (``abf_conv_pallas``: the 3x3 conv through
``kernels/conv3x3.py``; ``abf_attfuse_pallas``: the attention fuse through
``kernels/attfuse.py``; ``abf_block_pallas``: the whole block but bn2 through
``kernels/abf_block.py``) against the default chain on the same weights and
taps, on the CPU, where the wrappers run their plain versions: outputs,
updated BN statistics, and the gradients of the taps and of every parameter.

The kernel fuse path (and the block path) forms the normalized map and contracts it with the raw
attention weights, where the default path folds the 1x1 conv and bn1's
affine into one tap-level contraction: the same function, summed in another
order.  Its tolerance is float32 rounding over these few-channel sums."""

import numpy as np
import pytest
import torch

from speech_enhancement_clskd_tpu_torch.distill import abf as pabf
from speech_enhancement_clskd_tpu_torch.kernels.abf_block import abf_block_bwd, abf_block_fwd
from speech_enhancement_clskd_tpu_torch.kernels.attfuse import (
    attention_fuse_bwd,
    attention_fuse_fwd,
)
from speech_enhancement_clskd_tpu_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_wgrad
from torch_oracle import one_cpu_thread

TOL = 1e-5
# the student/teacher tap geometry of tests/test_torch_train_layers.py
B, T_FRAMES, MID = 4, 9, 6
CHAINS = {
    "encoder": dict(s_ch=(4, 8, 8), t_ch=(8, 16, 32), ds=(16, 8, 4), reverse=True),
    "decoder": dict(s_ch=(8, 4, 2), t_ch=(32, 16, 2), ds=(8, 16, 32), reverse=False),
}
FLAGS = {
    "conv": dict(conv_pallas=True),
    "fuse": dict(attfuse_pallas=True),
    "both": dict(conv_pallas=True, attfuse_pallas=True),
    "block": dict(block_pallas=True),
}
COUNTERS = (conv3x3_fwd, conv3x3_wgrad, attention_fuse_fwd, attention_fuse_bwd, abf_block_fwd,
            abf_block_bwd)


def _rel_l2(got, want):
    return (got - want).norm().item() / max(want.norm().item(), 1e-30)


def _run(chain, taps, cot):
    tt = [torch.from_numpy(t).requires_grad_(True) for t in taps]
    outs = chain(tt, training=True)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    return ([o.detach() for o in outs], [t.grad for t in tt],
            {n: p.grad for n, p in chain.named_parameters()},
            {n: b.clone() for n, b in chain.named_buffers()})


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
@pytest.mark.parametrize("which", list(CHAINS))
def test_kernel_chain_matches_default_chain(which, flags):
    geo = CHAINS[which]
    rng = np.random.default_rng(7)
    taps = [rng.standard_normal((B, d, T_FRAMES, c)).astype(np.float32)
            for d, c in zip(geo["ds"], geo["s_ch"])]
    cot = [rng.standard_normal((B, d, T_FRAMES, c)).astype(np.float32)
           for d, c in zip(geo["ds"], geo["t_ch"])]
    default = pabf.ReviewKD(geo["s_ch"], geo["t_ch"], MID, reverse=geo["reverse"])
    default.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():  # non-trivial BN parameters and attention biases
        for name, p in default.named_parameters():
            if name.endswith(("bn1.scale", "bn2.scale")):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape).astype(np.float32)))
    kernel = pabf.ReviewKD(geo["s_ch"], geo["t_ch"], MID, reverse=geo["reverse"], **flags)
    kernel.load_state_dict(default.state_dict(), strict=True)

    launches = [fn.launches for fn in COUNTERS]
    want_out, want_gt, want_gp, want_stats = _run(default, taps, cot)
    got_out, got_gt, got_gp, got_stats = _run(kernel, taps, cot)
    # on the CPU the wrappers take their plain versions and launch nothing
    assert launches == [fn.launches for fn in COUNTERS]
    for g, w in zip(got_out, want_out):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    for name, w in want_stats.items():
        torch.testing.assert_close(got_stats[name], w, rtol=TOL, atol=TOL, msg=name)
    for g, w in zip(got_gt, want_gt):
        assert _rel_l2(g, w) <= TOL
    assert got_gp.keys() == want_gp.keys()
    for name, w in want_gp.items():
        assert _rel_l2(got_gp[name], w) <= TOL, name


def test_flags_reach_every_block():
    chain = pabf.ReviewKD((4, 8, 8), (8, 16, 32), MID, conv_pallas=True, attfuse_pallas=True)
    assert all(chain.get_submodule(f"abf{i}").conv2.use_kernel for i in range(3))
    assert chain.abf0.att_conv is None
    assert all(chain.get_submodule(f"abf{i}").att_conv.use_kernel for i in (1, 2))
    default = pabf.ReviewKD((4, 8, 8), (8, 16, 32), MID)
    assert not default.abf0.conv2.use_kernel and not default.abf1.att_conv.use_kernel
    block = pabf.ReviewKD((4, 8, 8), (8, 16, 32), MID, block_pallas=True)
    assert all(block.get_submodule(f"abf{i}").block_pallas for i in range(3))
    assert not any(default.get_submodule(f"abf{i}").block_pallas for i in range(3))


@pytest.mark.parametrize("which", list(CHAINS))
def test_block_path_takes_every_block(which, monkeypatch):
    """With ``block_pallas`` every block of the tiny chains passes the gate
    and goes through ``kernels.abf_block.abf_block``, and nothing goes
    through the conv or fuse kernels' autograd functions."""
    geo = CHAINS[which]
    chain = pabf.ReviewKD(geo["s_ch"], geo["t_ch"], MID, reverse=geo["reverse"],
                          block_pallas=True)
    chain.reset_parameters(torch.Generator().manual_seed(4))
    calls = []

    def counting(*args):
        calls.append(args[1] is None)
        return block_fn(*args)

    def refuse(*_):
        raise AssertionError("a per-op kernel path ran")

    block_fn = pabf.abf_block
    monkeypatch.setattr(pabf, "abf_block", counting)
    monkeypatch.setattr(pabf, "conv3x3", refuse)
    monkeypatch.setattr(pabf, "attention_fuse", refuse)
    rng = np.random.default_rng(8)
    taps = [torch.from_numpy(rng.standard_normal((B, d, T_FRAMES, c)).astype(np.float32))
            for d, c in zip(geo["ds"], geo["s_ch"])]
    sum(o.sum() for o in chain(taps, training=True)).backward()
    assert calls == [True, False, False]  # the first block in processing order: no residual
