"""Weights carried flax -> torch -> flax: exact round trip, and the torch side
loads strictly into the port's model (same keys, same shapes)."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu.config import STUDENT as JAX_STUDENT
from speech_enhancement_clskd_tpu.config import TEACHER as JAX_TEACHER
from speech_enhancement_clskd_tpu.models.dccrn import make_model as jax_make_model
from speech_enhancement_clskd_tpu_torch.config import STUDENT, TEACHER
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    torch_state_from_flax,
)
from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle
from torch_oracle import one_cpu_thread

BUNDLE = str(Path(__file__).resolve().parents[1] / "artifacts/r4_distill/the_best_model.npz")


def _jax_init(cfg):
    model = jax_make_model(cfg)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 1600)), training=True))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=["teacher", "student", "r4_bundle"])
def case(request):
    if request.param == "r4_bundle":
        cfg, variables, _ = load_bundle(BUNDLE)
        return cfg, variables
    jax_cfg, cfg = {"teacher": (JAX_TEACHER, TEACHER),
                    "student": (JAX_STUDENT, STUDENT)}[request.param]
    return cfg, _jax_init(jax_cfg)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_round_trip_is_exact(case):
    _, variables = case
    back = flax_from_torch_state(torch_state_from_flax(variables))
    a = dict(_leaves({c: variables[c] for c in ("params", "batch_stats")}))
    b = dict(_leaves(back))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


def test_state_loads_strictly_into_port_model(case):
    cfg, variables = case
    state = torch_state_from_flax(variables)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_conv_layouts():
    """HWIO -> OIHW for encoder convs, HWIO -> IOHW for decoder convs."""
    w = np.arange(5 * 2 * 3 * 4, dtype=np.float32).reshape(5, 2, 3, 4)
    state = torch_state_from_flax({"params": {"enc0_conv": {"wr": w},
                                              "dec0_conv": {"wr": w}}})
    enc, dec = state["enc0_conv.wr"].numpy(), state["dec0_conv.wr"].numpy()
    assert enc.shape == (4, 3, 5, 2) and dec.shape == (3, 4, 5, 2)
    assert enc[3, 2, 4, 1] == w[4, 1, 2, 3] and dec[2, 3, 4, 1] == w[4, 1, 2, 3]
