"""The port's parallel layer in one process on the CPU: ``MeshConfig`` and
its overrides, ``make_mesh``'s layouts, the tensor-parallel rule and the
batch-slice arithmetic against the JAX package's, the rule's torch dims
against ``_spec_for`` on the JAX trees of both families, torchrun's
variables reaching ``initialize``, the trainers' refusal of a model axis
without a process group, a data-parallel step in a group of one against
the one-process step (bit for bit, the CPU counterpart of ``chip_smoke.py``
phase 26 (a)), and ``sharded_utterance_forward`` in a world of one.  The
groups of several processes are ``tests/test_torch_distributed.py``'s."""

import dataclasses
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.config import MeshConfig as JaxMeshConfig
from speech_enhancement_clskd_tpu.config import STFTConfig as JaxSTFTConfig
from speech_enhancement_clskd_tpu.models import make_model as jax_make_model
from speech_enhancement_clskd_tpu.parallel import distributed as jax_distributed
from speech_enhancement_clskd_tpu.parallel.mesh import _spec_for, make_mesh as jax_make_mesh
from speech_enhancement_clskd_tpu_torch.config import (
    DCCRNConfig,
    MeshConfig,
    STFTConfig,
    TrainConfig,
    load_config,
    to_yaml,
)
from speech_enhancement_clskd_tpu_torch.distill.strategies import spkd_term
from speech_enhancement_clskd_tpu_torch.losses.kd import spkd_loss, spkd_loss_affine
from speech_enhancement_clskd_tpu_torch.parallel import distributed
from speech_enhancement_clskd_tpu_torch.models.dccrn import build_model
from speech_enhancement_clskd_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape,
    spec_for,
    torch_shard_dims,
)
from speech_enhancement_clskd_tpu_torch.parallel.sequence import sharded_utterance_forward
from speech_enhancement_clskd_tpu_torch.train.pretrain import PretrainTrainer
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer
from torch_oracle import one_cpu_thread

import torch_dp_worker as worker

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_mesh_config_matches_jax_and_round_trips():
    assert [(f.name, f.default) for f in dataclasses.fields(MeshConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxMeshConfig)]
    assert TrainConfig().mesh == MeshConfig(data=-1, model=1)
    cfg = load_config(None, ["mesh.data=2", "mesh.model=1"])
    assert cfg.mesh == MeshConfig(data=2, model=1)
    pytest.importorskip("yaml")
    assert "mesh:\n  data: 2\n  model: 1\n" in to_yaml(cfg)


def test_mesh_shapes():
    """The counterpart of ``tests/test_parallel.py::test_mesh_shapes``: the
    layouts over 8 ranks, as JAX lays them out over 8 devices."""
    for d, m in ((4, 2), (-1, 2), (-1, 1), (8, 1)):
        want = jax_make_mesh(JaxMeshConfig(data=d, model=m)).shape
        assert dict(zip(("data", "model"), mesh_shape(MeshConfig(data=d, model=m), 8))) == want
    with pytest.raises(ValueError):
        jax_make_mesh(JaxMeshConfig(data=16, model=1))
    with pytest.raises(ValueError):
        mesh_shape(MeshConfig(data=16, model=1), 8)
    with pytest.raises(ValueError):  # the port's mesh spans the world: no idle rank
        mesh_shape(MeshConfig(data=2, model=1), 8)


def test_make_mesh_without_a_group_is_a_world_of_one():
    assert not dist.is_initialized()
    mesh = make_mesh(MeshConfig(), "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.device_mesh is None
    assert mesh.is_main
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=2), "cpu")


@pytest.mark.parametrize("model_size", [1, 2, 4, 3])
def test_spec_for_matches_jax(model_size):
    shapes = [(), (4, 4), (512, 256), (512, 255), (3, 3, 64, 128), (1 << 14,), (1 << 13,),
              (128, 2), (64, 256, 4)]
    for shape in shapes:
        assert spec_for(shape, model_size) == tuple(_spec_for("p", shape, model_size)), shape
    assert tuple(P(None, "model")) == (None, "model")


def _fake_group(monkeypatch, n, i, jax_too=True):
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda group=None: i)
    if jax_too:
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda: i)
    return object()


@pytest.mark.parametrize("n, i, batch", [(4, 2, 10), (4, 3, 10), (2, 0, 8), (2, 1, 8),
                                         (3, 2, 7), (1, 0, 5)])
def test_host_local_batch_slice_matches_jax(monkeypatch, n, i, batch):
    """The counterpart of ``test_put_global_batch_multiprocess_branch_unit``:
    the same slice arithmetic (the last rank takes the remainder)."""
    group = _fake_group(monkeypatch, n, i)
    assert distributed.host_local_batch_slice(batch, group) == \
        jax_distributed.host_local_batch_slice(batch)


def test_local_rows_takes_the_ranks_rows(monkeypatch):
    g = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    group = _fake_group(monkeypatch, 4, 2, jax_too=False)
    np.testing.assert_array_equal(distributed.local_rows(g, 0, group).numpy(), g[4:6])
    gk = np.arange(3 * 8 * 2, dtype=np.float32).reshape(3, 8, 2)
    np.testing.assert_array_equal(distributed.local_rows(gk, 1, group).numpy(), gk[:, 4:6])
    with pytest.raises(ValueError):  # 10 rows do not shard over 4 ranks
        distributed.local_rows(np.zeros((10, 5), np.float32), 0, group)
    np.testing.assert_array_equal(distributed.local_rows(g).numpy(), g)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("device, backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_torchrun_variables_reach_initialize(monkeypatch, device, backend):
    """torchrun's variables name the group; the backend follows the device
    and the card follows ``LOCAL_RANK``."""
    calls = {}
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.update(card=d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for name, value in zip(TORCHRUN_VARS, ("10.0.0.7", "29511", "8", "5", "1")):
        monkeypatch.setenv(name, value)
    assert distributed.initialize(device=device) is True
    want = dict(backend=backend, init_method="tcp://10.0.0.7:29511", world_size=8, rank=5)
    if device == "cuda":
        want["card"] = torch.device("cuda", 1)
    assert calls == want
    calls.clear()
    assert distributed.initialize("tcp://h:1", 2, 0, backend="gloo", device=device)
    assert calls["init_method"] == "tcp://h:1" and calls["backend"] == "gloo"


def test_initialize_needs_a_coordinator(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")


@pytest.mark.parametrize("make", [
    lambda cfg, mesh: Trainer(cfg, device="cpu", mesh=mesh),
    lambda cfg, mesh: PretrainTrainer(cfg, device="cpu", mesh=mesh),
], ids=["Trainer", "PretrainTrainer"])
def test_model_axis_needs_a_process_group(make):
    """``mesh.model=2`` in one process cannot cover the world, and a mesh
    with a model axis but no model group raises: nothing runs replicated
    in its place."""
    cfg = load_config(None, ["mesh.model=2", "mesh.data=1"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make(cfg, None)
    with pytest.raises(ValueError, match="no model process group"):
        make(cfg, Mesh({"data": 1, "model": 2}))


# full width: the defaults' teacher and student, the asteroid pair, the
# real-LSTM bottleneck with complex BN, and the tensor-parallel tests' geometry
TP_MODELS = {
    "teacher": dict(name="dccrn-cl", kernel_num=(32, 64, 128, 256, 256, 256), rnn_units=256),
    "student": dict(name="dccrn-cl-test", kernel_num=(16, 32, 64, 128, 128, 128), rnn_units=64),
    "dccrnet_teacher": dict(name="dccrn-cl", family="dccrnet",
                            kernel_num=(32, 64, 128, 256, 256, 256), rnn_units=256),
    "dccrnet_student": dict(name="dccrn-cl-test", family="dccrnet",
                            kernel_num=(8, 16, 32, 64, 64, 64), rnn_units=64),
    "real_lstm": dict(name="dccrn-cl", kernel_num=(32, 64, 128, 256, 256, 256), rnn_units=256,
                      use_clstm=False, use_cbn=True),
    "tp_teacher": dict(name="t", kernel_num=(8, 16, 32), rnn_units=64),
}


def _jax_leaves(fields):
    """The JAX model's parameter shapes by dotted path (``eval_shape`` of
    its init: no compile)."""
    stft = dict(stft=JaxSTFTConfig(window="sqrthann")) if fields.get("family") == "dccrnet" else {}
    model = jax_make_model(JaxDCCRNConfig(**fields, **stft))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000)),
                                               training=True))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    return {".".join(k.key for k in path): tuple(leaf.shape) for path, leaf in flat}


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("which", sorted(TP_MODELS))
def test_torch_shard_dims_match_the_jax_rule(which, model_size):
    """For every leaf, ``torch_shard_dims`` cuts the port's tensor exactly
    where ``_spec_for`` shards the JAX leaf, along the torch dim that holds
    the JAX leaf's last axis (the same length); something is cut."""
    fields = TP_MODELS[which]
    jax_shapes = _jax_leaves(fields)
    stft = dict(stft=STFTConfig(window="sqrthann")) if fields.get("family") == "dccrnet" else {}
    params = dict(build_model(DCCRNConfig(**fields, **stft)).named_parameters())
    assert set(params) == set(jax_shapes)
    dims = torch_shard_dims(params.items(), model_size)
    for name, shape in jax_shapes.items():
        sharded = "model" in tuple(_spec_for(name, shape, model_size))
        assert (dims[name] is not None) == sharded, (name, shape, dims[name])
        if sharded:
            assert params[name].shape[dims[name]] == shape[-1], (name, shape)
    assert any(d is not None for d in dims.values())


def test_collectives_without_a_group_are_the_identity():
    x = torch.randn(3, 4)
    assert distributed.all_reduce(x) is x
    assert distributed.all_gather(x, 1) is x
    assert distributed.mean_over_ranks([x]) == [x]
    p = torch.nn.Parameter(torch.randn(3))
    p.grad = torch.randn(3)
    g = p.grad.clone()
    distributed.average_gradients([p])
    torch.testing.assert_close(p.grad, g, rtol=0, atol=0)


@pytest.mark.parametrize("groups, batch_axis, affine", [(1, 0, False), (2, 0, False),
                                                        (1, 1, False), (1, 0, True),
                                                        (2, 0, True)])
def test_spkd_term_in_one_process_is_spkd_loss(groups, batch_axis, affine):
    g = torch.Generator().manual_seed(0)
    shape = (4, 6, 5, 3) if batch_axis == 0 else (7, 4, 9)
    s, t = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    if affine:
        a, b = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
        want = spkd_loss_affine(s, a, b, t, "batchmean", groups=groups)
        got = spkd_term((s, a, b), t, groups)
    else:
        want = spkd_loss(s, t, "batchmean", batch_axis=batch_axis, groups=groups)
        got = spkd_term(s, t, groups, batch_axis=batch_axis)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def group_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["clskd_g1", "clskd_remat_fold_g1", "pretrain_cbn",
                                  "pretrain_si_sdr"])
def test_data_parallel_step_in_a_group_of_one_is_bit_exact(group_of_one, case):
    """Every collective of the data-parallel step runs (a gloo group of
    one) and changes no bit: the logs, the step-1 gradients and the state
    after the case's steps equal the one-process step's."""
    mesh = make_mesh(MeshConfig(), "cpu")
    assert mesh.data_group is not None and mesh.shape == {"data": 1, "model": 1}
    got = worker.run_steps(case, mesh=mesh)
    want = worker.run_steps(case, mesh=dataclasses.replace(mesh, data_group=None))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sequence_forward_in_a_world_of_one():
    """Without a group the span is the whole utterance, zeros on both
    sides; a length off the hop raises."""
    model = worker.sequence_model()
    hop, guard = model.cfg.stft.hop, model.cfg.stft.win_len - model.cfg.stft.hop
    ctx = 16 * hop
    wav = torch.from_numpy(worker.sequence_signal()[:, :100 * hop])
    got = sharded_utterance_forward(model, wav, context_frames=16)
    padded = torch.cat([torch.zeros(2, ctx), wav, torch.zeros(2, guard)], dim=1)
    with torch.no_grad():
        want = model(padded, training=False).wav[:, ctx:ctx + wav.shape[1]]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        sharded_utterance_forward(model, wav[:, :12345 % wav.shape[1]])
