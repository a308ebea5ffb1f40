"""The ranks' ``("data", "model")`` layout and the tensor-parallel rule.

Port of ``speech_enhancement_clskd_tpu/parallel/mesh.py``.  The JAX package
builds one ``jax.sharding.Mesh`` over its devices and shards the batch over
``data`` (``NamedSharding(P("data"))``), the large weights over ``model``.
The port runs a process a device: ``make_mesh`` lays the process group's
ranks out as ``data`` x ``model`` with
``torch.distributed.device_mesh.init_device_mesh`` where the group is up,
and gives a world of 1 otherwise.  A rank's share of a batch is its row
slice (``distributed.local_rows``), the counterpart of the JAX batch
shardings.

``spec_for`` is the JAX tensor-parallel rule (``_spec_for``) as a pure
function of a shape; the trainers do not shard over ``model`` yet and raise
for ``model > 1`` (``trainer_mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from ..config import MeshConfig

# the ROADMAP item that ports tensor parallelism over the model axis
TP_ITEM = "ROADMAP queue 1 item 8b (tensor parallelism over mesh.model)"

_TP_MIN_SIZE = 1 << 14  # tensors below this many elements stay replicated


@dataclass(frozen=True)
class Mesh:
    """``shape``: ``{"data": d, "model": m}``; ``device_mesh``: the torch
    ``DeviceMesh`` over the ranks, ``None`` for a world of 1 without a
    process group; ``data_group``: the process group of this rank's data
    axis (``None`` without a process group, so no collective runs)."""

    shape: Dict[str, int]
    device_mesh: Any = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        """Whether this rank writes: rank 0 of the world."""
        return not dist.is_initialized() or dist.get_rank() == 0


def mesh_shape(mcfg: MeshConfig, world: int) -> Tuple[int, int]:
    """(data, model) of ``mcfg`` over ``world`` ranks: ``data=-1`` takes
    ``world // model``; a layout that does not cover the world exactly
    raises (a rank outside the mesh would have nothing to run)."""
    model = max(1, mcfg.model)
    data = mcfg.data if mcfg.data > 0 else max(1, world // model)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the world has {world}")
    return data, model


def make_mesh(mcfg: Optional[MeshConfig] = None, device_type: str = "cuda") -> Mesh:
    """The ``("data", "model")`` layout of ``mcfg`` over the process
    group's ranks (``init_device_mesh`` on ``device_type``), or a world of
    1 without a process group."""
    mcfg = mcfg or MeshConfig()
    if not dist.is_initialized():
        data, model = mesh_shape(mcfg, 1)
        return Mesh({"data": data, "model": model})
    from torch.distributed.device_mesh import init_device_mesh

    data, model = mesh_shape(mcfg, dist.get_world_size())
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    return Mesh({"data": data, "model": model}, dm, dm.get_group("data"))


def trainer_mesh(mcfg: MeshConfig, mesh: Optional[Mesh], device_type: str) -> Mesh:
    """The trainers' mesh: ``mesh``, else ``make_mesh(mcfg)``.  They run
    data parallel only: ``model > 1`` raises ``NotImplementedError``."""
    model = mesh.shape["model"] if mesh is not None else mcfg.model
    if model > 1:
        raise NotImplementedError(f"mesh.model={model}: not ported yet, {TP_ITEM}")
    return mesh if mesh is not None else make_mesh(mcfg, device_type)


def spec_for(shape: Tuple[int, ...], model_size: int) -> Tuple[Optional[str], ...]:
    """The JAX tensor-parallel rule as a partition spec: the last axis of a
    tensor of at least 2^14 elements over ``"model"`` where it divides,
    every other axis (and every smaller or indivisible tensor) replicated
    (``()``)."""
    if model_size <= 1 or not shape:
        return ()
    size = 1
    for s in shape:
        size *= s
    if size < _TP_MIN_SIZE:
        return ()
    last = shape[-1]
    if last % model_size == 0 and last >= model_size:
        return (None,) * (len(shape) - 1) + ("model",)
    return ()
