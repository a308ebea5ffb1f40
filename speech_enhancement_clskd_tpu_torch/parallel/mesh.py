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
function of a shape, and ``torch_shard_dims`` applies it to a module's
parameters: a leaf of the JAX tree whose last axis the rule shards over
``model`` is held by each model rank as its slice along the torch dim that
carries that axis (``utils.bridge``'s layouts put a conv's output channels
at dim 0, a transposed conv's at dim 1 and leave a dense ``[F, O]`` as it
is).  ``models.dccrn.shard_model`` cuts a built model so; the trainers
shard the student and the teacher (the pretraining model) and leave the
ABF chains, the BN statistics and the optimizer's scalars replicated, as
the JAX trainers place them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import torch.distributed as dist

from ..config import MeshConfig
from ..utils.bridge import torch_perm

_TP_MIN_SIZE = 1 << 14  # tensors below this many elements stay replicated


@dataclass(frozen=True)
class Mesh:
    """``shape``: ``{"data": d, "model": m}``; ``device_mesh``: the torch
    ``DeviceMesh`` over the ranks, ``None`` for a world of 1 without a
    process group; ``data_group``: the process group of this rank's data
    axis (the ranks that hold the same slices of the model), ``model_group``
    that of its model axis (the ranks that take the same rows); ``None``
    without a process group, so no collective runs."""

    shape: Dict[str, int]
    device_mesh: Any = None
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def world_group(self) -> Optional[dist.ProcessGroup]:
        """Every rank of the mesh (``None`` for a mesh without a process
        group)."""
        return None if self.device_mesh is None else dist.group.WORLD

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
    return Mesh({"data": data, "model": model}, dm, dm.get_group("data"), dm.get_group("model"))


def trainer_mesh(mcfg: MeshConfig, mesh: Optional[Mesh], device_type: str) -> Mesh:
    """The trainers' mesh: ``mesh``, else ``make_mesh(mcfg)``.  A mesh
    with ``model > 1`` and no model group raises: its ranks would have no
    collective to join their slices."""
    mesh = mesh if mesh is not None else make_mesh(mcfg, device_type)
    if mesh.shape["model"] > 1 and mesh.model_group is None:
        raise ValueError(f"mesh {mesh.shape} has no model process group")
    return mesh


def model_axis_group(mesh: Mesh) -> Optional[dist.ProcessGroup]:
    """The group the trainers shard over: ``mesh.model_group`` where the
    model axis has more than one rank, else ``None`` (nothing sharded)."""
    return mesh.model_group if mesh.shape["model"] > 1 else None


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


def torch_shard_dims(named_parameters: Iterable[Tuple[str, Any]], model_size: int
                     ) -> Dict[str, Optional[int]]:
    """For each ``(name, tensor)`` of a module's parameters (names as the
    state_dict has them, the JAX tree's paths joined with dots), the torch
    dim that holds the JAX leaf's last axis where ``spec_for`` shards that
    leaf over ``model_size`` ranks, else ``None``.  The rule reads the JAX
    shape (``utils.bridge.torch_perm`` undone), not the torch tensor's."""
    dims: Dict[str, Optional[int]] = {}
    for name, tensor in named_parameters:
        shape = tuple(tensor.shape)
        perm = torch_perm(tuple(name.split(".")))
        if perm is None:
            perm = tuple(range(len(shape)))
        jax_shape = tuple(shape[perm.index(axis)] for axis in range(len(shape)))
        sharded = spec_for(jax_shape, model_size) != ()
        dims[name] = perm.index(len(shape) - 1) if sharded else None
    return dims
