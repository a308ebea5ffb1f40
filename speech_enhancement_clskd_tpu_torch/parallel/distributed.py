"""The process group and the collectives of data parallelism.

Port of ``speech_enhancement_clskd_tpu/parallel/distributed.py``.  The JAX
package runs one process per host and lets XLA insert the collectives from
sharding annotations; the port runs one process per device
(``torch.distributed``) and calls its collectives where the program needs
them: NCCL between cards, gloo on the CPU (and where two ranks share one
card, which NCCL refuses).

Usage, on every rank (``torchrun --nproc_per_node=N -m
speech_enhancement_clskd_tpu_torch distill ...`` sets the environment):

    from speech_enhancement_clskd_tpu_torch.parallel import distributed
    distributed.initialize()        # a no-op in a single process
    trainer = Trainer(cfg)          # data parallel over every rank

Every rank iterates the same seeded global batches; ``local_rows`` moves
only its own rows to its device (the JAX ``put_global_batch``).  Here
``group=None`` means a single process: no collective runs, and every
function returns what the one-process program computes.

``all_reduce`` and ``all_gather`` are ``torch.autograd.Function``s: the
backward of a sum over ranks is the sum over ranks of the gradients, and
the backward of a gather is that sum's slice of this rank's rows.  A
gathered tensor keeps the order of its axes in memory, so code that walks a
map by its strides (``losses/kd.py::_grams``) sums it in the same order as
the one-process map.

Tensor parallelism over the model axis (``parallel.mesh``) adds Megatron's
pair of collectives over the model group: ``copy_in`` (the identity, its
backward a sum over the ranks) in front of a column-parallel product and
``gather_out`` (an all-gather, its backward this rank's slice) behind it.
Every collective here is an ``all_reduce``, ``all_gather`` or
``broadcast``, which gloo has too, so the same code runs on the CPU and
with several ranks on one card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> bool:
    """Join the process group when running more than one process; a no-op
    for a single process and when the group is already up.  Returns whether
    it joined (the caller then ``leave``s).

    ``coordinator_address`` (``host:port``, or an ``init_method`` URL),
    ``num_processes`` and ``process_id`` default to torchrun's
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The
    backend follows ``device`` (NCCL for ``cuda``, on the card
    ``LOCAL_RANK`` names, gloo for ``cpu``) unless ``backend`` names one.
    A failed init raises; nothing falls back to another backend."""
    nproc = num_processes or _env_int("WORLD_SIZE")
    if nproc in (None, 1) or dist.is_initialized():
        return False
    pid = process_id if process_id is not None else _env_int("RANK")
    if pid is None:
        raise ValueError(f"{nproc} processes but no process id (RANK)")
    coord = coordinator_address
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coord is None:
        raise ValueError(f"{nproc} processes but no coordinator address (MASTER_ADDR)")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev, pid))
    dist.init_process_group(backend, init_method=coord if "://" in coord else f"tcp://{coord}",
                            world_size=nproc, rank=pid)
    return True


def leave() -> None:
    """Leave the process group ``initialize`` joined."""
    dist.destroy_process_group()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def local_device(device: Union[str, torch.device], process_id: Optional[int] = None
                 ) -> torch.device:
    """``device`` with the rank's card where it names none: ``cuda`` is
    ``cuda:LOCAL_RANK`` (else the process's rank), modulo the cards there
    are, so ranks may share one; any other device is itself."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = process_id if process_id is not None else (
            dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def world_size(group: Group = None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group = None) -> int:
    return 0 if group is None else dist.get_rank(group)


def host_local_batch_slice(global_batch: int, group: Group = None) -> Tuple[int, int]:
    """[start, end) rows of the global batch this rank takes; the last rank
    takes the remainder (the JAX arithmetic)."""
    n, i = world_size(group), rank(group)
    per = global_batch // n
    return i * per, (i + 1) * per if i < n - 1 else global_batch


def local_rows(array, batch_axis: int = 0, group: Group = None,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """This rank's rows of the global batch ``array`` (numpy or a tensor,
    the same on every rank) as a float32 tensor on ``device``: only those
    rows move.  ``batch_axis`` is the batch axis (1 for a [K, B, T] stack).
    A batch that does not divide by the group's size raises, as the JAX
    package's ``NamedSharding(P("data"))`` does."""
    x = torch.as_tensor(array, dtype=torch.float32)
    n = world_size(group)
    if n > 1:
        if x.shape[batch_axis] % n:
            raise ValueError(f"a global batch of {x.shape[batch_axis]} rows does not divide "
                             f"over {n} ranks")
        lo, hi = host_local_batch_slice(x.shape[batch_axis], group)
        x = x.narrow(batch_axis, lo, hi - lo)
    return x.to(device) if device is not None else x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself without a
    group), differentiable: the gradient of each rank's ``x`` is the sum of
    the ranks' gradients of the result."""
    return x if group is None else _AllReduce.apply(x, group)


def _memory_order(x: torch.Tensor) -> List[int]:
    return sorted(range(x.ndim), key=x.stride, reverse=True)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        order = _memory_order(x)
        xp = x.permute(order).contiguous()  # no copy for a map dense in its order
        d = order.index(dim)
        parts = [torch.empty_like(xp) for _ in range(n)]
        dist.all_gather(parts, xp, group=group)
        ctx.rows = x.shape[dim]
        inverse = sorted(range(x.ndim), key=order.__getitem__)
        return torch.cat(parts, dim=d).permute(inverse)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.rows, ctx.rows), None, None


def all_gather(x: torch.Tensor, dim: int = 0, group: Group = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (``x``
    itself without a group), each rank's part of one shape, the axes in
    ``x``'s memory order; differentiable: the gradient of each rank's part
    is its slice of the sum of the ranks' gradients."""
    return x if group is None else _AllGather.apply(x, dim, group)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_in(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``x`` itself, the input of a column-parallel product over the model
    ranks of ``group`` (Megatron's ``f``): every rank holds the same ``x``
    and contributes a part of its gradient, so the backward sums the ranks'
    gradients.  The identity without a group."""
    return x if group is None else _CopyIn.apply(x, group)


def _parts_of(x: torch.Tensor, dim: int, parts: int) -> List[torch.Tensor]:
    return list(x.chunk(parts, dim)) if parts > 1 else [x]


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, parts):
        ctx.dim, ctx.group, ctx.parts = dim, group, parts
        pieces = [torch.empty_like(x, memory_format=torch.contiguous_format)
                  for _ in range(dist.get_world_size(group))]
        dist.all_gather(pieces, x.contiguous(), group=group)
        by_rank = [_parts_of(p, dim, parts) for p in pieces]
        return torch.cat([ps[j] for j in range(parts) for ps in by_rank], dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        chunks = _parts_of(g, ctx.dim, ctx.parts * n)
        mine = [chunks[j * n + r] for j in range(ctx.parts)]
        return torch.cat(mine, dim=ctx.dim) if ctx.parts > 1 else mine[0], None, None, None


def gather_out(x: torch.Tensor, dim: int, group: Group = None, parts: int = 1) -> torch.Tensor:
    """The model ranks' slices ``x`` joined along ``dim`` (Megatron's ``g``):
    the output of a column-parallel product, or a sharded weight gathered
    whole.  ``x`` holds ``parts`` equal blocks along ``dim`` (2 for a packed
    complex map ``[re | im]``, 4 for an LSTM cell's gates), and block ``j``
    of the result is block ``j`` of every rank in rank order, so a packed
    map stays ``[re of all | im of all]``.  What follows runs replicated,
    so every rank holds the same gradient of the result, and the backward
    takes this rank's slices of it without summing (``all_gather``'s
    backward sums, which is right for data-parallel rows and multiplies
    this gradient by the ranks).  ``x`` itself without a group."""
    if group is None:
        return x
    return _GatherOut.apply(x, dim % x.ndim, group, parts)


def mean_over_ranks(xs: Sequence[torch.Tensor], group: Group = None) -> List[torch.Tensor]:
    """Each of the 0-d or equal-shaped float tensors ``xs`` averaged over
    the ranks, in one collective, outside autograd."""
    if group is None:
        return list(xs)
    stacked = torch.stack([x.detach().float() for x in xs])
    dist.all_reduce(stacked, group=group)
    stacked /= dist.get_world_size(group)
    return list(stacked.unbind(0))


@torch.no_grad()
def average_gradients(params: Sequence[torch.nn.Parameter], group: Group = None) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one all-reduce of a flat float32 buffer; a parameter without a gradient
    counts as zeros, so every rank sends the same layout."""
    if group is None:
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.numel()
        part = flat[offset:offset + n].view_as(p)
        if p.grad is None:
            p.grad = part.clone()
        else:
            p.grad.copy_(part)
        offset += n


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group: Group = None) -> None:
    """Every rank's ``tensors`` set to rank ``src``'s, one broadcast a dtype."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def sync_batch_stats(module: torch.nn.Module, group: Group = None) -> None:
    """Every batch norm of ``module`` (each submodule with a
    ``process_group``: ``ops.complex_layers.BatchNorm``,
    ``ops.complex_bn.ComplexBatchNorm``) takes its batch statistics over the
    ranks of ``group`` (``None``: its own rows)."""
    for m in module.modules():
        if hasattr(m, "process_group"):
            m.process_group = group


def barrier(group: Group = None) -> None:
    if group is not None:
        dist.barrier(group=group)
