"""Process groups and the device mesh (port of ``speechlid_tpu/parallel/mesh.py``).

The JAX package runs one program over a named mesh: the batch's leading
axis is sharded on ``data``, the parameters are placed by the rules of
``parallel/sharding.py`` on ``model``, and XLA inserts every collective.
Here the layout is one process per card, the JAX multi-process layout with
one device per process, over ``torch.distributed``:

- :func:`initialize_multihost` is the rendezvous (``jax.distributed
  .initialize``): ``env://`` by default (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, as ``python -m torch.distributed.run``
  sets them), or an explicit ``init_method`` (``tcp://host:port``,
  ``file://path``) with the world size and the rank.  The backend is nccl
  for a CUDA device and gloo for the CPU;
- :func:`process_index` / :func:`process_count` are ``jax.process_index`` /
  ``jax.process_count``;
- :func:`make_mesh` lays the ranks out row-major over the axes ``(data,
  seq, stage, model)``, as the JAX ``make_mesh`` reshapes its devices: at
  ``(data, model)`` rank r has data index ``r // model`` and model index
  ``r % model``.  For every axis it makes the groups of the ranks that
  differ only along it (the **data group** of a rank holds the ranks with
  its model index, the **model group** those with its data index), each
  made once, in the same order, on every rank;
- :func:`replicate` broadcasts a module's replicated tensors from rank 0,
  and each tensor that a layout slices over the model group from the rank
  of its data group with data index 0.

Every collective names its group: :func:`all_reduce`, :func:`all_gather`
and :func:`broadcast` take one (a mesh's ``group(axis)``), and
:func:`data_group` is the current mesh's (the last :func:`make_mesh`; the
whole world where none was made).  The differentiable pieces of tensor
parallelism are here too: :func:`copy_to_group` (identity forward, sum of
the gradients backward), :func:`reduce_from_group` (sum forward, identity
backward) and :func:`gather_from_group` (the slots of the group's ranks
concatenated forward, this rank's slot of the gradient backward).

gloo takes CUDA tensors for ``broadcast``, ``all_reduce`` and ``barrier``
only, so the all-gather here is an all-reduce of a zero buffer with each
rank's slot filled (adding zeros is exact), on every backend alike.

With no process group initialised every function here is a one-process
no-op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(minutes=10)
AXES = ("data", "seq", "stage", "model")  # row-major rank order

# the gloo group that carries host tensors when the default group is nccl,
# made once per default group (every rank creates it at the same point)
_HOST_GROUPS: dict = {}
_CURRENT: List["Mesh"] = []  # the mesh the last make_mesh built


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group.  ``coordinator_address`` is an
    ``init_method`` (``tcp://host:port`` or ``file://path``; a bare
    ``host:port`` means tcp), default ``env://``; ``num_processes`` and
    ``process_id`` are the world size and the rank (from the environment
    under ``env://``).  Without a launcher's environment (no ``RANK`` and no
    address) it forms a group of one process, so a one-card run takes the
    same path.  ``backend`` defaults to nccl for a CUDA ``device`` and gloo
    for the CPU; a group that fails to form raises.  A process already in a
    group stays in it."""
    if initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if coordinator_address is None and "RANK" not in os.environ:
        if num_processes not in (None, 1):
            raise ValueError("a group of several processes needs an address or env://")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        address = coordinator_address or "env://"
        if "://" not in address:
            address = "tcp://" + address
        dist.init_process_group(backend, init_method=address, timeout=timeout,
                                world_size=-1 if num_processes is None else num_processes,
                                rank=-1 if process_id is None else process_id)
    host_group()  # collective: every rank makes it here, together


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined), after every
    rank has come this far: a rank that tore its connections down while a
    peer still read its last collective's data aborted that peer."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        _HOST_GROUPS.pop(id(dist.group.WORLD), None)
        _CURRENT.clear()
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def host_group():
    """The group that carries host (CPU) tensors: the default group under
    gloo, else one gloo group over the same ranks (nccl takes only CUDA
    tensors).  The first call is a collective."""
    if not initialized() or dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _HOST_GROUPS:
        _HOST_GROUPS[key] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[key]


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, over the host group.
    One process: ``[obj]``."""
    if not initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def barrier() -> None:
    if initialized():
        dist.barrier(group=host_group())


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Group:
    """The ranks along one axis through this rank: ``ranks`` in axis order,
    ``handle`` the process group (``None`` when it is the whole world),
    ``host`` a gloo group over the same ranks where the default backend is
    nccl (``None``: ``handle`` carries host tensors too)."""

    ranks: tuple
    handle: object = None
    host: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position along the axis."""
        return self.ranks.index(process_index()) if self.size > 1 else 0


_SOLO = Group(ranks=(0,))


@dataclass(frozen=True)
class Mesh:
    """The process group's mesh, one card a rank: ``data`` × ``seq`` ×
    ``stage`` × ``model`` ranks, row-major in that order.  ``shape`` names
    ``data`` and ``model`` always and ``seq`` / ``stage`` where they exceed
    one, as the JAX meshes of the trainer, the dryrun and the pipeline name
    their axes."""

    data: int
    model: int = 1
    seq: int = 1
    stage: int = 1
    groups: Dict[str, Group] = field(default_factory=dict, compare=False, repr=False)
    pairs: Dict[int, Group] = field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        shape = {"data": self.data}
        shape.update({a: getattr(self, a) for a in ("seq", "stage") if getattr(self, a) > 1})
        shape["model"] = self.model
        return shape

    @property
    def size(self) -> int:
        return self.data * self.seq * self.stage * self.model

    def group(self, axis: str) -> Group:
        """This rank's group along ``axis`` (a group of one where the axis
        has size 1)."""
        return self.groups.get(axis, _SOLO)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return _coords(process_index(), self)[axis]

    def pair(self, stage: int) -> Group:
        """The two-rank group of stages ``stage`` and ``stage + 1`` of this
        rank's stage line (the pipeline's point-to-point link)."""
        return self.pairs[stage]


def _coords(rank: int, mesh: Mesh) -> dict:
    coords = {}
    for axis in reversed(AXES):
        n = getattr(mesh, axis)
        coords[axis] = rank % n
        rank //= n
    return coords


def _rank(coords: dict, mesh: Mesh) -> int:
    r = 0
    for axis in AXES:
        r = r * getattr(mesh, axis) + coords[axis]
    return r


def _new_group(ranks: Sequence[int], world: int) -> Group:
    """A group over ``ranks`` (a collective over the world: every rank calls
    it for every group, in one order)."""
    ranks = tuple(ranks)
    if len(ranks) == world:
        return Group(ranks, None, host_group())
    handle = dist.new_group(list(ranks))
    host = dist.new_group(list(ranks), backend="gloo") if dist.get_backend() != "gloo" else None
    return Group(ranks, handle, host)


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1,
              stage: int = 1) -> Mesh:
    """The mesh over the process group (one process per card; ``data=None``
    → the ranks the other axes leave).  A product that differs from the
    world size raises.  Every rank must call it, with the same sizes: it
    makes the axes' groups.  It becomes the current mesh."""
    n = process_count()
    rest = model * seq * stage
    if data is None:
        if n % rest:
            raise ValueError(f"a mesh of model={model}, seq={seq}, stage={stage} needs a "
                             f"multiple of {rest} processes, the group has {n}")
        data = n // rest
    if data * rest != n:
        raise ValueError(f"one process per card: a mesh of {data}x{seq}x{stage}x{model} "
                         f"(data x seq x stage x model) needs {data * rest} processes, "
                         f"the group has {n}")
    mesh = Mesh(data=data, model=model, seq=seq, stage=stage)
    if n > 1:
        me = _coords(process_index(), mesh)
        for axis in AXES:
            size = getattr(mesh, axis)
            if size == 1:
                continue
            # every line along the axis, in one order on every rank
            others = [a for a in AXES if a != axis]
            lines = _lines(mesh, others)
            for fixed in lines:
                ranks = [_rank({**fixed, axis: i}, mesh) for i in range(size)]
                group = _new_group(ranks, n)
                if all(fixed[a] == me[a] for a in others):
                    mesh.groups[axis] = group
        if stage > 1:
            for fixed in _lines(mesh, [a for a in AXES if a != "stage"]):
                for s in range(stage - 1):
                    ranks = [_rank({**fixed, "stage": i}, mesh) for i in (s, s + 1)]
                    group = _new_group(ranks, n)
                    if all(fixed[a] == me[a] for a in fixed):
                        mesh.pairs[s] = group
    _CURRENT[:] = [mesh]
    return mesh


def _lines(mesh: Mesh, axes: List[str]) -> List[dict]:
    """Every combination of indices along ``axes``, row-major."""
    out = [{}]
    for axis in axes:
        out = [{**c, axis: i} for c in out for i in range(getattr(mesh, axis))]
    return out


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[0] if _CURRENT else None


def world_group() -> Group:
    """Every rank of the process group."""
    n = process_count()
    return Group(tuple(range(n)), None, host_group()) if n > 1 else _SOLO


def data_group() -> Group:
    """The current mesh's data group; the whole world where no mesh was made."""
    mesh = current_mesh()
    return mesh.group("data") if mesh is not None else world_group()


def data_parallel() -> bool:
    """More than one rank in the data group: batch statistics, gradients and
    metrics span them."""
    return data_group().size > 1


# ---------------------------------------------------------------------------
# collectives over a named group
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable: its backward sums the
    gradient over the group, so a loss on one rank reaches every rank's
    inputs (the BatchNorm statistics' cross-rank terms).  A group of one:
    ``t``."""
    if group.size == 1:
        return t
    from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

    return differentiable_all_reduce(t, group=_handle(group))


def _handle(group: Group):
    return group.handle if group.handle is not None else dist.group.WORLD


def host_handle(group: Group):
    """The process group that carries ``group``'s host tensors."""
    return group.host if group.host is not None else _handle(group)


def all_reduce_(t: torch.Tensor, group: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, no gradient: ``t`` reduced by ``op`` over ``group``."""
    if group.size > 1:
        dist.all_reduce(t, op=op, group=_handle(group))
    return t


def broadcast(t: torch.Tensor, group: Group, src_index: int = 0) -> torch.Tensor:
    """In place, no gradient: ``t`` from the rank at ``src_index`` of
    ``group`` to every rank of it."""
    if group.size > 1:
        dist.broadcast(t, src=group.ranks[src_index], group=_handle(group))
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = 0,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in rank order, no
    gradient: an all-reduce of a zero buffer holding each rank's slot.
    ``sizes``: every rank's length along ``dim`` (default: all alike)."""
    if group.size == 1:
        return t
    dim = dim % t.dim()
    sizes = list(sizes) if sizes is not None else [t.shape[dim]] * group.size
    full = t.new_zeros(t.shape[:dim] + (sum(sizes),) + t.shape[dim + 1:])
    start = sum(sizes[:group.index])
    full.narrow(dim, start, sizes[group.index]).copy_(t)
    return all_reduce_(full, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim = group, dim
        ctx.sizes = list(sizes) if sizes is not None else [x.shape[dim]] * group.size
        return all_gather(x.contiguous(), group, dim, ctx.sizes)

    @staticmethod
    def backward(ctx, g):
        start = sum(ctx.sizes[:ctx.group.index])
        return g.narrow(ctx.dim, start, ctx.sizes[ctx.group.index]).contiguous(), None, None, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` (the same on every rank of ``group``) as the input of work
    split over the group: identity forward; backward the sum of the ranks'
    gradients, each rank's being its share's."""
    return x if group.size == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial results: forward an
    all-reduce, backward identity (the sum's gradient reaches every
    partial as it is)."""
    return x if group.size == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Group, dim: int,
                      sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``, differentiable: the
    backward keeps this rank's slice of the (replicated) gradient."""
    return x if group.size == 1 else _GatherFromGroup.apply(x, group, dim % x.dim(), sizes)


@torch.no_grad()
def average_grads(module: torch.nn.Module) -> None:
    """Every parameter's gradient averaged over the data group, the global
    batch's.  Under a layout (``module.layout``, set by
    ``parallel.sharding``) a parameter held whole is averaged over the world
    instead: a model group's ranks computed the same value, so the mean is
    unchanged, but after it the ranks hold the same bits where their
    backward summed in another order (atomics), and their replicated
    parameters stay equal."""
    params = list(module.parameters())
    layout = getattr(module, "layout", None)
    if layout is None or layout.group.size == 1:
        _average(params, data_group())
        return
    split = [getattr(p, "sharded_over", None) is not None for p in params]
    _average([p for p, s in zip(params, split) if not s], world_group())
    _average([p for p, s in zip(params, split) if s], data_group())


def _average(params: List[torch.nn.Parameter], group: Group) -> None:
    """``params``' gradients summed over ``group`` and divided by its size,
    in one flat all-reduce of a fixed parameter list (the group's ranks hold
    the same tensors); a count a parameter says which ranks had a gradient,
    and a parameter none had keeps ``grad = None``."""
    if not params or group.size == 1:
        return
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
         for p in params]
        + [torch.tensor([float(p.grad is not None) for p in params], device=params[0].device)])
    all_reduce_(flat, group)
    counts = flat[-len(params):].tolist()
    offset = 0
    for p, count in zip(params, counts):
        n = p.numel()
        if count:
            p.grad = (flat[offset:offset + n] / group.size).view_as(p).to(p.dtype)
        offset += n


# ---------------------------------------------------------------------------
# state and batches
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's data-index share of a host batch's leading axis (the
    counterpart of placing it sharded on ``data``); a leaf whose leading
    axis does not divide, and a scalar, stays whole."""
    n, d = mesh.data, mesh.index("data")

    def take(x):
        if getattr(x, "ndim", 0) < 1 or x.shape[0] % n:
            return x
        rows = x.shape[0] // n
        return x[d * rows:(d + 1) * rows]

    return {k: take(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s tensors so every rank starts alike: the
    replicated ones from rank 0, then each one that its layout
    (``module.layout``, set by ``parallel.sharding``) holds sliced over the
    model group from the rank of this rank's data group with data index 0.
    → ``module``."""
    if process_count() > 1:
        layout = getattr(module, "layout", None)
        local = layout.local_names() if layout is not None else set()
        tensors = list(module.state_dict(keep_vars=True).items())
        for name, t in tensors:
            if name not in local:
                dist.broadcast(t.data, src=0)
        for name, t in tensors:
            if name in local:
                broadcast(t.data, data_group())
    return module
