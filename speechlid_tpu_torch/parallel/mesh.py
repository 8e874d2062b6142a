"""Process groups and the data-parallel mesh (port of
``speechlid_tpu/parallel/mesh.py``, the data axis).

The JAX package runs one program over a ``("data", "model")`` mesh: the
batch's leading axis is sharded on ``data``, the state replicated, and XLA
inserts the gradient all-reduce.  Here the layout is one process per card,
the JAX multi-process layout with one device per process, over
``torch.distributed``:

- :func:`initialize_multihost` is the rendezvous (``jax.distributed
  .initialize``): ``env://`` by default (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, as ``python -m torch.distributed.run``
  sets them), or an explicit ``init_method`` (``tcp://host:port``,
  ``file://path``) with the world size and the rank.  The backend is nccl
  for a CUDA device and gloo for the CPU;
- :func:`process_index` / :func:`process_count` are ``jax.process_index`` /
  ``jax.process_count``;
- :func:`make_mesh` describes the data axis; a ``model`` axis (tensor,
  expert, pipeline parallelism) comes with the next slice and raises;
- :func:`replicate` broadcasts a module's parameters and buffers from rank
  0, the counterpart of placing the state replicated.

Each process feeds its own sampler shard (``MultiBatchSampler(shard_id,
num_shards)``) of ``data.batch_size`` rows, so the global batch is the
ranks' batches concatenated; the trainer all-reduces the gradients, the
train-mode BatchNorms all-reduce their statistics and the metrics gather
their rows (``metrics/dist.py``).

With no process group initialised every function here is a one-process
no-op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(minutes=10)

# the gloo group that carries host tensors when the default group is nccl,
# made once per default group (every rank creates it at the same point)
_HOST_GROUPS: dict = {}


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
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        _HOST_GROUPS.pop(id(dist.group.WORLD), None)
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def data_parallel() -> bool:
    """More than one process in the group: batch statistics, gradients and
    metrics span the ranks."""
    return process_count() > 1


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward
    all-reduces the gradient, so a loss on one rank reaches every rank's
    inputs (the BatchNorm statistics' cross-rank terms)."""
    from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

    return differentiable_all_reduce(t)


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


@dataclass(frozen=True)
class Mesh:
    """The ``("data", "model")`` mesh of the process group: ``data`` ranks,
    one card each; ``model`` is 1."""

    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The data-parallel mesh over the process group (one process per card;
    ``data=None`` → every process).  ``model`` > 1 raises."""
    if model > 1:
        raise NotImplementedError(
            "make_mesh(model > 1): tensor, expert and pipeline layouts "
            "(parallel/sharding.py, parallel/pipeline.py) come with the next slice")
    n = process_count()
    if data is None:
        data = n
    if data != n:
        raise ValueError(f"one process per card: a data axis of {data} needs {data} "
                         f"processes, the group has {n}")
    return Mesh(data=data, model=1)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every
    rank starts from rank 0's state.  → ``module``."""
    if process_count() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
