"""Data parallelism over ``torch.distributed`` (port of
weclip_tpu/parallel/mesh.py).

One process per card, started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), each on ``cuda:LOCAL_RANK``.  ``make_mesh`` starts the
default process group: NCCL on the card, gloo where asked (the CPU tests,
or two ranks sharing one card, which NCCL refuses).  Where the JAX package
shards the batch axis over a device mesh and lets GSPMD insert the
reductions, each rank here holds its own slice of the global batch and the
collectives below are explicit: ``psum``/``pmean``/``pmax``/``all_gather``
over the default group, identities in a single process.  The Megatron MLP
split over a ``model`` axis is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel layout of this process: ``data`` ranks and this
    process's ``rank`` (no model axis: the MLP split is not ported)."""
    data: int
    rank: int


def rank_world():
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device: str) -> str:
    """``device`` with the card index of ``LOCAL_RANK`` where ``device`` is
    a bare ``cuda`` in a multi-process run."""
    if device == "cuda" and rank_world()[1] > 1:
        return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return device


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              backend: Optional[str] = None) -> Mesh:
    """The mesh of this run: ``data_parallel`` ranks (-1 or 0: the whole
    world).  Starts the default group from ``torchrun``'s environment when
    ``WORLD_SIZE`` > 1 and no group is up (``backend`` default: NCCL where
    CUDA is available, else gloo).  Raises ``ValueError`` when the world is
    not ``data_parallel`` processes."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"mesh.model_parallel {model_parallel}: the tensor-parallel MLP split "
            f"is not ported (ROADMAP.md §1 item 1); use model_parallel 1")
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1 and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    rank, world = rank_world()
    n = world if data_parallel in (-1, 0, None) else data_parallel
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs {n} processes, this run has {world}: "
            f"start one process per card with torchrun --nproc_per_node {n}")
    return Mesh(data=n, rank=rank)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} not divisible by {mesh.data} ranks")
    return global_batch // mesh.data


def dp_only(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` splits the batch over more than one rank."""
    return mesh is not None and mesh.data > 1


def barrier() -> None:
    """Wait for every rank; nothing in a single process."""
    if rank_world()[1] > 1:
        dist.barrier()


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    """``op`` over the group on a copy of ``x``, on the device the backend
    takes (NCCL: the current card; gloo: the host), returned on ``x``'s
    device."""
    if rank_world()[1] == 1:
        return x
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    y = x.detach().to(dev, copy=True)
    dist.all_reduce(y, op=op)
    return y.to(x.device)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks."""
    return _reduce(x, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor) -> torch.Tensor:
    return psum(x) / rank_world()[1]


def pmax(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order (an
    all-reduce of zero-padded slots, so gloo takes CUDA tensors too)."""
    rank, world = rank_world()
    if world == 1:
        return x
    slots = torch.zeros((world, *x.shape), dtype=x.dtype, device=x.device)
    slots[rank] = x
    return torch.cat(list(psum(slots).unbind(0)), dim=axis)
