"""Data and tensor parallelism over ``torch.distributed`` (port of
weclip_tpu/parallel/mesh.py).

One process per card, started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), each on ``cuda:LOCAL_RANK``.  ``make_mesh`` starts the
default process group: NCCL on the card, gloo where asked (the CPU tests,
or two ranks sharing one card, which NCCL refuses).  The ranks form the
JAX package's ``(data, model)`` mesh in its row-major layout: rank r is
``data_rank * model + model_rank``.  Where the JAX package shards arrays
over that mesh and lets GSPMD insert the reductions, each rank here holds
its own slice of the global batch (the same slice on every rank of a model
group) and the collectives are explicit: ``psum``/``pmean``/``pmax``/
``all_gather`` over a group (default: every rank), identities in a single
process.

The ``model`` axis is the Megatron split of the frozen ViT's MLP:
``shard_model`` keeps this rank's part of each block's ``fc_w``/``fc_b``
(hidden out) and ``proj_w`` (hidden in) and stores the mesh beside them
under ``"tp"``, where ``models/clip/vit.py::mlp_forward`` finds it and sums
the partial projections over the model group (``enter_model`` and
``leave_model``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout of this run's ranks: ``data`` x ``model`` of them, this
    process's world ``rank`` and its coordinates, and the two groups it
    reduces over (None: every rank, or no collective at width 1).  A
    sharded frozen tree carries its mesh (``shard_model``); the tree
    helpers (``vit.tree_map``) leave it as it is."""
    data: int
    rank: int
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)


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


def _new_group(ranks, world: int):
    """A group of ``ranks``; None (the default group) when it is the world.
    Every rank must make the same calls in the same order."""
    return None if len(ranks) == world else dist.new_group(ranks)


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              backend: Optional[str] = None) -> Mesh:
    """The mesh of this run: ``data_parallel`` x ``model_parallel`` ranks
    (``data_parallel`` -1 or 0: the world over ``model_parallel``).  Starts
    the default group from ``torchrun``'s environment when ``WORLD_SIZE`` >
    1 and no group is up (``backend`` default: NCCL where CUDA is
    available, else gloo), then builds the data and model groups on every
    rank.  Raises ``ValueError`` when the world is not data x model
    processes."""
    model = max(int(model_parallel or 1), 1)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1 and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    rank, world = rank_world()
    data = world // model if data_parallel in (-1, 0, None) else data_parallel
    if data < 1 or data * model != world:
        need = max(data, 1) * model
        raise ValueError(
            f"a mesh of {max(data, 1)} x {model} (data x model) ranks needs {need} "
            f"processes, this run has {world}: start one process per card with "
            f"torchrun --nproc_per_node {need}")
    data_rank, model_rank = divmod(rank, model)
    data_group = model_group = None
    if model > 1:
        for d in range(data):
            g = _new_group([d * model + m for m in range(model)], world)
            if d == data_rank:
                model_group = g
        if data > 1:
            for m in range(model):
                g = _new_group([d * model + m for d in range(data)], world)
                if m == model_rank:
                    data_group = g
    return Mesh(data=data, rank=rank, model=model, data_rank=data_rank,
                model_rank=model_rank, data_group=data_group, model_group=model_group)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} not divisible by {mesh.data} ranks")
    return global_batch // mesh.data


def dp_only(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` splits the batch over more than one data rank."""
    return mesh is not None and mesh.data > 1


def barrier() -> None:
    """Wait for every rank; nothing in a single process."""
    if rank_world()[1] > 1:
        dist.barrier()


# -- the MLP split ------------------------------------------------------------

_SPLIT = {"fc_w": -2, "fc_b": -1, "proj_w": -1}   # leaf -> its hidden dim


def shard_model(mesh: Mesh, tree):
    """``tree`` with this rank's part of every ``mlp`` dict's ``fc_w``
    (hidden out, dim -2), ``fc_b`` (dim -1) and ``proj_w`` (hidden in, dim
    -1): slice ``model_rank`` of ``model`` along that dim, the JAX
    package's ``model_shardings``.  A leaf whose dim the model width does
    not divide stays whole, and so does every other leaf (attention, the
    LayerNorms, ``proj_b``, the embeddings, the text features).  An ``mlp``
    dict whose leaves were sliced gains ``"tp": mesh``.  ``tree`` itself is
    unchanged; at model width 1 it is returned as it is."""
    if mesh.model == 1:
        return tree

    def mlp(d):
        out, sliced = dict(d), []
        present = [name for name in _SPLIT if name in d]
        for name in present:
            t, dim = d[name], _SPLIT[name]
            if t.shape[dim] % mesh.model:
                continue
            n = t.shape[dim] // mesh.model
            out[name] = t.narrow(dim, mesh.model_rank * n, n).contiguous()
            sliced.append(name)
        if sliced and sliced != present:
            raise ValueError(f"mlp leaves {sliced} split by {mesh.model}, the rest of "
                             f"{present} not: their hidden dims disagree")
        if sliced:
            out["tp"] = mesh
        return out

    def walk(t, key=None):
        if isinstance(t, dict):
            if key == "mlp":
                return mlp(t)
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(tree)


def mesh_of(tree) -> Optional[Mesh]:
    """The mesh a tree was sharded over by ``shard_model``, or None."""
    if isinstance(tree, Mesh):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            m = mesh_of(v)
            if m is not None:
                return m
    return None


def data_shard(tree):
    """(index, count, group) of this rank's share of the data: the data
    coordinates of the mesh ``tree`` was sharded over, else this rank of
    the world (data parallel only, or one process)."""
    mesh = mesh_of(tree)
    if mesh is not None:
        return mesh.data_rank, mesh.data, mesh.data_group
    rank, world = rank_world()
    return rank, world, None


def _backend_device(group) -> torch.device:
    """Where ``group``'s backend takes tensors: NCCL the current card,
    gloo the host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sum_partials(y: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``y`` over ``group``, in fp32, rounded once to ``y``'s dtype:
    under bf16 each rank's partial is already rounded, so at width 2 this
    is a bf16 add, and gloo and NCCL give the same numbers."""
    acc = y.detach().to(_backend_device(group), torch.float32, copy=True)
    dist.all_reduce(acc, group=group)
    return acc.to(y.device, y.dtype)


class _EnterModel(torch.autograd.Function):
    """Megatron's "f": identity forward; the backward sums the input's
    gradient over the model group (each rank holds only its shard's part
    of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_partials(g, ctx.group), None


class _LeaveModel(torch.autograd.Function):
    """Megatron's "g": the forward sums the partial outputs over the model
    group; identity backward (the summed output is replicated, so its
    gradient is already whole on every rank)."""

    @staticmethod
    def forward(ctx, y, group):
        return _sum_partials(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a split MLP (see ``_EnterModel``)."""
    return _EnterModel.apply(x, mesh.model_group)


def leave_model(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The summed output of a split MLP (see ``_LeaveModel``)."""
    return _LeaveModel.apply(y, mesh.model_group)


# -- collectives ----------------------------------------------------------------

def _size(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    """``op`` over ``group`` on a copy of ``x``, on the device the backend
    takes, returned on ``x``'s device."""
    if _size(group) == 1:
        return x
    y = x.detach().to(_backend_device(group), copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (default: every rank)."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    return psum(x, group) / _size(group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order (an
    all-reduce of zero-padded slots, so gloo takes CUDA tensors too)."""
    n = _size(group)
    if n == 1:
        return x
    slots = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
    slots[dist.get_rank(group)] = x
    return torch.cat(list(psum(slots, group).unbind(0)), dim=axis)
