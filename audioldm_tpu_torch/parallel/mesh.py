"""Process groups for data and tensor parallelism (port of
audioldm_tpu/parallel/mesh.py).

The JAX package is single-controller: one process places global arrays on a
device mesh and XLA inserts the collectives. The port runs one process a
device, launched by ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N``), so a JAX ``device_put`` of a global array becomes
"every rank computes the global thing identically, then keeps its rows"
(``shard_batch``), and every collective is written out.

A ``Mesh`` names its axes (``dp``, ``tp``) and holds, for each axis, the
process group of the ranks that share this rank's other coordinates. Ranks
are laid out row-major over the axes, the last axis fastest: on a
``(dp, tp)`` mesh rank ``d * tp + t`` sits at ``(d, t)``, so a tp group is
a run of adjacent ranks (adjacent GPUs, the fastest links) and its
all-reduces, one a block, stay there; dp's one gradient all-reduce a step
crosses them.

The backend follows the device: NCCL on ``cuda:LOCAL_RANK``, gloo on the
CPU. Nothing falls back: a mesh asked for on ``cuda`` without a GPU raises,
as every entry point of the port does, and a process group already joined
with another backend than the device's is refused.

The JAX ``batch_sharding`` and ``replicated`` are ``NamedSharding`` objects
that tell XLA where an array lives; they have no counterpart here, where
every tensor lives on its own rank's device.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from audioldm_tpu_torch import resolve_device


def torchrun_hint(n: int) -> str:
    """How to start ``n`` processes, for messages that refuse a size."""
    return f"python -m torch.distributed.run --nproc-per-node {n} -m audioldm_tpu_torch.cli ..."


def world_size() -> int:
    """Processes of this job: the default group's size once it is joined,
    else ``WORLD_SIZE`` (set by torchrun), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _local_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    return dev


def init_distributed(device="cuda") -> torch.device:
    """Join the default process group (create it when this process is not
    under torchrun: a world of one through a ``file://`` rendezvous) and
    return this rank's device. NCCL for a CUDA device, gloo for the CPU."""
    dev = _local_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have!r}, but a {dev.type} mesh needs {backend!r}")
        return dev
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        rdzv = os.path.join(tempfile.mkdtemp(prefix="audioldm_rdzv_"), "rdzv")
        dist.init_process_group(backend, init_method=f"file://{rdzv}", world_size=1, rank=0)
    return dev


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of the default group. ``shape`` maps each
    axis to its size (in axis order), ``groups`` each axis to the process
    group along it, ``coords`` this rank's index along each axis."""

    shape: dict
    rank: int
    coords: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def _make(axes: Sequence[str], sizes: Sequence[int], device) -> Mesh:
    dev = init_distributed(device)
    n, world = math.prod(sizes), dist.get_world_size()
    if n != world:
        raise ValueError(f"a {dict(zip(axes, sizes))} mesh needs {n} processes, but {world} are running: "
                         f"launch with {torchrun_hint(n)}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(tuple(sizes))
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, tuple(sizes)))))
    groups = {}
    for i, axis in enumerate(axes):
        if len(axes) == 1:
            groups[axis] = dist.group.WORLD
            continue
        # every run of ranks along this axis; each rank makes every group, in one order
        runs = np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist()
        groups[axis], _ = dist.new_subgroups_by_enumeration(runs)
    return Mesh(dict(zip(axes, sizes)), rank, coords, groups, dev)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp", device="cuda") -> Mesh:
    """A 1-D mesh over every process of the job (``n_devices`` defaults to
    the world size and must equal it)."""
    return _make((axis_name,), (n_devices or world_size(),), device)


def _rows(x, k: int, i: int, axis: int, what: str):
    n = x.shape[axis]
    if n % k:
        raise ValueError(f"{what}: {n} rows on axis {axis} do not split over {k} ranks")
    m = n // k
    if torch.is_tensor(x):
        return x.narrow(axis, i * m, m)
    return np.asarray(x)[(slice(None),) * axis + (slice(i * m, (i + 1) * m),)]


def shard_batch(mesh: Mesh, batch, axis_name: str = "dp", batch_axis: int = 0):
    """This rank's contiguous rows of a global batch (a dict, list or tuple
    of tensors or arrays), along ``batch_axis``; leaves of no more dims than
    ``batch_axis`` (a batch's scalar metadata) stay whole. ``batch_axis=1``
    is the gradient-accumulation layout ``[accum, micro, ...]``: every rank
    runs every accumulation step on its rows of the micro-batch."""
    k, i = mesh.axis_size(axis_name), mesh.coords.get(axis_name, 0)

    def leaf(x):
        if isinstance(x, dict):
            return {key: leaf(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)) and not isinstance(x, str):
            return type(x)(leaf(v) for v in x)
        if k == 1 or np.ndim(x) <= batch_axis or isinstance(x, str):
            return x
        return _rows(x, k, i, batch_axis, "shard_batch")

    return leaf(batch)


def local_rows(mesh: Optional[Mesh], x, axis_name: str = "dp"):
    """This rank's contiguous rows of ``x`` along dim 0 (``x`` itself
    without a mesh or on an axis of size 1)."""
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return x
    return _rows(x, mesh.axis_size(axis_name), mesh.coords[axis_name], 0, "local_rows")


def gather_rows(mesh: Mesh, x: torch.Tensor, axis_name: str = "dp") -> torch.Tensor:
    """The rows of every rank along ``axis_name``, concatenated in rank
    order along dim 0, on every rank (``all_gather``)."""
    k = mesh.axis_size(axis_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(k)]
    dist.all_gather(parts, x, group=mesh.groups[axis_name])
    return torch.cat(parts)


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Mesh, axis_name: str = "dp", mean: bool = True) -> None:
    """Sum (``mean``: average) ``tensors`` over the ranks along
    ``axis_name``, in place, as one all-reduce of their flattened
    concatenation: DDP's bucketed arithmetic in a single bucket."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.groups[axis_name])
    if mean:
        flat /= mesh.axis_size(axis_name)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))
