"""Device mesh construction (port of phylo_tpu/parallel/mesh.py).

One process per device.  The mesh lays the process group's ranks out
row-major over its shape and makes one process group per axis line:

* ``'s'`` -- sites.  Per-site log-likelihood terms are additive and
  every rank kernel is elementwise in S, so each rank runs the kernels
  on its site block and the per-particle site sums are all-reduced over
  's' (the long-alignment axis: DS1 at S=1949 and beyond).
* ``'k'`` -- particles.  Each rank holds K/k particles' messages;
  resampling makes a particle's children live on any rank, so they are
  fetched by one exchange over 'k' a rank step (parallel.collectives).

Asking for a mesh with no process group starts a world of one on a
local store, so a one-device mesh runs in one process.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from phylo_tpu_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of the process group's ranks.

    shape: {axis name: size}, in axis order (as a JAX Mesh's `shape`).
    coords: {axis name: this rank's index along it}.
    groups: {axis name: the process group of this rank's line along it}.
    """

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict = field(repr=False)
    rank: int = 0

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def _start_local_world(device):
    """A world of one on an in-memory store (NCCL on cuda, else gloo)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape=None, axis_names=("k", "s"), devices=None, device=None):
    """Build a Mesh over the process group (one process per device).

    shape: tuple matching axis_names; None puts every process on the
    last ('s') axis.  A 1-element shape is a pure site mesh ('s',).
    devices: the global devices, one a process (default: the process
    group's ranks); only their number is read.  device: the device type
    of a world of one started here (``cuda`` unless ``cpu``).  The mesh
    takes the whole process group: every process runs one shard.
    """
    n_dev = len(devices) if devices is not None else _world_size()
    if shape is None:
        shape = (n_dev,)
    shape = tuple(int(x) for x in shape)
    if len(shape) == 1:
        axis_names = (axis_names[-1],)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{tuple(axis_names)}")
    n = int(np.prod(shape))
    if n > n_dev:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {n_dev}")
    if n < _world_size():
        raise ValueError(
            f"mesh shape {shape} covers {n} of the {_world_size()} "
            "processes; run one process per mesh device")
    if not dist.is_initialized():
        _start_local_world(device)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in
                                   np.argwhere(grid == rank)[0])))
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            ranks = [int(r) for r in line]
            # every rank creates every group, in the same order
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[name] = g
    return Mesh(axis_names=tuple(axis_names),
                shape=dict(zip(axis_names, shape)), coords=coords,
                groups=groups, rank=rank)
