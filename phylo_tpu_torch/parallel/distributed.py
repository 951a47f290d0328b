"""Multi-process initialization (port of phylo_tpu/parallel/distributed.py).

One process per device: each process calls `initialize_distributed`
before it touches a device, and `make_mesh` then lays the mesh over the
process group.  The arguments (or the JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID environment, as the JAX package
reads it) name a `host:port` every process can reach; process 0 serves
the rendezvous there.

    from phylo_tpu_torch.parallel import initialize_distributed
    initialize_distributed(coordinator_address="localhost:29500",
                           num_processes=2, process_id=this_process)

The backend is NCCL for CUDA devices and gloo on the CPU unless the
caller names one.  Two ranks cannot share one card under NCCL (it
refuses a duplicate GPU), so ranks that share a card name
``backend="gloo"``, which takes CUDA tensors through the host.  A
failed initialization raises; no path switches backend by itself.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from phylo_tpu_torch.device import resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join this process to the process group.

    Arguments default to the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
    / JAX_PROCESS_ID environment variables; with none given and no
    environment set this is a no-op returning False (one process).
    `local_device_ids` names the CUDA devices this host's ranks use (by
    default all visible ones); the rank takes device ``local_device_ids[
    process_id % len(local_device_ids)]``.  `device` is the device type
    the ranks compute on, ``cuda`` unless the caller names ``cpu``;
    `backend` defaults to ``nccl`` on ``cuda`` and ``gloo`` on the CPU.

    Returns True when the process group was initialized.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID") is not None:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError(
            "num_processes was given without a coordinator address "
            "(--coordinator=host:port or JAX_COORDINATOR_ADDRESS): every "
            "process must name the same rendezvous")
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs num_processes and process_id "
            "(--num_processes / --process_id or JAX_NUM_PROCESSES / "
            "JAX_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        torch.cuda.set_device(ids[process_id % len(ids)])
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    """One-line description of this process's slice of the platform."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, "none"
    if torch.cuda.is_available():
        local = f"cuda:{torch.cuda.current_device()}"
        n_local = torch.cuda.device_count()
    else:
        local, n_local = "cpu", 1
    return (f"process {rank}/{world}: {local} of {n_local} local devices, "
            f"{world} global ({backend} backend)")
