"""Process groups and device meshes (the JAX package's parallel/mesh.py).

A JAX mesh is many devices in one process; here each device is a process,
one rank of a `torch.distributed` group, and a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the group's ranks. Its two
axes are those of the JAX package:
  - 'dp': data parallel over independent transmission blocks (the words
    axis); its only collectives are the detect's all-gather and the
    gradient all-reduce of training;
  - 'sp': sequence parallel over the time axis of long streams
    (block-parallel Viterbi with overlap-save warm-up), whose boundary
    exchange is one send and receive to each neighbour per decode.

Ranks run on the card through NCCL by default, or on the CPU through gloo.
Start one process per GPU (`torchrun --nproc-per-node N ...`): NCCL takes
one rank per GPU. With nothing configured, `init_distributed` forms a
world-1 group, so that the collectives run, on one rank, in a plain
single-process run too.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from metaviterbinet_tpu_torch.device import resolve_device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str | torch.device = "cuda") -> None:
    """Join this process to the default process group: NCCL for the card,
    gloo for the CPU. Call once per process before any collective.

    The arguments (the coordinator as "host:port" or an init URL such as
    "tcp://host:port", the world size and this process's rank) are taken
    where given, else from the `torchrun` environment (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK). Where none of them is configured, a
    world-1 group forms on an in-process store. A no-op when a group exists
    already, as the JAX package's is when initialized. On the card the
    process's device is its LOCAL_RANK (0 when unset)."""
    device = resolve_device(device)
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = "nccl" if device.type == "cuda" else "gloo"
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1) and process_id in (None, 0):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of processes and this "
            f"process's id (got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
    init_method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "sp"),
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A mesh over every rank of the group (formed by `init_distributed`
    with nothing configured where none exists yet); shape None puts all
    ranks on one 'dp' axis.

    The JAX package's make_mesh can take the first n of more devices; here
    every device is a rank that runs the program, so the shape must cover
    every rank: a shape whose product differs from the world size raises
    ValueError."""
    device = resolve_device(device)
    init_distributed(device=device)
    world = dist.get_world_size()
    if shape is None:
        shape, axis_names = (world,), ("dp",)
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n != world:
        raise ValueError(f"mesh shape {shape} covers {n} of the {world} ranks: every rank "
                         "must be in the mesh")
    return init_device_mesh(device.type, shape, mesh_dim_names=tuple(axis_names[:len(shape)]))


def make_multihost_mesh(chips_per_host: Optional[int] = None,
                        axis_names: Sequence[str] = ("dp", "sp"),
                        device: str | torch.device = "cuda") -> DeviceMesh:
    """A (hosts, chips_per_host) mesh, hosts-major: row i holds the ranks
    of host i (torchrun numbers a host's ranks consecutively), so that the
    'dp' axis crosses hosts and the 'sp' axis stays within a host. The
    chips per host are `chips_per_host`, else LOCAL_WORLD_SIZE, else the
    world size (one host)."""
    device = resolve_device(device)
    init_distributed(device=device)
    world = dist.get_world_size()
    per = chips_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per:
        raise ValueError(f"{world} devices do not split into hosts of {per}")
    return make_mesh((world // per, per), axis_names, device)


def mesh_axis(mesh: DeviceMesh, name: str) -> tuple[dist.ProcessGroup, int, int]:
    """(process group, size, this rank's index) of the mesh axis `name`."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {name!r} (axes {mesh.mesh_dim_names})")
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)
