"""Joining ranks into one process group, and the node mesh over it (port of
`open_simulator_tpu/parallel/distributed.py`).

`initialize()` is `torch.distributed.init_process_group` with torchrun's
variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or the
caller's arguments, and a timeout: a rank that dies fails the others within
it instead of hanging them. One process is a no-op, as JAX's `initialize`.

The backend is stated, never guessed in silence (`choose_backend`): NCCL when
every rank has a CUDA device of its own, gloo on the CPU or when ranks share
a card (NCCL refuses two ranks on one device; the collectives then stage
CUDA tensors through host memory, see collectives.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..simulator.engine import resolve_device
from .mesh import NodeMesh, make_node_mesh

DEFAULT_TIMEOUT_S = 120.0


def choose_backend(device, world_size: int) -> str:
    """"nccl" when the ranks run on CUDA and this host has a card for every
    local rank (LOCAL_WORLD_SIZE, else the world), "gloo" otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or form) the process group. Arguments fall back to torchrun's
    variables (`init_method` to env:// with MASTER_ADDR / MASTER_PORT).
    `device` ("cuda", the default, or "cpu"; without a card only an explicit
    "cpu" runs) picks the backend when `backend` is None; with NCCL the
    rank's card is cuda:LOCAL_RANK.
    Returns True when running distributed (world size > 1); for one process
    it does nothing and returns False."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    device = resolve_device(device)
    backend = backend or choose_backend(device, world_size)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def node_mesh_local(device=None) -> NodeMesh:
    """The node mesh over every rank of the process group (one shard each);
    a one-shard mesh when no group is initialized."""
    return make_node_mesh(device=device)


def make_global_mesh(scenario_axis: Optional[int] = None, device=None) -> NodeMesh:
    """JAX's (scenarios, nodes) mesh over every rank of the process group:
    `scenario_axis` > 1 groups the ranks into that many scenario groups of
    consecutive ranks (a ScenarioMesh, `make_node_mesh(scenario_axis=k)`);
    None or 1 is the node mesh over every rank. (JAX's default, one
    scenario group per process of several devices, has no counterpart in
    a port whose every process is one device.)"""
    return make_node_mesh(device=device, scenario_axis=scenario_axis or 1)
