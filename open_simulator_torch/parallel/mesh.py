"""The node-axis mesh on `torch.distributed` (port of the node-axis part of
`open_simulator_tpu/parallel/mesh.py`).

Design. Every rank runs the same `Simulator` on the same input: it encodes
the same `BatchTables` and holds the whole tables and carry, replicated.
Only the epoch front of the two wave kernels is sharded: rank r computes on
nodes [r*NL, (r+1)*NL), NL = N / shards, exactly as the JAX `shard_map`
in_specs slice them. Each epoch of `schedule_wave` and
`schedule_affinity_wave` then makes exactly two collectives
(collectives.py): one `pmax` of a stacked vector that holds every
normalizer (mins ride negated: -max(-x) == min(x)) and one tiled
`all_gather` of the payload, the rank's score-table block and the per-node
rows the selection reads. After the all-gather, the selection tail runs on
every rank on the full-width arrays, so the per-node counts, `placed`, the
epoch statistics and K3c's new carry are equal on every rank (JAX's
out_specs `P()`); no other collective is needed. The serial routes (K2,
K4, K1, K7) and the commit (K3c) run replicated on every rank.

The epoch path is taken as JAX takes it (`_mesh_axis_shards`,
ops/kernels.py `_epoch_shards`): more than one shard, N a multiple of the
shard count and N at most OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES (default
2,048). Otherwise the kernels run unsharded on every rank, which gives the
same placements (JAX keeps XLA's per-round GSPMD form there; the port has
no partitioned layout yet: ROADMAP A12b). The encoder pads the node axis to
a multiple of the shard count with phantom nodes, infeasible for every pod.

Not ported (ROADMAP A12b): the partitioned table layout
(`table_shardings`, `carry_shardings`, `to_device_sharded`,
`carry_reshard_bytes`) and the per-round GSPMD forms above the limit; (A12c)
the scenario axis with the probe, serve and sweep fan-outs on it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..simulator.encode import pad_batch_tables as _pad_batch_tables
from ..simulator.engine import resolve_device

NODE_AXIS = "nodes"
EPOCH_MAX_NODES = 2048  # the default of OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES (JAX :832)

# Node-axis padding lives with the encoder; re-exported for the mesh's callers.
pad_batch_tables = _pad_batch_tables

_A12C = "the scenario axis of the mesh is not ported yet (ROADMAP A12c)"


def _zero_counts() -> dict:
    return {"pmax": {"calls": 0, "bytes": 0}, "all_gather_tiled": {"calls": 0, "bytes": 0}}


@dataclasses.dataclass
class NodeMesh:
    """One rank's view of the node mesh: its process group (None for one
    shard), rank, shard count and device; the backend and the transport the
    collectives use; and the collective counters (collectives.py)."""

    group: Optional[object]
    rank: int
    shards: int
    device: torch.device
    backend: str
    transport: str
    counts: dict = dataclasses.field(default_factory=_zero_counts)
    staged_bytes: int = 0
    axis_names: Tuple[str, ...] = (NODE_AXIS,)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.shards}

    def reset_counts(self) -> None:
        self.counts = _zero_counts()
        self.staged_bytes = 0


def make_node_mesh(n_devices: Optional[int] = None, device=None, group=None) -> NodeMesh:
    """The node mesh over the ranks of `group` (default: the initialized
    process group; one shard when there is none). `n_devices`, when given,
    must equal that rank count: each rank is one shard. `device` is where
    this rank's tensors live: CUDA (the default) or an explicit "cpu"."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        shards, rank = dist.get_world_size(group), dist.get_rank(group)
        backend = str(dist.get_backend(group))
    else:
        shards, rank, backend, group = 1, 0, "none", None
    if n_devices is not None and n_devices != shards:
        raise ValueError(f"a node mesh of {n_devices} shards needs {n_devices} ranks; "
                         f"the process group has {shards}")
    transport = "host" if backend == "gloo" and dev.type == "cuda" else "direct"
    return NodeMesh(group, rank, shards, dev, backend, transport)


def epoch_max_nodes() -> int:
    """The largest node count the epoch path takes
    (OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES, read on every call)."""
    return int(os.environ.get("OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES", str(EPOCH_MAX_NODES)))


def _mesh_axis_shards(mesh) -> Tuple[Optional[str], int]:
    """(axis name, shard count) of a 1-D node mesh, or (None, 1) for no mesh
    (JAX ops/kernels.py :1045)."""
    if mesh is None or len(mesh.axis_names) != 1:
        return None, 1
    return mesh.axis_names[0], int(mesh.shards)


def epoch_shards(mesh, N: int) -> int:
    """The shard count of the epoch path for an N-node table, or 1 where the
    kernels run unsharded (JAX :1213 and :1977)."""
    ax, shards = _mesh_axis_shards(mesh)
    if ax is not None and shards > 1 and N % shards == 0 and N <= epoch_max_nodes():
        return shards
    return 1


class ShardedKernels:
    """The scenario-axis fan-outs of JAX's mesh namespace
    (`parallel/mesh.py:360`), not ported yet: each raises. The node axis
    needs no namespace of its own: the engine passes its mesh to
    `kernels.schedule_wave` and `kernels.schedule_affinity_wave`, and every
    other kernel runs unsharded on the replicated tensors of each rank."""

    def _fanout(self, *args, **kwargs):
        raise NotImplementedError(_A12C)

    probe_serial_fanout = probe_wave_fanout = probe_group_serial_fanout = _fanout
    probe_affinity_wave_fanout = serve_whatif_fanout = serve_wave_fanout = _fanout
    sweep_wave_fanout = sweep_whatif_fanout = _fanout


def make_scenario_mesh(*args, **kwargs):
    raise NotImplementedError(_A12C)


def fanout_shardings(*args, **kwargs):
    raise NotImplementedError(_A12C)


def put_fanout_inputs(*args, **kwargs):
    raise NotImplementedError(_A12C)


def schedule_scenarios_on_mesh(*args, **kwargs):
    raise NotImplementedError(_A12C)
