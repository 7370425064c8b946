"""The node-axis mesh on torch.distributed: see mesh.py for the design and
distributed.py for joining the ranks. The scenario axis is ROADMAP A12c."""

from .distributed import choose_backend, make_global_mesh, node_mesh_local
from .distributed import initialize as initialize_distributed
from .mesh import (
    NODE_AXIS,
    NodeMesh,
    ShardedKernels,
    epoch_shards,
    fanout_shardings,
    make_node_mesh,
    make_scenario_mesh,
    pad_batch_tables,
    put_fanout_inputs,
    schedule_scenarios_on_mesh,
)

__all__ = [
    "NODE_AXIS",
    "NodeMesh",
    "ShardedKernels",
    "choose_backend",
    "epoch_shards",
    "fanout_shardings",
    "initialize_distributed",
    "make_global_mesh",
    "make_node_mesh",
    "make_scenario_mesh",
    "node_mesh_local",
    "pad_batch_tables",
    "put_fanout_inputs",
    "schedule_scenarios_on_mesh",
]
