"""The mesh on torch.distributed, its node axis and its scenario axis: see
mesh.py for the design and distributed.py for joining the ranks."""

from .collectives import all_gather_rows, gather_lanes
from .distributed import choose_backend, make_global_mesh, node_mesh_local
from .distributed import initialize as initialize_distributed
from .mesh import (
    NODE_AXIS,
    SCENARIO_AXIS,
    NodeBlock,
    NodeMesh,
    ScenarioMesh,
    ShardedKernels,
    block_of,
    carry_reshard_bytes,
    carry_shardings,
    epoch_shards,
    fanout_shardings,
    fetch_lanes,
    make_node_mesh,
    make_scenario_mesh,
    pad_batch_tables,
    put_fanout_inputs,
    round_shards,
    schedule_batch_on_mesh,
    schedule_scenarios_on_mesh,
    table_shardings,
    to_device_sharded,
)

__all__ = [
    "NODE_AXIS",
    "SCENARIO_AXIS",
    "NodeBlock",
    "NodeMesh",
    "ScenarioMesh",
    "ShardedKernels",
    "all_gather_rows",
    "block_of",
    "carry_reshard_bytes",
    "carry_shardings",
    "choose_backend",
    "epoch_shards",
    "fanout_shardings",
    "fetch_lanes",
    "gather_lanes",
    "initialize_distributed",
    "make_global_mesh",
    "make_node_mesh",
    "make_scenario_mesh",
    "node_mesh_local",
    "pad_batch_tables",
    "put_fanout_inputs",
    "round_shards",
    "schedule_batch_on_mesh",
    "schedule_scenarios_on_mesh",
    "table_shardings",
    "to_device_sharded",
]
