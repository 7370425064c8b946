"""The mesh on `torch.distributed`: its node axis and its scenario axis
(port of `open_simulator_tpu/parallel/mesh.py`).

Node axis. Every rank runs the same `Simulator` on the same input: it
encodes the same `BatchTables`, and the encoder pads the node axis to a
multiple of the shard count with phantom nodes, infeasible for every pod.
On a 1-D node mesh of more than one shard the layout is partitioned (JAX
`table_shardings`, `carry_shardings`, `to_device_sharded`): rank r stages
and holds only its block [r*NL, (r+1)*NL), NL = N / shards, of the node
axis of every [*, N] table (`static_mask`, the `mask_*` and `*_raw` [G, N]
tables, `counter_dom`, `topo_dom`, `carr_dom`, `node_zone`) and [N, *]
table and carry row (`alloc`, `dev_total`, the volume-group and
storage-device tables; `requested`, `nonzero`, `port_used`, `dev_used`,
`vg_req`, `sdev_alloc`); every per-group table, `counter_topo`,
`carr_topo` and the carry's domain counters `counter` and `carrier`
[*, D+1] are whole on every rank. `table_shardings` and `carry_shardings`
give each leaf's `NodeBlock` rule; `carry_reshard_bytes` counts the bytes
of carry leaves out of that layout (0 on every chained dispatch). Every
route runs on the block (the engine passes the mesh to every kernel
wrapper; ops/kernels.py):

- the serial scan (`schedule_batch_on_mesh`, and the engine's serial
  segments): K12, per pod two `all_gather_rows` and a `pmax` for a group
  with ScheduleAnyway terms; `feasibility_jit` and `explain_jit` with the
  mesh take the block (K1; K12's explain mode), their masks gathered tiled
  at the fetch;
- the group-serial scan (`schedule_group_serial`): K13, K4's hoisted run
  state on the block and K12's per-pod stages, the same collectives;
- the commit of a counted segment (`aggregate_commit`): K14, the block's
  rows, then the replicated counters from ONE `all_gather_rows` of every
  block's per-domain counts, summed in rank order (integer-valued: exact);
- the waves, split at OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES (default
  2,048, read on every call; JAX reads it at import):
  - the epoch path, N at most the limit (`epoch_shards`; JAX
    `_mesh_axis_shards` and the `shard_map` loops of ops/kernels.py): the
    segment constants and the epoch front of `schedule_wave` and
    `schedule_affinity_wave` run on the block, and each epoch makes
    exactly two collectives (collectives.py): one `pmax` of a stacked
    vector that holds every normalizer (mins ride negated: -max(-x) ==
    min(x)) and one tiled `all_gather` of the payload: the block's
    score-table rows and every per-node value the selection tail reads
    (the normalizer inputs; for the affinity wave also the zone, the
    budget domain, the static flags and every term's domain). The tail
    then runs on every rank on the gathered full-width rows (K8, K9).
  - above the limit (`round_shards`; JAX keeps XLA's GSPMD form of the
    plain loops there, :1273 and :2095) both waves run every per-node stage
    on the block and exchange only block summaries and block tops:
    - the wave's per-round path: each round makes exactly four
      collectives: `pmax` #1 of the six normalizer maxima;
      `all_gather_rows` #1 of each block's summary (its first two maxima of
      the hidden-entry bound and its best head, as (value, global node),
      and its feasible count); `all_gather_rows` #2 of each block's top c =
      min(K, m - placed, NL*B) guarded entries (key, exhaust flag) and its
      guarded count, from which every rank merges the same global top;
      `pmax` #2 of the six maxima over the nodes that top leaves feasible.
      Exact: the maxima are order-free, ties break on global node and flat
      indices, and the top of the union of the blocks' tops is the
      unsharded top (csrc/wave_rounds.cu K10, ops/kernels.py
      `_wave_round_sharded`).
    - the affinity wave's sharded tail: each epoch's front, score table,
      SelectorSpread blend, guard and top c = min(K_EP, NL*B) entries run
      on the block; the rounds run on every rank on the merged list and the
      replicated [D+1] counters, so they need no collective. An epoch makes
      two to four collectives, by branch (`NodeMesh.tail_branches`):
      all_gather_rows #1 of the block's stacked maxima, four flags and the
      block's SelectorSpread zone sums (integer-valued: summed in rank
      order, exact); all_gather_rows #2 of the block summaries (the two
      largest hidden-entry bounds and the best head as (value, global
      node) with every term's domain at that head, the usable count) —
      "head" ends there when the epoch cannot take several pods;
      all_gather_rows #3 of each block's top c keys with their budget
      domains and every term's domain at their node, whose top K_EP is the
      unsharded top — "select" ends there when the rounds take nothing;
      pmax #4 of the sandwich's maxima over the block — "sandwich"
      (csrc/affinity_rounds.cu K11, ops/kernels.py `epoch_rounds` in
      `schedule_affinity_wave_plain`).
In every wave path the per-node counts, `placed` and the statistics are
equal on every rank (JAX's out_specs `P()`); the engine keeps the block's
part of the counts, commits it (K14) and gathers the blocks once per run at
its fetch. The host reads one to three small values per epoch or round.

Scenario axis. `make_scenario_mesh(n)` is JAX's pure-scenario mesh
('scenarios' = n, 'nodes' = 1) over the n ranks of the process group, and
`make_node_mesh(n, scenario_axis=k)` its 2-D form: k scenario groups of
n/k consecutive ranks, the node axis replicated within a group (JAX's
`fanout_shardings` partition it there: ROADMAP A12), so no wave kernel
takes the epoch path on it, as in JAX. The S lanes of a probe, serve or sweep fan-out are independent:
K2-K5 and K3c over lanes run one block per lane and read nothing of another
lane. So scenario group r runs lanes [r*S/k, (r+1)*S/k) through the same
lane kernels (`ShardedKernels`: the eight fan-outs of `kernels`, by name and
signature) and gets the same bits for them as one launch over all S lanes.
A rank stages and holds only its block of the lane inputs, carry and
outputs (the tables are replicated); the one collective is `gather_lanes`
at the fetch (`fetch_lanes`), once for each output the caller reads, after
which every rank holds the same [S, ...] result, as JAX's fetch of a
lane-sharded array gives it. The callers pad S to a multiple of k as JAX's
do (the probe session repeats its last candidate, the image its lane 0).

"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.distributed as dist

import numpy as np

from ..ops import kernels
from ..simulator.encode import pad_batch_tables as _pad_batch_tables
from ..simulator.encode import plugin_flags
from ..simulator.engine import resolve_device
from .collectives import all_gather_rows, gather_lanes

NODE_AXIS = "nodes"
SCENARIO_AXIS = "scenarios"
EPOCH_MAX_NODES = 2048  # the default of OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES (JAX :832)

# Node-axis padding lives with the encoder; re-exported for the mesh's callers.
pad_batch_tables = _pad_batch_tables

def _zero_counts() -> dict:
    return {name: {"calls": 0, "bytes": 0}
            for name in ("pmax", "all_gather_tiled", "all_gather_rows")}


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
    # epochs of the affinity wave's sharded tail by their last collective:
    # "head" (#2), "select" (#3), "sandwich" (#4)
    tail_branches: Counter = dataclasses.field(default_factory=Counter)
    axis_names: Tuple[str, ...] = (NODE_AXIS,)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.shards}

    def reset_counts(self) -> None:
        self.counts = _zero_counts()
        self.staged_bytes = 0
        self.tail_branches = Counter()


def _group_of(group) -> tuple:
    """(group, world size, rank, backend) of `group` (default: the
    initialized process group), or one rank without a backend."""
    if dist.is_available() and dist.is_initialized():
        return group, dist.get_world_size(group), dist.get_rank(group), str(dist.get_backend(group))
    return None, 1, 0, "none"


def _transport(backend: str, dev: torch.device) -> str:
    return "host" if backend == "gloo" and dev.type == "cuda" else "direct"


def make_node_mesh(n_devices: Optional[int] = None, device=None, group=None,
                   scenario_axis: int = 1) -> NodeMesh:
    """The node mesh over the ranks of `group` (default: the initialized
    process group; one shard when there is none). `n_devices`, when given,
    must equal that rank count: each rank is one shard. `device` is where
    this rank's tensors live: CUDA (the default) or an explicit "cpu".
    `scenario_axis` > 1 gives JAX's 2-D ('scenarios', 'nodes') mesh: that
    many scenario groups of consecutive ranks (a ScenarioMesh)."""
    dev = resolve_device(device)
    group, world, rank, backend = _group_of(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks; "
                         f"the process group has {world}")
    if scenario_axis > 1:
        if world % scenario_axis:
            raise ValueError(f"{world} ranks not divisible by scenario axis {scenario_axis}")
        return ScenarioMesh(group, rank, world // scenario_axis, dev, backend,
                            _transport(backend, dev), scenarios=scenario_axis)
    return NodeMesh(group, rank, world, dev, backend, _transport(backend, dev))


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


def round_shards(mesh, N: int) -> int:
    """The shard count of the wave's per-round path for an N-node table:
    a 1-D node mesh of more than one shard, N a multiple of the shard count
    and N above the epoch limit (JAX's GSPMD branch, :1273). Otherwise 1."""
    ax, shards = _mesh_axis_shards(mesh)
    if ax is not None and shards > 1 and N % shards == 0 and N > epoch_max_nodes():
        return shards
    return 1


# ------------------------------------------------------- partitioned layout ----

# The node axis of every partitioned leaf (0: rows, -1: columns); every
# other leaf is whole on every rank (JAX :67-115).
_TABLE_NODE_AXIS = dict(
    alloc=0, node_zone=0, static_mask=-1, mask_taint=-1, mask_unsched=-1, mask_aff=-1,
    mask_extra=-1, simon_raw=-1, nodeaff_raw=-1, taint_raw=-1, avoid_raw=-1, image_raw=-1,
    extra_raw=-1, counter_dom=-1, topo_dom=-1, carr_dom=-1, dev_total=0, vg_cap=0, vg_nameid=0,
    sdev_cap=0, sdev_media=0)
_CARRY_NODE_AXIS = dict(requested=0, nonzero=0, port_used=0, dev_used=0, vg_req=0, sdev_alloc=0)


@dataclasses.dataclass(frozen=True)
class NodeBlock:
    """One leaf's rule on one rank of a node mesh (the port's NamedSharding):
    `axis` is the leaf's node axis (None: whole on every rank), of `nodes`
    entries in all (the padded N; None: the leaf's own extent); the rank
    holds [rank*NL, (rank+1)*NL) of it, NL = nodes / shards, on `device`.
    Called on a host array or tensor of every node, returns that part."""

    axis: Optional[int]
    rank: int
    shards: int
    device: torch.device
    nodes: Optional[int] = None

    def block(self, n: int) -> slice:
        if n % self.shards:
            raise ValueError(f"{n} nodes do not split over {self.shards} shards; "
                             f"pad them (pad_batch_tables)")
        NL = n // self.shards
        return slice(self.rank * NL, (self.rank + 1) * NL)

    def __call__(self, a):
        if self.axis is None:
            return a
        idx = [slice(None)] * a.ndim
        idx[self.axis] = self.block(a.shape[self.axis] if self.nodes is None else self.nodes)
        return a[tuple(idx)]

    def holds(self, t: torch.Tensor) -> bool:
        """Whether tensor `t` is in this layout: on the rank's device and, on
        a node axis, NL entries long."""
        if t.device != _concrete(self.device):
            return False
        if self.axis is None:
            return True
        if self.nodes is None:
            raise ValueError("a node-axis rule needs `nodes` to check a layout")
        return t.shape[self.axis] == self.nodes // self.shards


def _concrete(dev: torch.device) -> torch.device:
    """`dev` with its index, as a tensor there reports it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _rules(fields, axes: dict, mesh, n_nodes) -> list:
    return [NodeBlock(axes.get(f), mesh.rank, mesh.shards, mesh.device, n_nodes) for f in fields]


def table_shardings(mesh, n_nodes: Optional[int] = None) -> kernels.Tables:
    """The `NodeBlock` rule of every Tables field on this rank (JAX
    `table_shardings`): the node axis partitioned, everything else whole.
    `n_nodes` (the padded N) lets the rules check a layout."""
    return kernels.Tables(*_rules(kernels.Tables._fields, _TABLE_NODE_AXIS, mesh, n_nodes))


def carry_shardings(mesh, n_nodes: Optional[int] = None) -> kernels.Carry:
    """The `NodeBlock` rule of every Carry field on this rank (JAX
    `carry_shardings`): the [N, *] rows partitioned, the domain counters
    `counter` and `carrier` whole (global state)."""
    return kernels.Carry(*_rules(kernels.Carry._fields, _CARRY_NODE_AXIS, mesh, n_nodes))


def to_device_sharded(bt, mesh) -> Tuple[kernels.Tables, kernels.Carry, object]:
    """Pad the batch to the mesh's shard count (`pad_batch_tables`; a no-op
    when the encoder aligned the node axis) and stage only this rank's part
    of every leaf on the mesh's device: (tables block, carry block, padded
    bt). The choices of a scan on it are global node indices; padding nodes
    are infeasible for every pod."""
    bt = pad_batch_tables(bt, mesh.shards)
    N = int(bt.alloc.shape[0])
    dev = mesh.device

    def put(a, rule):
        return torch.tensor(np.ascontiguousarray(rule(np.asarray(a))), device=dev)

    tables = kernels.Tables(*(put(getattr(bt, f), r) for f, r in
                              zip(kernels.Tables._fields, table_shardings(mesh, N))))
    carry = kernels.Carry(*(put(getattr(bt, "seed_" + f), r) for f, r in
                            zip(kernels.Carry._fields, carry_shardings(mesh, N))))
    return tables, carry, bt


def block_of(tables: kernels.Tables, carry: kernels.Carry, mesh) -> tuple:
    """This rank's block of tables and a carry of every node (tensors, the
    node axis a multiple of the shard count), as `to_device_sharded` stages
    them: (tables block, carry block), contiguous copies on the tensors'
    device. The tests and chip_smoke.py hold a kernel on the block against
    an unsharded one on the whole tables with it."""
    N = int(tables.alloc.shape[0])
    return (kernels.Tables(*(r(t).contiguous() for t, r in zip(tables, table_shardings(mesh, N)))),
            kernels.Carry(*(r(t).contiguous() for t, r in zip(carry, carry_shardings(mesh, N)))))


def carry_reshard_bytes(carry, shardings) -> int:
    """Bytes of the carry leaves whose shape or device differs from the
    declared layout `shardings` (`carry_shardings(mesh, n_nodes)`): what a
    chained dispatch would have to move to bring the carry back to its
    block. The partitioned scan returns the block it was given, so this is
    0 on every chained dispatch (simon_reshard_bytes_total)."""
    return sum(leaf.numel() * leaf.element_size() for leaf, rule in zip(carry, shardings)
               if not rule.holds(leaf))


def gather_carry(carry, mesh) -> kernels.Carry:
    """Every rank's carry block assembled in node order (one all_gather_rows
    per partitioned leaf), on every rank: the carry of all N nodes."""
    return kernels.Carry(*(all_gather_rows(leaf, mesh) if f in _CARRY_NODE_AXIS else leaf
                           for f, leaf in zip(kernels.Carry._fields, carry)))


def schedule_batch_on_mesh(bt, mesh):
    """One schedulePods batch with the node axis partitioned over `mesh`
    (JAX `schedule_batch_on_mesh`): `to_device_sharded`, then the serial scan
    on this rank's block (`kernels.schedule_batch` with the mesh: K12 on the
    card). Returns (this rank's final carry block, choices [P] i32). The
    choices index the original node list, equal on every rank: phantom
    padding is infeasible, so they never reach the real N."""
    tables, carry, bt = to_device_sharded(bt, mesh)
    enable_gpu, enable_storage = plugin_flags(bt)
    return kernels.schedule_batch(tables, carry, torch.from_numpy(bt.pod_group),
                                  torch.from_numpy(bt.forced_node), torch.from_numpy(bt.valid),
                                  n_zones=bt.n_zones, enable_gpu=enable_gpu,
                                  enable_storage=enable_storage, mesh=mesh)


# ------------------------------------------------------------ scenario axis ----


def _scenario_counts() -> dict:
    return {**_zero_counts(), "gather_lanes": {"calls": 0, "bytes": 0}}


@dataclasses.dataclass
class ScenarioMesh(NodeMesh):
    """One rank's view of a ('scenarios', 'nodes') mesh: `scenarios` groups
    of `shards` consecutive ranks (the node axis, replicated within a
    group). Besides NodeMesh's fields and counters (`gather_lanes` among
    them), what the tests and chip_smoke.py read: how many fan-out calls
    ran on blocks of each lane count (`blocks`) and how many fetches read
    each (this rank's lanes, the lanes gathered) (`fetched`)."""

    scenarios: int = 1
    blocks: Counter = dataclasses.field(default_factory=Counter)
    fetched: Counter = dataclasses.field(default_factory=Counter)

    def __post_init__(self) -> None:
        self.axis_names = (SCENARIO_AXIS, NODE_AXIS)
        self.counts = _scenario_counts()

    @property
    def shape(self) -> dict:
        return {SCENARIO_AXIS: self.scenarios, NODE_AXIS: self.shards}

    @property
    def world(self) -> int:
        return self.scenarios * self.shards

    @property
    def lane_group(self) -> int:
        """This rank's index on the scenario axis."""
        return self.rank // self.shards

    def padded_lanes(self, S: int) -> int:
        """S rounded up to a multiple of the scenario axis."""
        return S + (-S) % self.scenarios

    def lane_block(self, S: int) -> slice:
        """This rank's lanes of an S-lane fan-out: [r*S/k, (r+1)*S/k) for
        scenario group r of k."""
        if S % self.scenarios:
            raise ValueError(f"{S} lanes do not split over {self.scenarios} scenario groups; "
                             f"pad them to {self.padded_lanes(S)}")
        b = S // self.scenarios
        return slice(self.lane_group * b, (self.lane_group + 1) * b)

    def reset_counts(self) -> None:
        self.counts = _scenario_counts()
        self.staged_bytes = 0
        self.blocks = Counter()
        self.fetched = Counter()


def make_scenario_mesh(n_devices: Optional[int] = None, device=None, group=None) -> ScenarioMesh:
    """JAX's pure-scenario mesh ('scenarios' = n, 'nodes' = 1) over the n
    ranks of the process group (one scenario group when there is none):
    each rank runs its own block of every fan-out's lanes. `n_devices`,
    when given, must equal the rank count (the mesh never shrinks to fit).
    `device`: CUDA (the default) or an explicit "cpu"."""
    dev = resolve_device(device)
    group, world, rank, backend = _group_of(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a scenario mesh of {n_devices} needs {n_devices} ranks; "
                         f"the process group has {world}")
    return ScenarioMesh(group, rank, 1, dev, backend, _transport(backend, dev), scenarios=world)


def auto_scenario_mesh(device=None) -> Optional[ScenarioMesh]:
    """The probe session's and the image's own choice (JAX `_auto_mesh`): a
    scenario mesh over every rank when the process group has more than one,
    unless OPEN_SIMULATOR_MESH is 0, false or no; else None."""
    if os.environ.get("OPEN_SIMULATOR_MESH", "") in ("0", "false", "no"):
        return None
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return None
    return make_scenario_mesh(device=device)


def lane_block(mesh: Optional[ScenarioMesh], S: int) -> slice:
    """The lanes of an S-lane fan-out this rank stages: all of them without
    a mesh, its block on a scenario mesh."""
    return slice(0, S) if mesh is None else mesh.lane_block(S)


def fetch_lanes(mesh: Optional[ScenarioMesh], *outputs: torch.Tensor) -> list:
    """One fetch of a fan-out round: each output ([lanes, ...]) as a host
    numpy array of every lane. Without a mesh, a copy to the host; on a
    scenario mesh, one `gather_lanes` for each output, so every rank returns
    the same [S, ...] arrays."""
    if mesh is None:
        return [t.cpu().numpy() for t in outputs]
    out = [gather_lanes(t, mesh).cpu().numpy() for t in outputs]
    mesh.fetched[int(outputs[0].shape[0]), int(out[0].shape[0])] += 1
    return out


def fanout_shardings(mesh: ScenarioMesh):
    """The slicing rule of the fan-out inputs on this rank, shaped as JAX's
    (tables, carry_s, active_s) shardings: each entry maps a host array of
    every lane to the part this rank holds; the tables are replicated (the
    identity) and every carry leaf and the active mask keep this rank's lane
    block of their leading [S] axis."""
    def replicated(a):
        return a

    def lanes(a):
        return a[mesh.lane_block(a.shape[0])]

    return (kernels.Tables(*([replicated] * len(kernels.Tables._fields))),
            kernels.Carry(*([lanes] * len(kernels.Carry._fields))), lanes)


def put_fanout_inputs(mesh: ScenarioMesh, bt, carry_s_np, active_s_np):
    """The probe fan-out inputs on this rank's device, as `fanout_shardings`
    slices them: (tables, carry_s, active_s), the tables whole and the carry
    leaves and the [S, N] active mask this rank's lane block. S must be a
    multiple of the scenario axis."""
    ts, cs, as_ = fanout_shardings(mesh)
    tables = kernels.tables_from_batch(bt, mesh.device)
    carry_s = kernels.Carry(*(torch.tensor(np.ascontiguousarray(rule(np.asarray(v))),
                                           device=mesh.device)
                              for v, rule in zip(carry_s_np, cs)))
    active = torch.tensor(np.ascontiguousarray(as_(np.asarray(active_s_np, bool))),
                          device=mesh.device)
    return tables, carry_s, active


def _fanout(name: str, per_lane: tuple = (), lane_ndim: int = 1):
    """A ShardedKernels method: `kernels.<name>` on this rank's lane block,
    once the active mask and the per-lane inputs (argument positions
    `per_lane` after `active_s` whose rank is `lane_ndim`; a shared input of
    lower rank passes) hold the carry's lane count."""
    fn = getattr(kernels, name)

    def method(self, tb, cry_s, active_s, *args, **kwargs):
        S = int(cry_s.requested.shape[0])
        lanes = [("active_s", active_s)] + [(f"argument {i + 4}", args[i]) for i in per_lane]
        for what, a in lanes:
            if what == "active_s" or np.ndim(a) == lane_ndim:
                if int(a.shape[0]) != S:
                    raise ValueError(f"{name}: {what} holds {int(a.shape[0])} lanes, the "
                                     f"carry block {S}")
        self.mesh.blocks[S] += 1
        return fn(tb, cry_s, active_s, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = f"`kernels.{name}` on this rank's block of lanes."
    return method


class ShardedKernels:
    """The eight fan-outs on a scenario mesh (JAX's sharded executables,
    `parallel/mesh.py:555-626`, on the 'scenarios' axis). The signatures are
    those of `kernels.*_fanout`, so a caller swaps namespaces as JAX's do.
    Each method takes this rank's block of lane inputs (the carry, the
    [S/k, N] active mask and every per-lane input: `put_fanout_inputs`,
    `lane_block`), launches the same lane kernels on it (the plain versions
    for CPU tensors) and returns this rank's block; chained segments keep
    the carry block on the rank's device. Nothing here gathers: the caller
    fetches the outputs it reads with `fetch_lanes`. The node axis needs no
    namespace of its own: the engine passes its mesh to every
    kernel wrapper of `kernels`, which takes the rank's block of the
    partitioned layout."""

    def __init__(self, mesh: ScenarioMesh) -> None:
        if SCENARIO_AXIS not in mesh.axis_names:
            raise ValueError(f"the fan-outs need a mesh with a '{SCENARIO_AXIS}' axis "
                             f"(make_scenario_mesh); this mesh has {mesh.axis_names}")
        self.mesh = mesh

    probe_serial_fanout = _fanout("probe_serial_fanout")
    probe_wave_fanout = _fanout("probe_wave_fanout")
    probe_group_serial_fanout = _fanout("probe_group_serial_fanout")
    probe_affinity_wave_fanout = _fanout("probe_affinity_wave_fanout")
    serve_whatif_fanout = _fanout("serve_whatif_fanout", (2,), 2)
    serve_wave_fanout = _fanout("serve_wave_fanout", (0, 1, 2), 1)
    sweep_wave_fanout = _fanout("sweep_wave_fanout", (0, 1, 2), 2)
    sweep_whatif_fanout = _fanout("sweep_whatif_fanout", (0, 1, 2), 2)


def fanout_namespace(mesh: Optional[ScenarioMesh]):
    """The fan-outs' namespace: `kernels` without a mesh, a ShardedKernels
    on a scenario mesh."""
    return kernels if mesh is None else ShardedKernels(mesh)


def schedule_scenarios_on_mesh(bt, mesh: ScenarioMesh, seed_requested_s: np.ndarray):
    """S independent what-if scenarios of one cluster and pod batch, each
    from its own starting utilization (JAX `schedule_scenarios_on_mesh`:
    `schedule_batch` vmapped over the seeds): `seed_requested_s` is
    [S, N, R], S a multiple of the scenario axis. The tables are replicated
    (padded to the node axis's shard count), every other carry leaf is the
    batch's seed, and each scenario group runs its block of lanes through
    K2 over lanes with every node active (`kernels.sweep_whatif_fanout` with
    the batch's one pod stream). Returns choices [S, P] i32 on every rank
    (one `gather_lanes`)."""
    if SCENARIO_AXIS not in mesh.axis_names:
        raise ValueError("mesh has no scenario axis; build with make_node_mesh(n, scenario_axis=k)")
    bt = pad_batch_tables(bt, mesh.shards)
    S = seed_requested_s.shape[0]
    n_pad = bt.seed_requested.shape[0]
    if seed_requested_s.shape[1] > n_pad:
        raise ValueError(
            f"seed_requested_s node axis {seed_requested_s.shape[1]} exceeds the padded node "
            f"count {n_pad}; build seeds against the unpadded cluster "
            f"(or pad_batch_tables(bt, {mesh.shards}))")
    if seed_requested_s.shape[1] < n_pad:
        seed_requested_s = np.pad(seed_requested_s,
                                  ((0, 0), (0, n_pad - seed_requested_s.shape[1]), (0, 0)))
    blk = mesh.lane_block(S)
    b = blk.stop - blk.start
    seeds = [np.asarray(seed_requested_s[blk], np.float32)] + [
        np.broadcast_to(getattr(bt, "seed_" + f), (b,) + getattr(bt, "seed_" + f).shape)
        for f in kernels.Carry._fields[1:]]
    dev = mesh.device
    tables = kernels.tables_from_batch(bt, dev)
    carry_s = kernels.Carry(*(torch.tensor(np.ascontiguousarray(v), device=dev) for v in seeds))
    active = torch.ones((b, n_pad), dtype=torch.bool, device=dev)
    enable_gpu, enable_storage = plugin_flags(bt)
    _, choices = ShardedKernels(mesh).sweep_whatif_fanout(
        tables, carry_s, active, torch.from_numpy(bt.pod_group), torch.from_numpy(bt.forced_node),
        torch.from_numpy(bt.valid), n_zones=bt.n_zones, enable_gpu=enable_gpu,
        enable_storage=enable_storage)
    out = gather_lanes(choices, mesh)
    mesh.fetched[b, int(out.shape[0])] += 1
    return out
