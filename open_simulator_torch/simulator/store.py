"""Columnar host stores: struct-of-arrays pod batches and node sets.

The host side of the engine was a dict-of-dicts world: every pod a Python
dict, every encode a per-pod traversal, every commit a handful of dict
mutations. That is fine at 10k pods and ruinous at 10M (ROADMAP item 2 —
~60% of the 1M-pod row's wall was Python-side encode + commit bookkeeping).
This module keeps the expensive representation staged once and lets the
engine view it zero-copy, the same move serve/image.py made on the device
side (Orca, PAPERS.md):

- **PodStore** — a pod batch as template blocks: each block is one validated
  pod template plus a replica count and a name recipe. Columns (`tmpl_of`,
  `node_of`, `commit_seq`) are numpy arrays over the whole batch; the
  scheduling-relevant content lives once per TEMPLATE, so `encode_batch_ids`
  is one group interning per template plus one vectorized gather
  (`EncodedRows`), and the engine's bulk commit writes placements as array
  ops. Per-pod dicts are materialized lazily — only for the few pods a
  caller actually reads back (failure records, preemption victims,
  `pods_on_node` listings) — and a materialized dict is cached so its
  identity is stable. A PodStore is Sequence-compatible: code that iterates
  or indexes it transparently gets pod dicts, bit-identical to the dicts the
  legacy path would have carried (the double-encode parity suite in
  tests/test_store.py holds the two encodes to byte equality).

- **NodeStore** — the node set as blocks sharing one template (allocatable,
  taint pattern, constant labels) plus indexed label recipes (hostname,
  zone cycling). `NodeArrays` adopts its columns directly instead of parsing
  N node dicts; `LazyNodeSeq` stands in for the node list and materializes
  dicts on indexed access only.

- **PodsOnNode / NodePodList** — the per-node placement registry. Committed
  store rows are recorded as SPANS (store + row ids) instead of appended
  dicts; reading a node's pod list flattens its spans through lazy
  materialization. `snapshot()`/`restore()` copy only non-empty nodes, so
  the engine's per-call transaction stays O(touched), not O(N).

Semantic boundary (PARITY.md "Columnar host path"): materialization is the
one place columnar state becomes dict state. A materialized pod reflects the
store's CURRENT columns (committed → spec.nodeName + Running status), and a
bulk-commit rollback patches any already-materialized dict back, so callers
can never observe a dict/column split-brain.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core import constants as C
from .encode import SIG_MEMO_KEY

__all__ = [
    "EncodedRows", "PodStore", "NodeStore", "LazyNodeSeq",
    "NodePodList", "PodsOnNode", "is_pod_store",
]


class EncodedRows(Sequence):
    """The pod-axis encode of a store view: (group_id, forced_node) as
    columns. Sequence-compatible with the legacy List[(g, f)] — len,
    iteration, and indexing all yield row tuples, so lane assemblers
    (serve/sweep) consume it unchanged; the engine and
    build_pod_axis_tables use the arrays directly."""

    __slots__ = ("pod_group", "forced_node")

    def __init__(self, pod_group: np.ndarray,
                 forced_node: np.ndarray) -> None:
        self.pod_group = pod_group    # [P] i32
        self.forced_node = forced_node  # [P] i32

    def __len__(self) -> int:
        return int(self.pod_group.shape[0])

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter(zip(self.pod_group.tolist(), self.forced_node.tolist()))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return EncodedRows(self.pod_group[i], self.forced_node[i])
        return (int(self.pod_group[i]), int(self.forced_node[i]))


def is_pod_store(obj) -> bool:
    return isinstance(obj, PodStore)


class _PodBase:
    """Shared state behind every view of one pod batch."""

    __slots__ = (
        "templates", "blobs", "sigs", "tmpl_priority", "tmpl_bound",
        "blk_tmpl", "blk_fmt", "blk_names", "blk_start", "blk_name_base",
        "tmpl_of", "node_of", "commit_seq", "cache", "row_by_id",
        "node_names", "frozen",
    )

    def __init__(self) -> None:
        self.templates: List[dict] = []
        self.blobs: List[Optional[bytes]] = []
        self.sigs: List[object] = []
        self.tmpl_priority: List[int] = []
        self.tmpl_bound: List[bool] = []
        self.blk_tmpl: List[int] = []
        self.blk_fmt: List[Optional[str]] = []
        self.blk_names: List[Optional[List[str]]] = []
        self.blk_start = np.zeros(1, np.int64)  # simonlint: ignore[dtype-drift] -- host-side row offsets, never shipped to device
        self.blk_name_base: List[Optional[int]] = []
        self.tmpl_of = np.zeros(0, np.int32)
        self.node_of = np.zeros(0, np.int32)
        self.commit_seq: Optional[np.ndarray] = None  # lazy [P] i64
        self.cache: Dict[int, dict] = {}
        self.row_by_id: Dict[int, int] = {}
        self.node_names: Optional[Sequence[str]] = None
        self.frozen = False


class PodStore(Sequence):
    """A columnar pod batch (or a contiguous view of one).

    Build with add_block(); schedule by passing the store straight to
    Simulator.schedule_pods / probe_pods. Slicing returns a view sharing the
    commit columns (the engine's OOM bisection and streaming chunks slice
    freely); copy.deepcopy returns an independent store with its own commit
    state and materialization cache (the sweep oracle's isolation contract).
    """

    def __init__(self, _base: Optional[_PodBase] = None,
                 _lo: int = 0, _hi: Optional[int] = None) -> None:
        self._b = _base if _base is not None else _PodBase()
        self._lo = _lo
        self._hi = _hi if _hi is not None else int(self._b.blk_start[-1])

    # ------------------------------------------------------------ building --

    def add_block(self, template: dict, count: int,
                  name_fmt: Optional[str] = None,
                  names: Optional[List[str]] = None,
                  name_start: Optional[int] = None) -> "PodStore":
        """Append `count` replicas of one validated pod template. Names come
        from `names` (explicit, len == count), `name_fmt` (formatted with the
        global row index, or with `name_start` + the block-local index when
        name_start is given), or the template's own metadata.name. The
        template is held by reference and must not be mutated afterwards."""
        if self._lo != 0 or self._hi != len(self._b.tmpl_of):
            raise ValueError("add_block on a view; build on the root store")
        b = self._b
        if b.frozen:
            raise ValueError("add_block after scheduling started")
        if count <= 0:
            return self
        if names is not None and len(names) != count:
            raise ValueError("names length != count")
        ti = len(b.templates)
        b.templates.append(template)
        b.blobs.append(None)  # pickled lazily on first materialization
        from .encode import scheduling_signature

        b.sigs.append(scheduling_signature(template))
        spec = template.get("spec") or {}
        try:
            b.tmpl_priority.append(int(spec.get("priority") or 0))
        except (TypeError, ValueError):
            b.tmpl_priority.append(0)
        b.tmpl_bound.append(bool(spec.get("nodeName")))
        start = int(b.blk_start[-1])
        b.blk_tmpl.append(ti)
        b.blk_fmt.append(name_fmt)
        b.blk_names.append(list(names) if names is not None else None)
        b.blk_name_base.append(name_start)  # None = global row numbering
        b.blk_start = np.append(b.blk_start, start + count)
        b.tmpl_of = np.concatenate(
            [b.tmpl_of, np.full(count, ti, np.int32)])
        b.node_of = np.concatenate(
            [b.node_of, np.full(count, -1, np.int32)])
        self._hi = start + count
        return self

    def add_pod(self, pod: dict) -> "PodStore":
        """Append one explicit pod dict (a one-row block whose template IS
        the dict): exceptional pods — pre-bound, hand-built — ride the store
        without losing their identity; they materialize to the same object."""
        self.add_block(pod, 1)
        row = int(self._b.blk_start[-1]) - 1
        self._b.cache[row] = pod
        self._b.row_by_id[id(pod)] = row
        return self

    # ----------------------------------------------------------- sequence --

    def __len__(self) -> int:
        return self._hi - self._lo

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("PodStore views must be contiguous")
            return PodStore(self._b, self._lo + start, self._lo + stop)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.materialize(self._lo + i)

    def __iter__(self) -> Iterator[dict]:
        for i in range(self._lo, self._hi):
            yield self.materialize(i)

    def __deepcopy__(self, memo) -> "PodStore":
        nb = _PodBase()
        b = self._b
        nb.templates = list(b.templates)
        nb.blobs = list(b.blobs)
        nb.sigs = list(b.sigs)
        nb.tmpl_priority = list(b.tmpl_priority)
        nb.tmpl_bound = list(b.tmpl_bound)
        nb.blk_tmpl = list(b.blk_tmpl)
        nb.blk_fmt = list(b.blk_fmt)
        nb.blk_names = [list(n) if n is not None else None
                        for n in b.blk_names]
        nb.blk_start = b.blk_start.copy()
        nb.blk_name_base = list(b.blk_name_base)
        nb.tmpl_of = b.tmpl_of.copy()
        nb.node_of = b.node_of.copy()
        nb.commit_seq = (b.commit_seq.copy()
                         if b.commit_seq is not None else None)
        nb.node_names = b.node_names
        return PodStore(nb)

    # ------------------------------------------------------------- columns --

    @property
    def base(self) -> _PodBase:
        return self._b

    @property
    def lo(self) -> int:
        return self._lo

    @property
    def hi(self) -> int:
        return self._hi

    def tmpl_rows(self) -> np.ndarray:
        """[P] i32 template index per row of this view (zero-copy slice)."""
        return self._b.tmpl_of[self._lo:self._hi]

    def node_rows(self) -> np.ndarray:
        """[P] i32 committed node per row of this view (-1 = uncommitted)."""
        return self._b.node_of[self._lo:self._hi]

    def priorities_present(self) -> List[int]:
        """Distinct spec.priority values across this view's templates."""
        tis = np.unique(self.tmpl_rows())
        return sorted({self._b.tmpl_priority[int(t)] for t in tis})

    def bound_mask(self) -> Optional[np.ndarray]:
        """[P] bool of rows whose template is pre-bound (spec.nodeName set),
        or None when no template in the view is bound (the common case)."""
        b = self._b
        if not any(b.tmpl_bound[int(t)] for t in np.unique(self.tmpl_rows())):
            return None
        bound_t = np.array(b.tmpl_bound, bool)
        return bound_t[self.tmpl_rows()]

    def sig_of_row(self, abs_row: int):
        return self._b.sigs[int(self._b.tmpl_of[abs_row])]

    def template_of_row(self, abs_row: int) -> dict:
        return self._b.templates[int(self._b.tmpl_of[abs_row])]

    def ensure_commit_seq(self) -> np.ndarray:
        b = self._b
        if b.commit_seq is None:
            b.commit_seq = np.full(len(b.tmpl_of), -1, np.int64)  # simonlint: ignore[dtype-drift] -- host-side commit-order column
        return b.commit_seq

    def row_of_dict(self, pod: dict) -> Optional[int]:
        """Absolute row of a materialized pod dict, or None (identity map,
        populated at materialization)."""
        return self._b.row_by_id.get(id(pod))

    # ------------------------------------------------------ materialization --

    def name_of(self, abs_row: int) -> str:
        b = self._b
        blk = int(np.searchsorted(b.blk_start, abs_row, side="right")) - 1
        names = b.blk_names[blk]
        if names is not None:
            return names[abs_row - int(b.blk_start[blk])]
        fmt = b.blk_fmt[blk]
        if fmt is not None:
            base = b.blk_name_base[blk]
            if base is None:
                return fmt.format(abs_row)
            return fmt.format(base + abs_row - int(b.blk_start[blk]))
        return ((b.templates[b.blk_tmpl[blk]].get("metadata") or {})
                .get("name") or f"pod-{abs_row}")

    def materialize(self, abs_row: int) -> dict:
        """The lazy dict for one row: template copy + generated name, plus
        the committed nodeName/status when the row is placed. Cached — the
        dict's identity is stable and mutations stick (it IS the pod from
        then on)."""
        b = self._b
        pod = b.cache.get(abs_row)
        if pod is not None:
            return pod
        ti = int(b.tmpl_of[abs_row])
        blob = b.blobs[ti]
        if blob is None:
            blob = b.blobs[ti] = pickle.dumps(b.templates[ti], -1)
        pod = pickle.loads(blob)
        pod.pop(SIG_MEMO_KEY, None)  # defensive: never leak the marker
        pod.setdefault("metadata", {})["name"] = self.name_of(abs_row)
        ni = int(b.node_of[abs_row])
        if ni >= 0 and b.node_names is not None:
            pod.setdefault("spec", {})["nodeName"] = b.node_names[ni]
            pod["status"] = {"phase": "Running"}
        b.cache[abs_row] = pod
        b.row_by_id[id(pod)] = abs_row
        return pod

    def cached_rows_in(self, rows: np.ndarray) -> List[Tuple[int, dict]]:
        """(abs_row, dict) for the subset of `rows` already materialized —
        the bulk commit/rollback patch set (cache-sized, never O(rows))."""
        cache = self._b.cache
        if not cache:
            return []
        rs = set(rows.tolist())
        return [(r, d) for r, d in cache.items() if r in rs]


# ---------------------------------------------------------------- node store --


class _NodeBlock(NamedTuple):
    template: dict           # spec/status skeleton (no metadata.name/labels)
    count: int
    name_fmt: str
    labels: Tuple[Tuple[str, str], ...]   # constant labels
    zone_cycle: Optional[Tuple[str, str, int]]  # (label key, fmt, modulus)
    index_labels: Tuple[str, ...]         # label keys valued str(global index)
    taint: Optional[Tuple[tuple, int]]    # ((key, value, effect), every)


class NodeStore(Sequence):
    """Columnar node set: blocks of identical nodes up to indexed labels.
    NodeArrays adopts the columns directly (no per-node dict parsing); the
    `nodes` list every dict consumer sees becomes a LazyNodeSeq."""

    def __init__(self) -> None:
        self.blocks: List[_NodeBlock] = []
        self._n = 0

    def add_block(self, template: dict, count: int, name_fmt: str,
                  labels: Optional[dict] = None,
                  zone_cycle: Optional[Tuple[str, str, int]] = None,
                  index_labels: Sequence[str] = (),
                  taint: Optional[Tuple[dict, int]] = None) -> "NodeStore":
        if count <= 0:
            return self
        t = None
        if taint is not None:
            td, every = taint
            t = ((td.get("key", ""), td.get("value", "") or "",
                  td.get("effect", "")), int(every))
        self.blocks.append(_NodeBlock(
            template, int(count), name_fmt,
            tuple(sorted((labels or {}).items())), zone_cycle,
            tuple(index_labels), t))
        self._n += int(count)
        return self

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self.materialize(i)

    def __deepcopy__(self, memo) -> "NodeStore":
        return self  # blocks are immutable by contract; views carry caches

    # block helpers -------------------------------------------------------

    def block_of(self, i: int) -> Tuple[_NodeBlock, int]:
        for blk in self.blocks:
            if i < blk.count:
                return blk, i
            i -= blk.count
        raise IndexError(i)

    def offsets(self) -> List[int]:
        out, off = [], 0
        for blk in self.blocks:
            out.append(off)
            off += blk.count
        return out

    def name_of(self, i: int) -> str:
        blk, _ = self.block_of(i)
        return blk.name_fmt.format(i)

    def gen_names(self) -> List[str]:
        out: List[str] = []
        i = 0
        for blk in self.blocks:
            fmt = blk.name_fmt
            out.extend(fmt.format(j) for j in range(i, i + blk.count))
            i += blk.count
        return out

    def materialize(self, i: int) -> dict:
        """One node dict, bit-equivalent to what the dict-path generator
        would have produced for this row."""
        import copy as _copy

        blk, local = self.block_of(i)
        node = _copy.deepcopy(blk.template)
        labels = dict(blk.labels)
        labels[C.LabelHostname] = self.name_of(i)
        for k in blk.index_labels:
            labels[k] = str(i)
        if blk.zone_cycle is not None:
            key, fmt, mod = blk.zone_cycle
            labels[key] = fmt.format(i % mod)
        md = node.setdefault("metadata", {})
        md["name"] = self.name_of(i)
        md["labels"] = labels
        if blk.taint is not None and i % blk.taint[1] == 0:
            (k, v, e), _every = blk.taint
            node.setdefault("spec", {})["taints"] = [
                {"key": k, "value": v, "effect": e}]
        return node

    # capability flags (plugin hosts and the image-locality scan consult
    # these instead of walking N dicts) ----------------------------------

    def _any_status(self, pred) -> bool:
        return any(pred((blk.template.get("status") or {}))
                   for blk in self.blocks)

    @property
    def may_have_gpu(self) -> bool:
        from ..plugins.gpushare import node_total_gpu_memory

        return any(node_total_gpu_memory(blk.template) > 0
                   for blk in self.blocks)

    @property
    def may_have_local_storage(self) -> bool:
        return self.any_annotation(C.AnnoNodeLocalStorage)

    @property
    def has_images(self) -> bool:
        return self._any_status(lambda st: bool(st.get("images")))

    def any_annotation(self, key: str) -> bool:
        return any(key in ((blk.template.get("metadata") or {})
                           .get("annotations") or {})
                   for blk in self.blocks)

    def resource_names(self) -> List[str]:
        from ..utils.objutil import node_allocatable

        out: List[str] = []
        seen = set()
        for blk in self.blocks:
            # node_allocatable, not raw status.allocatable: the axis must see
            # the same capacity fallback node_vector will read later
            for k in node_allocatable(blk.template):
                if k not in seen:
                    seen.add(k)
                    out.append(k)
        return out


class LazyNodeSeq(Sequence):
    """Stands in for `na.nodes`: indexed access materializes (and caches) a
    node dict; append/extend (the serve delta node-add path) lands in an
    overflow list of real dicts."""

    def __init__(self, store: NodeStore) -> None:
        self.store = store
        self._cache: Dict[int, dict] = {}
        self._extra: List[dict] = []

    def __len__(self) -> int:
        return len(self.store) + len(self._extra)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        ns = len(self.store)
        if i >= ns:
            return self._extra[i - ns]
        got = self._cache.get(i)
        if got is None:
            got = self._cache[i] = self.store.materialize(i)
        return got

    def append(self, node: dict) -> None:
        self._extra.append(node)

    def extend(self, nodes) -> None:
        self._extra.extend(nodes)


# ------------------------------------------------------- placement registry --


class _Span(NamedTuple):
    store: PodStore          # any view over the right base
    rows: np.ndarray         # absolute row ids, commit order


class NodePodList:
    """One node's placed-pod list: explicit dicts and columnar spans in
    commit order. Reading pods (iteration/indexing/removal) flattens spans
    through lazy materialization — the designated read-back boundary."""

    __slots__ = ("_items",)

    def __init__(self, items: Optional[list] = None) -> None:
        self._items: list = items if items is not None else []

    # -- writes -----------------------------------------------------------
    def append(self, pod: dict) -> None:
        self._items.append(pod)

    def add_span(self, store: PodStore, rows: np.ndarray) -> None:
        self._items.append(_Span(store, rows))

    # -- reads ------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(it.rows) if isinstance(it, _Span) else 1
                   for it in self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def _flatten(self) -> list:
        if any(isinstance(it, _Span) for it in self._items):
            flat: list = []
            for it in self._items:
                if isinstance(it, _Span):
                    flat.extend(it.store.materialize(int(r))
                                for r in it.rows)
                else:
                    flat.append(it)
            self._items = flat
        return self._items

    def __iter__(self):
        return iter(self._flatten())

    def __getitem__(self, i):
        return self._flatten()[i]

    def __delitem__(self, i) -> None:
        del self._flatten()[i]

    def remove(self, pod: dict) -> None:
        self._flatten().remove(pod)

    def copy_items(self) -> list:
        return list(self._items)


class PodsOnNode:
    """The engine's `pods_on_node`, backed by a dict of non-empty nodes so
    the per-transaction snapshot is O(touched nodes), never O(N)."""

    __slots__ = ("_n", "_lists")

    def __init__(self, n: int) -> None:
        self._n = n
        self._lists: Dict[int, NodePodList] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> NodePodList:
        # hot path first: _commit_pod indexes this once per placed pod, so
        # the existing-list case must stay a bare dict hit (the checked slow
        # path below only runs on first touch / slices / negative indexes)
        try:
            l = self._lists.get(i)
        except TypeError:  # unhashable: a slice
            l = None
        if l is not None:
            return l
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        l = self._lists.get(i)
        if l is None:
            l = self._lists[i] = NodePodList()
        return l

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def extend(self, iterable) -> None:
        """Grow the node axis (serve delta node-add): each yielded entry must
        be an empty list placeholder."""
        for entry in iterable:
            assert not entry, "extend only grows empty node slots"
            self._n += 1

    def total(self) -> int:
        """Total placed pods, without materializing anything."""
        return sum(len(l) for l in self._lists.values())

    def nonempty(self):
        return self._lists.items()

    def snapshot(self) -> dict:
        # prune empty lists while scanning: read-side iteration (reports,
        # censuses) registers an empty NodePodList per visited node, and
        # without pruning every later snapshot would re-scan those N
        # entries. In-repo call sites never hold an EMPTY list across a
        # snapshot boundary (commit/evict grab-and-mutate atomically), so
        # dropping them keeps snapshot O(touched) without losing state.
        live = {i: l for i, l in self._lists.items() if l._items}
        if len(live) != len(self._lists):
            self._lists = dict(live)
        return {"n": self._n,
                "lists": {i: l.copy_items() for i, l in live.items()}}

    def restore(self, snap: dict) -> None:
        self._n = snap["n"]
        self._lists = {i: NodePodList(list(items))
                       for i, items in snap["lists"].items()}
