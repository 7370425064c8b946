"""First-party metrics registry: Counter / Gauge / Histogram, zero deps.

A copy of `open_simulator_tpu/obs/metrics.py` (host code with no
dependencies), kept so that the port imports nothing of the JAX package.

The reference leans on kube-scheduler's component-base metrics surface
(schedule_attempts_total, e2e_scheduling_duration_seconds, the framework
extension-point histograms) exposed over /metrics; this is the same idea
without a prometheus_client dependency: a process-wide thread-safe registry
of typed metric families with label support, a Prometheus-text renderer for
the server's `GET /metrics`, and a JSON snapshot form used by the CLI's
`--metrics-out`, bench rows, and `/debug/vars`.

Design constraints, in order:
- **Host-side only.** Nothing here runs on the device or waits for it: the
  engine updates the registry between kernel dispatches, never inside one.
- **Cheap increments.** One lock acquisition per update on a pre-resolved
  child (`.labels()` is amortized: resolve once, hold the child). The hot
  engine paths update per BATCH, not per pod.
- **Get-or-create.** `counter(name, ...)` returns the existing family when
  already registered (the engine is constructed many times per process);
  re-registering under a different type or label set is a programming error
  and raises.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets for wall-clock seconds (scheduling spans many
# decades: µs-scale host bookkeeping to multi-second cold compiles).
SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0)
# Pod-count buckets: powers of ~4 up to the north-star batch size.
PODS_BUCKETS = (1.0, 8.0, 32.0, 128.0, 512.0, 2048.0, 8192.0, 32768.0, 131072.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare (stable goldens)."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Child:
    """One labeled time series. Updates lock the family's lock (uncontended
    in practice: the engine updates from one thread per Simulator)."""

    __slots__ = ("_family", "_value")

    def __init__(self, family: "MetricFamily") -> None:
        self._family = family
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0 and self._family.type == "counter":
            raise ValueError("counters only go up")
        with self._family._lock:
            self._value += amount

    def set(self, value: float) -> None:
        if self._family.type != "gauge":
            raise TypeError(f"set() on a {self._family.type}")
        with self._family._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class _HistChild:
    __slots__ = ("_family", "_counts", "_sum", "_count")

    def __init__(self, family: "MetricFamily") -> None:
        self._family = family
        self._counts = [0] * (len(family.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # Prometheus bucket semantics: le is INCLUSIVE (value <= bound).
        i = bisect_left(self._family.buckets, value)
        with self._family._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1


class MetricFamily:
    """One named metric with a fixed label-name tuple and typed children."""

    def __init__(self, name: str, help: str, type: str,
                 label_names: Tuple[str, ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.help = help
        self.type = type  # "counter" | "gauge" | "histogram"
        self.label_names = tuple(label_names)
        if type == "histogram":
            bs = tuple(float(b) for b in (buckets or SECONDS_BUCKETS))
            if list(bs) != sorted(bs):
                raise ValueError(f"{name}: buckets must be sorted")
            self.buckets: Tuple[float, ...] = bs
        else:
            self.buckets = ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    # ------------------------------------------------------------- children --

    def labels(self, **kv: str):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        # double-checked fast path: dict.get is GIL-atomic and a miss
        # re-checks under _lock below, which is the only publisher; a stale
        # miss costs one lock round-trip
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (_HistChild(self) if self.type == "histogram"
                             else _Child(self))
                    self._children[key] = child
        return child

    def _default(self):
        if self.label_names:
            raise ValueError(f"{self.name}: labeled metric needs .labels(...)")
        return self.labels()

    # unlabeled conveniences
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    # ------------------------------------------------------------ rendering --

    def samples(self) -> List[dict]:
        """JSON-able per-child samples (snapshot form). Child state is COPIED
        under the family lock, so every row is internally consistent even
        while 16 serve threads update it — a torn histogram (counts bumped,
        sum not yet) can never escape into a scrape (the /metrics +
        /debug/pprof concurrent-scrape fix; tests/test_scope.py hammers it)."""
        with self._lock:
            items = sorted(self._children.items())
            if self.type == "histogram":
                rows = [(key, list(child._counts), child._sum, child._count)
                        for key, child in items]
            else:
                rows = [(key, child._value) for key, child in items]
        out: List[dict] = []
        if self.type == "histogram":
            for key, counts, hsum, count in rows:
                out.append({
                    "labels": dict(zip(self.label_names, key)),
                    "buckets": [[b, c] for b, c in
                                zip(list(self.buckets) + ["+Inf"], counts)],
                    "sum": hsum,
                    "count": count,
                })
        else:
            for key, value in rows:
                out.append({"labels": dict(zip(self.label_names, key)),
                            "value": value})
        return out

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type}"]
        for s in self.samples():  # one locked copy; render from the snapshot
            key = tuple(str(s["labels"][n]) for n in self.label_names)
            if self.type == "histogram":
                cum = 0
                for b, c in s["buckets"]:
                    cum += c
                    le = "+Inf" if b == "+Inf" else _fmt(float(b))
                    ls = _label_str(self.label_names + ("le",), key + (le,))
                    lines.append(f"{self.name}_bucket{ls} {cum}")
                base = _label_str(self.label_names, key)
                lines.append(f"{self.name}_sum{base} {_fmt(s['sum'])}")
                lines.append(f"{self.name}_count{base} {s['count']}")
            else:
                ls = _label_str(self.label_names, key)
                lines.append(f"{self.name}{ls} {_fmt(s['value'])}")
        return lines


class Registry:
    """Process-wide metric store. `REGISTRY` below is the default instance;
    tests build private ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, help: str, type: str,
                       label_names: Iterable[str],
                       buckets: Optional[Tuple[float, ...]] = None
                       ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type or fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"type/labels ({fam.type}{fam.label_names} vs "
                        f"{type}{tuple(label_names)})")
                return fam
            fam = MetricFamily(name, help, type, tuple(label_names), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str,
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str, labels: Iterable[str] = (),
                  buckets: Optional[Tuple[float, ...]] = None) -> MetricFamily:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    # ------------------------------------------------------------- exports ---

    def render_text(self) -> str:
        """Prometheus exposition format (text/plain; version=0.0.4). Built
        from ONE snapshot() pass so a scrape racing concurrent updates sees
        every family at a single locked copy (no partially-applied rows) —
        and /metrics, /debug/vars, and --metrics-out all flatten the same
        snapshot shape."""
        return render_text_from_snapshot(self.snapshot())

    def snapshot(self) -> dict:
        """JSON-able full dump: {name: {type, help, labels, samples}}."""
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        return {
            fam.name: {
                "type": fam.type,
                "help": fam.help,
                "label_names": list(fam.label_names),
                **({"bucket_bounds": list(fam.buckets)}
                   if fam.type == "histogram" else {}),
                "samples": fam.samples(),
            }
            for fam in fams
        }

    def values(self) -> Dict[str, float]:
        """Flat {name{labels}: value} view — /debug/vars and bench rows.
        Histograms flatten to _sum/_count only (buckets stay in snapshot())."""
        return values_from_snapshot(self.snapshot())


def values_from_snapshot(snap: dict) -> Dict[str, float]:
    """Flat {name{labels}: value} view of a snapshot() dump — shared by
    Registry.values() and `simon metrics --diff`, so live and saved dumps
    flatten identically (same sample keys, same histogram _sum/_count
    treatment) and a diff can line them up one-to-one."""
    out: Dict[str, float] = {}
    for name, fam in sorted(snap.items()):
        for s in fam.get("samples", []):
            labels = s.get("labels", {})
            ls = _label_str(tuple(sorted(labels)),
                            tuple(v for _, v in sorted(labels.items())))
            if fam.get("type") == "histogram":
                out[f"{name}_sum{ls}"] = s.get("sum", 0.0)
                out[f"{name}_count{ls}"] = s.get("count", 0)
            else:
                out[f"{name}{ls}"] = s.get("value", 0.0)
    return out


def render_text_from_snapshot(snap: dict) -> str:
    """Rebuild Prometheus text from a snapshot() dump — `simon metrics
    FILE.json` renders saved dumps without re-running anything."""
    lines: List[str] = []
    for name in sorted(snap):
        fam = snap[name]
        label_names = tuple(fam.get("label_names") or ())
        lines.append(f"# HELP {name} {fam.get('help', '')}")
        lines.append(f"# TYPE {name} {fam.get('type', 'untyped')}")
        for s in fam.get("samples", []):
            key = tuple(str(s.get("labels", {}).get(n, "")) for n in label_names)
            if fam.get("type") == "histogram":
                cum = 0
                for b, c in s.get("buckets", []):
                    cum += c
                    le = "+Inf" if b == "+Inf" else _fmt(float(b))
                    ls = _label_str(label_names + ("le",), key + (le,))
                    lines.append(f"{name}_bucket{ls} {cum}")
                base = _label_str(label_names, key)
                lines.append(f"{name}_sum{base} {_fmt(float(s.get('sum', 0.0)))}")
                lines.append(f"{name}_count{base} {int(s.get('count', 0))}")
            else:
                ls = _label_str(label_names, key)
                lines.append(f"{name}{ls} {_fmt(float(s.get('value', 0.0)))}")
    return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = Registry()


def counter(name: str, help: str, labels: Iterable[str] = ()) -> MetricFamily:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str, labels: Iterable[str] = ()) -> MetricFamily:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str, labels: Iterable[str] = (),
              buckets: Optional[Tuple[float, ...]] = None) -> MetricFamily:
    return REGISTRY.histogram(name, help, labels, buckets)
