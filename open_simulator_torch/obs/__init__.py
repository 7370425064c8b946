"""simonmetrics: first-party observability for the port's scheduling engine.

- `obs.metrics` — process-wide thread-safe registry (Counter / Gauge /
  Histogram with fixed buckets, labels, zero deps), Prometheus-text
  rendering, and JSON snapshots for `--metrics-out`.
- `obs.instruments` — the metric catalog (the JAX package's names, help
  strings and labels for every family the port emits) plus the dispatch
  shape tracker.
- `obs.chrome` — Chrome trace-event (perfetto-loadable) export of
  utils/trace.Span trees for `--trace-out FILE.json`, including span
  annotations (Span.annotate) as event args.
- `obs.xray` — simonxray, the opt-in per-pod scheduling flight recorder
  (`--xray` / OPEN_SIMULATOR_XRAY=1): decision records with kube-parity
  explanations, queryable via `explain` and the Chrome trace. Imported
  lazily by consumers (not re-exported here) so the metrics registry stays
  import-light.

Instrumentation lives on the HOST side of the device boundary: the engine
updates the registry between dispatches and never waits for the card to do
so.
"""

from .metrics import (  # noqa: F401
    REGISTRY,
    Registry,
    counter,
    gauge,
    histogram,
    render_text_from_snapshot,
    values_from_snapshot,
)
