"""Chrome trace-event export for utils/trace spans.

A copy of `open_simulator_tpu/obs/chrome.py`. Device profilers export
timelines as Chrome trace-event JSON loadable in perfetto /
chrome://tracing; this module gives the HOST spans
(utils/trace.Span trees: Simulate → schedule_run → encode/dispatch steps)
the same treatment, so a `--trace-out FILE.json` run drops one file that
perfetto renders as a nested flame chart.

Format: the JSON-object form of the trace-event spec — a `traceEvents`
array of complete ("ph": "X") events with microsecond `ts`/`dur`, plus a
`metadata` object carrying the metrics-registry snapshot (unknown top-level
keys are legal and ignored by viewers).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from ..utils.trace import Span


def _span_events(span: Span, pid: int, out: List[dict]) -> None:
    # annotations (Span.annotate — e.g. simonxray's per-batch decision
    # summary) merge into the event args, so each schedule_run span carries
    # its decision records straight into the perfetto UI
    args = dict(getattr(span, "meta", None) or {})
    if span.failed:
        args["failed"] = True
    out.append({
        "name": span.name,
        "ph": "X",
        "ts": round(span.t0 * 1e6, 3),
        "dur": round(span.total * 1e6, 3),
        "pid": pid,
        "tid": span.tid,
        "cat": "span",
        "args": args,
    })
    # steps are contiguous sub-intervals from the span start (utiltrace
    # semantics: step(i) measures since the previous mark)
    t = span.t0
    for name, dt in span.steps:
        out.append({
            "name": name,
            "ph": "X",
            "ts": round(t * 1e6, 3),
            "dur": round(dt * 1e6, 3),
            "pid": pid,
            "tid": span.tid,
            "cat": "step",
            "args": {},
        })
        t += dt
    for child in span.children:
        _span_events(child, pid, out)


def chrome_trace(spans: Sequence[Span], metrics: Optional[dict] = None) -> dict:
    """Build the trace-event JSON object for a list of root spans."""
    events: List[dict] = []
    pid = os.getpid()
    for sp in spans:
        _span_events(sp, pid, events)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"tool": "open-simulator-torch"},
    }
    if metrics is not None:
        doc["metadata"]["metrics"] = metrics
    return doc


def write_chrome_trace(path: str, spans: Sequence[Span],
                       metrics: Optional[dict] = None) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans, metrics), f, indent=1)
        f.write("\n")
