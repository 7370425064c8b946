"""The port's metrics registry, metric catalog and Chrome-trace writer
(open_simulator_torch/obs) against the JAX package's: the same Prometheus
text for the same registry (tests/golden/metrics.prom), every family the
port emits with the JAX family's type, help string and labels, and the
engine's counters."""

import copy
import json
import threading

import pytest

import open_simulator_tpu.obs.instruments as jax_instruments
from open_simulator_torch.obs import REGISTRY, instruments
from open_simulator_torch.obs.chrome import chrome_trace
from open_simulator_torch.obs.metrics import MetricFamily, Registry, render_text_from_snapshot
from open_simulator_torch.simulator.engine import Simulator
from open_simulator_torch.utils.trace import Span
from open_simulator_tpu.obs import REGISTRY as JAX_REGISTRY
from test_obs import GOLDEN, _golden_registry as _jax_golden_registry

from fixtures import make_node, make_pod


def _golden_registry() -> Registry:
    """The JAX test's golden registry, rebuilt on the port's Registry."""
    reg = Registry()
    for name, fam in _jax_golden_registry().snapshot().items():
        make = {"counter": reg.counter, "gauge": reg.gauge}.get(fam["type"])
        if make is None:
            f = reg.histogram(name, fam["help"], fam["label_names"],
                              buckets=tuple(fam["bucket_bounds"]))
        else:
            f = make(name, fam["help"], fam["label_names"])
        for s in fam["samples"]:
            child = f.labels(**s["labels"])
            if fam["type"] == "histogram":
                child._counts = [c for _, c in s["buckets"]]
                child._sum, child._count = s["sum"], s["count"]
            else:
                child._value = s["value"]
    return reg


def test_prometheus_rendering_matches_golden():
    assert _golden_registry().render_text() == GOLDEN.read_text()


def test_snapshot_roundtrips_through_json_to_same_text():
    reg = _golden_registry()
    snap = json.loads(json.dumps(reg.snapshot()))
    assert render_text_from_snapshot(snap) == reg.render_text()
    assert snap == json.loads(json.dumps(_jax_golden_registry().snapshot()))


def test_values_flat_view():
    v = _golden_registry().values()
    assert v['demo_requests_total{code="200",verb="GET"}'] == 3
    assert v["demo_queue_depth"] == 8.5
    assert v["demo_latency_seconds_count"] == 7


def test_counter_get_or_create_type_and_label_guards():
    reg = Registry()
    a = reg.counter("x_total", "x", ("l",))
    assert reg.counter("x_total", "x again", ("l",)) is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", "now a gauge", ("l",))
    with pytest.raises(ValueError):
        reg.counter("x_total", "other labels", ("other",))
    with pytest.raises(ValueError):
        a.labels(l="a").inc(-1)
    with pytest.raises(ValueError):
        a.labels(wrong="a")
    with pytest.raises(ValueError):
        a.inc()  # labeled family needs .labels()
    with pytest.raises(ValueError):
        reg.histogram("bad", "b", buckets=(2.0, 1.0))


def test_histogram_edges_inclusive_and_concurrent_updates():
    reg = Registry()
    h = reg.histogram("edge_seconds", "e", buckets=(1.0, 2.0))
    for v in (1.0, 2.0, 2.0001):
        h.observe(v)
    assert reg.snapshot()["edge_seconds"]["samples"][0]["buckets"] == [
        [1.0, 1], [2.0, 1], ["+Inf", 1]]
    c = reg.counter("t_total", "t").labels()

    def work():
        for _ in range(5_000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 20_000


def test_chrome_trace_carries_steps_annotations_and_failures():
    with Span("root", log_if_longer=99.0) as root:
        root.step("prep")
        root.annotate("xray", {"pods": 3})
        try:
            with Span("boom", log_if_longer=99.0):
                raise RuntimeError("x")
        except RuntimeError:
            pass
    doc = json.loads(json.dumps(chrome_trace([root], metrics={"m": 1})))
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert {"root", "prep", "boom"} <= set(by_name)
    assert by_name["root"]["args"] == {"xray": {"pods": 3}}
    assert by_name["boom"]["args"] == {"failed": True}
    assert doc["metadata"]["metrics"] == {"m": 1}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])


PORT_FAMILIES = sorted(n for n, f in vars(instruments).items() if isinstance(f, MetricFamily))


@pytest.mark.parametrize("name", PORT_FAMILIES)
def test_catalog_family_matches_jax(name):
    """Every family the port emits keeps the JAX family's metric name, type,
    help string, labels and buckets."""
    mine, theirs = getattr(instruments, name), getattr(jax_instruments, name)
    assert (mine.name, mine.type, mine.help, mine.label_names, mine.buckets) == (
        theirs.name, theirs.type, theirs.help, theirs.label_names, theirs.buckets)


def _total(values, prefix):
    return sum(v for k, v in values.items() if k.startswith(prefix))


def test_engine_emits_core_counters_and_warm_run_adds_no_misses():
    nodes = [make_node(f"m{i}") for i in range(4)]
    pods = [make_pod(f"p{i}", cpu="100m", memory="128Mi") for i in range(24)]

    def run():
        sim = Simulator(copy.deepcopy(nodes), device="cpu")
        assert sim.schedule_pods(copy.deepcopy(pods)) == []

    v0 = REGISTRY.values()
    run()
    v1 = REGISTRY.values()
    run()
    v2 = REGISTRY.values()
    att = "simon_scheduling_attempts_total"
    assert _total(v1, att) - _total(v0, att) == len(pods)
    assert _total(v2, att) - _total(v1, att) == len(pods)
    miss = "simon_compile_cache_misses_total"
    assert _total(v2, miss) == _total(v1, miss)
    assert _total(v2, "simon_commits_total") - _total(v1, "simon_commits_total") == len(pods)
    assert _total(v2, "simon_device_transfer_bytes_total") > 0
    assert _total(v2, "simon_segments_total") > _total(v1, "simon_segments_total")
    for k in ("simon_e2e_scheduling_duration_seconds_count", "simon_encode_seconds_count",
              "simon_host_commit_seconds_count", "simon_batch_pods_count"):
        assert v2[k] - v1[k] == 1, k
    assert JAX_REGISTRY is not REGISTRY  # the port keeps its own registry
