"""The capacity probe session and the planner's search: the port against JAX.

The port's ProbeSession gives the JAX session's (scheduled, total,
utilization) for every candidate on the scenarios of
tests/test_probe_incremental.py (bucket boundaries, the node-axis extension
on the device path and on the re-upload path, serial segments, live
SelectorSpread), returns None on the same gates, and agrees with the port's
fresh-Simulator probe. `CapacityPlanner.search()` gives JAX's found, n, hist
and stats (path, probes, dispatches, encodes) on the tests/test_apply.py
planner fixtures and the 2,000-pod shape of tools/capacity_smoke.py.
Tolerance zero throughout.
"""

import copy

import pytest

import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from fixtures import make_node, make_pod
from open_simulator_torch.apply.applier import CapacityPlanner as TorchPlanner
from open_simulator_torch.models.fakenode import new_fake_nodes
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.simulator.probe import ProbeSession as TorchSession
from open_simulator_torch.utils.synth import synth_capacity_cluster, synth_node, synth_pod
from open_simulator_tpu.apply.applier import CapacityPlanner as JaxPlanner
from open_simulator_tpu.simulator.probe import ProbeSession as JaxSession


@pytest.fixture(autouse=True)
def _no_envelope(monkeypatch):
    monkeypatch.delenv("MaxCPU", raising=False)
    monkeypatch.delenv("MaxMemory", raising=False)


def _cluster(n_base=2):
    base = [make_node(f"base-{i}", cpu="8", memory="16Gi") for i in range(n_base)]
    return base, make_node("tpl", cpu="8", memory="16Gi")


def _sessions(base, template, pods, cluster=None, n_new=2):
    js = JaxSession.try_build(base, template, copy.deepcopy(pods), cluster_objects=cluster,
                              n_new=n_new, mesh=None)
    tc = None if cluster is None else torch_types.ResourceTypes(services=cluster.services)
    ts = TorchSession.try_build(base, template, copy.deepcopy(pods), cluster_objects=tc,
                                n_new=n_new, device="cpu")
    return js, ts


def _fresh(base, template, pods, n, services=()):
    sim = TorchSimulator(base + new_fake_nodes(template, n), device="cpu")
    sim.register_cluster_objects(torch_types.ResourceTypes(services=list(services)))
    counts = sim.probe_pods(copy.deepcopy(pods))
    return counts, sim.probe_utilization()


def _assert_sessions_match(js, ts, ns, base=None, template=None, pods=None, services=()):
    assert js is not None and ts is not None
    assert js._segs == ts._segs
    want, got = js.probe_many(ns), ts.probe_many(ns)
    assert got == want
    if base is not None:  # the port's session against its own fresh probe
        for n in ns:
            (s, t), u = _fresh(base, template, pods, n, services)
            assert got[n] == (s, t, u), n


def test_session_matches_jax_across_bucket_boundary():
    base, template = _cluster()
    pods = [make_pod(f"p-{i}", cpu="2", memory="2Gi") for i in range(40)]
    js, ts = _sessions(base, template, pods, n_new=12)
    _assert_sessions_match(js, ts, [0, 3, 5, 6, 7, 8, 11, 14], base, template, pods)


def test_extension_on_the_device_path_matches_jax():
    """No hostname rows: the tables grow by extend_tables_on_device."""
    base, template = _cluster()
    pods = [make_pod(f"p-{i}", cpu="2", memory="2Gi") for i in range(40)]
    js, ts = _sessions(base, template, pods)
    before = ts.n_new
    js.ensure_capacity(12)
    ts.ensure_capacity(12)
    assert ts.n_new == js.n_new >= 12 and ts.extensions == 1
    assert ts.device_extensions == 1 and ts.uploads == 1 and ts.encodes == 1
    _assert_sessions_match(js, ts, [before - 1, before, before + 1, 12], base, template, pods)


def test_extension_on_the_upload_path_matches_jax():
    """Hostname self-anti-affinity: the domain axis widens, so the tables
    re-upload instead of growing on the device."""
    base, template = _cluster()
    pods = [make_pod(f"a-{i}", cpu="1", memory="1Gi", labels={"app": "a"}) for i in range(9)]
    for p in pods:
        p["spec"]["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "a"}},
                 "topologyKey": "kubernetes.io/hostname"}]}}
    js, ts = _sessions(base, template, pods)
    js.ensure_capacity(10)
    ts.ensure_capacity(10)
    assert ts.device_extensions == 0 and ts.uploads == 2
    _assert_sessions_match(js, ts, [0, 3, 6, 7, 10], base, template, pods)


def test_serial_segments_match_jax():
    base, template = _cluster()
    pods = [make_pod(f"s-{i}", cpu="3", memory="1Gi") if i % 3 == 0
            else make_pod(f"t-{i}", cpu="1", memory="3Gi") for i in range(24)]
    js, ts = _sessions(base, template, pods, n_new=8)
    assert {s[0] for s in ts._segs} == {"serial"}
    _assert_sessions_match(js, ts, [0, 2, 4, 6], base, template, pods)


def test_selector_spread_live_matches_jax():
    base, template = _cluster()
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "svc", "namespace": "default"},
           "spec": {"selector": {"app": "web"}}}
    cluster = jax_types.ResourceTypes(services=[svc])
    pods = [make_pod(f"w-{i}", cpu="1", memory="1Gi", labels={"app": "web"})
            for i in range(30)]
    js, ts = _sessions(base, template, pods, cluster=cluster, n_new=8)
    assert {s[0] for s in ts._segs} == {"spread"}
    _assert_sessions_match(js, ts, [0, 2, 4, 6], base, template, pods, [svc])


def test_session_gates_match_jax():
    base, template = _cluster()
    plain = [make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(10)]
    sp = make_pod("sp-0", cpu="1", memory="1Gi", labels={"app": "x"})
    sp["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "x"}}}]
    imgbase = [make_node("ib", cpu="8", memory="16Gi")]
    imgbase[0]["status"]["images"] = [{"names": ["busybox"], "sizeBytes": 100 << 20}]
    mixed = [make_pod("free"), make_pod("bound", node_name="base-0")]
    for b, pods in ((base, [sp] * 10), (imgbase, plain), (base, mixed)):
        js, ts = _sessions(b, template, pods, n_new=4)
        assert js is None and ts is None
    assert TorchSession.try_build(base, None, plain, device="cpu") is None
    ordered = [make_pod("bound", node_name="base-0", cpu="2", memory="2Gi"),
               make_pod("free", cpu="2", memory="2Gi")]
    js, ts = _sessions(base, template, ordered, n_new=4)
    _assert_sessions_match(js, ts, [0, 1])


def test_capacity_lanes_segment_census():
    """synth_capacity_cluster at its full size routes a segment of every
    kind: plain and cap-1 (hostname anti-affinity) waves, group-serial
    (Service), affinity (zone self-affinity) and serial chunks."""
    base, template, pods, services = synth_capacity_cluster(512, 20000)
    ts = TorchSession.try_build(base, template, pods,
                                torch_types.ResourceTypes(services=services), device="cpu")
    census = {}
    for s in ts._segs:
        key = s[0] + ("/cap1" if s[0] == "wave" and s[4] else "")
        census[key] = census.get(key, 0) + s[2]
    assert census == {"wave": 4000, "wave/cap1": 4000, "spread": 4000, "affinity": 4000,
                      "serial": 4000}
    assert ts._host_counters  # growth takes the re-upload path


def _planner_fixture():
    base = [make_node(f"base-{i}", cpu="8", memory="16Gi") for i in range(2)]
    template = make_node("tpl", cpu="8", memory="16Gi")
    pods = [make_pod(f"p-{i}", cpu="2", memory="2Gi") for i in range(20)]
    return base, template, pods


def _search_both(base, template, pods, fresh=False):
    out = []
    for cls, kw in ((JaxPlanner, {}), (TorchPlanner, {"device": "cpu"})):
        planner = cls(base, template, copy.deepcopy(pods), **kw)
        found, n, hist = planner._search_fresh() if fresh else planner.search()
        stats = {k: planner.stats[k] for k in ("path", "probes", "dispatches", "encodes")}
        out.append((found, n, [tuple(h) for h in hist], stats))
    return out


def test_planner_lower_bound_matches_jax(monkeypatch):
    base, template, pods = _planner_fixture()
    jp, tp = JaxPlanner(base, template, pods), TorchPlanner(base, template, pods, device="cpu")
    assert tp.lower_bound() == jp.lower_bound() == 3
    monkeypatch.setenv("MaxCPU", "50")
    assert tp.lower_bound() == jp.lower_bound() == 8


@pytest.mark.parametrize("max_cpu", [None, "50"])
def test_planner_search_matches_jax(monkeypatch, max_cpu):
    if max_cpu:
        monkeypatch.setenv("MaxCPU", max_cpu)
    base, template, pods = _planner_fixture()
    want, got = _search_both(base, template, pods)
    assert got == want
    assert got[3]["path"] == "incremental" and got[3]["encodes"] == 1


def test_planner_fresh_search_matches_jax():
    base, template, pods = _planner_fixture()
    want, got = _search_both(base, template, pods, fresh=True)
    assert got == want and got[3]["path"] == "fresh"


def test_planner_capacity_smoke_shape(monkeypatch):
    """tools/capacity_smoke.py: 2,000 pods x 100m on 8 x 32-core nodes under
    a 60% MaxCPU envelope needs 3 more nodes, found on the incremental path
    with one encode; the port's fresh probe agrees at n and fails at n-1."""
    monkeypatch.setenv("MaxCPU", "60")
    base = [synth_node(i) for i in range(8)]
    template = synth_node(0)
    pods = [synth_pod(i) for i in range(2000)]
    want, got = _search_both(base, template, pods)
    assert got == want
    assert got[:2] == (True, 3) and got[3]["encodes"] == 1
    planner = TorchPlanner(base, template, pods, device="cpu")
    assert planner.probe(3)[0] and not planner.probe(2)[0]


def test_planner_homeless_pods_not_failures():
    base = [make_node("base-0", cpu="8", memory="16Gi")]
    template = make_node("tpl", cpu="8", memory="16Gi")
    pods = [make_pod("ghost", cpu="64", memory="64Gi", node_name="no-such-node")]
    pods += [make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(4)]
    planner = TorchPlanner(base, template, pods, device="cpu")
    assert planner.lower_bound() == 0
    assert planner.probe(0) == (True, 0)


def test_planner_gates():
    cluster = torch_types.ResourceTypes()
    cluster.nodes = [make_node("n0")]
    app = torch_types.ResourceTypes()
    app.daemon_sets = [{"kind": "DaemonSet", "metadata": {"name": "ds"}}]
    tpl = make_node("tpl")
    assert TorchPlanner.try_build(
        cluster, [torch_types.AppResource(name="a", resource=app)], tpl, []) is None
    assert TorchPlanner.try_build(
        cluster, [torch_types.AppResource(name="a", resource=torch_types.ResourceTypes())],
        tpl, []) is not None
    cluster.pods = [make_pod("pending-first"), make_pod("bound-later", node_name="n0")]
    assert TorchPlanner.try_build(cluster, [], tpl, []) is None
    cluster.pods = [make_pod("bound-first", node_name="n0"), make_pod("pending-later")]
    assert TorchPlanner.try_build(cluster, [], tpl, []) is not None
