"""The xray flight recorder of the port against the JAX package's.

- K7's plain version: `kernels.explain_jit` (plain `explain_pod` on CPU
  tensors) against JAX `explain_jit` on every group of the five batches of
  tests/test_torch_kernels.py, on a mid-run carry, with a forced node, and
  on a full carry under which no node is feasible; the extended batch with
  the GPU-share and Open-Local branches on. All 26 rows over all N, bit for
  bit (f32 compared as their bit patterns, so a -0.0 for a 0.0 fails too).
- Recording is a pure observer: placements, reasons and probe counts are
  the same with recording on and off on every route (wave, affinity with
  its epoch statistics, spread, serial, probe).
- The trace: every record (sets with n_feasible, stage_reject, topk and
  reasons; batches with their pod rows), every npz array, every rendered
  explanation and the unscheduled summary equal the JAX package's trace of
  the same inputs; only backend_path and the header's pid and timestamp are
  left out of the comparison.
- The simon_filter_rejections_total deltas reconcile with the trace's
  reasons and equal the JAX package's deltas.
- The CLI: apply --xray --metrics-out --trace-out, explain, explain
  --unscheduled, an unknown pod and metrics --diff.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from fixtures import make_node, make_pod
from open_simulator_torch.obs import REGISTRY as TORCH_REGISTRY
from open_simulator_torch.obs import xray as tx
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.utils.synth import synth_cluster, synth_extended_cluster
from open_simulator_tpu.obs import REGISTRY as JAX_REGISTRY
from open_simulator_tpu.obs import xray as jx
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from test_torch_kernels import BATCHES
from test_xray import census_of, replicas, with_spread, zoned

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_recorders(monkeypatch):
    monkeypatch.delenv("OPEN_SIMULATOR_XRAY", raising=False)
    for x in (tx, jx):
        x.disable()
    yield
    for x in (tx, jx):
        x.disable()


def test_component_and_stage_names_match_the_kernels():
    assert tuple(tx.COMPONENT_NAMES) == tuple(tk.COMPONENT_ORDER) == tuple(jk.COMPONENT_ORDER)
    assert tuple(tx.STAGE_NAMES) == tuple(tk.EXPLAIN_STAGES) == tuple(jx.STAGE_NAMES)
    assert tk.EXPLAIN_ROWS == ("feasible", "total") + tx.STAGE_NAMES + tx.COMPONENT_NAMES
    assert sorted(tk.EXPLAIN_STAGES) == sorted(tk.STAGE_ROWS)


# ------------------------------------------------------------ explain_pod ----


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    assert not np.isnan(a).any(), "NaN in an explain row"
    return a.view(np.uint32)


def _same_rows(want, got_packed, N: int, where) -> None:
    """JAX explain_jit's four-tuple against the port's packed rows, row by
    row, bit for bit."""
    jf, js, jtot, jcomp = want
    f, s, tot, comp = tk.unpack_explain(got_packed)
    assert np.array_equal(np.asarray(jf), f.numpy()), (where, "feasible")
    for k in tk.EXPLAIN_STAGES:
        assert np.array_equal(np.asarray(js[k]), s[k].numpy()), (where, k)
    assert np.array_equal(_bits(jtot), _bits(tot.numpy())), (where, "total")
    for k in tk.COMPONENT_ORDER:
        w = np.broadcast_to(np.asarray(jcomp[k], np.float32), (N,))
        neg0 = np.signbit(comp[k].numpy()) & (comp[k].numpy() == 0)
        assert np.array_equal(_bits(w), _bits(comp[k].numpy())), (where, k, int(neg0.sum()))


@pytest.fixture(scope="module", params=sorted(BATCHES))
def explain_batch(request):
    """(name, bt, JAX tables, port tables, {carry kind: (JAX carry, port
    carry)}, groups, flags): the mid-run carry of test_torch_kernels.py and
    a full carry (requested = alloc) under which no node fits."""
    sim, pods = BATCHES[request.param]()
    bt = sim.encode_batch(pods)
    jt, jc = sim._to_device(bt)
    P = len(pods)
    ext = request.param == "extended"
    flags = dict(enable_gpu=ext, enable_storage=ext)
    valid = np.arange(bt.pod_group.shape[0]) < P // 2
    mid, _ = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, valid, n_zones=bt.n_zones,
                               **flags)
    full = mid._replace(requested=jnp.asarray(bt.alloc))
    carries = {}
    for kind, c in (("mid", mid), ("full", full)):
        arrays = {f: np.asarray(v) for f, v in c._asdict().items()}
        carries[kind] = (c, tk.carry_from_numpy(arrays, "cpu"))
    groups = sorted({int(g) for g in bt.pod_group[:P]})
    return request.param, bt, jt, tk.tables_from_batch(bt, "cpu"), carries, groups, flags


@pytest.mark.parametrize("carry_kind", ["mid", "full"])
def test_explain_matches_jax(explain_batch, carry_kind):
    name, bt, jt, tt, carries, groups, flags = explain_batch
    jc, tc = carries[carry_kind]
    N = bt.alloc.shape[0]
    empty = 0
    for g in groups:
        for forced in (-1, (7 * g + 3) % N):
            want = jk.explain_jit(jt, jc, jnp.int32(g), jnp.int32(forced), jnp.asarray(True),
                                  n_zones=bt.n_zones, **flags)
            got = tk.explain_jit(tt, tc, g, forced, True, bt.n_zones, **flags)
            assert got.dtype == torch.float32 and tuple(got.shape) == (26, N)
            _same_rows(want, got, N, (name, carry_kind, g, forced))
            empty += not bool(np.asarray(want[0]).any())
    if carry_kind == "full":
        assert empty == 2 * len(groups)  # every set of the full carry is empty


def test_explain_pod_returns_jax_shape():
    sim, pods = BATCHES["synthetic"]()
    bt = sim.encode_batch(pods)
    tt, tc = tk.tables_from_batch(bt, "cpu"), tk.carry_from_batch(bt, "cpu")
    feasible, stages, total, comp = tk.explain_pod(tt, tc, int(bt.pod_group[0]), -1, True,
                                                   bt.n_zones)
    assert feasible.dtype == torch.bool and total.dtype == torch.float32
    assert list(stages) == list(tk.EXPLAIN_STAGES) and list(comp) == list(tk.COMPONENT_ORDER)
    packed = tk.pack_explain(feasible, stages, total, comp)
    again = tk.unpack_explain(packed)
    assert torch.equal(again[0], feasible) and torch.equal(again[2], total)
    assert tk.launch_counts()["explain_jit"] == 0  # the CPU path launches nothing


# ------------------------------------------------- recording is an observer ----


def _torch_sim(nodes, use_waves=True, services=(), scs=()):
    sim = TorchSimulator(copy.deepcopy(nodes), device="cpu")
    sim.use_waves = use_waves
    sim.register_cluster_objects(torch_types.ResourceTypes(services=list(services),
                                                           storage_classes=list(scs)))
    return sim


def _jax_sim(nodes, use_waves=True, services=(), scs=()):
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=False)
    sim.use_waves = use_waves
    sim.register_cluster_objects(jax_types.ResourceTypes(services=list(services),
                                                         storage_classes=list(scs)))
    return sim


def _run(make, nodes, batches, use_waves=True, services=(), scs=()):
    sim = make(nodes, use_waves, services, scs)
    failed = []
    for batch in batches:
        failed.extend(sim.schedule_pods(copy.deepcopy(batch)))
    return sim, failed


def _wave():
    return [make_node(f"n{i}", cpu="8") for i in range(6)], [replicas("web", 40, cpu="200m")]


def _affinity():
    pods = with_spread(replicas("dns", 24, cpu="100m", memory="128Mi"), "dns")
    return zoned(8, 4, cpu="8"), [pods]


def _spread():
    pods = with_spread(replicas("sa", 20, cpu="100m", memory="128Mi"), "sa",
                       when="ScheduleAnyway")
    return zoned(6, 3, cpu="8"), [pods]


def _serial():
    pods = [make_pod(f"mix-{i}", cpu=f"{100 + 7 * (i % 9)}m") for i in range(30)]
    return [make_node(f"n{i}", cpu="8") for i in range(5)], [pods]


def _bound_homeless():
    pods = [make_pod("pinned", node_name="n0"), make_pod("lost", node_name="ghost-node"),
            make_pod("free", cpu="100m")] + replicas("big", 12, cpu="3")
    return [make_node("n0", cpu="8"), make_node("n1", cpu="8")], [pods]


def _overflow():
    # 4 nodes x 256 pod slots cannot hold 1,200 pods: reasons, and decision
    # sets with no feasible node
    nodes, pods = synth_cluster(4, 1200, hard_predicates=True)
    return nodes, [pods]


ROUTE_CASES = {"wave": (_wave, "wave"), "affinity": (_affinity, "affinity"),
               "spread": (_spread, "spread"), "serial": (_serial, "serial")}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_recording_is_an_observer(case, tmp_path):
    make, kind = ROUTE_CASES[case]
    nodes, batches = make()
    sim_off, failed_off = _run(_torch_sim, nodes, batches)
    rec = tx.enable(str(tmp_path / "trace"))
    sim_on, failed_on = _run(_torch_sim, nodes, batches)
    assert census_of(sim_on) == census_of(sim_off)
    assert [u.reason for u in failed_on] == [u.reason for u in failed_off]
    pod = batches[0][3]["metadata"]["name"]
    exp = rec.explain(f"default/{pod}")
    assert exp["segment"]["kind"] == kind
    assert exp["result_name"] == "scheduled"
    assert exp["node_name"] == sim_on.na.names[exp["node"]]
    assert exp["node_scores"]["components"]
    if kind == "affinity":
        st = exp["segment"]["stats"]
        assert st["epochs"] >= 1 and st["rounds"] + st["head_fallbacks"] >= 1


def test_probe_recording_is_an_observer(tmp_path):
    nodes = [make_node(f"n{i}", cpu="4") for i in range(4)]
    pods = replicas("probe", 30, cpu="900m")
    off = _torch_sim(nodes).probe_pods(copy.deepcopy(pods))
    tx.enable(str(tmp_path / "trace"))
    on = _torch_sim(nodes).probe_pods(copy.deepcopy(pods))
    assert on == off
    assert tx.active().counts()["pods"] == 0  # probes leave no pod rows
    tx.disable()
    tr = tx.XrayTrace.load(str(tmp_path / "trace"))
    assert tr.probes == [{"kind": "probe", "scheduled": off[0], "total": off[1],
                          "backend_path": ["cpu"]}]


def test_failed_call_commits_no_records(tmp_path):
    nodes = [make_node("n0", cpu="8")]
    lo = make_pod("lo", cpu="1")
    hi = make_pod("hi", cpu="1")
    # an unparseable request fails the encode, before any launch or commit
    hi["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "lots"
    rec = tx.enable(str(tmp_path / "trace"))
    sim = _torch_sim(nodes)
    sim.schedule_pods([lo])
    with pytest.raises(ValueError, match="unparseable quantity"):
        sim.schedule_pods([hi])
    assert rec.counts()["pods"] == 1 and rec.explain("default/hi") is None
    assert [p["metadata"]["name"] for p in sim.pods_on_node[0]] == ["lo"]


# ---------------------------------------------------------- trace parity ----


def _record(pkg, prefix, nodes, batches, use_waves=True, services=(), scs=()):
    """Run the batches with pkg's recorder on; returns (sim, failed)."""
    x, make = (jx, _jax_sim) if pkg == "jax" else (tx, _torch_sim)
    x.enable(prefix)
    try:
        return _run(make, nodes, batches, use_waves, services, scs)
    finally:
        x.disable()


def _lines(prefix):
    out = []
    with open(prefix + ".jsonl") as f:
        for line in f:
            rec = json.loads(line)
            for k in ("backend_path", "pid", "created_unix"):
                rec.pop(k, None)
            out.append(rec)
    return out


def _rendered(trace, pod):
    exp = trace.explain(pod)
    exp["backend_path"] = []
    return tx.render_explanation(exp)


def _assert_same_trace(jprefix, tprefix):
    assert _lines(tprefix) == _lines(jprefix)
    with np.load(jprefix + ".npz") as zj, np.load(tprefix + ".npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            a, b = zj[k], zt[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
    jt, tt = jx.XrayTrace.load(jprefix), tx.XrayTrace.load(tprefix)
    assert tt.unscheduled_summary() == jt.unscheduled_summary()
    assert sorted(tt.index) == sorted(jt.index)
    for pod in tt.index:
        assert _rendered(tt, pod) == _rendered(jt, pod), pod
    return jt, tt


def _extended():
    nodes, pods, _, scs = synth_extended_cluster(48, 600)
    return nodes, [pods], scs


TRACE_CASES = {"wave": _wave, "affinity": _affinity, "spread": _spread, "serial": _serial,
               "bound_homeless": _bound_homeless, "overflow": _overflow}


@pytest.mark.parametrize("case", sorted(TRACE_CASES) + ["overflow_serial", "extended"])
def test_trace_matches_jax(case, tmp_path):
    scs, use_waves = (), case != "overflow_serial"
    if case == "extended":
        nodes, batches, scs = _extended()
    else:
        nodes, batches = TRACE_CASES[case.replace("_serial", "")]()
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "torch")
    j0, t0 = JAX_REGISTRY.values(), TORCH_REGISTRY.values()
    _, jfailed = _record("jax", jp, nodes, batches, use_waves, scs=scs)
    j1, t1 = JAX_REGISTRY.values(), TORCH_REGISTRY.values()
    _, tfailed = _record("torch", tp, nodes, batches, use_waves, scs=scs)
    t2 = TORCH_REGISTRY.values()
    assert [u.reason for u in tfailed] == [u.reason for u in jfailed]
    jt, tt = _assert_same_trace(jp, tp)
    scheduled = [k for k, r in tt.index.items() if r["result"] == tx.SCHEDULED]
    assert scheduled and "event: Scheduled" in _rendered(tt, scheduled[0])
    # the rejection counters: the port's deltas equal JAX's, and each failed
    # pod adds its set's reasons
    rej = "simon_filter_rejections_total"

    def delta(a, b):
        return {k: b.get(k, 0) - a.get(k, 0) for k in b if k.startswith(rej)
                and b.get(k, 0) != a.get(k, 0)}

    assert delta(t1, t2) == delta(j0, j1)
    assert not delta(t0, t1)
    want: dict = {}
    for key, row in tt.index.items():
        if row["result"] == tx.UNSCHEDULABLE:
            for label, n in tt.sets[row["set"]]["reasons"].items():
                k = f'{rej}{{reason="{label}"}}'
                want[k] = want.get(k, 0) + n
    assert delta(t1, t2) == want
    if case.startswith("overflow"):
        assert tfailed
        assert "event: FailedScheduling: 0/4 nodes are available" in _rendered(
            tt, next(k for k, r in tt.index.items() if r["result"] == tx.UNSCHEDULABLE))
    if case == "overflow":  # a set after the cluster filled up: no feasible node
        assert any(s["n_feasible"] == 0 for s in tt.sets.values())
    if case == "extended":
        assert tfailed and jt.sets


def test_probe_session_records_match_jax(tmp_path, monkeypatch):
    from open_simulator_torch.simulator.probe import ProbeSession as TorchSession
    from open_simulator_tpu.simulator.probe import ProbeSession as JaxSession

    monkeypatch.delenv("MaxCPU", raising=False)
    base = [make_node(f"base-{i}", cpu="8", memory="16Gi") for i in range(2)]
    tpl = make_node("tpl", cpu="8", memory="16Gi")
    pods = replicas("app", 40, cpu="1")
    for pkg, x in (("jax", jx), ("torch", tx)):
        x.enable(str(tmp_path / pkg))
        if pkg == "jax":
            ses = JaxSession.try_build(base, tpl, copy.deepcopy(pods), n_new=4, mesh=None)
        else:
            ses = TorchSession.try_build(base, tpl, copy.deepcopy(pods), n_new=4, device="cpu")
        ses.probe_many([0, 2, 4])
        x.disable()
    assert _lines(str(tmp_path / "torch")) == _lines(str(tmp_path / "jax"))
    assert [r["candidate_nodes"] for r in _lines(str(tmp_path / "torch"))[1:]] == [0, 2, 4]


def test_serve_records_match_jax(tmp_path):
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_tpu.serve import ResidentImage as JaxImage
    from test_serve import make_cluster, whatif_pods

    nodes, bound = make_cluster(10, 8)
    reqs = [whatif_pods("a", 5), whatif_pods("anti", 6, anti_on="svc-0")]
    for pkg, x, Image, kw in (("jax", jx, JaxImage, {}), ("torch", tx, ResidentImage,
                                                          {"device": "cpu"})):
        img = Image.try_build(copy.deepcopy(nodes), pods=copy.deepcopy(bound), **kw)
        x.enable(str(tmp_path / pkg))
        img.dispatch_sessions([img.session(copy.deepcopy(r)) for r in reqs])
        img.fresh_probe(reqs[0])
        x.disable()
    got = _lines(str(tmp_path / "torch"))
    assert got == _lines(str(tmp_path / "jax"))
    assert [r["kind"] for r in got] == ["header", "probe", "probe", "probe"]


def test_sweep_records_one_probe_per_scenario(tmp_path):
    from open_simulator_torch.sweep import SweepRunner, load_spec

    tx.enable(str(tmp_path / "sweep"))
    runner = SweepRunner(load_spec(os.path.join(REPO, "examples", "sweeps", "zone-outage.yaml")),
                         parity="off", device="cpu")
    results = runner.run()
    tx.disable()
    probes = tx.XrayTrace.load(str(tmp_path / "sweep")).probes
    assert [(p["candidate_nodes"], p["scheduled"], p["total"]) for p in probes] == [
        (sid, r.scheduled, r.total) for sid, r in sorted(results.items())]
    assert all(p["backend_path"] == ["cpu"] for p in probes)


# --------------------------------------------------------------------- CLI ----


def test_cli_apply_xray_explain_and_metrics(tmp_path, monkeypatch, capsys):
    from open_simulator_torch.cli.main import main

    monkeypatch.chdir(REPO)
    monkeypatch.delenv("MaxCPU", raising=False)
    prefix, m1, m2, tr = (str(tmp_path / n) for n in ("x", "m1.json", "m2.json", "t.json"))
    args = ["apply", "-f", "examples/simon-smoke-config.yaml", "--device", "cpu"]
    assert main(args + ["--metrics-out", m1]) == 0
    assert main(args + ["--xray", "--xray-out", prefix, "--metrics-out", m2,
                        "--trace-out", tr]) == 0
    err = capsys.readouterr().err
    assert f"-> {prefix}.jsonl" in err
    trace = tx.XrayTrace.load(prefix)
    pod = next(iter(trace.index))
    assert main(["explain", pod, "--trace", prefix]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"pod: {pod}\nresult: scheduled") and "event: Scheduled" in out
    assert main(["explain", pod, "--trace", prefix, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["pod"] == pod
    assert main(["explain", "--unscheduled", "--trace", prefix]) == 0
    assert capsys.readouterr().out.endswith(
        f"# {len(trace.unscheduled)} unscheduled pod(s)\n")
    assert main(["explain", "default/no-such-pod", "--trace", prefix]) == 1
    assert "explain error: no decision record" in capsys.readouterr().err
    assert main(["explain", "--trace", prefix]) == 1  # neither a pod nor --unscheduled
    with open(tr) as f:
        doc = json.load(f)
    runs = [e for e in doc["traceEvents"] if e["name"] == "schedule_run"]
    assert runs and all("xray" in e["args"] for e in runs)
    assert "simon_xray_records_total" in doc["metadata"]["metrics"]
    assert main(["metrics", m2]) == 0
    assert "# TYPE simon_scheduling_attempts_total counter" in capsys.readouterr().out
    assert main(["metrics", "--diff", m1, m2]) == 0
    out = capsys.readouterr().out
    assert 'simon_xray_records_total{kind="set"}' in out and "regression(s)" in out
    assert main(["metrics", "--diff", m1, tr, "--fail-on-regression"]) == 0
    assert main(["metrics", "--diff", m1]) == 1
