"""Scenario sweeps: the PyTorch port against the JAX package.

- The three example specs (examples/sweeps/*.yaml) through the port's CLI on
  the CPU (`python -m open_simulator_torch.cli sweep SPEC --out R --device
  cpu`, parity full) write reports byte-identical to the JAX package's
  `simon sweep SPEC --out R`, stored as tests/golden/torch_port_sweep_*.json.
- The route and parity cases of tests/test_sweep.py run on both packages
  from the same spec, and the two reports are byte-identical: the wave
  route over every family, the scan route, mixed routing, the fresh route
  of an image-declined cluster, padding segments, seeds and the report
  layer. The port's parity check raises on a doctored lane, and the native
  signature path off (SIMON_NO_NATIVE=1) gives the same report.

The goldens are written by the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write [NAME ...]

NAME is an example spec (zone-outage, monte-carlo-mix, preemption-storm) or
`bench`, bench.py's 256-scenario sweep (tests/golden/
torch_port_sweep_bench.spec.json at --fanout 32, parity off: about 80 s).
"""

import copy
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # run as a script (--write), the repo is not on the path
EXAMPLES = ("zone-outage", "monte-carlo-mix", "preemption-storm")
BENCH_SPEC = os.path.join(REPO, "tests", "golden", "torch_port_sweep_bench.spec.json")


def golden_path(name: str) -> str:
    return os.path.join(REPO, "tests", "golden", f"torch_port_sweep_{name}.json")


def spec_path(name: str) -> str:
    return BENCH_SPEC if name == "bench" else os.path.join(REPO, "examples", "sweeps",
                                                           f"{name}.yaml")


def jax_cli_args(name: str, out: str) -> list:
    extra = ["--fanout", "32", "--parity", "off"] if name == "bench" else []
    return ["sweep", spec_path(name), "--out", out, *extra]


def write_golden(name: str) -> None:
    from open_simulator_tpu.cli.main import main

    assert main(jax_cli_args(name, golden_path(name))) == 0


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_cli_report_is_byte_identical_to_jax(name, tmp_path, capsys):
    from open_simulator_torch.cli.main import main

    out = tmp_path / "report.json"
    assert main(["sweep", spec_path(name), "--out", str(out), "--device", "cpu"]) == 0
    with open(golden_path(name), "rb") as f:
        assert out.read_bytes() == f.read()
    assert "scenarios in" in capsys.readouterr().err  # the wall goes to stderr only


def test_golden_is_the_jax_report(tmp_path):
    from open_simulator_tpu.cli.main import main

    out = tmp_path / "jax.json"
    assert main(jax_cli_args("zone-outage", str(out))) == 0
    with open(golden_path("zone-outage"), "rb") as f:
        assert out.read_bytes() == f.read()


# ------------------------------------------------- the cases of test_sweep ----

from test_sweep import make_doc  # noqa: E402


def run(pkg: str, doc, **kw):
    if pkg == "jax":
        from open_simulator_tpu.sweep import SweepRunner, parse_spec
    else:
        from open_simulator_torch.sweep import SweepRunner, parse_spec

        kw["device"] = "cpu"
    kw.setdefault("parity", "full")
    kw.setdefault("fanout", 4)
    runner = SweepRunner(parse_spec(copy.deepcopy(doc)), **kw)
    runner.run()
    return runner


def report_bytes(pkg: str, runner) -> str:
    if pkg == "jax":
        from open_simulator_tpu.sweep import build_report, report_json
    else:
        from open_simulator_torch.sweep import build_report, report_json
    return report_json(build_report(runner))


def both(doc, **kw):
    """The port's runner, after checking its report bytes against JAX's."""
    port = run("torch", doc, **kw)
    assert report_bytes("torch", port) == report_bytes("jax", run("jax", doc, **kw))
    return port


def test_wave_route_parity_all_families():
    runner = both(make_doc([
        {"kind": "zone_outage", "zones": "all"},
        {"kind": "node_drain", "counts": [1, 3], "draws": 2},
        {"kind": "preemption_storm", "storms": [6, 16], "cpu": "2", "memory": "2Gi"},
        {"kind": "rollout_wave", "workload": "web", "steps": [50, 100], "cpu": "1500m",
         "memory": "1536Mi"},
        {"kind": "nodepool_mix", "counts": [1, 2], "cpu": "16", "memory": "32Gi"},
    ]))
    assert runner.parity_checked == len(runner.results)
    assert all(r.route == "wave" for r in runner.results.values())
    outage = next(r for r in runner.results.values() if r.scenario.family == "zone_outage")
    assert outage.nodes_live < 12
    pool = next(r for r in runner.results.values() if r.scenario.family == "nodepool_mix")
    assert pool.nodes_live > 12


def test_scan_route_parity_with_affinity_groups():
    runner = both(make_doc(
        [{"kind": "node_drain", "counts": [2], "draws": 2},
         {"kind": "monte_carlo", "draws": 2, "templates": [
             {"name": "mc", "replicas": [4, 16], "cpu": "500m", "memory": "512Mi"},
             {"name": "pair", "replicas": [2, 6], "cpu": "250m", "memory": "256Mi",
              "affinityOn": "pair"}]}],
        workload=[{"name": "web", "replicas": 12, "cpu": "1", "memory": "1Gi"},
                  {"name": "pair", "replicas": 6, "cpu": "250m", "memory": "256Mi",
                   "affinityOn": "pair"}]))
    assert {r.route for r in runner.results.values()} == {"scan"}
    assert runner.parity_checked == len(runner.results)


def test_mixed_wave_and_scan_routing():
    runner = both(make_doc([
        {"kind": "node_drain", "counts": [1], "draws": 2},
        {"kind": "monte_carlo", "draws": 2, "templates": [
            {"name": "solo", "replicas": [3, 10], "cpu": "500m", "memory": "512Mi",
             "affinityOn": "solo"}]},
    ]))
    routes = [r.route for _, r in sorted(runner.results.items())]
    assert "wave" in routes and "scan" in routes
    assert set(runner.dispatches) == {"sweep_wave_fanout", "sweep_whatif_fanout"}


def test_census_dependent_workload_gates_fresh():
    from open_simulator_torch.sweep.families import build_pod
    from open_simulator_torch.sweep.spec import PodTemplate

    runner = run("torch", make_doc([{"kind": "node_drain", "counts": [1], "draws": 1}]))
    pods = [build_pod(f"spready-{i}", PodTemplate(name="spready", replicas=0))
            for i in range(4)]
    for p in pods:
        p["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "spready"}}}]
    session = runner.image.session(pods)
    gate = runner.image.eligible(session.batch, pods)
    assert gate is not None and "spread" in gate


def test_image_declined_cluster_runs_fresh_end_to_end(monkeypatch):
    """Node-advertised images: the image declines the cluster, and every
    scenario runs the fresh path on both packages with the same report."""
    import open_simulator_torch.sweep.runner as port_runner
    import open_simulator_tpu.sweep.runner as jax_runner

    doc = make_doc([{"kind": "node_drain", "counts": [1], "draws": 1}])
    for mod in (port_runner, jax_runner):
        orig = mod.build_base

        def with_images(spec, orig=orig):
            nodes, bound = orig(spec)
            nodes[0].setdefault("status", {})["images"] = [
                {"names": ["busybox"], "sizeBytes": 1 << 20}]
            return nodes, bound

        monkeypatch.setattr(mod, "build_base", with_images)
    runner = both(doc)
    assert runner.image is None
    assert all(r.route == "fresh" for r in runner.results.values())
    assert runner.parity_checked == 0


def test_parity_mismatch_raises_loudly():
    from open_simulator_torch.sweep import SweepParityError

    runner = run("torch", make_doc([{"kind": "node_drain", "counts": [1], "draws": 1}]),
                 parity="off")
    sid = max(runner.results)
    res = runner.results[sid]
    doctored = dict(res.census)
    doctored[next(iter(doctored))] += 1
    runner.results[sid] = res._replace(census=doctored)
    runner.parity = "full"
    with pytest.raises(SweepParityError, match="diverged"):
        runner._check_parity()


def test_parity_sample_and_off_modes():
    doc = make_doc([{"kind": "node_drain", "counts": [1, 2], "draws": 3}])
    assert both(doc, parity="sample", parity_sample=3).parity_checked == 3
    assert both(doc, parity="off").parity_checked == 0


def test_seed_override_changes_draws_and_report():
    doc = make_doc([
        {"kind": "node_drain", "counts": [2], "draws": 2},
        {"kind": "monte_carlo", "draws": 3, "templates": [
            {"name": "mc", "replicas": [1, 60], "cpu": "250m", "memory": "256Mi"}]},
    ])
    r1 = both(doc, parity="off")
    r2 = both(doc, parity="off", seed=12345)
    assert r1.seed != r2.seed
    assert ([len(s.pods) for s in r1.scenarios if s.family == "monte_carlo"]
            != [len(s.pods) for s in r2.scenarios if s.family == "monte_carlo"])


def test_report_schema_and_family_metrics():
    from open_simulator_torch.sweep import build_report, render_report

    runner = both(make_doc([
        {"kind": "preemption_storm", "storms": [10, 20], "cpu": "2", "memory": "2Gi"},
        {"kind": "nodepool_mix", "counts": [1, 2], "cpu": "16", "memory": "32Gi"},
        {"kind": "zone_outage", "zones": "all"},
    ], workload=[{"name": "web", "replicas": 40, "cpu": "1500m", "memory": "1536Mi"}]))
    report = build_report(runner)
    env = report["families"]["nodepool_mix"]["capacity_envelope"]
    assert [e["nodes"] for e in env] == [13, 14]
    text = render_report(report)
    assert "capacity envelope" in text and "victims" in text


def test_wave_chain_padding_segments_are_noops():
    doc = make_doc([{"kind": "node_drain", "counts": [1], "draws": 1}],
                   workload=[{"name": "web", "replicas": 10, "cpu": "1", "memory": "1Gi"}])
    r1 = both(doc)
    doc2 = copy.deepcopy(doc)
    doc2["spec"]["workload"] = [
        {"name": "web", "replicas": 10, "cpu": "1", "memory": "1Gi"},
        {"name": "w2", "replicas": 1, "cpu": "250m", "memory": "256Mi"},
        {"name": "w3", "replicas": 1, "cpu": "250m", "memory": "256Mi"}]
    r2 = both(doc2)
    c1 = dict(r1.results[0].census)
    web = {k[1] for k in c1}
    assert c1 == {k: v for k, v in r2.results[0].census.items() if k[1] in web}


def test_same_report_without_native_signatures(monkeypatch):
    """SIMON_NO_NATIVE=1: the computed tuple keys the groups and the
    census; the report is the native run's, and the two never mix within a
    run (every signature of the run comes from one path)."""
    import open_simulator_torch.simulator.encode as port_encode

    doc = make_doc([{"kind": "zone_outage", "zones": "all"},
                    {"kind": "monte_carlo", "draws": 2, "templates": [
                        {"name": "solo", "replicas": [3, 10], "cpu": "500m",
                         "memory": "512Mi", "affinityOn": "solo"}]}])
    native = report_bytes("torch", run("torch", doc))
    monkeypatch.setattr(port_encode, "_native_hash", None)
    runner = run("torch", doc)
    assert report_bytes("torch", runner) == native
    assert all(isinstance(k[1], tuple) for r in runner.results.values() for k in r.census)


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write [NAME ...]")
    names = [n for n in sys.argv[1:] if n in EXAMPLES + ("bench",)] or list(EXAMPLES)
    for n in names:
        write_golden(n)
        print("wrote", golden_path(n))
