"""The port's apply layer against the JAX package: Applier, config, CLI.

`Applier.run()` on the repo's three example configs gives the JAX package's
answer: the nodes added and the report, with the time-seeded fake-node names
normalized (tests/golden/torch_port_apply_*.json, written by the JAX package
through tests/test_torch_golden.py). The smoke config at MaxCPU=40 adds
nodes through the probe search, the GPU-share config runs the serial lanes
with the GPU branch, and demo_1 (Open-Local nodes) gates the planner out, so
the full-simulation search runs. `python -m open_simulator_torch.cli apply
--device cpu` exits 0; the inputs not ported yet raise and name their
ROADMAP item.
"""

import os
import subprocess
import sys

import pytest
import torch

import open_simulator_tpu.api.v1alpha1 as jax_api
from fixtures import make_node, make_pod
from open_simulator_torch.api.v1alpha1 import ConfigError, parse_simon_config, validate_config
from open_simulator_torch.apply.applier import Applier, Options, satisfy_resource_setting
from open_simulator_torch.core.types import NodeStatus
from open_simulator_torch.parity import normalize_report
from test_torch_golden import APPLY_SCENARIOS, apply_run, load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "examples", "simon-smoke-config.yaml")


@pytest.mark.parametrize("kind", sorted(APPLY_SCENARIOS))
def test_applier_matches_jax_golden(kind):
    got = apply_run("open_simulator_torch", kind, device="cpu")
    want = load(kind)
    assert got["nodes_added"] == want["nodes_added"]
    assert got["unscheduled"] == want["unscheduled"]
    assert got["report"] == want["report"]


def test_smoke_config_adds_nodes_through_the_probe_search(monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("MaxCPU", "40")
    applier = Applier(Options(simon_config=SMOKE, device="cpu"))
    applier.out = open(os.devnull, "w")
    result = applier.run()
    assert result is not None and not result.unscheduled_pods
    assert applier.planner.stats["path"] == "incremental"
    assert applier.planner.stats["encodes"] == 1
    assert satisfy_resource_setting(result.node_status)[0]


def test_config_parse_matches_jax():
    a, b = parse_simon_config(SMOKE), jax_api.parse_simon_config(SMOKE)
    assert (a.api_version, a.kind, a.name, a.spec.cluster.custom_cluster, a.spec.new_node,
            [(x.name, x.path, x.chart) for x in a.spec.app_list]) == (
        b.api_version, b.kind, b.name, b.spec.cluster.custom_cluster, b.spec.new_node,
        [(x.name, x.path, x.chart) for x in b.spec.app_list])


def test_validate_config_xor(monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = parse_simon_config(SMOKE)
    validate_config(cfg)
    cfg.spec.cluster.kube_config = "/nonexistent/kubeconfig"
    with pytest.raises(ConfigError):
        validate_config(cfg)


def test_satisfy_resource_setting_env(monkeypatch):
    node = make_node("n1", cpu="10", memory="10Gi")
    pods = [make_pod(f"p{i}", cpu="2", memory="2Gi", node_name="n1") for i in range(4)]
    statuses = [NodeStatus(node=node, pods=pods)]
    assert satisfy_resource_setting(statuses)[0]
    monkeypatch.setenv("MaxCPU", "60")
    ok, reason = satisfy_resource_setting(statuses)
    assert not ok and "cpu" in reason
    monkeypatch.setenv("MaxCPU", "bogus")
    with pytest.raises(ConfigError):
        satisfy_resource_setting(statuses)


def test_inputs_not_ported_raise(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    for kw, item in (({"deadline": 5.0}, "A9"), ({"resume_journal": str(tmp_path / "j")}, "A9")):
        with pytest.raises(NotImplementedError, match=item):
            Applier(Options(simon_config=SMOKE, device="cpu", **kw))
    # --default-scheduler-config is parsed now (api/schedconfig.py): a file
    # that is no KubeSchedulerConfiguration is a ConfigError
    with pytest.raises(ConfigError, match="unsupported apiVersion"):
        Applier(Options(simon_config=SMOKE, device="cpu", default_scheduler_config=SMOKE))
    chart = tmp_path / "chart.yaml"
    chart.write_text(open(SMOKE).read().replace("path: examples/smoke/app",
                                                "path: examples/smoke/app\n      chart: true"))
    with pytest.raises(NotImplementedError, match="A7"):
        Applier(Options(simon_config=str(chart), device="cpu")).run()


def test_report_normalization_is_name_blind():
    a = ("Node Info\nsimon-abcde  1\nsimon-zzzzz  2\n\nApp Info\n"
         "app  3  simon-abcde(1), simon-zzzzz(2)\n")
    b = a.replace("abcde", "qqqqq")
    assert normalize_report(a) == normalize_report(b) != normalize_report(a.replace("(1)", "(5)"))


def test_cli_apply_on_the_cpu(tmp_path):
    out = tmp_path / "report.txt"
    proc = subprocess.run([sys.executable, "-m", "open_simulator_torch.cli", "apply", "-f",
                           SMOKE, "--device", "cpu", "--output-file", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Simulation success!" in out.read_text() and "App Info" in out.read_text()
    bad = subprocess.run([sys.executable, "-m", "open_simulator_torch.cli", "apply", "-f",
                          SMOKE, "--device", "cpu", "--default-scheduler-config", SMOKE],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1 and "scheduler config: unsupported apiVersion" in bad.stderr


def test_planner_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from open_simulator_torch.apply.applier import CapacityPlanner
    from open_simulator_torch.simulator.probe import ProbeSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    base, tpl = [make_node("b0")], make_node("tpl")
    pods = [make_pod("p0")]
    with pytest.raises(RuntimeError, match="CUDA"):
        ProbeSession.try_build(base, tpl, pods)
    with pytest.raises(RuntimeError, match="CUDA"):
        CapacityPlanner(base, tpl, pods).search()
    with pytest.raises(RuntimeError, match="CUDA"):
        Applier(Options(simon_config=SMOKE)).run()
    assert ProbeSession.try_build(base, tpl, pods, device="cpu").device.type == "cpu"
