"""--default-scheduler-config in the port (open_simulator_torch/api/schedconfig.py
and the Simulator, planner and Applier wiring) against the JAX package's.

The 10 tests of tests/test_schedconfig.py, each on both packages: the
port's `parse_scheduler_config` gives the JAX parser's SchedulerConfig (the
same fields, the same ConfigError on every unsupported input); the port's
Simulator(device="cpu") under a parsed config places and fails every pod
as the JAX Simulator does; the port's Applier runs a config file to the
JAX Applier's report and refuses a bad one with ConfigError; and the
resident image takes a config (it refused one before).
"""

import copy
import dataclasses
import io
import os

import pytest

from fixtures import make_node, make_pod
from open_simulator_torch.api import schedconfig as TS
from open_simulator_torch.api.v1alpha1 import ConfigError as TorchConfigError
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_tpu.api import schedconfig as JS
from open_simulator_tpu.api.v1alpha1 import ConfigError as JaxConfigError
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from test_schedconfig import HEADER, write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both_parse(path):
    """The two packages' SchedulerConfig of one file, as equal dicts."""
    j, t = JS.parse_scheduler_config(path), TS.parse_scheduler_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.weight_kwargs() == j.weight_kwargs()
    return t, j


def test_parse_empty_and_default(tmp_path):
    t, _ = both_parse(write(tmp_path, HEADER))
    assert t == TS.DEFAULT_SCHEDULER_CONFIG
    assert dataclasses.asdict(TS.DEFAULT_SCHEDULER_CONFIG) == dataclasses.asdict(
        JS.DEFAULT_SCHEDULER_CONFIG)
    assert t.score_weights["PodTopologySpread"] == 2.0


def test_parse_weights_and_disables(tmp_path):
    t, _ = both_parse(write(tmp_path, HEADER + """
profiles:
  - schedulerName: default-scheduler
    plugins:
      score:
        enabled:
          - name: Simon
            weight: 5
          - name: ImageLocality   # weight 0 -> framework zero->1 rule
        disabled:
          - name: TaintToleration
      filter:
        disabled:
          - name: NodePorts
          - name: TaintToleration
"""))
    assert t.score_weights["Simon"] == 5.0 and t.score_weights["TaintToleration"] == 0.0
    assert t.disabled_kernel_filters == frozenset({"NodePorts"})
    assert t.disabled_encoder_filters == frozenset({"TaintToleration"})


def test_parse_wildcard_disable(tmp_path):
    t, _ = both_parse(write(tmp_path, HEADER + """
profiles:
  - plugins:
      score:
        disabled:
          - name: "*"
        enabled:
          - name: Simon
            weight: 3
"""))
    assert t.score_weights["Simon"] == 3.0
    assert all(w == 0.0 for k, w in t.score_weights.items() if k != "Simon")


@pytest.mark.parametrize("body,msg", [
    ("percentageOfNodesToScore: 50\n", "percentageOfNodesToScore"),
    ("extenders:\n  - urlPrefix: http://x\n", "extenders"),
    ("profiles:\n  - schedulerName: other\n", "schedulerName"),
    ("profiles:\n  - plugins:\n      score:\n        enabled:\n          - name: NoSuchPlugin\n",
     "NoSuchPlugin"),
    ("profiles:\n  - pluginConfig:\n      - name: Simon\n", "pluginConfig"),
    ("profiles:\n  - plugins:\n      preFilter:\n        disabled:\n          - name: NodePorts\n",
     "preFilter"),
    ("someUnknownField: 3\n", "someUnknownField"),
])
def test_parse_rejects_unsupported_loudly(tmp_path, body, msg):
    path = write(tmp_path, HEADER + body)
    with pytest.raises(JaxConfigError) as j:
        JS.parse_scheduler_config(path)
    with pytest.raises(TorchConfigError) as t:
        TS.parse_scheduler_config(path)
    assert msg in str(t.value) and str(t.value) == str(j.value)


def test_volume_plugins_accepted_as_inert(tmp_path):
    t, _ = both_parse(write(tmp_path, HEADER + """
profiles:
  - plugins:
      filter:
        disabled:
          - name: VolumeBinding
          - name: VolumeZone
"""))
    assert t.disabled_kernel_filters == frozenset() == t.disabled_encoder_filters


# ------------------------------------------------------------ engine effects ----


def _sched(nodes, pods, cfg_t=None, cfg_j=None, use_waves=True):
    """(placements, failure reasons) of the port, held equal to JAX's."""
    out = []
    for sim in (TorchSimulator(copy.deepcopy(nodes), device="cpu", sched_config=cfg_t),
                JaxSimulator(copy.deepcopy(nodes), use_mesh=False, sched_config=cfg_j)):
        sim.use_waves = use_waves
        failed = sim.schedule_pods(copy.deepcopy(pods))
        placements = {p["metadata"]["name"]: i
                      for i, nodepods in enumerate(sim.pods_on_node) for p in nodepods}
        out.append((placements, [u.reason for u in failed]))
    assert out[0] == out[1]
    return out[0]


def _parsed(tmp_path, text):
    path = write(tmp_path, HEADER + text)
    return TS.parse_scheduler_config(path), JS.parse_scheduler_config(path)


def test_score_weights_change_placement(tmp_path):
    nodes = [make_node("roomy", cpu="32", memory="64Gi"),
             make_node("snug", cpu="8", memory="16Gi")]
    seed = [make_pod("seed", cpu="2", memory="4Gi", node_name="snug")]
    pod = [make_pod("probe", cpu="2", memory="4Gi")]
    assert _sched(nodes, seed + pod)[0]["probe"] == 1
    boosted = _parsed(tmp_path, """
profiles:
  - plugins:
      score:
        enabled:
          - name: NodeResourcesLeastAllocated
            weight: 10
""")
    assert _sched(nodes, seed + pod, *boosted)[0]["probe"] == 0
    no_simon = _parsed(tmp_path, """
profiles:
  - plugins:
      score:
        disabled:
          - name: Simon
          - name: Open-Gpu-Share
""")
    assert _sched(nodes, seed + pod, *no_simon)[0]["probe"] == 0


def _configs(**kw):
    return TS.SchedulerConfig(**kw), JS.SchedulerConfig(**kw)


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
def test_filter_disable_taints(use_waves):
    nodes = [make_node("tainted", taints=[{
        "key": "dedicated", "value": "x", "effect": "NoSchedule"}])]
    pods = [make_pod("p0", cpu="1", memory="1Gi")]
    assert len(_sched(nodes, pods, use_waves=use_waves)[1]) == 1
    cfg = _configs(disabled_encoder_filters=frozenset({"TaintToleration"}))
    placements, failed = _sched(nodes, pods, *cfg, use_waves=use_waves)
    assert not failed and placements["p0"] == 0


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
def test_filter_disable_ports(use_waves):
    nodes = [make_node("n0")]
    pods = [make_pod(f"p{i}", cpu="100m", memory="128Mi", host_ports=[8080])
            for i in range(10)]
    assert len(_sched(nodes, pods, use_waves=use_waves)[1]) == 9
    cfg = _configs(disabled_kernel_filters=frozenset({"NodePorts"}))
    assert not _sched(nodes, pods, *cfg, use_waves=use_waves)[1]


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
def test_filter_disable_spread(use_waves):
    nodes = [make_node(f"n{i}", labels={"zone": "a" if i < 2 else "b"}) for i in range(3)]
    pods = []
    for i in range(8):
        p = make_pod(f"s{i}", cpu="100m", memory="128Mi", labels={"app": "s"})
        p["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "s"}}}]
        pods.append(p)
    nodes[2]["status"]["allocatable"]["cpu"] = "200m"
    nodes[2]["status"]["capacity"]["cpu"] = "200m"
    assert _sched(nodes, pods, use_waves=use_waves)[1]
    cfg = _configs(disabled_kernel_filters=frozenset({"PodTopologySpread"}))
    assert not _sched(nodes, pods, *cfg, use_waves=use_waves)[1]


def test_applier_accepts_scheduler_config_file(tmp_path, monkeypatch):
    from open_simulator_torch.apply.applier import Applier as TorchApplier
    from open_simulator_torch.apply.applier import Options as TorchOptions
    from open_simulator_torch.parity import normalize_report
    from open_simulator_tpu.apply.applier import Applier as JaxApplier
    from open_simulator_tpu.apply.applier import Options as JaxOptions

    monkeypatch.chdir(REPO)
    sched = write(tmp_path, HEADER + """
profiles:
  - plugins:
      score:
        enabled:
          - name: Simon
            weight: 2
""")
    reports = []
    for A, O, kw in ((JaxApplier, JaxOptions, {}), (TorchApplier, TorchOptions, {"device": "cpu"})):
        ap = A(O(simon_config="examples/simon-smoke-config.yaml",
                 default_scheduler_config=sched, **kw))
        ap.out = io.StringIO()
        assert ap.run() is not None
        reports.append(normalize_report(ap.out.getvalue()))
    assert reports[1] == reports[0] and reports[1].startswith("Simulation success!")
    bad = write(tmp_path, HEADER + "extenders:\n  - urlPrefix: http://x\n")
    with pytest.raises(TorchConfigError):
        TorchApplier(TorchOptions(simon_config="examples/simon-smoke-config.yaml",
                                  default_scheduler_config=bad, device="cpu"))


def test_resident_image_takes_the_config():
    """ResidentImage.try_build(sched_config=) (refused before): a what-if
    session and the fresh-probe oracle under a config that disables the
    TaintToleration filter answer as the JAX image does."""
    from open_simulator_torch.serve.image import ResidentImage as TorchImage
    from open_simulator_tpu.serve.image import ResidentImage as JaxImage

    nodes = [make_node(f"n{i}", cpu="2", taints=[{"key": "k", "value": "v",
                                                  "effect": "NoSchedule"}] if i % 2 else None)
             for i in range(4)]
    pods = [make_pod(f"p{i}", cpu="900m", memory="128Mi") for i in range(6)]
    cfgs = _configs(disabled_encoder_filters=frozenset({"TaintToleration"}))
    got = []
    for make, cfg, kw in ((TorchImage.try_build, cfgs[0], {"device": "cpu"}),
                          (JaxImage.try_build, cfgs[1], {})):
        img = make(copy.deepcopy(nodes), sched_config=cfg, **kw)
        got.append((img.session(copy.deepcopy(pods), []).run(),
                    img.fresh_probe(copy.deepcopy(pods))))
    assert got[0] == got[1]
    assert got[0][1]["scheduled"] == 6  # the tainted nodes take pods too
