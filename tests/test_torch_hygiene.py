"""The PyTorch port stands alone: no JAX and nothing of open_simulator_tpu in
open_simulator_torch/ or chip_smoke.py, and no entry point runs on the CPU
unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "open_simulator_tpu")


def _port_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "open_simulator_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'open_simulator_tpu', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import open_simulator_torch, open_simulator_torch.ops.kernels, "
        "open_simulator_torch.ops.build, open_simulator_torch.utils.yamlio, "
        "open_simulator_torch.utils.synth\n"
        "from open_simulator_torch.utils.synth import synth_cluster\n"
        "nodes, pods = synth_cluster(4, 20, hard_predicates=True)\n"
        "sim = open_simulator_torch.Simulator(nodes, device='cpu')\n"
        "assert not sim.schedule_pods(pods)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    import open_simulator_torch
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, _ = synth_cluster(2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        open_simulator_torch.Simulator(nodes)
    with pytest.raises(RuntimeError, match="CUDA"):
        open_simulator_torch.simulate(ResourceTypes(nodes=nodes), [])
    assert open_simulator_torch.Simulator(nodes, device="cpu").device.type == "cpu"


def test_unsupported_batches_raise():
    import copy

    import open_simulator_torch
    from open_simulator_torch.utils.synth import synth_cluster
    from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator

    # mixed priorities no longer raise: the batch schedules as the JAX
    # package schedules it, the PostFilter armed
    nodes, pods = synth_cluster(2, 2)
    pods[1]["spec"]["priority"] = 100
    runs = []
    for sim in (open_simulator_torch.Simulator(nodes, device="cpu"),
                JaxSimulator(nodes, use_mesh=False)):
        batch = copy.deepcopy(pods)
        failed = sim.schedule_pods(batch)
        runs.append(([p["spec"].get("nodeName") for p in batch], [u.reason for u in failed],
                     sim._preempt_armed, len(sim.preempted)))
    assert runs[0] == runs[1] and runs[0][2]
    # GPU-share demand no longer raises: with no GPU node the pod fails with
    # the GPU filter's per-node reasons
    nodes, pods = synth_cluster(2, 1)
    pods[0]["metadata"]["annotations"] = {"alibabacloud.com/gpu-mem": "1Gi",
                                          "alibabacloud.com/gpu-count": "1"}
    failed = open_simulator_torch.Simulator(nodes, device="cpu").schedule_pods(pods)
    assert len(failed) == 1 and "1 Node:node-00000, 1 Node:node-00001" in failed[0].reason


def test_wrappers_refuse_other_devices():
    from open_simulator_torch.ops import kernels

    t = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels._on_cpu(t)


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result(tmp_path):
    # alone in a directory: nothing of the port to import
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(src).read())
    for cwd, script in ((REPO, src), (str(tmp_path), str(lone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
