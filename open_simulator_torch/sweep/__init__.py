"""simonsweep: batched scenario sweeps on one device.

Port of `open_simulator_tpu/sweep/`: a sweep spec (spec.py) compiles
scenario families (families.py) into copy-on-write overlays on one shared
device-resident cluster image; the runner (runner.py) batches them onto the
sweep fan-outs (`kernels.sweep_wave_fanout`, `kernels.sweep_whatif_fanout`),
and every batched lane doubles as a parity case against a fresh serial
Simulator run.

    from open_simulator_torch.sweep import SweepRunner, load_spec, build_report
    runner = SweepRunner(load_spec("examples/sweeps/zone-outage.yaml"))
    results = runner.run()            # raises on any parity mismatch
    report = build_report(runner)     # deterministic JSON-able dict
"""

from .families import Scenario, build_base, compile_families
from .report import build_report, render_report, report_json
from .runner import ScenarioResult, SweepParityError, SweepRunner
from .spec import SweepSpec, SweepSpecError, load_spec, parse_spec

__all__ = [
    "Scenario", "ScenarioResult", "SweepParityError", "SweepRunner",
    "SweepSpec", "SweepSpecError", "build_base", "build_report",
    "compile_families", "load_spec", "parse_spec", "render_report",
    "report_json",
]
