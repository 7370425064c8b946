"""The port's `simon`-style CLI: `apply` and `sweep` on the PyTorch/CUDA Simulator.

    python -m open_simulator_torch.cli apply -f CONFIG [--output-file F]
        [--use-greed] [-i] [--extended-resources open-local,gpu]
        [--device cpu|cuda]
    python -m open_simulator_torch.cli sweep SPEC [--seed K] [--out FILE.json]
        [--json] [--parity full|sample|off] [--parity-sample N] [--fanout S]
        [--device cpu|cuda]

`apply` takes the flags of the reference's `simon apply` (cmd/apply/apply.go)
that the port runs; `--default-scheduler-config` is parsed and refused with
the ROADMAP item it waits for. `sweep` takes the JAX package's `simon sweep`
flags. `--device` picks the device (the card by default). The other
subcommands of the JAX package's CLI (server, lint, audit, ...) are not
ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from ..core import constants as C

_LOG_LEVELS = {
    "Panic": logging.CRITICAL,
    "Fatal": logging.CRITICAL,
    "Error": logging.ERROR,
    "Warn": logging.WARNING,
    "Info": logging.INFO,
    "Debug": logging.DEBUG,
    "Trace": logging.DEBUG,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simon",
        description=("Simon is a simulator, which will simulate a cluster and simulate "
                     "workload scheduling (PyTorch/CUDA port)."))
    sub = parser.add_subparsers(dest="command", metavar="command")
    p_apply = sub.add_parser(
        "apply", help="Make a reasonable cluster capacity planning based on application "
                      "resource requirements")
    p_apply.add_argument("-f", "--simon-config", required=True,
                         help="path of the simon config file (simon/v1alpha1 Config)")
    p_apply.add_argument("--default-scheduler-config", default="",
                         help="path to JSON or YAML file containing scheduler configuration "
                              "(not ported yet: refused)")
    p_apply.add_argument("--output-file", default="", help="save report to output file.")
    p_apply.add_argument("--use-greed", action="store_true",
                         help="use greedy algorithm when queue pods")
    p_apply.add_argument("-i", "--interactive", action="store_true", help="interactive mode")
    p_apply.add_argument("--extended-resources", default="",
                         help="show extended resources when reporting, comma-separated "
                              "(e.g. open-local,gpu)")
    p_apply.add_argument("--device", default=None, choices=("cuda", "cpu"),
                         help="device of the simulation (default: cuda; cpu runs the plain "
                              "PyTorch versions of the kernels)")

    p_sweep = sub.add_parser(
        "sweep", help="Run a batched scenario sweep: N independent what-if futures "
                      "(drains, zone outages, preemption storms, rollout waves, nodepool "
                      "mixes, Monte-Carlo workload draws) evaluated as lanes of a few "
                      "fan-out dispatches, every lane parity-checked against a fresh "
                      "serial run")
    p_sweep.add_argument("spec", help="sweep spec file (YAML/JSON, kind: SweepSpec; see "
                                      "examples/sweeps/)")
    p_sweep.add_argument("--seed", type=int, default=None, metavar="K",
                         help="override the spec's seed: every random draw derives from it, "
                              "so the same seed gives byte-identical report JSON")
    p_sweep.add_argument("--out", default="", metavar="FILE.json",
                         help="write the full report as deterministic JSON")
    p_sweep.add_argument("--json", action="store_true",
                         help="print the report JSON on stdout instead of the summary table")
    p_sweep.add_argument("--parity", choices=("full", "sample", "off"), default="full",
                         help="batched==serial placement-census check: re-run every batched "
                              "lane ('full', default), a seeded sample, or skip ('off'); any "
                              "mismatch exits nonzero")
    p_sweep.add_argument("--parity-sample", type=int, default=8, metavar="N",
                         help="lanes re-run serially under --parity sample (default 8)")
    p_sweep.add_argument("--fanout", type=int, default=64, metavar="S",
                         help="max scenario lanes per batched dispatch (default 64)")
    p_sweep.add_argument("--device", default=None, choices=("cuda", "cpu"),
                         help="device of the sweep (default: cuda; cpu runs the plain PyTorch "
                              "versions of the kernels)")
    return parser


def cmd_sweep(args) -> int:
    """`sweep`: batched scenario sweeps over one resident cluster image, with
    the batched==serial parity check on by default. The wall time goes to
    stderr only: the report bytes derive from (spec, seed, results)."""
    import time

    from ..sweep import (SweepParityError, SweepRunner, SweepSpecError, build_report,
                         load_spec, render_report, report_json)

    try:
        spec = load_spec(args.spec)
    except SweepSpecError as e:
        print(f"sweep error: {e}", file=sys.stderr)
        return 1
    runner = SweepRunner(spec, seed=args.seed, parity=args.parity,
                         parity_sample=args.parity_sample, fanout=args.fanout,
                         device=args.device)
    t0 = time.perf_counter()
    try:
        runner.run()
    except SweepParityError as e:
        print(f"sweep PARITY FAILURE: {e}", file=sys.stderr)
        return 1
    except SweepSpecError as e:
        print(f"sweep error: {e}", file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0
    report = build_report(runner)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(report_json(report))
    if args.json:
        sys.stdout.write(report_json(report))
    else:
        print(render_report(report))
    print(f"sweep: {len(report['scenarios'])} scenarios in {wall:.2f}s "
          f"({len(report['scenarios']) / wall:.1f} scenarios/s; batched "
          f"{runner.seconds['batched']:.3f}s, parity {runner.seconds['parity']:.3f}s)"
          + (f" -> {args.out}" if args.out else ""), file=sys.stderr)
    return 0


def cmd_apply(args) -> int:
    from ..apply.applier import Applier, Options

    ext = [e.strip() for e in (args.extended_resources or "").split(",") if e.strip()]
    try:
        applier = Applier(Options(
            simon_config=args.simon_config,
            default_scheduler_config=args.default_scheduler_config,
            use_greed=args.use_greed,
            interactive=args.interactive,
            extended_resources=ext,
            output_file=args.output_file,
            device=args.device,
        ))
        applier.run()
    except Exception as e:  # `apply error: ...` + exit 1 (cmd/apply/apply.go:17-24)
        print(f"apply error: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    level = _LOG_LEVELS.get(os.environ.get(C.EnvLogLevel, ""), logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    parser = build_parser()
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    if not args.command:
        parser.print_help()
        return 0
    return {"apply": cmd_apply, "sweep": cmd_sweep}[args.command](args)
