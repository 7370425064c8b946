"""The port's `simon`-style CLI: `apply` on the PyTorch/CUDA Simulator.

    python -m open_simulator_torch.cli apply -f CONFIG [--output-file F]
        [--use-greed] [-i] [--extended-resources open-local,gpu]
        [--device cpu|cuda]

The flags are those of the reference's `simon apply` (cmd/apply/apply.go)
that the port runs; `--device` picks the Simulator's device (the card by
default). `--default-scheduler-config` is parsed and refused with the
ROADMAP item it waits for. The other subcommands of the JAX package's CLI
(server, sweep, lint, audit, ...) are not ported.
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
    return parser


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
    return {"apply": cmd_apply}[args.command](args)
