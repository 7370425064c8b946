"""The port's `simon`-style CLI on the PyTorch/CUDA Simulator: `apply`,
`sweep`, `explain` and `metrics`.

    python -m open_simulator_torch.cli apply -f CONFIG [--output-file F]
        [--use-greed] [-i] [--extended-resources open-local,gpu]
        [--device cpu|cuda] [--xray] [--xray-out PREFIX]
        [--metrics-out FILE.json] [--trace-out FILE.json]
    python -m open_simulator_torch.cli sweep SPEC [--seed K] [--out FILE.json]
        [--json] [--parity full|sample|off] [--parity-sample N] [--fanout S]
        [--device cpu|cuda]
    python -m open_simulator_torch.cli explain [POD] [--trace PREFIX]
        [--unscheduled] [--json]
    python -m open_simulator_torch.cli metrics SNAPSHOT
    python -m open_simulator_torch.cli metrics --diff A B [--fail-on-regression]

`apply` takes the flags of the reference's `simon apply` (cmd/apply/apply.go)
that the port runs, plus the JAX package's observability flags: `--xray`
records the flight recorder's trace (PREFIX.jsonl + PREFIX.npz),
`--metrics-out` writes the metrics registry's snapshot and `--trace-out` a
Chrome trace of the run's spans; `--default-scheduler-config` is parsed and
refused with the ROADMAP item it waits for. `sweep` takes the JAX package's
`simon sweep` flags. `--device` picks the device (the card by default).
`explain` and `metrics` read files only and need no device; they read the
JAX package's traces and snapshots too. The other subcommands of the JAX
package's CLI (server, lint, audit, ...) are not ported.

`sweep` and `apply` run under torchrun, one rank per card:

    torchrun --nproc_per_node N -m open_simulator_torch.cli sweep SPEC --out R.json

With WORLD_SIZE > 1 each rank joins the process group (NCCL where every
rank has a card, gloo otherwise; parallel/distributed.py), the sweep's
image, the planner's probe session and the engine take their meshes over
the ranks, every rank computes the same result, and rank 0 alone prints
and writes the output files (the report's bytes equal the one-process
run's). A rank that fails fails the run: the others fail at their next
collective, within the process group's timeout.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional, Tuple

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
    p_apply.add_argument("--trace-out", default="", metavar="FILE.json",
                         help="write a Chrome trace-event JSON of the run's host spans "
                              "(perfetto-loadable; includes the metrics snapshot as metadata)")
    p_apply.add_argument("--metrics-out", default="", metavar="FILE.json",
                         help="write the metrics-registry snapshot of the run as JSON "
                              "(render later with `metrics FILE.json`)")
    p_apply.add_argument("--xray", action="store_true",
                         help="record per-pod scheduling decision records (simonxray flight "
                              "recorder): segment attribution, per-plugin filter masks and "
                              "score breakdowns. Query afterwards with `explain POD`.")
    p_apply.add_argument("--xray-out", default="simon-xray", metavar="PREFIX",
                         help="trace file prefix for --xray (writes PREFIX.jsonl + "
                              "PREFIX.npz; default: simon-xray)")

    p_metrics = sub.add_parser(
        "metrics", help="Render a saved metrics snapshot (--metrics-out / --trace-out file) "
                        "as Prometheus text, or diff two snapshots with --diff")
    p_metrics.add_argument("snapshot", nargs="+",
                           help="snapshot or trace JSON file (two files with --diff)")
    p_metrics.add_argument("--diff", action="store_true",
                           help="render per-metric deltas between TWO dumps (A B: changes "
                                "from A to B), flagging counter regressions — shape-signature "
                                "misses, rollbacks and friends that grew, and counters that "
                                "went backwards (different-process baselines)")
    p_metrics.add_argument("--fail-on-regression", action="store_true",
                           help="with --diff: exit 1 when any regression-direction counter "
                                "grew")

    p_explain = sub.add_parser(
        "explain", help="Explain one pod's scheduling decision from a simonxray trace "
                        "(apply --xray): the kube-parity event string, per-plugin filter "
                        "rejections, and the score breakdown vs the runner-up nodes")
    p_explain.add_argument("pod", nargs="?", default="",
                           help="pod to explain ('namespace/name', or a bare name when "
                                "unambiguous)")
    p_explain.add_argument("--trace", default="simon-xray", metavar="PREFIX",
                           help="xray trace prefix or .jsonl path (default: simon-xray)")
    p_explain.add_argument("--unscheduled", action="store_true",
                           help="list every unscheduled pod in the trace with its reason "
                                "string instead of explaining one pod")
    p_explain.add_argument("--json", action="store_true",
                           help="emit the raw decision record as JSON")

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
    if args.rank:
        return 0  # every rank built the same report: rank 0 writes and prints it
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
    if args.xray:
        from ..obs import xray

        xray.enable(args.xray_out or "simon-xray")
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
        if args.trace_out:
            from ..utils.trace import start_collection

            start_collection()
        try:
            applier.run()
        finally:
            # the dumps are written for failed runs too (a raising run
            # records failed=True spans), and collection always stops
            if args.trace_out or args.metrics_out:
                from ..obs import REGISTRY

                if args.trace_out:
                    from ..obs.chrome import write_chrome_trace
                    from ..utils.trace import stop_collection

                    write_chrome_trace(args.trace_out, stop_collection(),
                                       metrics=REGISTRY.snapshot())
                if args.metrics_out:
                    with open(args.metrics_out, "w") as f:
                        json.dump(REGISTRY.snapshot(), f, indent=1)
                        f.write("\n")
    except Exception as e:  # `apply error: ...` + exit 1 (cmd/apply/apply.go:17-24)
        print(f"apply error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.xray:
            # closed on failed runs too: the partial trace is the evidence
            from ..obs import xray

            rec = xray.active()
            counts = rec.counts() if rec is not None else {}
            xray.disable()
            if counts.get("batches"):  # the JSONL opens on the first committed batch
                print(f"xray: {counts.get('pods', 0)} decision records "
                      f"({counts.get('unscheduled', 0)} unscheduled, {counts.get('sets', 0)} "
                      f"decision sets) -> {counts.get('path')}.jsonl; query with "
                      f"`explain POD --trace {counts.get('path')}`", file=sys.stderr)
    return 0


def _load_metrics_snapshot(path: str) -> dict:
    """A registry snapshot from a --metrics-out dump or the metadata of a
    --trace-out Chrome trace. Raises ValueError on anything else."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        doc = (doc.get("metadata") or {}).get("metrics")
        if not doc:
            raise ValueError(f"{path}: trace file carries no metrics snapshot")
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a metrics snapshot")
    return doc


# Counter families whose GROWTH between two runs is a regression signal (the
# JAX package's list: everything here counts failures, rework or compile
# churn, never useful work; families the port does not emit stay listed so
# that a JAX dump diffs the same).
_BAD_WHEN_UP = (
    "simon_compile_cache_misses_total",
    "simon_xla_backend_compiles_total",
    "simon_commit_rollbacks_total",
    "simon_http_errors_total",
    "simon_retries_total",
    "simon_deadline_exceeded_total",
    "simon_faults_injected_total",
    "simon_guard_watchdog_expiries_total",
    "simon_guard_oom_bisections_total",
    "simon_guard_failovers_total",
    "simon_preemption_replay_pods_total",
    "simon_xray_dropped_total",
    "simon_serve_stale_sessions_total",
    "simon_sweep_parity_mismatches_total",
    "simon_scope_trace_dropped_total",
    "simon_scope_sampler_errors_total",
    "simon_pulse_regressions_total",
    "simon_pulse_records_dropped_total",
    "simon_serve_wrong_epoch_answers_total",
    "simon_serve_wal_parity_mismatches_total",
    "simon_sync_parity_mismatches_total",
    "simon_sync_full_rebuilds_total",
)


def _diff_metrics(snap_a: dict, snap_b: dict, out) -> Tuple[int, int]:
    """Render per-metric deltas A -> B; returns (changed, regressions)."""
    from ..obs import values_from_snapshot

    va, vb = values_from_snapshot(snap_a), values_from_snapshot(snap_b)
    fam_type: dict = {}
    for snap in (snap_a, snap_b):
        for name, fam in snap.items():
            fam_type[name] = fam.get("type", "untyped")
    # longest-match family lookup: flat keys are name{labels} (+_sum/_count)
    fams = sorted(fam_type, key=len, reverse=True)
    changed = regressions = backwards = 0

    def fmt(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else f"{v:.6g}"

    for key in sorted(set(va) | set(vb)):
        a, b = va.get(key, 0.0), vb.get(key, 0.0)
        if a == b:
            continue
        changed += 1
        fam = next((n for n in fams if key.startswith(n)), "")
        delta = b - a
        flags = []
        if fam_type.get(fam) == "counter":
            if delta < 0:
                backwards += 1
                flags.append("counter went backwards (different baseline?)")
            elif any(fam.startswith(p) for p in _BAD_WHEN_UP):
                regressions += 1
                flags.append("REGRESSION")
        sign = "+" if delta >= 0 else ""
        print(f"{key}  {fmt(a)} -> {fmt(b)}  ({sign}{fmt(delta)})"
              + (f"  [{'; '.join(flags)}]" if flags else ""), file=out)
    print(f"# {changed} metric(s) changed, {regressions} regression(s), "
          f"{backwards} counter(s) went backwards", file=out)
    return changed, regressions


def cmd_metrics(args) -> int:
    """Render a saved registry snapshot (apply --metrics-out, or the metadata
    of a --trace-out Chrome trace) as Prometheus text on stdout, or, with
    --diff A B, the per-metric deltas between two dumps."""
    from ..obs import render_text_from_snapshot

    try:
        if args.diff:
            if len(args.snapshot) != 2:
                print("metrics error: --diff needs exactly two snapshot files (A B)",
                      file=sys.stderr)
                return 1
            _, regressions = _diff_metrics(_load_metrics_snapshot(args.snapshot[0]),
                                           _load_metrics_snapshot(args.snapshot[1]), sys.stdout)
            return 1 if regressions and args.fail_on_regression else 0
        if len(args.snapshot) != 1:
            print("metrics error: one snapshot file expected (use --diff for two)",
                  file=sys.stderr)
            return 1
        doc = _load_metrics_snapshot(args.snapshot[0])
    except (OSError, ValueError) as e:
        print(f"metrics error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(render_text_from_snapshot(doc))
    return 0


def cmd_explain(args) -> int:
    """Explain one pod's scheduling decision from a simonxray trace: the
    kube-scheduler-parity event line, per-plugin filter rejections, and the
    chosen-node score breakdown vs the runner-ups."""
    from ..obs import xray

    if not args.pod and not args.unscheduled:
        print("explain error: name a pod ('namespace/name') or pass --unscheduled",
              file=sys.stderr)
        return 1
    try:
        tr = xray.XrayTrace.load(args.trace)
    except (OSError, ValueError) as e:
        print(f"explain error: {e}", file=sys.stderr)
        return 1
    if args.unscheduled:
        rows = tr.unscheduled_summary()
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            for r in rows:
                print(f"{r['pod']}: {r['reason']}")
            print(f"# {len(rows)} unscheduled pod(s)")
        return 0
    exp = tr.explain(args.pod)
    if exp is None:
        print(f"explain error: no decision record for pod {args.pod!r} in {args.trace} (run "
              "with --xray, and use 'namespace/name' when the bare name is ambiguous)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(exp, indent=1, default=str))
    else:
        print(xray.render_explanation(exp))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    level = _LOG_LEVELS.get(os.environ.get(C.EnvLogLevel, ""), logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    parser = build_parser()
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    if not args.command:
        parser.print_help()
        return 0
    cmd = {"apply": cmd_apply, "sweep": cmd_sweep, "explain": cmd_explain,
           "metrics": cmd_metrics}[args.command]
    if args.command not in ("sweep", "apply"):
        return cmd(args)
    joined = _join_ranks(args)
    try:
        if not args.rank:
            return cmd(args)
        # every rank computes the same result; rank 0 alone prints and writes
        if args.command == "apply":
            args.output_file = args.trace_out = args.metrics_out = ""
            args.xray = False
        import contextlib

        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return cmd(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_ranks(args) -> bool:
    """Under torchrun (WORLD_SIZE > 1) join the process group on the
    command's device; set args.rank (0 without a group). Returns whether
    this call formed the group (and so ends it)."""
    import torch.distributed as dist

    joined = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        from ..parallel.distributed import initialize

        joined = initialize(device=args.device)
    args.rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return joined
