"""CLI for the trace-calibration loop (the port of
``repro.calibration.cli``, with one more option: ``record --device``,
``cuda`` by default, ``cpu`` for the host).

    python -m repro_torch.calibration record paper-fig4 --out trace.json
    python -m repro_torch.calibration fit trace.json --out cal.json --holdout 1
    python -m repro_torch.calibration replay trace.json --calibration cal.json
    python -m repro_torch.calibration report trace.json --calibration cal.json
    python -m repro_torch.calibration validate trace.json
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.calibration.fit import (
    ANALYTIC,
    fit_calibration,
    load_calibration,
)
from repro_torch.calibration.replay import format_report, replay
from repro_torch.calibration.trace import (
    TraceArtifact,
    record_trace,
    validate_trace_dict,
)


def _parse_rounds(text: Optional[str]) -> Optional[List[int]]:
    if text is None:
        return None
    return [int(tok) for tok in text.split(",") if tok.strip()]


def cmd_record(args) -> int:
    from repro_torch.experiments.scenarios import get_scenario
    spec = get_scenario(args.scenario)
    overrides = {}
    for pair in args.set or ():
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        overrides[k.strip()] = v.strip()
    if overrides:
        try:
            spec = spec.with_overrides(**overrides)
        except TypeError as e:
            raise SystemExit(str(e)) from e
    trace = record_trace(spec, args.strategy, seed=args.seed,
                         rounds=args.rounds, verbose=args.verbose,
                         device=args.device)
    path = trace.save(args.out)
    print(f"recorded {trace.rounds} rounds of "
          f"{trace.scenario.get('name')}/{trace.strategy} seed={trace.seed}"
          f" device={args.device} -> {path}")
    return 0


def cmd_fit(args) -> int:
    trace = TraceArtifact.load(args.trace)
    cal = fit_calibration(trace, holdout_rounds=args.holdout)
    path = cal.save(args.out)
    link = ", ".join(f"{b:.6g}" for b in cal.level_link)
    print(f"fit {cal.n_rows} rows: payload_scale={cal.payload_scale:.6g} "
          f"level_link=[{link}] train_scale={cal.train_scale:.6g} "
          f"rms_residual={cal.rms_residual:.3g} -> {path}")
    return 0


def cmd_replay(args) -> int:
    trace = TraceArtifact.load(args.trace)
    cal = (load_calibration(args.calibration)
           if args.calibration else ANALYTIC)
    tag = args.calibration or "analytic"
    report = replay(trace, cal, rounds=_parse_rounds(args.rounds))
    print(format_report(tag, report))
    if args.out:
        path = report.save(args.out)
        print(f"wrote {path}")
    return 0


def cmd_report(args) -> int:
    """Side-by-side: fitted calibration vs the analytic baseline."""
    trace = TraceArtifact.load(args.trace)
    rounds = _parse_rounds(args.rounds)
    cal = (load_calibration(args.calibration) if args.calibration
           else fit_calibration(trace, holdout_rounds=args.holdout))
    fitted = replay(trace, cal, rounds=rounds)
    analytic = replay(trace, ANALYTIC, rounds=rounds)
    print(format_report("calibrated", fitted))
    print(format_report("analytic", analytic))
    better = fitted.mean_abs_error < analytic.mean_abs_error
    print(f"calibrated mean|err|={fitted.mean_abs_error:.6g} vs "
          f"analytic {analytic.mean_abs_error:.6g} -> "
          f"{'calibrated wins' if better else 'analytic wins'}")
    return 0


def cmd_validate(args) -> int:
    d = json.loads(Path(args.trace).read_text())
    errors = validate_trace_dict(d)
    if errors:
        for e in errors:
            print(f"INVALID: {e}")
        return 1
    print(f"{args.trace}: valid {d['schema']} v{d['schema_version']} "
          f"({d['rounds']} rounds)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.calibration",
        description="record / fit / replay trace-calibrated cost models")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("record", help="record a timing trace")
    p.add_argument("scenario")
    p.add_argument("--strategy", default="pso")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override a ScenarioSpec field (repeatable), "
                        "e.g. --set model=mlp-smoke")
    p.add_argument("--out", required=True)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the recorded run executes: cuda "
                        "(default; raises without a card) or cpu")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("fit", help="fit CostModel parameters from a trace")
    p.add_argument("trace")
    p.add_argument("--out", required=True)
    p.add_argument("--holdout", type=int, default=0,
                   help="reserve the trace's last N rounds (no fit rows)")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("replay",
                       help="score a calibration against a trace")
    p.add_argument("trace")
    p.add_argument("--calibration", default=None,
                   help="fitted-calibration JSON (default: analytic)")
    p.add_argument("--rounds", default=None,
                   help="comma-separated round indices (default: all)")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("report",
                       help="calibrated-vs-analytic error comparison")
    p.add_argument("trace")
    p.add_argument("--calibration", default=None,
                   help="fitted JSON (default: fit the trace now)")
    p.add_argument("--holdout", type=int, default=0)
    p.add_argument("--rounds", default=None)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("validate", help="schema-check a trace artifact")
    p.add_argument("trace")
    p.set_defaults(fn=cmd_validate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
