"""Command-line front end:  PYTHONPATH=src python -m repro_torch.experiments ...

The port of ``repro.experiments.cli``, with one more option: ``run
--device`` (``cuda`` by default, ``cpu`` for the host). Subcommands::

    list                        registered scenarios + strategies
    run SCENARIO                sweep strategies x seeds, write artifact
        --strategies pso,random --rounds 25 --seeds 0,17
        --set depth=4 --set width=5        (ScenarioSpec overrides)
        --env emulated                     (run on the other track, e.g.
                                            elastic presets on Fig. 4)
        --out artifacts/experiments/foo.json
        --device cuda|cpu                  (where the run executes)
    validate PATH [PATH ...]    schema-check existing artifacts

Exit status is non-zero on schema-invalid artifacts, so CI can use
``run`` + ``validate`` directly as a smoke gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core.registry import list_strategies
from repro_torch.experiments.eval_config import EvalConfig
from repro_torch.experiments.results import ExperimentResult, validate_result_dict
from repro_torch.experiments.runner import aggregate_line, run_experiment
from repro_torch.experiments.scenarios import get_scenario, list_scenarios

DEFAULT_OUT_DIR = Path("artifacts") / "experiments"


def _parse_set(pairs):
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def cmd_list(args) -> int:
    print("scenarios:")
    for spec in list_scenarios():
        events = ",".join(type(e).__name__ for e in spec.events) or "-"
        print(f"  {spec.name:12s} [{spec.kind:9s}] rounds={spec.rounds:<4d} "
              f"events={events}")
        print(f"               {spec.description}")
    print("\nstrategies:")
    for info in list_strategies():
        aliases = f" (aliases: {', '.join(info.aliases)})" \
            if info.aliases else ""
        fields = ", ".join(info.config_fields) or "-"
        print(f"  {info.name:12s} {info.description}{aliases}")
        print(f"               config: {fields}")
    return 0


def cmd_run(args) -> int:
    spec = get_scenario(args.scenario)
    if getattr(args, "env", None):
        spec = spec.for_env(args.env)
    overrides = _parse_set(args.set)
    # nested overrides: --set eval.backend=np targets EvalConfig,
    # everything else targets the ScenarioSpec
    eval_overrides = {k[len("eval."):]: v for k, v in overrides.items()
                      if k.startswith("eval.")}
    overrides = {k: v for k, v in overrides.items()
                 if not k.startswith("eval.")}
    try:
        eval_config = EvalConfig().with_overrides(**eval_overrides)
    except (TypeError, ValueError) as e:
        raise SystemExit(str(e)) from e
    if args.mode is not None:
        print("note: --mode is deprecated; use --set eval.mode=...")
        if "mode" in eval_overrides and eval_overrides["mode"] != args.mode:
            raise SystemExit(
                f"conflicting modes: --mode {args.mode} vs "
                f"--set eval.mode={eval_overrides['mode']}")
        eval_config = eval_config.with_overrides(mode=args.mode)
    if overrides:
        try:
            spec = spec.with_overrides(**overrides)
        except TypeError as e:
            raise SystemExit(str(e)) from e
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    strategies = [s for s in args.strategies.split(",") if s]
    rounds = args.rounds if args.rounds is not None else spec.rounds

    print(f"== experiment {spec.name} [{spec.kind}] rounds={rounds} "
          f"seeds={seeds} strategies={strategies} "
          f"mode={eval_config.mode} device={args.device} ==")
    result = run_experiment(spec, strategies, rounds=rounds, seeds=seeds,
                            verbose=args.verbose, eval_config=eval_config,
                            device=args.device)

    # --env runs get a kind-suffixed default filename, so driving the
    # same preset on both tracks never silently clobbers one artifact
    # with the other
    default_name = f"{spec.name}_{spec.kind}.json" \
        if getattr(args, "env", None) else f"{spec.name}.json"
    out = Path(args.out) if args.out else DEFAULT_OUT_DIR / default_name
    result.save(out)
    print(f"-> wrote {out} (schema v{result.stamped_schema_version()}, "
          f"{len(result.runs)} runs)")
    return 0


def cmd_validate(args) -> int:
    status = 0
    for p in args.paths:
        try:
            d = json.loads(Path(p).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"{p}: UNREADABLE ({e})")
            status = 1
            continue
        errors = validate_result_dict(d)
        if errors:
            print(f"{p}: INVALID")
            for e in errors:
                print(f"  - {e}")
            status = 1
        else:
            result = ExperimentResult.from_dict(d)
            print(f"{p}: OK (scenario={result.scenario['name']}, "
                  f"rounds={result.rounds}, seeds={result.seeds}, "
                  f"strategies={result.strategies})")
            for s in result.strategies:
                print(f"  {s:12s} {aggregate_line(result, s)}")
    return status


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="Unified placement-experiment runner")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="show registered scenarios + strategies")

    run_p = sub.add_parser("run", help="run a scenario sweep")
    run_p.add_argument("scenario", help="registered scenario name")
    run_p.add_argument("--strategies", default="pso,random,uniform",
                       help="comma-separated strategy names/aliases")
    run_p.add_argument("--rounds", type=int, default=None,
                       help="override the scenario's round budget")
    run_p.add_argument("--seeds", default="0",
                       help="comma-separated seeds (multi-seed sweep)")
    run_p.add_argument("--set", action="append", metavar="KEY=VALUE",
                       help="override a ScenarioSpec field, or an "
                            "EvalConfig field via the eval. prefix "
                            "(e.g. eval.backend=np, "
                            "eval.mode=batched, eval.recording=on; "
                            "repeatable)")
    run_p.add_argument("--env", default=None,
                       choices=("simulated", "emulated", "online"),
                       help="run the scenario on the given track "
                            "regardless of its registered kind (e.g. "
                            "the elastic presets on the emulated "
                            "Fig. 4 world)")
    run_p.add_argument("--out", default=None,
                       help=f"artifact path (default "
                            f"{DEFAULT_OUT_DIR}/<scenario>.json)")
    run_p.add_argument("--mode", default=None,
                       choices=("auto", "sequential", "batched"),
                       help="DEPRECATED alias for --set eval.mode=... "
                            "(batched = lockstep pooled evaluation, "
                            "simulated only; both modes are "
                            "bit-identical)")
    run_p.add_argument("--device", default="cuda",
                       help="where the run executes: cuda (default; "
                            "raises without a card) or cpu")
    run_p.add_argument("--verbose", action="store_true")

    val_p = sub.add_parser("validate",
                           help="schema-check result artifacts")
    val_p.add_argument("paths", nargs="+")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"list": cmd_list, "run": cmd_run,
            "validate": cmd_validate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
