"""Versioned experiment-result artifact: one JSON schema for every
strategy x scenario x seed sweep (simulated and emulated alike).

The port's copy of ``repro.experiments.results`` (numpy only): the same
runs give the same artifact bytes in both packages.

Schema v2 layout (v1 artifacts still validate/load)::

    {
      "schema": "repro.experiments/result",
      "schema_version": 2,
      "scenario": {... ScenarioSpec.to_dict() ...},
      "rounds": 50,
      "seeds": [0, 17],
      "strategies": ["pso", "random"],
      "runs": [
        {"strategy": "pso", "seed": 0, "tpds": [...],
         "metrics": {"accuracy": [...], ...},
         "event_log": ["r60: pspeed drift (reverse)"],
         "total_tpd": ..., "mean_tpd": ..., "last10_mean_tpd": ...,
         "best_tpd": ..., "final_metrics": {"accuracy": ...}},
        ...
      ],
      "aggregates": {"pso": {"total_tpd": ..., "total_tpd_std": ...,
                             "mean_tpd": ..., "last10_mean_tpd": ...,
                             "best_tpd": ..., "final_accuracy": ...}, ...}
    }

v2 additions (all optional per run, so static artifacts are unchanged
apart from the version stamp):

* elastic runs carry a per-round ``metrics["topology_version"]`` series
  plus ``r<N>: topology vK: ...`` event-log lines (the environments
  re-hierarchize as the client population crosses capacity);
* ``strategy_state`` — a full strategy checkpoint captured by
  ``StrategyRun.save_state`` (swarm positions/velocities/pbest, rng
  stream, history), restorable with ``load_state`` for sweep resume.

v3 additions (the fault track; again optional per run, so fault-free
artifacts only change their version stamp):

* the scenario dict may carry ``faults`` (tagged fault-event dicts),
  ``fault_profile``, ``quorum_frac``, ``retry_limit`` and
  ``retry_backoff`` — v1/v2 artifacts without them load as fault-free;
* faulty runs carry per-round metric series: ``faults`` (cumulative
  injected events), ``dropped_updates``, ``retries`` (online only),
  ``degraded_flushes`` (quorum-refused merges), ``failovers``
  (aggregator re-homings), plus ``down``/``partitioned`` gauges.

v4 addition (EvalConfig provenance): a top-level ``eval`` object
carrying the semantics-bearing evaluation fields (``backend`` pin,
``cost_source``/``calibration``). The section — and therefore the v4
stamp — appears ONLY when a non-default field was set: a default-config
sweep still writes schema_version 3 with the exact pre-EvalConfig
bytes, so the golden artifact pins (and any downstream byte diffing)
survive the redesign. Execution knobs (mode/shard/recording) are never
stamped; they are parity-pinned bit-identical.

``validate_result_dict`` is the schema gate the CLI (and CI smoke job)
run before an artifact is written or consumed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

RESULT_SCHEMA = "repro.experiments/result"
RESULT_SCHEMA_VERSION = 4
# what an artifact WITHOUT an eval section stamps (byte-compat with
# every pre-EvalConfig artifact)
_PRE_EVAL_SCHEMA_VERSION = 3
# older artifact versions that still validate and load
RESULT_SCHEMA_COMPAT = (1, 2, 3, 4)


@dataclass
class StrategyRun:
    """One (strategy, seed) trajectory through an environment."""
    strategy: str
    seed: int
    tpds: List[float] = field(default_factory=list)
    metrics: Dict[str, List[float]] = field(default_factory=dict)
    event_log: List[str] = field(default_factory=list)
    # optional end-of-run strategy internals (reignitions, evaluations,
    # converged, ...) — diagnostic only, not aggregated
    diagnostics: Dict[str, Any] = field(default_factory=dict)
    # optional full strategy checkpoint (schema v2): everything needed
    # to resume the strategy mid-sweep — see save_state/load_state
    strategy_state: Optional[Dict[str, Any]] = None

    # -- checkpointing -----------------------------------------------------
    def save_state(self, strategy) -> None:
        """Capture ``strategy``'s checkpoint (positions/velocities/pbest
        arrays, rng stream, swarm history — whatever the strategy's
        ``save_state`` serializes) into this run record."""
        self.strategy_state = strategy.save_state()

    def load_state(self, strategy) -> None:
        """Restore the captured checkpoint into ``strategy`` (exact
        resume: the rng stream continues where the checkpoint left it).
        """
        if self.strategy_state is None:
            raise ValueError(
                f"run ({self.strategy}, seed {self.seed}) carries no "
                f"strategy_state; re-run with capture_state=True")
        strategy.load_state(self.strategy_state)

    # -- derived ----------------------------------------------------------
    @property
    def total_tpd(self) -> float:
        return float(np.sum(self.tpds)) if self.tpds else 0.0

    @property
    def mean_tpd(self) -> float:
        return float(np.mean(self.tpds)) if self.tpds else 0.0

    @property
    def last10_mean_tpd(self) -> float:
        return float(np.mean(self.tpds[-10:])) if self.tpds else 0.0

    @property
    def best_tpd(self) -> float:
        return float(np.min(self.tpds)) if self.tpds else 0.0

    def final_metrics(self) -> Dict[str, float]:
        return {k: float(v[-1]) for k, v in self.metrics.items() if v}

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "strategy": self.strategy, "seed": self.seed,
            "tpds": [float(t) for t in self.tpds],
            "metrics": {k: [float(x) for x in v]
                        for k, v in self.metrics.items()},
            "event_log": list(self.event_log),
            "diagnostics": dict(self.diagnostics),
            "total_tpd": self.total_tpd, "mean_tpd": self.mean_tpd,
            "last10_mean_tpd": self.last10_mean_tpd,
            "best_tpd": self.best_tpd,
            "final_metrics": self.final_metrics(),
        }
        if self.strategy_state is not None:
            out["strategy_state"] = self.strategy_state
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StrategyRun":
        return cls(strategy=d["strategy"], seed=int(d["seed"]),
                   tpds=list(d.get("tpds", [])),
                   metrics={k: list(v)
                            for k, v in d.get("metrics", {}).items()},
                   event_log=list(d.get("event_log", [])),
                   diagnostics=dict(d.get("diagnostics", {})),
                   strategy_state=d.get("strategy_state"))


def aggregate_runs(runs: List[StrategyRun]) -> Dict[str, float]:
    """Multi-seed aggregate for ONE strategy's runs."""
    if not runs:
        return {"n_seeds": 0, "total_tpd": 0.0, "total_tpd_std": 0.0,
                "mean_tpd": 0.0, "last10_mean_tpd": 0.0, "best_tpd": 0.0}
    totals = [r.total_tpd for r in runs]
    agg = {
        "n_seeds": len(runs),
        "total_tpd": float(np.mean(totals)),
        "total_tpd_std": float(np.std(totals)),
        "mean_tpd": float(np.mean([r.mean_tpd for r in runs])),
        "last10_mean_tpd": float(np.mean([r.last10_mean_tpd
                                          for r in runs])),
        "best_tpd": float(np.mean([r.best_tpd for r in runs])),
    }
    metric_keys = sorted({k for r in runs for k in r.final_metrics()})
    for k in metric_keys:
        vals = [r.final_metrics()[k] for r in runs
                if k in r.final_metrics()]
        agg[f"final_{k}"] = float(np.mean(vals))
    return agg


@dataclass
class ExperimentResult:
    """The full sweep artifact (see module docstring for the schema)."""
    scenario: Dict[str, Any]
    rounds: int
    seeds: List[int]
    strategies: List[str]
    runs: List[StrategyRun] = field(default_factory=list)
    # EvalConfig.provenance(): the semantics-bearing evaluation fields,
    # or None for a default config (then the artifact keeps the v3
    # bytes — the golden-pin invariant)
    eval: Optional[Dict[str, Any]] = None
    # None = stamp at serialization time from the eval section; loaded
    # artifacts keep their original stamp through a round trip
    schema_version: Optional[int] = None

    def runs_for(self, strategy: str) -> List[StrategyRun]:
        return [r for r in self.runs if r.strategy == strategy]

    @property
    def aggregates(self) -> Dict[str, Dict[str, float]]:
        return {s: aggregate_runs(self.runs_for(s))
                for s in self.strategies}

    def stamped_schema_version(self) -> int:
        if self.schema_version is not None:
            return self.schema_version
        return RESULT_SCHEMA_VERSION if self.eval is not None \
            else _PRE_EVAL_SCHEMA_VERSION

    # -- JSON round trip ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "schema": RESULT_SCHEMA,
            "schema_version": self.stamped_schema_version(),
            "scenario": self.scenario,
            "rounds": self.rounds,
            "seeds": list(self.seeds),
            "strategies": list(self.strategies),
        }
        if self.eval is not None:
            d["eval"] = dict(self.eval)
        d["runs"] = [r.to_dict() for r in self.runs]
        d["aggregates"] = self.aggregates
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **kw)

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        d = self.to_dict()
        errors = validate_result_dict(d)
        if errors:
            raise ValueError(f"refusing to write schema-invalid artifact: "
                             f"{errors}")
        path.write_text(json.dumps(d, indent=1))
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentResult":
        errors = validate_result_dict(d)
        if errors:
            raise ValueError(f"invalid experiment artifact: {errors}")
        return cls(
            scenario=d["scenario"], rounds=int(d["rounds"]),
            seeds=[int(s) for s in d["seeds"]],
            strategies=list(d["strategies"]),
            runs=[StrategyRun.from_dict(r) for r in d["runs"]],
            eval=d.get("eval"),
            schema_version=int(d["schema_version"]))

    @classmethod
    def load(cls, path) -> "ExperimentResult":
        return cls.from_dict(json.loads(Path(path).read_text()))


def validate_result_dict(d: Dict[str, Any]) -> List[str]:
    """Structural schema check; returns a list of problems (empty = ok)."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return ["artifact is not a JSON object"]
    if d.get("schema") != RESULT_SCHEMA:
        errors.append(f"schema != {RESULT_SCHEMA!r}")
    if d.get("schema_version") not in RESULT_SCHEMA_COMPAT:
        errors.append(f"schema_version not in {RESULT_SCHEMA_COMPAT}")
    for key, typ in (("scenario", dict), ("rounds", int), ("seeds", list),
                     ("strategies", list), ("runs", list),
                     ("aggregates", dict)):
        if not isinstance(d.get(key), typ):
            errors.append(f"missing/mistyped field {key!r} "
                          f"(want {typ.__name__})")
    if errors:
        return errors
    if not isinstance(d["scenario"].get("name"), str):
        errors.append("scenario.name missing")
    if "eval" in d:
        if not isinstance(d["eval"], dict):
            errors.append("eval section must be an object")
        elif d["schema_version"] < 4:
            errors.append("eval section requires schema_version >= 4")
    expected_runs = len(d["strategies"]) * len(d["seeds"])
    if len(d["runs"]) != expected_runs:
        errors.append(f"expected {expected_runs} runs "
                      f"(strategies x seeds), got {len(d['runs'])}")
    for i, r in enumerate(d["runs"]):
        for key in ("strategy", "seed", "tpds", "total_tpd"):
            if key not in r:
                errors.append(f"runs[{i}] missing {key!r}")
        if r.get("strategy") not in d["strategies"]:
            errors.append(f"runs[{i}].strategy {r.get('strategy')!r} "
                          f"not in strategies")
        if len(r.get("tpds", [])) != d["rounds"]:
            errors.append(f"runs[{i}] has {len(r.get('tpds', []))} tpds, "
                          f"expected rounds={d['rounds']}")
    for s in d["strategies"]:
        if s not in d["aggregates"]:
            errors.append(f"aggregates missing strategy {s!r}")
    return errors
