"""Trace recording: every emulated run becomes a reusable measurement.

The port of ``repro.calibration.trace``: the same artifact, byte for
byte (the schema names below are the reference's, so either package
reads the other's traces). The recorded run executes on the caller's
``device``; its numbers come from deterministic timing, so they are
numpy and do not depend on the device.

A :class:`TraceArtifact` is the versioned, seeded-run-keyed record of
one (scenario, strategy, seed) run's timings — per-client local-step
times and per-level/per-cluster aggregation delays, exactly as the
environments surface them through ``RoundObservation.timings`` (the
uniform mapping all four environment kinds populate). The recorder is
byte-neutral: it reads values the engines already computed, consumes no
rng, and a ``recording=off`` run writes artifacts bit-identical to
pre-recording code.

Artifact layout (JSON, deterministic ordering)::

    {
      "schema": "repro.calibration/trace",
      "schema_version": 1,
      "scenario": {... ScenarioSpec.to_dict() ...},
      "kind": "emulated", "strategy": "pso", "seed": 0, "rounds": 3,
      "comm_latency": 0.002, "local_steps": 2,
      "clients": {"pspeed": [...], "mdatasize": [...], "memcap": [...]},
      "hierarchy": {"depth": 2, "width": 2, "trainers_per_leaf": 1,
                    "n_clients": 10},
      "records": [
        {"round": 0, "placement": [...], "tpd": ...,
         "train_time": ..., "agg_time": ...,
         "train": {"clients": [...], "times": [...]},
         "levels": [{"level": 1, "slots": [...], "hosts": [...],
                     "loads": [...], "n_parts": [...],
                     "delays": [...]}, ...]},
        ...
      ]
    }

``loads`` are RAW payload sums (mdatasize units, before the emulated
engine's eq. 6 scale) — the fitter's feature, never a fitted quantity.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

TRACE_SCHEMA = "repro.calibration/trace"
TRACE_SCHEMA_VERSION = 1


@dataclass
class TraceArtifact:
    """One recorded run's timing trace (see module docstring)."""
    scenario: Dict[str, Any]
    kind: str
    strategy: str
    seed: int
    rounds: int
    comm_latency: float
    local_steps: int
    clients: Dict[str, List[float]]
    hierarchy: Dict[str, int]
    records: List[Dict[str, Any]] = field(default_factory=list)
    schema_version: int = TRACE_SCHEMA_VERSION

    # -- JSON round trip ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": TRACE_SCHEMA,
            "schema_version": self.schema_version,
            "scenario": self.scenario,
            "kind": self.kind,
            "strategy": self.strategy,
            "seed": self.seed,
            "rounds": self.rounds,
            "comm_latency": self.comm_latency,
            "local_steps": self.local_steps,
            "clients": self.clients,
            "hierarchy": self.hierarchy,
            "records": self.records,
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **kw)

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        d = self.to_dict()
        errors = validate_trace_dict(d)
        if errors:
            raise ValueError(
                f"refusing to write schema-invalid trace: {errors}")
        path.write_text(json.dumps(d, indent=1))
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceArtifact":
        errors = validate_trace_dict(d)
        if errors:
            raise ValueError(f"invalid trace artifact: {errors}")
        return cls(
            scenario=d["scenario"], kind=d["kind"],
            strategy=d["strategy"], seed=int(d["seed"]),
            rounds=int(d["rounds"]),
            comm_latency=float(d["comm_latency"]),
            local_steps=int(d["local_steps"]),
            clients=d["clients"], hierarchy=d["hierarchy"],
            records=list(d["records"]),
            schema_version=int(d["schema_version"]))

    @classmethod
    def load(cls, path) -> "TraceArtifact":
        return cls.from_dict(json.loads(Path(path).read_text()))


def validate_trace_dict(d: Dict[str, Any]) -> List[str]:
    """Structural schema check; returns a list of problems (empty = ok)."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return ["trace is not a JSON object"]
    if d.get("schema") != TRACE_SCHEMA:
        errors.append(f"schema != {TRACE_SCHEMA!r}")
    if d.get("schema_version") != TRACE_SCHEMA_VERSION:
        errors.append(f"schema_version != {TRACE_SCHEMA_VERSION}")
    for key, typ in (("scenario", dict), ("kind", str), ("strategy", str),
                     ("seed", int), ("rounds", int), ("clients", dict),
                     ("hierarchy", dict), ("records", list)):
        if not isinstance(d.get(key), typ):
            errors.append(f"missing/mistyped field {key!r} "
                          f"(want {typ.__name__})")
    if errors:
        return errors
    for key in ("pspeed", "mdatasize", "memcap"):
        if not isinstance(d["clients"].get(key), list):
            errors.append(f"clients.{key} missing")
    for key in ("depth", "width", "trainers_per_leaf", "n_clients"):
        if not isinstance(d["hierarchy"].get(key), int):
            errors.append(f"hierarchy.{key} missing")
    if len(d["records"]) != d["rounds"]:
        errors.append(f"expected {d['rounds']} records, "
                      f"got {len(d['records'])}")
    for i, rec in enumerate(d["records"]):
        for key in ("round", "placement", "tpd", "train_time",
                    "agg_time", "train", "levels"):
            if key not in rec:
                errors.append(f"records[{i}] missing {key!r}")
        for j, row in enumerate(rec.get("levels", [])):
            for key in ("level", "slots", "hosts", "loads", "n_parts",
                        "delays"):
                if key not in row:
                    errors.append(
                        f"records[{i}].levels[{j}] missing {key!r}")
    return errors


def record_trace(scenario, strategy: str = "pso", *, seed: int = 0,
                 rounds: Optional[int] = None, config=None,
                 verbose: bool = False, device="cuda") -> TraceArtifact:
    """Run one (scenario, strategy, seed) trajectory with recording on,
    on ``device``, and return its :class:`TraceArtifact`.

    Drives the ordinary sequential loop (``run_single`` with
    ``EvalConfig(recording='on')`` and an ``on_observation`` hook), so
    the recorded run's trajectory is bit-identical to an unrecorded
    one. Calibration needs a stationary measurement, so scenarios with
    event schedules, fault schedules or client sampling are refused —
    their pools mutate mid-run and the trace's client snapshot would
    lie about the later rounds.
    """
    from repro_torch.experiments.eval_config import EvalConfig
    from repro_torch.experiments.runner import run_single
    from repro_torch.experiments.scenarios import get_scenario

    spec = get_scenario(scenario) if isinstance(scenario, str) else scenario
    rounds = rounds if rounds is not None else spec.rounds
    if spec.events:
        raise ValueError(
            f"scenario {spec.name!r} schedules events — record traces "
            "from stationary (event-free) scenarios")
    if not spec.make_faults(seed).empty:
        raise ValueError(
            f"scenario {spec.name!r} schedules faults — record traces "
            "from fault-free scenarios")
    if getattr(spec, "sampling", "off") != "off":
        raise ValueError(
            f"scenario {spec.name!r} samples cohorts — record traces "
            "from fully-participating scenarios")

    records: List[Dict[str, Any]] = []

    def on_observation(obs) -> None:
        t = obs.timings
        records.append({
            "round": int(obs.round_idx),
            "placement": [int(c) for c in obs.placement],
            "tpd": float(obs.tpd),
            "train_time": float(t.get("train_time", 0.0)),
            "agg_time": float(t.get("agg_time", 0.0)),
            "train": t.get("train", {"clients": [], "times": []}),
            "levels": t.get("levels", []),
        })

    run_single(spec, strategy, seed=seed, rounds=rounds, config=config,
               verbose=verbose, eval_config=EvalConfig(recording="on"),
               on_observation=on_observation, device=device)

    # the pool/hierarchy snapshot: stationary by the refusals above, so
    # re-materializing from (spec, seed) reproduces the run's exact pool
    pool = spec.make_pool(seed)
    h = spec.make_hierarchy()
    return TraceArtifact(
        # json round trip: the spec dict may hold tuples, which a
        # save/load cycle would turn into lists — store JSON-native
        # types so to_dict() is stable across round trips
        scenario=json.loads(json.dumps(spec.to_dict())),
        kind=spec.kind, strategy=strategy,
        seed=int(seed), rounds=int(rounds),
        comm_latency=float(spec.comm_latency),
        local_steps=int(spec.local_steps),
        clients={
            "pspeed": [float(x) for x in np.asarray(pool.pspeed)],
            "mdatasize": [float(x) for x in np.asarray(pool.mdatasize)],
            "memcap": [float(x) for x in np.asarray(pool.memcap)],
        },
        hierarchy={
            "depth": int(h.depth), "width": int(h.width),
            "trainers_per_leaf": int(h.trainers_per_leaf),
            "n_clients": int(h.total_clients),
        },
        records=records)
