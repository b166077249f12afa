"""Replay: re-score recorded rounds under a calibration.

The port of ``repro.calibration.replay`` (numpy, the same logic and
report).

The replay harness walks a :class:`TraceArtifact`'s records and, for
each round, predicts what the cost model says the round SHOULD have
cost — per-cluster delays through the vectorized surrogate
(:func:`~repro_torch.calibration.fit.batch_predict_cluster_delay`), the
round's aggregation delay as the sum of per-level maxima (paper eq. 7),
and the training phase as ``train_scale * max(1/pspeed)`` over the
round's recorded trainers — then compares against the delays the
emulated engine actually charged. The result is a per-round /
per-level delay prediction error report: the sim-to-real gap,
quantified.

Replaying the neutral :data:`~repro_torch.calibration.fit.ANALYTIC`
calibration scores the paper's analytic model against the same trace,
so ``report`` can show whether a trace-fitted model reduces held-out
delay error.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.calibration.fit import (
    CalibrationResult,
    batch_predict_cluster_delay,
)
from repro_torch.calibration.trace import TraceArtifact

REPLAY_SCHEMA = "repro.calibration/replay"
REPLAY_SCHEMA_VERSION = 1


@dataclass
class ReplayReport:
    """Per-round and per-level measured-vs-predicted delay errors."""
    calibration: Dict[str, Any]
    trace_source: Dict[str, Any]
    rounds: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def mean_abs_error(self) -> float:
        errs = [r["abs_error"] for r in self.rounds]
        return float(np.mean(errs)) if errs else 0.0

    @property
    def max_abs_error(self) -> float:
        errs = [r["abs_error"] for r in self.rounds]
        return float(np.max(errs)) if errs else 0.0

    @property
    def rms_error(self) -> float:
        errs = [r["abs_error"] for r in self.rounds]
        return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0

    def per_level_mean_abs_error(self) -> Dict[int, float]:
        acc: Dict[int, List[float]] = {}
        for r in self.rounds:
            for lvl in r["levels"]:
                acc.setdefault(int(lvl["level"]), []).append(
                    abs(lvl["measured"] - lvl["predicted"]))
        return {k: float(np.mean(v)) for k, v in sorted(acc.items())}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": REPLAY_SCHEMA,
            "schema_version": REPLAY_SCHEMA_VERSION,
            "calibration": self.calibration,
            "trace_source": self.trace_source,
            "summary": {
                "n_rounds": len(self.rounds),
                "mean_abs_error": self.mean_abs_error,
                "rms_error": self.rms_error,
                "max_abs_error": self.max_abs_error,
                "per_level_mean_abs_error": {
                    str(k): v
                    for k, v in self.per_level_mean_abs_error().items()},
            },
            "rounds": self.rounds,
        }

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path


def replay(trace: TraceArtifact, calibration: CalibrationResult, *,
           rounds: Optional[Sequence[int]] = None) -> ReplayReport:
    """Score ``calibration``'s delay predictions against a trace.

    ``rounds`` restricts the replay to specific round indices (e.g. the
    holdout tail the fitter never saw); default is every recorded round.
    """
    pspeed = np.asarray(trace.clients["pspeed"], dtype=np.float64)
    wanted = None if rounds is None else {int(r) for r in rounds}
    out_rounds: List[Dict[str, Any]] = []
    for rec in trace.records:
        if wanted is not None and int(rec["round"]) not in wanted:
            continue
        level_rows: List[Dict[str, Any]] = []
        pred_agg = 0.0
        meas_agg = 0.0
        for lvl in rec["levels"]:
            level = int(lvl["level"])
            hosts = np.asarray(lvl["hosts"], dtype=np.int64)
            pred = batch_predict_cluster_delay(
                lvl["loads"], pspeed[hosts], lvl["n_parts"],
                np.full(len(hosts), level), calibration)
            meas_level = float(np.max(lvl["delays"])) if hosts.size else 0.0
            pred_level = float(np.max(pred)) if hosts.size else 0.0
            level_rows.append({
                "level": level,
                "measured": meas_level,
                "predicted": pred_level,
                "cluster_mean_abs_error": float(
                    np.mean(np.abs(pred - np.asarray(lvl["delays"]))))
                if hosts.size else 0.0,
            })
            pred_agg += pred_level
            meas_agg += meas_level
        train = rec["train"]
        trainers = np.asarray(train["clients"], dtype=np.int64)
        pred_train = (calibration.train_scale
                      * float(np.max(1.0 / pspeed[trainers]))
                      if trainers.size else 0.0)
        measured = float(rec["train_time"]) + float(rec["agg_time"])
        predicted = pred_train + pred_agg
        out_rounds.append({
            "round": int(rec["round"]),
            "measured": measured,
            "predicted": predicted,
            "abs_error": abs(measured - predicted),
            "train_measured": float(rec["train_time"]),
            "train_predicted": pred_train,
            "agg_measured": meas_agg,
            "agg_predicted": pred_agg,
            "levels": level_rows,
        })
    return ReplayReport(
        calibration=calibration.to_dict(),
        trace_source={
            "scenario": trace.scenario.get("name"),
            "kind": trace.kind,
            "strategy": trace.strategy,
            "seed": trace.seed,
            "rounds": trace.rounds,
        },
        rounds=out_rounds)


def format_report(tag: str, report: ReplayReport) -> str:
    """One human-readable block per replayed calibration."""
    lines = [f"[{tag}] {len(report.rounds)} rounds: "
             f"mean|err|={report.mean_abs_error:.6g} "
             f"rms={report.rms_error:.6g} "
             f"max|err|={report.max_abs_error:.6g}"]
    for level, err in report.per_level_mean_abs_error().items():
        lines.append(f"  level {level}: mean|err|={err:.6g}")
    for r in report.rounds:
        lines.append(
            f"  round {r['round']:>3}: measured={r['measured']:.6g} "
            f"predicted={r['predicted']:.6g} |err|={r['abs_error']:.6g}")
    return "\n".join(lines)
