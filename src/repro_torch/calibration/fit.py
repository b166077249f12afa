"""Fit CostModel parameters from a recorded trace.

The port of ``repro.calibration.fit``: numpy least squares, the same
logic, so a fit of the same trace gives the same constants.

The emulated engine's delay laws are linear in three parameters:

* cluster aggregation (one row per recorded cluster)::

      delay = alpha * load / pspeed_host + beta_level * n_parts

  with ``alpha`` the payload scale (the engine's eq. 6 divisor is
  ``1/alpha``) and one ``beta`` link charge per hierarchy level;
* local training (one row per recorded client)::

      time = gamma / pspeed_client

  with ``gamma`` the per-round local-step count.

So a single :func:`numpy.linalg.lstsq` over the trace's rows recovers
the engine's true constants exactly on deterministic-timing traces and
least-squares-optimally on noisy ones. The fitted
:class:`CalibrationResult` plugs into
:class:`~repro_torch.core.cost_model.CalibratedCostModel` (via
:meth:`CalibrationResult.make_cost_model` or
``CostModel.from_trace``), which the PSO inner loop consumes through
the existing batch-TPD path.

The cheap vectorized surrogate :func:`batch_predict_cluster_delay`
scores many candidate clusters at once; ``_predict_cluster_delay_ref``
is its scalar oracle.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.calibration.trace import TraceArtifact

CALIBRATION_SCHEMA = "repro.calibration/calibration"
CALIBRATION_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class CalibrationResult:
    """Fitted CostModel parameters plus fit diagnostics.

    payload_scale  alpha: multiplier on load/pspeed (analytic = 1.0)
    level_link     beta per hierarchy level, indexed by level value
                   (one per-part link charge; analytic = all zero)
    train_scale    gamma: local-train time is gamma/pspeed (analytic 0)
    n_rows         fitted rows (clusters + clients) across kept rounds
    rms_residual   root-mean-square fit residual over those rows
    source         provenance: scenario/strategy/seed/rounds/holdout
    """
    payload_scale: float
    level_link: Tuple[float, ...]
    train_scale: float
    n_rows: int = 0
    rms_residual: float = 0.0
    source: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": CALIBRATION_SCHEMA,
            "schema_version": CALIBRATION_SCHEMA_VERSION,
            "payload_scale": self.payload_scale,
            "level_link": list(self.level_link),
            "train_scale": self.train_scale,
            "n_rows": self.n_rows,
            "rms_residual": self.rms_residual,
            "source": self.source,
        }

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationResult":
        if d.get("schema") != CALIBRATION_SCHEMA:
            raise ValueError(
                f"not a calibration artifact (schema={d.get('schema')!r}, "
                f"want {CALIBRATION_SCHEMA!r})")
        if d.get("schema_version") != CALIBRATION_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported calibration schema_version "
                f"{d.get('schema_version')!r}")
        return cls(
            payload_scale=float(d["payload_scale"]),
            level_link=tuple(float(x) for x in d["level_link"]),
            train_scale=float(d["train_scale"]),
            n_rows=int(d.get("n_rows", 0)),
            rms_residual=float(d.get("rms_residual", 0.0)),
            source=dict(d.get("source", {})))

    def make_cost_model(self, hierarchy, clients, *,
                        memory_penalty: float = 1e6, device="cuda"):
        """A :class:`CalibratedCostModel` carrying these parameters, its
        swarm backends on ``device``."""
        from repro_torch.core.cost_model import CalibratedCostModel
        return CalibratedCostModel(
            hierarchy, clients, memory_penalty=memory_penalty,
            device=device, payload_scale=self.payload_scale,
            level_link=self.level_link,
            train_scale=self.train_scale)


#: the analytic cost model expressed as a (neutral) calibration: unit
#: payload scale, no link charges, no train term — the replay harness's
#: baseline.
ANALYTIC = CalibrationResult(payload_scale=1.0, level_link=(),
                             train_scale=0.0)


def load_calibration(path) -> CalibrationResult:
    """Read a fitted-calibration JSON written by
    :meth:`CalibrationResult.save` / ``python -m repro_torch.calibration
    fit`` (or the reference's ``fit``: the artifact is the same)."""
    return CalibrationResult.from_dict(json.loads(Path(path).read_text()))


def _split_rounds(trace: TraceArtifact,
                  holdout_rounds: int) -> Tuple[List[dict], List[dict]]:
    if holdout_rounds < 0:
        raise ValueError("holdout_rounds must be >= 0")
    if holdout_rounds >= len(trace.records):
        raise ValueError(
            f"holdout_rounds={holdout_rounds} leaves no fitting rounds "
            f"(trace has {len(trace.records)})")
    if holdout_rounds == 0:
        return list(trace.records), []
    return (list(trace.records[:-holdout_rounds]),
            list(trace.records[-holdout_rounds:]))


def fit_calibration(trace: TraceArtifact, *,
                    holdout_rounds: int = 0) -> CalibrationResult:
    """Least-squares fit of (payload_scale, level_link, train_scale)
    from a trace's cluster and train rows.

    ``holdout_rounds`` reserves the trace's LAST n rounds for replay
    validation — they contribute no fitting rows, so the replay error
    on them is a genuine held-out measurement.
    """
    fit_records, _ = _split_rounds(trace, holdout_rounds)
    pspeed = np.asarray(trace.clients["pspeed"], dtype=np.float64)
    depth = int(trace.hierarchy["depth"])

    # unknowns: [alpha, beta_0 .. beta_{depth-1}, gamma]
    n_unknown = 1 + depth + 1
    rows: List[np.ndarray] = []
    y: List[float] = []
    for rec in fit_records:
        for lvl in rec["levels"]:
            level = int(lvl["level"])
            for host, load, n_parts, delay in zip(
                    lvl["hosts"], lvl["loads"], lvl["n_parts"],
                    lvl["delays"], strict=True):
                x = np.zeros(n_unknown)
                x[0] = float(load) / pspeed[int(host)]
                x[1 + level] = float(n_parts)
                rows.append(x)
                y.append(float(delay))
        train = rec["train"]
        for client, t in zip(train["clients"], train["times"],
                             strict=True):
            x = np.zeros(n_unknown)
            x[-1] = 1.0 / pspeed[int(client)]
            rows.append(x)
            y.append(float(t))
    if not rows:
        raise ValueError(
            "trace has no timing rows to fit — was it recorded with "
            "eval.recording='on' on the emulated track?")

    X = np.stack(rows)
    yv = np.asarray(y, dtype=np.float64)
    # drop all-zero columns (levels never observed) so lstsq stays
    # well-posed; their betas are pinned to 0
    seen = np.abs(X).sum(axis=0) > 0
    theta = np.zeros(n_unknown)
    sol, _, _, _ = np.linalg.lstsq(X[:, seen], yv, rcond=None)
    theta[seen] = sol
    resid = X @ theta - yv
    return CalibrationResult(
        payload_scale=float(theta[0]),
        level_link=tuple(float(b) for b in theta[1:1 + depth]),
        train_scale=float(theta[-1]),
        n_rows=int(len(yv)),
        rms_residual=float(np.sqrt(np.mean(resid ** 2))),
        source={
            "scenario": trace.scenario.get("name"),
            "kind": trace.kind,
            "strategy": trace.strategy,
            "seed": trace.seed,
            "rounds": trace.rounds,
            "holdout_rounds": holdout_rounds,
        })


def cost_model_from_trace(trace, *, hierarchy=None, clients=None,
                          holdout_rounds: int = 0, device="cuda"):
    """``CostModel.from_trace`` backend: fit a trace, return the
    calibrated model on ``device``. ``hierarchy``/``clients`` default to
    the trace's own recorded topology and pool."""
    if isinstance(trace, (str, Path)):
        trace = TraceArtifact.load(trace)
    cal = fit_calibration(trace, holdout_rounds=holdout_rounds)
    if hierarchy is None:
        from repro_torch.core.hierarchy import Hierarchy
        hinfo = trace.hierarchy
        hierarchy = Hierarchy(
            depth=int(hinfo["depth"]), width=int(hinfo["width"]),
            trainers_per_leaf=int(hinfo["trainers_per_leaf"]),
            n_clients=int(hinfo["n_clients"]))
    if clients is None:
        from repro_torch.core.hierarchy import ClientPool
        c = trace.clients
        clients = ClientPool(
            memcap=np.asarray(c["memcap"], dtype=np.float64),
            pspeed=np.asarray(c["pspeed"], dtype=np.float64),
            mdatasize=np.asarray(c["mdatasize"], dtype=np.float64))
    mp = float(trace.scenario.get("memory_penalty", 1e6))
    return cal.make_cost_model(hierarchy, clients, memory_penalty=mp,
                               device=device)


# -- cluster-delay surrogate and its scalar oracle -------------------------

def batch_predict_cluster_delay(loads, host_pspeed, n_parts, levels,
                                calibration: CalibrationResult):
    """Vectorized calibrated cluster-delay prediction.

    Scores many candidate clusters at once inside search loops without
    materializing CalibratedCostModel objects: for each row i,

        delay_i = alpha * loads[i]/host_pspeed[i] + beta_{levels[i]} *
                  n_parts[i]

    Levels the calibration never observed charge beta = 0.
    ``_predict_cluster_delay_ref`` is the scalar oracle.
    """
    loads = np.asarray(loads, dtype=np.float64)
    host_pspeed = np.asarray(host_pspeed, dtype=np.float64)
    n_parts = np.asarray(n_parts, dtype=np.float64)
    levels = np.asarray(levels, dtype=np.int64)
    beta = np.zeros(int(levels.max()) + 1 if levels.size else 1)
    link = np.asarray(calibration.level_link, dtype=np.float64)
    beta[:min(len(beta), link.size)] = link[:len(beta)]
    return (calibration.payload_scale * loads / host_pspeed
            + beta[levels] * n_parts)


def _predict_cluster_delay_ref(load, host_pspeed, n_parts, level,
                               calibration: CalibrationResult) -> float:
    """Scalar oracle for :func:`batch_predict_cluster_delay`."""
    link = calibration.level_link
    beta = link[level] if level < len(link) else 0.0
    return (calibration.payload_scale * float(load) / float(host_pspeed)
            + beta * float(n_parts))
