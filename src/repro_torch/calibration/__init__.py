"""repro_torch.calibration — trace-calibrated cost models.

The port of ``repro.calibration``. The sim-to-real loop in three moves:

1. **record** — run an emulated scenario with
   ``EvalConfig(recording='on')`` on the caller's device and write the
   per-client / per-cluster timings as a versioned :class:`TraceArtifact`
   (:func:`record_trace`; byte-neutral — recorded runs produce
   bit-identical result artifacts).
2. **fit** — least-squares recover the engine's delay laws from the
   trace (:func:`fit_calibration` → :class:`CalibrationResult`), and
   materialize them as a
   :class:`~repro_torch.core.cost_model.CalibratedCostModel` usable
   anywhere the analytic model goes, including the PSO inner loop
   (``CostModel.from_trace`` delegates here).
3. **replay** — re-score recorded rounds under any calibration and
   report per-round/per-level delay prediction error
   (:func:`replay`); the neutral :data:`ANALYTIC` calibration scores
   the paper's closed-form model as the baseline.

CLI: ``python -m repro_torch.calibration record|fit|replay|report|validate``.
"""
from repro_torch.calibration.fit import (
    ANALYTIC,
    CALIBRATION_SCHEMA,
    CALIBRATION_SCHEMA_VERSION,
    CalibrationResult,
    batch_predict_cluster_delay,
    cost_model_from_trace,
    fit_calibration,
    load_calibration,
)
from repro_torch.calibration.replay import (
    REPLAY_SCHEMA,
    REPLAY_SCHEMA_VERSION,
    ReplayReport,
    format_report,
    replay,
)
from repro_torch.calibration.trace import (
    TRACE_SCHEMA,
    TRACE_SCHEMA_VERSION,
    TraceArtifact,
    record_trace,
    validate_trace_dict,
)

__all__ = [
    "TraceArtifact", "record_trace", "validate_trace_dict",
    "TRACE_SCHEMA", "TRACE_SCHEMA_VERSION",
    "CalibrationResult", "fit_calibration", "load_calibration",
    "cost_model_from_trace", "batch_predict_cluster_delay",
    "ANALYTIC", "CALIBRATION_SCHEMA", "CALIBRATION_SCHEMA_VERSION",
    "ReplayReport", "replay", "format_report",
    "REPLAY_SCHEMA", "REPLAY_SCHEMA_VERSION",
]
