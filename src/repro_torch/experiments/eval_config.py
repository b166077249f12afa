"""EvalConfig: ONE frozen dataclass for every evaluation knob.

The port of ``repro.experiments.eval_config``. The knobs —
``batch_tpd(backend=...)``, ``PooledTPDEvaluator(shard=...)``, the
runner's ``mode=``, and the calibrated-vs-analytic cost source — are
consolidated here and threaded through ``run_experiment`` /
``run_single`` / ``build_environment`` / the CLI (``--set
eval.backend=np`` style nested overrides)::

    from repro_torch.experiments import EvalConfig, run_experiment
    run_experiment("paper-fig3", ["pso"],
                   eval_config=EvalConfig(mode="batched", shard="off"))

``backend`` takes the port's ``batch_tpd`` backend names — ``None``,
``"np"``, ``"torch"`` and ``"kernel"`` — not the reference's ``"jit"``,
``"pallas"`` and ``"interpret"``. A pinned backend is stamped into the
artifact's ``eval`` section, so a pinned-backend artifact of the port
differs from the reference's by that one string; default-config
artifacts keep the reference's bytes. ``cost_source="calibrated"``
builds a :class:`~repro_torch.core.cost_model.CalibratedCostModel` from
the fitted-calibration JSON ``calibration`` names.

Two kinds of fields, deliberately separated:

* **execution knobs** (``mode``, ``shard``, ``recording``) — change HOW
  a sweep runs, never WHAT it computes; every combination is
  parity-pinned bit-identical, so they are NOT artifact provenance.
* **semantics knobs** (``backend``, ``cost_source``, ``calibration``) —
  can change the numbers a strategy observes; :meth:`provenance`
  returns exactly these (or ``None`` when all are default), and the
  result artifact stamps schema v4 only when the section is present —
  default-config artifacts stay byte-identical to pre-EvalConfig runs.

The legacy ``run_experiment(mode=..., shard=...)`` kwargs and the CLI
``--mode`` flag keep working for one release through deprecation shims
(:func:`resolve_eval_config`) that name the replacement field.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional

_MODES = ("auto", "sequential", "batched")
_BACKENDS = (None, "np", "torch", "kernel")
_SHARDS = ("auto", "on", "off")
_COST_SOURCES = ("analytic", "calibrated")
_RECORDING = ("off", "on")


@dataclass(frozen=True)
class EvalConfig:
    """How a sweep evaluates placements.

    mode         sweep execution: 'auto' | 'sequential' | 'batched'
                 (recording='on' forces the sequential step loop)
    backend      pin the batch-TPD backend strategies ride inside the
                 PSO inner loop: None (auto) | 'np' | 'torch' | 'kernel'
    shard        pooled-evaluator device sharding: 'auto' | 'on' |
                 'off' ('on' splits rows over the devices of the
                 models' type; 'auto' only over more than one card)
    cost_source  'analytic' (paper eqs. 6-7) | 'calibrated'
                 (trace-fitted terms; simulated track only)
    calibration  path to a fitted-calibration JSON
                 (``python -m repro_torch.calibration fit``) — required
                 when cost_source='calibrated'
    recording    'off' | 'on' — capture per-round timing traces into
                 ``RoundObservation.timings`` (byte-neutral: recorded
                 runs produce bit-identical artifacts)
    """
    mode: str = "auto"
    backend: Optional[str] = None
    shard: str = "auto"
    cost_source: str = "analytic"
    calibration: Optional[str] = None
    recording: str = "off"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown eval.mode {self.mode!r}; "
                             f"use one of {_MODES}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown eval.backend {self.backend!r}; "
                             f"use one of {_BACKENDS}")
        if self.shard not in _SHARDS:
            raise ValueError(f"unknown eval.shard {self.shard!r}; "
                             f"use one of {_SHARDS}")
        if self.cost_source not in _COST_SOURCES:
            raise ValueError(
                f"unknown eval.cost_source {self.cost_source!r}; "
                f"use one of {_COST_SOURCES}")
        if self.recording not in _RECORDING:
            raise ValueError(f"unknown eval.recording {self.recording!r}; "
                             f"use one of {_RECORDING}")
        if self.cost_source == "calibrated" and not self.calibration:
            raise ValueError(
                "eval.cost_source='calibrated' needs eval.calibration="
                "<path to a fitted-calibration JSON> (write one with "
                "`python -m repro_torch.calibration fit`)")
        if self.recording == "on" and self.mode == "batched":
            raise ValueError(
                "eval.recording='on' needs the sequential step loop "
                "(batched mode bypasses env.step); use eval.mode="
                "'sequential' or 'auto'")

    # -- artifact provenance ------------------------------------------------
    def provenance(self) -> Optional[Dict[str, Any]]:
        """The semantics-bearing fields, for the result artifact's
        ``eval`` section — or ``None`` when every one is default.

        Execution knobs (mode/shard/recording) are EXCLUDED: they are
        parity-pinned bit-identical, and stamping them would make
        sequential and batched runs of the same sweep produce different
        bytes, breaking the golden artifact pins."""
        out: Dict[str, Any] = {}
        if self.backend is not None:
            out["backend"] = self.backend
        if self.cost_source != "analytic":
            out["cost_source"] = self.cost_source
            out["calibration"] = self.calibration
        return out or None

    # -- CLI-facing construction --------------------------------------------
    def with_overrides(self, **overrides) -> "EvalConfig":
        """``dataclasses.replace`` with CLI-friendly string coercion
        (``--set eval.backend=none`` clears the pin)."""
        by_name = {f.name for f in dataclasses.fields(self)}
        coerced = {}
        for k, v in overrides.items():
            if k not in by_name:
                accepted = ", ".join(sorted(by_name))
                raise TypeError(f"EvalConfig has no field {k!r}; "
                                f"fields: {accepted}")
            if isinstance(v, str) and v.lower() in ("none", "null"):
                v = None
            coerced[k] = v
        return dataclasses.replace(self, **coerced)


def resolve_eval_config(eval_config: Optional[EvalConfig] = None, *,
                        mode: Optional[str] = None,
                        shard: Optional[str] = None) -> EvalConfig:
    """Fold the legacy ``mode=``/``shard=`` kwargs into one EvalConfig.

    The legacy kwargs keep working for one release; each use warns with
    the replacement field's name. Passing a legacy kwarg that disagrees
    with an explicit ``eval_config`` is an error — silently preferring
    either would make the sweep run under a config the caller didn't
    write."""
    legacy = {}
    if mode is not None:
        warnings.warn(
            "the mode= kwarg is deprecated; use "
            "eval_config=EvalConfig(mode=...) (CLI: --set eval.mode=...)",
            DeprecationWarning, stacklevel=3)
        legacy["mode"] = mode
    if shard is not None:
        warnings.warn(
            "the shard= kwarg is deprecated; use "
            "eval_config=EvalConfig(shard=...) (CLI: --set eval.shard=...)",
            DeprecationWarning, stacklevel=3)
        legacy["shard"] = shard
    if eval_config is None:
        return EvalConfig(**legacy)
    for k, v in legacy.items():
        if getattr(eval_config, k) != v:
            raise ValueError(
                f"conflicting evaluation config: legacy kwarg {k}={v!r} "
                f"vs EvalConfig.{k}={getattr(eval_config, k)!r} — drop "
                f"the deprecated kwarg")
    return eval_config
