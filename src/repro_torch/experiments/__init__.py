"""repro_torch.experiments — scenarios, environments and the sweep runner.

* :class:`~repro_torch.experiments.scenarios.ScenarioSpec` — a
  declarative evaluation world (hierarchy, client-pool profile, event
  and fault schedules) with every preset of the reference registered.
* :class:`SimulatedEnvironment` — the analytical CostModel world
  (Fig. 3, the two-tier pod model and the trace-calibrated model
  included); :class:`EmulatedEnvironment` — real federated rounds on
  the paper MLP (Fig. 4, faults and quorums included);
  :class:`OnlineEnvironment` — the same rounds asynchronously, on a
  virtual clock (jittered arrivals, buffered flushes, staleness-weighted
  merges, mid-round re-optimization, faults); all on the device the
  caller names.
* :func:`run_experiment` — the multi-seed sweep (sequential, or the
  lockstep batched sweep on simulated scenarios), configured by one
  :class:`EvalConfig` and returning the versioned
  :class:`ExperimentResult`; also a CLI: ``python -m
  repro_torch.experiments run paper-fig4 --strategies pso,random
  --rounds 25 --seeds 0,17``.
"""
from repro_torch.core.hierarchy import TopologyUpdate
from repro_torch.experiments.environments import (
    EmulatedEnvironment,
    Environment,
    OnlineEnvironment,
    RoundObservation,
    SampledSimulatedEnvironment,
    SimulatedEnvironment,
    build_environment,
)
from repro_torch.experiments.eval_config import EvalConfig, resolve_eval_config
from repro_torch.experiments.results import (
    RESULT_SCHEMA,
    RESULT_SCHEMA_VERSION,
    ExperimentResult,
    StrategyRun,
    aggregate_runs,
    validate_result_dict,
)
from repro_torch.experiments.runner import run_batched, run_experiment, run_single
from repro_torch.experiments.scenarios import (
    ClientChurn,
    ClientJoin,
    ClientLeave,
    LatencyNoise,
    PoolProfile,
    PSpeedDrift,
    ScenarioSpec,
    ScheduledEvent,
    StragglerSpike,
    get_scenario,
    list_scenarios,
    register_scenario,
)

__all__ = [
    "Environment", "SimulatedEnvironment", "SampledSimulatedEnvironment",
    "EmulatedEnvironment", "OnlineEnvironment", "RoundObservation",
    "TopologyUpdate",
    "build_environment", "EvalConfig", "resolve_eval_config",
    "ExperimentResult", "StrategyRun", "aggregate_runs",
    "validate_result_dict", "RESULT_SCHEMA", "RESULT_SCHEMA_VERSION",
    "run_experiment", "run_single", "run_batched",
    "ScenarioSpec", "PoolProfile", "ScheduledEvent", "PSpeedDrift",
    "ClientChurn", "ClientJoin", "ClientLeave",
    "StragglerSpike", "LatencyNoise",
    "get_scenario", "list_scenarios", "register_scenario",
]
