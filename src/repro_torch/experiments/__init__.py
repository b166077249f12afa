"""repro_torch.experiments — scenarios, environments and the sweep runner.

* :class:`~repro_torch.experiments.scenarios.ScenarioSpec` — a
  declarative evaluation world (hierarchy, client-pool profile, event
  schedule) with every preset of the reference registered.
* :class:`SimulatedEnvironment` — the analytical CostModel world
  (Fig. 3); :class:`EmulatedEnvironment` — real federated rounds on the
  paper MLP (Fig. 4); both on the device the caller names.
* :func:`run_experiment` / :func:`run_single` — the sequential sweep,
  returning the versioned :class:`ExperimentResult`::

      run_experiment("paper-fig4", ["pso", "random", "uniform"],
                     rounds=50, seeds=[0])

The lockstep batched sweep, the CLI and ``EvalConfig`` wait for later
slices (ROADMAP.md).
"""
from repro_torch.core.hierarchy import TopologyUpdate
from repro_torch.experiments.environments import (
    EmulatedEnvironment,
    Environment,
    RoundObservation,
    SampledSimulatedEnvironment,
    SimulatedEnvironment,
    build_environment,
)
from repro_torch.experiments.results import ExperimentResult, StrategyRun, aggregate_runs
from repro_torch.experiments.runner import run_experiment, run_single
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
    "EmulatedEnvironment", "RoundObservation", "TopologyUpdate",
    "build_environment", "run_experiment", "run_single",
    "ExperimentResult", "StrategyRun", "aggregate_runs",
    "ScenarioSpec", "PoolProfile", "ScheduledEvent", "PSpeedDrift",
    "ClientChurn", "ClientJoin", "ClientLeave",
    "StragglerSpike", "LatencyNoise",
    "get_scenario", "list_scenarios", "register_scenario",
]
