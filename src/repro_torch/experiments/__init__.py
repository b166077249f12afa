"""repro_torch.experiments — scenarios and the simulated environments.

* :class:`~repro_torch.experiments.scenarios.ScenarioSpec` — a
  declarative evaluation world (hierarchy, client-pool profile, event
  schedule) with every preset of the reference registered.
* :class:`SimulatedEnvironment` — the analytical CostModel world
  (Fig. 3), on the device the caller names.

The sweep runner, results, CLI and ``EvalConfig`` come with the
emulated slice.
"""
from repro_torch.core.hierarchy import TopologyUpdate
from repro_torch.experiments.environments import (
    Environment,
    RoundObservation,
    SampledSimulatedEnvironment,
    SimulatedEnvironment,
    build_environment,
)
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
    "RoundObservation", "TopologyUpdate", "build_environment",
    "ScenarioSpec", "PoolProfile", "ScheduledEvent", "PSpeedDrift",
    "ClientChurn", "ClientJoin", "ClientLeave",
    "StragglerSpike", "LatencyNoise",
    "get_scenario", "list_scenarios", "register_scenario",
]
