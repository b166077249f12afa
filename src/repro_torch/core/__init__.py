"""Flag-Swap core: the paper's contribution, ported.

- ``Hierarchy``: the SDFL aggregation tree (eq. 5) and placement algebra.
- ``ClientPool``: simulated client attributes (Sec. IV-A).
- ``CostModel``: TPD (eqs. 6-7), scalar + swarm-vectorized on a device;
  ``TwoTierCostModel`` adds pod edge costs.
- ``FlagSwapPSO``: the black-box integer PSO (eqs. 1-4, Algorithm 1).
- placement strategies: pso / pso-adaptive / random / uniform / ga / sa /
  cem / greedy / exhaustive / static — all registered in the typed
  strategy registry (``create_strategy``).
"""
from repro_torch.core.cost_model import CostModel, TwoTierCostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.placement import (
    AdaptivePSOPlacement,
    CEMPlacement,
    ExhaustivePlacement,
    GAPlacement,
    GreedySpeedPlacement,
    PlacementStrategy,
    PSOPlacement,
    RandomPlacement,
    SimulatedAnnealingPlacement,
    StaticPlacement,
    UniformRoundRobinPlacement,
)
from repro_torch.core.pso import FlagSwapPSO, SwarmHistory
from repro_torch.core.registry import (
    StrategyInfo,
    build_config,
    create_strategy,
    list_strategies,
    register_strategy,
    resolve_strategy,
    strategy_names,
)
from repro_torch.core.state import params_from_numpy, params_to_numpy, pool_from_numpy, swarm_from_state

__all__ = [
    "Hierarchy", "ClientPool", "CostModel", "TwoTierCostModel",
    "FlagSwapPSO", "SwarmHistory", "pool_from_numpy", "swarm_from_state",
    "params_from_numpy", "params_to_numpy",
    "StrategyInfo", "build_config", "create_strategy", "list_strategies",
    "register_strategy", "resolve_strategy", "strategy_names",
    "PlacementStrategy", "RandomPlacement", "UniformRoundRobinPlacement",
    "PSOPlacement", "AdaptivePSOPlacement", "GAPlacement",
    "SimulatedAnnealingPlacement", "CEMPlacement", "GreedySpeedPlacement",
    "ExhaustivePlacement", "StaticPlacement",
]
