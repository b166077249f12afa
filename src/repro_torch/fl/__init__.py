"""Federated-learning layer of the port: hierarchy ladders, FedAvg
aggregation (flat, hierarchical, per-level segment kernels, grouped
collectives over a rank mesh), the distributed round step and the round
orchestrator of the emulated track."""
from repro_torch.fl.aggregation import (
    AggregationPlan,
    SegmentAggregator,
    batched_hierarchical_fedavg,
    fedavg,
    flat_psum,
    hierarchical_fedavg,
    hierarchical_psum,
)
from repro_torch.fl.distributed import (
    FLTrainStep,
    choose_fl_hierarchy,
    elastic_rehierarchize,
    shard_rows,
)
from repro_torch.fl.orchestrator import FederatedOrchestrator, FederatedRunResult, RoundRecord

__all__ = ["choose_fl_hierarchy", "elastic_rehierarchize", "fedavg",
           "hierarchical_fedavg", "SegmentAggregator", "AggregationPlan",
           "hierarchical_psum", "flat_psum", "FLTrainStep", "shard_rows",
           "batched_hierarchical_fedavg", "FederatedOrchestrator",
           "FederatedRunResult", "RoundRecord"]
