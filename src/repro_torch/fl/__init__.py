"""Federated-learning layer of the port: hierarchy ladders, FedAvg
aggregation (flat, hierarchical, per-level segment kernels) and the
round orchestrator of the emulated track."""
from repro_torch.fl.aggregation import (
    SegmentAggregator,
    batched_hierarchical_fedavg,
    fedavg,
    hierarchical_fedavg,
)
from repro_torch.fl.distributed import choose_fl_hierarchy, elastic_rehierarchize
from repro_torch.fl.orchestrator import FederatedOrchestrator, FederatedRunResult, RoundRecord

__all__ = ["choose_fl_hierarchy", "elastic_rehierarchize", "fedavg",
           "hierarchical_fedavg", "SegmentAggregator",
           "batched_hierarchical_fedavg", "FederatedOrchestrator",
           "FederatedRunResult", "RoundRecord"]
