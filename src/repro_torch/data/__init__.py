"""Synthetic federated data of the port (the classification set)."""
from repro_torch.data.synthetic import (
    FederatedDataset,
    SyntheticClassificationDataset,
    dirichlet_partition,
    make_federated_dataset,
)

__all__ = ["SyntheticClassificationDataset", "FederatedDataset",
           "dirichlet_partition", "make_federated_dataset"]
