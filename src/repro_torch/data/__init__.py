"""Synthetic data of the port: the classification set and its
federated partitions, and the LM token stream."""
from repro_torch.data.synthetic import (
    FederatedDataset,
    SyntheticClassificationDataset,
    SyntheticLMDataset,
    dirichlet_partition,
    make_federated_dataset,
)

__all__ = ["SyntheticClassificationDataset", "SyntheticLMDataset", "FederatedDataset",
           "dirichlet_partition", "make_federated_dataset"]
