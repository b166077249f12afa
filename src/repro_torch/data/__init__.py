"""Synthetic data of the port: the classification set and its
federated partitions, and the LM token streams."""
from repro_torch.data.synthetic import (
    FederatedDataset,
    FederatedLMDataset,
    SyntheticClassificationDataset,
    SyntheticLMDataset,
    dirichlet_partition,
    make_federated_dataset,
)

__all__ = ["SyntheticClassificationDataset", "SyntheticLMDataset", "FederatedDataset",
           "FederatedLMDataset",
           "dirichlet_partition", "make_federated_dataset"]
