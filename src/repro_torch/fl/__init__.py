"""Federated-learning layer of the port (hierarchy ladders so far)."""
from repro_torch.fl.distributed import choose_fl_hierarchy, elastic_rehierarchize

__all__ = ["choose_fl_hierarchy", "elastic_rehierarchize"]
