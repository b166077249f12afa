"""Public kernel entry points of the port with natural shapes.

The port of the FedAvg half of ``repro.kernels.ops``. There is no
``use_pallas`` switch: a CUDA tensor always goes through the hand-written
kernel and a CPU tensor through its plain torch version (the choice is
the tensor's device, made in :mod:`repro_torch.kernels.fedavg`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import fedavg as _fedavg_kernel
from repro_torch.utils.trees import flatten_tree, tree_layout, unflatten_tree


def fedavg(stacked: torch.Tensor, weights) -> torch.Tensor:
    """Weighted sum over the leading client dim: (K, N), (K,) -> (N,)."""
    w = torch.as_tensor(np.asarray(weights, np.float32)) \
        if not isinstance(weights, torch.Tensor) else weights.float()
    return _fedavg_kernel.fedavg(stacked, w)


def fedavg_tree(trees, weights):
    """FedAvg over a list of trees via one fused flat reduction.

    Packs every tree into one row of a (K, N_total) stack, runs the
    (K, N) kernel once, and hands back a tree of views into the (N,)
    result — one pass over the whole model instead of one launch per
    leaf. As in the reference, the weights are first rounded to the
    trees' dtype.
    """
    layout = tree_layout(trees[0])
    first = flatten_tree(trees[0], layout)
    stacked = torch.empty((len(trees), layout.numel), dtype=first.dtype,
                          device=first.device)
    stacked[0] = first
    for i, t in enumerate(trees[1:], start=1):
        flatten_tree(t, layout, out=stacked[i])
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(stacked.dtype)
    return unflatten_tree(fedavg(stacked, w.float()), layout)
