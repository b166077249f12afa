"""Public kernel entry points of the port with natural shapes.

The port of ``repro.kernels.ops`` (FedAvg, fused AdamW, flash attention
and the RG-LRU scan). There is no
``use_pallas`` switch: a CUDA tensor always goes through the
hand-written kernel and a CPU tensor through its plain torch version
(the choice is the tensor's device, made in the kernel modules). Nothing
is padded: the attention and scan kernels mask their own ragged edges.
Unlike the reference's ``fused_adamw``, which concatenates the tree on
every call, the port's takes buffers that are already flat and updates
them in place (``optim.adamw`` keeps params, grads and moments flat).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import fedavg as _fedavg_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import fused_adamw as _adamw_kernel
from repro_torch.kernels import rglru as _rglru_kernel
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention, (B, Hq, S, hd) x (B, Hkv, S, hd) -> (B, Hq, S, hd)."""
    return _flash_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window, scale=scale)


def rglru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gated linear recurrence h_t = a_t h_{t-1} + u_t over (B, T, D)."""
    return _rglru_kernel.rglru_scan(a, u)


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, lr, bc1, bc2, *, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1):
    """Fused AdamW over flat 1-D buffers, in place: (p, m, v)."""
    return _adamw_kernel.fused_adamw(p, g, m, v, lr, bc1, bc2, b1=b1, b2=b2,
                                     eps=eps, wd=wd)
