"""Optimizers of the port (``repro.optim.optimizers``).

An ``Optimizer`` is a pair of functions over param trees, as in the
reference:

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

Where the port departs, for memory. The reference's update is pure;
here ``adamw`` keeps the first and second moments as two flat float32
buffers (``state.mu`` and ``state.nu`` are trees of views into them)
and updates params, moments and the step in one launch of the fused
AdamW kernel (``kernels.ops.fused_adamw``) over the whole model. When
the params and grads are already views of one flat buffer each (as the
train step of ``models.api`` keeps them) that update is in place: the
returned params are the same views, now updated, and the grads buffer
is clipped in place. Any other tree is first packed into a new buffer,
and the returned params are views of it. The learning rate and the bias
corrections are host float32 values (the step count lives on the
host), passed to the kernel by value. ``sgd`` stays leaf by leaf in
torch ops, as the reference has it; without momentum it too updates
params that view one flat buffer in place (the same ops, written back
leaf by leaf), so a federated rank holds one copy of its model.

Sharded params. Over a rank mesh each rank holds shards of the params
and their gradients; the clip must read the global norm, as the
reference's (one program over every shard) does. ``update`` takes
``shards=(pspecs, mesh)``, the specs of the rank's leaves on its
``launch.mesh.RankMesh``; the norm is then
``utils.trees.sharded_global_norm`` (each leaf summed over the axes
that split it, once over those that replicate it), the same on every
rank. ``models.api.make_train_step`` passes it for a model whose policy
shards params. Without it the norm is the rank's own, as before.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.trees import (
    flat_buffer_of,
    flatten_tree,
    sharded_global_norm,
    tree_global_norm,
    tree_layout,
    tree_leaves,
    tree_map,
    unflatten_tree,
)

ScheduleOrFloat = Union[float, Callable]


class OptState(NamedTuple):
    step: torch.Tensor   # 0-dim int32 on the host
    mu: Any              # first moment (or momentum); () for sgd without
    nu: Any              # second moment; () for sgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _lr_at(lr: ScheduleOrFloat, step: int) -> np.float32:
    return np.float32(lr(step) if callable(lr) else lr)


def _host_step(step: int) -> torch.Tensor:
    return torch.tensor(step, dtype=torch.int32)


def _f32(x) -> float:
    """``x`` rounded to float32, as JAX rounds a weak Python scalar."""
    return float(np.float32(x))


def global_norm(grads, shards=None) -> torch.Tensor:
    """The gradients' global norm: of the tree itself, or, with
    ``shards=(pspecs, mesh)``, of the global tree whose shards it holds
    (:func:`~repro_torch.utils.trees.sharded_global_norm`)."""
    if shards is None:
        return tree_global_norm(grads)
    return sharded_global_norm(grads, *shards)


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm); the
    scaled grads are float32, as the reference's promotion makes them.
    ``shards`` as :func:`global_norm`."""
    norm = global_norm(grads, shards)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _flat(tree, layout):
    """(buffer, tree): the flat buffer ``tree`` already views, or a new
    packed copy and the views into it."""
    flat = flat_buffer_of(tree, layout)
    if flat is not None:
        return flat, tree
    flat = flatten_tree(tree, layout)
    return flat, unflatten_tree(flat, layout)


def adamw(lr: ScheduleOrFloat = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    """AdamW with decoupled weight decay and optional global-norm
    clipping, one fused kernel launch per step over the whole model.

    Moments are float32 whatever the param dtype (bf16 compute, f32
    master state); a grad has its param's dtype.
    """

    def init(params) -> OptState:
        layout = tree_layout(params)
        dev = tree_leaves(params)[0].device
        m = torch.zeros(layout.numel, dtype=torch.float32, device=dev)
        v = torch.zeros(layout.numel, dtype=torch.float32, device=dev)
        return OptState(step=_host_step(0), mu=unflatten_tree(m, layout),
                        nu=unflatten_tree(v, layout))

    def update(params, grads, state: OptState, shards=None):
        layout = tree_layout(params)
        with torch.no_grad():
            flat_p, params = _flat(params, layout)
            flat_g, grads = _flat(grads, layout)
            flat_m, mu = _flat(state.mu, layout)
            flat_v, nu = _flat(state.nu, layout)
            if grad_clip is not None:
                norm = torch.linalg.vector_norm(flat_g, dtype=torch.float32) \
                    if shards is None else sharded_global_norm(grads, *shards)
                flat_g.mul_(torch.clamp(grad_clip / (norm + 1e-9), max=1.0))
            step = int(state.step) + 1
            t = np.float32(step)
            bc1 = np.float32(1.0) - np.float32(b1) ** t
            bc2 = np.float32(1.0) - np.float32(b2) ** t
            ops.fused_adamw(flat_p, flat_g, flat_m, flat_v, _lr_at(lr, step),
                            bc1, bc2, b1=b1, b2=b2, eps=eps, wd=weight_decay)
        return params, OptState(step=_host_step(step), mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(lr: ScheduleOrFloat = 1e-2, momentum: float = 0.0,
        grad_clip: Optional[float] = None) -> Optimizer:
    """SGD with optional (heavy-ball) momentum, leaf by leaf in torch
    ops; returns new params, except that without momentum params viewing
    one flat buffer are updated in place and returned (the FL clients'
    local step keeps its own in-place SGD in ``fl.orchestrator``)."""

    def init(params) -> OptState:
        # momentum-free SGD carries no per-param state
        mu = () if momentum == 0.0 else tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return OptState(step=_host_step(0), mu=mu, nu=())

    def update(params, grads, state: OptState, shards=None):
        with torch.no_grad():
            if grad_clip is not None:
                grads, _ = clip_by_global_norm(grads, grad_clip, shards)
            step = int(state.step) + 1
            lr_t = float(_lr_at(lr, step))
            if momentum == 0.0:
                def step_leaf(p, g):
                    return (p.float() - lr_t * g.float()).to(p.dtype)

                if flat_buffer_of(params) is not None:
                    for p, g in zip(tree_leaves(params), tree_leaves(grads),
                                    strict=True):
                        p.copy_(step_leaf(p, g))
                    new_p = params
                else:
                    new_p = tree_map(step_leaf, params, grads)
                return new_p, OptState(step=_host_step(step), mu=(), nu=())
            mom = _f32(momentum)
            new_m = tree_map(lambda m, g: mom * m + g.float(), state.mu,
                             grads)
            new_p = tree_map(lambda p, m: (p.float() - lr_t * m).to(p.dtype),
                             params, new_m)
        return new_p, OptState(step=_host_step(step), mu=new_m, nu=())

    return Optimizer(init=init, update=update)
