"""The Model interface of the port.

A ``Model`` is a bundle of plain functions over a plain-dict param tree
in the reference's layout (``repro.models.api.Model``): the FL layer and
the serving scheduler program against this interface only. ``policy``
is the model's sharding policy (``fl.distributed.FLTrainStep`` reads its
rank mesh); ``spec_rule`` and ``state_spec_rule`` map a leaf's path and
global shape to its :class:`~repro_torch.models.sharding.PartitionSpec`,
and :meth:`Model.param_pspecs` and :meth:`Model.state_pspecs` apply them
to the whole tree, its shapes built on the meta device
(:meth:`Model.param_shapes`: nothing is allocated, at any size).

Under a model axis (``models/tensor_parallel.py``) ``init`` draws this
rank's shards, the functions take and return local shards, and
``unsharded`` is the same model without the axis (the global init and
decode state, whose shapes the spec rules read).

A client dim. The batched round engine trains every client at once: it
hands the loss a client-stacked param tree and batch (a leading ``C``
dim on every leaf) and takes the gradient of the summed losses, so each
loss must keep that dim. The MLP does so natively (its products become
batched products); the language-model families get it from
:func:`per_client_loss`, which runs the family's one-client loss on each
client's slice, as the reference's ``jax.vmap`` does.

The train step keeps the reference's contract, ``(params, opt_state,
batch) -> (params, opt_state, metrics)``, but not its copies: the params
are views of one flat buffer (:func:`flat_params`), each leaf's ``.grad``
a view of one flat grad buffer zeroed once per step, so ``backward()``
accumulates in place and the optimizer (``optim.adamw``: one fused
kernel launch) updates in place the very tensors the model reads. No
step copies the tree; a tree that is not yet flat is packed once, on
its first step.

Over a rank mesh whose policy shards the params (a model, seq or fsdp
axis), the step runs on the rank's own flat buffer of shards: the
model's functions place the collectives, and the optimizer's clip
reads the global norm (``shards=(param_pspecs, mesh)``, see
``optim.optimizers``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import UNSHARDED, PartitionSpec, ShardingPolicy
from repro_torch.utils.trees import (
    flat_buffer_of,
    flatten_tree,
    tree_flatten,
    tree_layout,
    tree_leaves,
    tree_map_with_path,
    tree_stack,
    tree_unstack,
    unflatten_tree,
)


@dataclass
class Model:
    config: ModelConfig
    # (generator, device) -> params, drawn on the generator's device; a
    # CPU torch.Generator gives the same params on every device
    init: Callable[[torch.Generator, Any], Any]
    # (params, batch) -> (loss, metrics); with a leading client dim on
    # the params and the batch, the loss and metrics keep that dim
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Any]
    # (params, batch) -> (last_logits, decode_state)
    prefill_fn: Optional[Callable] = None
    # (params, state, batch) -> (logits, state)
    decode_fn: Optional[Callable] = None
    # (batch_size, cache_len, device) -> a zero decode state
    init_decode_state: Optional[Callable] = None
    policy: ShardingPolicy = UNSHARDED
    # (path str, global shape) -> PartitionSpec of a param leaf
    spec_rule: Optional[Callable] = None
    # (path str, global shape) -> PartitionSpec of a decode-state leaf
    state_spec_rule: Optional[Callable] = None
    # the model without its model axis (None: this one holds whole leaves)
    unsharded: Optional["Model"] = None

    # ------------------------------------------------------------------
    def param_shapes(self):
        """The global param tree on the meta device (shapes and dtypes,
        no storage; the init's draws are skipped)."""
        return (self.unsharded or self).init(None, "meta")

    def param_pspecs(self):
        """A tree of PartitionSpec mirroring the params (by spec_rule)."""
        rule = self.spec_rule or (lambda path, shape: PartitionSpec())
        return tree_map_with_path(lambda path, x: rule(path, tuple(x.shape)),
                                  self.param_shapes())

    def state_pspecs(self, batch_size: int, cache_len: int):
        """A tree of PartitionSpec mirroring the decode state (None
        without a decode step); a Python scalar leaf has shape ()."""
        model = self.unsharded or self
        if model.init_decode_state is None:
            return None
        rule = self.state_spec_rule or (lambda path, shape: PartitionSpec())
        return tree_map_with_path(
            lambda path, x: rule(path, tuple(getattr(x, "shape", ()))),
            model.init_decode_state(batch_size, cache_len, "meta"))


def per_client_loss(loss_fn):
    """A language model's ``loss_fn`` (one client's params and batch ->
    (loss, metrics)) given the Model contract's client dim: when
    ``batch["tokens"]`` is (C, B, S), params and batch carry a leading
    client dim C, and the loss runs on each client's slice (one
    ``unbind`` per leaf), its losses and metrics stacked to (C,). On
    (B, S) tokens it is ``loss_fn`` itself."""

    def loss(params, batch):
        if batch["tokens"].dim() == 2:
            return loss_fn(params, batch)
        outs = [loss_fn(p, b) for p, b in zip(
            tree_unstack(params), tree_unstack(batch), strict=True)]
        return (torch.stack([out[0] for out in outs]),
                tree_stack([out[1] for out in outs]))

    return loss


def flat_params(params):
    """``params`` packed into one new flat buffer: a tree of leaf views
    into it (``flat.narrow(...).view(shape)``, detached, requiring grad).
    The caller drops the old tree to free it."""
    layout = tree_layout(params)
    with torch.no_grad():
        flat = flatten_tree(params, layout)
    return _leaf_views(flat, layout)


def _leaf_views(flat, layout):
    leaves, rebuild = tree_flatten(unflatten_tree(flat, layout))
    return rebuild([x.detach().requires_grad_() for x in leaves])


def make_train_step(model: Model, optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    params and the optimizer state are updated in place when the params
    are already flat (as returned by an earlier step or by
    :func:`flat_params`)."""
    grads_of = {}          # flat param buffer's address -> flat grads
    policy = model.policy
    sharded = {}
    if policy.mesh is not None and not policy.replicas_only:
        sharded["shards"] = (model.param_pspecs(), policy.mesh)

    def train_step(params, opt_state, batch):
        layout = tree_layout(params)
        flat = flat_buffer_of(params, layout)
        if flat is None or not all(x.requires_grad
                                   for x in tree_leaves(params)):
            params = flat_params(params)
            flat = flat_buffer_of(params, layout)
        grad = grads_of.get(flat.data_ptr())
        if grad is None or grad.numel() != flat.numel() \
                or grad.dtype != flat.dtype:
            grads_of.clear()
            grad = grads_of[flat.data_ptr()] = torch.zeros_like(flat)
        else:
            grad.zero_()
        grads = unflatten_tree(grad, layout)
        for leaf, g in zip(tree_leaves(params), tree_leaves(grads),
                           strict=True):
            leaf.grad = g          # backward() accumulates into the view
        loss, metrics = model.loss_fn(params, batch)
        loss.backward()
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             **sharded)
        metrics = {k: v.detach() for k, v in dict(metrics).items()}
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: Model):
    """(params, state, batch) -> (logits, state): one decode token."""
    if model.decode_fn is None:
        raise ValueError(f"{model.config.name} has no decode step")

    def serve_step(params, state, batch):
        return model.decode_fn(params, state, batch)

    return serve_step


def make_grad_step(model: Model):
    """(params, batch) -> (grads, loss): the FL clients' local step, in
    new tensors; the params are not touched."""

    def grad_step(params, batch):
        leaves, rebuild = tree_flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, _ = model.loss_fn(rebuild(leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return rebuild(list(grads)), loss.detach()

    return grad_step
