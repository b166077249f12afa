"""The paper's technique as a distributed training step, and the
hierarchy ladders of the elastic tracks.

The port of ``repro.fl.distributed``. Mapping SDFL onto a mesh of ranks
(:class:`~repro_torch.launch.mesh.RankMesh`, one process a rank):

* Every FL **client owns a slice of the data axis**: ``n_devices /
  n_clients`` ranks, each holding a whole replica of the client's model
  (the reference's client dim sharded over ``[pod,] data``). With one
  rank a client, local training touches no other rank; with several,
  they split the client's batch and average their gradients each step
  (data parallelism inside the client, what GSPMD gives the reference).
* One FL round = ``local_steps`` local updates, then **hierarchical
  aggregation along the placement tree**: one grouped all-reduce per
  tree level (``aggregation.hierarchical_psum``) on the flat parameter
  buffer. The placement decides the groups.
* The flat baseline (CFL) is the same round with one ungrouped
  all-reduce (``aggregation.flat_psum``); mode ``"none"`` skips it.

Multi-pod: each pod hosts its own client set (the same per-pod
placement); the top of the tree is a mean across the ``pod`` axis.

Tensor-parallel clients (the reference's ``_fl_train_bundle``: a
policy with ``model_axis`` and optionally ``seq_axis``, no batch or fsdp
axes) on a ``([pod,] data, model)`` mesh: a client is the model-axis
group at its data coordinates, each rank holding its shards of the
client's params (``Model.init`` cuts the one seeded init) and running
the local steps through its family's tensor parallelism
(``models/transformer_tp.py`` for the dense and vlm decoders,
``rglru_tp.py`` for the hybrid, ``encdec_tp.py`` for the audio
family). The psums reduce each rank's flat
buffer of shards along the data axis at its model coordinate
(``RankMesh.subgroup``'s lines), so every shard of the aggregate is the
same along the data axis.

Without a mesh (``model.policy.mesh is None``) the round is the host
path: every client's replica on one device, trained one client at a
time, then the flat weighted FedAvg (one launch of the FedAvg kernel on
the card), the oracle the rank path is held to.

``stacked_param_pspecs`` gives the reference's specs of the
client-stacked tree (the client dim over the pod and data axes, the
model axis kept). ``shard_rows`` row-shards a batched evaluator over a
single controller's devices (the sweep runner's device-sharded pooled
TPD).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.fl.aggregation import AggregationPlan, flat_psum, hierarchical_psum
from repro_torch.kernels import ops
from repro_torch.launch.mesh import COLLECTIVE_CHUNK
from repro_torch.models.api import Model, flat_params, make_train_step
from repro_torch.models.sharding import PartitionSpec, check_runnable
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.trees import (
    flat_buffer_of,
    flatten_tree,
    is_view_of,
    tree_layout,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    unflatten_tree,
)

_MODES = ("hierarchical", "flat", "none")


class FLTrainStep:
    """Builder for the federated round step of any zoo ``Model``.

    On a rank mesh (``model.policy.mesh``), each rank holds its own
    client's params (a flat tree) and optimizer state. Without one, the
    host path holds every client's params as a *client-stacked* tree:
    every leaf with a leading ``n_clients_total`` dim, views of one
    ``(C, N)`` buffer.
    """

    def __init__(self, model: Model, optimizer: Optimizer,
                 hierarchy: Hierarchy, placement: Sequence[int], *,
                 weights: Optional[Sequence[float]] = None,
                 local_steps: int = 1, mode: str = "hierarchical"):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; use one of {_MODES}")
        self.model = model
        self.optimizer = optimizer
        self.hierarchy = hierarchy
        self.placement = np.asarray(placement, np.int64)
        self.local_steps = local_steps
        self.mode = mode
        self.mesh = model.policy.mesh
        if self.mesh is not None:
            self.n_pods = self.mesh.shape.get("pod", 1)
            self.data_size = self.mesh.shape.get("data", 1)
        else:
            self.n_pods = 1
            self.data_size = hierarchy.total_clients  # host path: 1 dev/client
        self.clients_per_pod = hierarchy.total_clients
        self.n_clients_total = self.clients_per_pod * self.n_pods
        self.plan = AggregationPlan.build(
            hierarchy, self.placement, self.data_size, weights)
        self.ranks_per_client = self.data_size // self.clients_per_pod

    # ------------------------------------------------------------------
    @property
    def client_axes(self):
        if self.mesh is None:
            return None
        axes = tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)
        return axes if axes else None

    def stacked_param_pspecs(self):
        """Per-leaf specs of the client-stacked tree: the leading client
        dim over (pod, data); the other dims keep the model-axis splits
        of the model's spec rule, and a data or pod axis there resolves
        to None (client replicas exclude data-axis FSDP)."""
        c = self.client_axes

        def stackspec(path, x, spec):
            parts = [c]
            for s in spec:
                if s in ("data", "pod") or (isinstance(s, tuple) and any(
                        a in ("data", "pod") for a in s)):
                    parts.append(None)
                else:
                    parts.append(s)
            return PartitionSpec(*parts)

        return tree_map_with_path(stackspec, self.model.param_shapes(),
                                  self.model.param_pspecs())

    @property
    def client_index(self) -> int:
        """This rank's client in the ``n_clients_total`` order (pod-major,
        as the reference's stacked client dim)."""
        d = self.mesh.axis_index("data")
        pod = self.mesh.axis_index("pod") if "pod" in self.mesh.shape else 0
        return pod * self.clients_per_pod + int(self.plan.client_of_device[d])

    def init_stacked(self, generator: torch.Generator, device=None):
        """(params, opt_state), every client starting from one init.

        Host path: the client-stacked tree and a list of one optimizer
        state a client, on ``device`` (default ``cuda``). Rank path: this
        rank's client's flat params and state, on the mesh's device;
        every rank draws from the same seeded ``generator`` (on that
        device) and keeps its shards of it under a model axis, and a
        checksum all-reduce over the client axes asserts that the
        clients start bit-equal.
        """
        self._check_clients()
        if self.mesh is not None:
            params = flat_params(self.model.init(
                generator, device if device is not None else self.mesh.device))
            _assert_replicas_equal(flat_buffer_of(params), self._replica_groups())
            return params, self.optimizer.init(params)
        params = self.model.init(generator,
                                 device if device is not None else "cuda")
        layout = tree_layout(params)
        leaf = tree_leaves(params)[0]
        stack = torch.empty((self.n_clients_total, layout.numel),
                            dtype=leaf.dtype, device=leaf.device)
        flatten_tree(params, layout, out=stack[0])
        del params
        stack[1:] = stack[0]
        states = [self.optimizer.init(_client_params(stack, layout, c))
                  for c in range(self.n_clients_total)]
        return unflatten_tree(stack, layout), states

    # ------------------------------------------------------------------
    def make_round_fn(self):
        """``(params, opt_state, batch, stats=None) -> (params, opt_state,
        metrics)``; the params are updated in place and returned.

        Host path: ``batch`` leaves are ``(n_clients_total,
        per_client_batch, ...)``. Rank path: ``batch`` is this rank's
        client's batch (``per_client_batch, ...``); a client's ranks take
        equal slices of it. ``stats``, a list, receives the round's
        split: the local steps' and each aggregation step's host-clock
        milliseconds (the card synchronised), and each collective's
        bytes and group size.
        """
        self._check_clients()
        return self._host_round if self.mesh is None else self._rank_round

    def _check_clients(self) -> None:
        """The round step runs whole clients: a rank holds a client's
        model (replicas), or its shards over a model axis (and seq
        axis) for the dense, vlm, hybrid and audio families; the other
        families under a model axis raise naming their ROADMAP.md item
        (``check_runnable``). Batch and fsdp axes would split a
        client's batch or params across clients; the reference's
        federated bundle sets neither."""
        policy = self.model.policy
        if policy.mesh is None or policy.replicas_only:
            return
        check_runnable(policy, self.model.config.family)
        if policy.batch_axes or policy.fsdp_axes:
            raise ValueError(
                "federated clients split over a model axis take a policy "
                "with batch_axes=None and fsdp_axes=None (a client is a "
                f"data-axis slice); got {policy}")

    def _replica_groups(self) -> list:
        """The process groups the clients' replicas span: the whole world
        for whole replicas, else the client axes' lines at this rank's
        model coordinate."""
        if self.model.policy.replicas_only:
            return [None]
        return [self.mesh.axis_group(a) for a in self.client_axes
                if self.mesh.shape[a] > 1]

    def _local_round(self, train_step, params, opt_state, batch):
        loss = None
        for _ in range(self.local_steps):
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = metrics["loss"]
        return params, opt_state, loss

    def _host_round(self, params_stacked, opt_states, batch_stacked,
                    stats: Optional[list] = None):
        t0 = time.perf_counter()
        layout = tree_layout(params_stacked, lead=1)
        stack = flat_buffer_of(params_stacked, layout, lead=1)
        if stack is None:
            stack = flatten_tree(params_stacked, layout, lead=1)
        train_step = make_train_step(self.model, self.optimizer)
        losses, states = [], []
        for c in range(self.n_clients_total):
            batch = {k: v[c] for k, v in batch_stacked.items()}
            params, state, loss = self._local_round(
                train_step, _client_params(stack, layout, c), opt_states[c],
                batch)
            if not is_view_of(params, stack[c], layout):
                flatten_tree(params, layout, out=stack[c])
            losses.append(loss)
            states.append(state)
        _timed(stats, "local steps", stack, t0)
        if self.mode != "none":
            t0 = time.perf_counter()
            with torch.no_grad():
                # the tree-equivalent weighted FedAvg: the plan has one
                # device a client, so weight_of_device is each client's
                # weight (rounded to the params' dtype, as the reference)
                w = torch.as_tensor(self.plan.weight_of_device).to(
                    stack.dtype).float()
                stack.copy_(ops.fedavg(stack, w).expand_as(stack))
            _timed(stats, "fedavg", stack, t0)
        return (unflatten_tree(stack, layout), states,
                {"loss": torch.stack(losses).mean()})

    def _rank_round(self, params, opt_state, batch,
                    stats: Optional[list] = None):
        t0 = time.perf_counter()
        per = self.ranks_per_client
        optimizer = self.optimizer
        if per > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % per:
                raise ValueError(f"a client's batch of {rows} rows does "
                                 f"not split over its {per} ranks")
            j, b = self.mesh.axis_index("data") % per, rows // per
            batch = {k: v[j * b:(j + 1) * b] for k, v in batch.items()}
            optimizer = self._client_mean_grads()
        params, opt_state, loss = self._local_round(
            make_train_step(self.model, optimizer), params, opt_state, batch)
        _timed(stats, "local steps", loss, t0)
        pod_axis = "pod" if "pod" in self.mesh.shape else None
        if self.mode == "hierarchical":
            params = hierarchical_psum(params, self.plan, self.mesh, "data",
                                       pod_axis, stats=stats)
        elif self.mode == "flat":
            params = flat_psum(params, self.plan, self.mesh, "data",
                               pod_axis, stats=stats)
        # the mean loss over clients: equal slices, so over every rank
        loss = loss.detach().float().reshape(1).clone()
        dist.all_reduce(loss)
        return params, opt_state, {"loss": loss[0] / dist.get_world_size()}

    def _client_mean_grads(self) -> Optimizer:
        """The optimizer with each step's gradients first averaged over
        this client's ranks (one chunked all-reduce of the flat grads)."""
        per, mesh, inner = self.ranks_per_client, self.mesh, self.optimizer
        group = mesh.subgroup("data", self.plan.client_groups)

        def update(params, grads, state, **kw):
            flat = flat_buffer_of(grads)
            with torch.no_grad():
                mesh.all_reduce(flat, group)
                flat.div_(per)
            return inner.update(params, grads, state, **kw)

        return Optimizer(init=inner.init, update=update)

    # ------------------------------------------------------------------
    def batch_shape(self, shape_cfg) -> dict:
        """Per-client batch split of a global shape."""
        per = shape_cfg.global_batch // self.n_clients_total
        return {"per_client_batch": max(per, 1),
                "n_clients": self.n_clients_total}


def _client_params(stack: torch.Tensor, layout, c: int):
    """Row ``c`` of the client stack as a flat param tree: leaf views
    requiring grad, which the train step updates in place."""
    return tree_map(lambda x: x.detach().requires_grad_(),
                    unflatten_tree(stack[c], layout))


def _timed(stats: Optional[list], step: str, like: torch.Tensor,
           t0: float) -> None:
    if stats is None:
        return
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    stats.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3})


_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def bits_checksum(flat: torch.Tensor) -> torch.Tensor:
    """The int64 sum of a 1-D buffer's raw bit patterns, a (1,) tensor on
    its device (summed in chunks: no int64 copy of the buffer)."""
    bits = flat.detach().view(_BITS[flat.element_size()])
    check = torch.zeros(1, dtype=torch.int64, device=flat.device)
    for off in range(0, bits.numel(), COLLECTIVE_CHUNK):
        check += bits[off:off + COLLECTIVE_CHUNK].sum(dtype=torch.int64)
    return check


def _assert_replicas_equal(flat: torch.Tensor, groups=(None,)) -> None:
    """Every rank of ``groups`` (process groups reduced over in turn;
    None the world) holds the same bits: :func:`bits_checksum`,
    all-reduced by MIN and by MAX, must agree."""
    check = bits_checksum(flat)
    lo, hi = check.clone(), check.clone()
    for group in groups:
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if int(lo) != int(hi):
        raise RuntimeError(f"ranks start from different params (bit "
                           f"checksums {int(lo)} to {int(hi)})")


# the historical preference ladder (deeper trees first) and, above it,
# the swarm-scale rungs the elastic environments opt into
_BASE_LADDER = ((3, 2, 2), (3, 2, 1), (2, 3, 4), (2, 3, 3),
                (2, 2, 4), (2, 2, 2), (2, 2, 1))
_SCALE_LADDER = ((6, 4, 2), (6, 3, 2), (5, 3, 2), (4, 3, 2),
                 (4, 2, 2)) + _BASE_LADDER


def choose_fl_hierarchy(n_clients: int, *, scale: bool = False) -> Hierarchy:
    """Pick a depth/width whose minimum client count fits ``n_clients``.

    Preference order: deeper trees first (more interesting schedules).
    Extra clients beyond the minimum become additional trainers (the
    round-robin assignment absorbs them).

    ``scale=True`` extends the ladder with the swarm-scale rungs
    (depth-4 .. depth-6, the large-1k/large-10k tree shapes) so a large
    population keeps a proportionate tree instead of collapsing onto
    the 7-slot depth-3 one — this is what the elastic environments use
    to re-hierarchize a GROWING population (a flash crowd climbs
    depth-2 -> -3 -> -4 as it crosses each rung's minimum). The default
    keeps the historical small-cluster ladder.
    """
    for depth, width, tpl in (_SCALE_LADDER if scale else _BASE_LADDER):
        if Hierarchy(depth, width, tpl).min_clients <= n_clients:
            return Hierarchy(depth=depth, width=width, trainers_per_leaf=tpl,
                             n_clients=n_clients)
    return Hierarchy(depth=1, width=1, trainers_per_leaf=1,
                     n_clients=max(n_clients, 2))


def elastic_rehierarchize(old: Hierarchy, n_clients: int,
                          capacity: int) -> tuple:
    """THE capacity-window re-hierarchization rule of the elastic tracks.

    Returns ``(new_hierarchy, new_capacity)`` for a population that just
    resized to ``n_clients`` under a tree previously allowed to carry up
    to ``capacity`` clients. Outside the window ``[old.min_clients,
    capacity]`` the structure is rebuilt through
    :func:`choose_fl_hierarchy` (scale ladder) and the capacity re-pins
    to the new tree's bound; inside it, the same tree shape is kept and
    only ``n_clients`` is re-pinned (cheaper migration, identity
    ``slot_remap``). Deterministic — no rng is consumed.
    """
    if n_clients < old.min_clients or n_clients > capacity:
        new = choose_fl_hierarchy(n_clients, scale=True)
        return new, max(new.max_clients, n_clients)
    return Hierarchy(depth=old.depth, width=old.width,
                     trainers_per_leaf=old.trainers_per_leaf,
                     n_clients=n_clients), capacity


def shard_rows(fn, mesh, n_rows: int, axis: str = "rows"):
    """Row-shard a batched evaluator across the devices of ``mesh``.

    ``mesh`` is a 1-D :class:`~repro_torch.launch.mesh.DeviceMesh` over
    ``axis`` (one process drives every shard; the devices may repeat one
    card). ``fn`` maps per-row tensors ``(rows, ...)`` on one device to
    per-row outputs ``(rows,)`` on it. The returned callable splits
    every input along dim 0 into one equal shard a mesh entry, runs
    ``fn`` on each shard on its device, and merges with the segment-sum
    trick the aggregation plans use: each shard is scattered into the
    zeros of the full ``(total,)`` output at its global row offsets, and
    the disjoint segments are added on the first device (the reference's
    ``psum``), in ``fn``'s dtype (float64 for the exact TPD).

    ``n_rows`` not divisible by the shard count is handled by padding
    with copies of row 0 (computed and discarded, so every shard has one
    shape).
    """
    if mesh.axis_names != (axis,):
        raise ValueError(f"shard_rows takes a 1-D ({axis!r},) mesh, got "
                         f"{mesh.axis_names}")
    ndev = mesh.shape[axis]
    pad = (-n_rows) % ndev
    total = n_rows + pad
    shard = total // ndev

    def run(*arrays):
        arrays = [torch.as_tensor(a) for a in arrays]
        if pad:
            arrays = [torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
                      for a in arrays]
        out = None
        for i, dev in enumerate(mesh.devices):
            rows = slice(i * shard, (i + 1) * shard)
            vals = fn(*(a[rows].to(dev) for a in arrays))      # (shard,)
            idx = torch.arange(rows.start, rows.stop, device=dev)
            seg = torch.zeros(total, dtype=vals.dtype, device=dev) \
                .index_add_(0, idx, vals).to(mesh.devices[0])
            out = seg if out is None else out + seg
        return out[:n_rows]

    return run
