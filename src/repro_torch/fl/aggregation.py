"""Aggregation: flat FedAvg, host-level hierarchical FedAvg, and the
paper's aggregation tree as grouped collectives over a mesh of ranks.

The port of ``repro.fl.aggregation``: ``fedavg``,
``hierarchical_fedavg``, ``SegmentAggregator`` and
``batched_hierarchical_fedavg`` on one device; ``AggregationPlan``,
``hierarchical_psum`` and ``flat_psum`` across the ranks of a
:class:`~repro_torch.launch.mesh.RankMesh`, one grouped all-reduce per
tree level (the reference's ``psum`` with ``axis_index_groups``).

Key invariant (property-tested against the reference): for any valid
placement, hierarchical FedAvg over the placement tree == flat weighted
FedAvg. The placement changes *where* partial sums happen (hence the
delay), never the result.

Every level reduction of :class:`SegmentAggregator` is ONE launch of the
FedAvg kernel in its row-indexed form
(:func:`repro_torch.kernels.fedavg.fedavg_rows`; its plain torch version
on the CPU). The aggregator keeps one ``(C + D, N)`` buffer per tree
shape: rows ``0..C-1`` hold the client updates, row ``C + s`` the value
of aggregator slot ``s``. A level reads its clients' rows and its child
slots' rows in place and writes its own slots' rows, so the reference's
per-level ``concatenate`` + gather + ``segment_sum`` needs no copies.
Each cluster still sums ``[host, children...]`` in the reference's
order, with the client weights applied to the client rows inside the
kernel (child rows carry weight 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hierarchy import Hierarchy, RoundPlan
from repro_torch.kernels import ops
from repro_torch.kernels.fedavg import fedavg_rows
from repro_torch.utils.trees import (
    flat_buffer_of,
    flatten_tree,
    is_view_of,
    tree_add,
    tree_layout,
    tree_leaves,
    tree_map,
    unflatten_tree,
)


def fedavg(updates: Sequence, weights: Sequence[float]):
    """Flat weighted FedAvg: sum_i w_i * update_i (weights sum to 1), as
    one flat reduction (one kernel launch on the card)."""
    return ops.fedavg_tree(list(updates), list(weights))


def hierarchical_fedavg(updates: Sequence, weights: Sequence[float],
                        hierarchy: Hierarchy, placement: Sequence[int]):
    """FedAvg computed along the placement tree, bottom-up, in plain
    torch adds — the sequential oracle the segment path is held to.

    Every client's contribution w_i * u_i enters at its position (trainer
    under a leaf aggregator, or aggregator's own update at its level);
    each aggregator sums its buffer; the root's sum is the global model.
    """
    h = hierarchy
    placement = np.asarray(placement, np.int64)
    h.validate_placement(placement)
    weighted = [tree_map(lambda x, w=w: x * float(w), u)
                for u, w in zip(updates, weights, strict=True)]
    trainers = h.trainer_assignment(placement)
    slot_value = [None] * h.dimensions
    for level in range(h.depth - 1, -1, -1):
        for s in range(h.level_starts[level], h.level_starts[level + 1]):
            host = int(placement[s])
            parts = [weighted[host]]
            kids = h.children_slots(s)
            if kids:
                parts.extend(slot_value[k] for k in kids)
            else:
                leaf_idx = s - h.level_starts[h.depth - 1]
                parts.extend(weighted[t] for t in trainers[leaf_idx])
            acc = parts[0]
            for p in parts[1:]:
                acc = tree_add(acc, p)
            slot_value[s] = acc
    return slot_value[0]


class SegmentAggregator:
    """Per-level weighted FedAvg over client-stacked updates — the
    batched round engine's aggregation hot path, one kernel launch per
    tree level, driven by the ``RoundPlan`` index tables.

    ELASTIC: :meth:`retarget` points the aggregator at a new hierarchy
    after a mid-run resize and reports whether the tree shape (the
    per-level cluster counts) moved. What the reference caches per tree
    shape (its compiled executables) is here the ``(C + D, N)`` buffer:
    one per shape, dtype and device, so an elastic run oscillating
    between two trees allocates each once.

    Values handed out by :meth:`client_stack`, :meth:`weighted` and
    :meth:`run_level` are views into that buffer, valid until the next
    call that writes the same rows; the global model returned by
    :meth:`aggregate` and :meth:`aggregate_fused` is a copy.
    """

    def __init__(self, hierarchy: Hierarchy):
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._n_clusters: Optional[list] = None
        self.retarget(hierarchy)

    def retarget(self, hierarchy: Hierarchy) -> bool:
        """Adopt ``hierarchy`` (elastic resize); returns True when the
        tree shape moved, False when it stayed."""
        n_clusters = [
            lp.n_clusters
            for lp in hierarchy.round_plan(
                np.arange(hierarchy.dimensions)).levels]
        changed = n_clusters != self._n_clusters
        self.hierarchy = hierarchy
        self._n_clusters = n_clusters
        return changed

    # ---- the buffer ------------------------------------------------------
    def _buffer(self, layout, dtype, device) -> torch.Tensor:
        h = self.hierarchy
        key = (h.total_clients + h.dimensions, layout.numel, dtype,
               torch.device(device))
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(key[:2], dtype=dtype,
                                                   device=device)
        return buf

    def client_stack(self, template):
        """A ``(C, ...)`` tree of views into the client rows, shaped like
        ``template`` (the global params): local training writes the
        updates here, and the aggregation reads them without a copy."""
        layout = tree_layout(template)
        leaf = tree_leaves(template)[0]
        buf = self._buffer(layout, leaf.dtype, leaf.device)
        return unflatten_tree(buf[:self.hierarchy.total_clients], layout)

    def _load_clients(self, stacked):
        """The buffer with ``stacked`` (C, ...) in its client rows (copied
        in unless it already lives there) and the layout."""
        layout = tree_layout(stacked, lead=1)
        leaf = tree_leaves(stacked)[0]
        buf = self._buffer(layout, leaf.dtype, leaf.device)
        rows = buf[:self.hierarchy.total_clients]
        if not is_view_of(stacked, rows, layout):
            flatten_tree(stacked, layout, lead=1, out=rows)
        return buf, layout

    # ---- levels -------------------------------------------------------------
    def _level_tables(self, idx: int, plan: RoundPlan, weights):
        """(rows (G, K) int32, w (G, K) f32, first output row) of level
        ``idx`` (deepest first). Member j of cluster g sits at column j,
        host first; a client member reads its row with its weight (1
        when ``weights`` is None: the rows are weighted already), a child
        slot's row with weight 1; -1 pads clusters to the common fan-in."""
        h = self.hierarchy
        C = h.total_clients
        lp = plan.levels[idx]
        level = h.depth - 1 - idx
        src = lp.src.astype(np.int64)
        child = src >= C
        # src C + j is the j-th slot of the level below, at buffer row
        # C + level_starts[level + 1] + j
        below = h.level_starts[min(level + 1, h.depth)]
        row = np.where(child, src + below, src)
        if weights is None:
            wt = np.ones(src.shape, np.float32)
        else:
            wt = np.where(child, np.float32(1.0),
                          weights[np.minimum(src, C - 1)]).astype(np.float32)
        G = lp.n_clusters
        first = np.searchsorted(lp.seg, np.arange(G))
        col = np.arange(src.size) - first[lp.seg]
        K = int(lp.n_parts.max())
        rows = np.full((G, K), -1, np.int32)
        w = np.zeros((G, K), np.float32)
        rows[lp.seg, col] = row
        w[lp.seg, col] = wt
        return (torch.from_numpy(rows), torch.from_numpy(w),
                C + h.level_starts[level])

    def _reduce_level(self, buf, idx: int, plan: RoundPlan, weights):
        rows, w, first = self._level_tables(idx, plan, weights)
        out = buf[first:first + rows.shape[0]]
        return fedavg_rows(buf, rows, w, out=out)

    def _weights_for(self, weights, dtype) -> np.ndarray:
        """The client weights rounded to the updates' dtype (as the
        reference's ``w.astype(x.dtype)``), then carried as float32."""
        w = torch.as_tensor(np.asarray(weights, np.float32))
        return w.to(dtype).float().numpy()

    # ---- public surface (the reference's) ---------------------------------
    def weighted(self, stacked_updates, weights):
        """stacked (C, ...) tree * per-client weights -> the weighted
        stack, in the client rows (when ``stacked_updates`` already is
        the client stack, it is weighted in place, saving a copy)."""
        buf, layout = self._load_clients(stacked_updates)
        rows = buf[:self.hierarchy.total_clients]
        w = torch.as_tensor(np.asarray(weights, np.float32)).to(
            device=rows.device, dtype=rows.dtype)
        rows.mul_(w[:, None])
        return unflatten_tree(rows, layout)

    def run_level(self, idx: int, weighted, child_vals, plan: RoundPlan):
        """One level (deepest first) over the weighted stack and the
        level below's values -> this level's (G, ...) cluster values."""
        h = self.hierarchy
        buf, layout = self._load_clients(weighted)
        level = h.depth - 1 - idx
        if idx > 0:
            start = h.total_clients + h.level_starts[level + 1]
            below = buf[start:start + plan.levels[idx - 1].n_clusters]
            if not is_view_of(child_vals, below, layout):
                flatten_tree(child_vals, layout, lead=1, out=below)
        return unflatten_tree(self._reduce_level(buf, idx, plan, None),
                              layout)

    def aggregate(self, weighted, plan: RoundPlan):
        """Run all levels bottom-up over a weighted stack; returns the
        root cluster's value."""
        buf, layout = self._load_clients(weighted)
        for idx in range(len(plan.levels)):
            self._reduce_level(buf, idx, plan, None)
        return self._root(buf, layout)

    def aggregate_fused(self, stacked_updates, weights, plan: RoundPlan):
        """Weighting + every level + root extraction, the client weights
        applied inside the level kernels — the deterministic-timing hot
        path (no host syncs)."""
        buf, layout = self._load_clients(stacked_updates)
        w = self._weights_for(weights, buf.dtype)
        for idx in range(len(plan.levels)):
            self._reduce_level(buf, idx, plan, w)
        return self._root(buf, layout)

    def _root(self, buf, layout):
        C = self.hierarchy.total_clients
        return unflatten_tree(buf[C].clone(), layout)


def batched_hierarchical_fedavg(stacked_updates, weights,
                                hierarchy: Hierarchy,
                                placement: Sequence[int]):
    """``hierarchical_fedavg`` over a client-stacked tree in one kernel
    launch per level (property-tested equal to the sequential oracle)."""
    agg = SegmentAggregator(hierarchy)
    plan = hierarchy.round_plan(np.asarray(placement, np.int64))
    return agg.aggregate(agg.weighted(stacked_updates, weights), plan)


# --------------------------------------------------------------------------
# device-level plan: the tree as grouped collectives over a rank mesh
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AggregationPlan:
    """Static schedule of the in-mesh hierarchical aggregation, field
    for field the reference's (plain numpy, built on the host from the
    hierarchy, the placement and the data axis's extent)."""
    n_devices: int                       # extent of the data axis (per pod)
    client_of_device: np.ndarray         # (n_devices,) int
    weight_of_device: np.ndarray         # (n_devices,) f32: w_c / n_dev_c
    client_groups: tuple                 # device groups: one per client
    levels: tuple                        # per level, deepest first:
    #   (groups, carrier_mask, in_group_mask)
    root_rep_mask: np.ndarray            # (n_devices,) 0/1: root-group reps

    @staticmethod
    def build(hierarchy: Hierarchy, placement: Sequence[int],
              n_devices: int, weights: Optional[Sequence[float]] = None
              ) -> "AggregationPlan":
        n_clients = hierarchy.total_clients
        if n_devices % n_clients != 0:
            raise ValueError(
                f"data axis ({n_devices}) must be a multiple of the client "
                f"count ({n_clients})")
        per = n_devices // n_clients
        client_of_device = np.repeat(np.arange(n_clients), per)
        if weights is None:
            weights = np.full(n_clients, 1.0 / n_clients)
        weights = np.asarray(weights, np.float32)
        weight_of_device = weights[client_of_device] / per

        def devices_of(c: int) -> List[int]:
            return list(range(c * per, (c + 1) * per))

        client_groups = tuple(tuple(devices_of(c)) for c in range(n_clients))
        levels = []
        for level_clusters in hierarchy.clusters(placement):  # deepest first
            groups: List[tuple] = []
            carrier = np.zeros(n_devices, np.float32)
            in_group = np.zeros(n_devices, np.float32)
            for members in level_clusters:
                devs: List[int] = []
                for c in members:
                    devs.extend(devices_of(c))
                    carrier[c * per] = 1.0          # the client's rep
                groups.append(tuple(sorted(devs)))
                in_group[devs] = 1.0
            groups.extend((d,) for d in range(n_devices) if not in_group[d])
            levels.append((tuple(groups), carrier, in_group))
        root_rep = np.zeros(n_devices, np.float32)
        root_rep[int(placement[0]) * per] = 1.0
        return AggregationPlan(
            n_devices=n_devices,
            client_of_device=client_of_device,
            weight_of_device=weight_of_device.astype(np.float32),
            client_groups=client_groups,
            levels=tuple(levels),
            root_rep_mask=root_rep,
        )


def _flat_value(value):
    """(flat buffer, the tree to return) of a tensor or tree: the buffer
    its leaves already view (reduced in place, and ``value`` itself
    returned, so a flat param tree keeps its leaves), else a packed copy
    and a tree of views into it."""
    layout = tree_layout(value)
    flat = flat_buffer_of(value, layout)
    if flat is not None:
        return flat, value
    flat = flatten_tree(value, layout)
    return flat, unflatten_tree(flat, layout)


def _scale(flat: torch.Tensor, s) -> None:
    """``flat *= s`` with ``s`` first rounded to the buffer's dtype (the
    reference's ``x * w.astype(x.dtype)``)."""
    flat.mul_(torch.tensor(float(s), dtype=flat.dtype))


def _reduce(mesh, flat, group, step: str, stats: Optional[list]) -> None:
    """One grouped reduction (a tree level) over the flat buffer; with
    ``stats`` it appends the step's bytes in, group size and host-clock
    milliseconds (the card synchronised at the end)."""
    t0 = time.perf_counter()
    moved = mesh.all_reduce(flat, group)
    if stats is None:
        return
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    ranks = 1 if group is None else torch.distributed.get_world_size(group)
    stats.append({"step": step, "ranks": ranks, "bytes": moved,
                  "ms": (time.perf_counter() - t0) * 1e3})


def hierarchical_psum(value, plan: AggregationPlan, mesh,
                      axis_name: str = "data",
                      pod_axis: Optional[str] = None, *,
                      stats: Optional[list] = None):
    """The paper's aggregation tree as grouped collectives.

    Call on every rank of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.RankMesh` over ``[pod_axis,]
    axis_name``). ``value`` is this rank's local update, a tensor or a
    tree; its flat buffer (the one its leaves view, as a flat param
    tree's do, else a packed copy) is reduced in place, one chunked
    all-reduce a level, and the tree viewing it returned (``value``
    itself when it was flat): the global aggregate, on every rank. Singleton groups are the identity
    and launch nothing. The reference's order and masks: weight, sum
    each client's ranks, then each level deepest first (carriers only;
    a rank outside every group keeps its value), the root
    representative's sum to the whole axis, the mean over pods.
    """
    flat, out = _flat_value(value)
    d = mesh.axis_index(axis_name)
    with torch.no_grad():
        _scale(flat, plan.weight_of_device[d])
        _reduce(mesh, flat, mesh.subgroup(axis_name, plan.client_groups),
                "clients", stats)
        for i, (groups, carrier, in_group) in enumerate(plan.levels):
            # every rank creates every group, in one order
            group = mesh.subgroup(axis_name, groups)
            if in_group[d]:
                _scale(flat, carrier[d])
                _reduce(mesh, flat, group, f"level {i}", stats)
        _scale(flat, plan.root_rep_mask[d])
        _reduce(mesh, flat, mesh.axis_group(axis_name), "root", stats)
        _pod_mean(mesh, flat, pod_axis, stats)
    return out


def flat_psum(value, plan: AggregationPlan, mesh, axis_name: str = "data",
              pod_axis: Optional[str] = None, *,
              stats: Optional[list] = None):
    """CFL baseline: one weighted all-reduce over the data axis (then
    the pod mean), in place as :func:`hierarchical_psum`."""
    flat, out = _flat_value(value)
    with torch.no_grad():
        _scale(flat, plan.weight_of_device[mesh.axis_index(axis_name)])
        _reduce(mesh, flat, mesh.axis_group(axis_name), "flat", stats)
        _pod_mean(mesh, flat, pod_axis, stats)
    return out


def _pod_mean(mesh, flat, pod_axis, stats) -> None:
    """Multi-pod: the top of the hierarchy crosses the pod boundary; the
    per-pod weights each sum to 1, so the global model is the pod mean
    (``lax.pmean``: the sum over the axis, divided by its size)."""
    if pod_axis is None:
        return
    _reduce(mesh, flat, mesh.axis_group(pod_axis), "pod", stats)
    flat.div_(mesh.shape[pod_axis])
