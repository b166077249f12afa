"""Aggregation: flat FedAvg and host-level hierarchical FedAvg.

The port of the host-level half of ``repro.fl.aggregation``
(``fedavg``, ``hierarchical_fedavg``, ``SegmentAggregator``,
``batched_hierarchical_fedavg``). The device-level plan
(``AggregationPlan``, ``hierarchical_psum``, ``flat_psum``) comes with
the multi-device slice (ROADMAP.md queue 1 item 12).

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

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hierarchy import Hierarchy, RoundPlan
from repro_torch.kernels import ops
from repro_torch.kernels.fedavg import fedavg_rows
from repro_torch.utils.trees import (
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
