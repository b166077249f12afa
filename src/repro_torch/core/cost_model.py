"""The TPD cost model (paper eqs. 6-7) — scalar and particle-vectorized.

    d_a = (mdatasize_a + sum_{c in children(a)} mdatasize_c) / pspeed_a
    TPD = sum_levels max_{a in level} d_a

The max-per-level captures the bottleneck effect (aggregators at one
level run in parallel; levels are serial, bottom-up). An optional memory
penalty inflates d_a when the buffer exceeds the host's memcap — the
"compute memory consumption" line of Algorithm 1.

The port's ``CostModel``, held to ``repro.core.cost_model.CostModel``:

* ``tpd`` — the scalar Python reference (paper-literal).
* ``tpd_fast`` — the cached EXACT (float64 numpy) vectorized evaluator
  on a batch of 1, on the host as in the reference; bit-identical to
  ``tpd`` for width < 8.
* ``batch_tpd`` — whole-swarm (P, D) -> (P,) evaluation, backends:

  - ``"np"``: the reference's float32 numpy closure, on the host;
  - ``"torch"``: the sums of the plain torch
    :func:`~repro_torch.kernels.ref.tpd_ref`, with
    :func:`~repro_torch.kernels.tpd.leaf_loads` and any trace-calibrated
    terms, on the model's device (the two-tier model: its own pod-aware
    torch build);
  - ``"kernel"``: the CUDA kernel
    (:func:`~repro_torch.kernels.tpd.batch_tpd_cuda`), one launch that
    builds the leaf loads and scores the swarm; CUDA devices and the
    base model only.

  Auto-selection: ``"kernel"`` where the kernel covers the model on a
  CUDA device; else, on any device, the reference's
  ``_NP_FASTPATH_ELEMS`` rule picks ``"np"`` for small swarms and
  ``"torch"`` above it.
* ``PooledTPDEvaluator`` — S same-shape cost models with independent
  client pools evaluated in ONE exact call (the batched sweep runner's
  engine).
* ``TwoTierCostModel`` — eq. 6 plus per-edge pod transfer costs.
* ``CalibratedCostModel`` — eqs. 6-7 with trace-fitted payload scale,
  per-level link charges and train offset (``repro_torch.calibration``).

The CUDA kernel prices the base model only: auto-selection never sends a
two-tier or calibrated model to it, and ``backend="kernel"`` refuses
them.

Cache invalidation is O(1): evaluators are keyed on the ClientPool's
mutation ``version`` counter and the retarget counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hierarchy import ClientPool, Hierarchy, rows_with_duplicates
from repro_torch.device import resolve_device
from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs

_BACKENDS = ("np", "torch", "kernel")
# the calibration terms of the analytic model: payload scale, per-level
# link betas, train scale
_NEUTRAL_CALIBRATION = (1.0, (), 0.0)


@dataclass(frozen=True)
class CostModel:
    hierarchy: Hierarchy
    clients: ClientPool
    memory_penalty: float = 0.0  # 0 disables the memcap feasibility term
    device: object = "cuda"      # where the torch/kernel backends run

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------------
    def cluster_delay(self, host: int, children: Sequence[int]) -> float:
        """Paper eq. 6 (+ optional memcap penalty)."""
        mds = self.clients.mdatasize
        load = mds[host] + sum(mds[c] for c in children)
        delay = load / self.clients.pspeed[host]
        if self.memory_penalty > 0:
            over = max(0.0, load - self.clients.memcap[host])
            delay *= 1.0 + self.memory_penalty * over / max(
                self.clients.memcap[host], 1e-9)
        return float(delay)

    def tpd(self, placement: Sequence[int]) -> float:
        """Paper eq. 7: bottom-up BFT, sum of per-level maxima (the
        scalar reference every vectorized path is held to)."""
        h = self.hierarchy
        children = h.children_clients(placement)
        total = 0.0
        for level in range(h.depth - 1, -1, -1):
            worst = 0.0
            for s in range(h.level_starts[level], h.level_starts[level + 1]):
                worst = max(worst,
                            self.cluster_delay(int(placement[s]), children[s]))
            total += worst
        return total

    def fitness(self, placement: Sequence[int]) -> float:
        """Paper eq. 1: f = -T."""
        return -self.tpd(placement)

    # ------------------------------------------------------------------
    # vectorized path (all particles at once)
    # ------------------------------------------------------------------
    # the reference's numpy-vs-XLA crossover, kept for every model the
    # kernel does not cover: below this many placement entries the
    # numpy evaluator wins
    _NP_FASTPATH_ELEMS = 32768

    def _attr_stack(self, dtype) -> np.ndarray:
        """Stacked (A, C) client-attribute table: mdatasize, pspeed,
        memcap(, pod id) — ONE fancy-index gathers every per-host
        attribute."""
        rows = [self.clients.mdatasize, self.clients.pspeed,
                self.clients.memcap]
        pod = getattr(self, "pod_of", None)
        if pod is not None:
            rows.append(np.asarray(pod))  # pod ids exact in f32
        return np.stack(rows).astype(dtype)

    def _make_batch_tpd(self, dtype=None, pool_attrs=None):
        """Build the numpy (P, slots) -> (P,) TPD evaluator (the
        reference's closure, host-side, its numpy branch).

        The canonical round-robin trainer split is recomputed per
        particle (rank of each unplaced client in ascending id order,
        mod n_leaves), so heterogeneous ``mdatasize`` charges the ACTUAL
        per-child loads, and the two-tier model's per-edge costs
        (``pod_of`` + ICI/DCN rates) land on true child identities.

        ``dtype`` is the accumulation dtype (default float32). The
        float64 build is the EXACT path: every reduction runs in the
        same order as the scalar reference (bincount/left-to-right
        child sums, division by pspeed, per-level maxima summed deepest
        level first), so it is bit-identical to ``tpd`` for width < 8.

        ``pool_attrs`` switches on POOLED mode: a (A, S, C) stack of S
        client pools' attribute tables; the returned evaluator takes
        ``(placements, pool_idx=None)`` and scores placement row i
        against pool ``pool_idx[i]`` (default: row i against pool i).
        Row results are bit-identical to the single-pool evaluator of
        the matching pool — all per-row reductions are independent.
        """
        h = self.hierarchy
        C, D, depth = h.total_clients, h.dimensions, h.depth
        n_leaves = h.n_leaves
        leaf_start = h.level_starts[depth - 1]
        kids_np = h.kids_table
        penalty = self.memory_penalty
        have_pods = getattr(self, "pod_of", None) is not None
        ici = float(getattr(self, "ici_cost", 0.0))
        dcn = float(getattr(self, "dcn_cost", 0.0))
        # trace-calibrated terms (CalibratedCostModel; neutral values on
        # the base model keep every branch below bit-identical to the
        # uncalibrated build)
        cal_scale, cal_link, cal_train = self._calibration_terms()
        calibrated = (cal_scale != 1.0 or any(cal_link)
                      or cal_train != 0.0)
        link_np = np.zeros(D, np.float64)
        if calibrated and cal_link:
            link = np.asarray(cal_link, np.float64)
            link_np = link[np.minimum(h.levels, len(link) - 1)]
        kids_cnt_np = (kids_np >= 0).sum(axis=1)                  # (D,)
        tr_counts_np = np.bincount(np.arange(max(C - D, 0)) % n_leaves,
                                   minlength=n_leaves)
        ft = np.dtype(dtype if dtype is not None else np.float32).type
        pooled = pool_attrs is not None
        attrs_np = np.asarray(pool_attrs) if pooled \
            else self._attr_stack(ft)                     # (A, [S,] C)
        # uniform-payload fast path: when every client's mdatasize is
        # equal the canonical trainer split fixes each leaf cluster's
        # LOAD, so the per-call (P, C) rank/scatter pipeline collapses
        # to a per-slot constant — bit-identical because the constants
        # are accumulated by the same repeated addition the bincount
        # would perform. Rows with DUPLICATE ids take the general path;
        # pod edge costs always do.
        mds_rows = attrs_np[0] if pooled else attrs_np[0][None]
        uniform = not have_pods and all(
            row.size and np.all(row == row[0]) for row in mds_rows)
        if uniform:
            counts = np.bincount(np.arange(max(C - D, 0)) % n_leaves,
                                 minlength=n_leaves)
            kmax = int(counts.max()) if counts.size else 0

            def leaf_consts(u):
                # cumsum of a constant == the bincount's sequential
                # repeated addition, prefix by prefix (bit-identical)
                acc = np.concatenate(
                    [[np.float64(0.0)],
                     np.cumsum(np.full(kmax, u, np.float64))])
                return acc[counts]

            leaf_part = np.zeros((mds_rows.shape[0], D), np.float64)
            leaf_part[:, leaf_start:] = np.stack(
                [leaf_consts(np.float64(row[0])) for row in mds_rows])
            leaf_part = leaf_part.astype(ft)                # (S|1, D)
        # gather only the attribute rows each site consumes: hosts need
        # mds+pspeed (+memcap when the penalty is live, +pod for two-
        # tier); children only their mds (+pod)
        host_rows = [0, 1] + ([2] if penalty > 0 else []) + \
            ([3] if have_pods else [])
        kid_rows = [0] + ([3] if have_pods else [])
        h_attrs = attrs_np[host_rows]
        k_attrs = attrs_np[kid_rows]
        mds_all = attrs_np[0]                             # (C,) | (S, C)
        pods_all = attrs_np[3] if have_pods else None
        kids = np.clip(kids_np, 0, D - 1)
        kids_valid = kids_np >= 0
        is_leaf_slot = h.levels == depth - 1
        slot_leaf_idx = np.clip(np.arange(D) - leaf_start, 0, n_leaves - 1)
        level_starts_np = np.asarray(h.level_starts[:-1], np.int32)
        # calibrated-link statics: per-slot beta (level gather) and the
        # structural member count of every cluster for NON-duplicate
        # rows (kids + host for internal slots, round-robin trainers +
        # host for leaves); duplicate rows recount trainers per call
        link_slot = link_np.astype(ft)
        kid_parts = (kids_cnt_np + 1).astype(ft)
        static_parts = np.where(
            is_leaf_slot, tr_counts_np[slot_leaf_idx] + 1,
            kids_cnt_np + 1).astype(ft)
        train_add = None
        if calibrated and cal_train != 0.0:
            psp = attrs_np[1]
            inv_max = np.max(1.0 / psp, axis=-1)   # () | (S,)
            if pooled:
                train_add = (cal_train * inv_max).astype(ft)
            else:
                train_add = ft(cal_train * inv_max)

        def bincount(idx, w, m):
            return np.bincount(idx.ravel(),
                               weights=None if w is None else w.ravel(),
                               minlength=m)

        def batch(placements, pool_idx=None):             # (P, D) int
            placements = placements.astype(np.int32)
            P = placements.shape[0]
            rows = np.arange(P) if pool_idx is None \
                else np.asarray(pool_idx)
            use_uniform = uniform and \
                not rows_with_duplicates(placements).any()
            if not use_uniform:
                p_off = np.arange(P)[:, None]
                # placed mask via bincount, not a (P, D, C) compare
                placed = bincount(placements + C * p_off, None,
                                  P * C).reshape(P, C)
                unplaced = placed == 0
                mds_b = mds_all[rows] if pooled else mds_all[None]
                t_mds = np.where(unplaced, mds_b, ft(0.0))
                # canonical trainer split: rank among unplaced ids, mod
                # leaves
                leaf_of = (np.cumsum(unplaced, axis=1) - 1) % n_leaves
                leaf_bins = leaf_of + n_leaves * p_off
            if pooled:
                host = h_attrs[:, rows[:, None], placements]  # (Ah,P,D)
            else:
                host = h_attrs[:, placements]                 # (Ah,P,D)
            kid_host = placements[:, kids]                   # (P, D, W)
            if pooled:
                kid_attr = k_attrs[:, rows[:, None, None], kid_host]
            else:
                kid_attr = k_attrs[:, kid_host]              # (Ak,P,D,W)
            kid_mds = np.where(kids_valid[None], kid_attr[0], ft(0.0))

            if have_pods:  # two-tier per-edge transfer costs
                host_pod = host[-1]                          # (P, D)
                kid_rate = np.where(kid_attr[-1] == host_pod[:, :, None],
                                    ft(ici), ft(dcn))
                edge_int = np.sum(
                    np.where(kids_valid[None], kid_mds * kid_rate,
                             ft(0.0)), axis=2)
                t_host_pod = host_pod.reshape(-1)[
                    (leaf_start + leaf_of) + D * p_off]      # (P, C)
                pods_b = pods_all[rows] if pooled else pods_all[None]
                t_rate = np.where(pods_b == t_host_pod, ft(ici), ft(dcn))
                # one bincount for both leaf accumulators: trainer loads
                # in the first P*L bins, edge costs in the second
                two = bincount(
                    np.concatenate([leaf_bins,
                                    leaf_bins + P * n_leaves], axis=0),
                    np.concatenate([t_mds, t_mds * t_rate], axis=0),
                    2 * P * n_leaves)
                leaf_load = two[: P * n_leaves].reshape(P, n_leaves)
                edge_leaf = two[P * n_leaves:].reshape(P, n_leaves)
            elif not use_uniform:
                leaf_load = bincount(leaf_bins, t_mds,
                                     P * n_leaves).reshape(P, n_leaves)

            if use_uniform:
                # leaf slots: constant trainer load (+0 kid sum);
                # internal slots: +0 leaf part — both adds are exact
                lp = leaf_part[rows] if pooled else leaf_part
                child_load = lp + np.sum(kid_mds, axis=2)
            else:
                child_load = np.where(
                    is_leaf_slot[None],
                    leaf_load[:, slot_leaf_idx].astype(ft),
                    np.sum(kid_mds, axis=2))
            load = host[0] + child_load
            if calibrated and cal_scale != 1.0:
                load = load * ft(cal_scale)
            delay = load / host[1]
            if penalty > 0:
                cap = host[2]
                over = np.maximum(ft(0.0), load - cap)
                delay = delay * (1.0 + penalty * over /
                                 np.maximum(cap, ft(1e-9)))
            if have_pods:
                delay = delay + np.where(
                    is_leaf_slot[None],
                    edge_leaf[:, slot_leaf_idx].astype(ft), edge_int)
            if calibrated and any(cal_link):
                # per-part link charge: structural member counts for
                # non-duplicate rows; duplicate rows recount actual
                # trainers per leaf from the unplaced mask
                if use_uniform:
                    parts_f = static_parts[None]
                else:
                    leaf_cnt = bincount(
                        leaf_bins, np.where(unplaced, ft(1.0), ft(0.0)),
                        P * n_leaves).reshape(P, n_leaves)
                    parts_f = np.where(
                        is_leaf_slot[None],
                        leaf_cnt[:, slot_leaf_idx] + ft(1.0),
                        kid_parts[None])
                delay = delay + link_slot[None] * parts_f
            # per-level max, summed DEEPEST level first — the scalar
            # reference accumulates bottom-up, and float addition is not
            # associative, so the exact path must match its order
            level_max = np.maximum.reduceat(delay, level_starts_np, axis=1)
            out = level_max[:, ::-1].sum(axis=1)
            if train_add is not None:
                out = out + (train_add[rows] if pooled else train_add)
            return out

        return batch

    def _make_pooled_torch_tpd(self, pool_attrs):
        """The pooled evaluator of :meth:`_make_batch_tpd` in torch ops:
        ``(placements (P, D), pool_idx (P,)) -> (P,)`` TPDs, on the
        device the placements are on (tables uploaded once a device), in
        the dtype of ``pool_attrs`` (float64: each shard of the sharded
        pooled call, the reference's jnp float64 build).

        The numpy build's general path, op for op and in its order
        (trainer loads by a scatter-add over ascending client ids, kid
        columns left to right, the penalty, the pod edge costs and the
        calibrated terms where the model has them, level maxima summed
        deepest first); only the scatter-add's order on the card, where
        it uses atomics, may differ, by float64 round-off.
        """
        h = self.hierarchy
        D, depth, n_leaves = h.dimensions, h.depth, h.n_leaves
        leaf_start = h.level_starts[depth - 1]
        penalty = float(self.memory_penalty)
        have_pods = getattr(self, "pod_of", None) is not None
        ici = float(getattr(self, "ici_cost", 0.0))
        dcn = float(getattr(self, "dcn_cost", 0.0))
        cal_scale, cal_link, cal_train = self._calibration_terms()
        attrs_np = np.asarray(pool_attrs)                 # (A, S, C)
        kids_np = h.kids_table
        is_leaf_np = h.levels == depth - 1
        slot_leaf_np = np.clip(np.arange(D) - leaf_start, 0, n_leaves - 1)
        bounds = [int(b) for b in h.level_starts]
        link_np = parts_np = train_np = None
        if cal_link:
            link = np.asarray(cal_link, np.float64)
            link_np = link[np.minimum(h.levels, len(link) - 1)]
            parts_np = (kids_np >= 0).sum(axis=1) + 1
        if cal_train != 0.0:
            train_np = cal_train * np.max(1.0 / attrs_np[1], axis=-1)
        tables = {}

        def on(dev):
            if dev not in tables:
                dt = torch.as_tensor(attrs_np).dtype

                def put(a, dtype=None):
                    return torch.as_tensor(a, device=dev, dtype=dtype)

                tables[dev] = dict(
                    attrs=put(attrs_np),
                    ici=put(ici, dt), dcn=put(dcn, dt),
                    kids=put(np.clip(kids_np, 0, D - 1), torch.long),
                    kids_valid=put(kids_np >= 0),
                    is_leaf=put(is_leaf_np),
                    slot_leaf=put(slot_leaf_np, torch.long),
                    link=None if link_np is None else put(link_np, dt),
                    parts=None if parts_np is None else put(parts_np, dt),
                    train=None if train_np is None else put(train_np, dt))
            return tables[dev]

        def batch(placements, pool_idx=None):
            dev = placements.device
            t = on(dev)
            p = placements.long()
            P = p.shape[0]
            rows = torch.arange(P, device=dev) if pool_idx is None \
                else torch.as_tensor(pool_idx, device=dev).long()
            a = t["attrs"][:, rows]                        # (A, P, C)
            mds = a[0]
            unplaced = torch.ones_like(mds, dtype=torch.bool).scatter_(
                1, p, False)
            t_mds = torch.where(unplaced, mds, 0.0)
            # canonical trainer split: rank among unplaced ids, mod leaves
            leaf_of = torch.remainder(torch.cumsum(unplaced, dim=1) - 1,
                                      n_leaves)

            def by_leaf(w):
                return torch.zeros((P, n_leaves), dtype=w.dtype,
                                   device=dev).scatter_add_(1, leaf_of, w)

            host = a.gather(2, p.expand(a.shape[0], -1, -1))  # (A, P, D)
            kid_host = p[:, t["kids"]]                      # (P, D, W)
            kid_mds = torch.where(
                t["kids_valid"][None],
                mds.gather(1, kid_host.reshape(P, -1)).view(kid_host.shape),
                0.0)
            child = kid_mds[..., 0]
            for w in range(1, kid_mds.shape[-1]):           # in order
                child = child + kid_mds[..., w]
            load = host[0] + torch.where(
                t["is_leaf"][None], by_leaf(t_mds)[:, t["slot_leaf"]], child)
            if cal_scale != 1.0:
                load = load * cal_scale
            delay = load / host[1]
            if penalty > 0:
                cap = host[2]
                over = torch.clamp_min(load - cap, 0.0)
                delay = delay * (1.0 + penalty * over
                                 / torch.clamp_min(cap, 1e-9))
            if have_pods:
                pods = a[3]
                host_pod = host[3]                          # (P, D)
                kid_pod = pods.gather(1, kid_host.reshape(P, -1)).view(
                    kid_host.shape)
                kid_edge = torch.where(
                    t["kids_valid"][None],
                    kid_mds * torch.where(kid_pod == host_pod[..., None],
                                          t["ici"], t["dcn"]), 0.0)
                edge_int = kid_edge[..., 0]
                for w in range(1, kid_edge.shape[-1]):
                    edge_int = edge_int + kid_edge[..., w]
                t_host_pod = host_pod.gather(1, leaf_start + leaf_of)
                edge_leaf = by_leaf(t_mds * torch.where(
                    pods == t_host_pod, t["ici"], t["dcn"]))
                delay = delay + torch.where(
                    t["is_leaf"][None], edge_leaf[:, t["slot_leaf"]],
                    edge_int)
            if t["link"] is not None:
                leaf_cnt = by_leaf(unplaced.to(mds.dtype))
                parts = torch.where(t["is_leaf"][None],
                                    leaf_cnt[:, t["slot_leaf"]] + 1.0,
                                    t["parts"][None])
                delay = delay + t["link"][None] * parts
            total = torch.zeros(P, dtype=delay.dtype, device=dev)
            for lv in range(len(bounds) - 2, -1, -1):       # deepest first
                total = total + delay[:, bounds[lv]:bounds[lv + 1]].amax(1)
            if t["train"] is not None:
                total = total + t["train"][rows]
            return total

        return batch

    def _make_device_tpd(self, kernel: bool):
        """Closure scoring swarms on ``self.device``: static tables are
        uploaded once; per call the placements go up, the TPD evaluation
        runs on the device, and the (P,) TPDs come back to the host.

        With ``kernel`` the evaluation is one launch of the CUDA kernel,
        which builds the leaf loads itself (the base model only). Else
        eqs. 6-7 in float32 torch ops (the reference's jit build, in
        torch): the sums of :func:`~repro_torch.kernels.ref.tpd_ref`
        (leaf loads in float64 in ascending id order, kid columns left
        to right, level maxima deepest level first), with any
        trace-calibrated terms at the reference's points: the load times
        ``float32(payload_scale)`` before the pspeed divide; the float64
        per-level link betas cast to float32, times each cluster's
        member count (actual trainers + 1 at a leaf, kids + 1 inside),
        added after the memcap penalty; the float32 train offset
        ``train_scale * max(1 / pspeed)`` added last. At neutral terms
        these are ``tpd_ref``'s ops in its order.
        """
        h = self.hierarchy
        dev = self.device
        penalty = float(self.memory_penalty)
        attrs_np = self._attr_stack(np.float32)
        if kernel:
            kids_k, level_starts = tpd_kernel_inputs(h, device=dev)
            attrs = torch.as_tensor(attrs_np[:3], device=dev)

            def launch(placements):
                return batch_tpd_cuda(self._device_placements(placements),
                                      attrs, None, kids_k, level_starts,
                                      penalty=penalty).cpu().numpy()

            return launch
        cal_scale, cal_link, cal_train = self._calibration_terms()
        n_leaves, D, depth = h.n_leaves, h.dimensions, h.depth
        leaf_start = h.level_starts[depth - 1]
        mds, pspeed, memcap = torch.as_tensor(attrs_np[:3],
                                              device=dev).unbind(0)
        kids_np = h.kids_table[:leaf_start]
        kids = torch.as_tensor(np.clip(kids_np, 0, D - 1), device=dev)
        kids_valid = torch.as_tensor(kids_np >= 0, device=dev)
        bounds = [int(b) for b in h.level_starts]
        scale = float(np.float32(cal_scale))
        link_slot = None
        if cal_link:
            link = np.asarray(cal_link, np.float64)
            link_slot = torch.as_tensor(
                link[np.minimum(h.levels, len(link) - 1)].astype(
                    np.float32), device=dev)                   # (D,)
            kid_parts = torch.as_tensor(
                ((kids_np >= 0).sum(axis=1) + 1).astype(np.float32),
                device=dev)                                   # (D - L,)
            ones = torch.ones_like(mds)
        train_add = None
        if cal_train != 0.0:
            inv_max = np.max(1.0 / attrs_np[1], axis=-1)
            train_add = float(np.float32(cal_train * inv_max))

        def run(placements):
            p = self._device_placements(placements).long()
            kid_mds = torch.where(kids_valid[None], mds[p[:, kids]], 0.0)
            child = kid_mds[..., 0]                          # (P, D - L)
            for w in range(1, kid_mds.shape[-1]):            # in order
                child = child + kid_mds[..., w]
            load = mds[p] + torch.cat(
                [child, leaf_loads(p, mds, n_leaves)], dim=1)
            if cal_scale != 1.0:
                load = load * scale
            delay = load / pspeed[p]
            if penalty > 0:
                cap = memcap[p]
                over = torch.clamp_min(load - cap, 0.0)
                delay = delay * (1.0 + penalty * over
                                 / torch.clamp_min(cap, 1e-9))
            if link_slot is not None:
                # trainer counts a leaf: leaf_loads of unit payloads
                # (exact), so duplicate-id rows count actual trainers
                parts = torch.cat(
                    [kid_parts.expand(p.shape[0], -1),
                     leaf_loads(p, ones, n_leaves) + 1.0], dim=1)
                delay = delay + link_slot[None] * parts
            total = torch.zeros(p.shape[0], dtype=torch.float32,
                                device=dev)
            for lv in range(len(bounds) - 2, -1, -1):  # deepest first
                total = total + delay[:, bounds[lv]:bounds[lv + 1]].amax(1)
            if train_add is not None:
                total = total + train_add
            return total.cpu().numpy()

        return run

    def _device_placements(self, placements) -> torch.Tensor:
        """Range-check (P, D) placements on the host and upload them."""
        placements = np.asarray(placements, np.int32)
        C = self.hierarchy.total_clients
        if placements.size and (placements.min() < 0
                                or placements.max() >= C):
            raise ValueError(f"placement client id out of range "
                             f"[0, {C})")
        return torch.as_tensor(placements, device=self.device)

    @property
    def topology_version(self) -> int:
        """How many times :meth:`retarget` swapped the hierarchy (0 for
        a static run)."""
        return getattr(self, "_topology_version", 0)

    def retarget(self, hierarchy: Hierarchy) -> None:
        """Swap in a new hierarchy after an elastic resize.

        The SAME cost model object (strategies hold references to it)
        starts pricing rounds on the new topology, and the bumped
        ``topology_version`` joins the pool-mutation counter in
        :meth:`_client_token`, so every cached evaluator is rebuilt on
        the next call instead of serving stale-shape answers.
        """
        if hierarchy.total_clients != len(self.clients):
            raise ValueError(
                f"hierarchy expects {hierarchy.total_clients} clients, "
                f"pool has {len(self.clients)}")
        pod = getattr(self, "pod_of", None)
        if pod is not None and len(pod) != hierarchy.total_clients:
            raise ValueError(
                "cannot retarget a two-tier cost model across a pool "
                "resize: pod_of does not cover the new population")
        object.__setattr__(self, "hierarchy", hierarchy)
        object.__setattr__(self, "_topology_version",
                           self.topology_version + 1)

    def _calibration_terms(self) -> tuple:
        """(payload_scale, level_link, train_scale) — neutral
        ``(1.0, (), 0.0)`` on the base model; CalibratedCostModel
        overrides the fields. One tuple so every consumer (closure
        builders, pooled-evaluator compatibility check, kernel gate)
        compares the same thing."""
        return (float(getattr(self, "payload_scale", 1.0)),
                tuple(float(b) for b in getattr(self, "level_link", ())
                      or ()),
                float(getattr(self, "train_scale", 0.0)))

    def _client_token(self) -> tuple:
        """O(1) fingerprint of the client attrs + topology baked into
        the cached evaluators: the pool's mutation version counter plus
        the retarget counter."""
        return (id(self.clients), self.clients.version,
                self.topology_version)

    def _cached(self, attr: str, build):
        token = self._client_token()
        cached = getattr(self, attr, None)
        if cached is None or cached[0] != token:
            cached = (token, build())
            object.__setattr__(self, attr, cached)
        return cached[1]

    def _kernel_covers(self) -> bool:
        """The CUDA TPD kernel prices the base eq. 6/7 model only: no
        pod edge costs, no trace-calibrated terms."""
        return getattr(self, "pod_of", None) is None and \
            self._calibration_terms() == _NEUTRAL_CALIBRATION

    def _kernel_ok(self) -> bool:
        """The kernel covers the model and the model is on a CUDA
        device — the counterpart of the reference's ``_pallas_ok``."""
        return self._kernel_covers() and self.device.type == "cuda"

    def set_default_backend(self, backend: Optional[str]) -> None:
        """Pin what ``batch_tpd(backend=None)`` dispatches to (the
        ``EvalConfig.backend`` plumbing); ``None`` restores
        auto-selection."""
        if backend is not None and backend not in _BACKENDS:
            raise ValueError(f"unknown batch_tpd backend {backend!r}; "
                             f"use None, 'np', 'torch' or 'kernel'")
        object.__setattr__(self, "_default_backend", backend)

    def batch_tpd(self, placements, backend: Optional[str] = None
                  ) -> np.ndarray:
        """(P, D) placements -> (P,) f32 TPDs.

        ``backend``: ``None`` auto-selects (``"kernel"`` where
        :meth:`_kernel_ok` holds; else ``"np"`` below the fast-path
        threshold and ``"torch"`` above it); ``"np"`` / ``"torch"`` / ``"kernel"``
        force a path; ``"kernel"`` needs a CUDA device and the base
        model. A ``set_default_backend`` pin replaces the
        auto-selection, never an explicit ``backend=``.
        """
        placements = np.asarray(placements, np.int32)
        if backend is None:
            backend = getattr(self, "_default_backend", None)
        if backend is None:
            if self._kernel_ok():
                backend = "kernel"
            else:
                small = placements.size // max(self.hierarchy.dimensions, 1) \
                    * self.hierarchy.total_clients <= self._NP_FASTPATH_ELEMS
                backend = "np" if small else "torch"
        if backend == "np":
            fn = self._cached("_batch_tpd_np",
                              lambda: self._make_batch_tpd())
        elif backend == "kernel":
            if not self._kernel_covers():
                raise ValueError("the CUDA TPD kernel prices the base "
                                 "eqs. 6-7 only, not two-tier pod edge "
                                 "costs or trace-calibrated terms; use "
                                 "backend='torch'")
            if self.device.type != "cuda":
                raise ValueError(
                    f"backend='kernel' runs the CUDA kernel and needs a "
                    f"CUDA device; this model is on {self.device}")
            fn = self._cached("_batch_tpd_kernel",
                              lambda: self._make_device_tpd(True))
        elif backend == "torch":
            fn = self._cached("_batch_tpd_torch",
                              lambda: self._make_device_tpd(False))
        else:
            raise ValueError(f"unknown batch_tpd backend {backend!r}; "
                             f"use None, 'np', 'torch' or 'kernel'")
        return fn(placements)

    def tpd_fast(self, placement) -> float:
        """Single-placement fast path: the cached EXACT (float64 numpy)
        vectorized evaluator on a batch of 1, bit-identical to the
        scalar :meth:`tpd` for trees with width < 8. This is what
        ``SimulatedEnvironment.step`` calls every round."""
        placements = np.asarray(placement, np.int32).reshape(1, -1)
        fn = self._cached(
            "_batch_tpd_exact",
            lambda: self._make_batch_tpd(dtype=np.float64))
        return float(fn(placements)[0])

    def batch_fitness(self, placements) -> np.ndarray:
        return -np.asarray(self.batch_tpd(placements))

    @classmethod
    def from_trace(cls, trace, *, hierarchy: Optional[Hierarchy] = None,
                   clients: Optional[ClientPool] = None,
                   holdout_rounds: int = 0,
                   device="cuda") -> "CalibratedCostModel":
        """Fit a :class:`CalibratedCostModel` from a recorded
        :class:`repro_torch.calibration.trace.TraceArtifact` (or a path
        to one), on ``device``. ``hierarchy``/``clients`` default to the
        shape and attribute snapshot stored in the trace;
        ``holdout_rounds`` withholds the LAST k rounds from the fit.
        Delegates to ``repro_torch.calibration.fit`` (imported lazily —
        calibration depends on this module, not vice versa)."""
        from repro_torch.calibration.fit import cost_model_from_trace
        return cost_model_from_trace(trace, hierarchy=hierarchy,
                                     clients=clients,
                                     holdout_rounds=holdout_rounds,
                                     device=device)


class PooledTPDEvaluator:
    """ONE exact evaluation call for placements scored against DIFFERENT
    client pools — the batched sweep runner's engine.

    ``models`` are S cost models sharing hierarchy/penalty/pod topology
    but each wrapping its own (independently drifting) ClientPool — the
    per-seed environments of one sweep. ``tpds(placements, pool_idx)``
    scores placement row i against pool ``pool_idx[i]`` (default: row i
    vs pool i) in one float64 numpy call, bit-identical per row to
    ``models[s].tpd_fast(placements[i])`` — which is how the batched
    runner stays bit-identical to the sequential one.

    The stacked (A, S, C) attribute table is rebuilt lazily whenever any
    pool's mutation version changes (event schedules bump it), so
    mid-run churn/drift/straggler mutations are reflected in the very
    next call.

    ``shard``: ``"off"`` runs the float64 numpy path on the host, one
    call for all rows; ``"on"`` always runs :meth:`tpds_sharded` (the
    device-sharded build, over the devices of the models' type: the
    cards, or the host); ``"auto"`` (default) shards only when the
    models are on ``cuda``, more than one card is visible and there are
    at least as many rows as cards (the reference's rule over
    ``jax.local_device_count()``), else takes the numpy path: on one
    card it is the bit-identity pin of the goldens.
    """

    def __init__(self, models: Sequence[CostModel], shard: str = "auto"):
        if not models:
            raise ValueError("need at least one cost model")
        if shard not in ("auto", "on", "off"):
            raise ValueError(f"unknown shard mode {shard!r}; use "
                             f"'auto', 'on' or 'off'")
        m0 = models[0]
        for m in models[1:]:
            if m.hierarchy != m0.hierarchy:
                raise ValueError("pooled evaluation needs one shared "
                                 "hierarchy shape")
            if m.memory_penalty != m0.memory_penalty:
                raise ValueError("pooled evaluation needs one shared "
                                 "memory penalty")
            if type(m) is not type(m0):
                raise ValueError("pooled evaluation needs one cost-model "
                                 "type")
            pod, pod0 = getattr(m, "pod_of", None), \
                getattr(m0, "pod_of", None)
            if (pod is None) != (pod0 is None) or \
                    (pod is not None and not np.array_equal(pod, pod0)) or \
                    getattr(m, "ici_cost", 0.0) != \
                    getattr(m0, "ici_cost", 0.0) or \
                    getattr(m, "dcn_cost", 0.0) != \
                    getattr(m0, "dcn_cost", 0.0):
                raise ValueError("pooled evaluation needs one shared pod "
                                 "topology")
            if m._calibration_terms() != m0._calibration_terms():
                raise ValueError("pooled evaluation needs one shared "
                                 "calibration (payload_scale/level_link/"
                                 "train_scale)")
        self.models = list(models)
        self.shard = shard
        self._versions: Optional[tuple] = None
        self._fn = None
        self._shard_fn = None
        self._shard_versions: Optional[tuple] = None

    def _check_aligned(self) -> None:
        """Elastic runs retarget models in place; a rebuild must not mix
        topology epochs (the batched runner groups runs into
        same-hierarchy cohorts before pooling)."""
        for m in self.models[1:]:
            if m.hierarchy != self.models[0].hierarchy:
                raise ValueError("pooled evaluation needs one shared "
                                 "hierarchy shape")

    def _device_count(self) -> int:
        """Visible devices of the models' type (the reference's
        ``jax.local_device_count()``): the cards, or 1 host."""
        if self.models[0].device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def tpds(self, placements, pool_idx=None) -> np.ndarray:
        placements = np.asarray(placements, np.int32)
        if self.shard != "off":
            ndev = self._device_count()
            if self.shard == "on" or (ndev > 1
                                      and placements.shape[0] >= ndev):
                return self.tpds_sharded(placements, pool_idx, ndev)
        versions = tuple(m._client_token() for m in self.models)
        if self._fn is None or versions != self._versions:
            self._check_aligned()
            attrs = np.stack(
                [m._attr_stack(np.float64) for m in self.models], axis=1)
            self._fn = self.models[0]._make_batch_tpd(
                dtype=np.float64, pool_attrs=attrs)
            self._versions = versions
        return self._fn(placements, pool_idx)

    def tpds_sharded(self, placements, pool_idx=None,
                     ndev: Optional[int] = None) -> np.ndarray:
        """The device-sharded pooled call, explicitly (what ``tpds``
        dispatches to for ``shard="on"`` and on a multi-card host):
        placement rows split over a 1-D ``("rows",)`` mesh of ``ndev``
        entries (default: the visible devices; entries past them repeat
        the cards round-robin, so ``ndev=8`` on one card runs 8 shards
        on it) through ``fl.distributed.shard_rows``. Each shard scores
        its rows with the float64 torch build of the pooled closure
        (:meth:`CostModel._make_pooled_torch_tpd`) on its device, and
        the full (P,) vector is reassembled by the segment-sum merge.
        Numerically it is the torch build of the numpy exact path (same
        reduction order per row), so any deltas are float64 round-off,
        held within rtol 1e-12 of the sequential ``tpds`` oracle.
        """
        from repro_torch.fl.distributed import shard_rows
        from repro_torch.launch.mesh import row_mesh
        placements = np.asarray(placements, np.int32)
        n_rows = placements.shape[0]
        rows = np.arange(n_rows) if pool_idx is None \
            else np.asarray(pool_idx)
        ndev = self._device_count() if ndev is None else int(ndev)
        ndev = max(1, min(ndev, n_rows))
        versions = tuple(m._client_token() for m in self.models)
        if self._shard_fn is None or self._shard_versions != versions:
            self._check_aligned()
            attrs = np.stack(
                [m._attr_stack(np.float64) for m in self.models], axis=1)
            self._shard_fn = self.models[0]._make_pooled_torch_tpd(attrs)
            self._shard_versions = versions
        mesh = row_mesh(ndev, self.models[0].device)
        run = shard_rows(self._shard_fn, mesh, n_rows)
        out = run(torch.from_numpy(placements), torch.from_numpy(rows))
        return out.cpu().numpy().astype(np.float64)


@dataclass(frozen=True)
class TwoTierCostModel(CostModel):
    """Eq. 6 extended with link-tier communication costs: the paper's
    cost model mapped onto a two-tier (pod) topology.

    Every child->aggregator edge pays a per-payload transfer cost that
    depends on whether the two clients share a pod: intra-pod edges ride
    the fast tier (``ici_cost``), cross-pod edges the ~10x slower one
    (``dcn_cost``). A placement optimizer over this model learns *pod
    locality* with zero topology knowledge.

    The CUDA TPD kernel does not price pod edges, so ``batch_tpd``
    never picks it here and refuses ``backend='kernel'``; the
    ``"torch"`` build carries the edge costs (the reference's jit
    build, in torch).
    """
    pod_of: Optional[np.ndarray] = None   # (n_clients,) pod index
    ici_cost: float = 0.005               # delay per payload unit, same pod
    dcn_cost: float = 0.05                # delay per payload unit, cross-pod

    def _edge_cost(self, host: int, child: int) -> float:
        if self.pod_of is None:
            return 0.0
        same = self.pod_of[host] == self.pod_of[child]
        rate = self.ici_cost if same else self.dcn_cost
        return float(self.clients.mdatasize[child]) * rate

    def cluster_delay(self, host: int, children: Sequence[int]) -> float:
        base = super().cluster_delay(host, children)
        comm = sum(self._edge_cost(host, c) for c in children)
        return base + comm

    def _make_device_tpd(self, kernel: bool):
        """The pod-aware float32 evaluator in torch ops on
        ``self.device`` (``batch_tpd(backend='torch')``).

        The same closure as the numpy build: trainer loads and trainer
        edge costs summed per leaf in float64 in ascending id order
        (:func:`~repro_torch.kernels.tpd.leaf_loads`, np.bincount's
        order) and rounded to float32; child sums over the kid columns
        left to right; level maxima summed deepest level first.
        """
        if kernel or self.pod_of is None:   # batch_tpd keeps pods off the kernel
            return super()._make_device_tpd(kernel)
        h = self.hierarchy
        dev = self.device
        n_leaves, D = h.n_leaves, h.dimensions
        leaf_start = h.level_starts[h.depth - 1]
        mds, pspeed, memcap, pods = torch.as_tensor(
            self._attr_stack(np.float32), device=dev).unbind(0)
        kids_np = h.kids_table[:leaf_start]
        kids = torch.as_tensor(np.clip(kids_np, 0, D - 1), device=dev)
        kids_valid = torch.as_tensor(kids_np >= 0, device=dev)
        bounds = [int(b) for b in h.level_starts]
        penalty = float(self.memory_penalty)
        ici, dcn = float(self.ici_cost), float(self.dcn_cost)

        def run(placements):
            p = self._device_placements(placements).long()
            placed = torch.zeros((p.shape[0], mds.shape[0]),
                                 dtype=torch.bool, device=dev)
            placed.scatter_(1, p, True)
            unplaced = ~placed
            leaf_of = (torch.cumsum(unplaced, dim=1) - 1) % n_leaves
            host_pod = pods[p]                               # (P, D)
            t_host_pod = host_pod.gather(1, leaf_start + leaf_of)
            t_rate = torch.where(pods[None] == t_host_pod,
                                 torch.tensor(ici, device=dev),
                                 torch.tensor(dcn, device=dev))
            leaf_load = leaf_loads(p, mds, n_leaves)         # (P, L)
            edge_leaf = leaf_loads(p, mds[None] * t_rate, n_leaves)
            kid_host = p[:, kids]                            # (P, D-L, W)
            kid_mds = torch.where(kids_valid[None], mds[kid_host], 0.0)
            kid_rate = torch.where(pods[kid_host] == host_pod[
                :, :leaf_start, None], torch.tensor(ici, device=dev),
                torch.tensor(dcn, device=dev))
            kid_edge = torch.where(kids_valid[None], kid_mds * kid_rate,
                                   0.0)
            child, edge_int = kid_mds[..., 0], kid_edge[..., 0]
            for w in range(1, kid_mds.shape[-1]):            # in order
                child = child + kid_mds[..., w]
                edge_int = edge_int + kid_edge[..., w]
            load = mds[p] + torch.cat([child, leaf_load], dim=1)
            delay = load / pspeed[p]
            if penalty > 0:
                cap = memcap[p]
                over = torch.clamp_min(load - cap, 0.0)
                delay = delay * (1.0 + penalty * over
                                 / torch.clamp_min(cap, 1e-9))
            delay = delay + torch.cat([edge_int, edge_leaf], dim=1)
            total = torch.zeros(p.shape[0], dtype=torch.float32,
                                device=dev)
            for lv in range(len(bounds) - 2, -1, -1):  # deepest first
                total = total + delay[:, bounds[lv]:bounds[lv + 1]].amax(1)
            return total.cpu().numpy()

        return run

    def cross_pod_edges(self, placement) -> tuple:
        """(cross, total) aggregation edges — the locality metric.

        Vectorized: internal edges come straight from the placement's
        kid-slot gather; trainer edges from the canonical round-robin
        split (rank among unplaced ids, mod leaves).
        """
        h = self.hierarchy
        placement = np.asarray(placement, np.int64)
        C, D = h.total_clients, h.dimensions
        leaf_start = h.level_starts[h.depth - 1]
        # trainer -> leaf-aggregator edges (duplicate placement ids are
        # legal: they shrink the placed set, so count actual trainers)
        unplaced = np.ones(C, bool)
        unplaced[placement] = False
        trainers = np.nonzero(unplaced)[0]
        total = (D - 1) + len(trainers)  # every non-root member: 1 edge
        if self.pod_of is None:
            return 0, total
        pod = np.asarray(self.pod_of)
        # internal slot -> parent-slot edges
        kid_slots = np.arange(1, D)
        host_pod = pod[placement[(kid_slots - 1) // h.width]]
        cross = int(np.count_nonzero(host_pod != pod[placement[kid_slots]]))
        leaf_of = np.arange(len(trainers)) % h.n_leaves
        t_host_pod = pod[placement[leaf_start + leaf_of]]
        cross += int(np.count_nonzero(t_host_pod != pod[trainers]))
        return cross, total

    def _cross_pod_edges_ref(self, placement) -> tuple:
        """Scalar reference for :meth:`cross_pod_edges` (parity oracle)."""
        h = self.hierarchy
        placement = np.asarray(placement, np.int64)
        children = h.children_clients(placement)
        cross = total = 0
        for s in range(h.dimensions):
            host = int(placement[s])
            for c in children[s]:
                total += 1
                if self.pod_of is not None and \
                        self.pod_of[host] != self.pod_of[c]:
                    cross += 1
        return cross, total


@dataclass(frozen=True)
class CalibratedCostModel(CostModel):
    """Eq. 6/7 with trace-fitted parameters (``repro_torch.calibration``).

    The emulated track's deterministic engine charges

        delay_cluster = (sum_members mdatasize / PAYLOAD_SCALE) / pspeed
                        + comm_latency * n_members
        train_c       = local_steps / pspeed_c

    none of which the analytic base model prices. The fitted twin adds
    exactly those degrees of freedom, all linear in trace features:

    * ``payload_scale`` — multiplies the eq. 6 payload (the emulated
      engine's ``1 / EQ6_PAYLOAD_SCALE``);
    * ``level_link`` — per-level delay per cluster member (the
      ``comm_latency`` hop term; one beta per tree level, the last
      entry covering any deeper level);
    * ``train_scale`` — work units per local-training pass; charged as
      ``train_scale * max_c(1 / pspeed_c)``, a placement-independent
      offset that makes predicted TPDs comparable to the emulated
      ``train + agg`` composition.

    Neutral values (1.0, (), 0.0) make every evaluator bit-identical to
    the base :class:`CostModel`, the CUDA kernel included. The numpy
    paths ride the SAME ``_make_batch_tpd`` closure (the calibrated
    branches switch on via ``_calibration_terms``), so ``batch_tpd``/
    ``tpd_fast``/``PooledTPDEvaluator`` need no new plumbing; the
    ``"torch"`` backend is :meth:`CostModel._make_device_tpd`. The
    CUDA TPD kernel does not price the calibrated terms: auto-selection
    never picks it here and ``backend='kernel'`` is refused.
    """
    payload_scale: float = 1.0
    level_link: Tuple[float, ...] = ()
    train_scale: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "level_link",
                           tuple(float(b) for b in self.level_link))

    def _link_cost(self, level: int, n_members: int) -> float:
        if not self.level_link:
            return 0.0
        beta = self.level_link[min(level, len(self.level_link) - 1)]
        return beta * n_members

    def calibrated_cluster_delay(self, host: int, children, level: int
                                 ) -> float:
        """Eq. 6 with the fitted payload scale, memcap penalty on the
        scaled payload, and the per-level per-member link charge."""
        mds = self.clients.mdatasize
        load = mds[host] + sum(mds[c] for c in children)
        load = load * self.payload_scale
        delay = load / self.clients.pspeed[host]
        if self.memory_penalty > 0:
            over = max(0.0, load - self.clients.memcap[host])
            delay *= 1.0 + self.memory_penalty * over / max(
                self.clients.memcap[host], 1e-9)
        return float(delay + self._link_cost(level, len(children) + 1))

    def train_time(self) -> float:
        """The fitted local-training bottleneck: placement-independent,
        so it never moves the argmin — it aligns predicted TPD with the
        emulated ``train + agg`` total."""
        if self.train_scale == 0.0:
            return 0.0
        return float(self.train_scale
                     * (1.0 / np.asarray(self.clients.pspeed)).max())

    def tpd(self, placement: Sequence[int]) -> float:
        """Scalar reference of the calibrated eq. 7 (the parity oracle
        the shared vectorized closure stays bit-identical to)."""
        h = self.hierarchy
        children = h.children_clients(placement)
        total = 0.0
        for level in range(h.depth - 1, -1, -1):
            worst = 0.0
            for s in range(h.level_starts[level],
                           h.level_starts[level + 1]):
                worst = max(worst, self.calibrated_cluster_delay(
                    int(placement[s]), children[s], level))
            total += worst
        return total + self.train_time()

    def cluster_delay(self, host: int, children: Sequence[int]) -> float:
        """Level-free callers get the scaled eq. 6 without the link
        charge (levels are a placement-walk property)."""
        mds = self.clients.mdatasize
        load = (mds[host] + sum(mds[c] for c in children)) \
            * self.payload_scale
        delay = load / self.clients.pspeed[host]
        if self.memory_penalty > 0:
            over = max(0.0, load - self.clients.memcap[host])
            delay *= 1.0 + self.memory_penalty * over / max(
                self.clients.memcap[host], 1e-9)
        return float(delay)
