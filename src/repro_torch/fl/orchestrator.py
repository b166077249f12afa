"""The SDFL coordinator: federated rounds with black-box TPD measurement.

The port of ``repro.fl.orchestrator``: the single-host emulation of the
paper's docker/MQTT deployment (Sec. IV-C). N heterogeneous clients
train a real model (the paper's 1.8M-param MLP by default) on non-IID
partitions; every round a placement strategy proposes the aggregation
tree; aggregation is computed cluster by cluster with per-cluster
timing; the round's Total Processing Delay composes the per-cluster
times exactly like the physical system would experience them:

    TPD = max_c (local train time) + sum_levels max_cluster (agg time)

Heterogeneity: each client's measured compute time is scaled by
1/pspeed_c. The coordinator never reads pspeed to *decide* anything:
the strategy only ever sees the final TPD (black-box, as in the paper).

Two round engines drive the same semantics, on the device the caller
names (``cuda`` unless ``device="cpu"``):

* ``engine='batched'`` (default): every client's params ride a leading
  ``C`` dim in the aggregator's client rows; local training is one
  batched computation per round (per batch-shape bucket) — the MLP's
  products become batched matrix products, one per client, and one
  backward pass gives every client's gradient — and aggregation is ONE
  launch of the FedAvg kernel per tree level
  (:class:`~repro_torch.fl.aggregation.SegmentAggregator`).
* ``engine='loop'``: the per-client / per-cluster dispatch. Each
  cluster's sum is ``kernels.ops.fedavg_tree``: one launch of the flat
  FedAvg kernel per cluster.

``timing='deterministic'`` charges eq. 6 unit work through the same
black-box interface and needs no device synchronisation;
``timing='measured'`` reads the wall clock and synchronises the device
wherever the reference blocks on a result.

``run_round_faulty`` is the emulated fault track's round: a round with
no faults is ``run_round`` itself; a faulty one trains the live cohort
and merges the surviving updates flat through the quorum-gated
``quorum_merge_batched``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, slot_remap
from repro_torch.core.placement import PlacementStrategy
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.faults.tolerance import quorum_count, quorum_merge_batched
from repro_torch.fl.aggregation import SegmentAggregator
from repro_torch.fl.distributed import elastic_rehierarchize
from repro_torch.kernels import ops
from repro_torch.models.api import Model
from repro_torch.utils.trees import tree_flatten, tree_leaves, tree_map, tree_scale

# rng stream tag for elastic data provisioning: joiner shards draw from
# a dedicated stream so admitting clients never perturbs the training /
# noise rng sequences of the surviving population
_ELASTIC_STREAM = 0xE1A57


@dataclass
class RoundRecord:
    round_idx: int
    placement: list
    tpd: float
    train_time: float
    agg_time: float
    loss: float
    accuracy: float


@dataclass
class FederatedRunResult:
    strategy: str
    rounds: List[RoundRecord] = field(default_factory=list)

    @property
    def tpds(self) -> np.ndarray:
        return np.asarray([r.tpd for r in self.rounds])

    @property
    def total_processing_time(self) -> float:
        return float(self.tpds.sum())

    def summary(self) -> dict:
        if not self.rounds:  # zero rounds: well-defined empties, no NaN
            return {"strategy": self.strategy, "rounds": 0,
                    "total_tpd": 0.0, "mean_tpd": 0.0,
                    "last10_mean_tpd": 0.0, "final_accuracy": 0.0}
        return {
            "strategy": self.strategy,
            "rounds": len(self.rounds),
            "total_tpd": self.total_processing_time,
            "mean_tpd": float(self.tpds.mean()),
            "last10_mean_tpd": float(self.tpds[-10:].mean()),
            "final_accuracy": self.rounds[-1].accuracy,
        }


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)[0]`` summed over any
    leading client dim: with client-stacked params, each client's loss
    depends on its own params only, so the sum's gradient is every
    client's own gradient. A leaf the loss does not read (an empty
    stack: a hybrid model with no full triple) gets a zero gradient, as
    ``jax.grad`` gives."""
    leaves, rebuild = tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss, _ = loss_fn(rebuild(live), batch)
    grads = torch.autograd.grad(loss.sum(), live, allow_unused=True)
    return loss.detach(), rebuild([torch.zeros_like(x) if g is None else g
                                   for x, g in zip(live, grads, strict=True)])


class FederatedOrchestrator:
    """Runs FL rounds against a strategy, measuring black-box TPD.

    The training population is ELASTIC: :meth:`admit` / :meth:`retire`
    resize the live run mid-flight (joiners train from the current
    global model and get fresh data shards; survivors keep theirs), and
    :meth:`sync_population` reconciles hierarchy/data/engine state after
    event-driven pool resizes."""

    def __init__(self, model: Model, hierarchy: Hierarchy,
                 clients: ClientPool, data: FederatedDataset, *,
                 local_lr: float = 0.05, local_steps: int = 4,
                 batch_size: int = 32, time_scale: float = 1.0,
                 comm_latency: float = 0.0, seed: int = 0,
                 rng_noise: float = 0.0, timing: str = "measured",
                 engine: str = "auto", device="cuda"):
        """``timing``: 'measured' uses wall-clock (the docker-faithful
        mode — requires a quiet machine); 'deterministic' charges eq.6
        unit-work/pspeed delays through the SAME black-box interface.
        Training math is identical.

        ``engine``: 'batched' (client-stacked training + one kernel
        launch per level), 'loop' (per-client dispatch), or 'auto'
        (batched). ``device``: where params, batches and the kernels
        live."""
        assert len(clients) == hierarchy.total_clients == data.n_clients
        self.model = model
        self.hierarchy = hierarchy
        self.clients = clients
        self.data = data
        self.local_steps = local_steps
        self.batch_size = batch_size
        self.time_scale = time_scale
        self.comm_latency = comm_latency
        self.rng = np.random.default_rng(seed)
        self.rng_noise = rng_noise
        assert timing in ("measured", "deterministic")
        self.timing = timing
        assert engine in ("auto", "loop", "batched")
        self.engine = "batched" if engine == "auto" else engine
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full float32 matmuls, as the reference's float32 jnp
            # products (PyTorch's default, stated and set)
            torch.backends.cuda.matmul.allow_tf32 = False

        # initial params from a host generator: one seed gives the same
        # params on every device (not jax.random's bits — parity tests
        # copy the reference's params in through set_global)
        self.params = model.init(torch.Generator().manual_seed(seed),
                                 self.device)
        self.local_lr = local_lr
        self.weights = data.client_weights()

        # batched engine state (built lazily)
        self._agg: Optional[SegmentAggregator] = None
        self._eval_batches: Dict[int, dict] = {}

        # elastic population state
        self.topology_version = 0
        self._capacity = max(hierarchy.max_clients, len(clients))
        self._elastic_rng = np.random.default_rng((seed, _ELASTIC_STREAM))

        # trace recording: when enabled, each round captures per-client
        # train times and per-level/per-cluster aggregation delays into
        # ``last_timings``; it reads values the engines already computed
        self.record_timings = False
        self.last_timings: Optional[dict] = None
        self._trace: Optional[dict] = None

    # ==================================================================
    # device plumbing
    # ==================================================================
    def _block(self) -> None:
        """The reference's ``block_until_ready``: measured timing waits
        for the device; deterministic timing never needs to."""
        if self.timing == "measured" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # ==================================================================
    # deterministic per-cluster delay (eq. 6), shared by both engines
    # ==================================================================
    # eq. 6 payload units / this = charged delay units: puts aggregation
    # in the paper's regime (the 30 MB JSON model on a 64 MB container
    # dominated the 20-30 s docker rounds)
    EQ6_PAYLOAD_SCALE = 10.0

    def _det_cluster_work(self, member_clients: Sequence[int]) -> float:
        """eq. 6 payload units: own + ACTUAL children model payloads."""
        mds = self.clients.mdatasize
        return float(sum(mds[int(c)] for c in member_clients)) \
            / self.EQ6_PAYLOAD_SCALE

    def _cluster_time(self, host: int, dt: float, n_parts: int) -> float:
        """Emulated heterogeneity + comm hops + optional noise."""
        t = dt / self.clients.pspeed[host] + self.comm_latency * n_parts
        if self.rng_noise:
            t *= 1.0 + self.rng.normal(0, self.rng_noise)
        return t

    # ==================================================================
    # loop engine (per-client / per-cluster dispatch)
    # ==================================================================
    def _local_train(self, client_id: int, round_idx: int):
        """Client's local steps. Returns (new_params, loss, measured_time)."""
        params = self.params
        t0 = time.perf_counter()
        loss = 0.0
        for s in range(self.local_steps):
            batch = self._device_batch(self.data.client_batch(
                client_id, self.batch_size, round_idx * self.local_steps + s))
            lval, grads = _value_and_grad(self.model.loss_fn, params, batch)
            params = tree_map(lambda p, g: p - self.local_lr * g,
                              params, grads)
            loss = float(lval)
        self._block()
        if self.timing == "deterministic":
            dt = float(self.local_steps)  # unit work per local step
        else:
            dt = time.perf_counter() - t0
        return params, loss, dt / self.clients.pspeed[client_id]

    def _aggregate(self, updates: List, placement: np.ndarray):
        """Cluster-by-cluster aggregation with per-cluster timing.

        Returns (global_params, total_agg_time) where total_agg_time =
        sum over levels of the level's max cluster time (eq. 7 semantics,
        with per-cluster times instead of the model's estimate).
        """
        h = self.hierarchy
        weighted = [tree_scale(u, float(w))
                    for u, w in zip(updates, self.weights, strict=True)]
        trainers = h.trainer_assignment(placement)
        slot_value = [None] * h.dimensions
        mds = self.clients.mdatasize
        total = 0.0
        for level in range(h.depth - 1, -1, -1):
            level_max = 0.0
            row = None
            if self._trace is not None:
                row = {"level": level, "slots": [], "hosts": [],
                       "loads": [], "n_parts": [], "delays": []}
            for s in range(h.level_starts[level], h.level_starts[level + 1]):
                host = int(placement[s])
                parts = [weighted[host]]
                members = [host]
                kids = h.children_slots(s)
                if kids:
                    parts.extend(slot_value[k] for k in kids)
                    members.extend(int(placement[k]) for k in kids)
                else:
                    li = s - h.level_starts[h.depth - 1]
                    parts.extend(weighted[t] for t in trainers[li])
                    members.extend(trainers[li])
                t0 = time.perf_counter()
                acc = ops.fedavg_tree(parts, [1.0] * len(parts))
                self._block()
                if self.timing == "deterministic":
                    dt = self._det_cluster_work(members)
                else:
                    dt = time.perf_counter() - t0
                slot_value[s] = acc
                cluster_t = self._cluster_time(host, dt, len(parts))
                if row is not None:
                    row["slots"].append(s)
                    row["hosts"].append(host)
                    row["loads"].append(
                        float(sum(mds[int(c)] for c in members)))
                    row["n_parts"].append(len(parts))
                    row["delays"].append(float(cluster_t))
                level_max = max(level_max, cluster_t)
            if row is not None:
                self._trace["levels"].append(row)
            total += level_max
        return slot_value[0], total

    def _round_loop(self, r: int, placement: np.ndarray):
        updates, train_times = [], []
        for c in range(self.hierarchy.total_clients):
            p, _, t = self._local_train(c, r)
            updates.append(p)
            train_times.append(t)
        if self._trace is not None:
            self._trace["train"] = {
                "clients": list(range(self.hierarchy.total_clients)),
                "times": [float(t) for t in train_times]}
        new_params, agg_time = self._aggregate(updates, placement)
        return new_params, max(train_times), agg_time

    # ==================================================================
    # batched engine: client-stacked local steps + one launch per level
    # ==================================================================
    def _collect_batches(self, round_idx: int, ids=None):
        """Per-client step batches, bucketed by batch shape.

        Returns [(client_ids, stacked)] where stacked leaves are numpy
        (C_bucket, local_steps, batch, ...) — identical values to what
        the loop engine feeds step by step. ``ids`` restricts the
        cohort; ``None`` means every client, in id order.
        """
        if ids is None:
            ids = range(self.hierarchy.total_clients)
        buckets: Dict[tuple, list] = {}
        for c in ids:
            c = int(c)
            steps = [self.data.client_batch(
                c, self.batch_size, round_idx * self.local_steps + s)
                for s in range(self.local_steps)]
            sig = tuple(sorted((k, v.shape, str(np.asarray(v).dtype))
                               for k, v in steps[0].items()))
            buckets.setdefault(sig, []).append((c, steps))
        out = []
        for _sig, entries in buckets.items():
            ids = np.asarray([c for c, _ in entries], np.int64)
            keys = entries[0][1][0].keys()
            stacked = {k: np.stack([np.stack([np.asarray(st[k])
                                              for st in steps])
                                    for _, steps in entries])
                       for k in keys}
            out.append((ids, stacked))
        return out

    def _local_all(self, stack, batches: dict) -> None:
        """Every client of ``stack`` (a (Cb, ...) tree holding the
        starting params) takes its local SGD steps, in place; ``batches``
        are numpy (Cb, local_steps, batch, ...)."""
        dev = self._device_batch(batches)
        leaves = tree_leaves(stack)
        for s in range(self.local_steps):
            step = {k: v[:, s] for k, v in dev.items()}
            _, grads = _value_and_grad(self.model.loss_fn, stack, step)
            with torch.no_grad():
                for x, g in zip(leaves, tree_leaves(grads), strict=True):
                    x.sub_(self.local_lr * g)

    def _train_ids(self, round_idx: int, ids: np.ndarray):
        """Local training of the clients ``ids`` (strictly increasing)
        from the current global params. Returns ``(stack, wall)``: the
        (n, ...) updates row-aligned to ``ids`` — the aggregator's client
        rows when ``ids`` is the whole population — and the wall time."""
        C = self.hierarchy.total_clients
        if ids.size == C:
            if self._agg is None:
                self._agg = SegmentAggregator(self.hierarchy)
            stack = self._agg.client_stack(self.params)
        else:
            stack = tree_map(lambda p: torch.empty(
                (ids.size,) + tuple(p.shape), dtype=p.dtype,
                device=p.device), self.params)
        t0 = time.perf_counter()
        buckets = self._collect_batches(round_idx, ids)
        for bucket_ids, batches in buckets:
            if len(buckets) == 1:
                sub = stack
            else:
                sub = tree_map(lambda p: torch.empty(
                    (bucket_ids.size,) + tuple(p.shape), dtype=p.dtype,
                    device=p.device), self.params)
            with torch.no_grad():
                for x, g in zip(tree_leaves(sub), tree_leaves(self.params),
                                strict=True):
                    x.copy_(g.expand_as(x))
            self._local_all(sub, batches)
            if sub is not stack:
                at = torch.from_numpy(np.searchsorted(ids, bucket_ids)).to(
                    self.device)
                with torch.no_grad():
                    for x, y in zip(tree_leaves(stack), tree_leaves(sub),
                                    strict=True):
                        x.index_copy_(0, at, y)
        self._block()
        return stack, time.perf_counter() - t0

    def _train_all_batched(self, round_idx: int):
        """All clients' local training. Returns (stacked_updates (C,...),
        train_times (C,))."""
        C = self.hierarchy.total_clients
        stacked_updates, wall = self._train_ids(round_idx, np.arange(C))
        if self.timing == "deterministic":
            per_client_dt = float(self.local_steps)
        else:
            # one fused dispatch: attribute wall time evenly (the loop
            # engine measures each client; here C clients share the call)
            per_client_dt = wall / C
        train_times = per_client_dt / self.clients.pspeed
        return stacked_updates, train_times

    def _agg_batched(self, stacked_updates, placement: np.ndarray):
        """Per-level aggregation + per-cluster timing charge.

        Deterministic timing charges eq. 6 from the plan's ACTUAL member
        payloads (same formula, same rng stream as the loop engine);
        measured timing splits each level's wall clock across its
        clusters by payload share before the pspeed/comm composition.
        """
        h = self.hierarchy
        plan = h.round_plan(placement)
        mds = self.clients.mdatasize
        depth = h.depth

        def level_time(lp, cluster_dt, idx, raw_loads) -> float:
            """pspeed/comm/noise composition, vectorized per level (one
            rng draw per cluster, same stream order as the loop engine)."""
            ts = (cluster_dt / self.clients.pspeed[lp.hosts]
                  + self.comm_latency * lp.n_parts)
            if self.rng_noise:
                ts = ts * (1.0 + self.rng.normal(0, self.rng_noise,
                                                 size=lp.n_clusters))
            if self._trace is not None:
                level = depth - 1 - idx  # plan levels are deepest first
                start = h.level_starts[level]
                self._trace["levels"].append({
                    "level": level,
                    "slots": list(range(start, start + lp.n_clusters)),
                    "hosts": lp.hosts.tolist(),
                    "loads": np.asarray(raw_loads, np.float64).tolist(),
                    "n_parts": lp.n_parts.tolist(),
                    "delays": np.asarray(ts, np.float64).tolist()})
            return float(ts.max())

        if self.timing == "deterministic":
            # charge eq. 6 analytically; the levels run back to back on
            # the device (no per-level host syncs needed)
            new_global = self._agg.aggregate_fused(
                stacked_updates, self.weights, plan)
            total = 0.0
            for idx, lp in enumerate(plan.levels):
                loads = np.zeros(lp.n_clusters)
                np.add.at(loads, lp.seg, mds[lp.member_clients])
                total += level_time(lp, loads / self.EQ6_PAYLOAD_SCALE,
                                    idx, loads)
            return new_global, total

        weighted = self._agg.weighted(stacked_updates, self.weights)
        total = 0.0
        vals = None
        for idx, lp in enumerate(plan.levels):
            t0 = time.perf_counter()
            vals = self._agg.run_level(idx, weighted, vals, plan)
            self._block()
            wall = time.perf_counter() - t0
            loads = np.zeros(lp.n_clusters)
            np.add.at(loads, lp.seg, mds[lp.member_clients])
            total += level_time(lp, wall * loads / max(loads.sum(), 1e-12),
                                idx, loads)
        return tree_map(lambda x: x[0].clone(), vals), total

    def _round_batched(self, r: int, placement: np.ndarray):
        if self._agg is None:
            self._agg = SegmentAggregator(self.hierarchy)
        stacked_updates, train_times = self._train_all_batched(r)
        if self._trace is not None:
            self._trace["train"] = {
                "clients": list(range(self.hierarchy.total_clients)),
                "times": np.asarray(train_times, np.float64).tolist()}
        new_params, agg_time = self._agg_batched(stacked_updates, placement)
        return new_params, float(np.max(train_times)), agg_time

    # ==================================================================
    # partial-cohort hooks (the online track's building blocks)
    # ==================================================================
    def train_cohort(self, ids, round_idx: int):
        """Local training for a client subset, from the CURRENT global.

        ``ids`` must be strictly increasing. Returns ``(stacked_updates,
        train_times)`` row-aligned to ``ids``. A full-population cohort
        routes through ``_train_all_batched`` — the exact path
        ``run_round`` uses — so a full-cohort call equals the
        synchronous round's training half.
        """
        ids = np.asarray(ids, np.int64)
        self._check_population()
        C = self.hierarchy.total_clients
        if ids.size and np.any(np.diff(ids) <= 0):
            raise ValueError("train_cohort ids must be strictly increasing")
        if ids.size == C:
            return self._train_all_batched(round_idx)
        if ids.size == 0:
            return None, np.zeros(0, np.float64)
        stacked_updates, wall = self._train_ids(round_idx, ids)
        if self.timing == "deterministic":
            per_client_dt = float(self.local_steps)
        else:
            per_client_dt = wall / ids.size
        train_times = per_client_dt / self.clients.pspeed[ids]
        return stacked_updates, train_times

    def aggregate_cohort(self, stacked_updates, placement):
        """Full-population hierarchical aggregation: the batched
        engine's path, returning ``(new_global, agg_time)`` WITHOUT
        committing the params (callers commit via :meth:`set_global`).
        Equal to ``run_round``'s aggregation half."""
        placement = np.asarray(placement, np.int64)
        self.hierarchy.validate_placement(placement)
        if self._agg is None:
            self._agg = SegmentAggregator(self.hierarchy)
        return self._agg_batched(stacked_updates, placement)

    def cluster_delay(self, host: int, member_clients, n_parts: int
                      ) -> float:
        """The eq. 6 delay one aggregation flush charges: payload work
        over the ACTUAL members' model sizes, scaled by the host's
        pspeed plus per-part comm latency."""
        dt = self._det_cluster_work(member_clients)
        return self._cluster_time(int(host), dt, int(n_parts))

    def evaluate_global(self) -> tuple:
        """(loss, accuracy) of the current global params — the same
        eval batch ``run_round`` scores with."""
        return self._evaluate()

    def set_global(self, params) -> None:
        """Commit a new global model."""
        self.params = params

    # ==================================================================
    def _evaluate(self, n: int = 512) -> tuple:
        if hasattr(self.data, "eval_batch"):
            batch = self._device_batch(self.data.eval_batch(n))
        else:
            # the base set never changes under a resize: keep the batch
            # on the device
            batch = self._eval_batches.get(n)
            if batch is None:
                base = self.data.base
                idx = np.arange(min(n, len(base)))
                batch = self._eval_batches[n] = self._device_batch(
                    {"x": base.features[idx], "y": base.labels[idx]})
        with torch.no_grad():
            loss, metrics = self.model.loss_fn(self.params, batch)
        acc = metrics.get("acc")
        return float(loss), float(acc) if acc is not None else 0.0

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run every path once before round 0 (the kernels build at first
        use), so round-0 timing is not skewed by one-time work."""
        if self.engine == "batched":
            if self._agg is None:
                self._agg = SegmentAggregator(self.hierarchy)
            stacked, _ = self._train_all_batched(0)
            noise, self.rng_noise = self.rng_noise, 0.0  # keep rng stream
            try:
                self._agg_batched(stacked,
                                  np.arange(self.hierarchy.dimensions))
            finally:
                self.rng_noise = noise
            self._evaluate()
            return
        batch = self._device_batch(self.data.client_batch(
            0, self.batch_size, 0))
        _value_and_grad(self.model.loss_fn, self.params, batch)
        self._block()
        h = self.hierarchy
        n_pool = h.total_clients - h.dimensions
        base, extra = divmod(n_pool, h.n_leaves)
        sizes = {h.width + 1, base + 1} | ({base + 2} if extra else set())
        for k in sorted(sizes):
            ops.fedavg_tree([self.params] * k, [1.0] * k)
            self._block()
        self._evaluate()

    # ==================================================================
    # elastic population: admit / retire / sync_population
    # ==================================================================
    def admit(self, memcap, pspeed, mdatasize=None
              ) -> Tuple[np.ndarray, Optional[TopologyUpdate]]:
        """Admit fresh clients into the LIVE training population: the
        pool grows, each joiner gets a data shard, the FedAvg weights are
        recomputed, and the tree is re-hierarchized when the growth
        crosses its capacity window. Returns ``(new client ids,
        TopologyUpdate or None)``. Joiners start their local steps from
        the CURRENT global params."""
        ids = self.clients.join(memcap, pspeed, mdatasize)
        return ids, self.sync_population()

    def retire(self, ids) -> Optional[TopologyUpdate]:
        """Retire clients from the live population: their data shards
        are dropped, survivors are renumbered contiguously, and the
        returned :class:`TopologyUpdate` carries the old->new id remap
        plus the ``slot_remap`` strategies use to repair placements."""
        self.clients.leave(ids)
        return self.sync_population()

    def sync_population(self) -> Optional[TopologyUpdate]:
        """Reconcile hierarchy + data + engine state with the (possibly
        resized) client pool; ``None`` when the population is untouched.

        Drains the pool's resize log, carries surviving data shards
        across the id remap (provisioning joiners), recomputes the FedAvg
        weights, re-hierarchizes through the capacity-window rule
        (:func:`elastic_rehierarchize`, the simulated track's) and
        retargets the aggregator.
        """
        drained = self.clients.drain_resizes()
        if drained is None:
            return None
        old_n, client_remap = drained
        old_h = self.hierarchy
        if old_n != old_h.total_clients:
            raise RuntimeError(
                f"pool resize log starts at {old_n} clients but the "
                f"hierarchy tracked {old_h.total_clients}")
        n = len(self.clients)
        resize = getattr(self.data, "resize", None)
        if resize is None:
            raise NotImplementedError(
                f"{type(self.data).__name__} has no resize(); elastic "
                f"populations need a dataset that can carry shards "
                f"across a pool resize")
        resize(client_remap, n, self._elastic_rng)
        self.weights = self.data.client_weights()
        new_h, self._capacity = elastic_rehierarchize(old_h, n,
                                                      self._capacity)
        self.topology_version += 1
        update = TopologyUpdate(
            version=self.topology_version,
            old_hierarchy=old_h, new_hierarchy=new_h,
            slot_remap=slot_remap(old_h, new_h),
            client_remap=client_remap)
        self.hierarchy = new_h
        if self._agg is not None:
            self._agg.retarget(new_h)
        return update

    def _check_population(self) -> None:
        """Round-time invariant: the population must be synced."""
        if self.clients.pending_remap() is not None:
            raise RuntimeError(
                "client pool was resized without sync_population(); use "
                "admit()/retire() (or drive rounds through "
                "EmulatedEnvironment, whose sync_topology wires "
                "ClientJoin/ClientLeave events here)")
        if not (len(self.clients) == self.hierarchy.total_clients
                == self.data.n_clients):
            raise RuntimeError(
                f"inconsistent population: pool={len(self.clients)} "
                f"hierarchy={self.hierarchy.total_clients} "
                f"data={self.data.n_clients}")

    def run_round(self, r: int, placement) -> RoundRecord:
        """Execute ONE federated round at ``placement`` and return its
        record (the black-box TPD plus train/agg split and eval metrics).
        Call ``warmup()`` once before the first round."""
        placement = np.asarray(placement, np.int64)
        self._check_population()
        self.hierarchy.validate_placement(placement)

        self.last_timings = None
        if self.record_timings:
            self._trace = {"train": {"clients": [], "times": []},
                           "levels": []}
        try:
            if self.engine == "loop":
                new_params, train_time, agg_time = \
                    self._round_loop(r, placement)
            else:
                new_params, train_time, agg_time = \
                    self._round_batched(r, placement)
        finally:
            if self._trace is not None:
                self._trace["train_time"] = 0.0
                self._trace["agg_time"] = 0.0
                self.last_timings, self._trace = self._trace, None
        self.params = new_params
        if self.last_timings is not None:
            self.last_timings["train_time"] = float(train_time)
            self.last_timings["agg_time"] = float(agg_time)

        tpd = (train_time + agg_time) * self.time_scale
        loss, acc = self._evaluate()
        return RoundRecord(
            round_idx=r, placement=placement.tolist(), tpd=tpd,
            train_time=train_time, agg_time=agg_time,
            loss=loss, accuracy=acc)

    def run_round_faulty(self, r: int, placement, *, down=(), dropped=(),
                         degraded=None, quorum_frac: float = 0.0
                         ) -> Tuple[RoundRecord, Dict[str, float]]:
        """One federated round under faults (the emulated track's fault
        path; ``repro_torch.faults``).

        ``down`` clients (crashed or partitioned this round) neither
        train nor deliver; ``dropped`` clients train but their updates
        are lost in transit; ``degraded`` maps clients to train-delay
        multipliers. Down aggregator HOSTS fail over to the lowest-id
        live unplaced client (black-box: no pspeed peeking). Surviving
        updates merge FLAT at the root — hierarchical FedAvg over the
        tree equals flat weighted FedAvg — through
        :func:`~repro_torch.faults.tolerance.quorum_merge_batched`,
        gated on live-population quorum and damped by the arrived
        fraction; a refused merge leaves the model untouched (a degraded
        flush). Aggregation time charges the eq. 6 per-cluster walk over
        the payloads actually present.

        A round with NO faults delegates to :meth:`run_round` verbatim
        (the FedAvg kernel's path on a card), so a zero-fault schedule
        stays bit-identical to the fault-free track. Returns ``(record,
        extra)`` where ``extra`` carries the fault series (merged /
        degraded_flushes / failovers / dropped_updates / down).
        """
        placement = np.asarray(placement, np.int64)
        self._check_population()
        self.hierarchy.validate_placement(placement)
        down = {int(c) for c in down}
        dropped = {int(c) for c in dropped}
        degraded = {int(c): float(f)
                    for c, f in sorted((degraded or {}).items())}
        C = self.hierarchy.total_clients
        if not down and not dropped and not degraded:
            rec = self.run_round(r, placement)
            return rec, {"merged": float(C), "degraded_flushes": 0.0,
                         "failovers": 0.0, "dropped_updates": 0.0,
                         "down": 0.0}
        if self.timing != "deterministic":
            raise ValueError(
                "run_round_faulty composes per-cluster delays "
                "analytically and needs timing='deterministic', got "
                f"{self.timing!r}")
        if self.engine != "batched":
            raise ValueError("run_round_faulty needs the batched round "
                             f"engine, got {self.engine!r}")

        cohort = np.asarray([c for c in range(C) if c not in down],
                            np.int64)
        if cohort.size == 0:
            raise RuntimeError(f"round {r}: every client is down")

        # aggregator failover: repair down hosts before anything runs
        eff = placement.copy()
        placed = {int(c) for c in eff}
        failovers = 0
        for s in range(len(eff)):
            if int(eff[s]) in down:
                repl = -1
                for c in range(C):
                    if c not in down and c not in placed:
                        repl = c
                        break
                if repl < 0:
                    raise RuntimeError(
                        f"aggregator failover for slot {s}: no live "
                        "unplaced client left")
                eff[s] = repl
                placed.add(repl)
                failovers += 1
        self.hierarchy.validate_placement(eff)

        stacked, train_times = self.train_cohort(cohort, r)
        train_times = np.asarray(train_times, np.float64).copy()
        for j in range(cohort.size):
            factor = degraded.get(int(cohort[j]))
            if factor is not None:
                train_times[j] *= factor
        train_time = float(train_times.max())

        merged_ids = np.asarray(
            [c for c in cohort.tolist() if c not in dropped], np.int64)
        need = quorum_count(max(1, C - len(down)), quorum_frac)
        if merged_ids.size < need:
            agg_time = 0.0
            merged = 0
            degraded_flush = 1.0
        else:
            rows = torch.as_tensor(np.searchsorted(cohort, merged_ids),
                                   device=self.device)
            sub = tree_map(lambda x: x.index_select(0, rows), stacked)
            base_w = self.weights[merged_ids]
            stal = np.zeros(merged_ids.size, np.float64)
            self.params = quorum_merge_batched(
                self.params, sub, base_w, stal, 0.0, 1.0,
                merged_ids.size / C)
            agg_time = self._faulty_agg_time(
                eff, {int(c) for c in merged_ids})
            merged = int(merged_ids.size)
            degraded_flush = 0.0

        tpd = (train_time + agg_time) * self.time_scale
        loss, acc = self._evaluate()
        rec = RoundRecord(
            round_idx=r, placement=eff.tolist(), tpd=tpd,
            train_time=train_time, agg_time=agg_time,
            loss=loss, accuracy=acc)
        extra = {
            "merged": float(merged),
            "degraded_flushes": degraded_flush,
            "failovers": float(failovers),
            "dropped_updates": float(
                len(dropped & {int(c) for c in cohort})),
            "down": float(len(down))}
        return rec, extra

    def _faulty_agg_time(self, placement: np.ndarray, merged: set
                         ) -> float:
        """eq. 7 composition of eq. 6 per-cluster delays over the
        payloads PRESENT under faults: a leaf cluster charges its
        merged trainers (plus the host's own update if it merged), an
        inner cluster charges its child hosts' forwarded partials.
        Reduces to the full ``_aggregate`` walk when everything merged."""
        h = self.hierarchy
        trainers = h.trainer_assignment(placement)
        leaf_start = h.level_starts[h.depth - 1]
        total = 0.0
        for level in range(h.depth - 1, -1, -1):
            level_max = 0.0
            for s in range(h.level_starts[level],
                           h.level_starts[level + 1]):
                host = int(placement[s])
                kids = h.children_slots(s)
                if kids:
                    present = [int(placement[k]) for k in kids]
                else:
                    li = s - leaf_start
                    present = [t for t in trainers[li] if t in merged]
                if host in merged:
                    present = [host] + present
                if not present:
                    continue
                dt = self._det_cluster_work(present)
                level_max = max(
                    level_max,
                    self._cluster_time(host, dt, len(present)))
            total += level_max
        return total

    # ==================================================================
    # checkpoint support: the non-param runtime state
    # ==================================================================
    def runtime_state(self) -> dict:
        """JSON-safe snapshot of the orchestrator state that is NOT the
        params (the rng stream positions and the elastic bookkeeping)."""
        return {"rng": self.rng.bit_generator.state,
                "elastic_rng": self._elastic_rng.bit_generator.state,
                "topology_version": int(self.topology_version),
                "capacity": int(self._capacity)}

    def load_runtime_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._elastic_rng.bit_generator.state = state["elastic_rng"]
        self.topology_version = int(state["topology_version"])
        self._capacity = int(state["capacity"])

    def run(self, strategy: PlacementStrategy, rounds: int,
            verbose: bool = False) -> FederatedRunResult:
        result = FederatedRunResult(strategy=strategy.name)
        self.warmup()
        for r in range(rounds):
            placement = np.asarray(strategy.propose(r), np.int64)
            record = self.run_round(r, placement)
            strategy.observe(placement, record.tpd)
            result.rounds.append(record)
            if verbose:
                print(f"[{strategy.name}] round {r:3d} "
                      f"tpd={record.tpd:8.4f} "
                      f"loss={record.loss:.4f} acc={record.accuracy:.3f}")
        return result
