"""Environments: one propose/observe world per evaluation track.

The port's simulated track (paper Fig. 3) and emulated track (paper
Fig. 4), held to ``repro.experiments.environments``. A strategy is
driven through the same loop as in the reference:

    env.begin()
    for r in range(rounds):
        p = strategy.propose(r)
        obs = env.step(r, p)
        strategy.observe(p, obs.tpd)

``SimulatedEnvironment`` wraps :class:`repro_torch.core.cost_model.
CostModel` (or the two-tier pod variant); its ``step`` scores with the
exact float64 numpy path, and swarm-mode callers (``FlagSwapPSO.run``
with ``batch_fitness_fn``) score on the cost model's device.
``EmulatedEnvironment`` wraps
:class:`repro_torch.fl.orchestrator.FederatedOrchestrator`: its ``step``
runs a real federated round on the caller's device, through the fault
path (``run_round_faulty``) when the scenario schedules faults or a
quorum. ``OnlineEnvironment`` drives the same orchestrator
asynchronously on a virtual clock: a discrete-event queue of jittered
arrivals, count-or-deadline buffer flushes charging eq. 6, and
staleness-weighted root merges (its degenerate config runs lockstep,
bit-identical to the emulated track). The simulated track prices with
the analytic model or, under ``EvalConfig(cost_source="calibrated")``,
with the trace-fitted :class:`~repro_torch.core.cost_model.
CalibratedCostModel`. Every environment checkpoints and restores its
run state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, TwoTierCostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, slot_remap
from repro_torch.faults import (
    AggregatorFailure,
    ClientCrash,
    ClientRecover,
    FaultAt,
    FaultSchedule,
    LinkDegrade,
    NetworkPartition,
    RetryPolicy,
    UpdateDrop,
    fault_from_dict,
    quorum_count,
    quorum_merge_batched,
)
from repro_torch.fl.distributed import elastic_rehierarchize
from repro_torch.online import (
    AggregatorBuffer,
    ArrivalProcess,
    AsyncConfig,
    BufferDeadline,
    BufferedPart,
    BufferEntry,
    PartialArrival,
    RootComplete,
    UpdateArrival,
    VirtualClock,
    async_merge_batched,
    flush_count,
)
from repro_torch.utils.trees import tree_map


@dataclass
class RoundObservation:
    """What one environment step hands back to the runner/strategy."""
    round_idx: int
    placement: np.ndarray
    tpd: float                              # the black-box signal
    metrics: Dict[str, float] = field(default_factory=dict)
    topology_version: int = 0               # elastic re-hierarchizations
    log: List[str] = field(default_factory=list)  # env trace (online)
    # ONE uniform timing mapping across all environment kinds (empty
    # unless the environment's ``record_timings`` flag is on):
    #   {"train": {"clients": [...], "times": [...]},
    #    "levels": [{"level", "slots", "hosts", "loads", "n_parts",
    #                "delays"}, ...]   (deepest level first),
    #    "train_time": float, "agg_time": float}
    timings: Dict = field(default_factory=dict)


@runtime_checkable
class Environment(Protocol):
    """The propose/observe world every strategy runs against."""
    kind: str
    hierarchy: Hierarchy
    clients: ClientPool

    def begin(self) -> None:
        """One-time setup (compile/warmup) before round 0."""
        ...

    def step(self, round_idx: int, placement) -> RoundObservation:
        """Execute/evaluate one round at ``placement``."""
        ...

    def sync_topology(self) -> Optional[TopologyUpdate]:
        """Reconcile the topology with the (possibly resized) client
        pool; returns the update strategies must migrate through, or
        ``None`` when nothing changed."""
        ...


class SimulatedEnvironment:
    """The Fig. 3 world: rounds cost what eqs. 6-7 say they cost.

    Exposes ``cost_model`` (scalar + swarm-vectorized evaluators) so
    swarm-mode callers ride the same object the step loop uses. The cost
    model reads the pool by reference — event schedules that mutate
    ``clients`` in place are reflected in the very next ``step``.

    The topology is ELASTIC: after ``ClientJoin``/``ClientLeave`` events
    resize the pool, :meth:`sync_topology` re-hierarchizes whenever the
    population leaves the current tree's capacity window, bumps
    ``topology_version``, and retargets the cost model in place — the
    returned :class:`TopologyUpdate` carries the slot/client remaps the
    strategies' ``migrate`` hooks consume.
    """
    kind = "simulated"

    def __init__(self, hierarchy: Hierarchy, clients: ClientPool,
                 cost_model: Optional[CostModel] = None, *,
                 device="cuda"):
        self.hierarchy = hierarchy
        self.clients = clients
        self.cost_model = cost_model if cost_model is not None \
            else CostModel(hierarchy, clients, device=device)
        self.topology_version = 0
        self.record_timings = False
        # scenarios may start deliberately overstuffed (large-10k packs
        # ~7 trainers/leaf): the grow threshold honors the construction-
        # time population so a stray join doesn't snap the tree
        self._capacity = max(hierarchy.max_clients, len(clients))

    def begin(self) -> None:
        pass

    def sync_topology(self) -> Optional[TopologyUpdate]:
        """Reconcile hierarchy with the pool after this round's events.

        Drains the pool's resize log (composing the old->new client id
        remap). Any resize yields a new hierarchy; the STRUCTURE is
        rebuilt when the population crossed the capacity window, within
        it only ``n_clients`` is re-pinned. Deterministic: no rng is
        consumed.
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
        new_h, self._capacity = elastic_rehierarchize(old_h, n,
                                                      self._capacity)
        self.topology_version += 1
        update = TopologyUpdate(
            version=self.topology_version,
            old_hierarchy=old_h, new_hierarchy=new_h,
            slot_remap=slot_remap(old_h, new_h),
            client_remap=client_remap)
        self.hierarchy = new_h
        self.cost_model.retarget(new_h)
        return update

    def step(self, round_idx: int, placement) -> RoundObservation:
        # single-placement fast path: the cached exact (float64 numpy)
        # evaluator, bit-identical to CostModel.tpd
        placement = np.asarray(placement, np.int64)
        self.hierarchy.validate_placement(placement)
        tpd = self.cost_model.tpd_fast(placement)
        timings = self._analytic_timings(placement, tpd) \
            if self.record_timings else {}
        return RoundObservation(round_idx=round_idx, placement=placement,
                                tpd=tpd, timings=timings,
                                topology_version=self.topology_version)

    def _analytic_timings(self, placement: np.ndarray, tpd: float) -> Dict:
        """The uniform per-level timing rows, from the analytic model:
        each cluster's eq. 6 delay plus its raw payload load and part
        count — the same row schema the executing tracks record. No
        train section: the analytic track has no clients to train."""
        h = self.hierarchy
        cm = self.cost_model
        mds = self.clients.mdatasize
        children = h.children_clients(placement)
        levels = []
        for level in range(h.depth - 1, -1, -1):
            row = {"level": level, "slots": [], "hosts": [], "loads": [],
                   "n_parts": [], "delays": []}
            for s in range(h.level_starts[level],
                           h.level_starts[level + 1]):
                host = int(placement[s])
                kids = children[s]
                row["slots"].append(s)
                row["hosts"].append(host)
                row["loads"].append(float(
                    mds[host] + sum(mds[int(c)] for c in kids)))
                row["n_parts"].append(len(kids) + 1)
                row["delays"].append(cm.cluster_delay(host, kids))
            levels.append(row)
        return {"train": {"clients": [], "times": []}, "levels": levels,
                "train_time": 0.0, "agg_time": float(tpd)}

    # -- checkpoint/restore --------------------------------------------------
    def checkpoint_state(self) -> dict:
        return {"kind": self.kind,
                "topology_version": int(self.topology_version),
                "capacity": int(self._capacity)}

    def restore_state(self, state: dict, store=None) -> None:
        self.topology_version = int(state["topology_version"])
        self._capacity = int(state["capacity"])


class SampledSimulatedEnvironment(SimulatedEnvironment):
    """The simulated world at cross-device scale: a resident ``pool``
    of ``spec.pool_size`` clients, of which only a per-round sampled
    cohort participates.

    ``self.clients`` is the COHORT VIEW — a small :class:`ClientPool`
    whose attribute arrays are rewritten in place from the resident
    pool at every :meth:`sync_topology`. Event schedules mutate the
    RESIDENT pool (:attr:`event_pool`). Cohort draws are counter-based
    (``CohortSampler.draw(round, n)``), so every replay draws the same
    cohort sequence.
    """

    def __init__(self, hierarchy: Hierarchy, cohort_view: ClientPool,
                 cost_model: CostModel, pool: ClientPool, sampler):
        super().__init__(hierarchy, cohort_view, cost_model)
        self.pool = pool
        self.sampler = sampler
        self._round_next = 0

    @property
    def event_pool(self) -> ClientPool:
        """Where event schedules apply: the resident pool."""
        return self.pool

    def sync_topology(self) -> Optional[TopologyUpdate]:
        # 1) reconcile pool resizes with the sampling stream
        drained = self.pool.drain_resizes()
        if drained is not None:
            self.sampler.migrate(drained[1])
        # 2) draw this round's cohort from its counter-based stream
        cohort = self.sampler.draw(self._round_next, len(self.pool))
        self._round_next += 1
        # 3) resize the cohort view if the draw size changed, through
        #    the view's own resize log
        k, old_k = len(cohort), len(self.clients)
        if k < old_k:
            self.clients.leave(np.arange(k, old_k))
        elif k > old_k:
            grow = k - old_k
            self.clients.join(memcap=np.zeros(grow),
                              pspeed=np.ones(grow))
        # 4) gather the cohort's attributes into the view in place
        self.clients.memcap[:] = self.pool.memcap[cohort]
        self.clients.pspeed[:] = self.pool.pspeed[cohort]
        self.clients.mdatasize[:] = self.pool.mdatasize[cohort]
        self.clients.touch()
        return super().sync_topology()

    # -- checkpoint/restore --------------------------------------------------
    def checkpoint_state(self) -> dict:
        d = super().checkpoint_state()
        d["sampling"] = {
            "round_next": int(self._round_next),
            "sampler": self.sampler.state_dict(),
            "pool": {"memcap": self.pool.memcap.tolist(),
                     "pspeed": self.pool.pspeed.tolist(),
                     "mdatasize": self.pool.mdatasize.tolist()},
        }
        return d

    def restore_state(self, state: dict, store=None) -> None:
        super().restore_state(state, store)
        s = state["sampling"]
        self._round_next = int(s["round_next"])
        p = s["pool"]
        if len(p["memcap"]) != len(self.pool):
            raise RuntimeError(
                f"checkpoint pool has {len(p['memcap'])} clients, "
                f"environment was rebuilt with {len(self.pool)}")
        self.pool.memcap[:] = np.asarray(p["memcap"], np.float64)
        self.pool.pspeed[:] = np.asarray(p["pspeed"], np.float64)
        self.pool.mdatasize[:] = np.asarray(p["mdatasize"], np.float64)
        self.pool.touch()




class EmulatedEnvironment:
    """The Fig. 4 world: rounds cost what the federated run measures.

    Thin adapter over ``FederatedOrchestrator`` — ``step`` IS
    ``orchestrator.run_round``, so a strategy driven through this
    environment reproduces ``FederatedOrchestrator.run`` exactly
    (including model state evolution and eval metrics).

    The topology is ELASTIC, as on the simulated track:
    :meth:`sync_topology` delegates to
    ``FederatedOrchestrator.sync_population``.

    **Fault injection** (``repro_torch.faults``): faults apply at ROUND
    granularity — this track has no intra-round clock — with round-
    boundary window expiry. A round with active faults routes through
    ``FederatedOrchestrator.run_round_faulty`` (down/partitioned clients
    sit out, dropped updates are excluded from the quorum-gated merge,
    down hosts fail over); a fault-free round delegates to plain
    ``run_round``, keeping zero-fault runs bit-identical to the
    fault-free track.
    """
    kind = "emulated"

    def __init__(self, orchestrator, faults: Optional[FaultSchedule] = None,
                 quorum_frac: float = 0.0):
        self.orchestrator = orchestrator
        self.clients = orchestrator.clients
        self.record_timings = False
        self._cost_model: Optional[CostModel] = None

        self.faults = faults if faults is not None else FaultSchedule()
        self.quorum_frac = float(quorum_frac)
        self._fault_mode = (not self.faults.empty) or self.quorum_frac > 0
        self._down: set = set()
        self._down_until: Dict[int, int] = {}
        self._degraded: Dict[int, tuple] = {}   # c -> (factor, until)
        self._partitioned: Dict[int, int] = {}  # c -> until_round
        self._fault_stats: Dict[str, float] = {
            "faults": 0.0, "dropped_updates": 0.0,
            "degraded_flushes": 0.0, "failovers": 0.0}

    @property
    def hierarchy(self) -> Hierarchy:
        """The orchestrator's CURRENT hierarchy (elastic runs rebind it
        mid-flight, so this must never be snapshotted at construction)."""
        return self.orchestrator.hierarchy

    @property
    def topology_version(self) -> int:
        return self.orchestrator.topology_version

    @property
    def cost_model(self) -> CostModel:
        """Analytic eqs. 6-7 view of the same pool (lazily built, on the
        orchestrator's device) — only strategy-construction context; the
        observed TPD always comes from the orchestrator."""
        if self._cost_model is None:
            self._cost_model = CostModel(self.hierarchy, self.clients,
                                         device=self.orchestrator.device)
        return self._cost_model

    def begin(self) -> None:
        self.orchestrator.warmup()

    def sync_topology(self) -> Optional[TopologyUpdate]:
        """Reconcile the orchestrator with this round's pool resizes:
        data shards carried/provisioned, FedAvg weights recomputed, the
        round engine retargeted; the update feeds the strategies'
        ``migrate`` hooks (the runner calls them)."""
        update = self.orchestrator.sync_population()
        if update is not None and self._cost_model is not None:
            self._cost_model.retarget(update.new_hierarchy)
        return update

    def step(self, round_idx: int, placement) -> RoundObservation:
        self.orchestrator.record_timings = self.record_timings
        if not self._fault_mode:
            rec = self.orchestrator.run_round(round_idx, placement)
            return RoundObservation(
                round_idx=round_idx,
                placement=np.asarray(rec.placement, np.int64),
                tpd=float(rec.tpd),
                metrics={"loss": rec.loss, "accuracy": rec.accuracy,
                         "train_time": rec.train_time,
                         "agg_time": rec.agg_time},
                timings=self.orchestrator.last_timings or {},
                topology_version=self.topology_version)

        dropped = self._apply_round_faults(round_idx,
                                           np.asarray(placement, np.int64))
        absent = self._down | set(sorted(self._partitioned))
        # a fault-affected round has no clean per-cluster timings (hosts
        # fail over mid-aggregation) — clear any previous round's trace
        # so a stale one can never leak into this observation
        self.orchestrator.last_timings = None
        rec, extra = self.orchestrator.run_round_faulty(
            round_idx, placement, down=absent, dropped=dropped,
            degraded={c: f for c, (f, _u)
                      in sorted(self._degraded.items())},
            quorum_frac=self.quorum_frac)
        self._fault_stats["dropped_updates"] += extra["dropped_updates"]
        self._fault_stats["degraded_flushes"] += extra["degraded_flushes"]
        self._fault_stats["failovers"] += extra["failovers"]
        metrics = {"loss": rec.loss, "accuracy": rec.accuracy,
                   "train_time": rec.train_time,
                   "agg_time": rec.agg_time,
                   "merged": extra["merged"],
                   "down": float(len(self._down)),
                   "partitioned": float(len(self._partitioned))}
        for k in sorted(self._fault_stats):
            metrics[k] = float(self._fault_stats[k])
        return RoundObservation(
            round_idx=round_idx,
            placement=np.asarray(rec.placement, np.int64),
            tpd=float(rec.tpd), metrics=metrics,
            timings=self.orchestrator.last_timings or {},
            topology_version=self.topology_version)

    def _apply_round_faults(self, r: int, placement: np.ndarray) -> set:
        """Round-granular fault semantics: expire timed windows at the
        round boundary, then apply this round's faults in the
        schedule's canonical order. Returns the set of clients whose
        updates are dropped THIS round (an emulated drop is a lost
        update: the retry backoff is sub-round, which this track cannot
        resolve)."""
        C = self.orchestrator.hierarchy.total_clients
        for c in [c for c in sorted(self._down_until)
                  if self._down_until[c] <= r]:
            self._down_until.pop(c)
            self._down.discard(c)
        for c in [c for c in sorted(self._degraded)
                  if self._degraded[c][1] <= r]:
            self._degraded.pop(c)
        for c in [c for c in sorted(self._partitioned)
                  if self._partitioned[c] <= r]:
            self._partitioned.pop(c)

        dropped: set = set()
        for f in self.faults.for_round(r):
            self._fault_stats["faults"] += 1.0
            if isinstance(f, ClientCrash):
                if f.client < C:
                    self._down.add(f.client)
                    if f.down_rounds > 0:
                        self._down_until[f.client] = \
                            f.at_round + f.down_rounds
            elif isinstance(f, ClientRecover):
                self._down.discard(f.client)
                self._down_until.pop(f.client, None)
            elif isinstance(f, UpdateDrop):
                if f.client < C:
                    dropped.add(f.client)
            elif isinstance(f, LinkDegrade):
                if f.client < C:
                    self._degraded[f.client] = (
                        float(f.factor), f.at_round + f.for_rounds)
            elif isinstance(f, AggregatorFailure):
                if f.slot < len(placement):
                    host = int(placement[f.slot])
                    self._down.add(host)
                    if f.down_rounds > 0:
                        self._down_until[host] = max(
                            self._down_until.get(host, 0),
                            f.at_round + f.down_rounds)
            elif isinstance(f, NetworkPartition):
                for c in f.clients:
                    if c < C:
                        self._partitioned[c] = max(
                            self._partitioned.get(c, 0),
                            f.at_round + f.for_rounds)
            else:
                raise TypeError(f"unknown fault event {f!r}")
        return dropped

    # -- checkpoint/restore --------------------------------------------------
    def checkpoint_state(self) -> dict:
        return {
            "kind": self.kind,
            "down": sorted(int(c) for c in self._down),
            "down_until": [[int(c), int(r)] for c, r
                           in sorted(self._down_until.items())],
            "degraded": [[int(c), float(f), int(u)] for c, (f, u)
                         in sorted(self._degraded.items())],
            "partitioned": [[int(c), int(u)] for c, u
                            in sorted(self._partitioned.items())],
            "fault_stats": {k: float(v) for k, v
                            in sorted(self._fault_stats.items())},
            "orchestrator": self.orchestrator.runtime_state(),
        }

    def restore_state(self, state: dict, store=None) -> None:
        self._down = {int(c) for c in state["down"]}
        self._down_until = {int(c): int(r)
                            for c, r in state["down_until"]}
        self._degraded = {int(c): (float(f), int(u))
                          for c, f, u in state["degraded"]}
        self._partitioned = {int(c): int(u)
                             for c, u in state["partitioned"]}
        self._fault_stats = {str(k): float(v) for k, v
                             in sorted(state["fault_stats"].items())}
        self.orchestrator.load_runtime_state(state["orchestrator"])


# ---------------------------------------------------------------------------
# event codec for checkpointing: the online event vocabulary <-> JSON
# ---------------------------------------------------------------------------
def _encode_entries(entries) -> list:
    return [[int(e.client), int(e.version)] for e in entries]


def _decode_entries(entries) -> tuple:
    return tuple(BufferEntry(int(c), int(v)) for c, v in entries)


def _encode_event(ev) -> dict:
    if isinstance(ev, UpdateArrival):
        return {"t": "arrival", "client": int(ev.client),
                "version": int(ev.version)}
    if isinstance(ev, PartialArrival):
        return {"t": "partial", "slot": int(ev.slot), "src": int(ev.src),
                "entries": _encode_entries(ev.entries)}
    if isinstance(ev, BufferDeadline):
        return {"t": "deadline", "slot": int(ev.slot),
                "epoch": int(ev.epoch)}
    if isinstance(ev, RootComplete):
        return {"t": "root", "entries": _encode_entries(ev.entries)}
    if isinstance(ev, FaultAt):
        return {"t": "fault", "fault": ev.fault.to_dict()}
    raise TypeError(f"cannot checkpoint online event {ev!r}")


def _decode_event(d: dict):
    kind = d["t"]
    if kind == "arrival":
        return UpdateArrival(int(d["client"]), int(d["version"]))
    if kind == "partial":
        return PartialArrival(slot=int(d["slot"]), src=int(d["src"]),
                              entries=_decode_entries(d["entries"]))
    if kind == "deadline":
        return BufferDeadline(int(d["slot"]), int(d["epoch"]))
    if kind == "root":
        return RootComplete(_decode_entries(d["entries"]))
    if kind == "fault":
        return FaultAt(fault_from_dict(d["fault"]))
    raise ValueError(f"unknown checkpointed event kind {kind!r}")


class OnlineEnvironment:
    """The asynchronous world: a discrete-event queue over the live
    ``FederatedOrchestrator``.

    Each ``step`` dispatches every *idle* client's local training from
    the current global model and schedules one ``UpdateArrival`` per
    client at ``now + train_delay * jitter`` on the virtual clock
    (:class:`~repro_torch.online.clock.VirtualClock`; seeded per-client
    jitter, no wall-clock anywhere). Arrivals route to the client's
    aggregator slot under the CURRENT placement, where count-or-deadline
    :class:`~repro_torch.online.async_fedavg.AggregatorBuffer`\\ s flush
    partials up the tree, each flush charging the same eq. 6 cluster
    delay the synchronous engines charge. The round concludes at the
    first ROOT flush: its entries merge into the global model via
    staleness-weighted async FedAvg
    (:func:`~repro_torch.online.async_fedavg.async_merge_batched`), and the
    observed TPD is the virtual time from dispatch to merge. Clients
    still in flight simply stay in flight — rounds OVERLAP, and their
    updates land with positive staleness.

    Two extra mechanisms:

    * **Degenerate lockstep** — a config with zero jitter, full-cohort
      flushes and no deadline (``AsyncConfig.degenerate``) routes the
      model transition through the orchestrator's own
      ``train_cohort``/``aggregate_cohort`` executables, making the run
      bit-identical to ``EmulatedEnvironment`` (the parity pin).
    * **Delay-triggered re-optimization** — per-slot EWMAs track
      observed flush latency; a flush exceeding ``reopt_threshold`` x
      its slot's EWMA swaps that slot's host for the
      fastest-by-observed-delay unplaced client MID-ROUND (placement
      changes off the round boundary), and the next ``sync_topology``
      surfaces an identity :class:`TopologyUpdate` pulse through the
      elastic machinery so strategies' ``migrate`` hooks see the epoch.

    The elastic track composes: pool resizes flow through
    ``sync_population`` exactly as in ``EmulatedEnvironment``, with
    in-flight updates re-keyed across the id remap (departed clients'
    updates are dropped; survivors' stay in transit).

    **Fault injection** (``repro_torch.faults``): a non-empty
    :class:`FaultSchedule` wraps each of a round's faults in a
    :class:`FaultAt` event at ``t_round + offset`` on the SAME virtual
    clock, so faulty runs replay bit-identically. Crashed/partitioned
    clients leave the dispatch cohort (window expiry at round
    boundaries); a crash voids the client's undelivered update and, if
    it hosted a slot, fails the slot over to a live unplaced client
    (buffer contents re-home under the new host, and the swap raises
    the same identity-``TopologyUpdate`` pulse as a re-optimization);
    dropped updates re-deliver under the :class:`RetryPolicy`'s
    virtual-time exponential backoff; a partition holds in-flight
    arrivals and re-injects them when it heals. ``quorum_frac > 0``
    gates root merges on live-population quorum and damps committed
    merges by the arrived fraction (:func:`quorum_merge_batched`).
    With an empty schedule and ``quorum_frac == 0`` every fault hook
    is dormant and the run is bit-identical to the fault-free
    environment (the zero-fault parity pin).
    """
    kind = "online"

    def __init__(self, orchestrator, config: Optional[AsyncConfig] = None,
                 seed: int = 0, faults: Optional[FaultSchedule] = None,
                 retry: Optional[RetryPolicy] = None,
                 quorum_frac: float = 0.0):
        if orchestrator.engine != "batched":
            raise ValueError("OnlineEnvironment needs the batched round "
                             f"engine, got {orchestrator.engine!r}")
        self.orchestrator = orchestrator
        self.clients = orchestrator.clients
        self.cfg = config if config is not None else AsyncConfig()
        self.clock = VirtualClock()
        self._arrival = ArrivalProcess(seed, self.cfg.jitter)
        self._cost_model: Optional[CostModel] = None
        self.record_timings = False
        self._timing_rows: Optional[dict] = None  # armed per step

        # fault injection + tolerance (dormant when the schedule is
        # empty and no quorum is configured — the zero-fault parity pin)
        self.faults = faults if faults is not None else FaultSchedule()
        self.retry = retry if retry is not None else RetryPolicy()
        self.quorum_frac = float(quorum_frac)
        self._fault_mode = (not self.faults.empty) or self.quorum_frac > 0
        self._down: set = set()               # crashed clients
        self._down_until: Dict[int, int] = {}  # auto-revival round
        self._degraded: Dict[int, tuple] = {}  # c -> (factor, until_round)
        self._partitioned: Dict[int, int] = {}  # c -> until_round
        self._void: set = set()               # (c, v) voided by a crash
        self._drop_pending: set = set()       # (c, v) marked lost in transit
        self._retry_count: Dict[tuple, int] = {}
        self._held: List[tuple] = []          # partition-held arrivals
        self._fault_stats: Dict[str, float] = {
            "faults": 0.0, "dropped_updates": 0.0, "retries": 0.0,
            "degraded_flushes": 0.0, "failovers": 0.0}

        # routing + buffers are (re)built lazily from the placement each
        # step; see _set_placement
        self._placement: Optional[np.ndarray] = None
        self._client_slot: Optional[np.ndarray] = None
        self._buffers: List[AggregatorBuffer] = []

        # in-flight bookkeeping
        self._in_flight: set = set()          # clients with a pending arrival
        self._sent: Dict[tuple, float] = {}   # (client, version) -> t_dispatch
        self._store: Dict[tuple, object] = {}  # (client, version) -> update
        self._round = 0
        self._merge_stats: Optional[Dict[str, float]] = None

        # observed-delay state driving the re-optimization trigger
        self._slot_ewma: Optional[np.ndarray] = None
        self._slot_obs: Optional[np.ndarray] = None
        self._client_delay: Dict[int, float] = {}
        self._reopt_swaps = 0

        self._trace: List[str] = []
        self._pending_pulse = False
        self._topology_version = 0

    # -- protocol surface --------------------------------------------------
    @property
    def hierarchy(self) -> Hierarchy:
        return self.orchestrator.hierarchy

    @property
    def topology_version(self) -> int:
        return self._topology_version

    @property
    def cost_model(self) -> CostModel:
        """Analytic construction-time context for strategies (exhaustive
        oracle etc.) — observed TPD always comes from the event queue."""
        if self._cost_model is None:
            self._cost_model = CostModel(self.hierarchy, self.clients,
                                         device=self.orchestrator.device)
        return self._cost_model

    def begin(self) -> None:
        self.orchestrator.warmup()

    # -- placement routing -------------------------------------------------
    def _set_placement(self, placement: np.ndarray) -> None:
        """Adopt ``placement``: rebuild the client->slot routing table,
        per-slot expected-part counts and buffer thresholds. Buffered
        parts survive a placement change in place (they are in transit
        at their old slot); a topology change (different D) rebuilds the
        buffers from scratch — migration already re-injected their
        entries as arrivals."""
        h = self.hierarchy
        if (self._placement is not None
                and len(self._buffers) == h.dimensions
                and np.array_equal(self._placement, placement)):
            return
        self._placement = placement.copy()
        C = h.total_clients
        trainers = h.trainer_assignment(self._placement)
        leaf_start = h.level_starts[h.depth - 1]
        cs = np.full(C, -1, np.int64)
        for li, t_list in enumerate(trainers):
            for c in t_list:
                cs[c] = leaf_start + li
        for s in range(h.dimensions):
            cs[int(self._placement[s])] = s
        self._client_slot = cs

        rebuilt = len(self._buffers) != h.dimensions
        new_buffers: List[AggregatorBuffer] = []
        for s in range(h.dimensions):
            kids = h.children_slots(s)
            expected = (len(kids) if kids
                        else len(trainers[s - leaf_start])) + 1
            threshold = flush_count(expected, self.cfg.flush_fraction)
            if rebuilt:
                new_buffers.append(AggregatorBuffer(
                    slot=s, expected=expected, threshold=threshold))
            else:
                self._buffers[s].expected = expected
                self._buffers[s].threshold = threshold
        if rebuilt:
            self._buffers = new_buffers
            self._slot_ewma = np.zeros(h.dimensions, np.float64)
            self._slot_obs = np.zeros(h.dimensions, np.int64)

    # -- elastic topology --------------------------------------------------
    def sync_topology(self) -> Optional[TopologyUpdate]:
        """Pool resizes reconcile through ``sync_population`` (same
        elastic machinery as the emulated track) with the event engine
        migrated across the id remap; additionally, a mid-round
        re-optimization swap raises a PULSE — an identity update with a
        bumped version — so strategies' ``migrate`` hooks observe the
        new placement epoch even though no client ids moved."""
        update = self.orchestrator.sync_population()
        if update is not None:
            if self._cost_model is not None:
                self._cost_model.retarget(update.new_hierarchy)
            self._migrate_engine(update)
            self._pending_pulse = False
            self._topology_version += 1
            return dataclasses.replace(update,
                                       version=self._topology_version)
        if self._pending_pulse:
            self._pending_pulse = False
            self._topology_version += 1
            h = self.hierarchy
            return TopologyUpdate(
                version=self._topology_version,
                old_hierarchy=h, new_hierarchy=h,
                slot_remap=slot_remap(h, h), client_remap=None)
        return None

    def _migrate_engine(self, update: TopologyUpdate) -> None:
        """Re-key every client-id-indexed piece of event state across a
        pool renumbering; in-flight and buffered updates of departed
        clients are dropped, survivors' are conservatively re-injected
        as arrivals at their original virtual times (buffered ones at
        ``now``) so they re-route under the NEW topology."""
        remap = update.client_remap

        def alive(c: int) -> int:
            if remap is None:
                return c
            if c >= len(remap):
                # a client id the resize log never saw: the engine held
                # state for a client that was already renumbered away —
                # silent corruption, so fail loudly (see the post-rebuild
                # queue validation for the arrival-event twin)
                raise RuntimeError(
                    f"online event engine holds state for client {c} "
                    f"outside the remap domain [0, {len(remap)}) — "
                    "stale state for a retired/renumbered client")
            return int(remap[c]) if remap[c] >= 0 else -1

        self._arrival.migrate(remap)
        self._client_delay = {
            alive(c): v for c, v in sorted(self._client_delay.items())
            if alive(c) >= 0}
        self._in_flight = {alive(c) for c in self._in_flight
                           if alive(c) >= 0}
        self._sent = {(alive(c), v): t
                      for (c, v), t in sorted(self._sent.items())
                      if alive(c) >= 0}
        self._store = {
            (alive(c), v): u
            for (c, v), u in sorted(self._store.items(),
                                    key=lambda kv: kv[0])
            if alive(c) >= 0}

        # fault state rides the same remap: survivors keep their fault
        # windows, departed clients' entries are dropped with their ids
        self._down = {alive(c) for c in sorted(self._down)
                      if alive(c) >= 0}
        self._down_until = {
            alive(c): r for c, r in sorted(self._down_until.items())
            if alive(c) >= 0}
        self._degraded = {
            alive(c): v for c, v in sorted(self._degraded.items())
            if alive(c) >= 0}
        self._partitioned = {
            alive(c): r for c, r in sorted(self._partitioned.items())
            if alive(c) >= 0}
        self._void = {(alive(c), v) for (c, v) in sorted(self._void)
                      if alive(c) >= 0}
        self._drop_pending = {
            (alive(c), v) for (c, v) in sorted(self._drop_pending)
            if alive(c) >= 0}
        self._retry_count = {
            (alive(c), v): n
            for (c, v), n in sorted(self._retry_count.items())
            if alive(c) >= 0}
        self._held = [(alive(c), v) for (c, v) in self._held
                      if alive(c) >= 0]

        pend = self.clock.pending()
        self.clock.replace([])
        for t, _seq, ev in pend:
            if isinstance(ev, UpdateArrival):
                nc = alive(ev.client)
                if nc >= 0:
                    self.clock.schedule(t, UpdateArrival(nc, ev.version))
            elif isinstance(ev, (PartialArrival, RootComplete)):
                for e in ev.entries:
                    nc = alive(e.client)
                    if nc >= 0:
                        self.clock.schedule(
                            t, UpdateArrival(nc, e.version))
            elif isinstance(ev, FaultAt):
                # fault events carry round indices, not client routes;
                # they survive the migration verbatim
                self.clock.schedule(t, ev)
            # BufferDeadline: dropped — the buffers rebuild empty
        for buf in self._buffers:
            for part in buf.take():
                for e in part.entries:
                    nc = alive(e.client)
                    if nc >= 0:
                        self.clock.schedule(
                            self.clock.now, UpdateArrival(nc, e.version))

        # the post-rebuild invariant the elastic track rests on: every
        # arrival still queued routes to a LIVE client id. A violation
        # means a ClientLeave retired a client whose events survived —
        # a silent correctness hazard, so fail loudly instead of letting
        # the arrival index out of the new routing table
        C = len(self.clients)
        stale = sorted({ev.client for _t, _s, ev in self.clock.pending()
                        if isinstance(ev, UpdateArrival)
                        and not 0 <= ev.client < C})
        if stale:
            raise RuntimeError(
                f"sync_topology left queued arrivals for retired "
                f"clients {stale} (pool now has {C} clients) — the "
                "event engine migration is corrupt")

        # force a full routing/buffer rebuild at the next step (the
        # strategy proposes a placement for the NEW hierarchy then)
        self._placement = None
        self._buffers = []

    # -- the step ----------------------------------------------------------
    def step(self, round_idx: int, placement) -> RoundObservation:
        orch = self.orchestrator
        placement = np.asarray(placement, np.int64)
        self.hierarchy.validate_placement(placement)
        self._set_placement(placement)
        self._round = round_idx
        t_r = self.clock.now
        self._timing_rows = {"train": {"clients": [], "times": []},
                             "levels": []} if self.record_timings else None

        # a degenerate config stays on the lockstep fast path ONLY while
        # the fault layer is dormant — any fault/quorum config must flow
        # through the event queue where faults can actually bite
        lockstep = self.cfg.degenerate and not self._fault_mode
        if self._fault_mode:
            self._expire_faults(round_idx, t_r)
            for f in self.faults.for_round(round_idx):
                self.clock.schedule(t_r + f.offset, FaultAt(f))

        C = self.hierarchy.total_clients
        cohort = np.asarray([c for c in range(C)
                             if c not in self._in_flight
                             and c not in self._down
                             and c not in self._partitioned], np.int64)
        overlap = 1.0 - cohort.size / C
        stacked, train_times = orch.train_cohort(cohort, round_idx)
        if cohort.size:
            for j, c in enumerate(cohort):
                c = int(c)
                key = (c, round_idx)
                self._sent[key] = t_r
                if not lockstep:
                    # a copy, never a view: a full cohort trains into
                    # the aggregator's persistent client rows, which the
                    # next full-cohort round overwrites while this
                    # update may still sit in a buffer
                    self._store[key] = tree_map(
                        lambda x, j=j: x[j].clone(), stacked)
                delay = float(train_times[j]) * self._arrival.factor(c)
                if self._degraded:
                    dg = self._degraded.get(c)
                    if dg is not None:
                        delay *= dg[0]
                self.clock.schedule(t_r + delay,
                                    UpdateArrival(c, round_idx))
                self._in_flight.add(c)
            self._trace.append(
                f"t={t_r:.4f} r{round_idx}: dispatched {cohort.size}/{C} "
                f"clients ({len(self._in_flight)} now in flight)")
            if self._timing_rows is not None:
                self._timing_rows["train"] = {
                    "clients": [int(c) for c in cohort],
                    "times": [float(t) for t in train_times]}

        if lockstep:
            tpd, extra = self._step_degenerate(round_idx, placement,
                                               cohort, stacked,
                                               train_times, t_r)
        else:
            tpd, extra = self._step_async(round_idx, t_r)

        loss, acc = orch.evaluate_global()
        metrics = {"loss": loss, "accuracy": acc, "overlap": overlap,
                   "reopt_swaps": float(self._reopt_swaps), **extra}
        if self._fault_mode:
            metrics["down"] = float(len(self._down))
            metrics["partitioned"] = float(len(self._partitioned))
            for k in sorted(self._fault_stats):
                metrics[k] = float(self._fault_stats[k])
        timings, self._timing_rows = self._timing_rows, None
        if timings is not None:
            # online has no synchronous train/agg split: the floats are
            # this step's dispatched-train ceiling and the total flush
            # work the event loop charged before the merge
            timings["train_time"] = (float(np.max(train_times))
                                     if cohort.size else 0.0)
            timings["agg_time"] = float(sum(
                d for row in timings["levels"] for d in row["delays"]))
        log, self._trace = self._trace, []
        return RoundObservation(
            round_idx=round_idx, placement=self._placement.copy(),
            tpd=tpd, metrics=metrics, timings=timings or {},
            topology_version=self._topology_version, log=log)

    # -- degenerate lockstep path -------------------------------------------
    def _step_degenerate(self, r: int, placement, cohort, stacked,
                         train_times, t_r: float):
        """Zero jitter + full-cohort flush + no deadline: the round IS
        synchronous. The model transition runs through the orchestrator's
        own executables (``train_cohort`` full-cohort fast path +
        ``aggregate_cohort``), so tpd/loss/accuracy match
        ``EmulatedEnvironment.step`` bit for bit — while the arrival
        events still stream through the virtual clock, keeping the
        trace real."""
        orch = self.orchestrator
        if cohort.size != self.hierarchy.total_clients:
            raise RuntimeError("degenerate online round with clients in "
                               "flight — the lockstep invariant broke")
        while self.clock:
            t, ev = self.clock.pop()
            self._in_flight.discard(ev.client)
            sent = self._sent.pop((ev.client, ev.version), None)
            if sent is not None:
                self._observe_delay(ev.client, t - sent)
        train_time = float(np.max(train_times))
        new_params, agg_time = orch.aggregate_cohort(stacked, placement)
        orch.set_global(new_params)
        t_done = t_r + train_time + agg_time
        self.clock.advance_to(t_done)
        self._trace.append(
            f"t={t_done:.4f} r{r}: lockstep merge of {cohort.size} "
            f"updates (train={train_time:.4f} agg={agg_time:.4f})")
        tpd = (train_time + agg_time) * orch.time_scale
        extra = {"train_time": train_time, "agg_time": agg_time,
                 "merged": float(cohort.size),
                 "staleness_mean": 0.0, "staleness_max": 0.0}
        return tpd, extra

    # -- event-driven async path ---------------------------------------------
    def _step_async(self, r: int, t_r: float):
        """Drive the event queue until the first root merge; the TPD is
        the virtual dispatch->merge latency."""
        h = self.hierarchy
        self._merge_stats = None
        forced = 0
        force_limit = h.total_clients * h.depth + h.dimensions + 8
        while self._merge_stats is None:
            if not self.clock:
                slot = self._deepest_nonempty_slot()
                if slot is None:
                    # nothing in flight at all: the model is unchanged
                    self._merge_stats = {"merged": 0.0,
                                         "staleness_mean": 0.0,
                                         "staleness_max": 0.0}
                    break
                forced += 1
                if forced > force_limit:
                    raise RuntimeError("online event loop stalled "
                                       "(forced-flush runaway)")
                self._flush(slot, self.clock.now, why="drain")
                continue
            t, ev = self.clock.pop()
            if isinstance(ev, UpdateArrival):
                self._on_arrival(t, ev)
            elif isinstance(ev, PartialArrival):
                self._deposit(ev.slot,
                              BufferedPart(src=ev.src, entries=ev.entries),
                              t)
            elif isinstance(ev, BufferDeadline):
                buf = self._buffers[ev.slot]
                if buf.epoch == ev.epoch and not buf.empty:
                    self._flush(ev.slot, t, why="deadline")
            elif isinstance(ev, RootComplete):
                self._merge(t, ev.entries, r)
            elif isinstance(ev, FaultAt):
                self._apply_fault(t, ev.fault, r)
            else:
                raise TypeError(f"unknown online event {ev!r}")
        tpd = (self.clock.now - t_r) * self.orchestrator.time_scale
        return tpd, dict(self._merge_stats)

    def _on_arrival(self, t: float, ev: UpdateArrival) -> None:
        key = (ev.client, ev.version)
        if self._fault_mode:
            if key in self._void:
                # the sender crashed while this update was in transit
                self._void.discard(key)
                self._trace.append(
                    f"t={t:.4f} arrival c{ev.client} v{ev.version} "
                    "voided (sender crashed)")
                return
            if ev.client in self._partitioned:
                # hold the delivery; the partition's round-boundary
                # expiry re-injects it at the healing instant
                self._held.append(key)
                self._trace.append(
                    f"t={t:.4f} arrival c{ev.client} v{ev.version} "
                    "held (network partition)")
                return
            if key in self._drop_pending:
                self._drop_pending.discard(key)
                attempt = self._retry_count.get(key, 0)
                if attempt < self.retry.max_retries:
                    self._retry_count[key] = attempt + 1
                    self._fault_stats["retries"] += 1.0
                    backoff = self.retry.delay(attempt)
                    self.clock.schedule(
                        t + backoff, UpdateArrival(ev.client, ev.version))
                    self._trace.append(
                        f"t={t:.4f} DROP c{ev.client} v{ev.version}: "
                        f"retry {attempt + 1}/{self.retry.max_retries} "
                        f"after {backoff:.4f}")
                    return
                # retries exhausted: the update is permanently lost and
                # the client re-enters the next dispatch cohort
                self._sent.pop(key, None)
                self._store.pop(key, None)
                self._retry_count.pop(key, None)
                self._in_flight.discard(ev.client)
                self._fault_stats["dropped_updates"] += 1.0
                self._trace.append(
                    f"t={t:.4f} DROP c{ev.client} v{ev.version}: "
                    "retries exhausted, update lost")
                return
            self._retry_count.pop(key, None)
        self._in_flight.discard(ev.client)
        sent = self._sent.pop(key, None)
        if sent is not None:
            self._observe_delay(ev.client, t - sent)
        slot = int(self._client_slot[ev.client])
        self._deposit(slot, BufferedPart(
            src=ev.client,
            entries=(BufferEntry(ev.client, ev.version),)), t)

    def _deposit(self, slot: int, part: BufferedPart, t: float) -> None:
        buf = self._buffers[slot]
        was_empty = buf.empty
        if buf.deposit(part):
            self._flush(slot, t, why="count")
        elif was_empty and self.cfg.flush_timeout > 0:
            self.clock.schedule(t + self.cfg.flush_timeout,
                                BufferDeadline(slot, buf.epoch))

    def _flush(self, slot: int, t: float, why: str) -> None:
        """Drain one buffer: charge the eq. 6 cluster delay for the
        actual payloads, feed the latency EWMA (possibly triggering a
        host swap), and forward the merged entry set up the tree."""
        h = self.hierarchy
        parts = self._buffers[slot].take()
        host = int(self._placement[slot])
        members = [p.src for p in parts]
        ct = self.orchestrator.cluster_delay(host, members, len(parts))
        if self._timing_rows is not None:
            mds = self.orchestrator.clients.mdatasize
            self._timing_rows["levels"].append({
                "level": int(h.levels[slot]),
                "slots": [slot],
                "hosts": [host],
                "loads": [float(sum(mds[int(c)] for c in members))],
                "n_parts": [len(parts)],
                "delays": [float(ct)]})
        self._note_flush_latency(slot, ct, t)
        entries = tuple(e for p in parts for e in p.entries)
        self._trace.append(
            f"t={t:.4f} flush[{why}] slot {slot} host c{host} "
            f"parts={len(parts)} updates={len(entries)} dt={ct:.4f}")
        t_out = t + ct
        if slot == 0:
            self.clock.schedule(t_out, RootComplete(entries))
        else:
            self.clock.schedule(t_out, PartialArrival(
                slot=h.parent_slot(slot), src=host, entries=entries))

    def _merge(self, t: float, entries, r: int) -> None:
        """The root flush landed: staleness-weighted merge into the
        global model; the round concludes here. With ``quorum_frac``
        configured the merge is gated on live-population quorum
        (refused = a degraded flush, the model holds) and committed
        merges are damped by the arrived fraction."""
        orch = self.orchestrator
        order = sorted(entries, key=lambda e: (e.version, e.client))
        if self.quorum_frac > 0.0:
            C = self.hierarchy.total_clients
            live = C - len(self._down) - len(self._partitioned)
            need = quorum_count(max(1, live), self.quorum_frac)
            if len(order) < need:
                for e in order:
                    self._store.pop((e.client, e.version), None)
                self._fault_stats["degraded_flushes"] += 1.0
                self._trace.append(
                    f"t={t:.4f} r{r}: DEGRADED flush — {len(order)} "
                    f"updates < quorum {need} (live {live}), merge "
                    "refused, model holds")
                self._merge_stats = {"merged": 0.0,
                                     "staleness_mean": 0.0,
                                     "staleness_max": 0.0}
                return
        clients = np.asarray([e.client for e in order], np.int64)
        versions = np.asarray([e.version for e in order], np.int64)
        staleness = (r - versions).astype(np.float64)
        base_w = orch.weights[clients]
        trees = [self._store.pop((e.client, e.version)) for e in order]
        stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
        if self.quorum_frac > 0.0:
            arrived = len(order) / self.hierarchy.total_clients
            new_global = quorum_merge_batched(
                orch.params, stacked, base_w, staleness,
                self.cfg.staleness_alpha, self.cfg.server_lr, arrived)
        else:
            new_global = async_merge_batched(
                orch.params, stacked, base_w, staleness,
                self.cfg.staleness_alpha, self.cfg.server_lr)
        orch.set_global(new_global)
        self._trace.append(
            f"t={t:.4f} r{r}: root merge of {len(order)} updates "
            f"(staleness mean {staleness.mean():.2f} "
            f"max {staleness.max():.0f})")
        self._merge_stats = {
            "merged": float(len(order)),
            "staleness_mean": float(staleness.mean()),
            "staleness_max": float(staleness.max())}

    # -- observed-delay EWMAs + the re-optimization trigger ------------------
    def _observe_delay(self, client: int, delay: float) -> None:
        b = self.cfg.reopt_beta
        prev = self._client_delay.get(client)
        self._client_delay[client] = delay if prev is None \
            else b * prev + (1.0 - b) * delay

    def _note_flush_latency(self, slot: int, ct: float, t: float) -> None:
        cfg = self.cfg
        prior = float(self._slot_ewma[slot])
        obs = int(self._slot_obs[slot])
        if (cfg.reopt_threshold > 0 and obs >= 2
                and ct > cfg.reopt_threshold * prior
                and self._swap_host(slot, ct, prior, t)):
            # the slot's latency history belonged to the old host
            self._slot_ewma[slot] = 0.0
            self._slot_obs[slot] = 0
            return
        b = cfg.reopt_beta
        self._slot_ewma[slot] = ct if obs == 0 \
            else b * prior + (1.0 - b) * ct
        self._slot_obs[slot] = obs + 1

    def _swap_host(self, slot: int, ct: float, ewma: float,
                   t: float) -> bool:
        """Delay-triggered mid-round re-optimization: replace the slot's
        host with the fastest unplaced client by OBSERVED train-delay
        EWMA (the environment only ever acts on observed signals — the
        pool's pspeed stays black-box). Takes effect immediately: the
        very next flush of this slot charges the new host."""
        placed = {int(c) for c in self._placement}
        old = int(self._placement[slot])
        best, best_delay = -1, np.inf
        for c in range(self.hierarchy.total_clients):
            if c in placed:
                continue
            d = self._client_delay.get(c)
            if d is not None and d < best_delay:
                best, best_delay = c, d
        old_delay = self._client_delay.get(old)
        if best < 0 or (old_delay is not None and best_delay >= old_delay):
            return False
        placement = self._placement.copy()
        placement[slot] = best
        self._set_placement(placement)
        self._reopt_swaps += 1
        self._pending_pulse = True
        self._trace.append(
            f"t={t:.4f} REOPT slot {slot}: host c{old} -> c{best} "
            f"(flush {ct:.4f} > {self.cfg.reopt_threshold:g}x "
            f"ewma {ewma:.4f})")
        return True

    def _deepest_nonempty_slot(self) -> Optional[int]:
        for s in range(self.hierarchy.dimensions - 1, -1, -1):
            if not self._buffers[s].empty:
                return s
        return None

    # -- fault injection + tolerance -----------------------------------------
    def _expire_faults(self, r: int, t_r: float) -> None:
        """Round-boundary expiry of every timed fault window, then
        re-injection of arrivals a healed partition was holding."""
        for c in [c for c in sorted(self._down_until)
                  if self._down_until[c] <= r]:
            self._down_until.pop(c)
            self._down.discard(c)
            self._trace.append(f"t={t_r:.4f} r{r}: c{c} back up")
        for c in [c for c in sorted(self._degraded)
                  if self._degraded[c][1] <= r]:
            self._degraded.pop(c)
            self._trace.append(f"t={t_r:.4f} r{r}: c{c} link restored")
        for c in [c for c in sorted(self._partitioned)
                  if self._partitioned[c] <= r]:
            self._partitioned.pop(c)
            self._trace.append(f"t={t_r:.4f} r{r}: c{c} partition healed")
        if self._held:
            still: List[tuple] = []
            for (c, v) in self._held:
                if c in self._partitioned:
                    still.append((c, v))
                else:
                    self.clock.schedule(t_r, UpdateArrival(c, v))
                    self._trace.append(
                        f"t={t_r:.4f} r{r}: held update c{c} v{v} "
                        "re-injected")
            self._held = still

    def _apply_fault(self, t: float, f, r: int) -> None:
        """One FaultAt popped off the virtual clock."""
        self._fault_stats["faults"] += 1.0
        C = self.hierarchy.total_clients
        if isinstance(f, ClientCrash):
            until = f.at_round + f.down_rounds if f.down_rounds > 0 \
                else None
            self._crash_client(t, f.client, until)
        elif isinstance(f, ClientRecover):
            self._down.discard(f.client)
            self._down_until.pop(f.client, None)
            self._trace.append(f"t={t:.4f} FAULT recover c{f.client}")
        elif isinstance(f, UpdateDrop):
            self._drop_update(t, f.client)
        elif isinstance(f, LinkDegrade):
            if f.client < C:
                self._degraded[f.client] = (float(f.factor),
                                            f.at_round + f.for_rounds)
                self._trace.append(
                    f"t={t:.4f} FAULT degrade c{f.client} "
                    f"x{f.factor:g} until r{f.at_round + f.for_rounds}")
        elif isinstance(f, AggregatorFailure):
            if self._placement is None or f.slot >= len(self._placement):
                self._trace.append(
                    f"t={t:.4f} FAULT aggregator slot {f.slot} "
                    "out of range — skipped")
                return
            host = int(self._placement[f.slot])
            until = f.at_round + f.down_rounds if f.down_rounds > 0 \
                else None
            self._trace.append(
                f"t={t:.4f} FAULT aggregator slot {f.slot} "
                f"(host c{host}) failed")
            self._crash_client(t, host, until)
        elif isinstance(f, NetworkPartition):
            hit = [c for c in f.clients if c < C]
            for c in hit:
                cur = self._partitioned.get(c, 0)
                self._partitioned[c] = max(cur, f.at_round + f.for_rounds)
            self._trace.append(
                f"t={t:.4f} FAULT partition {hit} until "
                f"r{f.at_round + f.for_rounds}")
        else:
            raise TypeError(f"unknown fault event {f!r}")

    def _crash_client(self, t: float, c: int, until: Optional[int]) -> None:
        """Take client ``c`` down: void its undelivered update and, if
        it hosts a slot, fail the slot over to a live replacement."""
        if c >= self.hierarchy.total_clients:
            self._trace.append(
                f"t={t:.4f} FAULT crash c{c} out of range — skipped")
            return
        if c in self._down:
            if until is not None:
                self._down_until[c] = max(self._down_until.get(c, 0),
                                          until)
            return
        self._down.add(c)
        if until is not None:
            self._down_until[c] = until
        for key in [k for k in sorted(self._sent) if k[0] == c]:
            self._sent.pop(key)
            self._store.pop(key, None)
            self._void.add(key)
            self._fault_stats["dropped_updates"] += 1.0
        self._in_flight.discard(c)
        self._trace.append(
            f"t={t:.4f} FAULT crash c{c}"
            + (f" (down until r{until})" if until is not None else ""))
        if self._placement is not None:
            for s in range(len(self._placement)):
                if int(self._placement[s]) == c:
                    self._fail_host(s, t)
                    break

    def _drop_update(self, t: float, c: int) -> None:
        """Mark the client's pending in-flight update lost in transit;
        the retry policy decides what happens when it would arrive."""
        keys = [k for k in sorted(self._sent) if k[0] == c]
        if not keys:
            self._trace.append(
                f"t={t:.4f} FAULT drop c{c}: nothing in flight — no-op")
            return
        self._drop_pending.add(keys[-1])
        self._trace.append(
            f"t={t:.4f} FAULT drop c{c} v{keys[-1][1]}")

    def _fail_host(self, slot: int, t: float) -> None:
        """Aggregator failover: re-home the slot (and its in-transit
        buffer contents, which stay in place) on the fastest live
        unplaced client by observed delay — lowest-id live client when
        no delay has been observed yet. Raises the same identity
        ``TopologyUpdate`` pulse as a mid-round re-optimization so
        strategies' ``migrate`` hooks see the new placement epoch."""
        C = self.hierarchy.total_clients
        old = int(self._placement[slot])
        placed = {int(c) for c in self._placement}
        best, best_delay = -1, np.inf
        for c in range(C):
            if (c in placed or c in self._down
                    or c in self._partitioned):
                continue
            d = self._client_delay.get(c)
            if d is not None and d < best_delay:
                best, best_delay = c, d
        if best < 0:
            for c in range(C):
                if (c not in placed and c not in self._down
                        and c not in self._partitioned):
                    best = c
                    break
        if best < 0:
            raise RuntimeError(
                f"aggregator failover for slot {slot}: no live "
                "unplaced client left to re-home it on")
        placement = self._placement.copy()
        placement[slot] = best
        self._set_placement(placement)
        self._pending_pulse = True
        self._fault_stats["failovers"] += 1.0
        self._trace.append(
            f"t={t:.4f} FAILOVER slot {slot}: host c{old} -> c{best}")

    # -- checkpoint/restore --------------------------------------------------
    def checkpoint_state(self) -> dict:
        """JSON-safe snapshot of every piece of event-engine state the
        update trees don't carry (those go through the npz tree under
        ``store_*`` keys — see the runner). Floats survive JSON's repr
        round-trip exactly, so a restored run replays bit-identically."""
        return {
            "kind": self.kind,
            "clock": self.clock.state_dict(_encode_event),
            "placement": None if self._placement is None
            else [int(c) for c in self._placement],
            "buffers": [
                {"slot": b.slot, "epoch": b.epoch,
                 "parts": [[int(p.src), _encode_entries(p.entries)]
                           for p in b.parts]}
                for b in self._buffers],
            "in_flight": sorted(int(c) for c in self._in_flight),
            "sent": [[int(c), int(v), t]
                     for (c, v), t in sorted(self._sent.items())],
            "round": int(self._round),
            "slot_ewma": None if self._slot_ewma is None
            else [float(x) for x in self._slot_ewma],
            "slot_obs": None if self._slot_obs is None
            else [int(x) for x in self._slot_obs],
            "client_delay": [[int(c), float(d)] for c, d
                             in sorted(self._client_delay.items())],
            "reopt_swaps": int(self._reopt_swaps),
            "pending_pulse": bool(self._pending_pulse),
            "topology_version": int(self._topology_version),
            "arrival": self._arrival.state_dict(),
            "down": sorted(int(c) for c in self._down),
            "down_until": [[int(c), int(r)] for c, r
                           in sorted(self._down_until.items())],
            "degraded": [[int(c), float(f), int(u)] for c, (f, u)
                         in sorted(self._degraded.items())],
            "partitioned": [[int(c), int(u)] for c, u
                            in sorted(self._partitioned.items())],
            "void": [[int(c), int(v)] for (c, v) in sorted(self._void)],
            "drop_pending": [[int(c), int(v)] for (c, v)
                             in sorted(self._drop_pending)],
            "retry_count": [[int(c), int(v), int(n)] for (c, v), n
                            in sorted(self._retry_count.items())],
            "held": [[int(c), int(v)] for (c, v) in self._held],
            "fault_stats": {k: float(v) for k, v
                            in sorted(self._fault_stats.items())},
            "orchestrator": self.orchestrator.runtime_state(),
        }

    def restore_state(self, state: dict, store: Dict[tuple, object]) -> None:
        """Inverse of :meth:`checkpoint_state`; ``store`` carries the
        in-flight update trees restored from the npz payload."""
        self.clock = VirtualClock()
        self.clock.load_state(state["clock"], _decode_event)
        self._placement = None
        self._buffers = []
        if state["placement"] is not None:
            self._set_placement(np.asarray(state["placement"], np.int64))
            for b, bs in zip(self._buffers, state["buffers"],
                             strict=True):
                b.epoch = int(bs["epoch"])
                b.parts = [
                    BufferedPart(src=int(src),
                                 entries=_decode_entries(ents))
                    for src, ents in bs["parts"]]
        self._in_flight = {int(c) for c in state["in_flight"]}
        self._sent = {(int(c), int(v)): float(t)
                      for c, v, t in state["sent"]}
        self._store = dict(store)
        self._round = int(state["round"])
        if state["slot_ewma"] is not None:
            self._slot_ewma = np.asarray(state["slot_ewma"], np.float64)
            self._slot_obs = np.asarray(state["slot_obs"], np.int64)
        self._client_delay = {int(c): float(d)
                              for c, d in state["client_delay"]}
        self._reopt_swaps = int(state["reopt_swaps"])
        self._pending_pulse = bool(state["pending_pulse"])
        self._topology_version = int(state["topology_version"])
        self._arrival.load_state(state["arrival"])
        self._down = {int(c) for c in state["down"]}
        self._down_until = {int(c): int(r)
                            for c, r in state["down_until"]}
        self._degraded = {int(c): (float(f), int(u))
                          for c, f, u in state["degraded"]}
        self._partitioned = {int(c): int(u)
                             for c, u in state["partitioned"]}
        self._void = {(int(c), int(v)) for c, v in state["void"]}
        self._drop_pending = {(int(c), int(v))
                              for c, v in state["drop_pending"]}
        self._retry_count = {(int(c), int(v)): int(n)
                             for c, v, n in state["retry_count"]}
        self._held = [(int(c), int(v)) for c, v in state["held"]]
        self._fault_stats = {str(k): float(v)
                             for k, v in state["fault_stats"].items()}
        self.orchestrator.load_runtime_state(state["orchestrator"])



def _sim_cost_model(spec, hierarchy, pool, eval_config, device) -> CostModel:
    """The simulated track's cost model under ``eval_config``, on
    ``device``: analytic eqs. 6-7 by default, or the trace-calibrated
    variant when ``cost_source='calibrated'`` names a fitted-calibration
    JSON."""
    if eval_config is not None and eval_config.cost_source == "calibrated":
        from repro_torch.calibration import load_calibration
        cal = load_calibration(eval_config.calibration)
        return cal.make_cost_model(hierarchy, pool,
                                   memory_penalty=spec.memory_penalty,
                                   device=device)
    return CostModel(hierarchy, pool, memory_penalty=spec.memory_penalty,
                     device=device)


def _apply_eval_config(env, eval_config) -> "Environment":
    """Common EvalConfig wiring for a freshly built environment."""
    if eval_config is None:
        return env
    if eval_config.recording == "on":
        env.record_timings = True
    if eval_config.backend is not None:
        env.cost_model.set_default_backend(eval_config.backend)
    return env


def build_environment(spec, seed: int = 0, eval_config=None, *,
                      device="cuda") -> Environment:
    """Materialize a ScenarioSpec into a fresh environment for one run,
    on ``device``: the simulated track's cost model scores swarms there,
    the emulated track trains and aggregates there.

    ``eval_config`` (an :class:`~repro_torch.experiments.EvalConfig`)
    applies the evaluation surface: a calibrated cost source swaps the
    analytic model for the trace-fitted one (simulated track only), a
    backend pin becomes the cost model's default ``batch_tpd`` backend,
    and ``recording='on'`` arms per-round timing capture."""
    calibrated = (eval_config is not None
                  and eval_config.cost_source == "calibrated")
    if calibrated and spec.kind != "simulated":
        raise ValueError(
            "eval.cost_source='calibrated' applies to the simulated "
            "track only — the executing tracks measure real delays; "
            f"scenario {spec.name!r} is {spec.kind!r}")
    hierarchy = spec.make_hierarchy()
    pool = spec.make_pool(seed)
    faults = spec.make_faults(seed)
    if spec.kind == "simulated":
        if not faults.empty or spec.quorum_frac > 0:
            raise ValueError(
                "fault schedules need a track that executes rounds — "
                "the simulated (analytic) track has no clients to "
                "crash; use kind='emulated' or 'online'")
        if spec.sampling != "off":
            # resident pool + round-0 cohort view; subsequent cohorts
            # are regathered in place by sync_topology
            sampler = spec.make_sampler(seed)
            cohort = sampler.draw(0, len(pool))
            view = ClientPool(
                memcap=pool.memcap[cohort].copy(),
                pspeed=pool.pspeed[cohort].copy(),
                mdatasize=pool.mdatasize[cohort].copy())
            cm = _sim_cost_model(spec, hierarchy, view, eval_config, device)
            return _apply_eval_config(
                SampledSimulatedEnvironment(hierarchy, view, cm,
                                            pool, sampler), eval_config)
        if spec.pods:
            if calibrated:
                raise ValueError(
                    "eval.cost_source='calibrated' does not cover the "
                    "two-tier pod model (pods=0 scenarios only)")
            n = hierarchy.total_clients
            pod_of = np.arange(n) * spec.pods // n
            cm = TwoTierCostModel(hierarchy, pool,
                                  memory_penalty=spec.memory_penalty,
                                  device=device, pod_of=pod_of,
                                  ici_cost=spec.ici_cost,
                                  dcn_cost=spec.dcn_cost)
        else:
            cm = _sim_cost_model(spec, hierarchy, pool, eval_config, device)
        return _apply_eval_config(SimulatedEnvironment(hierarchy, pool, cm),
                                  eval_config)

    # emulated/online: build model + data + orchestrator
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.models import get_model

    cfg = get_config(spec.model)
    model = get_model(cfg)
    data = make_federated_dataset(cfg, hierarchy.total_clients, seed=seed)
    orch = FederatedOrchestrator(
        model, hierarchy, pool, data,
        local_steps=spec.local_steps, batch_size=spec.batch_size,
        seed=seed, comm_latency=spec.comm_latency, timing=spec.timing,
        engine=spec.engine, device=device)
    if spec.kind == "online":
        async_cfg = AsyncConfig(
            jitter=spec.jitter, staleness_alpha=spec.staleness_alpha,
            flush_fraction=spec.flush_fraction,
            flush_timeout=spec.flush_timeout, server_lr=spec.server_lr,
            reopt_threshold=spec.reopt_threshold,
            reopt_beta=spec.reopt_beta)
        retry = RetryPolicy(max_retries=spec.retry_limit,
                            backoff_base=spec.retry_backoff)
        return _apply_eval_config(
            OnlineEnvironment(orch, async_cfg, seed=seed,
                              faults=faults, retry=retry,
                              quorum_frac=spec.quorum_frac), eval_config)
    return _apply_eval_config(
        EmulatedEnvironment(orch, faults=faults,
                            quorum_frac=spec.quorum_frac), eval_config)
