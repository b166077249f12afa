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
quorum. Both checkpoint and restore their run state. The online track
raises ``NotImplementedError`` until ROADMAP.md queue 1 item 7, the
calibrated cost source until item 9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.cost_model import CostModel, TwoTierCostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, slot_remap
from repro_torch.faults import (
    AggregatorFailure,
    ClientCrash,
    ClientRecover,
    FaultSchedule,
    LinkDegrade,
    NetworkPartition,
    UpdateDrop,
)
from repro_torch.fl.distributed import elastic_rehierarchize


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


def _sim_cost_model(spec, hierarchy, pool, eval_config, device) -> CostModel:
    """The simulated track's cost model under ``eval_config``: analytic
    eqs. 6-7. The reference's trace-calibrated variant
    (``cost_source='calibrated'``) comes with ROADMAP.md queue 1 item 9."""
    if eval_config is not None and eval_config.cost_source == "calibrated":
        raise NotImplementedError(
            "eval.cost_source='calibrated' (CalibratedCostModel and the "
            "calibration fit) comes with ROADMAP.md queue 1 item 9 "
            "(calibration)")
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
    applies the evaluation surface: a backend pin becomes the cost
    model's default ``batch_tpd`` backend, and ``recording='on'`` arms
    per-round timing capture."""
    calibrated = (eval_config is not None
                  and eval_config.cost_source == "calibrated")
    if calibrated and spec.kind != "simulated":
        raise ValueError(
            "eval.cost_source='calibrated' applies to the simulated "
            "track only — the executing tracks measure real delays; "
            f"scenario {spec.name!r} is {spec.kind!r}")
    if spec.kind == "online":
        raise NotImplementedError(
            f"scenario {spec.name!r} is online; the online track comes "
            f"with ROADMAP.md queue 1 item 7 (online track)")
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

    # emulated: build model + data + orchestrator
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
    return _apply_eval_config(
        EmulatedEnvironment(orch, faults=faults,
                            quorum_frac=spec.quorum_frac), eval_config)
