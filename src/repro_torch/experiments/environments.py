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
CostModel`; its ``step`` scores with the exact float64 numpy path, and
swarm-mode callers (``FlagSwapPSO.run`` with ``batch_fitness_fn``) score
on the cost model's device. ``EmulatedEnvironment`` wraps
:class:`repro_torch.fl.orchestrator.FederatedOrchestrator`: its ``step``
runs a real federated round on the caller's device. The online track,
the emulated track's fault path and the two-tier pod model wait for
later slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, slot_remap
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
    # per-level timing rows of the reference's recording mode; empty
    # here until the port's EvalConfig brings recording
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
        return RoundObservation(round_idx=round_idx, placement=placement,
                                tpd=tpd,
                                topology_version=self.topology_version)


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


_FAULTS_NOT_PORTED = ("fault schedules and quorum merges on the "
                      "emulated track come with ROADMAP.md queue 1 item 8 "
                      "(faults/tolerance.py)")


class EmulatedEnvironment:
    """The Fig. 4 world: rounds cost what the federated run measures.

    Thin adapter over ``FederatedOrchestrator`` — ``step`` IS
    ``orchestrator.run_round``, so a strategy driven through this
    environment reproduces ``FederatedOrchestrator.run`` exactly
    (including model state evolution and eval metrics).

    The topology is ELASTIC, as on the simulated track:
    :meth:`sync_topology` delegates to
    ``FederatedOrchestrator.sync_population``. Fault injection (the
    reference's ``run_round_faulty`` path) is not ported: a fault
    schedule or a quorum raises.
    """
    kind = "emulated"

    def __init__(self, orchestrator, faults=None, quorum_frac: float = 0.0):
        if (faults is not None and not faults.empty) or quorum_frac > 0:
            raise NotImplementedError(_FAULTS_NOT_PORTED)
        self.orchestrator = orchestrator
        self.clients = orchestrator.clients
        self.record_timings = False
        self._cost_model: Optional[CostModel] = None

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


def _build_emulated(spec, hierarchy, pool, faults, seed, device):
    """Model + data + orchestrator for an emulated scenario."""
    if not faults.empty or spec.quorum_frac > 0:
        raise NotImplementedError(_FAULTS_NOT_PORTED)
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
    return EmulatedEnvironment(orch)


def build_environment(spec, seed: int = 0, *, device="cuda") -> Environment:
    """Materialize a ScenarioSpec into a fresh environment for one run,
    on ``device``: the simulated track's cost model scores swarms there,
    the emulated track trains and aggregates there."""
    if spec.kind == "online":
        raise NotImplementedError(
            f"scenario {spec.name!r} is online; the online track comes "
            f"with ROADMAP.md queue 1 item 7 (online track)")
    hierarchy = spec.make_hierarchy()
    pool = spec.make_pool(seed)
    faults = spec.make_faults(seed)
    if spec.kind == "emulated":
        return _build_emulated(spec, hierarchy, pool, faults, seed, device)
    if not faults.empty or spec.quorum_frac > 0:
        raise ValueError(
            "fault schedules need a track that executes rounds — "
            "the simulated (analytic) track has no clients to "
            "crash; use kind='emulated' or 'online'")
    if spec.sampling != "off":
        # resident pool + round-0 cohort view; subsequent cohorts are
        # regathered in place by sync_topology
        sampler = spec.make_sampler(seed)
        cohort = sampler.draw(0, len(pool))
        view = ClientPool(
            memcap=pool.memcap[cohort].copy(),
            pspeed=pool.pspeed[cohort].copy(),
            mdatasize=pool.mdatasize[cohort].copy())
        cm = CostModel(hierarchy, view, memory_penalty=spec.memory_penalty,
                       device=device)
        return SampledSimulatedEnvironment(hierarchy, view, cm, pool,
                                           sampler)
    if spec.pods:
        raise NotImplementedError(
            f"scenario {spec.name!r} uses the two-tier pod cost model; "
            f"it comes with ROADMAP.md queue 1 item 4 (TwoTierCostModel)")
    cm = CostModel(hierarchy, pool, memory_penalty=spec.memory_penalty,
                   device=device)
    return SimulatedEnvironment(hierarchy, pool, cm)
