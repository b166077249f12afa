"""Declarative experiment scenarios.

The port's copy of ``repro.experiments.scenarios``: every preset is
registered with the same fields and the same pools per seed, and the
port builds every kind: ``simulated``, ``emulated`` and ``online``
(faults, quorums and the two-tier pod model included).

A :class:`ScenarioSpec` is everything needed to reconstruct one
evaluation world: the aggregation hierarchy, the client-pool profile,
the environment kind (``simulated`` = the paper's Fig. 3 analytical
`CostModel`; ``emulated`` = the Fig. 4 docker-cluster emulation via
`FederatedOrchestrator`; ``online`` = the same orchestrator under the
asynchronous discrete-event track of ``repro.online``), and a per-round
*event schedule* (pspeed
drift, client churn, straggler spikes, latency noise) that turns the
stationary paper setups into the adaptive scenarios the roadmap asks
for.

Presets registered here (``get_scenario`` / ``list_scenarios``):

==============  ==========  ====================================================
name            kind        what it reproduces / probes
==============  ==========  ====================================================
``paper-fig3``  simulated   one Fig. 3 grid cell (PSO vs. eqs. 6-7 TPD model)
``paper-fig4``  emulated    the 10-client heterogeneous docker cluster (Fig. 4)
``drift``       simulated   mid-run pspeed reversal (Sec. VI future work)
``churn``       simulated   periodic client replacement (device churn)
``straggler``   simulated   transient slowdown spikes on a client subset
``latency``     simulated   multiplicative noise on the observed TPD signal
``two-tier``    simulated   ICI/DCN pod topology (TwoTierCostModel)
``large-256``   simulated   256-client pool, depth-4 tree (scale smoke)
``large-1k``    simulated   1k clients, depth-6/width-3 (364 slots)
``large-4k``    simulated   4k clients, depth-5/width-4 (341 slots)
``large-10k``   simulated   10k clients, depth-6/width-4 (1365 slots)
``large-100k``  simulated   100k pool, 512-cohort/round sampling
``pool-1m``     simulated   1M pool, 1024-cohort/round sampling
``flash-crowd``     simulated  population ramps mid-run; tree re-grows
``composite-storm`` simulated  joins+leaves+churn+stragglers+noise at once
``ebb-and-flow``    simulated  periodic join/leave waves across capacity
``online-fig4``     online     Fig. 4 cluster asynchronously (jitter + buffers)
``online-straggler`` online    delay-triggered mid-round host re-optimization
``online-sync``     online     degenerate lockstep twin of paper-fig4 (parity)
``online-faulty``   online     online-fig4 under crashes/drops/degrades + retry
``chaos``           online     every fault kind at once, quorum-gated merges
==============  ==========  ====================================================

The last two carry a FAULT track (``repro_torch.faults``): a seeded
:class:`~repro_torch.faults.schedule.FaultProfile` draws a randomized-but-
replayable :class:`~repro_torch.faults.schedule.FaultSchedule` per run
(``spec.make_faults(seed)``), and the tolerance knobs
(``retry_limit``/``retry_backoff``/``quorum_frac``) configure bounded
virtual-time retries and the quorum-gated degraded merge. A spec with
no profile and an empty ``faults`` tuple runs the exact pre-fault code
paths — bit-identical to the fault-free tracks (the parity pin).

The last three are ELASTIC: ``ClientJoin``/``ClientLeave`` events
genuinely resize the pool, and the environments re-hierarchize (new
``Hierarchy``, bumped ``topology_version``, strategy ``migrate`` hooks)
whenever the population crosses the current tree's capacity window.
They run on BOTH tracks: ``spec.for_env("emulated")`` (CLI
``--env emulated``) drives the same event schedule through the live
``FederatedOrchestrator`` — clients admitted/retired mid-run, joiners
training from the current global model — and replays the identical
hierarchy sequence the simulated track produces.

The ``large-*`` rungs are the swarm-scale regime: they are only
practical through the exact vectorized evaluators
(``CostModel.tpd_fast`` per step, ``PooledTPDEvaluator`` in the batched
sweep runner) — the scalar eq. 6/7 loop costs milliseconds per call at
these sizes (``benchmarks/bench_scale.py`` tracks the gap).

``large-100k``/``pool-1m`` add the SAMPLED regime on top: the spec's
``sampling``/``pool_size``/``cohort_size`` knobs keep a resident
:class:`ClientPool` of ``pool_size`` clients while every round draws a
``cohort_size`` cohort from a counter-based stream
(``repro_torch.experiments.sampling``); the cohort — not the pool — drives
``choose_fl_hierarchy`` and the cost model, so memory is bounded by
the cohort. ``sampling='off'`` (the default everywhere else) runs the
exact pre-sampling code paths, byte-identical artifacts included.

Specs are frozen; derive variants with ``with_overrides(depth=4, ...)``
(the CLI's ``--set key=value`` goes through the same path).
"""
from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.faults.schedule import (
    FaultEvent,
    FaultProfile,
    FaultSchedule,
    fault_from_dict,
)


# ---------------------------------------------------------------------------
# client-pool profiles
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PoolProfile:
    """How to build the ClientPool for a scenario.

    ``kind='random'`` samples the paper's Sec. IV-A distributions
    (memcap ~ U[10,50), pspeed ~ U[5,15)) per seed; ``kind='explicit'``
    pins every attribute (the Fig. 4 docker resource limits).
    """
    kind: str = "random"                 # 'random' | 'explicit'
    mdatasize: float = 5.0
    memcap: Optional[Tuple[float, ...]] = None
    pspeed: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.kind not in ("random", "explicit"):
            raise ValueError(f"unknown pool profile kind {self.kind!r}")
        if self.kind == "explicit" and (self.memcap is None
                                        or self.pspeed is None):
            raise ValueError("explicit pool profile needs memcap + pspeed")

    def make(self, n_clients: int, seed: int) -> ClientPool:
        if self.kind == "random":
            return ClientPool.random(n_clients, seed=seed,
                                     mdatasize=self.mdatasize)
        if len(self.pspeed) != n_clients or len(self.memcap) != n_clients:
            raise ValueError(
                f"explicit pool has {len(self.pspeed)} pspeed / "
                f"{len(self.memcap)} memcap entries, "
                f"scenario needs {n_clients} clients")
        return ClientPool(
            memcap=np.asarray(self.memcap, np.float64).copy(),
            pspeed=np.asarray(self.pspeed, np.float64).copy(),
            mdatasize=np.full(n_clients, self.mdatasize, np.float64))


# ---------------------------------------------------------------------------
# per-round event schedules
# ---------------------------------------------------------------------------
@dataclass
class ScheduledEvent:
    """Base event. Subclasses mutate the client pool before a round
    (``on_round``) and/or distort the observed delay (``transform_tpd``).

    Event instances in a spec are templates: the runner works on a
    ``fresh()`` copy per (strategy, seed) run so mutable state (e.g. a
    straggler's saved speeds) never leaks across runs.

    Same-round application order is deterministic and documented:
    within each round, events fire sorted by ``(class_name, index)`` —
    class name first, spec position breaking ties (``make_events``
    performs the stable sort once) — so composite schedules replay
    identically across the sequential and batched runners regardless of
    how the spec happened to list them.
    """

    # True for events that resize the population (ClientJoin/Leave):
    # the runners re-sync the topology after applying a round's events
    resizes_pool = False

    def fresh(self) -> "ScheduledEvent":
        return copy.deepcopy(self)

    def on_round(self, round_idx: int, pool: ClientPool,
                 rng: np.random.Generator) -> Optional[str]:
        """Mutate ``pool`` in place; return a log line or None."""
        return None

    def on_topology(self, update) -> None:
        """An elastic resize renumbered the population: events holding
        client-id-keyed state carry it through ``update.client_remap``
        (same :class:`~repro_torch.core.hierarchy.TopologyUpdate` the strategy
        ``migrate`` hooks receive; the runners invoke this right after
        them, in both execution modes)."""
        return None

    def transform_tpd(self, round_idx: int, tpd: float,
                      rng: np.random.Generator) -> float:
        return tpd

    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe mutable run state for checkpointing. Stateless
        events (most of them — the rng lives in the runner) return
        ``{}``; events carrying cross-round state (StragglerSpike's
        saved speeds) override both hooks."""
        return {}

    def load_state(self, state: Dict[str, Any]) -> None:
        return None

    def to_dict(self) -> Dict[str, Any]:
        d = {"event": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return d


@dataclass
class PSpeedDrift(ScheduledEvent):
    """One-shot system drift at ``at_round``: client speeds are reversed
    (fast hosts become slow — the bench_drift scenario) or reshuffled."""
    at_round: int = 60
    mode: str = "reverse"                # 'reverse' | 'shuffle'

    def on_round(self, round_idx, pool, rng):
        if round_idx != self.at_round:
            return None
        if self.mode == "reverse":
            pool.pspeed = pool.pspeed[::-1].copy()
        elif self.mode == "shuffle":
            pool.pspeed = rng.permutation(pool.pspeed).copy()
        else:
            raise ValueError(f"unknown drift mode {self.mode!r}")
        return f"pspeed drift ({self.mode})"


@dataclass
class ClientChurn(ScheduledEvent):
    """Every ``every`` rounds a random ``fraction`` of clients leave and
    are replaced by fresh devices (attributes resampled from the paper's
    Sec. IV-A distributions)."""
    every: int = 10
    fraction: float = 0.25
    first_round: int = 1

    def on_round(self, round_idx, pool, rng):
        if round_idx < self.first_round or \
                (round_idx - self.first_round) % self.every != 0:
            return None
        n = len(pool)
        k = max(1, int(round(n * self.fraction)))
        who = rng.choice(n, size=k, replace=False)
        pool.memcap[who] = rng.uniform(10, 50, k)
        pool.pspeed[who] = rng.uniform(5, 15, k)
        pool.touch()  # in-place edit: bump the evaluator-cache version
        return f"churn: replaced {k} clients"


@dataclass
class StragglerSpike(ScheduledEvent):
    """Every ``every`` rounds a random ``fraction`` of clients slows
    down by ``slowdown``x for ``duration`` rounds, then recovers —
    container throttling / co-tenant interference."""
    every: int = 15
    duration: int = 5
    fraction: float = 0.2
    slowdown: float = 6.0
    first_round: int = 5
    # client -> (slowed value, original value); restoring checks the
    # slowed value is still in place so a concurrent event (churn
    # replacing the device, a drift reshuffle) that already rewrote the
    # client's speed is not clobbered by a stale recovery
    _saved: Dict[int, tuple] = field(default_factory=dict, repr=False)
    _until: int = field(default=-1, repr=False)

    def _rekey_saved(self, remap) -> None:
        if self._saved and remap is not None:
            self._saved = {int(remap[c]): v
                           for c, v in self._saved.items()
                           if c < len(remap) and remap[c] >= 0}

    def on_topology(self, update):
        # a resize renumbered the population mid-spike: re-key the saved
        # speeds so recovery restores the RIGHT (surviving) devices —
        # departed stragglers are simply forgotten
        self._rekey_saved(update.client_remap)

    def on_round(self, round_idx, pool, rng):
        if self._saved and round_idx >= self._until:
            # a SAME-round ClientLeave (canonical order puts it first)
            # may have renumbered the pool before this restore and the
            # end-of-round on_topology re-key: peek the pool's pending
            # resize log so the restore targets current indices
            self._rekey_saved(pool.pending_remap())
            restored = 0
            for c, (slowed, original) in self._saved.items():
                # belt and braces on top of on_topology's re-keying: the
                # index bound plus the slowed-value check keep a stale
                # recovery from touching the wrong device
                if c < len(pool) and pool.pspeed[c] == slowed:
                    pool.pspeed[c] = original
                    restored += 1
            self._saved = {}
            pool.touch()  # in-place edit: bump the cache version
            return f"stragglers recovered ({restored} clients)"
        if self._saved or round_idx < self.first_round or \
                (round_idx - self.first_round) % self.every != 0:
            return None
        n = len(pool)
        k = max(1, int(round(n * self.fraction)))
        who = rng.choice(n, size=k, replace=False)
        originals = {int(c): float(pool.pspeed[c]) for c in who}
        pool.pspeed[who] = pool.pspeed[who] / self.slowdown
        pool.touch()  # in-place edit: bump the cache version
        self._saved = {c: (float(pool.pspeed[c]), v)
                       for c, v in originals.items()}
        self._until = round_idx + self.duration
        return f"straggler spike: {k} clients {self.slowdown:g}x slower"

    def to_dict(self):
        d = super().to_dict()
        d.pop("_saved", None)
        d.pop("_until", None)
        return d

    def state_dict(self):
        return {"saved": [[int(c), float(slowed), float(orig)]
                          for c, (slowed, orig)
                          in sorted(self._saved.items())],
                "until": int(self._until)}

    def load_state(self, state):
        self._saved = {int(c): (float(slowed), float(orig))
                       for c, slowed, orig in state["saved"]}
        self._until = int(state["until"])


@dataclass
class ClientJoin(ScheduledEvent):
    """Every ``every`` rounds from ``first_round`` (through
    ``last_round``, when set), ``count`` fresh devices JOIN the pool —
    a true population resize (arrays grow, new ids are minted), not the
    attribute masking ``ClientChurn`` does. Attributes are sampled from
    the paper's Sec. IV-A distributions. The environments re-hierarchize
    when the growth crosses the tree's capacity (flash crowds)."""
    resizes_pool = True
    every: int = 10
    count: int = 4
    first_round: int = 5
    last_round: Optional[int] = None

    def on_round(self, round_idx, pool, rng):
        if round_idx < self.first_round or \
                (round_idx - self.first_round) % self.every != 0:
            return None
        if self.last_round is not None and round_idx > self.last_round:
            return None
        pool.join(memcap=rng.uniform(10, 50, self.count),
                  pspeed=rng.uniform(5, 15, self.count))
        return f"join: +{self.count} clients (pool now {len(pool)})"


@dataclass
class ClientLeave(ScheduledEvent):
    """Every ``every`` rounds from ``first_round``, ``count`` random
    clients LEAVE the pool — a true resize: survivors are renumbered and
    the composed old->new id remap flows through the topology update to
    every strategy's ``migrate`` hook. Departures can take out current
    aggregator hosts; the strategies repair such placements. Never
    shrinks the pool below ``min_clients``."""
    resizes_pool = True
    every: int = 10
    count: int = 4
    first_round: int = 10
    last_round: Optional[int] = None
    min_clients: int = 8

    def on_round(self, round_idx, pool, rng):
        if round_idx < self.first_round or \
                (round_idx - self.first_round) % self.every != 0:
            return None
        if self.last_round is not None and round_idx > self.last_round:
            return None
        k = min(self.count, len(pool) - self.min_clients)
        if k <= 0:
            return None
        who = rng.choice(len(pool), size=k, replace=False)
        pool.leave(who)
        return f"leave: -{k} clients (pool now {len(pool)})"


@dataclass
class LatencyNoise(ScheduledEvent):
    """Multiplicative lognormal-ish noise on the observed TPD — the
    black-box signal the strategy sees gets dirtier, the true system
    stays put (tests optimizer robustness to measurement noise)."""
    sigma: float = 0.1

    def transform_tpd(self, round_idx, tpd, rng):
        return float(tpd * max(1.0 + rng.normal(0.0, self.sigma), 1e-3))


_EVENT_TYPES = {cls.__name__: cls for cls in
                (PSpeedDrift, ClientChurn, StragglerSpike, LatencyNoise,
                 ClientJoin, ClientLeave)}


def event_from_dict(d: Dict[str, Any]) -> ScheduledEvent:
    d = dict(d)
    name = d.pop("event", None)
    cls = _EVENT_TYPES.get(name)
    if cls is None:
        known = ", ".join(sorted(_EVENT_TYPES))
        raise ValueError(f"unknown event type {name!r}; known: {known}")
    return cls(**d)


# ---------------------------------------------------------------------------
# the scenario spec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ScenarioSpec:
    """One declarative experiment world (see module docstring)."""
    name: str
    kind: str                            # 'simulated' | 'emulated'
    depth: int = 3
    width: int = 2
    trainers_per_leaf: int = 2
    n_clients: Optional[int] = None
    pool: PoolProfile = field(default_factory=PoolProfile)
    events: Tuple[ScheduledEvent, ...] = ()
    rounds: int = 100                    # default round budget
    description: str = ""

    # simulated-only knobs
    memory_penalty: float = 0.0
    pods: Optional[int] = None           # two-tier topology: pod count
    ici_cost: float = 0.005
    dcn_cost: float = 0.05

    # emulated/online knobs (online runs the same orchestrator)
    model: str = "paper-mlp-1m8"
    local_steps: int = 2
    batch_size: int = 32
    comm_latency: float = 0.0
    timing: str = "deterministic"
    engine: str = "auto"

    # online-only knobs (see repro.online.async_fedavg.AsyncConfig)
    jitter: float = 0.0                  # lognormal sigma on train delays
    staleness_alpha: float = 0.5         # (1 + s)^(-alpha) decay
    flush_fraction: float = 1.0          # buffer count-flush fraction
    flush_timeout: float = 0.0           # virtual-time deadline (0 = off)
    server_lr: float = 1.0               # eta at the root merge
    reopt_threshold: float = 0.0         # flush-latency trigger (0 = off)
    reopt_beta: float = 0.5              # EWMA decay for observed delays

    # fault track (repro_torch.faults; emulated + online kinds)
    faults: Tuple[FaultEvent, ...] = ()  # explicit pinned fault events
    fault_profile: Optional[FaultProfile] = None   # seeded generation
    quorum_frac: float = 0.0             # 0 = merge whatever arrived
    retry_limit: int = 0                 # retries per dropped update
    retry_backoff: float = 0.25          # virtual-time backoff base

    # client sampling (simulated track; repro_torch.experiments.sampling):
    # the resident pool holds pool_size clients, each round draws a
    # cohort_size cohort from a counter-based stream; the COHORT drives
    # the hierarchy and the cost model, so memory scales with the
    # cohort, not the pool. "off" = full participation (the pre-
    # sampling code paths, byte-identical artifacts).
    sampling: str = "off"                # 'off' | 'uniform'
    pool_size: Optional[int] = None      # resident pool (sampling only)
    cohort_size: int = 0                 # per-round participants

    def __post_init__(self):
        if self.kind not in ("simulated", "emulated", "online"):
            raise ValueError(f"unknown scenario kind {self.kind!r}")
        if self.sampling not in ("off", "uniform"):
            raise ValueError(f"unknown sampling mode {self.sampling!r}; "
                             f"use 'off' or 'uniform'")
        if self.sampling != "off":
            if self.kind != "simulated":
                raise ValueError("client sampling is simulated-only "
                                 f"(kind={self.kind!r})")
            if self.pods is not None:
                raise ValueError("client sampling does not compose with "
                                 "the two-tier pod topology yet")
            if self.cohort_size < 2:
                raise ValueError(f"sampling needs cohort_size >= 2, "
                                 f"got {self.cohort_size}")
            if self.pool_size is None or self.pool_size < self.cohort_size:
                raise ValueError(
                    f"sampling needs pool_size >= cohort_size "
                    f"({self.pool_size} vs {self.cohort_size})")

    # -- construction ------------------------------------------------------
    def make_hierarchy(self) -> Hierarchy:
        if self.sampling != "off":
            # the cohort drives the tree: pick the scale-ladder shape
            # that fits cohort_size clients, exactly as the elastic
            # re-hierarchization will mid-run
            from repro_torch.fl.distributed import choose_fl_hierarchy
            return choose_fl_hierarchy(self.cohort_size, scale=True)
        return Hierarchy(depth=self.depth, width=self.width,
                         trainers_per_leaf=self.trainers_per_leaf,
                         n_clients=self.n_clients)

    def make_pool(self, seed: int) -> ClientPool:
        if self.sampling != "off":
            return self.pool.make(int(self.pool_size), seed)
        return self.pool.make(self.make_hierarchy().total_clients, seed)

    def make_sampler(self, seed: int):
        """The run's :class:`~repro_torch.experiments.sampling.CohortSampler`
        (None when sampling is off)."""
        if self.sampling == "off":
            return None
        from repro_torch.experiments.sampling import CohortSampler
        return CohortSampler(seed, self.cohort_size)

    def make_environment(self, seed: int = 0, eval_config=None, *,
                         device="cuda"):
        """Build a fresh Environment for one (strategy, seed) run on
        ``device`` (``"cpu"`` runs the plain torch paths on the host).
        ``eval_config`` (an :class:`~repro_torch.experiments.EvalConfig`)
        selects cost source / backend pin / timing recording."""
        from repro_torch.experiments.environments import build_environment
        return build_environment(self, seed, eval_config=eval_config,
                                 device=device)

    def make_faults(self, seed: int) -> FaultSchedule:
        """The run's fault schedule: the spec's explicit pinned events
        plus (when a :class:`FaultProfile` is set) the randomized-but-
        seeded events drawn from the dedicated fault stream — a pure
        function of (spec, seed), so every faulty run replays."""
        events = tuple(self.faults)
        if self.fault_profile is not None:
            hier = self.make_hierarchy()
            gen = FaultSchedule.generate(
                self.fault_profile, seed=seed,
                n_clients=hier.total_clients, n_slots=hier.dimensions,
                rounds=self.rounds)
            events = events + gen.events
        return FaultSchedule(events)

    def make_events(self) -> Tuple[ScheduledEvent, ...]:
        """Fresh per-run event copies in the CANONICAL application
        order: stable-sorted by ``(class_name, spec index)``, so a
        composite schedule fires identically every run, in every
        execution mode, however the spec listed its events."""
        fresh = [e.fresh() for e in self.events]
        return tuple(sorted(fresh, key=lambda e: type(e).__name__))

    @property
    def is_elastic(self) -> bool:
        """Does any scheduled event resize the client population?"""
        return any(e.resizes_pool for e in self.events)

    def for_env(self, kind: str) -> "ScenarioSpec":
        """The same scenario on the other evaluation track.

        ``for_env('emulated')`` runs a (possibly elastic) simulated
        preset on the Fig. 4 world — real local training via
        ``FederatedOrchestrator``, with the track-specific knobs
        (``model``, ``local_steps``, ``timing``, ...) taking their
        spec'd values; ``for_env('simulated')`` goes the other way;
        ``for_env('online')`` lifts any preset onto the asynchronous
        event-driven track (with its ``jitter``/``flush_*``/``reopt_*``
        knobs at their spec'd values — a preset that never set them runs
        the degenerate lockstep config, bit-identical to emulated). The
        CLI's ``--env`` flag routes through here.
        """
        if kind not in ("simulated", "emulated", "online"):
            raise ValueError(f"unknown environment kind {kind!r}")
        if kind == self.kind:
            return self
        return dataclasses.replace(self, kind=kind)

    # -- variants ----------------------------------------------------------
    def with_overrides(self, **overrides) -> "ScenarioSpec":
        """``dataclasses.replace`` with CLI-friendly string coercion."""
        coerced = {}
        by_name = {f.name: f for f in dataclasses.fields(self)}
        for k, v in overrides.items():
            if k not in by_name:
                accepted = ", ".join(sorted(by_name))
                raise TypeError(f"scenario {self.name!r} has no field "
                                f"{k!r}; fields: {accepted}")
            try:
                if k == "fault_profile":
                    coerced[k] = _coerce_profile(v)
                else:
                    coerced[k] = _coerce(v, getattr(self, k))
            except ValueError:
                raise TypeError(
                    f"cannot parse {k}={v!r} for scenario "
                    f"{self.name!r} (current value "
                    f"{getattr(self, k)!r})") from None
        return dataclasses.replace(self, **coerced)

    # -- serialization (for the versioned result artifact) -----------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["pool"] = dataclasses.asdict(self.pool)
        d["events"] = [e.to_dict() for e in self.events]
        d["faults"] = [f.to_dict() for f in self.faults]
        d["fault_profile"] = (None if self.fault_profile is None
                              else self.fault_profile.to_dict())
        if self.sampling == "off":
            # sampling-free artifacts keep the pre-sampling schema
            # byte-identical (the parity pin in tests/golden/)
            for k in ("sampling", "pool_size", "cohort_size"):
                d.pop(k, None)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        d = dict(d)
        d["pool"] = PoolProfile(**d.get("pool", {}))
        d["events"] = tuple(event_from_dict(e) for e in d.get("events", ()))
        # schema v1/v2 artifacts predate the fault track: absent keys
        # mean the fault-free defaults
        d["faults"] = tuple(fault_from_dict(f) for f in d.get("faults", ()))
        fp = d.get("fault_profile")
        d["fault_profile"] = None if fp is None else FaultProfile.from_dict(fp)
        return cls(**d)


def _coerce(value, current):
    """Coerce a CLI string to the field's current type.

    Scalars coerce by the current value's type; TUPLE fields (the event
    schedule above all) parse as JSON — a list of ``{"event": ...}``
    dicts becomes a tuple of :class:`ScheduledEvent` via
    ``event_from_dict``, any other JSON list becomes a plain tuple, and
    ``""``/``none``/``[]``/``()`` clear the field — so
    ``--set 'events=[{"event":"ClientJoin","count":4}]'`` works from
    the command line.
    """
    if not isinstance(value, str) or isinstance(current, str):
        return value
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, tuple):
        return _coerce_sequence(value)
    if isinstance(current, int) or (current is None and value.isdigit()):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if current is None:
        try:
            return int(value)
        except ValueError:
            return value
    return value


def _coerce_sequence(value: str) -> tuple:
    """Parse a CLI string for a tuple-typed ScenarioSpec field (see
    :func:`_coerce`). Raises ``ValueError`` on malformed input, which
    ``with_overrides`` turns into the usual descriptive TypeError."""
    v = value.strip()
    if v.lower() in ("", "none", "()", "[]"):
        return ()
    parsed = json.loads(v)  # JSONDecodeError is a ValueError
    if not isinstance(parsed, list):
        raise ValueError(f"expected a JSON list, got {type(parsed).__name__}")
    if parsed and all(isinstance(e, dict) for e in parsed):
        # tagged dicts: {"fault": ...} -> FaultEvent, {"event": ...}
        # -> ScheduledEvent (so --set 'faults=[{"fault":"ClientCrash",
        # "client":3,"at_round":5}]' works from the command line)
        return tuple(fault_from_dict(e) if "fault" in e
                     else event_from_dict(e) for e in parsed)
    return tuple(parsed)


def _coerce_profile(value) -> Optional[FaultProfile]:
    """Coerce a ``fault_profile`` override: passthrough for None /
    FaultProfile, a JSON object string from the CLI (``""``/``none``
    clears it), or a plain dict."""
    if value is None or isinstance(value, FaultProfile):
        return value
    if isinstance(value, dict):
        return FaultProfile.from_dict(value)
    v = str(value).strip()
    if v.lower() in ("", "none", "{}"):
        return None
    parsed = json.loads(v)  # JSONDecodeError is a ValueError
    if not isinstance(parsed, dict):
        raise ValueError(
            f"expected a JSON object, got {type(parsed).__name__}")
    return FaultProfile.from_dict(parsed)


# ---------------------------------------------------------------------------
# preset registry
# ---------------------------------------------------------------------------
_SCENARIOS: Dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    key = spec.name.lower()
    if key in _SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} registered twice")
    _SCENARIOS[key] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    spec = _SCENARIOS.get(name.lower())
    if spec is None:
        known = ", ".join(sorted(_SCENARIOS))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}")
    return spec


def list_scenarios() -> Tuple[ScenarioSpec, ...]:
    return tuple(_SCENARIOS.values())


# the Fig. 4 docker resource limits -> relative speed units (one beefy,
# two medium, seven tiny containers; see bench_fig4_cluster)
_FIG4_PSPEED = (4.0, 2.0, 2.0) + (1.0,) * 7
_FIG4_MEMCAP = (2048.0, 1024.0, 1024.0) + (64.0,) * 7

register_scenario(ScenarioSpec(
    name="paper-fig3", kind="simulated", depth=3, width=4,
    trainers_per_leaf=2, rounds=100,
    description="One Fig. 3 grid cell: PSO against the eqs. 6-7 TPD "
                "cost model, paper Sec. IV-A client distributions."))

register_scenario(ScenarioSpec(
    name="paper-fig4", kind="emulated", depth=2, width=2,
    trainers_per_leaf=1, n_clients=10,
    pool=PoolProfile(kind="explicit", mdatasize=30.0,
                     memcap=_FIG4_MEMCAP, pspeed=_FIG4_PSPEED),
    rounds=50, model="paper-mlp-1m8", local_steps=2, batch_size=32,
    comm_latency=0.002, timing="deterministic",
    description="The 10-client heterogeneous docker/MQTT cluster "
                "(Fig. 4), emulated single-host."))

register_scenario(ScenarioSpec(
    name="drift", kind="simulated", depth=3, width=2, trainers_per_leaf=2,
    events=(PSpeedDrift(at_round=60, mode="reverse"),), rounds=180,
    description="Client speeds reversed at round 60: the 'container got "
                "throttled' drift scenario (paper Sec. VI)."))

register_scenario(ScenarioSpec(
    name="churn", kind="simulated", depth=3, width=2, trainers_per_leaf=2,
    n_clients=24, events=(ClientChurn(every=10, fraction=0.25),),
    rounds=120,
    description="A quarter of the pool replaced by fresh devices every "
                "10 rounds."))

register_scenario(ScenarioSpec(
    name="straggler", kind="simulated", depth=3, width=2,
    trainers_per_leaf=2, n_clients=24,
    events=(StragglerSpike(every=15, duration=5, fraction=0.2,
                           slowdown=6.0),),
    rounds=120,
    description="Transient 6x slowdown spikes on 20% of clients."))

register_scenario(ScenarioSpec(
    name="latency", kind="simulated", depth=3, width=2,
    trainers_per_leaf=2, events=(LatencyNoise(sigma=0.15),), rounds=120,
    description="15% multiplicative noise on the observed TPD signal."))

register_scenario(ScenarioSpec(
    name="two-tier", kind="simulated", depth=3, width=2,
    trainers_per_leaf=2, n_clients=24, pods=2, rounds=150,
    description="Two TPU pods: cross-pod aggregation edges pay DCN "
                "rates (~10x ICI); probes black-box locality discovery."))

register_scenario(ScenarioSpec(
    name="large-256", kind="simulated", depth=4, width=3,
    trainers_per_leaf=2, n_clients=256, rounds=150,
    description="256-client pool on a depth-4/width-3 tree (40 slots): "
                "the scale smoke for placement search."))

register_scenario(ScenarioSpec(
    name="flash-crowd", kind="simulated", depth=2, width=2,
    trainers_per_leaf=4, n_clients=12,
    events=(ClientJoin(every=5, count=6, first_round=10, last_round=40),),
    rounds=80,
    description="Population ramps 12 -> ~54 mid-run: the tree re-grows "
                "(depth-2 -> -3 -> -4, D 3 -> 7 -> 15) as the flash "
                "crowd crosses each capacity window; swarms migrate "
                "instead of restarting."))

register_scenario(ScenarioSpec(
    name="composite-storm", kind="simulated", depth=2, width=2,
    trainers_per_leaf=4, n_clients=14,
    events=(ClientJoin(every=12, count=5, first_round=6),
            ClientLeave(every=18, count=6, first_round=18,
                        min_clients=11),
            ClientChurn(every=10, fraction=0.2, first_round=4),
            StragglerSpike(every=15, duration=4, fraction=0.2,
                           slowdown=5.0, first_round=5),
            LatencyNoise(sigma=0.1)),
    rounds=80,
    description="Everything at once: joins, departures, device churn, "
                "straggler spikes and observation noise — the composite "
                "adaptive scenario the roadmap asks for."))

register_scenario(ScenarioSpec(
    name="ebb-and-flow", kind="simulated", depth=2, width=2,
    trainers_per_leaf=4, n_clients=12,
    events=(ClientJoin(every=20, count=8, first_round=10),
            ClientLeave(every=20, count=8, first_round=20,
                        min_clients=11),),
    rounds=100,
    description="Periodic join/leave waves oscillating across the "
                "capacity boundary: the topology re-hierarchizes every "
                "~10 rounds (the migrate-vs-cold-restart benchmark)."))

register_scenario(ScenarioSpec(
    name="large-1k", kind="simulated", depth=6, width=3,
    trainers_per_leaf=2, n_clients=1024, rounds=100,
    description="1k-client pool on a depth-6/width-3 tree (364 slots, "
                "~2.7 trainers/leaf — the paper's small-cluster regime "
                "at scale); the bench_scale 20x-vs-scalar reference "
                "point."))

register_scenario(ScenarioSpec(
    name="large-4k", kind="simulated", depth=5, width=4,
    trainers_per_leaf=2, n_clients=4096, rounds=60,
    description="4k-client pool on a depth-5/width-4 tree (341 slots, "
                "~14.7 trainers/leaf — the stuffed-leaves regime): mid "
                "swarm-scale rung."))

register_scenario(ScenarioSpec(
    name="large-10k", kind="simulated", depth=6, width=4,
    trainers_per_leaf=2, n_clients=10000, rounds=50,
    description="10k-client pool on a depth-6/width-4 tree (1365 "
                "slots): the paper's 'many clients as candidates' "
                "regime — a 50-round PSO run completes in seconds on "
                "CPU."))

register_scenario(ScenarioSpec(
    name="large-100k", kind="simulated", sampling="uniform",
    pool_size=100_000, cohort_size=512, rounds=60,
    description="100k-client resident pool, 512-client sampled cohort "
                "per round (depth-5/width-3, 121 slots): the first "
                "cross-device rung — memory scales with the cohort, "
                "not the pool."))

register_scenario(ScenarioSpec(
    name="pool-1m", kind="simulated", sampling="uniform",
    pool_size=1_000_000, cohort_size=1024, rounds=20,
    description="1M-client resident pool, 1024-client cohort per round "
                "(the large-1k tree, 364 slots): the production "
                "cross-device regime — the swarm only ever sees the "
                "cohort; pool attributes stay resident (~24 MB)."))

register_scenario(ScenarioSpec(
    name="online-fig4", kind="online", depth=2, width=2,
    trainers_per_leaf=1, n_clients=10,
    pool=PoolProfile(kind="explicit", mdatasize=30.0,
                     memcap=_FIG4_MEMCAP, pspeed=_FIG4_PSPEED),
    rounds=50, model="paper-mlp-1m8", local_steps=2, batch_size=32,
    comm_latency=0.002, timing="deterministic",
    jitter=0.35, staleness_alpha=0.5, flush_fraction=0.75,
    flush_timeout=0.5, server_lr=0.7,
    description="The Fig. 4 cluster asynchronously: jittered arrivals, "
                "75%-count-or-deadline buffer flushes, staleness-"
                "weighted merges — rounds overlap, stragglers land "
                "late with decayed weight."))

register_scenario(ScenarioSpec(
    name="online-straggler", kind="online", depth=3, width=2,
    trainers_per_leaf=2, n_clients=24,
    events=(StragglerSpike(every=15, duration=5, fraction=0.3,
                           slowdown=8.0),),
    rounds=60, comm_latency=0.002,
    jitter=0.25, staleness_alpha=0.5, flush_fraction=0.75,
    flush_timeout=0.5, server_lr=0.7,
    reopt_threshold=2.0, reopt_beta=0.5,
    description="The delay-triggered re-optimization demo: recurring "
                "8x straggler spikes blow a host's flush latency past "
                "2x its EWMA, and the environment swaps the host for "
                "the fastest observed unplaced client MID-ROUND "
                "(placement changes off the round boundary; the next "
                "sync_topology pulses strategies' migrate hooks)."))

register_scenario(ScenarioSpec(
    name="online-sync", kind="online", depth=2, width=2,
    trainers_per_leaf=1, n_clients=10,
    pool=PoolProfile(kind="explicit", mdatasize=30.0,
                     memcap=_FIG4_MEMCAP, pspeed=_FIG4_PSPEED),
    rounds=50, model="paper-mlp-1m8", local_steps=2, batch_size=32,
    comm_latency=0.002, timing="deterministic",
    description="paper-fig4's degenerate online twin: zero jitter, "
                "full-cohort flushes, no deadline — the event queue "
                "runs but every round is lockstep, bit-identical to "
                "the emulated track (the parity pin)."))

register_scenario(ScenarioSpec(
    name="online-faulty", kind="online", depth=2, width=2,
    trainers_per_leaf=1, n_clients=10,
    pool=PoolProfile(kind="explicit", mdatasize=30.0,
                     memcap=_FIG4_MEMCAP, pspeed=_FIG4_PSPEED),
    rounds=50, model="paper-mlp-1m8", local_steps=2, batch_size=32,
    comm_latency=0.002, timing="deterministic",
    jitter=0.35, staleness_alpha=0.5, flush_fraction=0.75,
    flush_timeout=0.5, server_lr=0.7,
    fault_profile=FaultProfile(crash_rate=0.15, crash_down_rounds=2,
                               drop_rate=0.25, degrade_rate=0.2,
                               degrade_factor=4.0, degrade_rounds=2,
                               agg_fail_every=10, agg_down_rounds=1,
                               first_round=2),
    retry_limit=3, retry_backoff=0.25, quorum_frac=0.2,
    description="online-fig4 under a seeded fault profile: client "
                "crashes void in-flight updates, transit drops retry "
                "with bounded virtual-time backoff, degraded links "
                "multiply delivery latency, and every 10th round the "
                "host of a random slot fails over mid-round; root "
                "flushes below the 20% quorum are refused (degraded "
                "flush, the model holds), at-or-above quorum they "
                "commit with a participation-damped server step."))

register_scenario(ScenarioSpec(
    name="chaos", kind="online", depth=2, width=2,
    trainers_per_leaf=1, n_clients=10,
    pool=PoolProfile(kind="explicit", mdatasize=30.0,
                     memcap=_FIG4_MEMCAP, pspeed=_FIG4_PSPEED),
    rounds=40, model="paper-mlp-1m8", local_steps=2, batch_size=32,
    comm_latency=0.002, timing="deterministic",
    jitter=0.3, staleness_alpha=0.5, flush_fraction=0.75,
    flush_timeout=0.5, server_lr=0.7,
    events=(StragglerSpike(every=12, duration=3, fraction=0.2,
                           slowdown=5.0, first_round=6),),
    fault_profile=FaultProfile(crash_rate=0.2, crash_down_rounds=2,
                               drop_rate=0.3, degrade_rate=0.25,
                               degrade_factor=5.0, degrade_rounds=2,
                               partition_rate=0.15, partition_frac=0.3,
                               partition_rounds=1, agg_fail_every=8,
                               agg_down_rounds=1, first_round=2),
    retry_limit=2, retry_backoff=0.25, quorum_frac=0.2,
    description="Every fault kind at once on the tiny Fig. 4 topology "
                "(so even exhaustive search completes): crashes, "
                "drops, link degradation, timed network partitions "
                "that hold in-flight updates until they heal, cadenced "
                "aggregator failovers, plus straggler spikes — the "
                "survivability stress all registered strategies must "
                "ride out with a valid placement every round."))
