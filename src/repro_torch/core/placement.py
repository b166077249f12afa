"""Placement strategies for the FL orchestrator.

The port's copy of ``repro.core.placement``: all ten strategies, in
numpy, proposing identically to the reference for the same seeds.

The paper compares three: PSO (Flag-Swap), random, and uniform
round-robin — we implement all three plus beyond-paper baselines: a
genetic algorithm (the meta-heuristic the paper argues PSO beats), an
exhaustive oracle (tiny scenarios only — gives the true optimum the
others can be scored against), and a greedy speed-sorted heuristic that
*cheats* by reading client pspeed (it is the non-black-box upper
baseline: what you could do if clients DID share telemetry).

All strategies share one black-box interface:

    placement = strategy.propose(round_idx)   # client ids per slot
    strategy.observe(placement, tpd)          # measured round delay

Each strategy registers itself (``repro_torch.core.registry``) under a
canonical name + aliases, together with a typed config dataclass; build
instances with ``create_strategy``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, fill_placement_holes
from repro_torch.core.pso import FlagSwapPSO
from repro_torch.core.registry import register_strategy


def repair_placement(placement, update: TopologyUpdate,
                     rng: np.random.Generator) -> np.ndarray:
    """Carry one concrete placement across a :class:`TopologyUpdate`.

    Surviving slots keep their (id-remapped) hosts; slots whose host
    departed — e.g. a ``ClientLeave`` removing a current aggregator —
    and brand-new slots are repaired with rng-drawn ids not already
    placed, so the result always satisfies ``validate_placement`` on the
    new hierarchy. The shared repair primitive for every placement-
    holding strategy's ``migrate`` hook.
    """
    old = np.asarray(placement, np.int64)
    sr = update.slot_remap
    carried = np.where(sr >= 0, old[np.where(sr >= 0, sr, 0)], -1)
    cr = update.client_remap
    if cr is not None:
        carried = np.where(carried >= 0,
                           cr[np.clip(carried, 0, len(cr) - 1)], -1)
    return fill_placement_holes(
        carried, update.new_hierarchy.total_clients, rng)


# ---------------------------------------------------------------------------
# typed per-strategy configs (the registry validates overrides against
# these fields, so a typo'd or misplaced kwarg fails loudly)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RandomConfig:
    pass


@dataclass(frozen=True)
class UniformConfig:
    pass


@dataclass(frozen=True)
class StaticConfig:
    placement: Tuple[int, ...]


@dataclass(frozen=True)
class PSOConfig:
    n_particles: int = 10
    inertia: float = 0.01
    c1: float = 0.01
    c2: float = 1.0
    velocity_factor: float = 0.1
    exploit_after_convergence: bool = True
    exploit_when_stagnant: bool = True
    # off for scale scenarios: don't accumulate (P,) arrays per iteration
    record_per_particle: bool = True


@dataclass(frozen=True)
class AdaptivePSOConfig(PSOConfig):
    drift_factor: float = 1.3
    probe_every: int = 5
    probe_patience: int = 2


@dataclass(frozen=True)
class GAConfig:
    population: int = 10
    tournament: int = 3
    mutate_p: float = 0.15


@dataclass(frozen=True)
class SAConfig:
    t0: float = 1.0
    cooling: float = 0.97


@dataclass(frozen=True)
class CEMConfig:
    batch: int = 10
    elite_frac: float = 0.3
    smoothing: float = 0.7


@dataclass(frozen=True)
class GreedyConfig:
    pass


@dataclass(frozen=True)
class ExhaustiveConfig:
    limit: int = 2_000_000


class PlacementStrategy:
    name = "base"

    def __init__(self, hierarchy: Hierarchy, seed: int = 0):
        self.hierarchy = hierarchy
        self.rng = np.random.default_rng(seed)

    def propose(self, round_idx: int) -> np.ndarray:
        raise NotImplementedError

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        pass

    # -- elastic topology --------------------------------------------------
    def migrate(self, update: TopologyUpdate) -> None:
        """Adopt a new topology mid-run (elastic scenarios).

        The base hook just swaps the hierarchy — enough for strategies
        that re-derive everything from it each round (random, uniform).
        Strategies holding placement-shaped or client-id-indexed state
        override this and carry it through ``update``'s remap tables.
        """
        self.hierarchy = update.new_hierarchy

    # -- checkpointing -----------------------------------------------------
    def save_state(self) -> dict:
        """JSON-able snapshot for sweep resume; subclasses extend.

        The (possibly migrated) hierarchy is part of the state: an
        elastic run's checkpoint restores a strategy consistent with
        the topology it was captured on, not the scenario's
        construction-time tree.
        """
        h = self.hierarchy
        return {"strategy": self.name,
                "rng": self.rng.bit_generator.state,
                "hierarchy": {"depth": h.depth, "width": h.width,
                              "trainers_per_leaf": h.trainers_per_leaf,
                              "n_clients": h.n_clients}}

    def load_state(self, state: dict) -> None:
        if state.get("strategy") != self.name:
            raise ValueError(
                f"checkpoint is for strategy {state.get('strategy')!r}, "
                f"cannot load into {self.name!r}")
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = state["rng"]
        self.hierarchy = Hierarchy(**state["hierarchy"])


@register_strategy("random", config=RandomConfig,
                   description="fresh random arrangement every round")
class RandomPlacement(PlacementStrategy):
    """Paper baseline: a fresh random arrangement every round."""
    name = "random"

    def propose(self, round_idx: int) -> np.ndarray:
        return self.rng.permutation(
            self.hierarchy.total_clients)[: self.hierarchy.dimensions]


@register_strategy("uniform", config=UniformConfig,
                   aliases=("round-robin",),
                   description="deterministic round-robin rotation")
class UniformRoundRobinPlacement(PlacementStrategy):
    """Paper baseline: deterministic rotation — every client takes its
    turn hosting aggregation slots (uniform load spreading)."""
    name = "uniform"

    def propose(self, round_idx: int) -> np.ndarray:
        n = self.hierarchy.total_clients
        d = self.hierarchy.dimensions
        start = (round_idx * d) % n
        return np.asarray([(start + i) % n for i in range(d)], np.int64)


@register_strategy("static", config=StaticConfig, aliases=("fixed",),
                   description="fixed placement, never changes")
class StaticPlacement(PlacementStrategy):
    """Fixed placement (e.g. the flat/CFL-equivalent root choice)."""
    name = "static"

    def __init__(self, hierarchy: Hierarchy, placement: Sequence[int],
                 seed: int = 0):
        super().__init__(hierarchy, seed)
        self._placement = np.asarray(placement, np.int64)
        hierarchy.validate_placement(self._placement)

    def propose(self, round_idx: int) -> np.ndarray:
        return self._placement

    def migrate(self, update: TopologyUpdate) -> None:
        super().migrate(update)
        self._placement = repair_placement(self._placement, update,
                                           self.rng)
        self.hierarchy.validate_placement(self._placement)

    def save_state(self) -> dict:
        state = super().save_state()
        state["placement"] = self._placement.tolist()
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self._placement = np.asarray(state["placement"], np.int64)


@register_strategy("pso", config=PSOConfig, aliases=("flag-swap",),
                   description="Flag-Swap PSO, one particle per round")
class PSOPlacement(PlacementStrategy):
    """Flag-Swap: one particle tested per FL round (paper Sec. III)."""
    name = "pso"

    def __init__(self, hierarchy: Hierarchy, n_particles: int = 10,
                 inertia: float = 0.01, c1: float = 0.01, c2: float = 1.0,
                 velocity_factor: float = 0.1, seed: int = 0,
                 exploit_after_convergence: bool = True,
                 exploit_when_stagnant: bool = True,
                 record_per_particle: bool = True):
        super().__init__(hierarchy, seed)
        self.pso = FlagSwapPSO(
            n_slots=hierarchy.dimensions,
            n_clients=hierarchy.total_clients,
            n_particles=n_particles, inertia=inertia, c1=c1, c2=c2,
            velocity_factor=velocity_factor, seed=seed,
            record_per_particle=record_per_particle)
        self.exploit_after_convergence = exploit_after_convergence
        # once a FULL sweep passes without improving gbest, alternate
        # exploit/test rounds: the system banks the found placement's
        # savings while the swarm keeps refining on the off-rounds
        self.exploit_when_stagnant = exploit_when_stagnant
        self._gbest_eval = 0   # evaluations counter at last gbest improve
        self._pending = False

    def _stagnant(self) -> bool:
        return (self.pso.evaluations - self._gbest_eval
                >= self.pso.n_particles)

    def propose(self, round_idx: int) -> np.ndarray:
        have_best = self.pso.gbest_f > -np.inf
        if have_best and self.exploit_after_convergence and \
                self.pso.converged:
            self._pending = False
            return self.pso.best_placement
        if have_best and self.exploit_when_stagnant and self._stagnant() \
                and round_idx % 2 == 0:
            self._pending = False
            return self.pso.best_placement
        self._pending = True
        return self.pso.ask()

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        if self._pending:
            before = self.pso.gbest_f
            self.pso.tell(-float(tpd))
            if self.pso.gbest_f > before:
                self._gbest_eval = self.pso.evaluations
            self._pending = False

    def migrate(self, update: TopologyUpdate) -> None:
        """Carry the swarm across the resize (warm restart): surviving
        per-slot pbest/position state is remapped, only new slots and
        departed-client entries are re-seeded — see
        :meth:`FlagSwapPSO.migrate`."""
        super().migrate(update)
        self.pso.migrate(update.new_n_clients, update.slot_remap,
                         update.client_remap)
        # fitness memory was dropped: restart the stagnation clock
        self._gbest_eval = self.pso.evaluations
        self._pending = False

    def save_state(self) -> dict:
        state = super().save_state()
        state["pso"] = self.pso.state_dict()
        state["gbest_eval"] = self._gbest_eval
        state["pending"] = self._pending
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.pso.load_state(state["pso"])
        self._gbest_eval = int(state["gbest_eval"])
        self._pending = bool(state["pending"])


@register_strategy("pso-adaptive", config=AdaptivePSOConfig,
                   aliases=("adaptive",),
                   description="Flag-Swap + drift probes + re-ignition")
class AdaptivePSOPlacement(PSOPlacement):
    """Flag-Swap + drift detection (the paper's Sec. VI future work).

    After convergence the base strategy freezes on gbest and stops
    learning — if the system drifts (a host slows down, a container gets
    throttled), the frozen placement silently degrades. This variant
    keeps watching the measured TPD of the *exploitation* rounds: when
    the trailing mean exceeds ``drift_factor`` x the TPD the swarm
    converged at, it re-ignites the swarm (fresh particles, stale
    fitness memory dropped) and re-optimizes — still 100% black-box.
    """
    name = "pso-adaptive"

    def __init__(self, hierarchy: Hierarchy, drift_factor: float = 1.3,
                 probe_every: int = 5, probe_patience: int = 2, **kw):
        super().__init__(hierarchy, **kw)
        self.drift_factor = drift_factor
        self.probe_every = probe_every
        self.probe_patience = probe_patience
        self._probing = False
        self._bad_probes = 0
        self.reignitions = 0

    def propose(self, round_idx: int) -> np.ndarray:
        # every ``probe_every`` rounds, run the best-known placement and
        # compare its MEASURED delay against the fitness the swarm
        # remembers for it. Zero regret while the system is stationary
        # (it is the best placement anyway); a cheap drift thermometer
        # when it is not. Still 100% black-box.
        if round_idx % self.probe_every == self.probe_every - 1 \
                and np.isfinite(self.pso.gbest_f):
            self._probing = True
            self._pending = False
            return self.pso.best_placement
        self._probing = False
        return super().propose(round_idx)

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        if not self._probing:
            super().observe(placement, tpd)
            return
        expected = -self.pso.gbest_f
        if tpd > self.drift_factor * expected:
            self._bad_probes += 1
            if self._bad_probes >= self.probe_patience:
                self.pso.reignite(keep_best=True)
                self.reignitions += 1
                self._bad_probes = 0
        else:
            self._bad_probes = 0
        self._probing = False

    def migrate(self, update: TopologyUpdate) -> None:
        super().migrate(update)
        # the drift thermometer reads exploitation rounds against the
        # remembered gbest fitness — both just got invalidated
        self._probing = False
        self._bad_probes = 0

    def save_state(self) -> dict:
        state = super().save_state()
        state["probing"] = self._probing
        state["bad_probes"] = self._bad_probes
        state["reignitions"] = self.reignitions
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self._probing = bool(state["probing"])
        self._bad_probes = int(state["bad_probes"])
        self.reignitions = int(state["reignitions"])


@register_strategy("ga", config=GAConfig, aliases=("genetic",),
                   description="genetic-algorithm baseline")
class GAPlacement(PlacementStrategy):
    """Genetic-algorithm baseline (beyond paper; the paper cites GA's
    premature convergence as the reason to prefer PSO — this lets the
    benchmarks show it)."""
    name = "ga"

    def __init__(self, hierarchy: Hierarchy, population: int = 10,
                 tournament: int = 3, mutate_p: float = 0.15, seed: int = 0):
        super().__init__(hierarchy, seed)
        n, d = hierarchy.total_clients, hierarchy.dimensions
        self.pop = [self.rng.permutation(n)[:d] for _ in range(population)]
        self.fit = [-np.inf] * population
        self.tournament = tournament
        self.mutate_p = mutate_p
        self._cursor = 0

    def _dedup(self, child: np.ndarray) -> np.ndarray:
        n = self.hierarchy.total_clients
        seen = set()
        for i in range(len(child)):
            c = int(child[i]) % n
            while c in seen:
                c = (c + 1) % n
            child[i] = c
            seen.add(c)
        return child

    def propose(self, round_idx: int) -> np.ndarray:
        return np.asarray(self.pop[self._cursor], np.int64)

    def migrate(self, update: TopologyUpdate) -> None:
        super().migrate(update)
        # every member is repaired in place; measured fitness belongs to
        # the old topology, so the generation restarts from scratch
        self.pop = [repair_placement(p, update, self.rng)
                    for p in self.pop]
        self.fit = [-np.inf] * len(self.pop)
        self._cursor = 0

    def save_state(self) -> dict:
        state = super().save_state()
        state["pop"] = [p.tolist() for p in self.pop]
        state["fit"] = [float(f) for f in self.fit]
        state["cursor"] = self._cursor
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.pop = [np.asarray(p, np.int64) for p in state["pop"]]
        self.fit = [float(f) for f in state["fit"]]
        self._cursor = int(state["cursor"])

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        i = self._cursor
        self.fit[i] = -float(tpd)
        self._cursor = (self._cursor + 1) % len(self.pop)
        if self._cursor == 0:  # full generation evaluated -> evolve
            self._evolve()

    def _evolve(self) -> None:
        pop, fit = self.pop, np.asarray(self.fit)
        order = np.argsort(-fit)
        elite = [pop[order[0]].copy()]
        new = elite
        while len(new) < len(pop):
            def pick():
                idx = self.rng.choice(len(pop), self.tournament, replace=False)
                return pop[idx[np.argmax(fit[idx])]]
            a, b = pick(), pick()
            mask = self.rng.random(len(a)) < 0.5
            child = np.where(mask, a, b)
            mut = self.rng.random(len(child)) < self.mutate_p
            child[mut] = self.rng.integers(
                0, self.hierarchy.total_clients, mut.sum())
            new.append(self._dedup(child))
        self.pop = new
        self.fit = [-np.inf] * len(new)


@register_strategy("greedy", config=GreedyConfig, aliases=("speed-sorted",),
                   needs_clients=True,
                   description="telemetry-cheating speed-sorted baseline")
class GreedySpeedPlacement(PlacementStrategy):
    """Non-black-box upper baseline: sort clients by pspeed and fill slots
    top-down (fastest client at the root). Requires telemetry the paper's
    threat model forbids — included to quantify the gap PSO closes."""
    name = "greedy"

    def __init__(self, hierarchy: Hierarchy, clients: ClientPool,
                 seed: int = 0):
        super().__init__(hierarchy, seed)
        self._clients = clients
        self._recompute()

    def _recompute(self) -> None:
        order = np.argsort(-self._clients.pspeed)
        self._placement = order[: self.hierarchy.dimensions].astype(np.int64)

    def propose(self, round_idx: int) -> np.ndarray:
        return self._placement

    def migrate(self, update: TopologyUpdate) -> None:
        # it cheats with telemetry anyway: just re-sort the (live) pool
        super().migrate(update)
        self._recompute()

    def save_state(self) -> dict:
        state = super().save_state()
        state["placement"] = self._placement.tolist()
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self._placement = np.asarray(state["placement"], np.int64)


@register_strategy("exhaustive", config=ExhaustiveConfig,
                   aliases=("oracle",), needs_cost_model=True,
                   description="brute-force optimum (tiny scenarios only)")
class ExhaustivePlacement(PlacementStrategy):
    """Brute-force oracle over all permutations (tiny scenarios only)."""
    name = "exhaustive"

    def __init__(self, hierarchy: Hierarchy, cost_model, seed: int = 0,
                 limit: int = 2_000_000):
        super().__init__(hierarchy, seed)
        self._cost_model = cost_model
        self._limit = limit
        self._solve()

    def _solve(self) -> None:
        n, d = self.hierarchy.total_clients, self.hierarchy.dimensions
        count = 1
        for i in range(d):
            count *= (n - i)
        if count > self._limit:
            raise ValueError(f"{count} permutations exceed limit "
                             f"{self._limit}")
        best, best_tpd = None, np.inf
        for perm in itertools.permutations(range(n), d):
            t = self._cost_model.tpd(np.asarray(perm))
            if t < best_tpd:
                best, best_tpd = np.asarray(perm, np.int64), t
        self._placement = best
        self.optimal_tpd = float(best_tpd)

    def propose(self, round_idx: int) -> np.ndarray:
        return self._placement

    def migrate(self, update: TopologyUpdate) -> None:
        # the environment retargets the cost model in place before the
        # migrate hooks fire, so re-solving prices the NEW topology
        super().migrate(update)
        self._solve()

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        # the oracle is deterministic given (hierarchy, cost model): if
        # the restored hierarchy disagrees with the placement solved at
        # construction, re-solve against the caller's cost model
        if len(self._placement) != self.hierarchy.dimensions:
            self._solve()


@register_strategy("sa", config=SAConfig, aliases=("annealing",),
                   description="simulated-annealing baseline")
class SimulatedAnnealingPlacement(PlacementStrategy):
    """Simulated-annealing baseline (beyond paper; SA is among the
    black-box families the paper's related work compares against).

    One candidate per round: swap/replace moves on the incumbent
    placement, accepted with the Metropolis rule under a geometric
    cooling schedule. Pure black-box.
    """
    name = "sa"

    def __init__(self, hierarchy: Hierarchy, t0: float = 1.0,
                 cooling: float = 0.97, seed: int = 0):
        super().__init__(hierarchy, seed)
        n, d = hierarchy.total_clients, hierarchy.dimensions
        self.current = self.rng.permutation(n)[:d]
        self.current_f: Optional[float] = None
        self.best = self.current.copy()
        self.best_f = -np.inf
        self.temp = t0
        self.cooling = cooling
        self._candidate: Optional[np.ndarray] = None

    def _neighbor(self, p: np.ndarray) -> np.ndarray:
        q = p.copy()
        n, d = self.hierarchy.total_clients, self.hierarchy.dimensions
        if d >= 2 and self.rng.random() < 0.5:
            i, j = self.rng.choice(d, 2, replace=False)
            q[i], q[j] = q[j], q[i]            # swap two slots
        else:
            i = self.rng.integers(d)
            outside = np.setdiff1d(np.arange(n), q)
            q[i] = self.rng.choice(outside)    # bring in a new client
        return q

    def propose(self, round_idx: int) -> np.ndarray:
        if self.current_f is None:
            self._candidate = self.current
        else:
            self._candidate = self._neighbor(self.current)
        return np.asarray(self._candidate, np.int64)

    def migrate(self, update: TopologyUpdate) -> None:
        super().migrate(update)
        self.current = repair_placement(self.current, update, self.rng)
        self.best = repair_placement(self.best, update, self.rng)
        # measured energies belong to the old topology: re-measure the
        # incumbent next round before generating neighbors
        self.current_f = None
        self.best_f = -np.inf
        self._candidate = None

    def save_state(self) -> dict:
        state = super().save_state()
        state.update(
            current=self.current.tolist(), current_f=self.current_f,
            best=self.best.tolist(), best_f=float(self.best_f),
            temp=float(self.temp))
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.current = np.asarray(state["current"], np.int64)
        self.current_f = None if state["current_f"] is None \
            else float(state["current_f"])
        self.best = np.asarray(state["best"], np.int64)
        self.best_f = float(state["best_f"])
        self.temp = float(state["temp"])
        self._candidate = None

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        f = -float(tpd)
        if f > self.best_f:
            self.best_f, self.best = f, placement.copy()
        if self.current_f is None:
            self.current_f = f
            return
        accept = f >= self.current_f or \
            self.rng.random() < np.exp((f - self.current_f) /
                                       max(self.temp, 1e-9))
        if accept:
            self.current, self.current_f = placement.copy(), f
        self.temp *= self.cooling


@register_strategy("cem", config=CEMConfig, aliases=("cross-entropy",),
                   description="cross-entropy-method baseline")
class CEMPlacement(PlacementStrategy):
    """Cross-entropy-method baseline: maintains per-slot categorical
    distributions over client ids, samples placements, refits on the
    elite fraction. A strong derivative-free baseline for categorical
    placement problems; black-box like the rest."""
    name = "cem"

    def __init__(self, hierarchy: Hierarchy, batch: int = 10,
                 elite_frac: float = 0.3, smoothing: float = 0.7,
                 seed: int = 0):
        super().__init__(hierarchy, seed)
        n, d = hierarchy.total_clients, hierarchy.dimensions
        self.probs = np.full((d, n), 1.0 / n)
        self.batch = batch
        self.elite = max(1, int(round(batch * elite_frac)))
        self.smoothing = smoothing
        self._wave: List[tuple] = []
        self.best = np.arange(d)
        self.best_f = -np.inf

    def _sample(self) -> np.ndarray:
        d, n = self.probs.shape
        out = np.empty(d, np.int64)
        taken: set = set()
        for s in range(d):
            p = self.probs[s].copy()
            for c in taken:
                p[c] = 0.0
            p = p / p.sum()
            out[s] = self.rng.choice(n, p=p)
            taken.add(int(out[s]))
        return out

    def propose(self, round_idx: int) -> np.ndarray:
        return self._sample()

    def migrate(self, update: TopologyUpdate) -> None:
        super().migrate(update)
        d, n = self.hierarchy.dimensions, self.hierarchy.total_clients
        old = self.probs
        fresh = np.full((d, n), 1.0 / n)
        cr = update.client_remap
        for s in range(d):
            o = int(update.slot_remap[s])
            if o < 0:
                continue  # brand-new slot: uniform
            row = old[o]
            if cr is None:
                kept = row.copy()
                newcomer = np.zeros(n, bool)
            else:
                alive = cr >= 0
                kept = np.zeros(n)
                kept[cr[alive]] = row[alive]
                newcomer = np.ones(n, bool)
                newcomer[cr[alive]] = False
            # joined clients start at a REAL uniform share (not the
            # near-zero leftover of departed mass — the multiplicative
            # refit could never recover them from ~0), survivors keep
            # their relative mass; renormalize to a distribution
            kept[newcomer] = 1.0 / n
            total = kept.sum()
            fresh[s] = kept / total if total > 0 else fresh[s]
        self.probs = fresh
        self.best = repair_placement(self.best, update, self.rng)
        self.best_f = -np.inf
        self._wave.clear()

    def save_state(self) -> dict:
        state = super().save_state()
        state.update(
            probs=self.probs.tolist(),
            wave=[[float(f), p.tolist()] for f, p in self._wave],
            best=self.best.tolist(), best_f=float(self.best_f))
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.probs = np.asarray(state["probs"], np.float64)
        self._wave = [(float(f), np.asarray(p, np.int64))
                      for f, p in state["wave"]]
        self.best = np.asarray(state["best"], np.int64)
        self.best_f = float(state["best_f"])

    def observe(self, placement: np.ndarray, tpd: float) -> None:
        f = -float(tpd)
        if f > self.best_f:
            self.best_f, self.best = f, placement.copy()
        self._wave.append((f, placement.copy()))
        if len(self._wave) >= self.batch:
            self._wave.sort(key=lambda t: -t[0])
            elite = [p for _, p in self._wave[: self.elite]]
            d, n = self.probs.shape
            counts = np.zeros((d, n))
            for p in elite:
                counts[np.arange(d), p] += 1.0
            fresh = counts / counts.sum(axis=1, keepdims=True)
            self.probs = (self.smoothing * self.probs
                          + (1 - self.smoothing) * fresh)
            self._wave.clear()
