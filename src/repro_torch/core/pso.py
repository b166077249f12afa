"""Flag-Swap: integer-domain Particle Swarm Optimization for aggregation
placement (paper Sec. III).

The port's copy of ``repro.core.pso``. The swarm stays in numpy on the
host, as in the reference, so the PCG64 stream gives bit-identical
trajectories; only the fitness callable reaches the device.

Faithful to the paper's formulation:

* particle position = vector of ``dimensions`` client ids (one per
  aggregator slot);
* velocity update (eq. 2):
      v <- w*v + c1*r1*(pbest - x) + c2*r2*(gbest - x)
  with defaults w=0.01, c1=0.01, c2=1 (Sec. IV-B);
* velocity clamped to [-Vmax, Vmax], Vmax = max(1, D*velocity_factor)
  (eq. 3, velocity_factor=0.1);
* position update (eq. 4): x <- (x + v) mod client_count, duplicates
  resolved by incrementing until a unique client id is found;
* fitness f = -TPD (eq. 1), pbest/gbest updated on improvement.

The optimizer is strictly **black-box**: it sees only (placement ->
fitness) pairs. Two driving modes:

* ``run(fitness_fn, iterations)`` — the simulation loop (Fig. 3): every
  particle is evaluated each iteration; per-iteration swarm statistics
  are recorded for the convergence plots. The loop is whole-swarm
  vectorized — one (P, 2, D) random draw, one (P, D) velocity/position
  update, one first-argmax gbest resolution per iteration — and
  bit-identical to the per-particle reference loop, which is kept as
  ``_run_reference`` (the parity oracle the tests pin against).
* ``ask()`` / ``tell()`` — the deployment loop (Fig. 4): each FL round
  tests ONE particle's placement against the *measured* round delay,
  cycling through the swarm (this is how SDFLMQ integrates it — one
  arrangement per round, no client telemetry).

Deduped placements are cached per particle and invalidated only for
particles whose position actually moved, so the per-round ``converged``
check in deployment mode stops re-deduplicating the whole swarm.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np

from repro_torch.core.hierarchy import fill_placement_holes, rows_with_duplicates


@dataclass
class SwarmHistory:
    """Per-iteration fitness statistics (for Fig. 3-style plots).

    ``record_per_particle=False`` drops the (P,)-per-iteration arrays
    (the scalar best/worst/mean series stay) so 10k-iteration scale
    sweeps don't accumulate unbounded per-iteration state.
    """
    per_particle: List[np.ndarray] = field(default_factory=list)  # (P,) TPD
    best: List[float] = field(default_factory=list)
    worst: List[float] = field(default_factory=list)
    mean: List[float] = field(default_factory=list)
    record_per_particle: bool = True

    def record(self, tpds: np.ndarray) -> None:
        if self.record_per_particle:
            self.per_particle.append(tpds.copy())
        self.best.append(float(tpds.min()))
        self.worst.append(float(tpds.max()))
        self.mean.append(float(tpds.mean()))

    def as_dict(self) -> dict:
        return {
            # np.stack([]) raises, so guard the no-record case
            "per_particle": (np.stack(self.per_particle).tolist()
                             if self.per_particle else []),
            "best": self.best, "worst": self.worst, "mean": self.mean,
        }

    @classmethod
    def from_dict(cls, d: dict,
                  record_per_particle: bool = True) -> "SwarmHistory":
        """Inverse of :meth:`as_dict` (checkpoint restore). Iteration
        lengths may differ per entry after a topology change, so rows
        are restored individually, not via one stack."""
        return cls(
            per_particle=[np.asarray(row, np.float64)
                          for row in d.get("per_particle", [])],
            best=[float(x) for x in d.get("best", [])],
            worst=[float(x) for x in d.get("worst", [])],
            mean=[float(x) for x in d.get("mean", [])],
            record_per_particle=record_per_particle)


class FlagSwapPSO:
    """Integer PSO over aggregator placements."""

    def __init__(self, n_slots: int, n_clients: int, n_particles: int = 10,
                 inertia: float = 0.01, c1: float = 0.01, c2: float = 1.0,
                 velocity_factor: float = 0.1, seed: int = 0,
                 record_per_particle: bool = True):
        if n_clients < n_slots:
            raise ValueError("need at least as many clients as slots")
        self.n_slots = n_slots
        self.n_clients = n_clients
        self.n_particles = n_particles
        self.inertia = inertia
        self.c1 = c1
        self.c2 = c2
        self.velocity_factor = velocity_factor
        # eq. 3: Vmax = max(1, D * velocity_factor)
        self.v_max = max(1.0, n_slots * velocity_factor)
        self.rng = np.random.default_rng(seed)

        # init (Sec. III-C): random permutations, zero velocities
        self.x = np.stack([
            self.rng.permutation(n_clients)[:n_slots]
            for _ in range(n_particles)
        ]).astype(np.float64)
        self.v = np.zeros_like(self.x)
        self.pbest_x = self.x.copy()
        self.pbest_f = np.full(n_particles, -np.inf)
        self.gbest_x = self.x[0].copy()
        self.gbest_f = -np.inf
        self.history = SwarmHistory(record_per_particle=record_per_particle)
        self._cursor = 0  # ask/tell round-robin particle index
        self.evaluations = 0
        self.migrations = 0  # topology migrations survived (diagnostics)
        # deduped-placement cache: "all" = every row stale, else the set
        # of particle rows whose position moved since the last read
        self._pl_cache: Optional[np.ndarray] = None
        self._pl_dirty: Union[str, set] = "all"
        self._dedup_memo: dict = {}
        # best_placement cache: gbest only changes on strict improvement
        self._gbest_version = 0
        self._gbest_pl: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _dedup(self, pos: np.ndarray) -> np.ndarray:
        """Paper: 'Duplicates are resolved by incrementing until a unique
        client ID is found.' (reference single-particle rule)

        Two exact fast paths around the sequential loop: a sort detects
        the no-collision case (the increment rule is the identity), and
        collision-heavy rows are memoized on their floored ids — a
        converged swarm re-deduplicates the SAME near-stationary row
        every round, which otherwise dominates deployment-mode proposes.
        """
        pos = np.floor(pos).astype(np.int64) % self.n_clients
        if not rows_with_duplicates(pos[None])[0]:
            return pos
        key = pos.tobytes()
        hit = self._dedup_memo.get(key)
        if hit is not None:
            return hit.copy()
        out = self._dedup_ints(pos)
        if len(self._dedup_memo) >= 256:
            self._dedup_memo.clear()
        self._dedup_memo[key] = out.copy()
        return out

    def _dedup_ints(self, pos: np.ndarray) -> np.ndarray:
        """The increment rule, literally: the sequential reference the
        array fixer below is parity-pinned against."""
        vals = pos.tolist()
        seen = set()
        n = self.n_clients
        for i, c in enumerate(vals):
            while c in seen:
                c = (c + 1) % n
            vals[i] = c
            seen.add(c)
        pos[:] = vals
        return pos

    def _dedup_fix(self, pos: np.ndarray) -> np.ndarray:
        """Array-based increment rule over (R, D) rows, in place.

        Each pass bumps every non-first duplicate by one (mod C), with
        first-ness decided by a STABLE sort — i.e. at every probe step
        the lowest slot claims the contested id, which is exactly the
        order the sequential loop resolves collisions in, so the
        fixpoint is bit-identical to ``_dedup_ints`` per row (pinned
        exhaustively by tests).

        Measured note: pass count equals the longest probe chain, so on
        near-converged swarms (many copies of one id) this degrades to
        one argsort per duplicate and loses to the plain loop by 3-16x —
        the hot paths therefore use sort-detection + memoization around
        ``_dedup_ints`` and keep this as the whole-row batch formulation
        (and the parity oracle for it).
        """
        C = self.n_clients
        while True:
            order = np.argsort(pos, axis=1, kind="stable")
            sv = np.take_along_axis(pos, order, axis=1)
            dup = sv[:, 1:] == sv[:, :-1]
            if not dup.any():
                return pos
            rows, k = np.nonzero(dup)
            bump = order[rows, k + 1]
            pos[rows, bump] = (pos[rows, bump] + 1) % C

    def _dedup_batch(self, pos: np.ndarray) -> np.ndarray:
        """(P, D) positions -> (P, D) deduped placements, bit-identical
        to applying ``_dedup`` row by row (parity-pinned). Array fast
        path: a sort detects the rows that are already duplicate-free
        (the common case) and passes them through untouched; only
        colliding rows run the sequential increment rule."""
        pos = np.floor(pos).astype(np.int64) % self.n_clients
        for i in np.nonzero(rows_with_duplicates(pos))[0]:
            self._dedup_ints(pos[i])
        return pos

    def placements(self) -> np.ndarray:
        """All particles' current placements, (P, D) — a fresh copy of
        the internal cache (safe to hold or mutate)."""
        return self._placements_buf().copy()

    def _placements_buf(self) -> np.ndarray:
        """The LIVE dedup cache; only rows whose position moved since
        the last call are re-deduplicated. Internal read-only use — the
        buffer is rewritten in place by later calls."""
        if self._pl_cache is None or self._pl_dirty == "all":
            self._pl_cache = self._dedup_batch(self.x)
        elif self._pl_dirty:
            for i in self._pl_dirty:
                self._pl_cache[i] = self._dedup(self.x[i])
        self._pl_dirty = set()
        return self._pl_cache

    def placement(self, i: int) -> np.ndarray:
        return self._dedup(self.x[i])

    def _mark_moved(self, i: Optional[int] = None) -> None:
        if i is None or self._pl_dirty == "all":
            self._pl_dirty = "all"
        else:
            self._pl_dirty.add(i)

    # ------------------------------------------------------------------
    # reference per-particle updates (deployment mode + parity oracle)
    # ------------------------------------------------------------------
    def _step_particle(self, i: int) -> None:
        """Velocity (eq. 2, clamped eq. 3) + position (eq. 4) update."""
        # one (2, D) draw == the historical r1-then-r2 pair (same stream)
        r1, r2 = self.rng.random((2, self.n_slots))
        self.v[i] = (self.inertia * self.v[i]
                     + self.c1 * r1 * (self.pbest_x[i] - self.x[i])
                     + self.c2 * r2 * (self.gbest_x - self.x[i]))
        self.v[i] = np.clip(self.v[i], -self.v_max, self.v_max)
        # positions stay continuous (eq. 4 mod wrap); they are floored to
        # client ids only at evaluation time (_dedup) so sub-integer
        # velocity accumulates instead of being truncated away.
        self.x[i] = (self.x[i] + self.v[i]) % self.n_clients
        self._mark_moved(i)

    def _update_bests(self, i: int, f: float) -> None:
        if f > self.pbest_f[i]:
            self.pbest_f[i] = f
            self.pbest_x[i] = self.x[i].copy()
        if f > self.gbest_f:
            self.gbest_f = f
            self.gbest_x = self.x[i].copy()
            self._gbest_version += 1

    # ------------------------------------------------------------------
    # whole-swarm vectorized updates (simulation mode)
    # ------------------------------------------------------------------
    def _step_swarm(self) -> None:
        """All particles' eq. 2-4 updates in three (P, D) array ops.

        One (P, 2, D) draw consumes the generator stream in exactly the
        order P sequential ``_step_particle`` calls would (numpy fills
        C-order: particle 0's r1 then r2, then particle 1's, ...), and
        every arithmetic op is elementwise — so this is bit-identical to
        the reference loop, not merely close.
        """
        r = self.rng.random((self.n_particles, 2, self.n_slots))
        self.v = (self.inertia * self.v
                  + self.c1 * r[:, 0] * (self.pbest_x - self.x)
                  + self.c2 * r[:, 1] * (self.gbest_x[None] - self.x))
        np.clip(self.v, -self.v_max, self.v_max, out=self.v)
        self.x = (self.x + self.v) % self.n_clients
        self._mark_moved()

    def _update_bests_swarm(self, fs: np.ndarray) -> None:
        """Vectorized pbest/gbest update, sequential-equivalent: the
        reference ascending-i loop leaves gbest at the FIRST particle
        attaining the iteration maximum (strict improvement only), which
        is exactly ``argmax``."""
        improved = fs > self.pbest_f
        self.pbest_f = np.where(improved, fs, self.pbest_f)
        self.pbest_x = np.where(improved[:, None], self.x, self.pbest_x)
        i = int(np.argmax(fs))
        if fs[i] > self.gbest_f:
            self.gbest_f = float(fs[i])
            self.gbest_x = self.x[i].copy()
            self._gbest_version += 1

    # ------------------------------------------------------------------
    # deployment mode: one particle per FL round
    # ------------------------------------------------------------------
    def ask(self) -> np.ndarray:
        """Placement to test this FL round (current particle, deduped)."""
        return self._placements_buf()[self._cursor].copy()

    def tell(self, fitness: float) -> None:
        """Report the measured fitness (= -TPD) for the last ask()."""
        i = self._cursor
        self._update_bests(i, float(fitness))
        self._step_particle(i)
        self._cursor = (self._cursor + 1) % self.n_particles
        self.evaluations += 1

    # ------------------------------------------------------------------
    # simulation mode: full swarm per iteration
    # ------------------------------------------------------------------
    def run(self, fitness_fn: Callable, iterations: int = 100,
            batch_fitness_fn: Optional[Callable] = None) -> np.ndarray:
        """Algorithm 1 main loop, whole-swarm vectorized. ``fitness_fn
        (placement) -> f`` or, when ``batch_fitness_fn`` is given,
        evaluate the whole swarm at once (``(P, slots) -> (P,)``).
        Returns the gbest placement. Bit-identical trajectories to
        ``_run_reference`` (parity-pinned)."""
        for _ in range(iterations):
            # a copy: fitness callables must not corrupt the dedup cache
            placements = self.placements()
            if batch_fitness_fn is not None:
                fs = np.asarray(batch_fitness_fn(placements), np.float64)
            else:
                fs = np.array([fitness_fn(p) for p in placements],
                              np.float64)
            self.evaluations += self.n_particles
            self.history.record(-fs)  # record TPD (positive)
            self._update_bests_swarm(fs)
            self._step_swarm()
        return self._dedup(self.gbest_x)

    def _run_reference(self, fitness_fn: Callable, iterations: int = 100,
                       batch_fitness_fn: Optional[Callable] = None
                       ) -> np.ndarray:
        """The seed-era per-particle loop, kept verbatim as the parity
        oracle ``run`` is pinned against (tests assert bit-identical
        positions, velocities, bests and history)."""
        for _ in range(iterations):
            placements = np.stack([self.placement(i)
                                   for i in range(self.n_particles)])
            if batch_fitness_fn is not None:
                fs = np.asarray(batch_fitness_fn(placements), np.float64)
            else:
                fs = np.array([fitness_fn(p) for p in placements],
                              np.float64)
            self.evaluations += self.n_particles
            self.history.record(-fs)  # record TPD (positive)
            for i in range(self.n_particles):
                self._update_bests(i, fs[i])
            for i in range(self.n_particles):
                self._step_particle(i)
        return self._dedup(self.gbest_x)

    @property
    def best_placement(self) -> np.ndarray:
        if self._gbest_pl is None or \
                self._gbest_pl[0] != self._gbest_version:
            self._gbest_pl = (self._gbest_version,
                              self._dedup(self.gbest_x))
        return self._gbest_pl[1].copy()

    @property
    def converged(self) -> bool:
        """All particles currently propose the same placement."""
        ps = self._placements_buf()
        return bool(np.all(ps == ps[0]))

    # ------------------------------------------------------------------
    # adaptation to system drift (paper Sec. VI future work)
    # ------------------------------------------------------------------
    def reignite(self, keep_best: bool = True) -> None:
        """Restart exploration after a detected system change.

        The converged swarm is a point mass — useless once client speeds
        shift. Re-randomize every particle (fresh permutations, zero
        velocities) and FORGET the now-stale fitness memory; optionally
        seed particle 0 with the old gbest placement (it competes, but
        no longer anchors the velocity field with a stale fitness).
        """
        old_best = self.gbest_x.copy()
        self.x = np.stack([
            self.rng.permutation(self.n_clients)[: self.n_slots]
            for _ in range(self.n_particles)
        ]).astype(np.float64)
        if keep_best:
            self.x[0] = old_best
        self.v = np.zeros_like(self.x)
        self.pbest_x = self.x.copy()
        self.pbest_f = np.full(self.n_particles, -np.inf)
        self.gbest_x = self.x[0].copy()
        self.gbest_f = -np.inf
        self._cursor = 0
        self._gbest_version += 1
        self._mark_moved()

    # ------------------------------------------------------------------
    # elastic topology: carry swarm state across a (D, C) change
    # ------------------------------------------------------------------
    def migrate(self, new_n_clients: int, slot_remap,
                client_remap=None) -> None:
        """Resize the swarm to a new placement dimension / client count,
        carrying surviving per-slot state instead of cold-restarting.

        ``slot_remap`` is the (new_D,) new-slot -> old-slot table from
        :func:`repro_torch.core.hierarchy.slot_remap`; ``client_remap`` the
        (old_C,) old-id -> new-id table from a pool resize (``None`` =
        ids unchanged). The carried state is deterministic:

        * position/pbest entries of surviving slots keep their
          id-remapped client ids plus their sub-integer fraction (the
          accumulated eq. 4 momentum), so a same-shape migration with
          identity remaps is a true no-op on positions; entries
          referring to departed clients and entries of brand-new slots
          are re-seeded — one ``rng.permutation(new_C)`` draw per
          particle that has at least one hole, holes filled in
          ascending slot order with ids not already carried by that
          particle;
        * pbest holes copy the re-seeded position (a new slot's best
          known spot is where it starts, matching ``reignite``);
        * velocities of surviving slots are carried (re-clamped to the
          new ``Vmax``), new slots start at rest;
        * fitness memory (``pbest_f``/``gbest_f``) is dropped — those
          numbers were measured on a different topology/population;
          ``gbest_x`` keeps its carried coordinates (holes copy particle
          0's seeds) so the velocity field retains its pull direction
          until a fresh gbest is measured.
        """
        old_n, old_D = self.n_clients, self.n_slots
        slot_remap = np.asarray(slot_remap, np.int64)
        new_D = len(slot_remap)
        if new_n_clients < new_D:
            raise ValueError(f"need at least {new_D} clients for {new_D} "
                             f"slots, got {new_n_clients}")
        if client_remap is not None:
            client_remap = np.asarray(client_remap, np.int64)
            if len(client_remap) != old_n:
                raise ValueError(
                    f"client_remap covers {len(client_remap)} ids, swarm "
                    f"was over {old_n} clients")
        valid = slot_remap >= 0
        src = np.where(valid, slot_remap, 0)

        def carry(rows: np.ndarray):
            """(P, old_D) continuous positions -> carried new client ids
            (-1 where re-seeding is needed) + the sub-integer momentum
            fraction of each carried entry."""
            ids = np.floor(rows).astype(np.int64) % old_n
            frac = (rows - np.floor(rows))[:, src]
            moved = ids[:, src]
            if client_remap is not None:
                moved = client_remap[moved]
            return np.where(valid[None], moved, -1), frac

        def fill(row: np.ndarray) -> np.ndarray:
            return fill_placement_holes(row, new_n_clients, self.rng)

        carried_x, frac_x = carry(self.x)
        carried_p, frac_p = carry(self.pbest_x)
        carried_g, frac_g = carry(self.gbest_x[None])
        survived_x, survived_p = carried_x >= 0, carried_p >= 0
        new_x = np.stack([fill(carried_x[i])
                          for i in range(self.n_particles)])
        new_x = new_x + np.where(survived_x, frac_x, 0.0)
        # pbest holes copy the (already re-seeded) position
        new_p = np.where(survived_p, carried_p + frac_p, new_x)
        new_v = np.zeros((self.n_particles, new_D))
        self.v_max = max(1.0, new_D * self.velocity_factor)
        new_v[:, valid] = np.clip(self.v[:, src][:, valid],
                                  -self.v_max, self.v_max)

        self.n_slots = new_D
        self.n_clients = new_n_clients
        self.x = new_x.astype(np.float64)
        self.v = new_v
        self.pbest_x = new_p.astype(np.float64)
        self.pbest_f = np.full(self.n_particles, -np.inf)
        self.gbest_x = np.where(carried_g[0] >= 0,
                                carried_g[0] + frac_g[0],
                                new_x[0]).astype(np.float64)
        self.gbest_f = -np.inf
        self.migrations += 1
        self._gbest_version += 1
        self._gbest_pl = None
        self._dedup_memo.clear()
        self._pl_cache = None
        self._mark_moved()

    # ------------------------------------------------------------------
    # checkpointing (JSON-able; exact resume incl. the rng stream)
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Full swarm state, JSON-serializable: positions, velocities,
        pbest/gbest, the ask/tell cursor, the rng bit-generator state
        and the recorded :class:`SwarmHistory`."""
        return {
            "n_slots": self.n_slots, "n_clients": self.n_clients,
            "n_particles": self.n_particles,
            "inertia": self.inertia, "c1": self.c1, "c2": self.c2,
            "velocity_factor": self.velocity_factor,
            "x": self.x.tolist(), "v": self.v.tolist(),
            "pbest_x": self.pbest_x.tolist(),
            "pbest_f": self.pbest_f.tolist(),
            "gbest_x": self.gbest_x.tolist(),
            "gbest_f": float(self.gbest_f),
            "cursor": self._cursor,
            "evaluations": self.evaluations,
            "migrations": self.migrations,
            "rng": self.rng.bit_generator.state,
            "history": self.history.as_dict(),
            "record_per_particle": self.history.record_per_particle,
        }

    def load_state(self, d: dict) -> None:
        """Restore :meth:`state_dict` in place (inverse, exact: the rng
        stream continues bit-for-bit where the checkpoint left it)."""
        self.n_slots = int(d["n_slots"])
        self.n_clients = int(d["n_clients"])
        self.n_particles = int(d["n_particles"])
        self.inertia = float(d["inertia"])
        self.c1 = float(d["c1"])
        self.c2 = float(d["c2"])
        self.velocity_factor = float(d["velocity_factor"])
        self.v_max = max(1.0, self.n_slots * self.velocity_factor)
        self.x = np.asarray(d["x"], np.float64)
        self.v = np.asarray(d["v"], np.float64)
        self.pbest_x = np.asarray(d["pbest_x"], np.float64)
        self.pbest_f = np.asarray(d["pbest_f"], np.float64)
        self.gbest_x = np.asarray(d["gbest_x"], np.float64)
        self.gbest_f = float(d["gbest_f"])
        self._cursor = int(d["cursor"])
        self.evaluations = int(d["evaluations"])
        self.migrations = int(d.get("migrations", 0))
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = d["rng"]
        self.history = SwarmHistory.from_dict(
            d.get("history", {}),
            record_per_particle=bool(d.get("record_per_particle", True)))
        self._gbest_version += 1
        self._gbest_pl = None
        self._dedup_memo.clear()
        self._pl_cache = None
        self._mark_moved()
