"""The SDFL aggregation hierarchy (paper Sec. IV-A).

The port's copy of ``repro.core.hierarchy``: the same numpy logic, so
tables, placements and seeded pools match the reference bit for bit.

A regular tree of *aggregator slots*: depth ``D`` levels of aggregators,
width ``W`` children per aggregator, and ``trainers_per_leaf`` trainer
clients under each level-(D-1) aggregator. Slot count (paper eq. 5):

    dimensions = sum_{i=0}^{D-1} W^i

A **placement** is a vector of ``dimensions`` distinct client ids — which
client hosts which aggregator slot (the PSO particle). All remaining
clients are trainers, assigned round-robin to leaf aggregators (paper
Sec. III-C "Hierarchy Rearrangement").

Slots are BFS-indexed: slot 0 is the root, slot ``1 + (s-1)*W .. `` etc.;
``level(s)`` and ``parent(s)`` are closed-form.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np


def rows_with_duplicates(rows: np.ndarray) -> np.ndarray:
    """(R, D) int rows -> (R,) bool: which rows repeat a value.

    The shared duplicate-id detection the scale engine's fast paths key
    off (PSO dedup, batched-runner validation, the uniform-TPD
    fallback) — one sort + adjacent compare per row, no sets.
    """
    srt = np.sort(rows, axis=1)
    return (srt[:, 1:] == srt[:, :-1]).any(axis=1)


@dataclass(frozen=True)
class LevelPlan:
    """Flattened gather/segment tables for ONE aggregation level.

    The level's clusters are laid out back-to-back, each as
    ``[host, child_1, ..., child_k]``; ``seg`` maps every entry to its
    cluster. ``src`` indexes the level's value pool: client ids for the
    deepest level, and for internal levels either a client id (< C, the
    host's own update) or ``C + j`` (the j-th cluster value of the level
    below). ``member_clients`` is the client id *charged* for each entry
    (eq. 6 payloads: a child slot is carried by its host client), which
    is what deterministic timing and the cost model consume.
    """
    src: np.ndarray             # (M,) int32 indices into the level pool
    seg: np.ndarray             # (M,) int32 cluster index, sorted ascending
    member_clients: np.ndarray  # (M,) int32 client id charged per entry
    hosts: np.ndarray           # (G,) int32 host client id per cluster
    n_parts: np.ndarray         # (G,) int32 member count per cluster
    n_clusters: int


@dataclass(frozen=True)
class RoundPlan:
    """Per-level segment-sum plans for one placement, deepest level first.

    Shapes are placement-independent (the canonical round-robin trainer
    split fixes every cluster's member count), so jit'd consumers compile
    once per hierarchy and stream each round's index tables as data.
    """
    levels: Tuple[LevelPlan, ...]


@dataclass(frozen=True)
class Hierarchy:
    depth: int                 # number of aggregator levels, >= 1
    width: int                 # children per aggregator
    trainers_per_leaf: int = 2
    n_clients: Optional[int] = None  # default: exactly slots + trainers

    def __post_init__(self):
        if self.depth < 1 or self.width < 1:
            raise ValueError("depth and width must be >= 1")
        if self.n_clients is not None and self.n_clients < self.min_clients:
            raise ValueError(
                f"need >= {self.min_clients} clients for depth={self.depth} "
                f"width={self.width} t/leaf={self.trainers_per_leaf}, "
                f"got {self.n_clients}")

    # ---- sizes (cached: these sit on per-round hot paths) -----------------
    @cached_property
    def dimensions(self) -> int:
        """Paper eq. 5: number of aggregator slots."""
        return sum(self.width ** i for i in range(self.depth))

    @cached_property
    def n_leaves(self) -> int:
        return self.width ** (self.depth - 1)

    @cached_property
    def min_clients(self) -> int:
        return self.dimensions + self.n_leaves * self.trainers_per_leaf

    @cached_property
    def max_clients(self) -> int:
        """Elastic capacity bound: the population at which the tree
        counts as *overloaded* (every leaf carrying 2x its nominal
        trainer share). The elastic environments re-hierarchize when the
        (changing) population leaves ``[min_clients, max_clients]`` —
        a static run never consults this."""
        return self.dimensions + 2 * self.n_leaves * self.trainers_per_leaf

    @cached_property
    def total_clients(self) -> int:
        return self.n_clients if self.n_clients is not None else self.min_clients

    # ---- static tree structure -------------------------------------------
    @cached_property
    def levels(self) -> np.ndarray:
        """level index of each slot (BFS order)."""
        out = np.zeros(self.dimensions, np.int32)
        start, level = 0, 0
        count = 1
        while start < self.dimensions:
            out[start: start + count] = level
            start += count
            count *= self.width
            level += 1
        return out

    @cached_property
    def level_starts(self) -> List[int]:
        starts = [0]
        count = 1
        for _ in range(self.depth):
            starts.append(starts[-1] + count)
            count *= self.width
        return starts  # length depth+1; starts[l]..starts[l+1] are level l

    @cached_property
    def kids_table(self) -> np.ndarray:
        """(dimensions, width) child-slot table, -1 padded — the static
        gather operand every vectorized TPD evaluator keys off (cached:
        rebuilding it per evaluator is O(D*W) Python)."""
        kids = np.full((self.dimensions, self.width), -1, np.int32)
        for s in range(self.dimensions):
            ks = self.children_slots(s)
            kids[s, : len(ks)] = ks
        return kids

    def children_slots(self, slot: int) -> List[int]:
        """Child aggregator slots (empty for leaf aggregators)."""
        first = 1 + slot * self.width
        if first >= self.dimensions:
            return []
        return list(range(first, first + self.width))

    def parent_slot(self, slot: int) -> int:
        return (slot - 1) // self.width

    @cached_property
    def leaf_slots(self) -> List[int]:
        return list(range(self.level_starts[self.depth - 1],
                          self.level_starts[self.depth]))

    # ---- placement -> full role assignment --------------------------------
    def trainer_assignment(self, placement: Sequence[int]) -> List[List[int]]:
        """Round-robin the non-aggregator clients over the leaf slots.

        Returns trainers[i] = client ids under leaf slot leaf_slots[i].
        """
        placed = set(int(c) for c in placement)
        pool = [c for c in range(self.total_clients) if c not in placed]
        out: List[List[int]] = [[] for _ in self.leaf_slots]
        for idx, c in enumerate(pool):
            out[idx % len(out)].append(c)
        return out

    def children_clients(self, placement: Sequence[int],
                         trainers: Optional[List[List[int]]] = None
                         ) -> List[List[int]]:
        """children_clients[s] = client ids in slot s's processing buffer."""
        if trainers is None:
            trainers = self.trainer_assignment(placement)
        out: List[List[int]] = []
        for s in range(self.dimensions):
            kids = self.children_slots(s)
            if kids:
                out.append([int(placement[k]) for k in kids])
            else:
                leaf_idx = s - self.level_starts[self.depth - 1]
                out.append(list(trainers[leaf_idx]))
        return out

    def clusters(self, placement: Sequence[int]) -> List[List[List[int]]]:
        """Per-level aggregation clusters, bottom-up.

        clusters[0] is the deepest level: for each leaf aggregator, the
        member client ids = its trainers + the aggregator itself. Higher
        entries: child-aggregator hosts + the parent aggregator. The FL
        layer turns these into ``axis_index_groups``.
        """
        trainers = self.trainer_assignment(placement)
        children = self.children_clients(placement, trainers)
        out: List[List[List[int]]] = []
        for level in range(self.depth - 1, -1, -1):
            groups = []
            for s in range(self.level_starts[level], self.level_starts[level + 1]):
                groups.append(sorted(children[s] + [int(placement[s])]))
            out.append(groups)
        return out

    def round_plan(self, placement: Sequence[int]) -> RoundPlan:
        """Segment-sum tables for one round's aggregation (deepest first).

        Member ordering inside each cluster matches the sequential
        reference (``hierarchical_fedavg``): host first, then children —
        so a segment reduction reproduces the same partial-sum grouping.
        """
        placement = np.asarray(placement, np.int64)
        trainers = self.trainer_assignment(placement)
        C = self.total_clients
        out: List[LevelPlan] = []
        for level in range(self.depth - 1, -1, -1):
            start, stop = self.level_starts[level], self.level_starts[level + 1]
            src: List[int] = []
            mem: List[int] = []
            seg: List[int] = []
            hosts: List[int] = []
            counts: List[int] = []
            for g, s in enumerate(range(start, stop)):
                host = int(placement[s])
                e_src, e_mem = [host], [host]
                kids = self.children_slots(s)
                if kids:
                    child_base = self.level_starts[level + 1]
                    e_src += [C + (k - child_base) for k in kids]
                    e_mem += [int(placement[k]) for k in kids]
                else:
                    li = s - self.level_starts[self.depth - 1]
                    e_src += list(trainers[li])
                    e_mem += list(trainers[li])
                src += e_src
                mem += e_mem
                seg += [g] * len(e_src)
                hosts.append(host)
                counts.append(len(e_src))
            out.append(LevelPlan(
                src=np.asarray(src, np.int32),
                seg=np.asarray(seg, np.int32),
                member_clients=np.asarray(mem, np.int32),
                hosts=np.asarray(hosts, np.int32),
                n_parts=np.asarray(counts, np.int32),
                n_clusters=stop - start))
        return RoundPlan(levels=tuple(out))

    def slot_path(self, slot: int) -> Tuple[int, ...]:
        """Root->slot path as child indices (root = empty path).

        The path is the hierarchy-shape-independent identity of a slot:
        two hierarchies' slots correspond iff their paths match, which is
        what :func:`slot_remap` keys on.
        """
        path = []
        while slot > 0:
            path.append((slot - 1) % self.width)
            slot = (slot - 1) // self.width
        return tuple(reversed(path))

    def validate_placement(self, placement: Sequence[int]) -> None:
        p = np.asarray(placement, np.int64)
        if p.shape != (self.dimensions,):
            raise ValueError(f"placement must have {self.dimensions} slots")
        if len(set(p.tolist())) != self.dimensions:
            raise ValueError("placement has duplicate client ids")
        if p.min() < 0 or p.max() >= self.total_clients:
            raise ValueError("placement client id out of range")


def slot_remap(old: "Hierarchy", new: "Hierarchy") -> np.ndarray:
    """(new.dimensions,) int32 table: new slot -> old slot, -1 for slots
    with no counterpart.

    Slots correspond by tree *path* (sequence of child indices from the
    root), so the root always survives a re-hierarchization, a width
    shrink drops the right-most subtrees, and a depth change drops or
    grows the deepest levels. This is the remap the strategy ``migrate``
    hooks consume to carry per-slot swarm state across a ``D`` change.
    """
    out = np.full(new.dimensions, -1, np.int32)
    for s in range(new.dimensions):
        idx = 0
        for k in new.slot_path(s):
            if k >= old.width:
                idx = -1
                break
            idx = 1 + idx * old.width + k
            if idx >= old.dimensions:
                idx = -1
                break
        out[s] = idx
    return out


@dataclass(frozen=True)
class TopologyUpdate:
    """One elastic re-hierarchization, as handed to strategy ``migrate``
    hooks: the hierarchy transition plus the index remaps needed to
    carry per-slot / per-client state across it.

    ``slot_remap`` maps new slot -> old slot (-1 = brand-new slot);
    ``client_remap`` maps old client id -> new client id (-1 = departed;
    ``None`` = ids unchanged, pure re-shaping). ``version`` is the
    environment's topology epoch AFTER this update (first bump = 1).
    """
    version: int
    old_hierarchy: Hierarchy
    new_hierarchy: Hierarchy
    slot_remap: np.ndarray
    client_remap: Optional[np.ndarray] = None

    @property
    def old_n_clients(self) -> int:
        return self.old_hierarchy.total_clients

    @property
    def new_n_clients(self) -> int:
        return self.new_hierarchy.total_clients

    def describe(self) -> str:
        o, n = self.old_hierarchy, self.new_hierarchy
        shape = (f"d{o.depth}w{o.width} D={o.dimensions}" if
                 (o.depth, o.width) == (n.depth, n.width) else
                 f"d{o.depth}w{o.width} D={o.dimensions} -> "
                 f"d{n.depth}w{n.width} D={n.dimensions}")
        return (f"topology v{self.version}: {self.old_n_clients} -> "
                f"{self.new_n_clients} clients, {shape}")


def fill_placement_holes(row: np.ndarray, n_clients: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Fill the ``-1`` holes of a partially-carried placement row, in
    place: one ``rng.permutation(n_clients)`` draw (only when holes
    exist), holes taken in ascending slot order, skipping ids the row
    already carries. THE re-seeding rule of every elastic migration —
    `FlagSwapPSO.migrate` and ``repair_placement`` share it, so swarm
    re-seeding and placement repair can never drift apart.
    """
    holes = np.nonzero(row < 0)[0]
    if len(holes):
        taken = set(int(c) for c in row[row >= 0])
        fresh = [int(c) for c in rng.permutation(n_clients)
                 if int(c) not in taken]
        row[holes] = fresh[: len(holes)]
    return row


def compose_remaps(first: Optional[np.ndarray],
                   second: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Compose two old->new index remaps (``None`` = identity)."""
    if first is None:
        return None if second is None else second.copy()
    if second is None:
        return first.copy()
    out = np.full(len(first), -1, first.dtype)
    alive = first >= 0
    out[alive] = second[first[alive]]
    return out


@dataclass
class ClientPool:
    """Simulated client attributes (paper Sec. IV-A).

    memcap ~ U[10, 50); pspeed ~ U[5, 15); mdatasize fixed at 5 units.

    ``version`` is a mutation counter consumed by the cached vectorized
    TPD evaluators (an O(1) staleness check instead of hashing every
    attribute array). Rebinding an attribute (``pool.pspeed = ...``)
    bumps it automatically; after IN-PLACE edits (``pool.pspeed[i] = v``)
    callers must call :meth:`touch` — the event schedules in
    ``repro_torch.experiments.scenarios`` do.
    """
    memcap: np.ndarray
    pspeed: np.ndarray
    mdatasize: np.ndarray
    version: int = 0
    # pending old->new id remaps from join/leave, drained (composed) by
    # the elastic environments after each round's events have applied
    _resizes: List[np.ndarray] = field(default_factory=list, repr=False)

    _ATTRS = ("memcap", "pspeed", "mdatasize")

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in self._ATTRS:
            object.__setattr__(self, "version",
                               getattr(self, "version", 0) + 1)

    def touch(self) -> None:
        """Declare an in-place attribute mutation (invalidates caches)."""
        object.__setattr__(self, "version", self.version + 1)

    # ---- elastic population (true resizes, not attribute masking) --------
    def join(self, memcap, pspeed, mdatasize=None) -> np.ndarray:
        """Append new clients; returns their (new) client ids.

        Existing ids are unchanged — the logged remap is the identity
        over the pre-join population.
        """
        memcap = np.atleast_1d(np.asarray(memcap, np.float64))
        pspeed = np.atleast_1d(np.asarray(pspeed, np.float64))
        if len(memcap) != len(pspeed):
            raise ValueError("join needs matching memcap/pspeed lengths")
        if mdatasize is None:
            mdatasize = float(self.mdatasize[0]) if len(self) else 5.0
        mdatasize = np.broadcast_to(
            np.asarray(mdatasize, np.float64), memcap.shape).copy()
        m = len(self)
        self._resizes.append(np.arange(m, dtype=np.int64))
        self.memcap = np.concatenate([self.memcap, memcap])
        self.pspeed = np.concatenate([self.pspeed, pspeed])
        self.mdatasize = np.concatenate([self.mdatasize, mdatasize])
        return np.arange(m, m + len(memcap))

    def leave(self, ids) -> np.ndarray:
        """Remove clients ``ids``; survivors are renumbered contiguously
        (order preserved). Returns the old->new id remap (-1 = departed)
        — also logged for :meth:`drain_resizes`.
        """
        ids = np.unique(np.asarray(ids, np.int64))
        n = len(self)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"leave ids out of range [0, {n})")
        if ids.size >= n:
            raise ValueError("cannot remove the entire client pool")
        keep = np.ones(n, bool)
        keep[ids] = False
        remap = np.full(n, -1, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        self._resizes.append(remap)
        self.memcap = self.memcap[keep]
        self.pspeed = self.pspeed[keep]
        self.mdatasize = self.mdatasize[keep]
        return remap.copy()

    def pending_remap(self) -> Optional[np.ndarray]:
        """Composed old->new id remap of the resizes logged since the
        last drain, WITHOUT draining — the peek a stateful event uses to
        re-key client-indexed state mid-round, before the environment's
        end-of-round ``sync_topology`` consumes the log."""
        if not self._resizes:
            return None
        remap = self._resizes[0]
        for nxt in self._resizes[1:]:
            remap = compose_remaps(remap, nxt)
        return remap

    def drain_resizes(self) -> Optional[Tuple[int, np.ndarray]]:
        """Composed ``(old_n, old->new remap)`` covering every join/leave
        since the last drain; ``None`` when the population is untouched.
        """
        remap = self.pending_remap()
        if remap is None:
            return None
        self._resizes.clear()
        old_n = len(remap)
        # joins extend the id space past the remap's domain: the remap
        # only describes pre-existing ids, which is all a consumer
        # carrying old state needs
        return old_n, remap

    @classmethod
    def random(cls, n_clients: int, seed: int = 0,
               mdatasize: float = 5.0) -> "ClientPool":
        rng = np.random.default_rng(seed)
        return cls(
            memcap=rng.uniform(10, 50, n_clients).astype(np.float64),
            pspeed=rng.uniform(5, 15, n_clients).astype(np.float64),
            mdatasize=np.full(n_clients, mdatasize, np.float64),
        )

    def __len__(self) -> int:
        return len(self.pspeed)
