"""Hierarchy ladders of the elastic tracks.

The port's copy of ``choose_fl_hierarchy`` and ``elastic_rehierarchize``
from ``repro.fl.distributed`` (the numpy part; the mesh round step
waits for the multi-device slice).
"""
from __future__ import annotations

from repro_torch.core.hierarchy import Hierarchy

# the historical preference ladder (deeper trees first) and, above it,
# the swarm-scale rungs the elastic environments opt into
_BASE_LADDER = ((3, 2, 2), (3, 2, 1), (2, 3, 4), (2, 3, 3),
                (2, 2, 4), (2, 2, 2), (2, 2, 1))
_SCALE_LADDER = ((6, 4, 2), (6, 3, 2), (5, 3, 2), (4, 3, 2),
                 (4, 2, 2)) + _BASE_LADDER


def choose_fl_hierarchy(n_clients: int, *, scale: bool = False) -> Hierarchy:
    """Pick a depth/width whose minimum client count fits ``n_clients``.

    Preference order: deeper trees first (more interesting schedules).
    Extra clients beyond the minimum become additional trainers (the
    round-robin assignment absorbs them).

    ``scale=True`` extends the ladder with the swarm-scale rungs
    (depth-4 .. depth-6, the large-1k/large-10k tree shapes) so a large
    population keeps a proportionate tree instead of collapsing onto
    the 7-slot depth-3 one — this is what the elastic environments use
    to re-hierarchize a GROWING population (a flash crowd climbs
    depth-2 -> -3 -> -4 as it crosses each rung's minimum). The default
    keeps the historical small-cluster ladder.
    """
    for depth, width, tpl in (_SCALE_LADDER if scale else _BASE_LADDER):
        if Hierarchy(depth, width, tpl).min_clients <= n_clients:
            return Hierarchy(depth=depth, width=width, trainers_per_leaf=tpl,
                             n_clients=n_clients)
    return Hierarchy(depth=1, width=1, trainers_per_leaf=1,
                     n_clients=max(n_clients, 2))


def elastic_rehierarchize(old: Hierarchy, n_clients: int,
                          capacity: int) -> tuple:
    """THE capacity-window re-hierarchization rule of the elastic tracks.

    Returns ``(new_hierarchy, new_capacity)`` for a population that just
    resized to ``n_clients`` under a tree previously allowed to carry up
    to ``capacity`` clients. Outside the window ``[old.min_clients,
    capacity]`` the structure is rebuilt through
    :func:`choose_fl_hierarchy` (scale ladder) and the capacity re-pins
    to the new tree's bound; inside it, the same tree shape is kept and
    only ``n_clients`` is re-pinned (cheaper migration, identity
    ``slot_remap``). Deterministic — no rng is consumed.
    """
    if n_clients < old.min_clients or n_clients > capacity:
        new = choose_fl_hierarchy(n_clients, scale=True)
        return new, max(new.max_clients, n_clients)
    return Hierarchy(depth=old.depth, width=old.width,
                     trainers_per_leaf=old.trainers_per_leaf,
                     n_clients=n_clients), capacity
