"""Per-round client sampling: resident pool vs. per-round cohort.

The port's copy of ``repro.experiments.sampling`` (same streams, same
cohorts).

Production cross-device FL never sees the whole population in one
round — a few hundred participants are drawn from a pool of millions
(see the HFL survey and Qolomany et al. in PAPERS.md; the swarm only
ever needs the sampled cohort). This module holds the sampling stream:
a :class:`CohortSampler` that draws each round's cohort from the
resident pool with a *counter-based* RNG, so the cohort sequence is a
pure function of ``(seed, round)`` — identical across sequential vs.
batched runners and across a checkpoint/resume boundary with no stream
state to serialize.

Stream discipline (RPL002): every draw seeds
``default_rng((seed, _SAMPLING_STREAM, round))`` — a named stream
constant, no literals in the seed expression, no process entropy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CohortSampler"]

# dedicated stream id for cohort draws, disjoint from the event
# (0xE7E47), arrival (0xA441), fault (0xFA175), elastic (0xE1A57) and
# eval (0xE7A1) streams
_SAMPLING_STREAM = 0x5A3B1E


class CohortSampler:
    """Draws the round-``r`` cohort from a pool of ``pool_n`` clients.

    ``draw`` is stateless: round ``r``'s cohort comes from its own
    counter-based stream, so replaying any round re-derives the same
    cohort regardless of execution order. Cohort ids are sorted so the
    gathered attribute arrays are in stable pool order.
    """

    def __init__(self, seed: int, cohort_size: int):
        if cohort_size < 2:
            raise ValueError(f"cohort_size must be >= 2, got {cohort_size}")
        self.seed = int(seed)
        self.cohort_size = int(cohort_size)

    def draw(self, round_idx: int, pool_n: int) -> np.ndarray:
        """Sorted pool indices of round ``round_idx``'s cohort
        (``min(cohort_size, pool_n)`` of them, without replacement)."""
        k = min(self.cohort_size, int(pool_n))
        rng = np.random.default_rng(
            (self.seed, _SAMPLING_STREAM, int(round_idx)))
        return np.sort(rng.choice(int(pool_n), size=k, replace=False))

    def migrate(self, client_remap: np.ndarray) -> None:
        """Pool resize hook (mirrors ``ArrivalProcess.migrate``).

        The stream is keyed on ``(seed, round)`` — not on client ids —
        so there is no per-client state to re-key: the next ``draw``
        simply ranges over the new pool size. Kept as an explicit hook
        so resize plumbing treats all streams uniformly.
        """

    def state_dict(self) -> dict:
        """Checkpoint payload — static config only; draws are
        counter-based so there is no stream position to save."""
        return {"seed": self.seed, "cohort_size": self.cohort_size}
