"""Buffered, staleness-weighted asynchronous FedAvg.

The port of ``repro.online.async_fedavg``: the FedBuff/FedAsync-style
server rule over the paper's aggregation tree. Every aggregator slot
owns an :class:`AggregatorBuffer` that fills with arriving updates and
*flushes* when either a count threshold or a virtual-time deadline is
hit. What travels through the tree is bookkeeping — ``(client, dispatch
round)`` entries — because hierarchical FedAvg over the placement tree
equals flat weighted FedAvg: the tree decides *when* and *which*
updates reach the root, the tensor math happens once at the root flush
via :func:`async_merge_batched`:

    w~_i  ∝  w_i * (1 + s_i)^(-alpha)          (normalized over the flush)
    global <- (1 - eta) * global + eta * Σ_i w~_i * update_i

where ``s_i`` is the update's staleness in rounds and ``w_i`` the
client's FedAvg data weight. ``alpha = 0`` recovers plain weighted
FedAvg over the flushed cohort. The weights are float64 numpy, as in
the reference; the merge is one ``torch.tensordot`` a leaf over the
stacked updates, on their device (the reference's ``jnp.tensordot``;
no kernel runs here in either package). Both halves carry scalar
oracles (:func:`_staleness_weights_ref`, :func:`_async_merge_ref`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class AsyncConfig:
    """The online track's knobs (mirrored as ``ScenarioSpec`` fields).

    ``jitter``            lognormal sigma on per-client train delays
    ``staleness_alpha``   decay exponent in ``(1 + s)^(-alpha)``
    ``flush_fraction``    fraction of a buffer's expected parts that
                          triggers a count flush (>= 1.0 = wait for all)
    ``flush_timeout``     virtual-time deadline armed at first deposit
                          into an empty buffer (0 = count-only)
    ``server_lr``         eta — the server mixing rate at the root merge
    ``reopt_threshold``   flush latency > threshold x the slot's EWMA
                          triggers a mid-round host swap (0 = disabled)
    ``reopt_beta``        EWMA decay for the observed flush latencies
    """
    jitter: float = 0.0
    staleness_alpha: float = 0.5
    flush_fraction: float = 1.0
    flush_timeout: float = 0.0
    server_lr: float = 1.0
    reopt_threshold: float = 0.0
    reopt_beta: float = 0.5

    @property
    def degenerate(self) -> bool:
        """No jitter, full-cohort flushes, no deadline: the config IS
        synchronous lockstep."""
        return (self.jitter == 0.0 and self.flush_fraction >= 1.0
                and self.flush_timeout == 0.0)


# ---------------------------------------------------------------------------
# staleness weighting: vectorized fast path + scalar oracle
# ---------------------------------------------------------------------------
def staleness_weights(base_weights, staleness, alpha: float) -> np.ndarray:
    """Normalized staleness-decayed merge weights (vectorized).

    ``w~_i = w_i * (1 + s_i)^(-alpha) / Σ_j w_j * (1 + s_j)^(-alpha)``.
    float64 throughout; the scalar oracle is
    :func:`_staleness_weights_ref`.
    """
    w = np.asarray(base_weights, np.float64)
    s = np.asarray(staleness, np.float64)
    if w.shape != s.shape:
        raise ValueError(f"weights {w.shape} vs staleness {s.shape}")
    if s.size and s.min() < 0:
        raise ValueError("negative staleness")
    decayed = w * np.power(1.0 + s, -float(alpha))
    total = decayed.sum()
    if total <= 0:
        raise ValueError("staleness weights sum to zero")
    return decayed / total


def _staleness_weights_ref(base_weights, staleness,
                           alpha: float) -> np.ndarray:
    """Scalar reference: one explicit loop per update."""
    decayed = []
    for w, s in zip(base_weights, staleness, strict=True):
        decayed.append(float(w) * (1.0 + float(s)) ** (-float(alpha)))
    total = sum(decayed)
    return np.asarray([d / total for d in decayed], np.float64)


# ---------------------------------------------------------------------------
# the root merge: batched fast path + scalar oracle
# ---------------------------------------------------------------------------
def _merge(global_params, stacked_updates, w: np.ndarray, eta: float):
    """``(1 - eta) * global + eta * Σ_i w_i u_i``, one tensordot a leaf
    with the float64 weights cast to the leaf's dtype."""
    def merge_leaf(g, u):
        wt = torch.as_tensor(w, device=u.device).to(u.dtype)
        avg = torch.tensordot(wt, u, dims=([0], [0]))
        return (1.0 - eta) * g + eta * avg

    return tree_map(merge_leaf, global_params, stacked_updates)


def async_merge_batched(global_params, stacked_updates, base_weights,
                        staleness, alpha: float, eta: float):
    """Staleness-weighted server merge over a stacked flush cohort.

    ``stacked_updates`` leaves carry a leading ``K`` axis (one row per
    flushed entry). Returns ``(1 - eta) * global + eta * Σ w~_i u_i``
    computed as one tensordot per leaf. Scalar oracle:
    :func:`_async_merge_ref` (equal up to float summation order).
    """
    w = staleness_weights(base_weights, staleness, alpha)
    return _merge(global_params, stacked_updates, w, float(eta))


def _accumulate_ref(global_params, updates: List, w, eta: float):
    """Per-update accumulation, one tree at a time, then the mix."""
    acc = tree_map(torch.zeros_like, global_params)
    for wi, u in zip(w, updates, strict=True):
        acc = tree_map(lambda a, x, wi=float(wi): a + wi * x, acc, u)
    return tree_map(lambda g, a: (1.0 - eta) * g + eta * a,
                    global_params, acc)


def _async_merge_ref(global_params, updates: List, base_weights,
                     staleness, alpha: float, eta: float):
    """Scalar reference: per-update accumulation, one tree at a time."""
    w = _staleness_weights_ref(base_weights, staleness, alpha)
    return _accumulate_ref(global_params, updates, w, float(eta))


# ---------------------------------------------------------------------------
# per-aggregator count-or-deadline buffer
# ---------------------------------------------------------------------------
def flush_count(expected: int, flush_fraction: float) -> int:
    """Deposits needed to trigger a count flush: ceil(fraction *
    expected), at least 1, never more than ``expected``."""
    if expected <= 0:
        raise ValueError(f"expected parts must be positive: {expected}")
    k = math.ceil(float(flush_fraction) * expected)
    return max(1, min(int(k), expected))


@dataclass
class AggregatorBuffer:
    """One slot's in-flight deposit buffer.

    ``epoch`` increments on every flush; a deadline carries the epoch it
    was armed under, so a deadline firing after a count flush already
    drained the buffer is recognized as stale and dropped — the count
    path and the deadline path can never double-flush one cohort.
    """
    slot: int
    expected: int                # host + trainers (leaf) / children
    threshold: int               # deposits that trigger a count flush
    parts: List = field(default_factory=list)
    epoch: int = 0

    def deposit(self, part) -> bool:
        """Add a part; True when the count threshold is now met."""
        self.parts.append(part)
        return len(self.parts) >= self.threshold

    @property
    def empty(self) -> bool:
        return not self.parts

    def take(self) -> Tuple:
        """Drain the buffer for a flush (bumps the epoch)."""
        drained = tuple(self.parts)
        self.parts = []
        self.epoch += 1
        return drained
