"""Fault tolerance: retry policy + quorum-damped degraded merges.

The port of ``repro.faults.tolerance``. Two mechanisms sit on top of the
fault schedule:

* :class:`RetryPolicy` — a dropped update is re-sent after a bounded
  deterministic exponential backoff in VIRTUAL time
  (``base * mult**attempt``); after ``max_retries`` exhausted attempts
  the update is permanently lost and the client re-enters the next
  dispatch cohort.
* :func:`quorum_merge_batched` — the graceful-degradation server rule.
  When a flush carries fewer updates than the quorum
  (:func:`quorum_count` over the LIVE population) the merge is refused
  outright (the model holds); when it proceeds under partial
  participation the staleness weights are renormalized over the
  arrivals exactly as in
  :func:`~repro_torch.online.async_fedavg.async_merge_batched` but the
  server mixing rate is damped by the arrived fraction::

      eta_eff = eta * min(1, arrived_frac)
      global <- (1 - eta_eff) * global + eta_eff * Σ_i w~_i * update_i

  so a 30%-participation degraded flush moves the model 30% as far as
  a full one. ``arrived_frac >= 1`` recovers ``async_merge_batched``
  bit for bit. Scalar oracle: :func:`_quorum_merge_ref`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from repro_torch.online.async_fedavg import (
    _accumulate_ref,
    _merge,
    _staleness_weights_ref,
    staleness_weights,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded deterministic exponential backoff in virtual time."""
    max_retries: int = 0
    backoff_base: float = 0.25
    backoff_mult: float = 2.0

    @property
    def enabled(self) -> bool:
        return self.max_retries > 0

    def delay(self, attempt: int) -> float:
        """Virtual-time wait before re-delivery attempt ``attempt``
        (0-based)."""
        if attempt < 0:
            raise ValueError(f"negative retry attempt {attempt}")
        return float(self.backoff_base) * float(self.backoff_mult) ** attempt


def quorum_count(live_clients: int, quorum_frac: float) -> int:
    """Merged updates needed for a flush to commit: ceil(frac * live),
    at least 1. ``quorum_frac == 0`` disables the gate."""
    if live_clients <= 0:
        raise ValueError(f"live client count must be positive: "
                         f"{live_clients}")
    if quorum_frac <= 0.0:
        return 1
    return max(1, int(math.ceil(float(quorum_frac) * live_clients)))


def quorum_merge_batched(global_params, stacked_updates, base_weights,
                         staleness, alpha: float, eta: float,
                         arrived_frac: float):
    """Degraded-participation server merge over a stacked flush cohort.

    Identical to :func:`~repro_torch.online.async_fedavg.
    async_merge_batched` except the server mixing rate is damped by the
    fraction of the population that actually arrived: ``eta_eff = eta *
    min(1, arrived_frac)``. One ``torch.tensordot`` a leaf on the
    updates' device. Scalar oracle: :func:`_quorum_merge_ref` (equal up
    to float summation order).
    """
    if arrived_frac <= 0.0:
        raise ValueError(f"arrived_frac must be positive: {arrived_frac}")
    w = staleness_weights(base_weights, staleness, alpha)
    eta_eff = float(eta) * min(1.0, float(arrived_frac))
    return _merge(global_params, stacked_updates, w, eta_eff)


def _quorum_merge_ref(global_params, updates: List, base_weights,
                      staleness, alpha: float, eta: float,
                      arrived_frac: float):
    """Scalar reference: per-update accumulation, one tree at a time."""
    w = _staleness_weights_ref(base_weights, staleness, alpha)
    eta_eff = float(eta) * min(1.0, float(arrived_frac))
    return _accumulate_ref(global_params, updates, w, eta_eff)


__all__ = [
    "RetryPolicy",
    "quorum_count",
    "quorum_merge_batched",
]
