"""repro_torch.online — the deterministic discrete-event online track.

The port of ``repro.online``. The paper's real deployment is
asynchronous: client updates arrive whenever they arrive, rounds
overlap, and Flag-Swap re-optimizes placement from *observed* processing
delay. This package is that execution model behind the same
propose/observe Environment protocol as the synchronous tracks:

* :mod:`repro_torch.online.clock` — a virtual clock over a deterministic
  event heap (no wall-clock, total event order, replayable);
* :mod:`repro_torch.online.events` — the event vocabulary plus the
  seeded per-client :class:`~repro_torch.online.events.ArrivalProcess`;
* :mod:`repro_torch.online.async_fedavg` — buffered staleness-weighted
  async FedAvg: count-or-deadline :class:`~repro_torch.online.
  async_fedavg.AggregatorBuffer` per slot, the ``(1+s)^(-alpha)``
  weighting and the root :func:`~repro_torch.online.async_fedavg.
  async_merge_batched` (one ``torch.tensordot`` a leaf on the updates'
  device).

``OnlineEnvironment`` — the wiring of all three over
``FederatedOrchestrator`` — lives in
:mod:`repro_torch.experiments.environments` next to its siblings.
"""
from repro_torch.online.async_fedavg import (
    AggregatorBuffer,
    AsyncConfig,
    async_merge_batched,
    flush_count,
    staleness_weights,
)
from repro_torch.online.clock import VirtualClock
from repro_torch.online.events import (
    ArrivalProcess,
    BufferDeadline,
    BufferedPart,
    BufferEntry,
    PartialArrival,
    RootComplete,
    UpdateArrival,
)

__all__ = [
    "VirtualClock", "ArrivalProcess",
    "BufferEntry", "BufferedPart", "UpdateArrival", "PartialArrival",
    "BufferDeadline", "RootComplete",
    "AsyncConfig", "AggregatorBuffer", "flush_count",
    "staleness_weights", "async_merge_batched",
]
