"""repro_torch.online — the online track's server rule.

The port of ``repro.online`` so far: :mod:`repro_torch.online.async_fedavg`
— buffered staleness-weighted async FedAvg (count-or-deadline
:class:`~repro_torch.online.async_fedavg.AggregatorBuffer` per slot, the
``(1+s)^(-alpha)`` weighting and the root
:func:`~repro_torch.online.async_fedavg.async_merge_batched`), which the
fault track's quorum merge builds on. The virtual clock, the event
vocabulary and ``OnlineEnvironment`` come with ROADMAP.md queue 1
item 7.
"""
from repro_torch.online.async_fedavg import (
    AggregatorBuffer,
    AsyncConfig,
    async_merge_batched,
    flush_count,
    staleness_weights,
)

__all__ = [
    "AsyncConfig", "AggregatorBuffer", "flush_count",
    "staleness_weights", "async_merge_batched",
]
