"""Deterministic fault injection + tolerance for the FL tracks.

``repro_torch.faults.schedule`` — the seeded, replayable fault
vocabulary (crashes, drops, link degradation, aggregator failures,
partitions) and :class:`FaultSchedule`/:class:`FaultProfile`
generation.

``repro_torch.faults.tolerance`` — what the tracks do about it:
:class:`RetryPolicy` (bounded virtual-time exponential backoff) and
the quorum-gated, participation-damped merge
(:func:`quorum_merge_batched`, held to ``_quorum_merge_ref``).
"""
from repro_torch.faults.schedule import (
    AggregatorFailure,
    ClientCrash,
    ClientRecover,
    FaultAt,
    FaultEvent,
    FaultProfile,
    FaultSchedule,
    LinkDegrade,
    NetworkPartition,
    UpdateDrop,
    fault_from_dict,
)
from repro_torch.faults.tolerance import (
    RetryPolicy,
    quorum_count,
    quorum_merge_batched,
)

__all__ = [
    "AggregatorFailure",
    "ClientCrash",
    "ClientRecover",
    "FaultAt",
    "FaultEvent",
    "FaultProfile",
    "FaultSchedule",
    "LinkDegrade",
    "NetworkPartition",
    "RetryPolicy",
    "UpdateDrop",
    "fault_from_dict",
    "quorum_count",
    "quorum_merge_batched",
]
