"""Deterministic fault schedules (the tolerance half waits for the fault
slice)."""
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
    "UpdateDrop",
    "fault_from_dict",
]
