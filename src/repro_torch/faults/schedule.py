"""Deterministic fault schedules for the online and emulated tracks.

The port's copy of ``repro.faults.schedule``; ``ScenarioSpec`` carries
these fault fields on every track.

A :class:`FaultSchedule` is a frozen, seed-derivable list of fault
events pinned to round indices. Faults inject through the SAME
machinery the tracks already run on — the online track wraps each fault
in a :class:`FaultAt` clock event scheduled at ``t_round + offset`` on
the :class:`~repro.online.clock.VirtualClock`, the emulated track
applies the round's faults at step start — so every faulty run is
bit-replayable with no wall-clock anywhere.

Semantics shared by both tracks (durations are measured in ROUNDS and
expire at round boundaries, which is what lets one schedule mean the
same thing under event-driven and lockstep execution):

* ``ClientCrash(client, at_round, down_rounds)`` — the client goes
  down; its undelivered in-flight update is voided. ``down_rounds == 0``
  means "until an explicit :class:`ClientRecover`"; ``> 0`` auto-revives
  at the start of round ``at_round + down_rounds``.
* ``ClientRecover(client, at_round)`` — explicit revival.
* ``UpdateDrop(client, at_round)`` — the client's pending update is
  lost in transit once; the retry policy may re-send it (bounded
  exponential backoff in virtual time).
* ``LinkDegrade(client, at_round, factor, for_rounds)`` — the client's
  delivery latency is multiplied by ``factor`` for dispatches during
  the window.
* ``AggregatorFailure(slot, at_round, down_rounds)`` — the client
  HOSTING ``slot`` at fire time crashes; the slot fails over to a live
  unplaced client and in-flight buffer contents re-home under the new
  host.
* ``NetworkPartition(clients, at_round, for_rounds)`` — the named
  clients are unreachable for the window: they are not dispatched, and
  updates already in flight are held and re-injected when the
  partition heals.

``offset`` (online track only; the emulated track is round-granular
and ignores it) delays the fault's injection into the event queue by
that much virtual time past the round's dispatch instant.

RPL002: schedule generation draws from the dedicated
``(seed, _FAULT_STREAM)`` stream only.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Dict, Optional, Tuple

import numpy as np

# rng stream tag for fault-schedule generation: faults drawn for round
# r are independent of every training/event/arrival stream in the run
_FAULT_STREAM = 0xFA175


@dataclass(frozen=True)
class FaultEvent:
    """Base: one fault pinned to a round (and, online, a virtual-time
    offset past that round's dispatch)."""
    at_round: int = 0
    offset: float = 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["fault"] = type(self).__name__
        return d


@dataclass(frozen=True)
class ClientCrash(FaultEvent):
    client: int = 0
    down_rounds: int = 0    # 0 = until an explicit ClientRecover


@dataclass(frozen=True)
class ClientRecover(FaultEvent):
    client: int = 0


@dataclass(frozen=True)
class UpdateDrop(FaultEvent):
    client: int = 0


@dataclass(frozen=True)
class LinkDegrade(FaultEvent):
    client: int = 0
    factor: float = 3.0
    for_rounds: int = 2


@dataclass(frozen=True)
class AggregatorFailure(FaultEvent):
    slot: int = 0
    down_rounds: int = 1


@dataclass(frozen=True)
class NetworkPartition(FaultEvent):
    clients: Tuple[int, ...] = ()
    for_rounds: int = 1


_FAULT_TYPES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (ClientCrash, ClientRecover, UpdateDrop, LinkDegrade,
                AggregatorFailure, NetworkPartition)
}


def fault_from_dict(d: dict) -> FaultEvent:
    """Inverse of ``FaultEvent.to_dict`` (tag key ``"fault"``)."""
    d = dict(d)
    name = d.pop("fault", None)
    cls = _FAULT_TYPES.get(name)
    if cls is None:
        raise ValueError(
            f"unknown fault type {name!r}; known: "
            f"{sorted(_FAULT_TYPES)}")
    known = {f.name for f in fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown fields {unknown} for fault {name}")
    if "clients" in d:
        d["clients"] = tuple(int(c) for c in d["clients"])
    return cls(**d)


@dataclass(frozen=True)
class FaultProfile:
    """Per-round fault rates for :meth:`FaultSchedule.generate`.

    Rates are per-round Bernoulli probabilities of injecting ONE event
    of that kind (on a uniformly drawn client); ``agg_fail_every`` is a
    cadence (every k-th round the current host of a uniformly drawn
    slot crashes). ``first_round`` leaves the run's opening rounds
    fault-free so every strategy sees at least one clean placement.
    """
    crash_rate: float = 0.0
    crash_down_rounds: int = 2
    drop_rate: float = 0.0
    degrade_rate: float = 0.0
    degrade_factor: float = 4.0
    degrade_rounds: int = 2
    partition_rate: float = 0.0
    partition_frac: float = 0.2
    partition_rounds: int = 1
    agg_fail_every: int = 0
    agg_down_rounds: int = 1
    first_round: int = 1
    max_offset: float = 0.5

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultProfile":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown FaultProfile fields {unknown}; known: "
                f"{sorted(known)}")
        return cls(**d)


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, replayable list of fault events."""
    events: Tuple[FaultEvent, ...] = field(default_factory=tuple)

    @property
    def empty(self) -> bool:
        return not self.events

    def for_round(self, round_idx: int) -> Tuple[FaultEvent, ...]:
        """This round's faults in canonical order: (offset, type name,
        schedule position) — deterministic regardless of construction
        order."""
        hits = [(ev.offset, type(ev).__name__, i, ev)
                for i, ev in enumerate(self.events)
                if ev.at_round == round_idx]
        return tuple(ev for _off, _name, _i, ev in sorted(
            hits, key=lambda h: h[:3]))

    def to_dicts(self) -> list:
        return [ev.to_dict() for ev in self.events]

    @classmethod
    def from_dicts(cls, dicts) -> "FaultSchedule":
        return cls(tuple(fault_from_dict(d) for d in dicts))

    @classmethod
    def generate(cls, profile: FaultProfile, *, seed: int,
                 n_clients: int, n_slots: int,
                 rounds: int) -> "FaultSchedule":
        """Draw a randomized-but-seeded schedule from ``profile``.

        All draws come from the dedicated ``(seed, _FAULT_STREAM)``
        stream in a fixed per-round order (crash, drop, degrade,
        partition, aggregator failure), so the schedule is a pure
        function of ``(profile, seed, n_clients, n_slots, rounds)``.
        """
        rng = np.random.default_rng((int(seed), _FAULT_STREAM))
        out = []
        for r in range(int(profile.first_round), int(rounds)):
            if profile.crash_rate > 0 and rng.random() < profile.crash_rate:
                out.append(ClientCrash(
                    at_round=r,
                    offset=float(rng.uniform(0.0, profile.max_offset)),
                    client=int(rng.integers(n_clients)),
                    down_rounds=int(profile.crash_down_rounds)))
            if profile.drop_rate > 0 and rng.random() < profile.drop_rate:
                out.append(UpdateDrop(
                    at_round=r,
                    offset=float(rng.uniform(0.0, profile.max_offset)),
                    client=int(rng.integers(n_clients))))
            if (profile.degrade_rate > 0
                    and rng.random() < profile.degrade_rate):
                out.append(LinkDegrade(
                    at_round=r, offset=0.0,
                    client=int(rng.integers(n_clients)),
                    factor=float(profile.degrade_factor),
                    for_rounds=int(profile.degrade_rounds)))
            if (profile.partition_rate > 0
                    and rng.random() < profile.partition_rate):
                k = max(1, int(round(profile.partition_frac * n_clients)))
                picks = rng.choice(n_clients, size=k, replace=False)
                out.append(NetworkPartition(
                    at_round=r, offset=0.0,
                    clients=tuple(int(c) for c in np.sort(picks)),
                    for_rounds=int(profile.partition_rounds)))
            if (profile.agg_fail_every > 0
                    and (r - profile.first_round) % profile.agg_fail_every
                    == profile.agg_fail_every - 1):
                out.append(AggregatorFailure(
                    at_round=r,
                    offset=float(rng.uniform(0.0, profile.max_offset)),
                    slot=int(rng.integers(n_slots)),
                    down_rounds=int(profile.agg_down_rounds)))
        return cls(tuple(out))


@dataclass(frozen=True)
class FaultAt:
    """VirtualClock wrapper: ``fault`` fires when this event pops."""
    fault: FaultEvent


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
