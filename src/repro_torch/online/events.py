"""Event vocabulary + seeded arrival process for the online track.

The port of ``repro.online.events`` (numpy, the same logic and the
same streams, so every draw equals the reference's). Four event kinds
flow through the :class:`~repro_torch.online.clock.VirtualClock`:

* ``UpdateArrival`` — a trainer's locally-trained update reaches its
  aggregator (after its jittered virtual train delay);
* ``PartialArrival`` — an aggregator's flushed partial reaches its
  parent slot;
* ``BufferDeadline`` — the count-or-deadline buffer's timeout fires
  (epoch-guarded: a flush that already drained the buffer strands the
  stale deadline harmlessly);
* ``RootComplete`` — the root aggregator finished a flush; the merge
  happens at this instant and concludes the round.

The arrival process is the ONLY randomness the online track adds: each
client owns a counter-based rng stream keyed ``(seed, _ARRIVAL_STREAM,
client_id)``, so the jitter a client draws is independent of cohort
composition, dispatch order, and every other stream in the run — the
property the seeded-trace determinism tests pin.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# rng stream tag for per-client arrival jitter: a dedicated stream per
# client id keeps the draw sequence independent of dispatch order and
# of every training/event stream
_ARRIVAL_STREAM = 0xA441


@dataclass(frozen=True)
class BufferEntry:
    """One client update in flight through the aggregation tree."""
    client: int
    version: int        # the round the update was dispatched from


@dataclass(frozen=True)
class BufferedPart:
    """One payload sitting in an aggregator's buffer: a trainer's own
    update (``entries`` is a singleton) or a child's flushed partial
    (``entries`` spans everything the subtree accumulated)."""
    src: int            # client whose payload this is (trainer or host)
    entries: Tuple[BufferEntry, ...]


@dataclass(frozen=True)
class UpdateArrival:
    client: int
    version: int


@dataclass(frozen=True)
class PartialArrival:
    slot: int           # destination (parent) slot
    src: int            # host client that flushed the partial
    entries: Tuple[BufferEntry, ...]


@dataclass(frozen=True)
class BufferDeadline:
    slot: int
    epoch: int          # guards against flushes that already drained


@dataclass(frozen=True)
class RootComplete:
    entries: Tuple[BufferEntry, ...]


class ArrivalProcess:
    """Seeded multiplicative jitter on client train delays.

    ``factor(c)`` draws ``exp(sigma * z - sigma^2 / 2)`` from client
    ``c``'s own stream — a mean-one lognormal, so jitter spreads
    arrivals without biasing the average delay. ``sigma == 0`` draws
    nothing at all (the stream is never even created), which is what
    makes the zero-jitter degenerate config bit-exact.
    """

    def __init__(self, seed: int, sigma: float) -> None:
        self.seed = int(seed)
        self.sigma = float(sigma)
        self._rngs: Dict[int, np.random.Generator] = {}

    def factor(self, client: int) -> float:
        if self.sigma == 0.0:
            return 1.0
        rng = self._rngs.get(client)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed, _ARRIVAL_STREAM, client))
            self._rngs[client] = rng
        z = rng.standard_normal()
        return float(np.exp(self.sigma * z - 0.5 * self.sigma ** 2))

    def migrate(self, client_remap) -> None:
        """Carry per-client streams across an elastic pool renumbering
        so a surviving client keeps ITS draw sequence (departed
        clients' streams are dropped; joiners start fresh ones keyed by
        their new ids)."""
        if client_remap is None or not self._rngs:
            return
        remapped: Dict[int, np.random.Generator] = {}
        for c in sorted(self._rngs):
            if c < len(client_remap) and client_remap[c] >= 0:
                remapped[int(client_remap[c])] = self._rngs[c]
        self._rngs = remapped

    def state_dict(self) -> dict:
        """JSON-safe per-client stream states (checkpointing)."""
        return {"streams": [[c, self._rngs[c].bit_generator.state]
                            for c in sorted(self._rngs)]}

    def load_state(self, state: dict) -> None:
        """Rebuild each client's stream on its canonical key and fast-
        forward it by restoring the saved bit-generator state."""
        self._rngs = {}
        for c, st in state["streams"]:
            rng = np.random.default_rng(
                (self.seed, _ARRIVAL_STREAM, int(c)))
            rng.bit_generator.state = st
            self._rngs[int(c)] = rng
