"""Deterministic virtual clock + discrete-event queue.

The port of ``repro.online.clock`` (pure Python, the same logic). The
online track never reads wall-clock time: every timestamp is
*virtual* (the same delay units eqs. 6-7 charge), events are totally
ordered by ``(time, schedule sequence)``, and the heap tie-break is the
monotonically increasing sequence number — so two events landing on the
identical virtual instant pop in the order they were scheduled, on
every machine, on every replay. This is what makes the whole track
pass the repository's static determinism gate (RPL004: no wall-clock
reads, no unordered iteration) and lets two same-seed runs produce
bit-identical event traces.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Tuple

# events never need comparing: the (time, seq) prefix is unique, so the
# heap never falls through to the payload — events can be any object
_EPS = 1e-12


class VirtualClock:
    """A monotone virtual clock over a deterministic event heap."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._seq: int = 0
        self._heap: List[Tuple[float, int, Any]] = []

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def schedule(self, t: float, event: Any) -> None:
        """Enqueue ``event`` at virtual time ``t`` (>= now)."""
        t = float(t)
        if t < self.now - _EPS:
            raise ValueError(
                f"cannot schedule into the past: t={t} < now={self.now}")
        heapq.heappush(self._heap, (t, self._seq, event))
        self._seq += 1

    def pop(self) -> Tuple[float, Any]:
        """Pop the earliest event and advance ``now`` to its time."""
        if not self._heap:
            raise IndexError("pop from an empty event queue")
        t, _, event = heapq.heappop(self._heap)
        self.now = t
        return t, event

    def peek_time(self) -> float:
        if not self._heap:
            raise IndexError("peek on an empty event queue")
        return self._heap[0][0]

    def advance_to(self, t: float) -> None:
        """Move ``now`` forward without consuming events (lockstep
        rounds advance past their analytic completion time)."""
        t = float(t)
        if t < self.now - _EPS:
            raise ValueError(
                f"cannot rewind the clock: t={t} < now={self.now}")
        self.now = max(self.now, t)

    def pending(self) -> List[Tuple[float, int, Any]]:
        """Sorted snapshot of the queue (tests + topology migration)."""
        return sorted(self._heap)

    def replace(self, items: List[Tuple[float, int, Any]]) -> None:
        """Swap in a rebuilt queue (elastic migration re-keys client
        ids inside pending events); ``items`` keep their original
        (time, seq) keys so relative order is preserved exactly."""
        self._heap = list(items)
        heapq.heapify(self._heap)

    def state_dict(self, encode) -> dict:
        """JSON-safe snapshot for checkpointing; ``encode`` maps each
        event payload to a JSON-safe value. (time, seq) keys are kept
        verbatim so a restored queue pops in the identical order —
        floats round-trip exactly through JSON's repr serialization."""
        return {"now": self.now, "seq": self._seq,
                "events": [[t, s, encode(ev)]
                           for t, s, ev in self.pending()]}

    def load_state(self, state: dict, decode) -> None:
        """Inverse of :meth:`state_dict` (``decode`` rebuilds each
        event payload). The sequence counter resumes past every stored
        event, so post-restore scheduling keeps the FIFO tie-break."""
        self.now = float(state["now"])
        self._seq = int(state["seq"])
        self.replace([(float(t), int(s), decode(ev))
                      for t, s, ev in state["events"]])
