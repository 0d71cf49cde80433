"""Shared virtual clock: the event-loop substrate of both serving paths.

One heap-ordered event queue + a virtual ``now`` drives the discrete-event
simulator (``serving/cluster.py``) and the live orchestrator
(``serving/orchestrator.py``).  Time is *virtual* seconds: event costs come
from the §4.3 analytical model (``core/analytical.py``), never from wall
clocks, so every run is deterministic under a fixed workload seed and the
two paths report time-domain metrics (TTFT/TPOT/goodput, Figures 8–11) on
one axis.

Ordering contract: events pop in (time, push-order) — ties resolve FIFO,
so handlers that push follow-up work "at now" run in a deterministic,
causal order.  Pushing into the past is a bug (the clock never rewinds)
and raises.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence: ``kind`` names the handler, ``payload``
    is handler-private."""
    t: float
    seq: int                      # FIFO tie-break within a timestamp
    kind: str
    payload: Any = None


class VirtualClock:
    """Heap-based event queue with a monotonic virtual ``now``.

    ``trace=True`` keeps a per-event ``(t, kind)`` log — the execution
    trace tests and the docs' event-loop diagram refer to.
    """

    def __init__(self, trace: bool = False):
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        self.trace: Optional[List[Tuple[float, str]]] = [] if trace else None
        self.n_processed = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, t: float, kind: str, payload: Any = None) -> Event:
        """Schedule ``kind`` at virtual time ``t`` (>= now)."""
        if t < self.now - 1e-12:
            raise ValueError(
                f"event {kind!r} scheduled at {t} before now={self.now}")
        t = max(t, self.now)
        self._seq += 1
        ev = Event(t, self._seq, kind, payload)
        heapq.heappush(self._heap, (t, self._seq, ev))
        return ev

    def push_in(self, delay: float, kind: str, payload: Any = None) -> Event:
        """Schedule ``kind`` ``delay`` seconds from now."""
        return self.push(self.now + max(delay, 0.0), kind, payload)

    def peek_t(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[Event]:
        """Pop the earliest event and advance ``now`` to it."""
        if not self._heap:
            return None
        _, _, ev = heapq.heappop(self._heap)
        self.now = ev.t
        self.n_processed += 1
        if self.trace is not None:
            self.trace.append((ev.t, ev.kind))
        return ev
