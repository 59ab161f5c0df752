"""Deterministic discrete-event transport for the GHS protocol.

The reference's transports — per-thread ``queue.Queue`` with requeue caps
(``ghs_implementation.py:82-116``) and MPI ``iprobe``/``recv``
with deferred lists (``ghs_implementation_mpi.py:94-115,696-701``) — are both
sources of nondeterminism and the reason its liveness heuristics exist. This
transport is a single priority queue keyed ``(deliver_time, sequence)``:
identical runs deliver identical orders, deferred messages are redelivered at
a strictly later time, and quiescence (empty queue) is *exact* termination
detection — no idle counters, no polling (contrast
``ghs_implementation.py:442-526``).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.protocol.messages import Message

# Counter-track sampling period for the event bus (in drained events): dense
# enough for a timeline shape, cheap enough to leave on.
_SAMPLE_EVERY = 8192


class SimTransport:
    """Event-queue message delivery with per-hop latency.

    ``latency`` may be a constant or a ``(src, dst) -> int`` callable, letting
    tests model asymmetric links and delivery races deterministically.
    """

    def __init__(self, latency=1, *, defer_delay: int = 1, max_events: int = 50_000_000):
        self._queue: list = []
        self._seq = itertools.count()
        self._latency = latency if callable(latency) else (lambda s, d: latency)
        self._defer_delay = defer_delay
        self._max_events = max_events
        self.now = 0
        self.messages_sent = 0
        self.messages_deferred = 0
        # Bus totals already published for this transport, per counter name
        # (publishing folds in only the delta, so driving run() repeatedly
        # on one transport never double-counts).
        self._published: Dict[str, int] = {}

    def send(self, src: int, dst: int, msg: Message) -> None:
        self.messages_sent += 1
        when = self.now + max(1, self._latency(src, dst))
        heapq.heappush(self._queue, (when, next(self._seq), dst, msg))

    def run(self, nodes: Dict[int, "GHSNode"]) -> int:
        """Drain the queue to quiescence; returns events processed.

        The loop is shared with every transport subclass; the per-item
        semantics live in :meth:`_dispatch` (``ReliableTransport`` overrides
        it for its DATA/ACK/TIMER/LOCAL vocabulary).
        """
        processed = 0
        iterations = 0
        with BUS.span("protocol.run", cat="protocol", nodes=len(nodes)) as span:
            while self._queue:
                iterations += 1  # counts deferrals too: livelock trips the guard
                if iterations >= self._max_events:
                    raise RuntimeError(
                        f"protocol did not quiesce within {self._max_events} events"
                    )
                if iterations % _SAMPLE_EVERY == 0:
                    self._sample_counters()
                when, _, target, item = heapq.heappop(self._queue)
                self.now = max(self.now, when)
                processed += self._dispatch(nodes, target, item)
            span.set(events=iterations, sim_ticks=self.now)
            self._publish_counters()
        return processed

    def _dispatch(self, nodes, dst: int, msg: Message) -> int:
        """Handle one popped queue item; returns messages processed (0/1)."""
        if nodes[dst].handle(msg):
            return 1
        # Protocol-mandated deferral: redeliver strictly later.
        self.messages_deferred += 1
        heapq.heappush(
            self._queue,
            (self.now + self._defer_delay, next(self._seq), dst, msg),
        )
        return 0

    # -- observability -------------------------------------------------
    def _bus_counters(self) -> Dict[str, int]:
        """Channel totals this transport contributes to the event bus."""
        return {
            "protocol.messages_sent": self.messages_sent,
            "protocol.messages_deferred": self.messages_deferred,
        }

    def _sample_counters(self) -> None:
        """Timeline samples of this run's live totals (periodic, from run()).

        Samples carry the run-local value; the bus counter *totals* are only
        folded in once, at quiescence, by :meth:`_publish_counters`.
        """
        if not BUS.enabled:
            return
        for name, value in self._bus_counters().items():
            BUS.sample(name, value)

    def _publish_counters(self) -> None:
        """Fold this transport's totals into the bus counters at quiescence —
        delta-based, so repeated run() calls on one transport publish each
        message exactly once."""
        if not BUS.enabled:
            return
        for name, value in self._bus_counters().items():
            delta = value - self._published.get(name, 0)
            if delta:
                BUS.count(name, delta)
            self._published[name] = value
            BUS.sample(name, value)
