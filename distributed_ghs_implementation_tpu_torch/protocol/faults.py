"""Lossy channels and reliable delivery for the protocol transport.

The reference is only *probabilistically* live: its requeue caps, forced
merges, and idle-based termination exist to escape hangs that appear under
nondeterministic timing (SURVEY.md preamble), and they are exactly what makes
it wrong under adversity. This module attacks the problem from the other
side: make the channel *adversarial on purpose* and make correctness a
theorem again.

Two layers:

* :class:`FaultyTransport` — a :class:`SimTransport` whose channel drops,
  duplicates, and reorders transmissions, driven by a seeded RNG
  (:class:`FaultSpec`), so every failure scenario replays bit-identically.
  Under the raw GHS protocol a single dropped CONNECT either truncates the
  MST or livelocks a deferral cycle (caught by the ``max_events`` guard) —
  which is the demonstration that the reference's heuristics cannot be
  patched into safety.
* :class:`ReliableTransport` — the same lossy channel with a reliable
  in-order delivery sublayer on top: per-directed-link sequence numbers,
  positive acks, retransmit timers with capped exponential backoff, and
  duplicate suppression. GHS assumes reliable FIFO links; this layer restores
  that assumption over any loss rate < 1, so ``run_protocol`` reaches exact
  quiescence with the oracle MST no matter what the fault spec does.
  ``utils/chaos.py`` sweeps the matrix.

Everything is deterministic: the event loop is a single priority queue and
fault draws happen in event order, so (graph, spec, latency) fully determine
the run.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Dict, Tuple

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.protocol.messages import Message
from distributed_ghs_implementation_tpu_torch.protocol.transport import SimTransport


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded channel misbehavior, applied independently per transmission.

    ``drop``/``duplicate``/``reorder`` are probabilities; a reordered
    (or duplicated) transmission is delayed by 1..``max_jitter`` extra ticks,
    which lets later sends overtake it — genuine reordering, not just
    latency. ``seed`` makes the whole fault schedule replayable.
    """

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    max_jitter: int = 16
    seed: int = 0

    def __post_init__(self):
        for name in ("drop", "duplicate", "reorder"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if self.max_jitter < 1:
            raise ValueError(f"max_jitter must be >= 1, got {self.max_jitter}")

    @property
    def is_clean(self) -> bool:
        return self.drop == 0.0 and self.duplicate == 0.0 and self.reorder == 0.0


class FaultyTransport(SimTransport):
    """Event-queue transport whose channel misbehaves per a :class:`FaultSpec`.

    Counters (``dropped``/``duplicated``/``jittered``) record what the
    channel actually did, so tests can assert a scenario genuinely exercised
    the fault path rather than passing vacuously.
    """

    def __init__(self, spec: FaultSpec = FaultSpec(), latency=1, **kwargs):
        super().__init__(latency, **kwargs)
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self.dropped = 0
        self.duplicated = 0
        self.jittered = 0

    def _delivery_times(self, base: int) -> list:
        """Fault-adjusted arrival times for one transmission (empty = lost)."""
        rng, spec = self._rng, self.spec
        if spec.drop and rng.random() < spec.drop:
            self.dropped += 1
            return []
        when = base
        if spec.reorder and rng.random() < spec.reorder:
            self.jittered += 1
            when = base + rng.randint(1, spec.max_jitter)
        times = [when]
        if spec.duplicate and rng.random() < spec.duplicate:
            self.duplicated += 1
            times.append(base + rng.randint(1, spec.max_jitter))
        return times

    def send(self, src: int, dst: int, msg: Message) -> None:
        self.messages_sent += 1
        base = self.now + max(1, self._latency(src, dst))
        for when in self._delivery_times(base):
            heapq.heappush(self._queue, (when, next(self._seq), dst, msg))

    def _bus_counters(self) -> Dict[str, int]:
        counters = super()._bus_counters()
        counters.update(
            {
                "protocol.drops_injected": self.dropped,
                "protocol.duplicates_injected": self.duplicated,
                "protocol.reorders_injected": self.jittered,
            }
        )
        return counters


# Wire/loop items for ReliableTransport. DATA and ACK cross the lossy
# channel; TIMER and LOCAL are node-local bookkeeping events and bypass it.
@dataclasses.dataclass(frozen=True)
class _Data:
    src: int
    seq_no: int
    payload: Message


@dataclasses.dataclass(frozen=True)
class _Ack:
    src: int  # the data *receiver* acking back
    seq_no: int


@dataclasses.dataclass(frozen=True)
class _Timer:
    dst: int  # peer the unacked data was sent to (event target = the sender)
    seq_no: int
    attempt: int


@dataclasses.dataclass(frozen=True)
class _Local:
    payload: Message  # protocol-deferred message awaiting redelivery


class ReliableTransport(FaultyTransport):
    """Reliable in-order delivery over the lossy channel.

    Per directed link ``(src, dst)``: the sender stamps consecutive sequence
    numbers and keeps every message until acked, retransmitting on a timer
    whose period doubles from ``rto`` up to ``rto_cap``; the receiver acks
    every receipt (so a lost ack is healed by the next retransmit),
    suppresses duplicates by sequence number, and releases messages to the
    node strictly in order through a reorder buffer.

    ``max_retries=None`` retries forever — delivery is then guaranteed for
    any ``drop < 1`` and quiescence stays exact (all timers die once acked).
    A finite ``max_retries`` models a link declared dead: the run raises
    ``RuntimeError`` instead of silently computing a wrong forest.

    Protocol-level deferral (``handle`` returning ``False``) is unchanged:
    the payload is redelivered locally at ``defer_delay`` later, exactly as
    ``SimTransport`` does — reliability is a sublayer below the protocol's
    own semantics, not a change to them.
    """

    def __init__(
        self,
        spec: FaultSpec = FaultSpec(),
        latency=1,
        *,
        defer_delay: int = 1,
        max_events: int = 50_000_000,
        rto: int = 8,
        rto_cap: int = 256,
        max_retries: int | None = None,
    ):
        if spec.drop >= 1.0:
            raise ValueError("drop=1.0 severs every link; no reliable layer helps")
        super().__init__(
            spec, latency, defer_delay=defer_delay, max_events=max_events
        )
        self._rto = rto
        self._rto_cap = rto_cap
        self._max_retries = max_retries
        # Sender state, keyed by directed link (src, dst).
        self._next_seq: Dict[Tuple[int, int], int] = {}
        self._unacked: Dict[Tuple[int, int], Dict[int, Message]] = {}
        # Receiver state, keyed by directed link (src, dst).
        self._expected: Dict[Tuple[int, int], int] = {}
        self._rx_buffer: Dict[Tuple[int, int], Dict[int, Message]] = {}
        self.retransmits = 0
        self.acks_sent = 0
        self.dup_suppressed = 0
        # Ack latency (sim ticks, first send -> first ack per sequence).
        self._sent_at: Dict[Tuple[Tuple[int, int], int], int] = {}
        self.ack_latency_count = 0
        self.ack_latency_sum = 0
        self.ack_latency_max = 0

    # ------------------------------------------------------------------
    def _push(self, when: int, target: int, item) -> None:
        heapq.heappush(self._queue, (when, next(self._seq), target, item))

    def _transmit(self, src: int, dst: int, item) -> None:
        """One trip across the lossy channel (DATA and ACK both ride it)."""
        base = self.now + max(1, self._latency(src, dst))
        for when in self._delivery_times(base):
            self._push(when, dst, item)

    def send(self, src: int, dst: int, msg: Message) -> None:
        self.messages_sent += 1
        link = (src, dst)
        seq_no = self._next_seq.get(link, 0)
        self._next_seq[link] = seq_no + 1
        self._unacked.setdefault(link, {})[seq_no] = msg
        self._sent_at[(link, seq_no)] = self.now
        self._transmit(src, dst, _Data(src, seq_no, msg))
        self._push(self.now + self._rto, src, _Timer(dst, seq_no, 1))

    # ------------------------------------------------------------------
    def _dispatch(self, nodes, target: int, item) -> int:
        """The reliable layer's event vocabulary, under the shared run loop."""
        if isinstance(item, _Data):
            return self._on_data(nodes, target, item)
        if isinstance(item, _Ack):
            self._on_ack(target, item)
            return 0
        if isinstance(item, _Timer):
            self._on_timer(target, item)
            return 0
        if isinstance(item, _Local):
            return self._deliver(nodes, target, item.payload)
        # A raw Message cannot appear: send() always wraps.
        raise AssertionError(f"unexpected event item {item!r}")

    def _on_ack(self, owner: int, ack: "_Ack") -> None:
        link = (owner, ack.src)
        if self._unacked.get(link, {}).pop(ack.seq_no, None) is None:
            return  # duplicate ack: already settled
        sent = self._sent_at.pop((link, ack.seq_no), None)
        if sent is not None:
            latency = self.now - sent
            self.ack_latency_count += 1
            self.ack_latency_sum += latency
            if latency > self.ack_latency_max:
                self.ack_latency_max = latency
            BUS.record("protocol.ack_latency_ticks", latency)

    def _on_data(self, nodes, dst: int, data: _Data) -> int:
        link = (data.src, dst)
        # Ack unconditionally — duplicates re-ack so a lost ack cannot wedge
        # the sender into retransmitting forever.
        self.acks_sent += 1
        self._transmit(dst, data.src, _Ack(dst, data.seq_no))
        expected = self._expected.get(link, 0)
        buf = self._rx_buffer.setdefault(link, {})
        if data.seq_no < expected or data.seq_no in buf:
            self.dup_suppressed += 1
            return 0
        buf[data.seq_no] = data.payload
        handled = 0
        while expected in buf:
            handled += self._deliver(nodes, dst, buf.pop(expected))
            expected += 1
        self._expected[link] = expected
        return handled

    def _deliver(self, nodes, dst: int, payload: Message) -> int:
        if nodes[dst].handle(payload):
            return 1
        self.messages_deferred += 1
        self._push(self.now + self._defer_delay, dst, _Local(payload))
        return 0

    def _on_timer(self, owner: int, timer: _Timer) -> None:
        link = (owner, timer.dst)
        msg = self._unacked.get(link, {}).get(timer.seq_no)
        if msg is None:
            return  # acked in the meantime; the timer chain dies here
        if self._max_retries is not None and timer.attempt > self._max_retries:
            raise RuntimeError(
                f"link {link} seq {timer.seq_no}: gave up after "
                f"{self._max_retries} retransmits (drop={self.spec.drop})"
            )
        self.retransmits += 1
        self._transmit(owner, timer.dst, _Data(owner, timer.seq_no, msg))
        backoff = min(self._rto << timer.attempt, self._rto_cap)
        self._push(
            self.now + backoff, owner, _Timer(timer.dst, timer.seq_no, timer.attempt + 1)
        )

    def _bus_counters(self) -> Dict[str, int]:
        counters = super()._bus_counters()
        counters.update(
            {
                "protocol.retransmits": self.retransmits,
                "protocol.acks_sent": self.acks_sent,
                "protocol.dup_suppressed": self.dup_suppressed,
            }
        )
        return counters

    @property
    def stats(self) -> dict:
        """Channel + reliability counters, for reports and assertions."""
        return {
            "messages_sent": self.messages_sent,
            "messages_deferred": self.messages_deferred,
            "dropped": self.dropped,
            "duplicated": self.duplicated,
            "jittered": self.jittered,
            "retransmits": self.retransmits,
            "acks_sent": self.acks_sent,
            "dup_suppressed": self.dup_suppressed,
            "ack_latency_ticks": {
                "count": self.ack_latency_count,
                "mean": (
                    self.ack_latency_sum / self.ack_latency_count
                    if self.ack_latency_count
                    else 0.0
                ),
                "max": self.ack_latency_max,
            },
        }
