"""Process-local structured event bus: spans, counters, histograms.

The reference's only observability was print-narration (per-message logs at
``ghs_implementation_mpi.py:100-113``) — which is exactly what let its
silent-wrong-MST failures go unnoticed. This bus is the opposite design
point: one process-wide sink of *typed* telemetry cheap enough to stay on in
production, drained by exporters (``obs.export``) into Chrome-trace JSON,
JSONL event logs, and plain-text stats.

Cost model:

* **Disabled** (``GHS_OBS=0`` or :meth:`EventBus.disable`): every emission
  is one attribute check; :meth:`EventBus.span` returns a module-level
  singleton, so the hot path allocates nothing.
* **Enabled**: events land in a fixed-capacity ring buffer as plain tuples
  (no dict/object per event); serialization happens only at export time.
  Overflow overwrites the oldest events and counts them in
  :attr:`EventBus.dropped` — memory is bounded no matter how long the
  process runs. Counters and histograms are O(1) aggregates outside the
  ring, so totals survive overflow.

Event taxonomy (names are dotted, ``docs/OBSERVABILITY.md`` has the full
registry): ``solver.*`` (level/chunk kernels), ``protocol.*`` (message
transport + reliable sublayer), ``resilience.*`` (supervisor attempts,
degradations), ``parallel.*`` (sharded staging/collectives), ``trace.*``
(CLI session phases), ``metrics.*`` (per-level fragment census),
``serve.*`` (query service: cache hits/misses, single-flight coalescing,
queue-depth samples, incremental-vs-resolve update routing).

Names this package emits beyond that registry, all from the rank route:

* ``solver.prep`` (span: ``family``, ``route`` ``l2``/``filtered``/``full``,
  ``m_pad``, ``cpu_s``) over the prep's steps ``solver.prep.rank_order``
  (``where="device"``; ``key``, the key K7 sorted: ``int32`` for integer
  weights within 2^22 values, after their device minimum and maximum,
  ``int64`` for wider integers, ``float64``; ``passes``, its digit
  passes), ``.endpoints``, ``.stage`` (one pinned copy issued: ``bytes``,
  ``pin_s``), ``.first_ranks``, ``.level1`` and ``.copy_wait``, each with
  ``cpu_s``, the process's CPU seconds over it (level 2 runs in the
  solve's head). The steps that run on the device say so (``on="device"``:
  ``.rank_order``, ``.endpoints``, ``.first_ranks``, ``.level1``); each
  closes after a device synchronize, so it holds the device's time. The
  counter ``solver.stage.h2d_bytes`` (bytes staged, its total also sampled
  on the timeline at each copy), and ``kernels.rank_order.passes`` (the
  prep's K7 digit passes, as its span's ``passes``; its total sampled on
  the timeline at each rank order).
* ``solver.rank.solve`` gains ``route``, the route that answered; its phases
  ``solver.rank.head``, ``solver.rank.finish`` (``phase``
  ``prefix``/``survivors``/``staged``, ``step``), ``solver.rank.filter``
  (``steps``) and ``solver.rank.replay`` (``stages``, ``on="device"``: the
  vertex relabel after a shrink chain, closed after a device synchronize).
  The counter ``solver.rank.host_reads`` (one a host read of the solve's
  small device tensors, its total sampled on the timeline at each read).
* ``solver.harvest`` (span: ``forest_edges``) and ``api.components`` (span:
  ``components``, ``method``: ``mask``, the presence mask's linear pass, or
  ``unique``, the sort). The counter ``api.components.masked`` (one a count
  by the mask, its total sampled on the timeline at each).

:meth:`EventBus.perf_counter_s` puts a stamp on the host's
``time.perf_counter`` clock.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from distributed_ghs_implementation_tpu_torch.obs import tracing

# Chrome-trace phase codes carried on every record (export stays a rename).
PH_COMPLETE = "X"  # span with a duration
PH_INSTANT = "I"  # point event
PH_COUNTER = "C"  # counter sample on a timeline track

# Record layout (plain tuple — cheap to emit, lazy to serialize):
#   (ph, name, cat, ts_ns, dur_ns, tid, args_dict_or_None)
EventTuple = Tuple[str, str, str, int, int, int, Optional[Dict[str, Any]]]

_HIST_SAMPLE_CAP = 512  # bounded per-histogram reservoir for percentiles
_HIST_SEED = 0x5EED  # fixed reservoir seed: summaries are run-reproducible


def quantile(
    samples: Sequence[float], p: float, *, presorted: bool = False
) -> float:
    """Nearest-rank quantile of a sample sequence.

    The ONE quantile rule every percentile in the repo uses — histogram
    summaries, the SLO accounting layer (``obs.slo``), and ``bench.py``'s
    warm-latency metrics — so a p99 in one report is comparable to a p99
    in another. Empty input returns 0.0 (a report field, not an error).
    ``presorted=True`` skips the sort for callers taking several quantiles
    of one sample set.
    """
    if not samples:
        return 0.0
    xs = samples if presorted else sorted(samples)
    return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]


class _NullSpan:
    """The disabled-mode span: a reusable, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle; records one ``PH_COMPLETE`` event on exit.

    When a :mod:`obs.tracing` context is active (and sampled), entering
    the span stamps ``trace``/``span``/``parent`` ids into its args and
    pushes itself as the context's parent, so spans opened inside —
    including on other processes that re-establish the context from the
    wire — chain to it. Untraced code pays one contextvar read. With
    ``cpu`` the span also carries ``cpu_s``: the process's CPU seconds
    over it (``time.process_time()``, every thread).
    """

    __slots__ = ("_bus", "name", "cat", "args", "_t0", "_c0", "_trace_token")

    def __init__(self, bus: "EventBus", name: str, cat: str, args: dict, cpu: bool = False):
        self._bus = bus
        self.name = name
        self.cat = cat
        self.args = args or None
        self._c0 = time.process_time() if cpu else None
        self._t0 = bus.now_ns()
        self._trace_token = None

    def set(self, **args) -> "_Span":
        """Attach arguments discovered mid-span (e.g. a resolved strategy)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)
        return self

    def __enter__(self) -> "_Span":
        ctx = tracing.current()
        if ctx is not None and ctx.sampled:
            span_id = tracing.new_span_id()
            if self.args is None:
                self.args = {}
            self.args["trace"] = ctx.trace_id
            self.args["span"] = span_id
            if ctx.span_id is not None:
                self.args["parent"] = ctx.span_id
            self._trace_token = tracing.push_child(ctx, span_id)
        return self

    def __exit__(self, *exc) -> bool:
        bus = self._bus
        dur_ns = bus.now_ns() - self._t0
        if self._c0 is not None:
            self.set(cpu_s=time.process_time() - self._c0)
        if self._trace_token is not None:
            tracing.pop(self._trace_token)
            self._trace_token = None
        bus._append(
            (
                PH_COMPLETE,
                self.name,
                self.cat,
                self._t0,
                dur_ns,
                threading.get_ident(),
                self.args,
            )
        )
        return False


class _Hist:
    """Running aggregate + bounded uniform reservoir (percentiles stay
    O(cap) in memory and unbiased over arbitrarily long runs).

    The previous implementation overwrote the 512-sample buffer
    round-robin — a sliding window of *recent* values, which skews long-run
    tail quantiles toward whatever the process did last (a load drill's
    p99 would forget its own warm phase). Algorithm R reservoir sampling
    keeps each of the ``count`` observations in the sample set with equal
    probability ``cap/count``; the RNG is seeded per histogram, so two runs
    over the same observation sequence summarize identically.
    """

    __slots__ = ("count", "total", "vmin", "vmax", "samples", "_rng")

    def __init__(self, seed: int = _HIST_SEED):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if len(self.samples) < _HIST_SAMPLE_CAP:
            self.samples.append(value)
        else:  # Algorithm R: keep with probability cap/count, evict uniform
            j = self._rng.randrange(self.count)
            if j < _HIST_SAMPLE_CAP:
                self.samples[j] = value

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        s = sorted(self.samples)
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": quantile(s, 0.50, presorted=True),
            "p90": quantile(s, 0.90, presorted=True),
            "p95": quantile(s, 0.95, presorted=True),
            "p99": quantile(s, 0.99, presorted=True),
        }


def merge_hists(raws: Sequence[dict]) -> _Hist:
    """Deterministic merge of raw reservoir exports into one :class:`_Hist`.

    ``raws`` are :meth:`EventBus.histograms_export` values for ONE metric
    across N processes, in a caller-stabilized order (the pulse sorts by
    worker id). Count/sum/min/max merge exactly; the merged reservoir is a
    count-weighted with-replacement draw from the per-process reservoirs
    under the same fixed seed every histogram uses — so two pulses over
    identical worker exports summarize byte-for-byte identically, and a
    big worker's tail outweighs a small one's in the merged p99.
    """
    merged = _Hist()
    pools = [
        r for r in raws
        if r and int(r.get("count", 0)) > 0 and r.get("samples")
    ]
    if not pools:
        return merged
    merged.count = sum(int(r["count"]) for r in pools)
    merged.total = float(sum(float(r.get("sum", 0.0)) for r in pools))
    merged.vmin = min(float(r["min"]) for r in pools)
    merged.vmax = max(float(r["max"]) for r in pools)
    concat = [float(s) for r in pools for s in r["samples"]]
    if len(concat) <= _HIST_SAMPLE_CAP:
        merged.samples = concat
        return merged
    rng = random.Random(_HIST_SEED)
    weights = [int(r["count"]) for r in pools]
    total_weight = sum(weights)
    for _ in range(_HIST_SAMPLE_CAP):
        x = rng.randrange(total_weight)
        for r, w in zip(pools, weights):
            if x < w:
                samples = r["samples"]
                merged.samples.append(
                    float(samples[rng.randrange(len(samples))])
                )
                break
            x -= w
    return merged


class EventBus:
    """Fixed-memory structured telemetry sink (see module docstring).

    All mutators are safe under CPython's GIL for the access patterns here
    (single-writer per thread; the ring index is guarded by a lock because
    two threads CAN interleave an append).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._buf: List[Optional[EventTuple]] = [None] * capacity
        self._write = 0  # monotone count of events ever appended
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}
        self._epoch_ns = time.perf_counter_ns()

    # -- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop all events, counters, and histograms; restart the clock."""
        with self._lock:
            self._buf = [None] * self.capacity
            self._write = 0
            self._counters = {}
            self._hists = {}
            self._epoch_ns = time.perf_counter_ns()

    def now_ns(self) -> int:
        """Nanoseconds since this bus's epoch (clear() resets it)."""
        return time.perf_counter_ns() - self._epoch_ns

    def perf_counter_s(self, ts_ns: int) -> float:
        """An event timestamp of this bus (:meth:`now_ns`) on the host's
        ``time.perf_counter`` clock, in seconds: the clock a caller's own
        spans, and a profiler trace anchored to it, are on."""
        return (ts_ns + self._epoch_ns) * 1e-9

    def epoch_unix_ns(self) -> int:
        """The bus epoch as a wall-clock unix timestamp (ns) — the anchor
        the multi-file trace merge uses to align per-process monotonic
        timelines onto one axis. Derived at call time (wall clock minus
        elapsed monotonic), so it is stable to ~scheduler noise, which is
        plenty for cross-process flow arrows."""
        return time.time_ns() - (time.perf_counter_ns() - self._epoch_ns)

    # -- emission ------------------------------------------------------
    def _append(self, rec: EventTuple) -> None:
        with self._lock:
            self._buf[self._write % self.capacity] = rec
            self._write += 1

    def span(self, name: str, cat: str = "app", *, cpu: bool = False, **args):
        """Context manager timing a region; no-op singleton when disabled.
        ``cpu=True`` adds the process's CPU seconds over the region as
        ``cpu_s`` (read only when enabled)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args, cpu)

    def complete(
        self,
        name: str,
        dur_s: float,
        cat: str = "app",
        ts_ns: Optional[int] = None,
        **args,
    ) -> None:
        """Record an already-measured span (duration in seconds)."""
        if not self.enabled:
            return
        dur_ns = int(dur_s * 1e9)
        if ts_ns is None:
            ts_ns = self.now_ns() - dur_ns
        ctx = tracing.current()
        if ctx is not None and ctx.sampled:
            args = dict(args)
            args["trace"] = ctx.trace_id
            args["span"] = tracing.new_span_id()
            if ctx.span_id is not None:
                args["parent"] = ctx.span_id
        self._append(
            (PH_COMPLETE, name, cat, ts_ns, dur_ns,
             threading.get_ident(), args or None)
        )

    def instant(self, name: str, cat: str = "app", **args) -> None:
        if not self.enabled:
            return
        self._append(
            (PH_INSTANT, name, cat, self.now_ns(), 0,
             threading.get_ident(), args or None)
        )

    def count(self, name: str, value: float = 1) -> None:
        """Accumulate a counter total (O(1); survives ring overflow)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter_sample(self, name: str, cat: str = "counter") -> None:
        """Drop a timeline sample of ``name``'s current total into the ring."""
        if not self.enabled:
            return
        self.sample(name, self._counters.get(name, 0), cat=cat)

    def sample(self, name: str, value: float, cat: str = "counter") -> None:
        """Drop an explicit-value sample onto counter track ``name``
        (used for run-local live values, e.g. a transport mid-drain)."""
        if not self.enabled:
            return
        self._append(
            (PH_COUNTER, name, cat, self.now_ns(), 0,
             threading.get_ident(), {"value": value})
        )

    def record(self, name: str, value: float) -> None:
        """Add one observation to histogram ``name``."""
        if not self.enabled:
            return
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Hist()
            hist.add(value)

    # -- reading -------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events overwritten by ring overflow (totals are unaffected)."""
        return max(0, self._write - self.capacity)

    def mark(self) -> int:
        """Position token for :meth:`events_since` (monotone event count)."""
        return self._write

    def events(self) -> List[EventTuple]:
        """Retained events, oldest first."""
        return self.events_since(0)

    def events_since(self, mark: int) -> List[EventTuple]:
        """Events appended at/after ``mark`` that are still retained."""
        with self._lock:
            write = self._write
            start = max(mark, write - self.capacity, 0)
            return [
                self._buf[i % self.capacity]  # type: ignore[misc]
                for i in range(start, write)
            ]

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    def histograms(self) -> Dict[str, dict]:
        return {name: h.summary() for name, h in self._hists.items()}

    def histograms_export(self) -> Dict[str, dict]:
        """Raw reservoir export (count/sum/min/max/samples) — the shape a
        worker ships in its ``stats`` reply so the router-side pulse can
        re-merge fleet-wide percentiles via :func:`merge_hists` instead of
        averaging per-worker p99s (which is statistically meaningless)."""
        with self._lock:
            return {
                name: {
                    "count": h.count,
                    "sum": h.total,
                    "min": h.vmin,
                    "max": h.vmax,
                    "samples": list(h.samples),
                }
                for name, h in self._hists.items()
                if h.count
            }

    def snapshot(self) -> dict:
        """Aggregated view: span stats by name, counter totals, histograms.

        This is the machine-readable summary behind ``stats`` and the bench
        gate — everything in it is derivable offline from the JSONL export
        (``obs.export.snapshot_from_jsonl`` rebuilds the same shape through
        the shared :func:`aggregate_span_stats`).
        """
        events = self.events()
        spans, instants = aggregate_span_stats(
            (rec[0], rec[1], rec[4] / 1e9) for rec in events
        )
        return {
            "schema": "ghs-obs-snapshot-v1",
            "spans": spans,
            "instants": instants,
            "counters": self.counters(),
            "histograms": self.histograms(),
            "events_retained": len(events),
            "events_dropped": self.dropped,
        }


def aggregate_span_stats(triples) -> Tuple[Dict[str, dict], Dict[str, int]]:
    """Fold ``(ph, name, dur_s)`` triples into the snapshot's span/instant
    tables — the ONE aggregation both the live bus and the JSONL reader use,
    so ``stats`` renders identically from either source."""
    spans: Dict[str, dict] = {}
    instants: Dict[str, int] = {}
    for ph, name, dur_s in triples:
        if ph == PH_COMPLETE:
            agg = spans.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += dur_s
            if dur_s > agg["max_s"]:
                agg["max_s"] = dur_s
        elif ph == PH_INSTANT:
            instants[name] = instants.get(name, 0) + 1
    for agg in spans.values():
        agg["mean_s"] = agg["total_s"] / agg["count"]
    return spans, instants


def _default_bus() -> EventBus:
    capacity = int(os.environ.get("GHS_OBS_CAPACITY", "65536"))
    enabled = os.environ.get("GHS_OBS", "1") != "0"
    return EventBus(capacity=capacity, enabled=enabled)


#: The process-global bus every instrumented layer emits to. Import the
#: MODULE-level accessor (``get_bus()``) or this name directly; tests swap
#: state via ``BUS.clear()`` / ``BUS.disable()`` rather than rebinding.
BUS = _default_bus()


def get_bus() -> EventBus:
    return BUS
