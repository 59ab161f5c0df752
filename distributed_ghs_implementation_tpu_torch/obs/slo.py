"""Per-class SLO accounting: join the obs event stream into a latency report.

Every request the serving stack answers is tagged with a **query class** —
``hit`` / ``miss`` / ``batch`` / ``dup`` / ``update`` / ``oversize`` / ...
are the load-drill deck's classes, but the label is an open string. The tag
travels two ways at once:

* as the ``cls`` argument on the ``serve.request`` (and nested
  ``serve.solve``) spans — this module *joins* those events back into
  per-class counts and latency reservoirs, so a report is derivable from a
  live bus **or** an exported JSONL log, and
* as a thread-scoped context tag (:func:`tagged_class` /
  :func:`current_class`) that layers below the service — the scheduler,
  the batch engine's forming queue — read to attribute their own telemetry
  (e.g. ``batch.queue.wait_s.<cls>``) without any API threading.

The output schema (``ghs-slo-summary-v1``) is shared by ALL drills
(``tools/load_drill.py``, ``tools/serve_drill.py``, ``tools/batch_drill.py``)
so their reports compare field-for-field: per class ``sent`` / ``ok`` /
``errors`` / ``shed`` counts, ``goodput_per_sec`` (ok-responses per wall
second), and ``latency_s`` / ``solve_s`` / ``queue_wait_s`` reservoirs
(p50/p95/p99 via the repo-wide nearest-rank :func:`obs.events.quantile`).
``latency_s`` minus ``solve_s`` is the scheduling/queueing overhead a
closed-loop micro-bench never sees; ``queue_wait_s`` narrows it to the
batch engine's forming queue when lanes are on. The ``stream.*`` taxonomy
joins the same way: a ``publish`` request's ``stream.window`` span (the
window apply + durable-log append + notification) surfaces as
``window_s`` under its class, so a report decomposes notification latency
into commit cost vs routing/queueing.

A summary computed while the ring overflowed is *flagged*
(``dropped_warning``) — span-derived per-class counts under-count once
events fall off the ring, and a drill must surface that, not report a
silently rosier p99. Counter/histogram-derived fields survive overflow.

:func:`gate_metrics` flattens a summary into the ``ghs-bench-metrics-v1``
shape ``tools/bench_gate.py`` already understands (``*_s`` wall-times,
``*_per_sec`` throughput floors, bare-name counts), which is how the
``gate-load-v1`` baseline (``docs/BENCH_BASELINE_LOAD.json``) gates p99 and
goodput regressions in CI. See ``docs/LOAD_TESTING.md``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterable, Optional

from distributed_ghs_implementation_tpu_torch.obs.events import (
    PH_COMPLETE,
    EventBus,
    _Hist,
)

SCHEMA = "ghs-slo-summary-v1"

#: Histogram-name prefix the batch engine uses for per-class forming-queue
#: wait (``batch.queue.wait_s.<cls>``); summaries attach these per class.
QUEUE_WAIT_PREFIX = "batch.queue.wait_s."

_current_class: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "ghs_slo_class", default=None
)


def current_class() -> Optional[str]:
    """The query class tag of the current request context (or ``None``)."""
    return _current_class.get()


def sanitize_class(cls) -> Optional[str]:
    """Normalize an untrusted ``slo_class`` label to a short, dotted-name-
    safe token (it is interpolated into bus histogram names downstream).
    The ONE sanitizer both the single-process service and the fleet router
    apply, so a class gated in one mode reports identically in the other."""
    if cls is None:
        return None
    return "".join(
        ch if ch.isalnum() or ch in "_-" else "_" for ch in str(cls)
    )[:32] or "untagged"


@contextlib.contextmanager
def tagged_class(cls: Optional[str]):
    """Scope the current thread of work to query class ``cls``.

    ``None`` is a no-op (untagged traffic stays untagged). Context-local,
    so concurrent request threads never see each other's tags.
    """
    if cls is None:
        yield
        return
    token = _current_class.set(str(cls))
    try:
        yield
    finally:
        _current_class.reset(token)


# -- query kinds -------------------------------------------------------------
#
# The analytics front door (``analytics/``) serves five query *kinds* over
# the same stack: ``mst`` (the default), ``components``, ``k_msf``,
# ``bottleneck``, ``path_max``. Each kind gets a default SLO class so a
# request that names a kind but no ``slo_class`` still lands in a stable,
# per-kind latency bucket (and picks up any per-class verify policy the
# operator configured). ``mst`` maps to ``None`` on purpose: pre-analytics
# traffic must keep its historical untagged telemetry shape.

KIND_CLASS_DEFAULTS: Dict[str, Optional[str]] = {
    "mst": None,
    "components": "components",
    "k_msf": "k_msf",
    "bottleneck": "bottleneck",
    "path_max": "path_max",
}


def default_class_for_kind(kind) -> Optional[str]:
    """Default SLO class for a query ``kind`` (``None`` for ``mst``/unknown)."""
    return KIND_CLASS_DEFAULTS.get(str(kind)) if kind is not None else None


_current_kind: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "ghs_query_kind", default=None
)


def current_kind() -> Optional[str]:
    """The query kind of the current request context (``None`` == ``mst``).

    Like :func:`current_class` this is a thread/context-scoped side channel:
    the batch engine snapshots it at submit time so forming lanes stay
    kind-homogeneous without threading a ``kind`` argument through the
    scheduler API.
    """
    return _current_kind.get()


@contextlib.contextmanager
def tagged_kind(kind: Optional[str]):
    """Scope the current thread of work to query kind ``kind`` (``None`` no-op)."""
    if kind is None:
        yield
        return
    token = _current_kind.set(str(kind))
    try:
        yield
    finally:
        _current_kind.reset(token)


class ClassStats:
    """Per-class accumulator: outcome counts + latency/solve reservoirs.

    Feed it either from the event stream (:func:`ingest_bus_events` /
    :func:`ingest_jsonl_events`) or directly from client-side measurements
    (:meth:`observe`, the subprocess drills' path — they cannot see the
    server's bus, only their own stopwatches). Both roads end in the same
    :func:`assemble` summary schema.
    """

    def __init__(self):
        self._classes: Dict[str, dict] = {}
        self._total_latency = _Hist()
        # worker id -> per-class accumulator (fleet mode: the router stamps
        # ``worker`` on fleet.request spans; empty in single-process runs).
        self._workers: Dict[str, "ClassStats"] = {}

    # -- recording -----------------------------------------------------
    def _entry(self, cls: str) -> dict:
        entry = self._classes.get(cls)
        if entry is None:
            entry = self._classes[cls] = {
                "sent": 0,
                "ok": 0,
                "errors": 0,
                "shed": 0,
                "latency": _Hist(),
                "solve": _Hist(),
                "queue_wait": _Hist(),
                "window": _Hist(),
            }
        return entry

    def observe(
        self,
        cls: str,
        latency_s: Optional[float] = None,
        *,
        ok: bool = True,
        shed: bool = False,
    ) -> None:
        """One finished (or shed) request of class ``cls``."""
        entry = self._entry(cls)
        entry["sent"] += 1
        if shed:
            entry["shed"] += 1
        elif ok:
            entry["ok"] += 1
        else:
            entry["errors"] += 1
        if latency_s is not None:
            entry["latency"].add(float(latency_s))
            self._total_latency.add(float(latency_s))

    def observe_solve(self, cls: str, dur_s: float) -> None:
        """Solver/scheduler time attributed to class ``cls`` (the
        ``serve.solve`` span — cache hits never record one)."""
        self._entry(cls)["solve"].add(float(dur_s))

    def observe_queue_wait(self, cls: str, dur_s: float) -> None:
        self._entry(cls)["queue_wait"].add(float(dur_s))

    def observe_window(self, cls: str, dur_s: float) -> None:
        """Stream window-commit time attributed to class ``cls`` (the
        ``stream.window`` span — the apply+log+notify cost of one window,
        nested inside its publish request's end-to-end latency)."""
        self._entry(cls)["window"].add(float(dur_s))

    def observe_worker(
        self,
        worker: str,
        cls: str,
        latency_s: Optional[float] = None,
        *,
        ok: bool = True,
        shed: bool = False,
    ) -> None:
        """The same observation, attributed to one fleet worker — the
        per-worker SLO breakdown a kill drill reads to show the degraded
        worker's latency apart from its healthy siblings'."""
        sub = self._workers.get(worker)
        if sub is None:
            sub = self._workers[worker] = ClassStats()
        sub.observe(cls, latency_s, ok=ok, shed=shed)

    # -- reading -------------------------------------------------------
    def classes(self):
        return sorted(self._classes)

    def class_summary(self, cls: str, wall_s: Optional[float]) -> dict:
        entry = self._classes[cls]
        out = {
            "sent": entry["sent"],
            "ok": entry["ok"],
            "errors": entry["errors"],
            "shed": entry["shed"],
            "goodput_per_sec": (
                entry["ok"] / wall_s if wall_s else None
            ),
            "latency_s": entry["latency"].summary(),
        }
        for field, key in (
            ("solve", "solve_s"),
            ("queue_wait", "queue_wait_s"),
            ("window", "window_s"),
        ):
            if entry[field].count:
                out[key] = entry[field].summary()
        return out

    def workers_summary(self, wall_s: Optional[float]) -> Dict[str, dict]:
        """Per-worker per-class summaries (empty unless fleet spans fed in)."""
        return {
            worker: {
                "classes": {
                    cls: sub.class_summary(cls, wall_s)
                    for cls in sub.classes()
                },
                "totals": sub.totals(wall_s),
            }
            for worker, sub in sorted(self._workers.items())
        }

    def totals(self, wall_s: Optional[float]) -> dict:
        sent = sum(e["sent"] for e in self._classes.values())
        ok = sum(e["ok"] for e in self._classes.values())
        return {
            "sent": sent,
            "ok": ok,
            "errors": sum(e["errors"] for e in self._classes.values()),
            "shed": sum(e["shed"] for e in self._classes.values()),
            "goodput_per_sec": ok / wall_s if wall_s else None,
            "latency_s": self._total_latency.summary(),
        }


# ----------------------------------------------------------------------
# Joining the event stream
# ----------------------------------------------------------------------
def _ingest(
    stats: ClassStats, ph: str, name: str, dur_s: float, args: Optional[dict]
) -> None:
    """One event into the accumulator. The join key is the ``cls`` span
    argument the service stamps on ``serve.request`` (outcome + end-to-end
    latency) and the scheduler propagates onto ``serve.solve`` (the
    miss-path solve/queue time nested inside that request). In fleet mode
    the router's ``fleet.request`` span plays the serve.request role — its
    latency additionally includes routing, queueing, pipe transport, and
    any failover re-queue — and its ``worker`` argument feeds the
    per-worker breakdown."""
    if ph != PH_COMPLETE or not args:
        return
    cls = args.get("cls")
    if cls is None:
        return
    if name in ("serve.request", "fleet.request"):
        ok = bool(args.get("ok", True))
        shed = bool(args.get("shed", False))
        stats.observe(str(cls), dur_s, ok=ok, shed=shed)
        worker = args.get("worker")
        if name == "fleet.request" and worker is not None:
            stats.observe_worker(str(worker), str(cls), dur_s, ok=ok, shed=shed)
    elif name == "serve.solve":
        stats.observe_solve(str(cls), dur_s)
    elif name == "stream.window":
        # The stream taxonomy's class-attributed span: publish requests
        # tag their class, the session layer stamps it on the window
        # commit, and the join exposes it as ``window_s`` — per-class
        # commit cost next to end-to-end publish latency.
        stats.observe_window(str(cls), dur_s)


def ingest_bus_events(stats: ClassStats, events: Iterable[tuple]) -> None:
    """Live-bus record tuples (``obs.events.EventTuple`` layout)."""
    for ph, name, _cat, _ts_ns, dur_ns, _tid, args in events:
        _ingest(stats, ph, name, dur_ns / 1e9, args)


def window_class_waits(events: Iterable[tuple]) -> Dict[str, list]:
    """Per-class request durations from one SLICE of live-bus events.

    The elastic autoscaler's breach signal (``fleet/autoscaler.py``): each
    control tick it reads the events appended since its last mark
    (``BUS.events_since``) and joins the same spans the SLO report joins —
    ``fleet.request`` in fleet mode, ``serve.request`` single-process — by
    their ``cls`` argument. Returning the raw duration lists (seconds, not
    a reservoir) keeps the tick-window p99 exact: a reservoir over the
    whole run would remember breaches long after they healed, and
    hysteresis needs a *recent* signal. Untagged requests don't feed the
    breach check — the budgets are per-class by design (an operator who
    wants a fleet-wide budget tags a fleet-wide class).
    """
    out: Dict[str, list] = {}
    for ph, name, _cat, _ts_ns, dur_ns, _tid, args in events:
        if ph != PH_COMPLETE or not args:
            continue
        if name not in ("fleet.request", "serve.request"):
            continue
        cls = args.get("cls")
        if cls is None:
            continue
        out.setdefault(str(cls), []).append(dur_ns / 1e9)
    return out


def ingest_jsonl_events(stats: ClassStats, events: Iterable[dict]) -> None:
    """Event dicts as parsed by ``obs.export.read_events_jsonl``."""
    for rec in events:
        _ingest(
            stats,
            rec.get("ph"),
            rec.get("name"),
            rec.get("dur_us", 0.0) / 1e6,
            rec.get("args"),
        )


def assemble(
    stats: ClassStats,
    *,
    wall_s: Optional[float] = None,
    histograms: Optional[dict] = None,
    events_dropped: int = 0,
    lines_skipped: int = 0,
) -> dict:
    """A ``ghs-slo-summary-v1`` dict from an accumulator (+ the bus's
    aggregate histograms, which survive ring overflow — per-class queue
    wait rides in as ``batch.queue.wait_s.<cls>``)."""
    histograms = histograms or {}
    classes = {}
    for cls in stats.classes():
        summary = stats.class_summary(cls, wall_s)
        queue_hist = histograms.get(QUEUE_WAIT_PREFIX + cls)
        if queue_hist and queue_hist.get("count"):
            summary["queue_wait_s"] = queue_hist
        classes[cls] = summary
    out = {
        "schema": SCHEMA,
        "wall_s": wall_s,
        "events_dropped": events_dropped,
        "dropped_warning": events_dropped > 0,
        "classes": classes,
        "totals": stats.totals(wall_s),
    }
    workers = stats.workers_summary(wall_s)
    if workers:
        out["workers"] = workers
    if lines_skipped:
        out["lines_skipped"] = lines_skipped
    return out


def summarize_bus(bus: EventBus, *, wall_s: Optional[float] = None) -> dict:
    """Join a live bus's retained events into the per-class summary."""
    stats = ClassStats()
    ingest_bus_events(stats, bus.events())
    return assemble(
        stats,
        wall_s=wall_s,
        histograms=bus.histograms(),
        events_dropped=bus.dropped,
    )


def summarize_jsonl(path: str, *, wall_s: Optional[float] = None) -> dict:
    """Same summary, rebuilt offline from an exported JSONL event log."""
    from distributed_ghs_implementation_tpu_torch.obs.export import read_events_jsonl

    events, meta = read_events_jsonl(path)
    stats = ClassStats()
    ingest_jsonl_events(stats, events)
    return assemble(
        stats,
        wall_s=wall_s,
        histograms=meta.get("histograms", {}),
        events_dropped=meta.get("events_dropped", 0),
        lines_skipped=meta.get("lines_skipped", 0),
    )


# ----------------------------------------------------------------------
# Bench-gate bridge
# ----------------------------------------------------------------------
def gate_metrics(
    summary: dict,
    *,
    workload: str,
    config: Optional[dict] = None,
    extra_metrics: Optional[dict] = None,
) -> dict:
    """Flatten an SLO summary into ``ghs-bench-metrics-v1`` for the gate.

    Per class: ``<cls>_p99_s`` (wall-time ceiling), ``<cls>_goodput_per_sec``
    (throughput floor), ``<cls>_errors`` / ``<cls>_shed`` (count ceilings —
    a zero baseline means ANY error fails). p50/p95 stay report-only: on
    shared CI runners sub-millisecond medians are nearly all scheduler
    noise, while the p99 tail and goodput are the SLO. ``extra_metrics``
    lets the drill add scenario-level facts (``lost_accepted`` gates
    exactly via ``bench_gate.KINDS``).
    """
    metrics: Dict[str, float] = {}
    for cls, c in summary.get("classes", {}).items():
        lat = c.get("latency_s") or {}
        if lat.get("count"):
            metrics[f"{cls}_p99_s"] = lat["p99"]
        if c.get("goodput_per_sec") is not None:
            metrics[f"{cls}_goodput_per_sec"] = c["goodput_per_sec"]
        metrics[f"{cls}_errors"] = c.get("errors", 0)
        metrics[f"{cls}_shed"] = c.get("shed", 0)
    totals = summary.get("totals", {})
    metrics["queries_sent"] = totals.get("sent", 0)
    if totals.get("goodput_per_sec") is not None:
        metrics["total_goodput_per_sec"] = totals["goodput_per_sec"]
    if extra_metrics:
        metrics.update(extra_metrics)
    return {
        "schema": "ghs-bench-metrics-v1",
        "config": {"workload": workload, **(config or {})},
        "metrics": metrics,
    }
