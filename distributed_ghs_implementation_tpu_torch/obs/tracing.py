"""Distributed trace context: one id that follows a request everywhere.

The obs bus (``obs/events.py``) is process-local by design — cheap tuples
in a ring, no cross-process anything. That was the right primitive, but the
system it instruments stopped being one process: a query enters the fleet
router, hops a TCP frame to a worker, may fail over to a second worker, may
commit a stream window whose WAL replay re-runs it on a *third* process
days later. This module is the missing join key: a context-local
:class:`TraceContext` minted at every front door (``serve_loop``,
``FleetRouter.handle``, stream publish) and re-established on the far side
of every hop, so every span the bus records — on any process — carries the
same 128-bit ``trace`` id plus a ``span``/``parent`` edge that the
multi-file merge (``obs.export.merge_trace_files``) can stitch back into
one tree.

Design rules:

* **Stdlib only, imports nothing from obs.** ``events.py`` imports this
  module (to stamp spans); the reverse edge would be a cycle.
* **Context-local, not thread-local.** ``contextvars`` propagates through
  the worker thread-pools the same way ``obs.slo.tagged_class`` does; a
  token-based activate/deactivate keeps nesting exception-safe.
* **Deterministic head sampling.** The keep/drop decision hashes the
  trace id against a seed (``GHS_TRACE_SEED``) and a rate
  (``GHS_TRACE_SAMPLE``, default 1.0) — every process computes the same
  answer for the same trace, and the decision ALSO rides the wire so a
  worker with a different env cannot half-sample a trace.
* **Wire shape is a plain dict** (``{"trace","span","sampled","cls"}``)
  carried as an optional ``trace`` field on fleet frames, journal accept
  records, and stream WAL entries — gated by hello ``caps.trace`` exactly
  like the round-19 CRC opt-in, so a legacy peer simply never sees it.

Span ids are 16 hex chars: a per-process random prefix (8 hex, fresh at
import) + a monotone counter — collision-safe across the fleet without
coordination, and cheap (no per-span ``urandom``).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import itertools
import os
import uuid
from typing import Any, Dict, Optional

__all__ = [
    "TraceContext",
    "current",
    "mint",
    "activate",
    "deactivate",
    "activated",
    "front_door",
    "push_child",
    "pop",
    "new_trace_id",
    "new_span_id",
    "head_sampled",
    "wire_context",
    "from_wire",
]


class TraceContext:
    """One request's identity at a point in the call tree.

    ``span_id`` is the id the *next* span should name as its parent —
    ``None`` at a fresh root, so the first span under a minted context
    records no ``parent`` and the merge sees a true root (never an
    orphan). ``sampled=False`` contexts still propagate (the decision is
    sticky) but stamp nothing.
    """

    __slots__ = ("trace_id", "span_id", "slo_class", "sampled")

    def __init__(
        self,
        trace_id: str,
        span_id: Optional[str] = None,
        slo_class: Optional[str] = None,
        sampled: bool = True,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.slo_class = slo_class
        self.sampled = sampled

    def child(self, span_id: str) -> "TraceContext":
        """The context spans nested under ``span_id`` should see."""
        return TraceContext(
            self.trace_id, span_id, self.slo_class, self.sampled
        )

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"TraceContext(trace={self.trace_id[:8]}..., "
            f"span={self.span_id}, cls={self.slo_class}, "
            f"sampled={self.sampled})"
        )


_current: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("ghs_trace_context", default=None)
)

# Per-process span-id prefix: 8 random hex chars fixed at import + an
# 8-hex monotone counter. Two processes share a prefix with p ~ 2^-32
# per pair — and even then ids only collide if the counters align.
_SPAN_PREFIX = os.urandom(4).hex()
_span_counter = itertools.count(1)


def new_trace_id() -> str:
    """A fresh 128-bit trace id (32 hex chars)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    return f"{_SPAN_PREFIX}{next(_span_counter) & 0xFFFFFFFF:08x}"


def head_sampled(trace_id: str) -> bool:
    """Deterministic head-sampling decision for ``trace_id``.

    ``GHS_TRACE_SAMPLE`` (default 1.0) is the keep rate;
    ``GHS_TRACE_SEED`` (default 0) salts the hash so operators can rotate
    which traces a low rate keeps without changing the rate. Every process
    with the same env computes the same answer — and the decision rides
    the wire anyway, so mixed-env fleets still agree per trace.
    """
    try:
        rate = float(os.environ.get("GHS_TRACE_SAMPLE", "1"))
    except ValueError:
        rate = 1.0
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    seed = os.environ.get("GHS_TRACE_SEED", "0")
    digest = hashlib.sha256(f"{seed}:{trace_id}".encode()).digest()
    u = int.from_bytes(digest[:8], "big") / 2.0**64
    return u < rate


def current() -> Optional[TraceContext]:
    return _current.get()


def mint(slo_class: Optional[str] = None) -> TraceContext:
    """A fresh root context (front doors only; hops use :func:`from_wire`)."""
    tid = new_trace_id()
    return TraceContext(tid, None, slo_class, head_sampled(tid))


def activate(ctx: Optional[TraceContext]) -> "contextvars.Token":
    return _current.set(ctx)


def deactivate(token: "contextvars.Token") -> None:
    _current.reset(token)


def push_child(ctx: TraceContext, span_id: str) -> "contextvars.Token":
    """Enter ``span_id``'s scope: spans opened until :func:`pop` parent it."""
    return _current.set(ctx.child(span_id))


def pop(token: "contextvars.Token") -> None:
    _current.reset(token)


@contextlib.contextmanager
def activated(ctx: Optional[TraceContext]):
    """Run a block under ``ctx``; a no-op when ``ctx`` is None (so callers
    can pass ``from_wire(frame.get("trace"))`` unconditionally)."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextlib.contextmanager
def front_door(slo_class: Optional[str] = None):
    """A request entry point: reuse the active context when one exists
    (a fleet worker re-established the router's), else mint a root.

    The reuse rule is what makes nesting front doors safe — the stream
    ``publish`` door inside a traced ``serve.request`` joins that trace
    instead of forking a new one.
    """
    ctx = _current.get()
    if ctx is not None:
        yield ctx
        return
    ctx = mint(slo_class)
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def wire_context() -> Optional[Dict[str, Any]]:
    """The active context as a frame/journal/WAL field, or None when
    there is nothing worth carrying (no context, or head-sampled out)."""
    ctx = _current.get()
    if ctx is None or not ctx.sampled:
        return None
    wire: Dict[str, Any] = {"trace": ctx.trace_id, "sampled": True}
    if ctx.span_id is not None:
        wire["span"] = ctx.span_id
    if ctx.slo_class is not None:
        wire["cls"] = ctx.slo_class
    return wire


def from_wire(wire: Any) -> Optional[TraceContext]:
    """Rebuild a context from a wire dict; tolerant of absence/garbage
    (returns None, the untraced path) so legacy peers cost nothing."""
    if not isinstance(wire, dict):
        return None
    tid = wire.get("trace")
    if not isinstance(tid, str) or not tid:
        return None
    span = wire.get("span")
    return TraceContext(
        tid,
        span if isinstance(span, str) else None,
        wire.get("cls"),
        bool(wire.get("sampled", True)),
    )
