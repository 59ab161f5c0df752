"""Micro-batching solve scheduler: single-flight coalescing + admission bound.

Port of the JAX package's ``serve/scheduler.py``. The scheduler runs its
solves on one explicit device (``device=None`` means CUDA) through the
port's ``minimum_spanning_forest``. With a ``sharded_lane``
(``parallel.lane.ShardedLane``) oversize misses run on the mesh (the
``sharded_lane`` route); without one they take the ``bypass`` route.

Request handling for the serve path, in order:

1. **Cache probe** — ``ResultStore.get`` by content key; a hit never touches
   the solver (zero ``solver.*`` spans — the warm-path guarantee tests
   assert on bus events).
2. **Single-flight** — concurrent requests for the same key join the one
   in-flight solve instead of duplicating it (``serve.scheduler.coalesced``
   counts the joins). This is what keeps a thundering herd of identical
   queries at exactly one kernel dispatch.
3. **Admission bound** — distinct misses solve under a semaphore
   (``max_concurrent``); excess requests queue. ``serve.queue.depth`` is
   sampled on every transition so traces show pressure over time. With a
   batch engine attached the engine's own forming queue + serialized
   dispatch is the capacity bound instead (holding the semaphore while
   waiting for lane-mates would forbid the very coalescing the engine is
   for).
4. **Supervised solve** — every miss runs through the resilience
   supervisor (watchdog, bounded retry, the sharded->device->stepped->host
   degradation ladder), so one flaky device never fails a request that a
   degraded rung can still answer exactly. With a batch engine, device
   misses instead run the engine's batch-shaped supervision (batch retry,
   then per-lane ladder fallback — ``batch/engine.py``).

``solve_batch`` is the micro-batching entry: it dedups a whole request list
by key, registers ONE flight per distinct missed digest *before any solving
starts* (duplicates inside the batch — and concurrent ``solve`` callers —
join that flight instead of racing it), then solves the distinct misses as
a group: through the batch engine when attached (same-bucket misses share
device dispatches), else sequentially.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Sequence, Tuple

from distributed_ghs_implementation_tpu_torch.api import MSTResult, minimum_spanning_forest
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import current_class
from distributed_ghs_implementation_tpu_torch.serve.store import ResultStore, solve_cache_key


def _cls_args() -> dict:
    """The SLO class tag of the current request context, as span args —
    stamping it on ``serve.solve`` lets ``obs.slo`` decompose each class's
    end-to-end latency into solve time vs everything else."""
    cls = current_class()
    return {"cls": cls} if cls is not None else {}


class _Flight:
    """One in-flight solve; joiners block on ``event`` and read the outcome."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[MSTResult] = None
        self.error: Optional[BaseException] = None


class PriorityGate:
    """Two-class priority over the shared device: bulk yields to interactive.

    A bulk mesh solve (oversize → the sharded lane) is seconds of work; an
    interactive small-graph miss is milliseconds. Without priority, one
    RMAT-24 in flight starves every small query behind it. The gate is the
    minimal mechanism that prevents that:

    * interactive misses run inside :meth:`interactive` — a pending-count
      context the solve holds for its duration;
    * bulk solves call :meth:`checkpoint` between device dispatches (the
      stepped-solve boundaries ``parallel/lane.py`` exposes): while
      interactive work is pending, the bulk solve PAUSES — bounded by
      ``max_pause_s`` per checkpoint, so a steady interactive stream delays
      bulk work rather than deadlocking it.

    Telemetry: ``serve.gate.yields`` counts checkpoints that actually
    paused; ``serve.gate.bulk_pause_s`` records how long.
    """

    def __init__(self, max_pause_s: float = 5.0):
        self.max_pause_s = max_pause_s
        self._cv = threading.Condition()
        self._pending = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def interactive(self):
        with self._cv:
            self._pending += 1
        self._local.pending = getattr(self._local, "pending", 0) + 1
        try:
            yield
        finally:
            self._local.pending -= 1
            with self._cv:
                self._pending -= 1
                if self._pending <= 0:
                    self._cv.notify_all()

    def checkpoint(self) -> None:
        """Bulk-side yield point: wait out pending interactive work.

        Pending registrations held by THIS thread don't count: a solve
        that degrades to bulk from inside an interactive context (a
        stream window's resolve escape hatch routing to the sharded
        lane) must not wait out its own registration at every stepped
        boundary — it still yields to everyone else's.
        """
        own = getattr(self._local, "pending", 0)
        t0 = time.monotonic()
        with self._cv:
            while (
                self._pending > own
                and time.monotonic() - t0 < self.max_pause_s
            ):
                self._cv.wait(timeout=0.05)
        paused = time.monotonic() - t0
        if paused >= 0.002:
            BUS.count("serve.gate.yields")
            BUS.record("serve.gate.bulk_pause_s", paused)


class SolveScheduler:
    """Cache-fronted, single-flight, capacity-bounded solve dispatch."""

    def __init__(
        self,
        store: Optional[ResultStore] = None,
        *,
        backend: str = "device",
        max_concurrent: int = 2,
        supervisor_config=None,
        batch_engine=None,
        sharded_lane=None,
        device=None,
    ):
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1, got {max_concurrent}")
        self.device = resolve_device(device)
        self.store = store if store is not None else ResultStore()
        self.backend = backend
        self.batch_engine = batch_engine
        # sharded_lane (a parallel.lane.ShardedLane) opens the oversize
        # route: device-backend misses past the batch policy's admission
        # ceiling run on the mesh instead of bypassing to the semaphore
        # path, where one such solve would hold a max_concurrent slot for
        # seconds and starve interactive misses behind it.
        self.sharded_lane = sharded_lane
        self.gate = PriorityGate()
        self._supervisor_config = supervisor_config
        self._sem = threading.BoundedSemaphore(max_concurrent)
        self._flights: dict = {}
        self._lock = threading.Lock()
        # The oversize decision is the batch policy's admission rule even
        # when no engine is attached (one rule set, batch/policy.py).
        if batch_engine is not None:
            self._route_policy = batch_engine.policy
        else:
            from distributed_ghs_implementation_tpu_torch.batch.policy import (
                BatchPolicy,
            )

            self._route_policy = BatchPolicy()

    def solve(
        self, graph: Graph, *, backend: Optional[str] = None
    ) -> Tuple[MSTResult, str]:
        """Answer one solve request; returns ``(result, source)`` where
        ``source`` is ``"cache"`` / ``"coalesced"`` / ``"solved"``."""
        backend = backend or self.backend
        key = solve_cache_key(graph, backend=backend)
        cached = self.store.get(key, graph=graph)
        if cached is not None:
            return cached, "cache"

        flight, leader = self._join_or_lead(key)
        if not leader:
            BUS.count("serve.scheduler.coalesced")
            flight.event.wait()
            if flight.error is not None:
                raise flight.error
            return flight.result, "coalesced"

        try:
            # Double-check after winning leadership: a previous leader may
            # have published between our cache probe and the flight insert —
            # without this, that race re-solves an already-cached graph.
            cached = self.store.get(key, graph=graph, record_miss=False)
            if cached is not None:
                flight.result = cached
                return cached, "cache"
            flight.result = self._solve_miss(graph, backend)
            self.store.put(key, flight.result)
        except BaseException as e:
            flight.error = e
            raise
        finally:
            self._land(key, flight)
        return flight.result, "solved"

    def solve_batch(
        self, graphs: Sequence[Graph], *, backend: Optional[str] = None
    ) -> List[Tuple[MSTResult, str]]:
        """Solve a batch, deduplicating by content key first: duplicates
        inside the batch resolve against one flight (never race), and the
        distinct misses solve as a group (coalescing into device batches
        when the batch engine is attached)."""
        backend = backend or self.backend
        keys: List[str] = []
        unique: dict = {}
        for g in graphs:
            key = solve_cache_key(g, backend=backend)
            keys.append(key)
            if key in unique:
                BUS.count("serve.scheduler.coalesced")
            else:
                unique[key] = g

        outcome: dict = {}
        leaders: list = []  # (key, graph, flight)
        joiners: list = []  # (key, flight)
        for key, g in unique.items():
            cached = self.store.get(key, graph=g)
            if cached is not None:
                outcome[key] = (cached, "cache")
                continue
            flight, leader = self._join_or_lead(key)
            if leader:
                # Leadership double-check, as in solve().
                cached = self.store.get(key, graph=g, record_miss=False)
                if cached is not None:
                    flight.result = cached
                    self._land(key, flight)
                    outcome[key] = (cached, "cache")
                else:
                    leaders.append((key, g, flight))
            else:
                joiners.append((key, flight))

        if leaders:
            try:
                results = self._solve_misses(
                    [g for _, g, _ in leaders], backend
                )
            except BaseException as e:
                for key, _, flight in leaders:
                    flight.error = e
                    self._land(key, flight)
                raise
            try:
                for (key, _, flight), result in zip(leaders, results):
                    flight.result = result
                    self.store.put(key, result)
                    self._land(key, flight)
                    outcome[key] = (result, "solved")
            except BaseException as e:
                # A raise mid-publish (e.g. KeyboardInterrupt) must not
                # leak the remaining flights — a leaked flight blocks its
                # joiners forever. Land every unlanded leader (with its
                # result when the solve already succeeded).
                for key, _, flight in leaders:
                    if not flight.event.is_set():
                        if flight.result is None:
                            flight.error = e
                        self._land(key, flight)
                raise

        for key, flight in joiners:
            BUS.count("serve.scheduler.coalesced")
            flight.event.wait()
            if flight.error is not None:
                raise flight.error
            outcome[key] = (flight.result, "coalesced")

        out: List[Tuple[MSTResult, str]] = []
        first = set()
        for key in keys:
            result, source = outcome[key]
            out.append((result, source) if key not in first else (result, "coalesced"))
            first.add(key)
        return out

    # ------------------------------------------------------------------
    def _join_or_lead(self, key: str) -> Tuple[_Flight, bool]:
        """Atomically join the in-flight solve for ``key`` or become its
        leader; returns ``(flight, is_leader)``."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                return flight, False
            flight = self._flights[key] = _Flight()
            BUS.sample("serve.queue.depth", len(self._flights))
            return flight, True

    def _land(self, key: str, flight: _Flight) -> None:
        """Retire a flight and wake its joiners."""
        with self._lock:
            del self._flights[key]
            BUS.sample("serve.queue.depth", len(self._flights))
        flight.event.set()

    def _route(self, graph: Graph, backend: str) -> str:
        """One solve's route: ``"batch"`` (engine-admitted), ``"direct"``
        (small graph on the semaphore path), ``"sharded_lane"``, or
        ``"bypass"`` (oversize without a usable mesh lane)."""
        if backend != "device":
            return "direct"
        route = self._route_policy.route(
            graph,
            sharded_available=(
                self.sharded_lane is not None and self.sharded_lane.admits(graph)
            ),
        )
        if route == "lane":
            return "batch" if self.batch_engine is not None else "direct"
        return route

    def interactive(self):
        """Register non-solve request work with the priority gate.

        The stream layer wraps each window commit in this context so a
        bulk mesh solve yields to window applies at its stepped-solve
        checkpoints, the same way it yields to interactive misses.
        """
        return self.gate.interactive()

    def _solve_miss(self, graph: Graph, backend: str) -> MSTResult:
        """One cache miss, routed: batch-engine submission (admitted,
        device backend), the mesh-sharded lane (oversize with a lane
        attached), or a semaphore-bounded supervised solve (small graphs
        without an engine, other backends, and the oversize bypass when no
        lane is attached). Oversize spans carry ``route`` (``sharded_lane``
        or ``bypass``); interactive (not oversize) solves register with the
        priority gate the bulk lane yields to."""
        # Every path below runs the solver on a graph nothing had cached.
        BUS.count("serve.scheduler.fresh_solve")
        route = self._route(graph, backend)
        if route == "batch":
            with self.gate.interactive(), BUS.span(
                "serve.solve", cat="serve", backend="batch",
                nodes=graph.num_nodes, edges=graph.num_edges, **_cls_args(),
            ):
                return self.batch_engine.submit(graph).wait()
        if route == "sharded_lane":
            BUS.count("serve.route.sharded_lane")
            with BUS.span(
                "serve.solve", cat="serve", backend="sharded_lane",
                route="sharded_lane", nodes=graph.num_nodes,
                edges=graph.num_edges, **_cls_args(),
            ):
                # Bulk class: no semaphore slot held, one mesh solve in
                # flight inside the lane, yielding to pending interactive
                # work between its dispatches.
                return self.sharded_lane.solve_result(
                    graph, yield_fn=self.gate.checkpoint
                )
        span_args = dict(
            backend=backend, nodes=graph.num_nodes, edges=graph.num_edges,
            **_cls_args(),
        )
        if route == "bypass":
            BUS.count("serve.route.bypass")
            span_args["route"] = "bypass"
        gate = (
            self.gate.interactive() if route == "direct"
            else contextlib.nullcontext()
        )
        with gate, self._sem:
            with BUS.span("serve.solve", cat="serve", **span_args):
                return minimum_spanning_forest(
                    graph, backend=backend, supervised=True,
                    supervisor=self._make_supervisor(), device=self.device,
                )

    def _solve_misses(
        self, graphs: List[Graph], backend: str
    ) -> List[MSTResult]:
        """The distinct misses of one batch, as a group: engine-admitted
        misses coalesce into device batches; misses routed to the sharded
        lane peel off to the mesh (the engine would bypass them to the
        single-graph path otherwise); without an engine, one solve each."""
        if self.batch_engine is not None and backend == "device":
            lane_set = {
                i for i, g in enumerate(graphs)
                if self._route(g, backend) == "sharded_lane"
            }
            results: List[Optional[MSTResult]] = [None] * len(graphs)
            rest = [i for i in range(len(graphs)) if i not in lane_set]
            if rest:
                with BUS.span(
                    "serve.solve", cat="serve", backend="batch",
                    misses=len(rest), **_cls_args(),
                ):
                    solved = self.batch_engine.solve_many([graphs[i] for i in rest])
                for i, result in zip(rest, solved):
                    results[i] = result
            for i in sorted(lane_set):
                results[i] = self._solve_miss(graphs[i], backend)
            return results  # type: ignore[return-value]
        return [self._solve_miss(g, backend) for g in graphs]

    # ------------------------------------------------------------------
    def _make_supervisor(self):
        from distributed_ghs_implementation_tpu_torch.utils.resilience import Supervisor

        return Supervisor(self._supervisor_config)
