"""BatchEngine: the queue + supervised execution behind batched solves.

Port of the JAX package's ``batch/engine.py``. The engine runs on one
explicit device (``device=None`` means CUDA): its worker thread and every
single solve launch there. Two entry points share one execution core:

* :meth:`BatchEngine.solve_many` — synchronous: a whole request list is
  formed into batches immediately (no waiting) and solved; the serving
  scheduler's ``solve_batch`` miss path and the public
  ``minimum_spanning_forest_batch`` both land here.
* :meth:`BatchEngine.submit` — asynchronous: one graph joins the forming
  queue and waits up to ``policy.max_wait_s`` for same-bucket lane-mates
  (a full bucket dispatches immediately); concurrent cache-miss ``solve``
  requests coalesce into device batches this way.

Execution is supervised, batch-shaped: a formed batch retries on
*transient* failure (same classification and backoff as
``utils.resilience``), and when retries exhaust it degrades to per-lane
single-graph solves under the full supervisor ladder — so one poisoned
lane (or one injected ``batch.attempt`` fault) never fails its lane-mates,
and every lane's incidents stay separately attributable. Non-transient
errors raise immediately (programming errors must not be papered over).
The port's ``is_transient`` takes a CUDA error from a kernel and a library
that fails to build or load as fatal, so a kernel fault in a batch raises
at once: it neither retries nor degrades to lanes on the host rung.

``solve_many`` is **pipelined** (``policy.pipeline_depth``, default
double-buffered): a background former thread stacks batch *k+1*'s host
arrays while batch *k* executes on the device, handing off through a
bounded queue — the device never waits on host-side padding/stacking.
Results, retries, and incident handling are identical to the synchronous
path: execution still runs through the same supervised core, and the
former thread touches no device state.

Telemetry (``batch.*`` on the obs bus):
``batch.solve`` spans; ``batch.batches.formed`` / ``batch.lanes.formed`` /
``batch.bypass`` / ``batch.retry`` / ``batch.lane.fallback`` /
``batch.compile.hit|miss`` / ``batch.pipeline.batches`` counters;
``batch.fill_ratio``, ``batch.queue.wait_s``, ``batch.form_s``, and
``batch.pipeline.stall_s`` histograms; ``batch.queue.depth`` samples.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from distributed_ghs_implementation_tpu_torch.api import (
    MSTResult,
    minimum_spanning_forest,
)
from distributed_ghs_implementation_tpu_torch.batch.lanes import (
    StackedBatch,
    bucket_key,
    execute_stacked,
    stack_lanes,
)
from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import (
    current_class,
    current_kind,
)
from distributed_ghs_implementation_tpu_torch.utils.resilience import (
    FAULTS,
    IncidentLog,
    Supervisor,
    SupervisorConfig,
    is_transient,
)

# Ceiling on distinct per-class queue-wait histogram names one engine will
# create (each histogram is permanent process state on the global bus).
_CLS_HIST_CAP = 16


class PendingSolve:
    """One submitted solve; ``wait()`` blocks until its batch lands.

    ``cls`` snapshots the submitting request's SLO class tag
    (``obs.slo.current_class``) — the worker thread that eventually forms
    the batch has no request context of its own, so queue-wait telemetry
    is attributed from the tag captured here at submit time. ``kind``
    snapshots the analytics query kind the same way (``None`` == mst):
    batch forming keys on it, so lanes stay kind-homogeneous.
    """

    __slots__ = ("graph", "event", "result", "error", "enqueued_at", "cls",
                 "kind")

    def __init__(self, graph: Graph):
        self.graph = graph
        self.event = threading.Event()
        self.result: Optional[MSTResult] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()
        self.cls = current_class()
        self.kind = current_kind()

    def wait(self, timeout: Optional[float] = None) -> MSTResult:
        if not self.event.wait(timeout):
            raise TimeoutError("batched solve did not complete in time")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class BatchEngine:
    """Forms, supervises, and unpacks multi-graph device batches."""

    def __init__(
        self,
        *,
        policy: Optional[BatchPolicy] = None,
        supervisor_config: Optional[SupervisorConfig] = None,
        clock=time.monotonic,
        sleep=time.sleep,
        device=None,
    ):
        self.device = resolve_device(device)
        self.policy = policy or BatchPolicy()
        self.config = supervisor_config or SupervisorConfig()
        self._clock = clock
        self._sleep = sleep
        self._dispatch = threading.Lock()  # one device batch in flight
        self._cv = threading.Condition()
        self._cls_seen: set = set()  # distinct per-class histogram labels
        self._queue: List[PendingSolve] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------------
    # Synchronous entry
    # ------------------------------------------------------------------
    def solve_many(self, graphs: Sequence[Graph]) -> List[MSTResult]:
        """Solve a request list; results in input order.

        Forms batches immediately (the caller already holds the whole
        list, so there is nothing to wait for); non-admitted graphs bypass
        to supervised single-graph solves. With ``policy.pipeline_depth >=
        2`` and more than one formed batch, forming is pipelined: batch
        *k+1* stacks on a background thread while batch *k* executes.
        """
        graphs = list(graphs)
        results: List[Optional[MSTResult]] = [None] * len(graphs)
        batches, bypass = self.policy.form(graphs)
        if (
            self.policy.pipeline_depth >= 2
            and len(batches) >= 2
            and self._pipeline_worthwhile(batches)
        ):
            self._solve_batches_pipelined(graphs, batches, results)
        else:
            for fb in batches:
                members = [graphs[i] for i in fb.indices]
                for i, result in zip(fb.indices, self._solve_formed(members)):
                    results[i] = result
        for i in bypass:
            BUS.count("batch.bypass")
            results[i] = self._solve_single(graphs[i])
        return results  # type: ignore[return-value]

    def _pipeline_worthwhile(self, batches) -> bool:
        """Is there enough host stacking per batch to hide behind device
        execution? A batch's stacked arrays hold ``8 * lanes * m_pad``
        int32 elements (3 edge-slot arrays of ``2 * m_pad`` + 2 rank
        arrays of ``m_pad``, all times ``lanes``); below the policy floor
        the former thread's handoff overhead outweighs the overlap
        (the JAX package's floor; ``chip_smoke.py`` times both on the card)."""
        lanes = self.policy.max_lanes
        return any(
            8 * lanes * fb.key[1] >= self.policy.pipeline_min_stack_elems
            for fb in batches
        )

    def _solve_batches_pipelined(
        self, graphs: List[Graph], batches, results: List[Optional[MSTResult]]
    ) -> None:
        """Double-buffered dispatch: one background former thread stacks
        upcoming batches' host arrays into a bounded handoff queue
        (capacity ``pipeline_depth - 1``) while this thread executes.

        The former does pure host work (``stack_lanes`` touches no device
        state and no shared caches), so overlap is safe; execution itself
        still runs through :meth:`_solve_formed`'s retry/fallback ladder,
        keeping results and incidents identical to the synchronous path. A
        forming error is delivered as a ``None`` stack and reproduced by
        re-stacking on this thread — stacking is deterministic, so the
        error surfaces with exactly the synchronous path's classification
        and incident records.
        """
        handoff: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, self.policy.pipeline_depth - 1)
        )
        stop = threading.Event()

        def former() -> None:
            for fb in batches:
                # The WHOLE per-batch body is guarded: an unexpected error
                # (bad indices from a broken policy, an obs exporter blowing
                # up) must reach the dispatcher as an item, never kill this
                # thread silently — a dead former would hang the timeout-
                # less handoff.get() forever.
                try:
                    members = [graphs[i] for i in fb.indices]
                    t0 = self._clock()
                    try:
                        stacked = stack_lanes(
                            members, lanes=self.policy.max_lanes,
                            mode=self.policy.mode,
                        )
                    except BaseException:  # noqa: BLE001 — redone at dispatch
                        stacked = None  # deterministic: re-raised by re-stack
                    BUS.record("batch.form_s", self._clock() - t0)
                    item: object = (fb, members, stacked)
                except BaseException as e:  # noqa: BLE001 — raised at dispatch
                    item = e
                while not stop.is_set():
                    try:
                        handoff.put(item, timeout=0.05)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set():
                    return

        thread = threading.Thread(target=former, name="batch-former", daemon=True)
        thread.start()
        try:
            for _ in range(len(batches)):
                t0 = self._clock()
                got = handoff.get()
                if isinstance(got, BaseException):
                    raise got  # the sync path would have raised it here too
                fb, members, stacked = got
                BUS.record("batch.pipeline.stall_s", self._clock() - t0)
                BUS.count("batch.pipeline.batches")
                for i, result in zip(
                    fb.indices, self._solve_formed(members, stacked=stacked)
                ):
                    results[i] = result
        finally:
            stop.set()
            while thread.is_alive():
                try:  # unblock a former stuck on a full handoff queue
                    handoff.get_nowait()
                except queue_mod.Empty:
                    pass
                thread.join(timeout=0.05)

    # ------------------------------------------------------------------
    # Asynchronous entry (the scheduler's per-request miss path)
    # ------------------------------------------------------------------
    def submit(self, graph: Graph) -> PendingSolve:
        """Queue one solve for lane-forming; returns a waitable handle.

        Non-admitted graphs solve inline in the calling thread (there is
        no batch to wait for) and return an already-completed handle.
        """
        pending = PendingSolve(graph)
        pending.enqueued_at = self._clock()  # queue timing honors the
        if not self.policy.admits(graph):    # injectable clock throughout
            BUS.count("batch.bypass")
            try:
                pending.result = self._solve_single(graph)
            except BaseException as e:  # noqa: BLE001 — delivered via wait()
                pending.error = e
            pending.event.set()
            return pending
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchEngine is closed")
            self._queue.append(pending)
            BUS.sample("batch.queue.depth", len(self._queue))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, name="batch-engine", daemon=True
                )
                self._worker.start()
            self._cv.notify_all()
        return pending

    def close(self) -> None:
        """Stop accepting submissions and drain the queue."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)

    # ------------------------------------------------------------------
    # Worker: the forming window
    # ------------------------------------------------------------------
    def _take_batch(self) -> Optional[List[PendingSolve]]:
        """Under the lock: pop a full bucket, or the oldest item's bucket
        once its wait expires. ``None`` means keep waiting.

        The forming key is ``(kind, shape bucket)``: every admitted solve
        is a plain MSF solve regardless of query kind (components submits
        its index-weighted twin), so mixing kinds would be *numerically*
        fine — homogeneity is kept so one lane-mate's failure, retry, or
        supervision incident never blurs across kinds in the per-kind SLO
        and incident telemetry.
        """
        if not self._queue:
            return None
        by_bucket: Dict[tuple, List[PendingSolve]] = {}
        for p in self._queue:
            by_bucket.setdefault(
                (p.kind, bucket_key(p.graph)), []
            ).append(p)
        for members in by_bucket.values():
            if len(members) >= self.policy.max_lanes:
                return members[: self.policy.max_lanes]
        oldest = self._queue[0]
        if self._clock() - oldest.enqueued_at >= self.policy.max_wait_s:
            members = by_bucket[(oldest.kind, bucket_key(oldest.graph))]
            return members[: self.policy.max_lanes]
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                batch = self._take_batch()
                while batch is None:
                    if self._closed and not self._queue:
                        return
                    if self._queue:
                        headroom = self.policy.max_wait_s - (
                            self._clock() - self._queue[0].enqueued_at
                        )
                        self._cv.wait(timeout=max(headroom, 0.0005))
                    else:
                        self._cv.wait()
                    batch = self._take_batch()
                for p in batch:
                    self._queue.remove(p)
                BUS.sample("batch.queue.depth", len(self._queue))
            now = self._clock()
            for p in batch:
                wait_s = now - p.enqueued_at
                BUS.record("batch.queue.wait_s", wait_s)
                if p.cls is not None and (
                    p.cls in self._cls_seen
                    or len(self._cls_seen) < _CLS_HIST_CAP
                ):
                    # Per-class forming-queue wait: histograms survive ring
                    # overflow, so obs.slo can attach this to each class's
                    # report even on long drills (obs/slo.py joins on the
                    # "batch.queue.wait_s.<cls>" name). Distinct labels are
                    # capped — histograms live forever in the process-global
                    # bus, and the label ultimately comes from request JSON.
                    self._cls_seen.add(p.cls)
                    BUS.record(f"batch.queue.wait_s.{p.cls}", wait_s)
            try:
                results = self._solve_formed([p.graph for p in batch])
                for p, result in zip(batch, results):
                    p.result = result
            except BaseException as e:  # noqa: BLE001 — delivered via wait()
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()

    # ------------------------------------------------------------------
    # Execution core
    # ------------------------------------------------------------------
    def _solve_formed(
        self,
        graphs: List[Graph],
        stacked: Optional[StackedBatch] = None,
    ) -> List[MSTResult]:
        """One same-bucket batch: lane solve with retry, then per-lane
        fallback isolation. Results in input order.

        ``stacked`` carries pre-formed host arrays from the pipelined
        former; when absent (synchronous path, or a former that failed)
        the stack is built here, inside the attempt's error classification.
        A retry re-dispatches the same immutable stack without re-forming.
        """
        lanes = self.policy.max_lanes
        n_pad, m_pad = bucket_key(graphs[0])
        BUS.count("batch.batches.formed")
        BUS.count("batch.lanes.formed", len(graphs))
        BUS.record("batch.fill_ratio", len(graphs) / lanes)
        log = IncidentLog()
        with BUS.span(
            "batch.solve", cat="batch",
            bucket_n=n_pad, bucket_m=m_pad, lanes=len(graphs), max_lanes=lanes,
        ) as span:
            for attempt in range(1, self.config.retries_per_rung + 2):
                t0 = self._clock()
                try:
                    FAULTS.fire("batch.attempt")
                    if stacked is None:
                        stacked = stack_lanes(
                            graphs, lanes=lanes, mode=self.policy.mode
                        )
                    with self._dispatch:
                        solved = execute_stacked(stacked, device=self.device)
                except Exception as e:  # noqa: BLE001 — classified below
                    if not is_transient(e):
                        log.add(
                            rung="batch", attempt=attempt, outcome="fatal",
                            error=repr(e), elapsed_s=self._clock() - t0,
                            site="batch.attempt",
                        )
                        raise
                    retrying = attempt <= self.config.retries_per_rung
                    backoff = 0.0
                    if retrying:
                        backoff = min(
                            self.config.backoff_base_s * (2 ** (attempt - 1)),
                            self.config.backoff_cap_s,
                        )
                    log.add(
                        rung="batch", attempt=attempt, outcome="transient",
                        error=repr(e), elapsed_s=self._clock() - t0,
                        backoff_s=backoff, site="batch.attempt",
                    )
                    BUS.count("batch.retry")
                    if retrying and backoff > 0:
                        self._sleep(backoff)
                    continue
                wall = self._clock() - t0
                log.add(
                    rung="batch", attempt=attempt, outcome="ok", elapsed_s=wall
                )
                span.set(attempts=attempt, outcome="ok")
                incidents = log if len(log) > 1 else None
                return [
                    self._lane_result(g, *out, wall=wall, incidents=incidents)
                    for g, out in zip(graphs, solved)
                ]
            # Retries exhausted: isolate lanes — each graph gets its own
            # supervised solve so one bad lane cannot fail its lane-mates.
            span.set(outcome="lane_fallback")
            return [self._fallback_lane(g, log) for g in graphs]

    def _lane_result(
        self, graph, edge_ids, fragment, levels, *, wall, incidents
    ) -> MSTResult:
        num_components = (
            int(np.unique(fragment).size) if graph.num_nodes else 0
        )
        return MSTResult(
            graph=graph,
            edge_ids=edge_ids,
            num_levels=levels,
            wall_time_s=wall,
            backend=f"batch/{self.policy.mode}",
            num_components=num_components,
            incidents=incidents,
        )

    def _fallback_lane(self, graph: Graph, batch_log: IncidentLog) -> MSTResult:
        """One isolated lane after batch retries exhausted. The lane's
        incident log keeps the batch-level failure records in front of its
        own supervised attempts (records are already on the bus — they are
        re-linked here, not re-emitted), so a degraded response tells the
        whole story: the batch failed first, then this lane solved alone."""
        BUS.count("batch.lane.fallback")
        result = self._solve_single(graph)
        merged = IncidentLog()
        merged.records = list(batch_log.records)
        if result.incidents is not None:
            merged.records.extend(result.incidents.records)
        result.incidents = merged
        return result

    def _solve_single(self, graph: Graph) -> MSTResult:
        """The bypass/fallback path: one supervised single-graph solve."""
        return minimum_spanning_forest(
            graph, supervised=True, supervisor=Supervisor(self.config),
            device=self.device,
        )
