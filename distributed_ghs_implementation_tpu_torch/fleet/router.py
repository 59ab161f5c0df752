"""Fleet front-end: digest-routed dispatch over N worker processes.

Port of the JAX package's ``fleet/router.py``: the same routing, failover,
re-queue, journal, chaos and certificate paths, over the port's workers
(``python -m distributed_ghs_implementation_tpu_torch.fleet.worker``).
Where it differs on purpose: ``FleetConfig.device`` is passed to every
spawned worker as ``--device`` (``None`` leaves the worker's default,
``cuda``); and :meth:`FleetRouter.start` raises as soon as a spawned worker
exits non-zero before its hello (a worker without CUDA that was not given
``device="cpu"``), where the JAX package waits out ``ready_timeout_s``. The
router process itself touches no device: routing hashes digests, and its
certificates run the ``np`` engine.

The router is the serving tier's availability layer. It owns no solver —
every query is forwarded over a framed channel (``fleet/transport.py``:
subprocess pipes on one host, TCP sockets across hosts) to one of N worker
processes (``fleet/worker.py``), each a full single-process serving stack.
What the router adds is exactly what one process cannot have:

* **Cache-affine routing** — ``Graph.digest()`` consistent-hashes onto the
  ring (``fleet/hashing.py``), so repeats of a graph land on the worker
  whose result cache, update sessions, and compiled buckets are already
  warm, and worker death moves only the dead worker's keyspace share.
  Updates re-key content-addressed, so the router pins each *session
  digest* to the worker holding the materialized session and follows the
  chain as responses rename it.
* **Cache-miss forwarding** — across hosts there is no shared disk store,
  so whenever routing must deviate from the worker that last served a
  digest (lane steering, failover, ring rejoin), the router first asks the
  digest's owner-of-record with a tiny ``cached_only`` probe and only
  lets the dispatch target solve locally on a miss (``fleet.forward.hit``
  / ``fleet.forward.miss``) — consistent-hash affinity keeps paying off
  even where ``disk_dir`` cannot follow.
* **Admission control** — per-worker bounded in-flight queues
  (``queue_depth``). A full queue sheds requests whose ``slo_class`` is in
  ``shed_classes`` (``{"ok": false, "shed": true}``, counted
  ``fleet.shed``); every other class blocks — backpressure, not loss.
* **Health-checked failover** — a heartbeat thread pings every worker; a
  worker silent past its **lease** (``lease_s``, default
  ``heartbeat_interval_s * heartbeat_miss_threshold``), or whose channel
  reaches EOF (pipe closed, TCP connection lost), is declared dead. Its
  accepted-but-unanswered requests are **re-queued** onto surviving
  workers by the same digest key (``fleet.requeue``) — idempotent, because
  results are content-addressed and every worker computes the identical
  forest. The dead worker restarts (spawned) or is re-dialed (remote) with
  capped exponential backoff and rejoins the ring when it says hello.
* **Graceful drain** — :meth:`FleetRouter.shutdown` stops admitting, sends
  every worker a drain frame, and waits for in-flight responses to flush
  before the processes exit 0.
* **Elastic pool primitives** — :meth:`FleetRouter.add_worker` grows the
  pool by one *warm* worker (spawned with the fleet's warmup flags; it
  enters the hash ring only after a hello whose ``warmed`` capability is
  confirmed — a cold worker can never be routed interactive traffic;
  ``fleet.scale.up``, ``fleet.join.warm_s``) and
  :meth:`FleetRouter.retire_worker` shrinks it by one (victim = lowest
  forwarding-affinity worker unless pinned; removed from the ring first,
  in-flight accepted work drains, pinned update/stream sessions migrate to
  their ring inheritors — who replay from the shared disk store / stream
  WAL exactly like failover — then a drain frame and exit 0;
  ``fleet.scale.down``). A worker in graceful drain is exempt from lease
  expiry: the heartbeat loop skips draining workers entirely, so a slow
  drain can never be mistaken for a death and re-queued mid-flush.
  ``fleet/autoscaler.py`` drives both primitives from the obs bus.

Telemetry (router-process bus): ``fleet.request`` spans carry ``cls`` /
``worker`` / ``ok`` — ``obs.slo`` joins them into per-class AND per-worker
SLO breakdowns — plus ``fleet.dispatch`` / ``fleet.requeue`` /
``fleet.shed`` / ``fleet.worker.dead`` / ``fleet.worker.restart`` /
``fleet.heartbeat.miss`` / ``fleet.lease.expired`` /
``fleet.forward.hit`` / ``fleet.forward.miss`` counters and the
``fleet.hop_s[.<cls>]`` histograms (send-to-response minus in-worker
service time — the transport + queueing overhead a ``--transport`` choice
actually changes). See ``docs/FLEET.md``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from distributed_ghs_implementation_tpu_torch.fleet.framing import (
    SECTIONS_KEY,
    fold_sections,
)
from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
from distributed_ghs_implementation_tpu_torch.fleet.transport import (
    ChaosState,
    ChaosTransport,
    HelloError,
    PipeTransport,
    Transport,
    WorkerListener,
    check_hello,
    connect_to_worker,
    new_conn_token,
)
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import sanitize_class

_SESSION_MAP_CAP = 4096  # digest -> worker pins retained (LRU)
_FORWARD_MAP_CAP = 4096  # digest -> last-serving worker (LRU)
# The forwarding probe is an OPTIMIZATION riding ahead of a correct local
# solve: on a busy owner it must give up fast (miss and move on), never
# queue behind slow solves for the full control-plane timeout.
_FORWARD_PROBE_TIMEOUT_S = 2.0
_FORWARD_PROBE_SLOT_TIMEOUT_S = 0.25


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology + failover policy (defaults suit tests/drills; the
    ``serve --fleet`` CLI maps its flags onto this)."""

    workers: int = 2
    backend: str = "device"
    batch_lanes: int = 0
    batch_wait_s: Optional[float] = None
    store_capacity: int = 128
    disk_dir: Optional[str] = None  # SHARED persistent store (flock'd writes)
    max_concurrent: int = 2
    max_sessions: int = 32
    resolve_threshold: Optional[int] = None
    worker_threads: int = 4
    warmup_buckets: Optional[str] = None
    warmup_replay: Optional[str] = None
    compile_cache_dir: Optional[str] = None
    no_compile_cache: bool = False
    tune_record: Optional[str] = None  # ghs-tuning-v1 record (all workers)
    queue_depth: int = 64
    shed_classes: Tuple[str, ...] = ()
    # Oversize routing: the first K worker slots own a mesh-sharded solve
    # lane (spawned with --sharded-lane; -1 = every worker). Oversize
    # solves consistent-hash onto the LANE ring so they land on a
    # mesh-owning worker; 0 leaves oversize on the normal ring (bypass).
    sharded_lane_workers: int = 0
    warmup_mesh_buckets: Optional[str] = None  # passed to lane workers
    warmup_stream_buckets: Optional[str] = None  # window-kernel warm (all)
    # Durable stream layer: a SHARED directory (like disk_dir) holding
    # every stream's snapshot + update log, so whichever worker inherits a
    # stream's keyspace after a death replays it instead of re-solving
    # (stream/log.py, docs/STREAMING.md).
    stream_dir: Optional[str] = None
    stream_snapshot_every: int = 8
    # -- transport (round 16, docs/FLEET.md "Network transport") -------
    # "pipe": subprocess stdin/stdout (single host). "tcp": length-prefixed
    # frames over sockets with coalesced pipelined writes — spawned workers
    # dial into the router's listener with a tokened hello; with
    # remote_workers set, the router instead dials each listed
    # host:port (externally started `fleet.worker --listen` processes,
    # possibly on other machines / pod slices).
    transport: str = "pipe"
    listen_host: str = "127.0.0.1"
    remote_workers: Tuple[str, ...] = ()
    # Cross-host cache-miss forwarding: before a solve lands on a worker
    # that is NOT the digest's owner-of-record, probe the owner with a
    # cached_only frame and return its cached result on a hit. None = auto:
    # on for TCP fleets without a shared disk store (the topology where a
    # deviating dispatch would otherwise re-solve), off elsewhere.
    forward_cache: Optional[bool] = None
    # -- verification (round 19, docs/VERIFICATION.md) -------------------
    # verify: the per-class off|sample|full policy spec every spawned
    # real-service worker boots with (--verify). verify_forward: certify
    # cross-host forward.hit payloads AT THE ROUTER before serving them —
    # mandatory by default: a forwarded result crosses an extra process
    # and an extra link that the owning worker's own verification never
    # saw. verify_responses: certify EVERY verifiable solve response
    # (request carried edges, response carried mst_edges) and re-dispatch
    # once on a failed certificate — the net the corruption drill arms
    # fleet.chaos.payload against.
    verify: Optional[str] = None
    verify_forward: bool = True
    verify_responses: bool = False
    # -- survivability (round 18, docs/FLEET.md "Router survivability") --
    # Durable accepted-work journal (fleet/journal.py): every accept is
    # fsynced before dispatch, answers/pins/ring/scale changes follow, so
    # a router crash loses NOTHING acknowledged — a restarted router with
    # the same journal_dir re-adopts live --listen workers warm,
    # re-spawns dead ones, rebuilds pins/affinity, and re-queues orphaned
    # accepts by digest. None = the pre-round-18 in-memory-only router.
    journal_dir: Optional[str] = None
    journal_checkpoint_every: int = 512
    # Transport chaos layer (fleet/transport.py ChaosTransport): wrap
    # every worker channel in the fault-injectable wrapper so drills can
    # drive seeded partitions / latency / frame corruption per worker.
    chaos: bool = False
    chaos_seed: int = 0
    # Worker lease: silence (no pong, no frames) longer than this declares
    # the worker dead even while its connection stays open. None derives
    # heartbeat_interval_s * heartbeat_miss_threshold. A dead process is
    # caught instantly by channel EOF; the lease exists for WEDGED
    # processes and half-dead network paths, so the default errs generous —
    # a false-positive kill under load-spike GIL starvation costs more
    # than slow detection.
    lease_s: Optional[float] = None
    pipelined_io: bool = True  # coalesce TCP frame writes (transport.py)
    heartbeat_interval_s: float = 0.25
    heartbeat_miss_threshold: int = 20
    restart_backoff_base_s: float = 0.05
    restart_backoff_cap_s: float = 2.0
    # Restart jitter: each backoff is scaled by (1 - restart_jitter * u)
    # with u in [0,1) derived deterministically from (seed, worker,
    # attempt), so a MASS death (or mass scale-up rejoin) fans restarts
    # out over the backoff window instead of stampeding the shared disk
    # store and compile cache in lockstep — while staying reproducible
    # under a seed and never exceeding the documented cap.
    restart_jitter: float = 0.5
    restart_jitter_seed: int = 0
    max_restarts: int = 8  # per worker slot, cumulative
    request_timeout_s: float = 300.0
    ready_timeout_s: float = 120.0
    ring_replicas: int = 64
    obs_dir: Optional[str] = None  # per-worker JSONL exports on drain
    test_echo: bool = False  # spawn solver-free echo workers (tests)
    worker_env: Optional[Dict[int, Dict[str, str]]] = None  # incarnation 0 only
    # The workers' device (--device): None = the worker's default, cuda,
    # which raises without CUDA; "cpu" runs the kernels' plain versions.
    device: Optional[str] = None

    @property
    def effective_lease_s(self) -> float:
        if self.lease_s is not None:
            return self.lease_s
        return self.heartbeat_interval_s * self.heartbeat_miss_threshold

    @property
    def forward_enabled(self) -> bool:
        if self.forward_cache is not None:
            return self.forward_cache
        return self.transport == "tcp" and not self.disk_dir


#: Default admission-ceiling BUCKETS mirrored from ``batch.policy
#: .BatchPolicy`` (max_bucket_nodes / max_bucket_edges) — mirrored, not
#: imported, as in the JAX package, so that the router imports no solver;
#: a drift guard in tests/test_torch_fleet.py pins these to the real
#: policy defaults.
_OVERSIZE_NODE_BUCKET = 1 << 16
_OVERSIZE_EDGE_BUCKET = 1 << 17


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _request_oversize(request: dict) -> bool:
    """Would this solve bypass the lane engine (oversize)? Judged from the
    raw request so the router can steer it at a mesh-owning worker without
    building a Graph twice. Binary requests declare ``num_edges`` in the
    B-frame header, so the judgment never touches the edge sections —
    part of the O(header) passthrough contract. ``graph_path`` solves
    (size unknown without I/O) and updates (session-pinned anyway) route
    normally."""
    if request.get("op") != "solve":
        return False
    if "edges" in request:
        m_raw = len(request["edges"])
    elif SECTIONS_KEY in request and "num_edges" in request:
        m_raw = int(request["num_edges"])
    else:
        return False
    n = _next_pow2(max(1, int(request.get("num_nodes", 0))))
    m = _next_pow2(max(1, m_raw))
    return n > _OVERSIZE_NODE_BUCKET or m > _OVERSIZE_EDGE_BUCKET


class _Pending:
    """One accepted request: survives its worker by being re-dispatched."""

    __slots__ = ("request", "key", "cls", "event", "response", "worker_id",
                 "requeues", "lane", "sent_at", "trace")

    def __init__(
        self,
        request: dict,
        key: Optional[str],
        cls: Optional[str],
        lane: bool = False,
    ):
        self.request = request
        self.key = key
        self.cls = cls
        self.event = threading.Event()
        self.response: Optional[dict] = None
        self.worker_id: Optional[int] = None
        self.requeues = 0
        self.lane = lane  # prefers a mesh-owning worker (oversize solve)
        self.sent_at: Optional[float] = None  # hop-latency clock start
        # Wire trace context (obs/tracing.py) captured at dispatch time —
        # failover re-dispatch happens on the monitor thread, where the
        # contextvar from handle() is gone; this is how the re-queued
        # attempt keeps the original trace_id.
        self.trace: Optional[dict] = None


class _Worker:
    """One worker slot: a stable ring identity across process incarnations
    (spawned) or connections (remote)."""

    def __init__(self, worker_id: int, queue_depth: int,
                 addr: Optional[str] = None):
        self.id = worker_id
        self.lock = threading.Lock()  # channel writes + pending map
        self.proc: Optional[subprocess.Popen] = None
        self.transport: Optional[Transport] = None
        self.addr = addr  # remote endpoint (None for spawned workers)
        self.conn_token: Optional[str] = None  # per-incarnation dial-in auth
        self.alive = False
        self.ready = threading.Event()
        self.incarnation = -1
        self.pending: Dict[int, _Pending] = {}
        self.slots = threading.BoundedSemaphore(queue_depth)
        self.last_pong = 0.0
        self.restarts = 0
        self.caps: Dict[str, object] = {}  # from the hello frame
        self.lane_advertised = False  # caps["lane"]
        # Elastic lifecycle: ``draining`` = mid-retire (off the ring,
        # flushing in-flight work — exempt from lease expiry); ``retired``
        # = gone on purpose (never restarted, never counted dead).
        self.draining = False
        self.retired = False


class FleetRouter:
    """Digest-routed, health-checked front end over worker processes.

    :meth:`handle` is request/response-compatible with
    :class:`serve.service.MSTService.handle`, so ``serve_loop``, the load
    drill, and tests drive either interchangeably.
    """

    def __init__(self, config: Optional[FleetConfig] = None):
        self.config = config or FleetConfig()
        if self.config.transport not in ("pipe", "tcp"):
            raise ValueError(
                f"transport must be 'pipe' or 'tcp', got "
                f"{self.config.transport!r}"
            )
        if self.config.remote_workers and self.config.transport != "tcp":
            raise ValueError("remote_workers requires transport='tcp'")
        n = len(self.config.remote_workers) or self.config.workers
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {n}")
        # Durable journal: load BEFORE building slots — a journal from a
        # crashed predecessor may know about workers the static config
        # does not (elastic scale-ups), and those slots must exist so the
        # restarted pool matches the pool the autoscaler had built.
        self._journal = None
        self._journal_state = None
        if self.config.journal_dir:
            from distributed_ghs_implementation_tpu_torch.fleet.journal import (
                RouterJournal,
            )

            self._journal = RouterJournal(
                self.config.journal_dir,
                checkpoint_every=self.config.journal_checkpoint_every,
            )
            self._journal_state = self._journal.load()
        self._workers = [
            _Worker(
                i, self.config.queue_depth,
                addr=(self.config.remote_workers[i]
                      if self.config.remote_workers else None),
            )
            for i in range(n)
        ]
        if self._journal_state is not None and self._journal_state.members:
            for wid in sorted(self._journal_state.members):
                member = self._journal_state.members[wid]
                while wid >= len(self._workers):
                    self._workers.append(_Worker(
                        len(self._workers), self.config.queue_depth,
                        addr=member.get("addr"),
                    ))
                w = self._workers[wid]
                if member.get("addr") and w.addr is None:
                    w.addr = member["addr"]
                if member.get("retired"):
                    # A planned departure stays departed across a router
                    # restart — resurrecting it would undo a scale-down.
                    w.retired = True
                    w.alive = False
        self._ring = HashRing(replicas=self.config.ring_replicas)
        # Mesh-owning worker slots (config-derived — stable across
        # incarnations): oversize solves hash onto this subring.
        k = self.config.sharded_lane_workers
        # -1 = every worker, including slots a journal restored beyond n.
        self._lane_ids = set(range(
            len(self._workers) if k == -1 else max(0, min(k, n))
        ))
        if self._journal_state is not None:
            for wid, member in self._journal_state.members.items():
                if member.get("lane") is None or wid >= len(self._workers):
                    continue
                # Restore the lane subring the crashed router had built —
                # it is capability-derived for dialed standbys, so config
                # alone would mis-place them (a -1 config would drag a
                # lane-less standby onto the oversize ring; a k-bounded
                # one would drop a lane-capable standby off it).
                if member["lane"]:
                    self._lane_ids.add(wid)
                else:
                    self._lane_ids.discard(wid)
        self._lane_ring = HashRing(replicas=self.config.ring_replicas)
        self._ring_lock = threading.Lock()
        # Chaos layer: one standing fault-flag object per worker slot,
        # shared across its transport incarnations (a partition outlives
        # a re-dial). Empty unless config.chaos.
        self._chaos: Dict[int, ChaosState] = {}
        self._sessions: Dict[str, int] = {}  # update-session digest -> worker
        # digest -> worker that LAST answered it ok (the forwarding hop's
        # owner-of-record; survives ring changes that move ownership).
        self._last_served: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._rr = 0  # round-robin cursor for keyless ops
        self._closed = False
        self._started = False
        self._heartbeat: Optional[threading.Thread] = None
        self._listener: Optional[WorkerListener] = None
        self._hello_rejections: List[str] = []  # surfaced on ready timeout
        # Serializes pool mutations (add_worker / retire_worker): scale
        # operations are deliberately one-at-a-time — the hysteresis the
        # autoscaler's determinism rests on.
        self._pool_lock = threading.Lock()
        self.last_scale_decision: Optional[dict] = (
            dict(self._journal_state.last_scale)
            if self._journal_state is not None
            and self._journal_state.last_scale else None
        )

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._started:
            return self
        self._started = True
        if self.config.transport == "tcp" and not self.config.remote_workers:
            self._listener = WorkerListener(
                self._on_dial_in,
                host=self.config.listen_host,
                on_reject=self._on_hello_reject,
                pipelined=self.config.pipelined_io,
            )
        for w in self._workers:
            if w.retired:
                continue  # journal-restored planned departures stay gone
            if w.addr is not None:
                threading.Thread(
                    target=self._connect_remote, args=(w,),
                    name=f"fleet-dial-{w.id}", daemon=True,
                ).start()
            else:
                self._spawn(w)
        deadline = time.monotonic() + self.config.ready_timeout_s
        for w in self._workers:
            if w.retired:
                continue
            if not self._wait_ready(w, deadline):
                rejections = "; ".join(self._hello_rejections[-3:])
                self.shutdown(drain=False)
                raise TimeoutError(
                    f"worker {w.id} not ready within "
                    f"{self.config.ready_timeout_s}s"
                    + (f" (hello rejected: {rejections})" if rejections else "")
                )
        now = time.monotonic()
        with self._ring_lock:
            for w in self._workers:
                if w.retired:
                    continue
                w.alive = True
                w.last_pong = now
                self._ring.add(w.id)
                if w.id in self._lane_ids:
                    self._lane_ring.add(w.id)
        for w in self._workers:
            if not w.retired:
                self._journal_ring("add", w)
        self._adopt_journal_state()
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, name="fleet-heartbeat", daemon=True
        )
        self._heartbeat.start()
        return self

    def _wait_ready(self, w: _Worker, deadline: float) -> bool:
        """Wait for ``w``'s hello until ``deadline``. A spawned worker that
        exits non-zero first (it could not build its service: no CUDA and
        no ``device="cpu"``, a bad flag) raises at once instead of running
        out the ready timeout: a fleet never starts short of a worker."""
        while True:
            left = deadline - time.monotonic()
            if w.ready.wait(max(0.0, min(0.1, left))):
                return True
            proc = w.proc
            code = proc.poll() if proc is not None else None
            if code not in (None, 0) and not w.ready.is_set():
                self.shutdown(drain=False)
                raise RuntimeError(
                    f"worker {w.id} exited with code {code} before its "
                    f"hello (its service could not be built; a worker "
                    f"without CUDA needs FleetConfig(device='cpu'))"
                )
            if left <= 0:
                return False

    # -- journal hooks (no-ops without a journal_dir) -------------------
    def _journal_ring(self, action: str, w: _Worker) -> None:
        if self._journal is not None:
            try:
                self._journal.ring(
                    action, w.id, addr=w.addr,
                    lane=w.id in self._lane_ids,
                )
            except (OSError, TimeoutError):
                BUS.count("fleet.router.journal.ring_failed")

    def _journal_answer(self, jid, *, ok, worker=None, digest=None) -> None:
        if self._journal is None or jid is None:
            return
        try:
            self._journal.answer(jid, ok=ok, worker=worker, digest=digest)
        except (OSError, TimeoutError):
            # A failed answer append degrades to a spurious (idempotent)
            # replay after a crash, never to a lost query.
            BUS.count("fleet.router.journal.answer_failed")

    def _adopt_journal_state(self) -> None:
        """Restart-with-warm-re-adoption: restore session pins and the
        forwarding affinity map from the journal (live workers only — a
        pin on a slot that did not come back would route at a corpse),
        then re-queue every accepted-but-unanswered entry by digest on a
        background thread (idempotent: results are content-addressed, so
        an answer the crashed router never delivered is recomputed or
        cache-hit, never double-committed)."""
        state = self._journal_state
        if state is None or not state.had_state:
            return
        self._journal_state = None  # one-shot: adoption happens at boot
        with self._ring_lock:
            for digest, wid in state.pins.items():
                if wid < len(self._workers) and self._workers[wid].alive:
                    self._sessions[digest] = wid
            for digest, wid in state.served.items():
                if wid < len(self._workers) and self._workers[wid].alive:
                    self._last_served[digest] = wid
        for w in self._workers:
            if not w.alive:
                continue
            if w.addr is not None:
                # A --listen worker that outlived the crashed router: the
                # re-dial found its caches and sessions warm.
                BUS.count("fleet.router.restart.readopted")
            else:
                BUS.count("fleet.router.restart.respawned")
        orphans = state.unanswered
        BUS.instant(
            "fleet.router.restart", cat="fleet",
            orphans=len(orphans), pins=len(state.pins),
            served=len(state.served), dropped=state.dropped,
        )
        if orphans:
            threading.Thread(
                target=self._replay_orphans, args=(list(orphans.values()),),
                name="fleet-journal-replay", daemon=True,
            ).start()

    def _replay_orphans(self, orphans: List[dict]) -> None:
        """Answer the crashed router's accepted-but-unanswered ledger.
        The original clients are gone (they died with the old router's
        sockets), so the *answer* here is the durable journal record: the
        query was accepted, it got executed, nothing was lost — and a
        client that retries the same content-addressed request gets a
        warm cache hit."""
        for entry in orphans:
            if self._closed:
                return
            BUS.count("fleet.router.restart.requeued")
            p = _Pending(
                entry.get("req") or {}, entry.get("key"), entry.get("cls"),
                lane=bool(entry.get("lane")),
            )
            p.trace = entry.get("trace")
            # Replay re-dispatch continues the ORIGINAL trace: the accept
            # record journaled the wire context, so the replayed hop shows
            # up as a fresh child span under the crashed router's request.
            with tracing.activated(tracing.from_wire(p.trace)), \
                    BUS.span("fleet.replay.request", cat="fleet",
                             op=(entry.get("req") or {}).get("op")):
                err = self._dispatch(p, allow_shed=False)
                if err is not None:
                    self._journal_answer(entry.get("jid"), ok=False)
                    continue
                if not p.event.wait(self.config.request_timeout_s):
                    self._forget(p)
                    self._journal_answer(entry.get("jid"), ok=False)
                    continue
                resp = p.response or {}
                self._journal_answer(
                    entry.get("jid"), ok=bool(resp.get("ok")),
                    worker=p.worker_id, digest=resp.get("digest"),
                )
                if resp.get("ok"):
                    BUS.count("fleet.router.restart.replayed")

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    def shutdown(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop admitting, drain every worker, reap the processes.

        ``drain=True`` sends the drain frame and waits: in-flight requests
        finish and flush before the workers exit 0 (remote workers exit
        too — shutdown drains the whole fleet it was configured with).
        ``drain=False`` kills.
        """
        self._closed = True
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=2.0)
        for w in self._workers:
            with w.lock:
                transport = w.transport
                proc = w.proc
                if drain and transport is not None and not transport.closed:
                    try:
                        transport.send({"drain": True})
                    except OSError:
                        pass
                elif not drain and proc is not None and proc.poll() is None:
                    proc.kill()
        deadline = time.monotonic() + timeout_s
        for w in self._workers:
            proc = w.proc
            if proc is None:
                # Remote worker: wait for its reader to see the post-drain
                # close (bye + EOF), bounded by the shutdown deadline.
                if drain and w.transport is not None:
                    t_deadline = max(0.1, deadline - time.monotonic())
                    t_end = time.monotonic() + t_deadline
                    while (time.monotonic() < t_end
                           and not w.transport.closed):
                        time.sleep(0.02)
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        for w in self._workers:
            if w.transport is not None:
                w.transport.close()
        if self._listener is not None:
            self._listener.close()

    # -- spawning ------------------------------------------------------
    def _worker_argv(self, w: _Worker) -> List[str]:
        cfg = self.config
        argv = [
            sys.executable, "-m",
            "distributed_ghs_implementation_tpu_torch.fleet.worker",
            "--worker-id", str(w.id),
            "--backend", cfg.backend,
            "--batch-lanes", str(cfg.batch_lanes),
            "--store-capacity", str(cfg.store_capacity),
            "--max-concurrent", str(cfg.max_concurrent),
            "--max-sessions", str(cfg.max_sessions),
            "--threads", str(cfg.worker_threads),
        ]
        if self._listener is not None:
            argv += ["--connect", self._listener.address,
                     "--conn-token", w.conn_token]
        if cfg.batch_wait_s is not None:
            argv += ["--batch-wait", str(cfg.batch_wait_s)]
        if cfg.disk_dir:
            argv += ["--disk-cache", cfg.disk_dir]
        if cfg.stream_dir:
            argv += ["--stream-dir", cfg.stream_dir,
                     "--stream-snapshot-every",
                     str(cfg.stream_snapshot_every)]
        if cfg.resolve_threshold is not None:
            argv += ["--resolve-threshold", str(cfg.resolve_threshold)]
        if cfg.warmup_buckets:
            argv += ["--warmup-buckets", cfg.warmup_buckets]
        if cfg.warmup_replay:
            argv += ["--warmup-replay", cfg.warmup_replay]
        if cfg.warmup_stream_buckets:
            argv += ["--warmup-stream-buckets", cfg.warmup_stream_buckets]
        if w.id in self._lane_ids:
            argv += ["--sharded-lane", "-1"]
            if cfg.warmup_mesh_buckets:
                argv += ["--warmup-mesh-buckets", cfg.warmup_mesh_buckets]
        if cfg.verify:
            argv += ["--verify", cfg.verify]
        if cfg.compile_cache_dir:
            argv += ["--compile-cache-dir", cfg.compile_cache_dir]
        if cfg.no_compile_cache:
            argv += ["--no-compile-cache"]
        if cfg.tune_record:
            argv += ["--tune-record", cfg.tune_record]
        if cfg.obs_dir:
            os.makedirs(cfg.obs_dir, exist_ok=True)
            argv += ["--obs-jsonl", os.path.join(
                cfg.obs_dir, f"worker{w.id}.{w.incarnation}.jsonl"
            )]
        if cfg.device:
            argv += ["--device", cfg.device]
        if cfg.test_echo:
            argv += ["--test-echo"]
        return argv

    def _spawn(self, w: _Worker) -> None:
        env = dict(os.environ)
        # The worker runs `-m distributed_ghs_implementation_tpu_torch.fleet.worker`;
        # make the package importable no matter the caller's cwd.
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        extra = (self.config.worker_env or {}).get(w.id)
        if extra and w.incarnation < 0:
            # Incarnation 0 only: a crash-fault env inherited by restarts
            # would kill every incarnation and the fleet could never heal.
            env.update(extra)
        tcp = self._listener is not None
        with w.lock:
            w.incarnation += 1
            incarnation = w.incarnation
            # A fresh token per incarnation: a limping previous incarnation
            # (or a stranger on the port) cannot register into this slot.
            w.conn_token = new_conn_token() if tcp else None
            w.ready.clear()
            w.slots = threading.BoundedSemaphore(self.config.queue_depth)
            argv = self._worker_argv(w)
            if tcp:
                # The framed channel is the socket the worker dials back;
                # stdin/stdout stay free (stderr inherits for logs).
                w.transport = None
                w.proc = subprocess.Popen(
                    argv, stdin=subprocess.DEVNULL, env=env
                )
            else:
                w.proc = subprocess.Popen(
                    argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    env=env,
                )
                w.transport = self._wrap_transport(
                    w, PipeTransport(w.proc.stdin, w.proc.stdout)
                )
        if not tcp:
            threading.Thread(
                target=self._reader,
                args=(w, incarnation, w.transport),
                name=f"fleet-reader-{w.id}.{incarnation}",
                daemon=True,
            ).start()
        # tcp: the reader starts when the worker's dial-in hello arrives
        # (_on_dial_in); until then the slot has no channel.

    # -- chaos wrapping ------------------------------------------------
    def _wrap_transport(self, w: _Worker, transport: Transport) -> Transport:
        """With ``config.chaos``, wrap a freshly established channel in
        the fault-injectable layer, bound to the worker's STANDING flag
        object — a partition set on the slot applies to every future
        incarnation until healed."""
        if not self.config.chaos:
            return transport
        state = self._chaos.get(w.id)
        if state is None:
            state = self._chaos[w.id] = ChaosState(
                seed=self.config.chaos_seed, name=str(w.id)
            )
        return ChaosTransport(transport, state)

    def partition_worker(self, worker_id: int, *, mode: str = "oneway") -> None:
        """Partition one worker's link (drills; needs ``config.chaos``).

        ``oneway``: router→worker frames vanish while worker→router still
        flows — the nastiest shape, because the worker looks alive (its
        in-flight responses keep arriving) right up until silence expires
        the lease. ``sym``: both directions drop. Unlike
        :meth:`close_worker_connection` the socket stays OPEN — detection
        must come from the lease, not EOF."""
        if not self.config.chaos:
            raise RuntimeError("partition_worker needs FleetConfig(chaos=True)")
        if mode not in ("oneway", "sym"):
            raise ValueError(f"mode must be 'oneway' or 'sym', got {mode!r}")
        state = self._chaos.setdefault(worker_id, ChaosState(
            seed=self.config.chaos_seed, name=str(worker_id)
        ))
        state.drop_send = True
        state.drop_recv = mode == "sym"
        BUS.count("fleet.chaos.partition")
        BUS.instant("fleet.chaos.partition", cat="fleet",
                    worker=worker_id, mode=mode)

    def heal_partition(self, worker_id: int) -> None:
        """Heal a drill partition: frames flow again and the redial loop's
        next knock completes — a warm rejoin, never a cold restart."""
        state = self._chaos.get(worker_id)
        if state is None:
            return
        state.drop_send = False
        state.drop_recv = False
        BUS.count("fleet.chaos.heal")
        BUS.instant("fleet.chaos.heal", cat="fleet", worker=worker_id)

    def set_worker_latency(
        self, worker_id: int, latency_s: float, jitter_s: float = 0.0
    ) -> None:
        """Add seeded latency/jitter to one worker's outbound frames."""
        if not self.config.chaos:
            raise RuntimeError(
                "set_worker_latency needs FleetConfig(chaos=True)"
            )
        state = self._chaos.setdefault(worker_id, ChaosState(
            seed=self.config.chaos_seed, name=str(worker_id)
        ))
        state.latency_s = float(latency_s)
        state.jitter_s = float(jitter_s)

    # -- connection establishment (tcp) --------------------------------
    def _on_hello_reject(self, reason: str) -> None:
        BUS.count("fleet.hello.rejected")
        BUS.instant("fleet.hello.reject", cat="fleet", reason=reason[:200])
        self._hello_rejections.append(reason)
        del self._hello_rejections[:-16]  # keep the tail only

    def _on_dial_in(self, hello: dict, transport: Transport) -> None:
        """Listener callback: attach a validated dial-in to its slot."""
        wid = int(hello["worker"])
        if not 0 <= wid < len(self._workers):
            raise HelloError(f"hello for unknown worker slot {wid}")
        w = self._workers[wid]
        with w.lock:
            if self._closed:
                raise HelloError("router is shutting down")
            if hello.get("token") != w.conn_token:
                raise HelloError(
                    f"stale or foreign dial-in token for worker {wid} "
                    f"(incarnation {w.incarnation})"
                )
            if w.transport is not None and not w.transport.closed:
                raise HelloError(f"worker {wid} already connected")
            transport = self._wrap_transport(w, transport)
            w.transport = transport
            incarnation = w.incarnation
        self._register_hello(w, hello)
        threading.Thread(
            target=self._reader,
            args=(w, incarnation, transport),
            name=f"fleet-reader-{w.id}.{incarnation}",
            daemon=True,
        ).start()

    def _connect_remote(self, w: _Worker) -> None:
        """Dial one externally started worker (``--listen``) until it
        answers with a valid hello or the ready timeout passes."""
        deadline = time.monotonic() + self.config.ready_timeout_s
        while not self._closed and time.monotonic() < deadline:
            state = self._chaos.get(w.id)
            if state is not None and state.partitioned:
                # A partitioned endpoint cannot complete a dial either —
                # the redial loop keeps knocking until the drill heals it.
                time.sleep(0.1)
                continue
            try:
                hello, transport = connect_to_worker(
                    w.addr, pipelined=self.config.pipelined_io
                )
            except HelloError as e:
                self._on_hello_reject(str(e))
                return  # incompatible peer: retrying cannot fix a version
            except OSError:
                time.sleep(0.2)
                continue
            if int(hello.get("worker", -1)) != w.id:
                # A misconfigured endpoint (two --listen workers started
                # with the same --worker-id, or the wrong port listed):
                # registering it anyway would mis-attribute every
                # response's `worker` field, the per-worker SLO breakdown,
                # and the session pins — silently. Redialing the same
                # endpoint cannot fix a config error, so fail loud.
                self._on_hello_reject(
                    f"worker at {w.addr} says --worker-id "
                    f"{hello.get('worker')}, but this slot is {w.id} — "
                    f"fix the --worker-id/--fleet-workers pairing"
                )
                transport.close(flush=False)
                return
            with w.lock:
                w.incarnation += 1
                incarnation = w.incarnation
                transport = self._wrap_transport(w, transport)
                w.transport = transport
            self._register_hello(w, hello)
            threading.Thread(
                target=self._reader,
                args=(w, incarnation, transport),
                name=f"fleet-reader-{w.id}.{incarnation}",
                daemon=True,
            ).start()
            return

    def _register_hello(self, w: _Worker, hello: dict) -> None:
        w.caps = dict(hello.get("caps") or {})
        w.lane_advertised = bool(w.caps.get("lane"))
        if w.caps.get("crc") and w.transport is not None:
            # The worker parses checksummed frames: emit them. The worker
            # side flips on by echo — its first checksummed inbound frame
            # (fleet/transport.py, "CRC negotiation").
            w.transport.enable_crc()
        if w.caps.get("wire") and w.transport is not None:
            # The worker parses B-frames: section-bearing payloads pass
            # through binary. Workers flip on by the same echo rule.
            w.transport.enable_wire()
        w.last_pong = time.monotonic()
        w.ready.set()

    # -- the channel reader (one per incarnation) ----------------------
    def _reader(self, w: _Worker, incarnation: int, transport: Transport) -> None:
        while True:
            frame = transport.recv()
            if frame is None:
                break
            if "ready" in frame:
                # Pipe mode: the hello arrives in-band as the first frame.
                try:
                    hello = check_hello(frame)
                except HelloError as e:
                    self._on_hello_reject(str(e))
                    break  # incompatible peer: drop the channel
                self._register_hello(w, hello)
                continue
            if "pong" in frame:
                w.last_pong = time.monotonic()
                continue
            if "bye" in frame:
                continue
            rid = frame.get("id")
            resp = frame.get("resp")
            if rid is None or not isinstance(resp, dict):
                continue
            w.last_pong = time.monotonic()  # a response proves liveness too
            with w.lock:
                pending = w.pending.pop(rid, None)
            if pending is None:
                # A response for a request we already re-queued elsewhere
                # (the worker was declared dead but limped on). Results are
                # content-addressed, so the duplicate is discardable.
                BUS.count("fleet.duplicate.response")
                continue
            self._release_slot(w)
            self._record_hop(pending, frame.get("t"))
            if resp.get("ok") and resp.get("op") in (
                "update", "publish", "subscribe"
            ):
                # update/publish rename the pinned digest along the chain;
                # subscribe pins the head it returned (no predecessor).
                self._note_session(
                    resp.get("digest"), w.id, prev=resp.get("prev_digest")
                )
            if resp.get("ok") and resp.get("digest"):
                # Forwarding's owner-of-record: this worker now holds the
                # digest's result warm, wherever the ring says it *should*
                # live.
                self._note_served(str(resp["digest"]), w.id)
            pending.response = resp
            pending.worker_id = w.id
            pending.event.set()
        transport.close(flush=False)  # channel already dead: never wait on it
        self._on_death(w, incarnation)

    @staticmethod
    def _release_slot(w: _Worker) -> None:
        try:
            w.slots.release()
        except ValueError:
            pass  # slot already reclaimed by a respawn's fresh semaphore

    @staticmethod
    def _record_hop(p: _Pending, service_s) -> None:
        """Hop latency = send-to-response wall time minus the worker's own
        service time: what the transport, framing, queueing, and router
        bookkeeping cost this request — the number a pipe-vs-TCP choice
        moves, tracked per class so the SLO report can carry it."""
        if p.sent_at is None:
            return
        try:
            service = float(service_s or 0.0)
        except (TypeError, ValueError):
            service = 0.0
        hop = max(0.0, time.monotonic() - p.sent_at - service)
        BUS.record("fleet.hop_s", hop)
        if p.cls:
            BUS.record(f"fleet.hop_s.{p.cls}", hop)

    def _note_session(
        self, digest: Optional[str], worker_id: int, prev: Optional[str]
    ) -> None:
        if not digest:
            return
        with self._ring_lock:
            if prev:
                self._sessions.pop(prev, None)
            self._sessions[digest] = worker_id
            while len(self._sessions) > _SESSION_MAP_CAP:
                self._sessions.pop(next(iter(self._sessions)))
        if self._journal is not None:
            try:
                self._journal.pin(digest, worker_id, prev=prev)
            except (OSError, TimeoutError):
                # A lost pin degrades to one post-restart ring-routed hop
                # (the session worker answers `no session` / stale and the
                # chain re-syncs) — never to a lost query.
                BUS.count("fleet.router.journal.pin_failed")

    def _note_served(self, digest: str, worker_id: int) -> None:
        with self._ring_lock:
            self._last_served[digest] = worker_id
            self._last_served.move_to_end(digest)
            while len(self._last_served) > _FORWARD_MAP_CAP:
                self._last_served.popitem(last=False)

    # -- health --------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        cfg = self.config
        lease_s = cfg.effective_lease_s
        seq = 0
        while not self._closed:
            time.sleep(cfg.heartbeat_interval_s)
            for w in self._workers:
                if self._closed:
                    return
                if not (w.alive and w.ready.is_set()):
                    continue
                if w.draining:
                    # A worker in graceful drain stops reading its channel
                    # on purpose — silence is the PROTOCOL there, not a
                    # wedge. Lease expiry on a draining worker would
                    # declare it dead mid-flush and re-queue work it is
                    # about to answer (duplicate solves, a spurious
                    # fleet.worker.dead in a planned scale-down), so the
                    # heartbeat skips it entirely; retire_worker owns its
                    # deadline.
                    continue
                age = time.monotonic() - w.last_pong
                if age > lease_s:
                    # The channel is still open but the worker went silent
                    # past its lease: a wedged process, or a half-dead
                    # network path TCP keepalive hasn't noticed.
                    BUS.count("fleet.heartbeat.miss")
                    if w.transport is not None and w.transport.kind == "tcp":
                        BUS.count("fleet.lease.expired")
                    self._on_death(w, w.incarnation)
                    continue
                seq += 1
                try:
                    with w.lock:
                        if w.transport is not None:
                            w.transport.send({"ping": seq})
                except OSError:
                    self._on_death(w, w.incarnation)

    def _on_death(self, w: _Worker, incarnation: int) -> None:
        """Declare one incarnation dead exactly once: fail over its pending
        requests, drop its ring share + session pins, schedule a restart.
        A *retiring* worker's channel EOF lands here too — that exit is on
        purpose (drain frame sent, responses flushed), so it closes the
        slot quietly: no death counter, no kill, no restart."""
        with self._ring_lock:
            if w.incarnation != incarnation or not w.alive:
                return
            w.alive = False
            w.ready.clear()
            retiring = w.draining
            if retiring:
                w.retired = True
            self._ring.remove(w.id)
            if w.id in self._lane_ids:
                self._lane_ring.remove(w.id)
            for digest in [
                d for d, wid in self._sessions.items() if wid == w.id
            ]:
                del self._sessions[digest]
            for digest in [
                d for d, wid in self._last_served.items() if wid == w.id
            ]:
                # Its warm copies died with it (memory) or became
                # unreachable (its host-local disk): stop forwarding there.
                del self._last_served[digest]
        self._journal_ring("retire" if retiring else "remove", w)
        with w.lock:
            orphans = list(w.pending.values())
            w.pending.clear()
            proc = w.proc
            transport = w.transport
        if transport is not None:
            # flush=False: this is the death path — waiting on a wedged
            # peer's full TCP window here would stall the heartbeat thread
            # (and every other worker's failover) for the flush timeout.
            transport.close(flush=False)
        if retiring:
            # Planned exit: retire_worker() owns the reap and the
            # fleet.scale.down accounting. Anything still pending (the
            # drain deadline fired with work in flight) re-queues onto
            # survivors — retirement must uphold zero-loss like any other
            # departure.
            if orphans and not self._closed:
                self._redispatch(orphans)
            elif orphans:
                for p in orphans:
                    p.response = {
                        "ok": False, "error": "fleet shutting down",
                        "op": p.request.get("op"),
                    }
                    p.event.set()
            return
        if not self._closed:  # drained workers EOF on purpose: not a death
            BUS.count("fleet.worker.dead")
            BUS.instant("fleet.worker.death", cat="fleet", worker=w.id,
                        incarnation=incarnation, orphans=len(orphans))
        if proc is not None and proc.poll() is None and not self._closed:
            # During shutdown the channel closes BEFORE the process exits
            # (a TCP worker tears its socket down, then flushes obs and
            # returns 0) — killing here would turn every graceful drain
            # into a SIGKILL. shutdown() owns the reap (and the kill, past
            # its deadline); outside shutdown a dead channel means the
            # incarnation is done: make sure the process is too.
            try:
                proc.kill()
            except OSError:
                pass
        if orphans and not self._closed:
            threading.Thread(
                target=self._redispatch, args=(orphans,),
                name=f"fleet-requeue-{w.id}", daemon=True,
            ).start()
        elif orphans:
            for p in orphans:  # shutting down: answer rather than hang
                p.response = {
                    "ok": False, "error": "fleet shutting down",
                    "op": p.request.get("op"),
                }
                p.event.set()
        if not self._closed:
            threading.Thread(
                target=self._restart, args=(w,),
                name=f"fleet-restart-{w.id}", daemon=True,
            ).start()

    def _redispatch(self, orphans: List[_Pending]) -> None:
        for p in orphans:
            p.requeues += 1
            BUS.count("fleet.requeue")
            # Failover continues the original trace: re-activate the wire
            # context captured at first dispatch, so the requeue span (and
            # the second worker's spans under it) keep the trace_id while
            # parenting to the attempt that lost its worker.
            with tracing.activated(tracing.from_wire(p.trace)), \
                    BUS.span("fleet.requeue.dispatch", cat="fleet",
                             requeues=p.requeues):
                err = self._dispatch(p, allow_shed=False)
            if err is not None:
                p.response = err
                p.event.set()

    def _backoff_s(self, worker_id: int, attempt: int) -> float:
        """The jittered restart backoff for one (worker, attempt) pair.

        Capped exponential, then scaled DOWN by a deterministic per-pair
        jitter: ``sha256(seed:worker:attempt)`` -> u in [0,1), backoff *=
        (1 - restart_jitter * u). Scaling down (never up) keeps the cap a
        real ceiling while desynchronizing a mass death's restart wave —
        N workers that died together stop hammering the shared disk store
        and compile cache at the same instant. Fully reproducible under
        ``restart_jitter_seed`` (the property the jitter test pins)."""
        cfg = self.config
        backoff = min(
            cfg.restart_backoff_base_s * (2 ** attempt),
            cfg.restart_backoff_cap_s,
        )
        if cfg.restart_jitter <= 0:
            return backoff
        token = f"{cfg.restart_jitter_seed}:{worker_id}:{attempt}"
        u = int.from_bytes(
            hashlib.sha256(token.encode("utf-8")).digest()[:8], "big"
        ) / float(1 << 64)
        return backoff * (1.0 - cfg.restart_jitter * u)

    def _restart(self, w: _Worker) -> None:
        cfg = self.config
        while not self._closed:
            if w.retired:
                return  # a planned departure is never restarted
            if w.restarts >= cfg.max_restarts:
                BUS.count("fleet.worker.abandoned")
                # The slot is gone for good — it must leave pool_size(),
                # or the autoscaler would forever count phantom capacity
                # and refuse to scale up past a crash-looped worker
                # ("already at max" while real capacity is below it).
                with self._ring_lock:
                    w.retired = True
                self._journal_ring("retire", w)
                return
            backoff = self._backoff_s(w.id, w.restarts)
            w.restarts += 1
            time.sleep(backoff)
            if self._closed:
                return
            if w.addr is not None:
                # Remote worker: re-dial. The process (and its caches) may
                # have survived a mere connection loss — the hello-led
                # reconnect is then a warm rejoin, not a cold restart.
                self._connect_remote(w)
            else:
                try:
                    self._spawn(w)
                except OSError:
                    continue
            if w.ready.wait(cfg.ready_timeout_s):
                with self._ring_lock:
                    w.alive = True
                    w.last_pong = time.monotonic()
                    self._ring.add(w.id)
                    if w.id in self._lane_ids:
                        self._lane_ring.add(w.id)
                self._journal_ring("add", w)
                BUS.count("fleet.worker.restart")
                BUS.instant("fleet.worker.rejoin", cat="fleet", worker=w.id,
                            incarnation=w.incarnation, backoff_s=backoff)
                return
            with w.lock:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                if w.transport is not None:
                    w.transport.close()

    # -- elastic pool (fleet/autoscaler.py drives these) ---------------
    def pool_size(self) -> int:
        """Worker slots currently in (or rejoining) the pool: everything
        not retired and not mid-drain. A slot whose process is restarting
        still counts — the pool's *intent* is N workers; the autoscaler
        must not scale up just because a restart is in flight."""
        return sum(
            1 for w in self._workers if not w.retired and not w.draining
        )

    def queue_depths(self) -> Dict[int, int]:
        """Live per-worker in-flight depth (the autoscaler's queue-pressure
        signal; draining/retired slots excluded — their depth is drain
        progress, not demand)."""
        return {
            w.id: len(w.pending)
            for w in self._workers
            if w.alive and not w.draining
        }

    def note_scale_decision(self, decision: dict) -> None:
        """Record the latest scale decision (the stats op reports it, so an
        operator can see WHY the fleet is its current size). With a
        journal, the decision — wall-clock stamped — is durable too: a
        restarted router hands it back to its autoscaler, whose cooldown
        then spans the crash instead of resetting (a crash-loop must not
        double-scale a fleet that just scaled)."""
        decision = dict(decision)
        decision.setdefault("at", time.time())
        self.last_scale_decision = decision
        if self._journal is not None:
            try:
                self._journal.scale(decision)
            except (OSError, TimeoutError):
                BUS.count("fleet.router.journal.scale_failed")

    def add_worker(
        self, *, addr: Optional[str] = None,
        timeout_s: Optional[float] = None,
    ) -> dict:
        """Grow the pool by one WARM worker; returns ``{"worker", "warm_s"}``.

        The joiner is spawned with the fleet's full flag set — shared disk
        store, persistent compile cache, warmup buckets — so it pre-seeds
        and precompiles before saying hello, and it enters the hash ring
        only once its hello's ``warmed`` capability is confirmed: scale-up
        can never route interactive traffic at a cold worker. The warm
        join wall time lands on ``fleet.join.warm_s`` (the elastic gate
        bounds its p95) and the join counts ``fleet.scale.up``.

        ``addr`` instead DIALS an externally started ``--listen`` worker
        (an operator bringing standby capacity into a remote fleet: the
        same warm gate applies — that worker's service, caches, and warmup
        already exist, which is the whole point of a standby).
        """
        if self.config.remote_workers and addr is None:
            raise ValueError(
                "add_worker spawns processes; growing a --fleet-workers "
                "remote topology needs the standby's endpoint: "
                "add_worker(addr='host:port')"
            )
        if addr is not None and self.config.transport != "tcp":
            raise ValueError("dialing a remote joiner needs transport='tcp'")
        if self._closed or not self._started:
            raise RuntimeError("router is not running")
        with self._pool_lock:
            t0 = time.monotonic()
            w = _Worker(len(self._workers), self.config.queue_depth,
                        addr=addr)
            if self.config.sharded_lane_workers == -1 and addr is None:
                # "-1 = every worker" includes workers that join later.
                self._lane_ids.add(w.id)
            self._workers.append(w)
            if addr is not None:
                threading.Thread(
                    target=self._connect_remote, args=(w,),
                    name=f"fleet-dial-{w.id}", daemon=True,
                ).start()
            else:
                self._spawn(w)
            deadline = timeout_s or self.config.ready_timeout_s
            if not w.ready.wait(deadline):
                self._abandon_join(w)
                BUS.count("fleet.scale.failed")
                rejections = "; ".join(self._hello_rejections[-3:])
                raise TimeoutError(
                    f"joining worker {w.id} not ready within {deadline}s"
                    + (f" (hello rejected: {rejections})" if rejections
                       else "")
                )
            if not w.caps.get("warmed", False):
                self._abandon_join(w)
                BUS.count("fleet.join.cold_rejected")
                raise RuntimeError(
                    f"joining worker {w.id} said hello without the "
                    f"'warmed' capability — a cold joiner would serve "
                    f"cold p99s, refusing ring entry"
                )
            warm_s = time.monotonic() - t0
            with self._ring_lock:
                w.alive = True
                w.last_pong = time.monotonic()
                self._ring.add(w.id)
                if addr is not None and w.lane_advertised:
                    # A dialed standby declares its own lane capability.
                    self._lane_ids.add(w.id)
                if w.id in self._lane_ids:
                    self._lane_ring.add(w.id)
            self._journal_ring("add", w)
            BUS.count("fleet.scale.up")
            BUS.record("fleet.join.warm_s", warm_s)
            BUS.instant("fleet.join", cat="fleet", worker=w.id,
                        warm_s=round(warm_s, 4),
                        warmup=w.caps.get("warmup"))
            return {"worker": w.id, "warm_s": warm_s}

    def _abandon_join(self, w: _Worker) -> None:
        """A join that never got warm: close the slot without it ever
        having owned keyspace (it was never on the ring)."""
        with self._ring_lock:
            w.retired = True
            w.draining = False
            w.alive = False
            w.ready.clear()
        self._journal_ring("retire", w)
        with w.lock:
            proc, transport = w.proc, w.transport
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass
        if transport is not None:
            transport.close(flush=False)

    def retire_worker(
        self, worker_id: Optional[int] = None, *, timeout_s: float = 30.0
    ) -> dict:
        """Drain one worker out of the pool (scale-down); returns
        ``{"worker", "sessions_moved", "exit_code"}``.

        Victim (when not pinned by ``worker_id``): the live worker with the
        fewest ``_last_served`` affinity entries — the one whose warm
        result cache the fleet would miss least; ties retire the youngest
        slot (a recent joiner before a long-warmed original). Sequence:

        1. off the ring immediately (its keyspace hands off with bounded
           movement; no NEW work routes at it) and marked ``draining`` —
           the heartbeat loop now ignores it, so a slow drain cannot trip
           ``fleet.lease.expired`` and re-queue work mid-flush;
        2. in-flight accepted work drains (bounded by ``timeout_s``;
           whatever outlives the deadline re-queues onto survivors at EOF
           — zero loss either way);
        3. pinned update/stream session digests unpin — their ring
           inheritors recover state exactly like failover does: disk-store
           reads for results, snapshot+WAL replay for streams (zero fresh
           solves, the contract the elastic drill gates);
        4. a drain frame: the worker stops reading, flushes every
           response, exports its obs JSONL, and exits 0.
        """
        with self._pool_lock:
            with self._ring_lock:
                live = [
                    w for w in self._workers
                    if w.alive and w.ready.is_set()
                    and not w.draining and not w.retired
                ]
                if worker_id is not None:
                    w = self._workers[worker_id]
                    if w.retired or w.draining or not w.alive:
                        raise ValueError(
                            f"worker {worker_id} is not live "
                            f"(retired={w.retired}, draining={w.draining})"
                        )
                else:
                    if not live:
                        raise ValueError("no live worker to retire")
                    affinity: Dict[int, int] = {}
                    for wid in self._last_served.values():
                        affinity[wid] = affinity.get(wid, 0) + 1
                    w = min(
                        live,
                        key=lambda c: (affinity.get(c.id, 0), -c.id),
                    )
                if len(live) <= 1:
                    raise ValueError("cannot retire the last live worker")
                w.draining = True
                self._ring.remove(w.id)
                self._lane_ring.remove(w.id)
                for digest in [
                    d for d, wid in self._last_served.items()
                    if wid == w.id
                ]:
                    # Its in-memory warm copies leave with it; survivors
                    # fall back to the shared disk store (or a forward
                    # miss + local solve across hosts).
                    del self._last_served[digest]
            deadline = time.monotonic() + timeout_s
            flushed = True
            while time.monotonic() < deadline:
                with w.lock:
                    if not w.pending:
                        break
                time.sleep(0.02)
            else:
                flushed = False  # EOF re-queue covers what's left
            with self._ring_lock:
                moved = [
                    d for d, wid in self._sessions.items() if wid == w.id
                ]
                for d in moved:
                    del self._sessions[d]
            with w.lock:
                transport = w.transport
                proc = w.proc
            if transport is not None and not transport.closed:
                try:
                    transport.send({"drain": True})
                except OSError:
                    pass
            # The reap gets a grace floor beyond the flush deadline: work
            # that outlived timeout_s re-queues at EOF anyway, but a drain
            # that is ALMOST done should exit 0, not eat a SIGKILL at the
            # buzzer.
            exit_code = None
            if proc is not None:
                try:
                    proc.wait(timeout=max(10.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
                exit_code = proc.returncode
            elif transport is not None:
                t_end = max(time.monotonic() + 10.0, deadline)
                while time.monotonic() < t_end and not transport.closed:
                    time.sleep(0.02)
            with self._ring_lock:
                # The reader's EOF normally lands in _on_death and marks
                # these; make retirement unconditional even if the reader
                # thread lost the race.
                w.alive = False
                w.retired = True
                w.ready.clear()
            if transport is not None:
                transport.close(flush=False)
            self._journal_ring("retire", w)
            BUS.count("fleet.scale.down")
            BUS.instant(
                "fleet.retire", cat="fleet", worker=w.id,
                sessions_moved=len(moved), flushed=flushed,
                exit_code=exit_code,
            )
            return {
                "worker": w.id,
                "sessions_moved": len(moved),
                "exit_code": exit_code,
            }

    # -- routing + dispatch --------------------------------------------
    def _routing_key(self, request: dict) -> Optional[str]:
        op = request.get("op")
        if op == "update":
            return request.get("digest")
        if op in ("subscribe", "publish", "poll"):
            # Stream ops ride the update-session digest-chain pinning: the
            # head digest (session-pinned, renamed by every publish
            # response) keeps a stream on the worker whose windowed
            # session is live; the stream id is the stable fallback so
            # polls without a head still hash consistently.
            return request.get("digest") or request.get("stream")
        if op == "solve":
            if "digest" in request:
                return str(request["digest"])  # client-side hint
            if "graph_path" in request:
                return str(request["graph_path"])  # stable path identity
            if "edges" in request:
                from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
                    Graph,
                )

                return Graph.from_edges(
                    int(request["num_nodes"]), request["edges"]
                ).digest()
            if SECTIONS_KEY in request and "num_nodes" in request:
                # Binary solve without a digest hint: the one routing
                # case that must decode sections. ``to_wire()`` always
                # stamps the digest into the header, so a well-formed
                # binary client never lands here.
                from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
                    Graph,
                )

                return Graph.from_wire(request).digest()
        return None

    def _route(
        self, key: Optional[str], *, lane: bool = False, count: bool = True
    ) -> Optional[_Worker]:
        """``count=False`` is the side-effect-free peek the forwarding
        probe uses to learn the prospective target — the lane-routing
        counters must reflect dispatches only (``fleet.route
        .lane_fallback`` is documented as the all-lane-workers-down
        signal; a probe pre-pass must not double it)."""
        with self._ring_lock:
            if key is not None:
                wid = self._sessions.get(key)
                if wid is not None and self._workers[wid].alive:
                    return self._workers[wid]
                if lane:
                    # Oversize: prefer a mesh-owning worker (cache
                    # affinity within the lane subring). All lane workers
                    # down -> fall through to the full ring: a bypass
                    # solve is slow, never wrong.
                    try:
                        wid = self._lane_ring.assign(key)
                        if count:
                            BUS.count("fleet.route.sharded_lane")
                        return self._workers[wid]
                    except LookupError:
                        if count:
                            BUS.count("fleet.route.lane_fallback")
                try:
                    return self._workers[self._ring.assign(key)]
                except LookupError:
                    return None
            live = [
                w for w in self._workers
                if w.alive and w.ready.is_set() and not w.draining
            ]
            if not live:
                return None
            self._rr += 1
            return live[self._rr % len(live)]

    def _dispatch(
        self, p: _Pending, *, allow_shed: bool = True
    ) -> Optional[dict]:
        """Queue ``p`` on the worker owning its key. Returns ``None`` once
        accepted (a response will land on ``p.event``) or a terminal
        error/shed response dict."""
        cfg = self.config
        # The trace context to put on the wire: the caller's active one
        # (handle()'s attempt span), else the context ``p`` was first
        # dispatched under — the monitor thread's failover re-dispatch
        # path, where the contextvar is long gone.
        wire = tracing.wire_context()
        if wire is None:
            wire = p.trace
        deadline = time.monotonic() + cfg.request_timeout_s
        while True:
            if self._closed:
                return {"ok": False, "op": p.request.get("op"),
                        "error": "fleet shutting down"}
            w = self._route(p.key, lane=p.lane)
            if w is None:
                if time.monotonic() >= deadline:
                    BUS.count("fleet.unroutable")
                    return {"ok": False, "op": p.request.get("op"),
                            "error": "no live workers"}
                time.sleep(0.02)  # workers restarting; the ring will refill
                continue
            incarnation = w.incarnation
            if not w.slots.acquire(blocking=False):
                if allow_shed and p.cls in cfg.shed_classes:
                    BUS.count("fleet.shed")
                    return {"ok": False, "op": p.request.get("op"),
                            "shed": True, "worker": w.id,
                            "error": f"shed: worker {w.id} queue full"}
                # Backpressure: wait briefly, then re-check liveness (a
                # worker dying with a full queue must not wedge us here).
                if not w.slots.acquire(timeout=0.05):
                    if time.monotonic() >= deadline:
                        return {"ok": False, "op": p.request.get("op"),
                                "error": f"admission timeout on worker {w.id}"}
                    continue
            rid = None
            try:
                with w.lock:
                    if (not w.alive or w.incarnation != incarnation
                            or w.transport is None):
                        raise OSError("worker died during dispatch")
                    with self._id_lock:
                        self._next_id += 1
                        rid = self._next_id
                    w.pending[rid] = p
                    p.sent_at = time.monotonic()
                    frame = {"id": rid, "req": p.request}
                    if wire is not None and w.caps.get("trace"):
                        # Gated on the hello capability: a legacy worker
                        # without caps.trace gets the untraced frame shape
                        # it has always parsed.
                        frame["trace"] = wire
                    w.transport.send(frame)
            except OSError:
                if rid is not None:
                    with w.lock:
                        w.pending.pop(rid, None)
                self._release_slot(w)
                self._on_death(w, incarnation)
                continue
            BUS.count("fleet.dispatch")
            if SECTIONS_KEY in p.request:
                # Binary payload: the transport passed the sections
                # through opaquely (caps.wire peers — the O(header) hop)
                # or folded them to classic JSON for a legacy worker.
                BUS.count(
                    "fleet.wire.passthrough" if w.caps.get("wire")
                    else "fleet.wire.fallback_json"
                )
            BUS.sample(f"fleet.queue.depth.{w.id}", len(w.pending))
            return None

    # -- payload verification (round 19, docs/VERIFICATION.md) ----------
    @staticmethod
    def _certify_solve_response(request: dict, response: dict):
        """Certify a solve response against the request it answers —
        ``None`` when the pair carries no verifiable claim (echo fleets,
        digest-only requests, responses without ``mst_edges``), else the
        :class:`verify.certify.Certificate`. NumPy engine: the router
        touches no device by design and the claim arrives as plain JSON
        anyway.
        Binary requests certify too — folding the edge sections here is
        deliberate: certification is the one router path that is ABOUT
        the edges, so it pays to decode them (forwarded hits only,
        never the passthrough dispatch)."""
        if request.get("op") != "solve" or "num_nodes" not in request:
            return None
        if "edges" not in request:
            if SECTIONS_KEY not in request:
                return None
            request = fold_sections(request)
            if "edges" not in request:
                return None
        if not isinstance(response.get("mst_edges"), list):
            return None
        from distributed_ghs_implementation_tpu_torch.verify.certify import (
            Certificate,
            certify_claim,
        )

        # Analytics kinds certify with their own adapters (the request's
        # kind travels on the forwarding probe, so a forwarded hit is
        # verified kind-correctly). A path_max response's edge payload IS
        # the owner's MST, so it certifies as an mst claim.
        kind = str(request.get("kind", "mst"))
        if kind == "path_max":
            kind = "mst"
        try:
            return certify_claim(
                request["num_nodes"], request["edges"],
                response["mst_edges"],
                total_weight=response.get("total_weight"), engine="np",
                kind=kind,
                k=request.get("k"),
                num_components=response.get("num_components"),
                bottleneck_weight=response.get("bottleneck_weight"),
            )
        except Exception as e:  # noqa: BLE001 — a crash here would turn
            # the designed reject-and-re-solve path into an unhandled
            # error on exactly the adversarial payloads it exists for.
            return Certificate(
                ok=False, reason="malformed_claim",
                detail=f"{type(e).__name__}: {e}", engine="np",
            )

    # -- cache-miss forwarding -----------------------------------------
    def _forward_probe(
        self, request: dict, key: Optional[str], cls: Optional[str],
        lane: bool,
    ) -> Tuple[Optional[dict], bool]:
        """The cross-host affinity hop: when a solve is about to land on a
        worker that is NOT the digest's owner-of-record, ask the owner
        first with a tiny ``cached_only`` frame (digest + backend — never
        the edge list). A hit returns the owner's cached result without
        any local solve (``fleet.forward.hit``); a miss falls through to
        the normal dispatch, which solves locally
        (``fleet.forward.miss``). Returns ``(response_or_None,
        rejected)``: when the request carries its edge list the probe asks
        for the owner's MST edges too and the hit payload is CERTIFIED
        before it is served (``verify_forward``, mandatory by default) — a
        failed certificate drops the poisoned forwarding affinity, counts
        ``fleet.forward.rejected`` + ``verify.failed``, and reports
        ``rejected=True`` so the caller counts the local re-solve as
        ``verify.corrected``."""
        if key is None or request.get("op") != "solve":
            return None, False
        if request.get("cached_only"):
            return None, False  # already a probe: no recursion
        target = self._route(key, lane=lane, count=False)  # peek only
        if target is None:
            return None, False
        with self._ring_lock:
            owner = self._last_served.get(key)
            if owner is None and lane:
                # No serving history: the lane steered this dispatch away
                # from the full-ring owner — the worker affinity WOULD have
                # chosen. Ask it (the literal "ask the digest-owner
                # first"); on the first-ever solve this is a recorded miss.
                try:
                    owner = self._ring.assign(key)
                except LookupError:
                    owner = None
        if owner is None or owner == target.id:
            return None, False
        ow = self._workers[owner]
        if not (ow.alive and ow.ready.is_set() and not ow.draining):
            return None, False  # a draining owner is leaving: don't queue on it
        probe = {"op": "solve", "digest": key, "cached_only": True}
        # The query kind (and its parameters) must travel on the probe:
        # per-kind cache keys mean the owner's mst entry says nothing
        # about its components entry, and a kind-blind probe would serve
        # an MST answer to a components query (docs/ANALYTICS.md).
        kind = str(request.get("kind", "mst"))
        if kind != "mst":
            probe["kind"] = kind
            for param in ("k", "u", "v", "labels_out"):
                if param in request:
                    probe[param] = request[param]
        verifiable = (
            self.config.verify_forward
            and "edges" in request and "num_nodes" in request
        )
        if verifiable:
            # The certificate needs the claimed edge set; the probe is no
            # longer "tiny" for verifiable requests, but the response was
            # always the full result — this only sizes the hit payload.
            probe["edges_out"] = True
        if "backend" in request:
            probe["backend"] = request["backend"]
        with BUS.span("fleet.forward.probe", cat="fleet", owner=owner):
            resp = self._request_worker(
                ow, probe,
                timeout_s=min(_FORWARD_PROBE_TIMEOUT_S,
                              self.config.request_timeout_s),
                # A saturated owner (no free admission slot) is a miss,
                # not something to wait out: the probe must not queue
                # behind slow solves or starve real requests of the
                # owner's slots.
                slot_timeout_s=_FORWARD_PROBE_SLOT_TIMEOUT_S,
            )
        if resp and resp.get("ok"):
            if verifiable:
                cert = self._certify_solve_response(request, resp)
                if cert is not None and not cert.ok:
                    # The owner's payload is wrong (corrupted cache, bad
                    # link, lying peer): never serve it. Drop the
                    # affinity so the next query doesn't re-probe the
                    # same poison, and fall through to a local solve.
                    BUS.count("verify.failed")
                    BUS.count("fleet.forward.rejected")
                    BUS.instant(
                        "fleet.forward.reject", cat="fleet",
                        worker=owner, reason=cert.reason,
                    )
                    with self._ring_lock:
                        if self._last_served.get(key) == owner:
                            del self._last_served[key]
                    return None, True
                if cert is not None:
                    BUS.count("fleet.forward.verified")
            BUS.count("fleet.forward.hit")
            out = dict(resp)
            if verifiable and not request.get("edges_out"):
                out.pop("mst_edges", None)  # the probe asked, not the client
            out["forwarded_from"] = owner
            out.setdefault("worker", owner)
            if cls is not None:
                out.setdefault("slo_class", cls)
            return out, False
        BUS.count("fleet.forward.miss")
        return None, False

    # -- the service surface -------------------------------------------
    def handle(self, request: dict) -> dict:
        """One request, same contract as ``MSTService.handle``."""
        op = request.get("op")
        if op == "stats":
            return self._stats()
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        cls = sanitize_class(request.get("slo_class"))
        span_args = {"op": str(op)}
        if cls is not None:
            span_args["cls"] = cls
        # The fleet front door: mint (or join) the request's trace context
        # before the root span opens, so every span below — here and on
        # whichever workers the request visits — shares one trace_id.
        with tracing.front_door(cls), \
                BUS.span("fleet.request", cat="fleet", **span_args) as span:
            BUS.count("fleet.requests")
            try:
                key = self._routing_key(request)
            except Exception as e:  # noqa: BLE001 — bad request, not a crash
                BUS.count("fleet.errors")
                return {"ok": False, "op": op,
                        "error": f"{type(e).__name__}: {e}"}
            # lane preference only exists in a fleet that HAS lane
            # workers — otherwise every oversize request would probe the
            # empty lane ring and pollute the lane_fallback counter
            # (documented as the all-lane-workers-down signal).
            lane = bool(self._lane_ids) and _request_oversize(request)
            jid = None
            if self._journal is not None:
                # The accept ack is GATED on the durable append: dispatch
                # happens only after the journal fsync returns, so a
                # router crash can never lose an acknowledged query. A
                # journal that cannot append refuses the work — accepting
                # without durability would be the round-12 router again.
                try:
                    # Binary payloads journal in their folded JSON form:
                    # the journal is JSONL by schema, and a successor
                    # router must be able to re-dispatch the replayed
                    # request at ANY worker, caps.wire or not.
                    jid = self._journal.accept(
                        fold_sections(request), key=key, cls=cls, lane=lane,
                        trace=tracing.wire_context(),
                    )
                except (OSError, TimeoutError) as e:
                    BUS.count("fleet.errors")
                    span.set(ok=False)
                    err = {"ok": False, "op": op,
                           "error": f"journal append failed: {e}"}
                    if self._closed:
                        # The append lost the race with crash(): the
                        # query was never acknowledged — clients retry on
                        # the successor like any crash-window request.
                        err["router_crashed"] = True
                    return err
            corrected = False  # a verification rejection forced a re-solve
            if self.config.forward_enabled:
                forwarded, rejected = self._forward_probe(
                    request, key, cls, lane
                )
                corrected = rejected
                if forwarded is not None:
                    span.set(ok=True, worker=forwarded.get("worker"),
                             forwarded=True)
                    self._journal_answer(
                        jid, ok=True, worker=forwarded.get("worker"),
                        digest=forwarded.get("digest"),
                    )
                    return forwarded
            for attempt in (0, 1):
                p = _Pending(request, key, cls, lane=lane)
                # One attempt = dispatch + wait + certify, under its own
                # span: the worker-side spans parent to THIS attempt (the
                # wire context is captured inside it), so the merge can
                # price the transport hop as attempt-duration minus the
                # worker's in-span service time.
                with BUS.span(
                    "fleet.attempt", cat="fleet", attempt=attempt
                ) as aspan:
                    p.trace = tracing.wire_context()
                    err = self._dispatch(p)
                    if err is not None:
                        span.set(ok=False, shed=bool(err.get("shed")))
                        if not err.get("shed"):
                            BUS.count("fleet.errors")
                        if cls is not None:
                            err.setdefault("slo_class", cls)
                        if not err.get("router_crashed"):
                            # A crashed router never acknowledged failure —
                            # those accepts stay unanswered so the restart
                            # replays them.
                            self._journal_answer(jid, ok=False)
                        return err
                    if not p.event.wait(self.config.request_timeout_s):
                        BUS.count("fleet.timeout")
                        span.set(ok=False)
                        self._forget(p)
                        self._journal_answer(jid, ok=False)
                        return {"ok": False, "op": op,
                                "error": "request timed out in the fleet"}
                    response = dict(p.response)
                    aspan.set(worker=p.worker_id)
                    if (
                        attempt == 0
                        and self.config.verify_responses
                        and response.get("ok")
                    ):
                        # Round 19: certify verifiable solve responses
                        # before they leave the router — the
                        # fleet.chaos.payload net. ONE re-dispatch on
                        # failure: the worker's own copy is good
                        # (in-flight corruption) or the worker's own
                        # verification corrects it (cache corruption). The
                        # replacement is re-certified below before it
                        # earns the corrected counter — a second
                        # consecutive bad answer is systemic and is
                        # refused, never served.
                        cert = self._certify_solve_response(
                            request, response
                        )
                        if cert is not None and not cert.ok:
                            BUS.count("verify.failed")
                            BUS.count("fleet.response.rejected")
                            BUS.instant(
                                "fleet.response.reject", cat="fleet",
                                worker=p.worker_id, reason=cert.reason,
                            )
                            corrected = True
                            continue
                    break
            if corrected and response.get("ok"):
                # The replacement must EARN the corrected counter: when
                # it is verifiable, re-certify it — a second consecutive
                # bad answer (systemic corruption) is refused loudly, not
                # served while the counters read "corrected".
                recheck = self._certify_solve_response(request, response)
                if recheck is not None and not recheck.ok:
                    BUS.count("verify.failed")
                    BUS.count("verify.unrecoverable")
                    span.set(ok=False)
                    self._journal_answer(jid, ok=False)
                    err = {
                        "ok": False, "op": op,
                        "error": "result failed verification even after "
                                 f"re-dispatch ({recheck.reason}: "
                                 f"{recheck.detail}) — refusing to serve",
                    }
                    if cls is not None:
                        err["slo_class"] = cls
                    return err
                BUS.count("verify.corrected")
            span.set(ok=bool(response.get("ok")), worker=p.worker_id,
                     requeues=p.requeues)
            if not response.get("router_crashed"):
                self._journal_answer(
                    jid, ok=bool(response.get("ok")), worker=p.worker_id,
                    digest=response.get("digest"),
                )
            response.setdefault("worker", p.worker_id)
            if p.requeues:
                response.setdefault("requeued", p.requeues)
            if cls is not None:
                response.setdefault("slo_class", cls)
            return response

    def _forget(self, p: _Pending) -> None:
        """Drop a timed-out pending from whichever worker holds it."""
        for w in self._workers:
            with w.lock:
                stale = [rid for rid, q in w.pending.items() if q is p]
                for rid in stale:
                    del w.pending[rid]
            for _ in stale:
                self._release_slot(w)
            if stale:
                return

    def _request_worker(
        self, w: _Worker, request: dict, timeout_s: float = 10.0,
        slot_timeout_s: Optional[float] = None,
    ) -> Optional[dict]:
        """A control-plane request pinned to one worker (stats fan-out,
        forwarding probes). ``slot_timeout_s`` bounds the admission-slot
        wait separately (probes give up fast on a saturated worker)."""
        p = _Pending(request, None, None)
        if not w.slots.acquire(
            timeout=timeout_s if slot_timeout_s is None else slot_timeout_s
        ):
            return None
        try:
            with w.lock:
                if not w.alive or w.transport is None:
                    self._release_slot(w)
                    return None
                with self._id_lock:
                    self._next_id += 1
                    rid = self._next_id
                w.pending[rid] = p
                p.sent_at = time.monotonic()
                frame = {"id": rid, "req": request}
                wire = tracing.wire_context()
                if wire is not None and w.caps.get("trace"):
                    frame["trace"] = wire
                w.transport.send(frame)
        except OSError:
            self._release_slot(w)
            return None
        if not p.event.wait(timeout_s):
            self._forget(p)
            return None
        return p.response

    def _stats(self) -> dict:
        counters: Dict[str, float] = {}
        workers_out = {}
        for w in self._workers:
            info = {
                "alive": w.alive,
                "incarnation": w.incarnation,
                "restarts": w.restarts,
                "pending": len(w.pending),
                "lane": w.id in self._lane_ids,
                "caps": dict(w.caps),
                # The elastic pool's operator view: is this slot serving
                # warm, leaving, or gone?
                "warmed": bool(w.caps.get("warmed")),
                "draining": w.draining,
                "retired": w.retired,
            }
            if w.addr is not None:
                info["addr"] = w.addr
            if w.transport is not None:
                info["transport"] = w.transport.kind
                info["channel_writes"] = w.transport.writes
                info["channel_frames"] = w.transport.frames
            if w.alive and w.ready.is_set() and not w.draining:
                # Draining workers stop reading mid-retire: a stats
                # fan-out at them would hang until the control timeout.
                resp = self._request_worker(w, {"op": "stats"})
                if resp and resp.get("ok"):
                    info["stats"] = {
                        k: v for k, v in resp.items()
                        if k not in ("ok", "op")
                    }
                    for name, value in (resp.get("counters") or {}).items():
                        counters[name] = counters.get(name, 0) + value
            workers_out[str(w.id)] = info
        fleet_counters = {
            name: value for name, value in BUS.counters().items()
            if name.startswith("fleet.")
        }
        hop = {
            name: summary
            for name, summary in BUS.histograms().items()
            if name.startswith("fleet.hop_s")
        }
        out = {
            "ok": True,
            "op": "stats",
            "counters": counters,  # summed across live workers
            "fleet": fleet_counters,
            "workers": workers_out,
            "ring": sorted(self._ring.members()),
            "sessions": len(self._sessions),
            "transport": self.config.transport,
            "forward_cache": self.config.forward_enabled,
            # The live pool, as the autoscaler sees it: slot counts by
            # lifecycle state plus the last scale decision and its reason
            # string — "why is the fleet this size" in one stanza.
            "pool": {
                "size": self.pool_size(),
                "alive": sum(1 for w in self._workers if w.alive),
                "draining": [w.id for w in self._workers if w.draining
                             and not w.retired],
                "retired": [w.id for w in self._workers if w.retired],
                "warmed": [w.id for w in self._workers
                           if w.alive and bool(w.caps.get("warmed"))],
                "last_scale": self.last_scale_decision,
            },
        }
        if hop:
            out["router_hop_s"] = hop
        join = BUS.histograms().get("fleet.join.warm_s")
        if join and join.get("count"):
            out["join_warm_s"] = join
        if self._journal is not None:
            unanswered, next_jid = self._journal.status()
            out["journal"] = {
                "dir": self.config.journal_dir,
                "accepted": next_jid - 1,
                "unanswered": unanswered,
            }
        return out

    # -- chaos/drill surface -------------------------------------------
    def crash(self) -> None:
        """Simulate abrupt router-process death (drills). Everything a
        real crash would do to the *world* happens — channels hard-close
        without drain (``--listen`` workers return to accept with their
        caches warm), in-flight callers get an error, NOTHING more is
        journaled (a dead process appends nothing) — while the test
        process survives to boot the successor: a new
        :class:`FleetRouter` on the same ``journal_dir`` re-adopts the
        live workers and replays the orphaned accepts."""
        BUS.count("fleet.router.crash")
        self._closed = True
        if self._journal is not None:
            # Synchronous: an in-flight accept finishes its durable
            # append before this returns (its owner got a real ack);
            # everything after raises OSError — a dead process appends
            # nothing, and a late append would collide with the
            # successor's sequence numbers. The reference itself stays
            # set: nulling it would race request threads between their
            # None-check and the call (AttributeError instead of the
            # caught OSError -> router_crashed error the clients retry
            # on).
            self._journal.close()
        if self._listener is not None:
            self._listener.close()
        for w in self._workers:
            with w.lock:
                orphans = list(w.pending.values())
                w.pending.clear()
                transport = w.transport
            for p in orphans:
                p.response = {
                    "ok": False, "op": p.request.get("op"),
                    "error": "router crashed", "router_crashed": True,
                }
                p.event.set()
            if transport is not None:
                transport.close(flush=False)

    def kill_worker(self, worker_id: int) -> None:
        """SIGKILL one worker mid-traffic (drills). Failover is automatic.
        Remote workers have no process handle here — their connection is
        hard-closed instead (the same death signal a network partition
        gives)."""
        w = self._workers[worker_id]
        with w.lock:
            proc = w.proc
            transport = w.transport
        if proc is not None and proc.poll() is None:
            proc.kill()
        elif transport is not None:
            transport.close(flush=False)
        # The reader sees EOF and runs the death path; nothing else to do.

    def close_worker_connection(self, worker_id: int) -> None:
        """Hard-close one worker's channel WITHOUT killing the process
        (drills: a network partition / socket reset, distinct from a
        crash). The reader sees EOF, pending requests re-queue onto
        survivors, and the restart path re-establishes the channel."""
        w = self._workers[worker_id]
        with w.lock:
            transport = w.transport
        if transport is not None:
            transport.close(flush=False)  # a partition does not flush

    def arm_worker_fault(
        self, worker_id: int, *, site: str = "fleet.worker.crash",
        times: int = 1, kind: str = "raise", value: float = 0.0,
    ) -> bool:
        """Arm the fault registry INSIDE one worker process (kill drills:
        ``fleet.worker.crash`` makes it die in place of its ``times``-th
        next request — deterministic, mid-traffic, no response flushed)."""
        w = self._workers[worker_id]
        try:
            with w.lock:
                if not w.alive or w.transport is None:
                    return False
                w.transport.send({
                    "arm": {"site": site, "times": times, "kind": kind,
                            "value": value},
                })
            return True
        except OSError:
            return False
