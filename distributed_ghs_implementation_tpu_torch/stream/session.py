"""Subscription sessions: long-lived subscribed graphs with MST-change
notifications per committed window.

A **stream** is a digest chain rooted at one solved seed graph: every
committed window re-keys the maintained forest under the updated graph's
content digest, exactly like ``serve``'s update sessions — which is what
lets the fleet router pin a stream to a worker with the *existing*
update-session digest-chain machinery (the ``publish`` response carries
``digest``/``prev_digest`` and the router follows the rename).

The protocol is pull-based, which is what survives failover cleanly:

* ``subscribe`` — pin a stream to a seed digest (creating it, joining it,
  or *recovering* it from the durable log when this process has never seen
  it — the restarted-worker path). Returns the stream id, current head
  digest, and head sequence number.
* ``publish`` — commit one update window against the current head:
  coalesce, batched apply (``stream/window.py``), WAL append + periodic
  snapshot (``stream/log.py``), then buffer one notification. A publish
  against a stale head fails with the current head attached
  (:class:`StaleDigest`) so a client that raced a failover re-syncs
  instead of forking the chain.
* ``poll`` — drain notifications after a client-held sequence number.
  Sequence numbers are the window commit order, so "no gap, no duplicate"
  is checkable by the subscriber: after a worker death, the next worker
  replays snapshot+WAL, regenerates the same notifications (windowed
  apply is deterministic), and the subscriber's ``after_seq`` cursor
  continues exactly where it left off — without one fresh solve
  (``stream.replay.*`` counters + the scheduler's fresh-solve counter are
  the receipts the kill drill asserts on).

**Sharded streams.** With a ``ShardedLane`` attached, a stream whose
graph is oversize for the lane engine (the scheduler's ``sharded_lane``
route) keeps its head resident on the mesh: the session pins the residency
for its life (pressure from unrelated oversize traffic must not evict a
streamed graph mid-window), every committed window moves the residency
along the digest chain by writing the changed rank slots in place
(``refresh_resident``; the pin re-keys with it), and a window that degrades
to a full re-solve moves it first (``pre_resolve``), so the mesh solve runs
on slots already written. Snapshots carry a ``sharded`` marker, and
``recover`` re-stages the snapshot's graph (``ensure_resident``, never a
solve) before replaying, so that each replayed window writes into the
slots again: a restarted lane worker rebuilds its resident state with no
fresh solve (``stream.replay.residency_restored``). Post-window sharded
heads also ride the verifier's audit under the ``verify`` policy (class
``stream_sharded``).

**Port.** This is the JAX package's ``stream/session.py`` on one explicit
device (``device=None`` means CUDA): every window's Borůvka rounds launch
K2 and K1 there. A stream directory that holds another package's stream
is refused (:class:`ForeignStream`, ``stream/log.py``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import current_class
from distributed_ghs_implementation_tpu_torch.stream.log import (
    ChainBreak,
    UpdateLog,
    list_streams,
)
from distributed_ghs_implementation_tpu_torch.stream.window import WindowedMST

#: Notifications retained per stream (ring): a poller further behind than
#: this sees ``truncated`` and must re-subscribe.
_NOTIFY_CAP = 4096

#: Live stream sessions retained per process (LRU, mirrors the service's
#: ``max_sessions`` bound on update handles): an evicted stream with a
#: durable log transparently recovers on its next verb; without one the
#: client re-subscribes by digest.
_MAX_STREAMS = 32

#: Stream ids are a digest prefix — long enough to be collision-safe at
#: any realistic stream count, short enough for directory names.
_ID_LEN = 16


def _notification(seq: int, prev_digest: str, digest: str, info) -> dict:
    """The MST-change payload a subscriber polls — built here for BOTH the
    live publish and the replay loop, so a recovered ring regenerates
    byte-for-byte (the failover contract: subscribers must not see a
    different shape after a worker kill)."""
    return {
        "seq": int(seq),
        "digest": digest,
        "prev_digest": prev_digest,
        "entered": [list(t) for t in info.entered],
        "left": [list(t) for t in info.left],
        "weight_delta": info.weight_delta,
        "mode": info.mode,
        "applied": info.applied,
    }


class StaleDigest(KeyError):
    """Publish against a superseded head; carries the current head."""

    def __init__(self, stream_id: str, head: str, seq: int):
        super().__init__(stream_id)
        self.stream_id = stream_id
        self.head = head
        self.seq = seq

    def __str__(self) -> str:
        return (
            f"stale digest for stream {self.stream_id}: "
            f"head is {self.head} at seq {self.seq}"
        )


class ForeignStream(ValueError):
    """The stream's directory holds another package's stream: the port
    neither recovers it nor writes over it."""


class StreamSession:
    """One live stream: the windowed session + its notification ring."""

    __slots__ = ("id", "mst", "head", "seq", "notifications", "lock", "log", "sharded")

    def __init__(
        self,
        stream_id: str,
        mst: WindowedMST,
        head: str,
        seq: int = 0,
        log: Optional[UpdateLog] = None,
        sharded: bool = False,
    ):
        self.id = stream_id
        self.mst = mst
        self.head = head
        self.seq = seq
        self.notifications: "collections.deque[dict]" = collections.deque(
            maxlen=_NOTIFY_CAP
        )
        self.lock = threading.Lock()
        self.log = log
        # This stream's head lives resident on the mesh lane (pinned for
        # the session's life). Reset to False once the pin is released:
        # the flag is also the unpin's guard against a second release.
        self.sharded = sharded


class StreamManager:
    """All of one process's streams: create, commit, poll, recover."""

    def __init__(
        self,
        *,
        root: Optional[str] = None,
        snapshot_every: int = 8,
        backend: str = "device",
        resolve_threshold: Optional[int] = None,
        window_mode: str = "batched",
        solver=None,
        interactive_gate=None,
        max_streams: int = _MAX_STREAMS,
        lane=None,
        verifier=None,
        device=None,
    ):
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}"
            )
        if max_streams < 1:
            raise ValueError(f"max_streams must be >= 1, got {max_streams}")
        self.root = root
        self.snapshot_every = snapshot_every
        self.backend = backend
        self.resolve_threshold = resolve_threshold
        self.window_mode = window_mode
        self.max_streams = max_streams
        self.device = resolve_device(device)
        self._solver = solver
        self._gate = interactive_gate
        # ``lane`` (parallel.lane.ShardedLane) turns oversize streams into
        # mesh-resident sessions (module docstring); ``verifier``
        # (verify.policy.ResultVerifier) audits their post-window heads.
        self._lane = lane
        self._verifier = verifier
        self._streams: "collections.OrderedDict[str, StreamSession]" = (
            collections.OrderedDict()
        )
        self._by_head: Dict[str, str] = {}  # head digest -> stream id
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._streams)

    # -- construction helpers ------------------------------------------
    def _make_mst(self, result=None, state=None) -> WindowedMST:
        kwargs = dict(
            window_mode=self.window_mode,
            resolve_threshold=self.resolve_threshold,
            backend=self.backend,
            solver=self._solver,
            device=self.device,
        )
        if state is not None:
            return WindowedMST.from_state(state, **kwargs)
        return WindowedMST(result, **kwargs)

    # -- sharded residency helpers --------------------------------------
    def _lane_wants(self, graph) -> bool:
        """Is this stream's graph one the mesh lane serves: oversize for the
        lane engine and inside the lane's rank envelope? The scheduler's
        routing rule (``BatchPolicy.route``), so that residency and solve
        routing agree on where a graph lives."""
        if self._lane is None:
            return False
        from distributed_ghs_implementation_tpu_torch.batch.warmup import (
            bucket_of,
            warmable_single,
        )

        if warmable_single(*bucket_of(graph.num_nodes, graph.num_edges)):
            return False
        return self._lane.admits(graph)

    def _session_state(self, session: StreamSession) -> dict:
        state = session.mst.state_arrays()
        if session.sharded:
            # The snapshot records that this head lives on the mesh, so a
            # restarted lane worker re-stages before it replays.
            state["sharded"] = np.asarray(True)
        return state

    def _attach_lane(self, session: StreamSession) -> None:
        """Arm the resolve escape hatch of a mesh-resident stream: when a
        window degrades to a full re-solve, move the head's residency onto
        the resolve graph first, so the solver's oversize route runs on
        slots already written instead of staging cold mid-publish."""
        lane = self._lane

        def pre_resolve(graph) -> None:
            if not lane.refresh_resident(session.head, graph):
                lane.ensure_resident(graph)

        session.mst._pre_resolve = pre_resolve

    def _unpin(self, session: StreamSession) -> None:
        """Release a sharded session's residency pin exactly once (drop,
        eviction from the manager's LRU, or a lost registration race)."""
        if session.sharded and self._lane is not None:
            self._lane.unpin(session.head)
        session.sharded = False

    def _maintain_residency(self, session: StreamSession, prev: str, graph) -> None:
        """After a commit (inside the session lock): write the window's
        changed rank slots into the resident shards, re-keying the
        residency and the session's pin along the digest chain. A dropped
        residency (a padded-shape change) on a sharded session re-stages;
        other sessions keep the best-effort move (a no-op unless the head
        was resident)."""
        migrated = self._lane.refresh_resident(prev, graph)
        if migrated:
            if session.sharded:
                BUS.count("stream.lane.migrated")
        elif session.sharded:
            self._lane.ensure_resident(graph, digest=session.head)
            BUS.count("stream.lane.restaged")

    def _audit_sharded(self, session: StreamSession, result) -> None:
        """Send a post-window (or post-replay) sharded head through the
        verifier's audit under its policy (class ``stream_sharded``): these
        heads never pass through the one-shot solve path that audits at
        response time."""
        if session.sharded and self._verifier is not None:
            self._verifier.audit(result, cls="stream_sharded", key=None)

    def _register(self, session: StreamSession) -> StreamSession:
        with self._lock:
            existing = self._streams.get(session.id)
            if existing is not None:
                self._streams.move_to_end(session.id)
                return existing  # a concurrent subscribe/recover won
            self._streams[session.id] = session
            self._by_head[session.head] = session.id
            # Bounded like the service's update-session LRU: a stream's
            # arrays + notification ring must not accumulate for the life
            # of the process. The durable log (when configured) makes
            # eviction transparent — the next verb recovers it.
            while len(self._streams) > self.max_streams:
                _sid, _evicted = self._streams.popitem(last=False)
                # Sweep every digest mapping to the evicted id, not just
                # its current head: a publish racing this eviction may
                # have moved ``session.head`` (under the session lock)
                # before its ``_move_head`` got here.
                for head in [
                    h for h, s in self._by_head.items() if s == _sid
                ]:
                    del self._by_head[head]
                # An evicted sharded stream releases its pin; recovery
                # re-stages (without solving) if the head was lost.
                self._unpin(_evicted)
                BUS.count("stream.evicted")
            return session

    def _drop(self, session: StreamSession) -> None:
        with self._lock:
            if self._streams.get(session.id) is session:
                del self._streams[session.id]
            if self._by_head.get(session.head) == session.id:
                del self._by_head[session.head]
        self._unpin(session)

    def _move_head(self, session: StreamSession, prev: str) -> None:
        with self._lock:
            if self._by_head.get(prev) == session.id:
                del self._by_head[prev]
            # Only map the new head for a session still registered: a
            # publish whose session was LRU-evicted mid-flight must not
            # re-insert a digest mapping nothing will ever clean up
            # (subscribe-by-digest would chase a dead id forever).
            if self._streams.get(session.id) is session:
                self._by_head[session.head] = session.id

    # -- the verbs ------------------------------------------------------
    def subscribe(
        self,
        *,
        digest: Optional[str] = None,
        stream: Optional[str] = None,
        result=None,
    ) -> StreamSession:
        """Create, join, or recover a stream.

        ``stream`` resumes a known stream id (recovering from the log when
        this process has never seen it). ``digest`` joins the stream whose
        head (or seed) is that digest; creating a new stream additionally
        needs ``result`` — the solved seed the caller fetched from its
        session/store. Raises ``KeyError`` when nothing matches.
        """
        if stream is not None:
            session = self._get_or_recover(stream)
            if session is None:
                raise KeyError(f"unknown stream {stream!r}")
            BUS.count("stream.subscribe")
            return session
        if digest is None:
            raise ValueError("subscribe needs a digest or a stream id")
        with self._lock:
            sid = self._by_head.get(digest)
            session = self._streams.get(sid) if sid else None
        if session is None:
            # A stream seeded from this digest may exist on disk (the
            # process restarted): its id is derived from the seed digest.
            session = self._get_or_recover(digest[:_ID_LEN])
        if session is None:
            session = self._recover_by_head(digest)
        if session is None:
            if result is None:
                raise KeyError(
                    f"no stream for digest {digest!r} (solve the graph "
                    f"first, or pass its stream id)"
                )
            session = self._create(digest, result)
        BUS.count("stream.subscribe")
        return session

    def _recover_by_head(self, digest: str) -> Optional[StreamSession]:
        """Subscribe-by-digest fallback for an EVICTED stream addressed by
        its current (mid-chain) head: log dirs are keyed by the SEED
        digest, so scan the recoverable streams for one whose durable head
        is ``digest`` and recover that. Without this, a re-subscribe after
        manager-LRU eviction would silently fork a fresh seq-0 stream —
        pollers whose cursors sit at the old sequence would never see
        another notification (nor a ``truncated`` marker)."""
        if self.root is None:
            return None
        for sid in list_streams(self.root):
            with self._lock:
                if sid in self._streams:
                    # Resident heads were already checked via _by_head: a
                    # resident stream with this durable head would have
                    # matched there, so this digest is historical for it.
                    continue
            head = UpdateLog(self.root, sid)._durable_head()
            if head is not None and head[1] == digest:
                session = self.recover(sid)
                if session is not None:
                    return session
        return None

    def _create(self, digest: str, result) -> StreamSession:
        log = None
        if self.root is not None:
            log = UpdateLog(self.root, digest[:_ID_LEN])
            if log.holds_foreign():
                BUS.count("stream.log.foreign_refused")
                raise ForeignStream(
                    f"stream directory {log.dir} holds another package's stream; "
                    f"this package neither recovers it nor writes over it"
                )
        mst = self._make_mst(result=result)
        sharded = self._lane_wants(result.graph)
        session = StreamSession(digest[:_ID_LEN], mst, digest, 0, None, sharded=sharded)
        if log is not None:
            session.log = log
            # The creation snapshot (seq 0) is what makes the stream
            # replayable from its very first window.
            session.log.snapshot(
                self._session_state(session), seq=0, digest=digest
            )
        if sharded:
            # The seed rode the mesh (the scheduler's oversize route), so
            # its slots are usually resident still: pin them for the
            # session's life. A seed that lost residency re-stages here,
            # without solving.
            self._lane.ensure_resident(result.graph, digest=digest, pin=True)
            self._attach_lane(session)
        BUS.count("stream.created")
        registered = self._register(session)
        if registered is not session:
            self._unpin(session)  # a concurrent subscribe won the race
        return registered

    def publish(
        self,
        stream_id: str,
        digest: str,
        updates: list,
        *,
        on_commit=None,
    ) -> dict:
        """Commit one window; returns the response fields (incl. the new
        :class:`MSTResult` under ``"result"`` and the notification).

        ``on_commit(result, prev_digest, new_digest)``, when given, runs
        INSIDE the session lock after the commit point — commits on one
        stream are seq-ordered, so per-head cache/residency maintenance
        hooked here cannot interleave out of order the way doing it after
        ``publish`` returns would (a later window's eviction racing ahead
        of an earlier window's insert re-plants a dead chain ancestor)."""
        session = self._get_or_recover(stream_id)
        if session is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        gate = self._gate() if self._gate is not None else contextlib.nullcontext()
        # The stream front door: a publish arriving through a traced
        # serve/fleet request joins that trace; a direct publish (tests,
        # embedded use) mints its own root.
        with session.lock, gate, tracing.front_door(current_class()):
            if digest != session.head:
                BUS.count("stream.publish.stale")
                raise StaleDigest(session.id, session.head, session.seq)
            cls = current_class()
            span_args = dict(
                stream=session.id, seq=session.seq + 1, updates=len(updates),
            )
            if cls is not None:
                span_args["cls"] = cls
            t0 = time.perf_counter()
            with BUS.span("stream.window", cat="stream", **span_args) as span:
                try:
                    result, info = session.mst.apply_window(updates)
                except Exception:
                    if session.mst.dirty:
                        # Failed mid-mutation — a forest no client has
                        # seen. Drop the session: the next verb recovers
                        # the clean pre-window state from the durable log
                        # (same discipline as serve.sessions.poisoned).
                        self._drop(session)
                        BUS.count("stream.poisoned")
                    raise
                span.set(mode=info.mode, net=info.applied)
                # Captured INSIDE the window span: the WAL rides this
                # window's span id, so a replay of the entry parents to
                # the publish that committed it (same trace, new spans).
                publish_trace = tracing.wire_context()
            new_digest = result.graph.digest()
            seq = session.seq + 1
            notification = _notification(seq, session.head, new_digest, info)
            if session.log is not None:
                # The WAL append is the commit point: nothing a poller can
                # observe (ring, head, seq) moves until the window is
                # durable, so a failed append + client retry cannot yield
                # two notifications for one sequence number. The arrays
                # already hold the window the log refused, so the session
                # is dropped alongside the error — recovery rebuilds the
                # clean pre-window state and the retry applies to it.
                try:
                    session.log.append(
                        seq=seq, prev_digest=session.head, digest=new_digest,
                        updates=[u if isinstance(u, dict) else u.__dict__
                                 for u in updates],
                        trace=publish_trace,
                    )
                except ChainBreak as e:
                    # Another process sharing this stream root (a fleet
                    # worker the router re-pinned traffic to) committed
                    # past our resident head — a fork the in-memory
                    # staleness check above cannot see. Drop the stale
                    # resident copy (the next verb replays the durable
                    # log) and bounce the client with the durable head,
                    # the same re-sync contract as any stale publish.
                    self._drop(session)
                    BUS.count("stream.publish.stale")
                    raise StaleDigest(
                        session.id,
                        e.digest if e.digest is not None else session.head,
                        e.seq if e.seq is not None else session.seq,
                    ) from e
                except Exception:
                    self._drop(session)
                    BUS.count("stream.poisoned")
                    raise
            session.notifications.append(notification)
            prev = session.head
            session.head = new_digest
            session.seq = seq
            self._move_head(session, prev)
            if self._lane is not None and prev != new_digest:
                # Mesh maintenance rides the commit point, seq-ordered
                # under the session lock: the window's changed rank slots
                # are written into the resident shards, and residency and
                # pin re-key to the new head.
                self._maintain_residency(session, prev, result.graph)
            if session.log is not None and seq % self.snapshot_every == 0:
                try:
                    session.log.snapshot(
                        self._session_state(session), seq=seq,
                        digest=new_digest,
                        notifications=list(session.notifications),
                    )
                except (OSError, TimeoutError):
                    # Past the commit point a snapshot is compaction, not
                    # durability — the WAL already holds the window, so a
                    # failed write must not error a committed publish.
                    BUS.count("stream.log.snapshot_failed")
            if on_commit is not None:
                on_commit(result, prev, new_digest)
            self._audit_sharded(session, result)
            BUS.count("stream.window.committed")
            BUS.count("stream.notify")
            return {
                "stream": session.id,
                "digest": new_digest,
                "prev_digest": prev,
                "seq": seq,
                "mode": info.mode,
                "applied": info.applied,
                "coalesced_from": info.coalesced_from,
                "notification": notification,
                "result": result,
                "wall_s": time.perf_counter() - t0,
            }

    def poll(self, stream_id: str, after_seq: int = 0) -> dict:
        """Notifications with ``seq > after_seq`` (+ the current head)."""
        session = self._get_or_recover(stream_id)
        if session is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        with session.lock:
            notes = [
                n for n in session.notifications if n["seq"] > after_seq
            ]
            earliest = (
                session.notifications[0]["seq"]
                if session.notifications else session.seq + 1
            )
            out = {
                "stream": session.id,
                "digest": session.head,
                "seq": session.seq,
                "notifications": notes,
            }
            # The ring dropped windows the poller still needs: it must
            # re-subscribe (or re-solve) rather than silently skip.
            if after_seq + 1 < earliest and after_seq < session.seq:
                out["truncated"] = earliest
            BUS.count("stream.poll")
            return out

    # -- recovery --------------------------------------------------------
    def _get_or_recover(self, stream_id: str) -> Optional[StreamSession]:
        with self._lock:
            session = self._streams.get(stream_id)
            if session is not None:
                self._streams.move_to_end(stream_id)
                return session
        return self.recover(stream_id)

    def recover(self, stream_id: str) -> Optional[StreamSession]:
        """Rebuild a stream from its durable log: snapshot + WAL replay.

        Every replayed window goes through the same batched apply as a
        live publish — deterministic, so the digests must re-derive
        exactly (a divergence stops replay at the last agreeing window,
        ``stream.replay.diverged``) and the notification ring regenerates
        byte-for-byte. No step touches the solver.
        """
        if self.root is None:
            return None
        log = UpdateLog(self.root, stream_id)
        state, entries, _notes = log.load()
        if state is None:
            return None
        with BUS.span(
            "stream.replay", cat="stream", stream=stream_id,
            windows=len(entries),
        ) as span:
            mst = self._make_mst(state=state)
            head = mst.result().graph.digest()
            if head != state["digest"]:
                # The arrays are the truth; a stored-digest mismatch means
                # the snapshot generation predates a weight-dtype change
                # or was tampered with — surface it, then trust the arrays.
                BUS.count("stream.replay.digest_mismatch")
            session = StreamSession(
                stream_id, mst, head, state["seq"], log
            )
            session.sharded = self._lane_wants(mst.result().graph)
            if state.get("sharded") and not session.sharded:
                # The snapshot says this head lived on the mesh but this
                # process cannot re-stage it (no lane, or the graph left the
                # lane's envelope): replay still rebuilds the forest; only
                # the residency degrades, visibly.
                BUS.count("stream.replay.residency_unavailable")
            if session.sharded:
                # Re-stage the snapshot's graph (a copy, never a solve),
                # pinned; each replayed window below writes into the slots
                # as a live publish does, so residency and pin re-key
                # along the replayed chain.
                self._lane.ensure_resident(mst.result().graph, digest=head, pin=True)
                self._attach_lane(session)
            # Ring continuity across the snapshot point: the persisted
            # notifications preload, replayed windows append after them.
            for note in state.get("notifications", []):
                session.notifications.append(note)
            replayed = 0
            diverged = False
            # WAL entries chain from the snapshot's STORED digest (that is
            # what log.load() validated) — chaining on the recomputed head
            # would silently drop every post-snapshot window whenever the
            # digest_mismatch path above fired.
            chain = state["digest"]
            for entry in entries:
                if entry["prev"] != chain:
                    BUS.count("stream.replay.diverged")
                    diverged = True
                    break
                # Replay continues the ORIGINAL publish's trace (the WAL
                # entry journaled its wire context): the re-applied
                # window is a fresh child span under the publish that
                # committed it — same trace_id, across processes and
                # restarts.
                with tracing.activated(
                    tracing.from_wire(entry.get("trace"))
                ), BUS.span(
                    "stream.replay.window", cat="stream",
                    stream=stream_id, seq=entry["seq"],
                ):
                    result, info = mst.apply_window(entry["updates"])
                new_digest = result.graph.digest()
                if new_digest != entry["digest"]:
                    BUS.count("stream.replay.diverged")
                    diverged = True
                    break
                session.notifications.append(
                    _notification(entry["seq"], entry["prev"], new_digest, info)
                )
                prev_head = session.head
                chain = session.head = new_digest
                session.seq = entry["seq"]
                replayed += 1
                if session.sharded:
                    self._maintain_residency(session, prev_head, result.graph)
            # Round 19: verify the REBUILT head against the journaled
            # expectation. On a clean replay the two agree by construction
            # (every applied window's recomputed digest was checked); a
            # disagreement means the arrays were evolved through state we
            # cannot vouch for — corrupt snapshot arrays, a mangled WAL
            # update that still parsed, or a divergence that left the
            # arrays one window past the last verified head. Replay alone
            # would serve that forest with full confidence; instead fall
            # back to ONE fresh solve of the rebuilt graph, so the served
            # forest is re-derived from the edges actually recovered
            # (``stream.replay.fresh_solve`` — the zero-fresh-solve
            # failover contract is scoped to clean replays, and this is
            # not one).
            rebuilt = mst.result().graph.digest()
            # A fully-verified replay CURES a seed-digest mismatch: when
            # every WAL window re-derived its journaled digest from the
            # arrays, the final state is journal-verified even though the
            # seed was not (the legacy weight-dtype-change case).
            seed_uncured = (
                head != state["digest"] and not (replayed and not diverged)
            )
            if self._solver is not None and (
                diverged or seed_uncured or rebuilt != session.head
            ):
                BUS.count("stream.replay.fresh_solve")
                fresh = self._solver(mst.result().graph)
                session.mst = self._make_mst(result=fresh)
                prev_head = session.head
                session.head = fresh.graph.digest()
                if session.sharded:
                    # The re-derived head supersedes the replayed one: carry
                    # the pin over and make sure the served head is resident.
                    self._lane.move_pins(prev_head, session.head)
                    self._lane.ensure_resident(fresh.graph, digest=session.head)
                    self._attach_lane(session)
            if session.sharded:
                BUS.count("stream.replay.residency_restored")
                self._audit_sharded(session, session.mst.result())
            span.set(replayed=replayed, head_seq=session.seq)
            BUS.count("stream.replay.streams")
            if replayed:
                BUS.count("stream.replay.windows", replayed)
            registered = self._register(session)
            if registered is not session:
                self._unpin(session)  # a concurrent recover won the race
            return registered

    # -- introspection ---------------------------------------------------
    def heads(self) -> Dict[str, str]:
        with self._lock:
            return {s.id: s.head for s in self._streams.values()}

    def stats(self) -> dict:
        with self._lock:
            out = {
                "streams": len(self._streams),
                "sharded": sum(1 for s in self._streams.values() if s.sharded),
                "root": self.root,
                "snapshot_every": self.snapshot_every,
                "heads": {
                    s.id: {"seq": s.seq, "digest": s.head}
                    for s in self._streams.values()
                },
            }
        if self.root is not None:
            # Durable streams outnumber live ones (LRU eviction, worker
            # restarts): report what is recoverable from disk, not just
            # what is resident.
            out["recoverable"] = list_streams(self.root)
        return out


def poll_gap_check(seen: List[int], head_seq: int, start_seq: int = 0) -> dict:
    """Subscriber-side integrity: ``seen`` window sequences vs the head.

    Returns ``{"gaps": N, "dups": N}`` — both must be zero for the
    no-lost-no-duplicated-notification contract (drills assert exactly
    this after a worker kill). ``start_seq`` is the sequence the
    subscriber JOINED at (the ``seq`` its subscribe response carried):
    a mid-chain joiner only owes the windows after it, so pre-join
    sequences are not gaps.
    """
    counts = collections.Counter(seen)
    dups = sum(c - 1 for c in counts.values())
    gaps = sum(
        1 for s in range(start_seq + 1, head_seq + 1) if s not in counts
    )
    return {"gaps": gaps, "dups": dups}
