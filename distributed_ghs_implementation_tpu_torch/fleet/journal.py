"""Durable router journal: the accepted-work ledger that survives a crash.

Port of the JAX package's ``fleet/journal.py`` on the port's
``utils/wal.JsonlWal``: the schema, the record kinds and every record are
that package's. A journal holds requests, not results (a replayed accept is
solved again by whichever worker takes it), so either package's router can
replay the other's journal.

Rounds 12–17 made every *worker* disposable — kill drills prove zero lost
accepted queries across pipe and TCP fleets, elastic churn, and
WAL-replayed stream failover — but the router's own state (the
accepted-but-unanswered ledger, session pins, the forwarding affinity
LRU, ring membership, the last scale decision) lived only in process
memory: a router crash silently lost every accepted query. This module
closes that last gap with a flock'd, fsync'd append-only journal
(``<journal_dir>/journal.jsonl``, schema ``ghs-router-journal-v1``) built
on the same hardened WAL core the stream log uses
(:class:`utils.wal.JsonlWal`: torn-tail seal, tolerant reads, atomic
rewrite) plus a **sequence-contiguity chain**: every record carries
``seq``; replay accepts the longest contiguous prefix and drops anything
past a gap (``fleet.router.journal.chain_broken``) — a skipped corrupt
line *is* a gap, so corruption can never splice unrelated history
together.

Record kinds (field ``t``):

* ``accept`` — one accepted request: journal id, the full request, its
  routing key/class/lane bits. **Appended before dispatch**: the router
  only acknowledges work whose accept is durable, so a crash can never
  lose an acknowledged query.
* ``answer`` — the matching outcome (journal id, ok, serving worker, the
  result digest — which is also how replay rebuilds the forwarding
  affinity LRU). An accept without an answer is an *orphan*: the
  restarted router re-queues it by digest, the same idempotent
  content-addressed re-queue worker failover uses.
* ``pin`` — an update/stream session digest moved (or renamed along its
  chain) to a worker.
* ``ring`` — a membership change (``add`` / ``remove`` / ``retire``,
  with the dial address for remote workers), so a restarted router knows
  the pool the autoscaler had grown it to — and does not double-scale.
* ``scale`` — the autoscaler's latest decision (with a wall-clock stamp
  the restarted cooldown derives from).
* ``checkpoint`` — a compaction point: the full mirrored state in one
  record, followed only by records after it. Written every
  ``checkpoint_every`` appends (the WAL-compaction-on-snapshot idiom).

The journal is also a state machine: it mirrors pins/affinity/membership
as records append (bounded LRUs, matching the router's own caps), so
compaction needs no caller-supplied snapshot and :meth:`load` hands the
restarted router everything re-adoption needs in one object.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.utils.wal import JsonlWal

JOURNAL_SCHEMA = "ghs-router-journal-v1"
COUNTER_PREFIX = "fleet.router.journal"

#: Mirror caps, matching the router's in-memory LRUs — the journal must
#: not remember more affinity than the router it restores.
_PIN_CAP = 4096
_SERVED_CAP = 4096

_KINDS = ("accept", "answer", "pin", "ring", "scale", "checkpoint")


def _entry(rec: dict) -> dict:
    """Schema-checked record -> validated entry (raising marks the line
    unparsable, exactly like non-JSON bytes)."""
    kind = rec["t"]
    if kind not in _KINDS:
        raise ValueError(f"unknown journal record kind {kind!r}")
    rec["seq"] = int(rec["seq"])
    if kind in ("accept", "answer"):
        rec["jid"] = int(rec["jid"])
    return rec


class JournalState:
    """Everything a restarted router re-adopts, replayed from the
    journal's longest valid prefix."""

    def __init__(self):
        self.had_state = False  # any parsable record at all
        self.next_jid = 1
        self.next_seq = 1
        #: jid -> the accept record (request/key/cls/lane) with no answer.
        self.unanswered: "Dict[int, dict]" = {}
        #: session digest -> worker id (insertion-ordered LRU mirror).
        self.pins: "Dict[str, int]" = {}
        #: digest -> worker that last answered it ok (forwarding affinity).
        self.served: "Dict[str, int]" = {}
        #: worker id -> {"addr": str|None, "retired": bool} — the pool as
        #: the crashed router knew it (scale-ups included).
        self.members: "Dict[int, dict]" = {}
        self.last_scale: Optional[dict] = None
        self.dropped = 0  # entries past a chain break (never replayed)

    # -- the replay state machine (shared by load() and the live mirror) --
    def apply(self, rec: dict) -> None:
        kind = rec["t"]
        if kind == "checkpoint":
            self.next_jid = int(rec.get("next_jid", self.next_jid))
            self.unanswered = {
                int(a["jid"]): a for a in rec.get("unanswered", [])
            }
            self.pins = {d: int(w) for d, w in (rec.get("pins") or {}).items()}
            self.served = {
                d: int(w) for d, w in (rec.get("served") or {}).items()
            }
            self.members = {
                int(k): dict(v) for k, v in (rec.get("members") or {}).items()
            }
            self.last_scale = rec.get("scale")
        elif kind == "accept":
            self.unanswered[rec["jid"]] = rec
            self.next_jid = max(self.next_jid, rec["jid"] + 1)
        elif kind == "answer":
            self.unanswered.pop(rec["jid"], None)
            if rec.get("ok") and rec.get("digest") is not None:
                worker = rec.get("worker")
                if worker is not None:
                    self.served[str(rec["digest"])] = int(worker)
                    while len(self.served) > _SERVED_CAP:
                        self.served.pop(next(iter(self.served)))
        elif kind == "pin":
            prev = rec.get("prev")
            if prev:
                self.pins.pop(prev, None)
            self.pins[str(rec["digest"])] = int(rec["worker"])
            while len(self.pins) > _PIN_CAP:
                self.pins.pop(next(iter(self.pins)))
        elif kind == "ring":
            wid = int(rec["worker"])
            action = rec.get("action")
            member = self.members.setdefault(
                wid, {"addr": None, "retired": False}
            )
            if rec.get("addr") is not None:
                member["addr"] = rec["addr"]
            if rec.get("lane") is not None:
                # The oversize-lane subring is capability-derived (a
                # dialed standby declares it in its hello), so restart
                # cannot reconstruct it from config alone — it rides the
                # ring record.
                member["lane"] = bool(rec["lane"])
            if action == "retire":
                member["retired"] = True
                self._drop_worker(wid)
            elif action == "remove":
                # Mirrors _on_death: the dead worker's pins and warm
                # copies die with the incarnation.
                self._drop_worker(wid)
            elif action == "add":
                member["retired"] = False
        elif kind == "scale":
            self.last_scale = rec.get("decision")

    def _drop_worker(self, wid: int) -> None:
        for d in [d for d, w in self.pins.items() if w == wid]:
            del self.pins[d]
        for d in [d for d, w in self.served.items() if w == wid]:
            del self.served[d]

    def checkpoint_record(self, seq: int) -> dict:
        return {
            "t": "checkpoint",
            "seq": seq,
            "next_jid": self.next_jid,
            "unanswered": list(self.unanswered.values()),
            "pins": dict(self.pins),
            "served": dict(self.served),
            "members": {str(k): v for k, v in self.members.items()},
            "scale": self.last_scale,
        }


class RouterJournal:
    """The router's durable ledger: one :class:`JsonlWal` under
    ``journal_dir``, a live state mirror, and checkpoint compaction.

    Thread-safe: the router appends from request threads, reader threads,
    and the heartbeat loop concurrently. Every append is durable (flock +
    fsync) before it returns — that is the whole point.
    """

    def __init__(self, root: str, *, checkpoint_every: int = 512):
        self.root = root
        self.path = os.path.join(root, "journal.jsonl")
        self.checkpoint_every = max(2, int(checkpoint_every))
        self._wal = JsonlWal(
            self.path,
            schema=JOURNAL_SCHEMA,
            counter_prefix=COUNTER_PREFIX,
            validate=_entry,
        )
        self._lock = threading.Lock()
        self.state = JournalState()
        self._since_checkpoint = 0
        self._closed = False

    def close(self) -> None:
        """Stop accepting appends, synchronously: taken under the same
        lock every append holds, so an in-flight append completes (and is
        durable — its owner gets a real ack) before this returns, and any
        append after it raises instead of racing a successor router that
        has already loaded the file (a late append would collide with the
        successor's sequence numbers and read as a chain break on the
        NEXT restart). ``FleetRouter.crash()`` calls this first — a dead
        process appends nothing."""
        with self._lock:
            self._closed = True

    # -- boot ----------------------------------------------------------
    def load(self) -> JournalState:
        """Replay the journal into a fresh state: the longest prefix of
        contiguous sequence numbers (a skipped corrupt line is a gap —
        everything past it is dropped and counted, never spliced)."""
        entries, _torn = self._wal.read()
        state = JournalState()
        expected: Optional[int] = None
        kept = 0
        for i, rec in enumerate(entries):
            if expected is not None and rec["seq"] != expected:
                BUS.count(f"{COUNTER_PREFIX}.chain_broken")
                state.dropped = len(entries) - i
                break
            state.apply(rec)
            state.had_state = True
            state.next_seq = rec["seq"] + 1
            expected = rec["seq"] + 1
            kept += 1
        BUS.count(f"{COUNTER_PREFIX}.replayed", kept)
        with self._lock:
            self.state = state
            self._since_checkpoint = 0
        return state

    # -- appends (all durable before returning) ------------------------
    def _append(self, rec: dict) -> None:
        """Must be called with ``self._lock`` held; assigns ``seq``,
        mirrors into the live state, and checkpoints on cadence."""
        if self._closed:
            raise OSError("journal closed (router crashed)")
        rec = dict(rec)
        rec["seq"] = self.state.next_seq
        self._wal.append(rec)
        self.state.next_seq += 1
        self.state.apply(rec)
        self._since_checkpoint += 1
        if (
            self._since_checkpoint >= self.checkpoint_every
            and rec["t"] != "checkpoint"
        ):
            self._checkpoint_locked()

    def accept(
        self,
        request: dict,
        *,
        key: Optional[str],
        cls: Optional[str],
        lane: bool = False,
        trace: Optional[dict] = None,
    ) -> int:
        """Durably record one accepted request; returns its journal id.
        The caller dispatches only after this returns — the accept ack is
        gated on the durable append. ``trace`` is the request's wire trace
        context (obs/tracing.py): it rides the accept record — and any
        checkpoint that carries it forward — so a successor router's
        orphan replay re-dispatches under the ORIGINAL trace_id."""
        with self._lock:
            jid = self.state.next_jid
            rec = {
                "t": "accept",
                "jid": jid,
                "req": request,
                "key": key,
                "cls": cls,
                "lane": bool(lane),
            }
            if trace is not None:
                rec["trace"] = trace
            self._append(rec)
        return jid

    def answer(
        self,
        jid: int,
        *,
        ok: bool,
        worker: Optional[int] = None,
        digest: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._append({
                "t": "answer",
                "jid": int(jid),
                "ok": bool(ok),
                "worker": worker,
                "digest": digest,
            })

    def pin(
        self, digest: str, worker: int, prev: Optional[str] = None
    ) -> None:
        with self._lock:
            self._append({
                "t": "pin", "digest": digest, "worker": int(worker),
                "prev": prev,
            })

    def ring(
        self, action: str, worker: int, addr: Optional[str] = None,
        lane: Optional[bool] = None,
    ) -> None:
        with self._lock:
            self._append({
                "t": "ring", "action": action, "worker": int(worker),
                "addr": addr, "lane": lane,
            })

    def scale(self, decision: dict) -> None:
        with self._lock:
            self._append({"t": "scale", "decision": dict(decision)})

    # -- compaction ------------------------------------------------------
    def checkpoint(self) -> None:
        """Compact: rewrite the journal as one checkpoint record holding
        the mirrored state (unanswered accepts ride inside it)."""
        with self._lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        rec = self.state.checkpoint_record(self.state.next_seq)
        self._wal.rewrite([rec])
        self.state.next_seq += 1
        self._since_checkpoint = 0
        BUS.count(f"{COUNTER_PREFIX}.compact")

    # -- introspection (drills + the stats op) -------------------------
    def status(self) -> Tuple[int, int]:
        """``(unanswered, next_jid)`` of the live mirror."""
        with self._lock:
            return len(self.state.unanswered), self.state.next_jid

    def unanswered_entries(self) -> List[dict]:
        with self._lock:
            return list(self.state.unanswered.values())
