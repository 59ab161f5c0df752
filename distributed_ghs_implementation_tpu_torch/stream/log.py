"""Durable update log: snapshot every K windows + a JSONL delta WAL.

Port of the JAX package's ``stream/log.py``, with two differences on
purpose, both so that neither package recovers the other's stream in a
shared stream root (recovery replays a snapshot and its WAL without a
solve, so a port stream recovered from the JAX package's log would hide a
fault of the port behind that package's answer):

* the port's streams live under ``<root>/torch/<stream_id>``
  (:data:`NAMESPACE`), where the JAX package's live under
  ``<root>/<stream_id>``; stream ids are the same in both packages (a seed
  digest's prefix), the directories are not;
* a snapshot carries a ``package`` field, and the port loads no snapshot
  without its own (:data:`PACKAGE`): a foreign one is skipped like a torn
  one (``stream.log.foreign_refused``), and the stream manager refuses to
  create a stream over one (``stream/session.py``).

The WAL schema and the snapshot's other fields are the JAX package's.

A maintained forest used to live only in a worker's memory — a restart
threw away every windowed session and the first post-restart update paid a
full fresh solve. This module gives each stream a directory under the
(fleet-shared) stream root:

* ``snapshot.npz`` — the session's whole state (``u/v/w/in_tree`` +
  window sequence + head digest) written through
  :func:`utils.checkpoint.atomic_write_npz`: tmp-file + rename with one
  retained ``.bak`` generation, so a crash mid-snapshot costs at most one
  snapshot interval (the ``stream.log.save`` fault site tears writes in
  tests).
* ``wal.jsonl`` — one JSON line per committed window
  (``ghs-stream-wal-v1``: seq, prev/new digest, the raw updates). Appends
  are flushed + fsynced and serialized across processes by the same
  advisory per-path flock the shared result store uses
  (``utils/locking.py``) — the two-process hammer test drives exactly
  that interleaving. The append/seal/read/compact mechanics live in the
  reusable :class:`utils.wal.JsonlWal` core (factored out in round 18 so
  the router's accepted-work journal shares them); this module keeps the
  stream-specific *chain* semantics on top.

**Replay** (:meth:`UpdateLog.load`) is snapshot-then-deltas: the newest
loadable snapshot generation (primary, else ``.bak``) plus every WAL entry
with a later sequence number, in order. A torn tail — a crash mid-append
leaves a partial last line — is skipped and counted
(``stream.log.torn_skipped``), never fatal; so is an unparsable *mid*-log
line (``stream.log.corrupt_line`` — a retried append seals the torn
record of its failed predecessor in place, leaving garbage between two
good lines). A real chain break (sequence gap, or a ``prev`` digest that
does not follow from the snapshot — the snapshot/log-disagreement case)
stops replay at the break with ``stream.log.chain_broken``: everything
before the break is still recovered, and the caller decides whether the
shortened head is acceptable. After each snapshot the WAL is compacted (entries at or below
the snapshot's sequence dropped via tmp + rename); a crash between
snapshot and compaction just leaves already-covered entries that replay
skips by sequence number.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.utils.checkpoint import (
    atomic_write_npz,
)
from distributed_ghs_implementation_tpu_torch.utils.locking import flocked as _flocked
from distributed_ghs_implementation_tpu_torch.utils.wal import JsonlWal

WAL_SCHEMA = "ghs-stream-wal-v1"
FAULT_SITE = "stream.log.save"

#: The value of a snapshot's ``package`` field; the port loads no snapshot
#: without it (the JAX package writes none).
PACKAGE = "torch"

#: The subdirectory of a stream root that holds the port's streams.
NAMESPACE = "torch"


class ChainBreak(ValueError):
    """The WAL does not follow from the snapshot (gap or digest mismatch),
    or an append would not follow from the durable tail (a fork). Carries
    the durable head when known so the caller can re-sync the client."""

    def __init__(
        self,
        msg: str,
        *,
        seq: Optional[int] = None,
        digest: Optional[str] = None,
    ):
        super().__init__(msg)
        self.seq = seq
        self.digest = digest


def _wal_entry(rec: dict) -> dict:
    """One schema-checked WAL record -> the replay entry shape (raising
    marks the line unparsable, exactly like non-JSON bytes)."""
    entry = {
        "seq": int(rec["seq"]),
        "prev": rec["prev"],
        "digest": rec["digest"],
        "updates": rec["updates"],
    }
    if "trace" in rec:
        # The publisher's trace context (obs/tracing.py): replay re-runs
        # the window under the ORIGINAL trace_id, so a recovery shows up
        # in the merged fleet trace as a child of the publish that
        # committed the window.
        entry["trace"] = rec["trace"]
    return entry


def _package_of_data(data) -> str:
    return str(data["package"]) if "package" in data.files else ""


def stream_dir(root: str, stream_id: str) -> str:
    return os.path.join(root, NAMESPACE, stream_id)


def _package_of(path: str) -> Optional[str]:
    """The ``package`` field of one snapshot generation (``""`` when it has
    none), or ``None`` when the file is missing or cannot be read."""
    try:
        with np.load(path) as data:
            return _package_of_data(data)
    except Exception:  # noqa: BLE001 — missing/torn: no verdict
        return None


def list_streams(root: str) -> List[str]:
    """Stream ids with a recoverable directory under ``root``."""
    base = os.path.join(root, NAMESPACE)
    if not os.path.isdir(base):
        return []
    return sorted(
        e.name for e in os.scandir(base)
        if e.is_dir() and (
            os.path.exists(os.path.join(e.path, "snapshot.npz"))
            or os.path.exists(os.path.join(e.path, "snapshot.npz.bak"))
        )
    )


class UpdateLog:
    """One stream's durable layer:
    ``<root>/torch/<stream_id>/{snapshot.npz,wal.jsonl}``."""

    def __init__(self, root: str, stream_id: str):
        self.dir = stream_dir(root, stream_id)
        self.snap_path = os.path.join(self.dir, "snapshot.npz")
        self.wal_path = os.path.join(self.dir, "wal.jsonl")
        # The shared append/seal/read/compact mechanics (utils/wal.py);
        # chain semantics — what makes an entry FOLLOW its predecessor —
        # stay here.
        self._wal = JsonlWal(
            self.wal_path,
            schema=WAL_SCHEMA,
            counter_prefix="stream.log",
            validate=_wal_entry,
        )

    def holds_foreign(self) -> bool:
        """A readable snapshot generation here is another package's."""
        return any(
            _package_of(c) not in (PACKAGE, None)
            for c in (self.snap_path, self.snap_path + ".bak")
        )

    # -- writing -------------------------------------------------------
    def append(
        self,
        *,
        seq: int,
        prev_digest: str,
        digest: str,
        updates: list,
        trace: Optional[dict] = None,
    ) -> None:
        """Append one committed window (flushed + fsynced, flock-serialized).

        The durable chain is validated under the same flock before the
        write: an append must extend the on-disk tail (last WAL entry,
        else the snapshot head). A mismatch raises :class:`ChainBreak`
        carrying the durable head instead of forking the log — the
        fleet-shared-``stream_dir`` race where a worker holding a stale
        resident copy of a stream accepts a publish (its *in-memory* head
        matched) after another worker already committed past it.
        """
        os.makedirs(self.dir, exist_ok=True)
        with self._wal.lock():
            tail = self._durable_head()
            if tail is not None and (
                int(seq) != tail[0] + 1 or prev_digest != tail[1]
            ):
                BUS.count("stream.log.fork_refused")
                raise ChainBreak(
                    f"append seq {seq} (prev {prev_digest[:12]}...) does "
                    f"not extend the durable tail seq {tail[0]} "
                    f"({tail[1][:12]}...)",
                    seq=tail[0],
                    digest=tail[1],
                )
            # The core seals any torn tail before the write, so a crashed
            # predecessor cannot make this (durably committed) record
            # unparsable on replay.
            rec = {
                "seq": int(seq),
                "prev": prev_digest,
                "digest": digest,
                "updates": updates,
            }
            if trace is not None:
                rec["trace"] = trace
            self._wal.append(rec, locked=True)

    def snapshot(
        self,
        state: dict,
        *,
        seq: int,
        digest: str,
        notifications: Optional[list] = None,
    ) -> None:
        """Persist the session state (``WindowedMST.state_arrays``) and
        compact the WAL down to entries the snapshot does not cover.

        ``notifications`` rides along (JSON-encoded) so a recovered
        stream's ring reaches BACK past the snapshot point — a subscriber
        whose cursor predates the snapshot still drains gap-free after a
        failover, instead of hitting ``truncated``.

        Extra ``state`` keys persist as they are: the sharded-residency
        marker (``"sharded"``, stream/session.py) rides the same npz."""
        os.makedirs(self.dir, exist_ok=True)
        arrays = dict(state)
        arrays["package"] = np.asarray(PACKAGE)
        arrays["seq"] = np.asarray(int(seq))
        arrays["digest"] = np.asarray(digest)
        arrays["notifications"] = np.asarray(
            json.dumps(list(notifications or []))
        )
        with _flocked(self.snap_path):
            atomic_write_npz(self.snap_path, arrays, fault_site=FAULT_SITE)
        BUS.count("stream.log.snapshot")
        self._compact(seq)

    def _compact(self, covered_seq: int) -> None:
        """Drop WAL entries the snapshot already covers (tmp + rename; a
        crash anywhere leaves entries replay skips by sequence number)."""
        try:
            with self._wal.lock():
                entries, _torn = self._read_wal()
                keep = [e for e in entries if e["seq"] > covered_seq]
                if len(keep) == len(entries):
                    return
                self._wal.rewrite(keep, locked=True)
            BUS.count("stream.log.compact")
        except (OSError, TimeoutError):
            pass  # compaction is best-effort; replay skips covered entries

    def _durable_head(self) -> Optional[Tuple[int, str]]:
        """``(seq, digest)`` of the durable chain tail — the last WAL
        append, else the newest loadable snapshot head; ``None`` when
        neither exists (a bare log). Callers hold the WAL flock; reads
        here must not re-enter it."""
        tail = self._wal.tail()
        if tail is not None:
            return tail["seq"], tail["digest"]
        for candidate in (self.snap_path, self.snap_path + ".bak"):
            if self._quarantine_if_corrupt(candidate):
                continue
            try:
                with np.load(candidate) as data:
                    if _package_of_data(data) != PACKAGE:
                        continue  # another package's stream
                    return int(data["seq"]), str(data["digest"])
            except Exception:  # missing/torn: fall through
                continue
        return None

    @staticmethod
    def _quarantine_if_corrupt(candidate: str) -> bool:
        """Checksum-verify one snapshot generation before ``np.load``
        touches it; a sidecar mismatch quarantines the file
        (``stream.log.quarantined``) and reports True — the caller falls
        to the next generation, exactly like a torn write."""
        from distributed_ghs_implementation_tpu_torch.utils.integrity import (
            IntegrityError,
            check_file,
            quarantine,
        )

        try:
            check_file(candidate)
        except FileNotFoundError:
            return False  # the load below reports it as missing
        except IntegrityError as e:
            quarantine(
                candidate, reason=str(e), counter="stream.log.quarantined"
            )
            return True
        return False

    # -- reading -------------------------------------------------------
    def _read_wal(self, count: bool = True) -> Tuple[List[dict], int]:
        """Parse the WAL; returns ``(entries, torn_skipped)`` — the core's
        tolerant read (torn tail and unparsable mid-log lines skipped);
        whether the log is still usable past a skip is decided by
        :meth:`load`'s chain validation, which stops at any real gap."""
        return self._wal.read(count=count)

    def load_snapshot(self) -> Tuple[Optional[dict], List[Tuple[str, str]]]:
        """Newest loadable snapshot generation (primary, else ``.bak``);
        returns ``(state_or_None, notes)`` in the checkpoint-recovery
        shape (why each skipped candidate was rejected)."""
        notes: List[Tuple[str, str]] = []
        for candidate in (self.snap_path, self.snap_path + ".bak"):
            if not os.path.exists(candidate):
                notes.append((candidate, "missing"))
                continue
            if self._quarantine_if_corrupt(candidate):
                notes.append((candidate, "quarantined: checksum mismatch"))
                continue
            try:
                with np.load(candidate) as data:
                    package = _package_of_data(data)
                    if package != PACKAGE:
                        BUS.count("stream.log.foreign_refused")
                        notes.append((
                            candidate,
                            f"another package's snapshot "
                            f"(package {package or 'none'!r}, want {PACKAGE!r})",
                        ))
                        continue
                    state = {
                        "num_nodes": int(data["num_nodes"]),
                        "u": np.asarray(data["u"]),
                        "v": np.asarray(data["v"]),
                        "w": np.asarray(data["w"]),
                        "in_tree": np.asarray(data["in_tree"], dtype=bool),
                        "seq": int(data["seq"]),
                        "digest": str(data["digest"]),
                        "notifications": (
                            json.loads(str(data["notifications"]))
                            if "notifications" in data.files else []
                        ),
                        # The residency marker (stream/session.py): this
                        # head lived on the mesh lane, so a recovering
                        # worker re-stages it before replaying.
                        "sharded": (
                            bool(data["sharded"])
                            if "sharded" in data.files else False
                        ),
                    }
            except Exception as e:  # torn/corrupt: fall to the next generation
                notes.append((candidate, f"{type(e).__name__}: {e}"))
                continue
            if candidate.endswith(".bak"):
                BUS.count("stream.log.snap_fallback")
            return state, notes
        return None, notes

    def load(self) -> Tuple[Optional[dict], List[dict], List[Tuple[str, str]]]:
        """Replay input: ``(snapshot_state_or_None, chained_entries, notes)``.

        ``chained_entries`` are the WAL windows that verifiably follow the
        snapshot: contiguous sequence numbers starting at ``seq + 1`` whose
        ``prev`` digests chain from the snapshot digest. The first entry
        breaking the chain stops the list (``stream.log.chain_broken``) —
        the snapshot/log-disagreement degraded path.
        """
        state, notes = self.load_snapshot()
        entries, _torn = self._read_wal()
        if state is None:
            return None, [], notes
        chained: List[dict] = []
        seq, head = state["seq"], state["digest"]
        broken = False
        for entry in entries:
            if entry["seq"] <= seq:
                continue  # covered by the snapshot (compaction raced a crash)
            if entry["seq"] != seq + 1 or entry["prev"] != head:
                BUS.count("stream.log.chain_broken")
                notes.append((
                    self.wal_path,
                    f"chain break at seq {entry['seq']} "
                    f"(expected {seq + 1} following {head[:12]}...)",
                ))
                broken = True
                break
            chained.append(entry)
            seq, head = entry["seq"], entry["digest"]
        if broken:
            self._truncate_to_chain()
        return state, chained, notes

    def _truncate_to_chain(self) -> None:
        """Repair a mid-log chain break: rewrite the WAL down to the
        prefix that chains from the snapshot. Entries past the break are
        unreachable by replay, but ``append`` validates against the LAST
        parsable line — leaving them in place refuses every publish from
        the recovered head forever (the client adopts the dead tail
        digest, the session keeps recovering to the chained head: a
        re-sync livelock). The chain is re-derived from the freshest
        snapshot generation INSIDE the flock, so a concurrent writer that
        just advanced the snapshot (making the tail chain again) is never
        clobbered. Best-effort like compaction: a failed rewrite leaves
        the pre-repair state."""
        try:
            with self._wal.lock():
                state, _notes = self.load_snapshot()
                if state is None:
                    return
                entries, _torn = self._read_wal(count=False)
                keep: List[dict] = []
                seq, head = state["seq"], state["digest"]
                for entry in entries:
                    if entry["seq"] <= seq:
                        continue  # covered: compaction's job either way
                    if entry["seq"] != seq + 1 or entry["prev"] != head:
                        break
                    keep.append(entry)
                    seq, head = entry["seq"], entry["digest"]
                if len(keep) == len(entries):
                    return
                self._wal.rewrite(keep, locked=True)
            BUS.count("stream.log.chain_truncated")
        except (OSError, TimeoutError):
            pass
