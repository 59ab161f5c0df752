"""Reusable append-only JSONL write-ahead-log core.

Port of the JAX package's ``utils/wal.py``, unchanged: the record format
and its CRC stamping are that package's, so either package reads a log the
other wrote (the stream layer refuses another package's stream by its
snapshot, ``stream/log.py``).

Factored out of ``stream/log.py`` (which hardened these idioms over five
review rounds) so the router's accepted-work journal (``fleet/journal.py``)
can share the exact same durability discipline instead of re-deriving it:

* **Durable appends** — one JSON object per line, flushed + fsynced,
  serialized across processes by the advisory per-path flock
  (``utils/locking.py``). Before writing, a *torn tail* left by a crash
  mid-append (a partial line with no trailing newline) is sealed with a
  newline, so the new — durably committed — record can never fuse onto
  garbage and become unparsable itself.
* **Tolerant reads** — :meth:`JsonlWal.read` skips a torn tail and any
  unparsable mid-log line (each counted on the owner's taxonomy), then
  hands the surviving entries to the caller, whose *chain validation*
  (digest chain for streams, sequence contiguity for the router journal)
  decides how much of the suffix is still trustworthy.
* **Tail scan** — :meth:`JsonlWal.tail` finds the last parsable entry by
  a backwards chunked scan, so per-append validation stays O(tail) even
  when compaction has been failing and the log has grown.
* **Compaction** — :meth:`JsonlWal.rewrite` replaces the log atomically
  (tmp + fsync + rename); a crash anywhere leaves either the old or the
  new generation, never a mix.
* **Record checksums** (round 19) — every line carries a ``crc`` field
  (crc32 over the record's canonical JSON), validated on read: a bit flip
  that keeps the line parsable — the corruption schema checks cannot see
  — is counted (``.crc_mismatch``) and skipped instead of replayed.
  Pre-crc lines (no field) stay accepted, so existing logs upgrade in
  place.

The core knows nothing about what a record *means*: callers provide the
``schema`` stamped into (and checked out of) every line, an optional
``validate`` hook for field coercion, and the counter prefix their
taxonomy lives under (``stream.log`` / ``fleet.router.journal``).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, List, Optional, Tuple

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.utils.locking import flocked, fsync_dir


def _canonical(obj: dict) -> str:
    """The one byte-deterministic JSON form records are checksummed over
    (sorted keys, tight separators, ASCII escapes) — ``json.loads`` then
    ``_canonical`` round-trips to the identical string, so readers can
    re-derive the writer's checksum input from the parsed record."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _stamp_crc(record: dict) -> str:
    """One record -> its log line: canonical JSON with a ``crc`` field
    (crc32 of the canonical form WITHOUT the field). A bit flip inside a
    value that stays valid JSON — the corruption the schema check cannot
    see — then fails the checksum on read instead of replaying garbage."""
    crc = zlib.crc32(_canonical(record).encode("utf-8"))
    return _canonical({**record, "crc": crc})


class JsonlWal:
    """One append-only JSONL log file with the durability discipline above.

    ``validate(record) -> dict`` turns one parsed, schema-checked JSON
    object into the caller's entry shape; raising ``ValueError`` /
    ``KeyError`` / ``TypeError`` marks the line unparsable (skipped and
    counted like any other corruption). ``counter_prefix`` namespaces the
    ``.sealed_torn`` / ``.torn_skipped`` / ``.corrupt_line`` / ``.append``
    / ``.rewrite`` counters.
    """

    def __init__(
        self,
        path: str,
        *,
        schema: str,
        counter_prefix: str,
        validate: Optional[Callable[[dict], dict]] = None,
    ):
        self.path = path
        self.schema = schema
        self.counter_prefix = counter_prefix
        self._validate = validate

    def _count(self, name: str, n: int = 1) -> None:
        BUS.count(f"{self.counter_prefix}.{name}", n)

    def lock(self):
        """The advisory cross-process write lock for this log. Callers
        that must validate-then-append atomically hold it around both
        (``append(..., locked=True)`` skips re-taking it)."""
        return flocked(
            self.path, counter=f"{self.counter_prefix}.lock_timeout"
        )

    # -- writing -------------------------------------------------------
    def append(self, record: dict, *, locked: bool = False) -> None:
        """Durably append one record (schema stamped in), sealing any torn
        tail first so a crashed predecessor cannot corrupt this line."""
        if locked:
            self._append_locked(record)
        else:
            with self.lock():
                self._append_locked(record)

    def _append_locked(self, record: dict) -> None:
        parent = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(parent, exist_ok=True)
        line = _stamp_crc({"schema": self.schema, **record})
        seal = b""
        created = True
        try:
            with open(self.path, "rb") as rf:
                created = False
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    seal = b"\n"
                    self._count("sealed_torn")
        except FileNotFoundError:
            pass  # missing: the append below creates it
        except OSError:
            created = False  # exists but empty: nothing to seal
        with open(self.path, "ab") as f:
            f.write(seal + (line + "\n").encode())
            f.flush()
            os.fsync(f.fileno())
        if created:
            # A first append CREATES the log: without a directory fsync
            # the entry is only eventually durable, and "durable before
            # the caller proceeds" is this class's whole contract (the
            # same host-crash hole atomic_write_npz closes).
            fsync_dir(parent)
        self._count("append")

    def rewrite(self, entries: List[dict], *, locked: bool = False) -> None:
        """Atomically replace the log with ``entries`` (compaction /
        chain-truncation repair). tmp + fsync + rename: a crash leaves
        either generation whole, never a blend."""
        if locked:
            self._rewrite_locked(entries)
        else:
            with self.lock():
                self._rewrite_locked(entries)

    def _rewrite_locked(self, entries: List[dict]) -> None:
        os.makedirs(
            os.path.dirname(os.path.abspath(self.path)) or ".", exist_ok=True
        )
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for e in entries:
                f.write(_stamp_crc({"schema": self.schema, **e}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        fsync_dir(os.path.dirname(os.path.abspath(self.path)) or ".")
        self._count("rewrite")

    # -- reading -------------------------------------------------------
    def parse_line(self, line: str) -> Optional[dict]:
        """One log line -> entry dict, or ``None`` for anything torn,
        unparsable, or schema-mismatched."""
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
            crc = rec.pop("crc", None)
            if crc is not None and zlib.crc32(
                _canonical(rec).encode("utf-8")
            ) != crc:
                # Parsable-but-wrong bytes: a value-level bit flip the
                # schema check cannot see. Counted separately (then
                # skipped like any corrupt line); records from pre-crc
                # builds simply have no crc field and stay accepted.
                self._count("crc_mismatch")
                raise ValueError("record checksum mismatch")
            if rec.get("schema") != self.schema:
                raise ValueError(f"bad schema {rec.get('schema')!r}")
            rec.pop("schema", None)
            if self._validate is not None:
                rec = self._validate(rec)
            return rec
        except (ValueError, KeyError, TypeError):
            return None

    def read(self, *, count: bool = True) -> Tuple[List[dict], int]:
        """Parse the whole log; returns ``(entries, torn_skipped)``.

        A partial final line (torn append) is skipped; an unparsable line
        anywhere else is also skipped (a sealed torn record from a retried
        append sits mid-file) — whether the log is usable past it is the
        caller's chain validation to decide.
        """
        if not os.path.exists(self.path):
            return [], 0
        # errors="replace", like tail(): a non-UTF-8 corruption byte must
        # become an unparsable (skipped, chain-breaking) line, not an
        # uncaught UnicodeDecodeError that makes the whole log — valid
        # prefix included — unrecoverable.
        with open(self.path, encoding="utf-8", errors="replace") as f:
            raw = f.read()
        entries: List[dict] = []
        torn = 0
        lines = raw.split("\n")
        complete = lines[:-1]  # text after the final newline is a torn tail
        if lines[-1]:
            torn += 1
        for i, line in enumerate(complete):
            if not line.strip():
                continue
            entry = self.parse_line(line)
            if entry is None:
                if i == len(complete) - 1:
                    torn += 1  # torn mid-record on the last complete line
                elif count:
                    self._count("corrupt_line")
                continue
            entries.append(entry)
        if torn and count:
            self._count("torn_skipped", torn)
        return entries, torn

    def tail(self) -> Optional[dict]:
        """Last complete, parsable entry, by a backwards chunked scan of
        the file tail — per-append validation must not become O(total log)
        when compaction keeps failing and the file grows."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        buf = b""
        with open(self.path, "rb") as f:
            pos = size
            while pos > 0:
                step = min(65536, pos)
                pos -= step
                f.seek(pos)
                buf = f.read(step) + buf
                lines = buf.decode("utf-8", errors="replace").split("\n")
                # lines[-1] is a torn tail (or empty past the final
                # newline); lines[0] may be a mid-line fragment unless
                # the scan reached the start of the file.
                first = 0 if pos == 0 else 1
                for line in reversed(lines[first:-1]):
                    if not line.strip():
                        continue
                    entry = self.parse_line(line)
                    if entry is not None:
                        return entry
        return None
