"""Content checksums for persisted artifacts: sha256 sidecars + quarantine.

Every npz the stack persists (serve result store entries, stream
snapshots, solver checkpoints) is written through
``utils.checkpoint.atomic_write_npz``, which also writes a
``<path>.sha256`` sidecar holding the hex digest of the final file bytes.
Loads verify the sidecar BEFORE deserializing: a mismatch means the bytes
changed after the commit point (bit rot, a torn filesystem, an overwrite
race nothing else caught) and the file must not be parsed — ``np.load``
on garbage can throw from deep inside zlib, or worse, succeed and hand
back plausible wrong arrays.

Verification outcomes:

* ``"ok"`` — sidecar present and matching.
* ``"unverified"`` — no sidecar (a file written before sidecars existed,
  or a crash landed between the data rename and the sidecar write).
  Accepted: refusing every legacy file on upgrade would be a
  self-inflicted cache wipe. The caller's counter (e.g.
  ``serve.store.unverified``) keeps the exposure visible.
* :class:`IntegrityError` — sidecar present and WRONG. The caller
  quarantines the file (:func:`quarantine` moves it — and its sidecar —
  into a ``.quarantine/`` subdirectory next to it, preserving the
  evidence for postmortems) and degrades to a miss.

Checksums are over raw file bytes, not parsed content, so verification
never allocates array-sized buffers for corrupt input.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import tempfile
from typing import Optional

from distributed_ghs_implementation_tpu_torch.obs.events import BUS

SIDECAR_SUFFIX = ".sha256"
QUARANTINE_DIR = ".quarantine"
#: Quarantined generations retained per directory (oldest reaped first):
#: evidence, not an archive.
QUARANTINE_CAP = 64


class IntegrityError(ValueError):
    """A file's bytes do not match its recorded checksum."""

    def __init__(self, path: str, expected: str, actual: str):
        super().__init__(
            f"checksum mismatch for {path}: sidecar says {expected[:16]}..., "
            f"file hashes to {actual[:16]}..."
        )
        self.path = path
        self.expected = expected
        self.actual = actual


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_sidecar(path: str, digest: Optional[str] = None) -> str:
    """Record ``path``'s checksum in its sidecar (tmp + rename — readers
    see the old sidecar or the new one, never a torn hex string)."""
    if digest is None:
        digest = sha256_file(path)
    side = sidecar_path(path)
    d = os.path.dirname(os.path.abspath(side)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".sha256.tmp")
    try:
        os.write(fd, (digest + "\n").encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, side)
    return side


def read_sidecar(path: str) -> Optional[str]:
    try:
        with open(sidecar_path(path)) as f:
            digest = f.read().strip()
    except OSError:
        return None
    return digest or None


def check_file(path: str) -> str:
    """Verify ``path`` against its sidecar: ``"ok"`` / ``"unverified"``
    (no sidecar), raising :class:`IntegrityError` on a mismatch. The file
    must exist (propagates ``FileNotFoundError`` — absence is the
    caller's plain-miss path, never an integrity event)."""
    expected = read_sidecar(path)
    actual = sha256_file(path)  # also raises FileNotFoundError for caller
    if expected is None:
        return "unverified"
    if actual != expected:
        raise IntegrityError(path, expected, actual)
    return "ok"


def quarantine(
    path: str,
    *,
    reason: str = "",
    counter: Optional[str] = None,
) -> Optional[str]:
    """Move ``path`` (and its sidecar) into ``.quarantine/`` next to it.

    Returns the quarantined path, or ``None`` when the file was already
    gone (a concurrent reader quarantined it first — their move IS the
    outcome this one wanted). The move is ``os.replace`` within one
    directory tree: atomic, and a corrupt file can never be half-removed.
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    qdir = os.path.join(directory, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dest = os.path.join(qdir, os.path.basename(path))
    try:
        os.replace(path, dest)
    except FileNotFoundError:
        return None
    with contextlib.suppress(OSError):
        os.replace(sidecar_path(path), sidecar_path(dest))
    if counter:
        BUS.count(counter)
    BUS.instant(
        "integrity.quarantined", cat="integrity",
        path=os.path.basename(path), reason=reason or "checksum/corrupt",
    )
    _reap_quarantine(qdir)
    return dest


def _reap_quarantine(qdir: str) -> None:
    """Bound the evidence locker: oldest quarantined files past the cap
    are deleted (best-effort — a racing sibling's unlink is success)."""
    try:
        entries = [
            e for e in os.scandir(qdir)
            if e.is_file() and not e.name.endswith(SIDECAR_SUFFIX)
        ]
    except OSError:
        return
    if len(entries) <= QUARANTINE_CAP:
        return
    entries.sort(key=lambda e: e.stat().st_mtime)
    for entry in entries[: len(entries) - QUARANTINE_CAP]:
        for victim in (entry.path, sidecar_path(entry.path)):
            with contextlib.suppress(OSError):
                os.unlink(victim)


def list_quarantined(directory: str) -> list:
    """Quarantined basenames under ``directory`` (ops/drill visibility)."""
    qdir = os.path.join(directory, QUARANTINE_DIR)
    try:
        return sorted(
            e.name for e in os.scandir(qdir)
            if e.is_file() and not e.name.endswith(SIDECAR_SUFFIX)
        )
    except OSError:
        return []
