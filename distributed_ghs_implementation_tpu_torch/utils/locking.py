"""Advisory per-path write locking shared by every durable layer.

One helper, three users: the shared on-disk result store
(``serve/store.py``), the stream snapshot+WAL log (``stream/log.py``), and
the router's accepted-work journal (``fleet/journal.py``). It used to live
as ``serve.store._flocked``; the router journal must stay importable
without the serve stack (echo-worker fleets never pay the solver's import), so
the lock moved here and ``serve.store`` re-exports it unchanged.

The lock serializes *writers only* — every caller keeps its read path
lock-free (atomic rename + content re-validation) so lookups never block
on a slow writer. ``flock`` is fd-scoped: a holding process that dies
releases it automatically, which is exactly the failure semantics a
crash-recovery layer needs from its own serialization primitive.
"""

from __future__ import annotations

import contextlib
import os
import time

try:  # advisory write locking (processes sharing one directory)
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: single-writer only
    fcntl = None

from distributed_ghs_implementation_tpu_torch.obs.events import BUS

#: How long a writer waits for a contended per-path lock before giving up
#: (callers treat a timeout as a skipped write, never a failed request).
LOCK_TIMEOUT_S = 2.0
_LOCK_POLL_S = 0.005


def fsync_dir(d: str) -> None:
    """Make a rename/creation durable: fsync the directory holding it.
    Filesystems without directory fds (or sandboxes refusing them) get
    best-effort — the write stays atomic, just back to eventually-
    durable. Shared by ``atomic_write_npz`` and the WAL core."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def flocked(
    path: str,
    timeout_s: float = LOCK_TIMEOUT_S,
    *,
    counter: str = "serve.store.lock_timeout",
):
    """Advisory per-path write lock (``<path>.lock``, ``fcntl.flock``).

    Processes sharing one directory (fleet workers on a ``disk_dir`` or
    ``stream_dir``, a restarted router on its journal) must not interleave
    the ``.bak`` rotation inside ``atomic_write_npz`` (rotate, rotate,
    rename, rename) or fuse two half-written WAL appends. Raises
    ``TimeoutError`` past ``timeout_s`` (counted on ``counter`` — the
    default keeps the historical ``serve.store.lock_timeout`` name);
    holders that die release the lock automatically (flock is fd-scoped,
    the kernel drops it on process exit).
    """
    if fcntl is None:
        yield
        return
    # The lock file precedes the payload (writers beneath us create their
    # directory lazily — the lock must not fail on a fresh directory).
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    lock_path = path + ".lock"
    deadline = time.monotonic() + timeout_s
    while True:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                if time.monotonic() >= deadline:
                    BUS.count(counter)
                    raise TimeoutError(
                        f"write lock busy > {timeout_s}s: {path}"
                    ) from None
                time.sleep(_LOCK_POLL_S)
                continue
            # Re-validate after acquiring: a cleanup sweep may have
            # unlinked this lock file between our open and our flock, in
            # which case we hold a lock on an anonymous inode while a
            # newer writer holds one on the recreated file — retry on the
            # current file.
            try:
                current_ino = os.stat(lock_path).st_ino
            except FileNotFoundError:
                current_ino = -1
            if os.fstat(fd).st_ino != current_ino:
                continue  # stale inode: reopen and re-acquire
            yield
            return
        finally:
            os.close(fd)  # closing the fd releases the flock
