"""Content-addressed solve cache: graph digest + solver config -> MSTResult.

Port of the JAX package's ``serve/store.py``, with one difference on
purpose: the backend token of a key is the port's own
(``"{digest}:torch_device"`` where the JAX package writes
``"{digest}:device"``), and a disk entry carries a ``package`` field that
the port's reads require. A port result never answers for a JAX one in a
shared disk directory, nor a JAX result for the port's: either would hide
a fault of one package behind the other's answer.

Keying is by *content*, never identity: :func:`solve_cache_key` combines
:meth:`Graph.digest` (stable sha256 over the canonicalized ``u/v/w`` arrays
plus ``num_nodes`` — the same hash checkpoint fingerprints derive from) with
the solver configuration, so two requests describing the same weighted edge
set hit the same entry regardless of edge input order or which client sent
them.

Two layers:

* an in-memory LRU front (``capacity`` entries; an entry is an
  :class:`api.MSTResult`, which pins its graph's arrays — size the capacity
  to the working set, not the request rate), and
* an optional on-disk layer (``disk_dir``) holding one npz per key through
  ``utils.checkpoint.atomic_write_npz`` — the same tmp-file + rename +
  ``.bak``-generation write path checkpoints use, so a crash mid-write never
  leaves a poisoned cache entry (the ``serve.store.save`` fault site tears
  writes in tests). Disk hits are re-validated against the graph's
  digest before they are served and promoted into memory. Writes take an
  advisory per-key ``flock`` (:func:`_flocked`) so fleet workers sharing one
  ``disk_dir`` cannot interleave a publish; reads stay lock-free.

Telemetry (``obs`` bus): ``serve.store.hit`` / ``.miss`` / ``.disk_hit`` /
``.put`` / ``.evict`` counters; all methods are thread-safe (the scheduler
calls in from concurrent request threads).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from typing import Optional

import numpy as np

try:  # advisory write locking (fleet workers share one disk_dir)
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: single-writer only
    fcntl = None

from distributed_ghs_implementation_tpu_torch.api import MSTResult
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.utils.locking import (
    LOCK_TIMEOUT_S,
    flocked,
)


def solve_cache_key(
    graph: Graph, *, backend: str = "device", kind: str = "mst"
) -> str:
    """The cache identity of one solve: content digest + solver config.

    ``backend`` is the *requested* entry (e.g. ``"device"``), not the rung a
    supervised solve eventually lands on — a degraded result is still the
    exact MSF (every rung computes the identical forest), so it may serve
    later requests for the same entry. The key writes it as the port's
    token, ``torch_<backend>``, so that no key of the port equals one of
    the JAX package's.

    ``kind`` is the analytics query-kind token (``"mst"``, ``"components"``,
    ``"k_msf4"``, ...): a components answer for a digest must never collide
    with the MST answer for the same digest, so non-``mst`` kinds append the
    token as a third key segment; ``"mst"`` keys have two segments.
    """
    return cache_key_for_digest(graph.digest(), backend=backend, kind=kind)


def cache_key_for_digest(
    digest: str, *, backend: str = "device", kind: str = "mst"
) -> str:
    """:func:`solve_cache_key` for an already-computed digest (to evict by
    digest alone, without the graph). Non-``mst`` ``kind`` tokens become a
    third ``:``-separated segment (must be filename-safe: ``[a-z0-9_]``)."""
    base = f"{digest}:{BACKEND_TOKEN_PREFIX}{backend}"
    if kind == "mst":
        return base
    token = str(kind)
    if not token or not all(ch.isalnum() or ch == "_" for ch in token):
        raise ValueError(f"bad cache kind token {kind!r}")
    return f"{base}:{token}"


#: What the port writes before a backend in a key, where the JAX package
#: writes nothing: ``device`` keys as ``torch_device``.
BACKEND_TOKEN_PREFIX = "torch_"

#: The value of a disk entry's ``package`` field; the port reads no entry
#: without it, so a JAX package's file is never served.
PACKAGE = "torch"


def _disk_path(disk_dir: str, key: str) -> str:
    return os.path.join(disk_dir, key.replace(":", "_") + ".npz")


#: Advisory per-key write locking lives in ``utils/locking.py``;
#: ``_flocked`` binds it to this store's timeout and counter.
_LOCK_TIMEOUT_S = LOCK_TIMEOUT_S


def _flocked(path: str, timeout_s: float = _LOCK_TIMEOUT_S):
    """Advisory per-key write lock (see :func:`utils.locking.flocked`)."""
    return flocked(path, timeout_s, counter="serve.store.lock_timeout")


class ResultStore:
    """In-memory LRU + optional on-disk content-addressed result cache."""

    def __init__(
        self,
        capacity: int = 128,
        disk_dir: Optional[str] = None,
        disk_max_entries: int = 512,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.disk_dir = disk_dir
        self.disk_max_entries = disk_max_entries
        self._mem: "collections.OrderedDict[str, MSTResult]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def get(
        self,
        key: str,
        graph: Optional[Graph] = None,
        *,
        record_miss: bool = True,
    ) -> Optional[MSTResult]:
        """Look up ``key``; memory first, then disk (needs ``graph`` to
        rebuild the result — content addressing means the caller has it).
        ``record_miss=False`` keeps a re-probe (the scheduler's single-flight
        double-check) from inflating the miss counter."""
        with self._lock:
            result = self._mem.get(key)
            if result is not None:
                self._mem.move_to_end(key)
                BUS.count("serve.store.hit")
                return result
        if self.disk_dir is not None and graph is not None:
            result = self._disk_get(key, graph)
            if result is not None:
                BUS.count("serve.store.hit")
                BUS.count("serve.store.disk_hit")
                self._mem_put(key, result)
                return result
        if record_miss:
            BUS.count("serve.store.miss")
        return None

    def put(
        self, key: str, result: MSTResult, *, memory_only: bool = False
    ) -> None:
        """Cache ``result``; ``memory_only=True`` skips the disk layer.

        Stream window commits use ``memory_only``: their durability is the
        stream snapshot+WAL (replay rebuilds any head), so a full-graph npz
        write per committed window — for a head the next window supersedes
        — would be pure disk churn on the commit hot path.
        """
        BUS.count("serve.store.put")
        self._mem_put(key, result)
        if self.disk_dir is not None and not memory_only:
            try:
                self._disk_put(key, result)
                self._disk_sweep()
            except Exception:  # noqa: BLE001 — write-behind is best-effort
                # A failed (or torn) cache write must never fail the request
                # that produced the result; the atomic writer left either
                # nothing or a .bak generation behind, and reads re-validate
                # digests, so the worst case is a future miss.
                BUS.count("serve.store.disk_write_failed")

    def invalidate(self, key: str, *, reason: str = "") -> bool:
        """Hard-evict a POISONED entry: memory LRU dropped, every disk
        generation quarantined (never merely unlinked — a failed
        certificate's input is postmortem evidence, and a digest chain
        that re-plants it from disk would serve the same wrong answer
        again). Returns whether anything was removed
        (``serve.store.invalidated``)."""
        removed = False
        with self._lock:
            removed = self._mem.pop(key, None) is not None
        if self.disk_dir is not None:
            from distributed_ghs_implementation_tpu_torch.utils.integrity import (
                quarantine,
            )

            path = _disk_path(self.disk_dir, key)
            for candidate in (path, path + ".bak"):
                if os.path.exists(candidate):
                    removed = bool(quarantine(
                        candidate, reason=reason or "invalidated",
                        counter="serve.store.quarantined",
                    )) or removed
        if removed:
            BUS.count("serve.store.invalidated")
        return removed

    def evict_chain(self, key: str) -> bool:
        """Drop a superseded digest-chain ancestor from the memory LRU.

        A stream commit renames its graph content-addressed every window;
        without this, every window's result lingers in memory until
        capacity pressure — for a long-lived subscribed graph that is the
        whole LRU filled with dead ancestors. Disk entries stay (the
        bounded sweep handles those): a late query for an old chain link
        is still answerable, just not at the cost of memory.

        Kind variants ride along: analytics entries key as
        ``{digest}:{backend}:{kind}`` (see :func:`cache_key_for_digest`), so
        evicting the base ``{digest}:{backend}`` ancestor also drops every
        kind-variant sibling — a superseded graph's components/k-MSF answers
        are exactly as dead as its MST. Returns whether any entry was
        dropped (``serve.store.chain_evicted`` counts each).
        """
        dropped = 0
        prefix = key + ":"
        with self._lock:
            victims = [
                k for k in self._mem if k == key or k.startswith(prefix)
            ]
            for k in victims:
                self._mem.pop(k, None)
                dropped += 1
        for _ in range(dropped):
            BUS.count("serve.store.chain_evicted")
        return dropped > 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._mem),
                "capacity": self.capacity,
                "disk_dir": self.disk_dir,
            }

    # ------------------------------------------------------------------
    def _mem_put(self, key: str, result: MSTResult) -> None:
        with self._lock:
            self._mem[key] = result
            self._mem.move_to_end(key)
            while len(self._mem) > self.capacity:
                self._mem.popitem(last=False)
                BUS.count("serve.store.evict")

    def _disk_put(self, key: str, result: MSTResult) -> None:
        from distributed_ghs_implementation_tpu_torch.utils.checkpoint import (
            atomic_write_npz,
        )

        path = _disk_path(self.disk_dir, key)
        with _flocked(path):
            atomic_write_npz(
                path,
                {
                    "digest": result.graph.digest_words(),
                    "edge_ids": result.edge_ids,
                    "num_levels": result.num_levels,
                    "num_components": result.num_components,
                    "backend": np.asarray(result.backend),
                    "package": np.asarray(PACKAGE),
                },
                fault_site="serve.store.save",
            )

    def _disk_sweep(self) -> None:
        """Bound the disk layer: drop the oldest entries (and their ``.bak``
        generations) past ``disk_max_entries`` — an update stream re-keys to
        a new digest per batch, so without GC the directory grows forever."""
        entries = [
            e for e in os.scandir(self.disk_dir) if e.name.endswith(".npz")
        ]
        if len(entries) <= self.disk_max_entries:
            return
        entries.sort(key=lambda e: e.stat().st_mtime)
        for entry in entries[: len(entries) - self.disk_max_entries]:
            for path in (
                entry.path, entry.path + ".bak",
                entry.path + ".sha256", entry.path + ".bak.sha256",
            ):
                # Concurrent workers sweep the shared directory too — a
                # sibling winning the unlink race is success, not an error.
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
            self._sweep_lock_file(entry.path + ".lock")
            BUS.count("serve.store.disk_evict")

    @staticmethod
    def _sweep_lock_file(lock_path: str) -> None:
        """GC an evicted entry's lock file — but only while HOLDING it.

        Unlinking a lock file someone else holds (or is about to flock)
        would let two writers lock different inodes of the same name and
        interleave a publish; :func:`_flocked` re-validates its inode
        after acquiring, which makes this held-then-unlink safe. A busy
        lock is simply left behind (tiny, retried next sweep)."""
        if fcntl is None:
            return
        try:
            fd = os.open(lock_path, os.O_RDWR)
        except FileNotFoundError:
            return
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return  # a writer holds it: not ours to reap
            with contextlib.suppress(FileNotFoundError):
                os.unlink(lock_path)
        finally:
            os.close(fd)

    def _disk_get(self, key: str, graph: Graph) -> Optional[MSTResult]:
        """One disk probe, with the failure modes told apart:

        * **ENOENT** — a plain miss: never counted as corruption.
        * **checksum mismatch** (``utils/integrity.py`` sidecar) — the
          bytes rotted after the commit point: quarantine the file
          (``.quarantine/``, ``serve.store.quarantined``) WITHOUT parsing
          it, try the ``.bak`` generation, degrade to a miss.
        * **torn/corrupt npz** (no sidecar to catch it — a legacy or
          crash-window file) — ``np.load`` failures quarantine the same
          way; they are corruption, not a miss, and must never raise out
          of :meth:`get`.
        * **digest mismatch** — a different graph collided on the
          filename: not corruption, just not our entry.
        * **no ``package`` field of the port's** — another package's entry
          (the JAX package writes none): not ours, a miss.
        """
        from distributed_ghs_implementation_tpu_torch.utils.integrity import (
            IntegrityError,
            check_file,
            quarantine,
        )

        path = _disk_path(self.disk_dir, key)
        for candidate in (path, path + ".bak"):
            if not os.path.exists(candidate):
                continue
            try:
                if check_file(candidate) == "unverified":
                    BUS.count("serve.store.unverified")
            except FileNotFoundError:
                continue  # lost a race with a sweep: a miss, not corruption
            except IntegrityError as e:
                quarantine(
                    candidate, reason=str(e),
                    counter="serve.store.quarantined",
                )
                continue
            try:
                with np.load(candidate) as data:
                    if "package" not in data.files or str(data["package"]) != PACKAGE:
                        continue  # another package's entry
                    stored = np.asarray(data["digest"])
                    if not np.array_equal(stored, graph.digest_words()):
                        continue  # a different graph collided on the filename
                    return MSTResult(
                        graph=graph,
                        edge_ids=np.asarray(data["edge_ids"]),
                        num_levels=int(data["num_levels"]),
                        wall_time_s=0.0,
                        backend=str(data["backend"]),
                        num_components=int(data["num_components"]),
                    )
            except Exception as e:  # noqa: BLE001 — torn/corrupt npz
                quarantine(
                    candidate, reason=f"{type(e).__name__}: {e}",
                    counter="serve.store.quarantined",
                )
                continue
        return None
