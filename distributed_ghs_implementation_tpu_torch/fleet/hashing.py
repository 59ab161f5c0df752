"""Consistent-hash ring: ``Graph.digest()`` -> worker id.

Port of the JAX package's ``fleet/hashing.py``, unchanged: ring points are
the same sha256 prefixes, so one digest lands on the same worker id in
either package's fleet.

Why consistent hashing and not ``hash(key) % N``: worker death (and
restart-rejoin) must move only the dead worker's share of the keyspace.
With modulo routing, removing one of three workers reassigns ~2/3 of all
digests — every surviving worker's warm result cache, materialized update
sessions, and AOT-compiled buckets turn cold at exactly the moment the
fleet is degraded. On the ring, keys owned by survivors stay put (the
bounded-movement property ``tests/test_fleet.py`` pins).

Determinism is load-bearing: ring points are sha256 of ``"{member}#{i}"``
— no process-seeded ``hash()`` — so the digest->worker mapping is identical
across router restarts and across machines. A restarted fleet re-routes
every digest to the worker whose shared-disk-store entries and compile
cache it warmed last time.

Churn-safe by construction: :meth:`HashRing.add` is idempotent (a member
already on the ring gains no duplicate points — an autoscaler join racing
a restart rejoin cannot double a worker's keyspace share) and
:meth:`HashRing.remove` of an absent member is a no-op (a retire racing a
death-path removal cannot corrupt the point list). The elastic fleet
(``fleet/autoscaler.py``) adds and removes members continuously, so both
properties are pinned by the churn tests in ``tests/test_fleet.py``.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, List, Tuple


def _point(token: str) -> int:
    return int.from_bytes(
        hashlib.sha256(token.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Sorted-point consistent-hash ring over small member ids."""

    def __init__(self, members: Iterable[int] = (), replicas: int = 64):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = replicas
        self._points: List[Tuple[int, int]] = []  # (point, member), sorted
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len({m for _, m in self._points})

    def members(self) -> set:
        return {m for _, m in self._points}

    def add(self, member: int) -> None:
        if any(m == member for _, m in self._points):
            return  # idempotent under churn: never duplicate ring points
        for i in range(self.replicas):
            bisect.insort(self._points, (_point(f"{member}#{i}"), member))

    def remove(self, member: int) -> None:
        self._points = [p for p in self._points if p[1] != member]

    def assign(self, key: str) -> int:
        """The member owning ``key`` (first ring point clockwise of its
        hash). Raises ``LookupError`` on an empty ring — the caller decides
        whether that means *wait* (workers restarting) or *fail*."""
        if not self._points:
            raise LookupError("hash ring is empty (no live workers)")
        h = _point(key)
        i = bisect.bisect_right(self._points, (h, -1))
        if i == len(self._points):
            i = 0  # wrap
        return self._points[i][1]
