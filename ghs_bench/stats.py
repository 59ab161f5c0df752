"""The benchmark's arithmetic: rates and interval unions and gaps."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def rate(count: float, seconds: float) -> Optional[float]:
    return count / seconds if seconds > 0 else None


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for start, end in sorted(intervals):
        if end <= cursor:
            continue
        if start > cursor:
            out.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
