"""The system's own spans and counters, read off its event bus once the
window has closed: each per-layer reader of a ``program_span`` or
``program_counter`` metric is one call here.

The bus keeps its events in memory, stamped on its own epoch; its
``perf_counter_s`` puts a stamp on the host clock that the window, the
benchmark's spans and the device trace's anchor are on. A system whose bus
has no such conversion, or that recorded no such span or counter in the
window, reads ``None``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ghs_bench import harness


def _bus():
    """The system's event bus, or ``None`` where it cannot be put on the
    host clock."""
    try:
        from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    except ImportError:
        return None
    return BUS if hasattr(BUS, "perf_counter_s") else None


def spans(record: harness.RunRecord, *names: str) -> List[Tuple[str, float, float, dict]]:
    """``(name, start, end, args)``, on the host clock, of the system's
    spans named ``names`` that lie inside the window."""
    bus = _bus()
    if bus is None:
        return []
    lo, hi = record.window
    out = []
    for ph, name, _cat, ts, dur, _tid, args in bus.events():
        if ph != "X" or name not in names:
            continue
        start, end = bus.perf_counter_s(ts), bus.perf_counter_s(ts + dur)
        if lo <= start and end <= hi:
            out.append((name, start, end, args or {}))
    return out


def seconds_per_solve(record: harness.RunRecord, *names: str) -> Optional[float]:
    """The seconds of the system's spans ``names`` in the window, summed,
    over the window's solves."""
    found = spans(record, *names)
    if not found or not record.solves:
        return None
    return sum(end - start for _, start, end, _ in found) / len(record.solves)


def counter_delta(record: harness.RunRecord, name: str) -> Optional[float]:
    """How much the system's counter ``name`` grew over the window, from
    the running totals the system drops on the bus's timeline with each
    increment: the last total inside the window less the last before it
    (none before it: the counter started in the window, unless the bus has
    overwritten older events)."""
    bus = _bus()
    if bus is None:
        return None
    lo, hi = record.window
    before, inside = None, None
    for ph, n, _cat, ts, _dur, _tid, args in bus.events():
        if ph != "C" or n != name:
            continue
        t = bus.perf_counter_s(ts)
        if t < lo:
            before = args["value"]
        elif t <= hi:
            inside = args["value"]
    if inside is None or (before is None and bus.dropped):
        return None
    return inside - (before or 0)
