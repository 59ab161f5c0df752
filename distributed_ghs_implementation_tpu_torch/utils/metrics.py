"""Per-level metrics as a view over the event bus.

Each instrumented level (or chunk, on the rank route) lands on the bus as a
``metrics.level`` span-event carrying the fragment census
(``fragments_before``/``fragments_after``, ``edges_alive``), and
:class:`SolveMetrics` / :class:`LevelMetrics` are read back from exactly
those events after the solve, as in the JAX package's ``utils/metrics.py``.

When the global bus is disabled (``GHS_OBS=0``) a private single-use bus
collects the same events, so the records are there all the same.

:func:`profiler_trace` wraps a solve in ``torch.profiler`` and writes a
Chrome trace of its host and device activity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import List

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.obs.events import BUS, EventBus
from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels


@dataclasses.dataclass
class LevelMetrics:
    level: int
    fragments_before: int
    fragments_after: int
    edges_alive_after: int
    wall_time_s: float


@dataclasses.dataclass
class SolveMetrics:
    num_nodes: int
    num_edges: int
    levels: List[LevelMetrics]
    total_wall_time_s: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _metrics_bus() -> EventBus:
    """The global bus when it is on; otherwise a private single-solve bus."""
    return BUS if BUS.enabled else EventBus(capacity=8192)


def _levels_from_bus(bus: EventBus, mark: int) -> List[LevelMetrics]:
    """The records, from the ``metrics.level`` events since ``mark``."""
    records = []
    for rec in bus.events_since(mark):
        if rec[0] != "X" or rec[1] != "metrics.level":
            continue
        args = rec[6] or {}
        records.append(
            LevelMetrics(
                level=args["level"],
                fragments_before=args["fragments_before"],
                fragments_after=args["fragments_after"],
                edges_alive_after=args["edges_alive"],
                wall_time_s=rec[4] / 1e9,
            )
        )
    return records


def _fragment_count(fragment, num_nodes: int) -> int:
    """Distinct fragments among the first ``num_nodes`` labels, counted where
    the labels are (on the card for a CUDA tensor), with no copy kept: the
    solve goes on updating the tensor after the hook returns."""
    if isinstance(fragment, torch.Tensor):
        return int(torch.unique(fragment[:num_nodes]).numel())
    return count_labels(np.asarray(fragment)[:num_nodes])


def _level_emitter(bus: EventBus, num_nodes: int):
    """The shared per-level hook body: census the fragment array and emit
    one ``metrics.level`` event. Returns ``emit(level, fragment,
    edges_alive, dt)``."""
    frags_before = [num_nodes]

    def emit(level: int, fragment, edges_alive: int, dt: float) -> None:
        frags_after = _fragment_count(fragment, num_nodes)
        bus.complete(
            "metrics.level",
            dt,
            cat="metrics",
            level=int(level),
            fragments_before=frags_before[0],
            fragments_after=frags_after,
            edges_alive=int(edges_alive),
        )
        frags_before[0] = frags_after

    return emit


def solve_graph_instrumented(
    graph, *, compact: bool = True, strategy: str = "stepped", device=None
) -> tuple:
    """Like ``models.boruvka.solve_graph`` on ``device`` (``None`` = CUDA),
    but returns ``(result_tuple, SolveMetrics)``.

    ``strategy="stepped"`` records one entry per level of the host-stepped
    solve; ``strategy="rank"`` runs the production routing and records one
    entry per chunk boundary (its hook's granularity), the practical choice
    at scale.
    """
    device = resolve_device(device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        empty = (np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0)
        return empty, SolveMetrics(n, graph.num_edges, [], 0.0)

    if strategy == "rank":
        return _solve_rank_instrumented(graph, device)
    if strategy != "stepped":
        raise ValueError(f"unknown strategy {strategy!r}; expected stepped|rank")

    from distributed_ghs_implementation_tpu_torch.models.boruvka import (
        harvest,
        prepare_device_arrays,
        solve_arrays_stepped,
    )

    bus = _metrics_bus()
    mark = bus.mark()
    args = prepare_device_arrays(graph, device=device)
    emit = _level_emitter(bus, n)

    def on_level(level, fragment, mst_ranks, has, count, dt):
        # The stepped solve counts surviving directed slots; each undirected
        # edge occupies two.
        emit(level, fragment, count // 2, dt)

    t_start = time.perf_counter()
    with bus.span("metrics.solve", cat="metrics", strategy="stepped", nodes=n):
        mst_ranks, fragment, levels = solve_arrays_stepped(
            *args, compact=compact, stepped_levels=None, on_level=on_level
        )
    total = time.perf_counter() - t_start
    return harvest(graph, mst_ranks, fragment, levels), SolveMetrics(
        n, graph.num_edges, _levels_from_bus(bus, mark), total
    )


def _solve_rank_instrumented(graph, device) -> tuple:
    """Rank-route instrumentation through its ``on_chunk`` hook (chunk
    granularity; the alive count there is of undirected slots already)."""
    from distributed_ghs_implementation_tpu_torch.models.boruvka import harvest
    from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
        make_production_solver,
    )

    n = graph.num_nodes
    bus = _metrics_bus()
    mark = bus.mark()
    emit = _level_emitter(bus, n)
    last = [time.perf_counter()]

    def on_chunk(level, fragment, mst_ranks, count):
        now = time.perf_counter()
        emit(level, fragment, count, now - last[0])
        last[0] = now

    # The production routing, as every rank solve takes it: the hook
    # selects the chunked forms (the speculative programs have no
    # boundaries to instrument).
    solve = make_production_solver(graph, device=device)
    with bus.span("metrics.solve", cat="metrics", strategy="rank", nodes=n):
        last[0] = time.perf_counter()
        t_start = last[0]
        mst_ranks, fragment, levels = solve(on_chunk=on_chunk)
        total = time.perf_counter() - t_start
    return harvest(graph, mst_ranks, fragment, levels), SolveMetrics(
        n, graph.num_edges, _levels_from_bus(bus, mark), total
    )


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Wrap a solve in ``torch.profiler`` (host activity, and the card's
    kernels and copies where CUDA is there) and write a Chrome trace
    (``chrome://tracing``, ui.perfetto.dev) into ``log_dir``:

    >>> with profiler_trace("traces") as path:
    ...     minimum_spanning_forest(graph)

    The block gets the trace's path, which is written when the block ends,
    by an exception too. This is the device-side view; the host-side
    structured trace is the event bus (``obs.export.write_chrome_trace``).
    """
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
