"""Closed loop of fresh road networks through the system's public solve.

Set-up makes a pool of connected road networks (``ghs_bench/roads.py``) on
the device from the seed, at the configuration's lattice, logs each one's
vertex and edge counts, component count and weight range, and copies it to
host memory; then it solves one network of the same generator at a
sixteenth of the size (the lattice cut by ``warm_divisor`` a side), which
takes the same route, to load and warm the system. The window, the traced
steps and the comparison after it are ``fresh_solve.py``'s: each pool
network in turn as a new ``Graph``, timed from the host arrays to forest
edge ids on the host through ``api.minimum_spanning_forest(graph,
backend="device")``; with ``--trace`` the route's steps
(``make_production_solver``, its solve, the harvest, the API's components
count) each inside a benchmark span, checked on the warm-up network
against the API's ids; after the window every forest against the plain
reference's, on the device.

The cell exists for the host-L2 route (``l2``), so every solve in the
window must take it: the ``solver.prep`` spans the system dropped on its
bus in the window name each prep's route, and any other route, or a solve
with no such span, raises, so the run gives no result.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ghs_bench import harness, program, reference, roads, stats
from ghs_bench.drivers.fresh_solve import _delta, _host_reading, _synchronize


def _make(config: dict, *, seed: int, stream: int, divisor: int, device, log):
    gen, pub = config["generator"], config["published"]
    n, u, v, w = roads.road_network(
        gen["rows"] // divisor, gen["cols"] // divisor, occupancy=gen["occupancy"],
        edges_per_vertex=pub["edges"] / pub["vertices"], seed=seed, stream=stream,
        device=device)
    parts = int(roads.components(n, u, v).unique().numel())
    m = int(u.numel())
    log(f"road network {stream}: {n} vertices, {m} edges, degree {2 * m / n:.4f}, "
        f"{parts} component(s), weights {int(w.min())}..{int(w.max())}")
    if parts != 1:
        raise RuntimeError(f"road network {stream} has {parts} components, not one")
    return n, u.cpu().numpy(), v.cpu().numpy(), w.cpu().numpy()


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import harvest
    from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
        make_production_solver,
    )

    config, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    spans = harness.Spans()

    t0 = time.perf_counter()
    pool = [_make(config, seed=ctx.seed, stream=i, divisor=1, device=device, log=ctx.log)
            for i in range(int(mix["pool"]))]
    ctx.log(f"pool of {len(pool)} road networks: {time.perf_counter() - t0:.3f} s")
    warm = _make(config, seed=ctx.seed, stream=len(pool), divisor=int(mix["warm_divisor"]),
                 device=device, log=ctx.log)
    _synchronize(torch, device)
    if cuda:
        torch.cuda.empty_cache()

    def api_solve(g):
        return api.minimum_spanning_forest(g, backend="device", device=device).edge_ids

    def stepped_solve(g):
        with spans.span("prep"):
            solver = make_production_solver(g, device=device)
            _synchronize(torch, device)
        with spans.span("device_loop"):
            mst, fragment, levels = solver()
            _synchronize(torch, device)
        with spans.span("harvest"):
            ids, frag, _ = harvest(g, mst, fragment, levels)
            del mst, fragment, solver
        with spans.span("components"):
            api.count_components(frag)
        return ids

    t0 = time.perf_counter()
    warm_ids = api_solve(Graph(*warm))
    if ctx.trace:
        stepped = stepped_solve(Graph(*warm))
        spans.items.clear()
        if not np.array_equal(stepped, warm_ids):
            raise RuntimeError("the traced steps return other ids than the API on the warm graph")
    ctx.log(f"warm-up solve at 1/{int(mix['warm_divisor']) ** 2} size: "
            f"{time.perf_counter() - t0:.3f} s")
    del warm, warm_ids
    gc.collect()
    gc.freeze()
    solve = stepped_solve if ctx.trace else api_solve

    trace = harness.DeviceTrace(device) if ctx.trace else None
    if trace is not None:
        trace.start()
        time.sleep(harness.PROFILER_PAD_S)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    solves = []
    start = time.perf_counter()
    close = start + ctx.seconds
    setup_s = start - ctx.t_start
    while time.perf_counter() < close and len(solves) < len(pool):
        n, u, v, w = pool[len(solves)]
        graph = Graph(n, u, v, w)
        host = _host_reading()
        t_call = time.perf_counter()
        ids = solve(graph)
        solves.append({"graph": len(solves), "edges": int(u.size), "ids": ids,
                       "call": t_call, "return": time.perf_counter(),
                       "host": _delta(host, _host_reading())})
        with spans.span("release"):
            del graph
    end = time.perf_counter()
    if end < close:
        ctx.log(f"the pool of {len(pool)} graphs ran out {close - end:.3f} s before the close")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    profile = None
    if trace is not None:
        time.sleep(harness.PROFILER_PAD_S)
        t_stop = time.perf_counter()
        trace.stop()
        t_stop = time.perf_counter() - t_stop
        profile = trace.summary(start, end, spans)
        ctx.log(f"device trace stopped in {t_stop:.3f} s, read in {profile.read_s:.3f} s, "
                f"anchored by the {trace.anchored_by}")
    record = harness.RunRecord(cell=ctx.cell, window=(start, end),
                               spans=spans, memory_peak_bytes=peak, profile=profile,
                               solves=solves)
    # Each solve's prep route, from the system's spans (None: it left none).
    routes = [a.get("route") for _, _, _, a in program.spans(record, "solver.prep")]
    routes += [None] * (len(solves) - len(routes))
    ctx.log(f"routes of the window's solves: {routes}")
    if any(r != "l2" for r in routes):
        raise RuntimeError(f"a solve left the host-L2 route this cell measures: {routes}")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mismatches = []
    for s in solves:
        n, *arrays = pool[s["graph"]]
        u, v, w = (torch.from_numpy(a).to(device) for a in arrays)
        want = reference.msf_ids(n, u, v, w, device=device)
        del u, v, w
        s["mismatch"] = reference.mismatch(s["ids"], torch.from_numpy(want).to(device))
        s["forest_edges"] = int(want.size)
        mismatches.append(s["mismatch"])
    ctx.log(f"reference over {len(solves)} forests: {time.perf_counter() - t0:.3f} s; "
            f"forest edges {[s['forest_edges'] for s in solves]}")
    for s in solves:
        ctx.log(f"solve {s['graph']}: {s['return'] - s['call']:.4f} s, host {s['host']}")

    wall = solves[-1]["return"] - solves[0]["call"] if solves else 0.0
    e2e = {"setup_s": setup_s,
           "solve_edges_per_s": stats.rate(sum(s["edges"] for s in solves), wall)}
    checks = {"forest_mismatch": (sum(mismatches), config["checks"]["forest_mismatch"])}
    return harness.Outcome(end_to_end=e2e, attempted=len(solves), failed=0,
                           checks=checks, record=record)
