"""Closed loop of Graph500 graphs with float weights through the system's
public solve, over a cycled pool.

Set-up first makes one graph at the mix's ``warm_scale`` and solves it, to
load and warm the system; that solve must take the device rank order over
float64 keys (its ``solver.prep.rank_order`` span on the system's bus says
``where="device"`` and ``key="float64"``), or the run raises, seconds into
set-up, and gives no result. Then it makes the pool: ``pool`` canonical
Kronecker graphs on the device from the seed, copied to host memory. A
graph's endpoints are ``graphs.kronecker``'s at the run's seed and the
graph's stream, the integer cell's graphs at the configuration's scale;
its weights are one float64 draw uniform in [0, 1) a distinct pair, from a
stream of their own.

The window hands the system pool graph ``i % pool`` on call ``i``, each
time as a new ``Graph`` over the pool's arrays. The system keeps its
caches on the ``Graph`` object, so a cycled graph costs what a fresh one
does; the log gives each graph's first solve apart from its later ones.
Each call is timed as ``fresh_solve.py`` times it, from the host arrays to
forest edge ids on the host through ``api.minimum_spanning_forest(graph,
backend="device")``; with ``--trace`` the route's steps
(``make_production_solver``, its solve, the harvest, the API's components
count) each run inside a benchmark span, checked on the warm-up graph
against the API's ids. Every solve of the window must leave the same
``solver.prep.rank_order`` span as the warm-up's, or the run raises.

After the window the plain reference (``reference_float.py``) computes each
pool graph's forest once, on the device, and every solve of that graph is
compared with it, id for id (``forest_mismatch``). The forest hides most
faults of the order: it changes only where a forest edge and the heaviest
edge of a cycle through it swap places. So the system's rank order is held
to the reference's too (``order_mismatch``): for each pool graph the window
solved, the prep every solve starts with (``make_production_solver``, the
API's first step) runs once more on a new ``Graph`` of it, and the order
it holds on the graph for the harvest (``boruvka.held_rank_order``) is
compared with the reference's stable sort, rank for rank.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ghs_bench import graphs, harness, program, reference, reference_float, stats
from ghs_bench.drivers.fresh_solve import _delta, _host_reading, _synchronize

#: The weights' stream, after the run's seed and the graph's stream; the
#: endpoints draw from ``(seed, stream)`` alone.
WEIGHT_STREAM = 1
#: The span every solve must leave: the rank order on the device, over
#: float64 keys.
ROUTE = {"where": "device", "key": "float64"}


def float_kronecker(config: dict, *, seed: int, stream: int, scale: int, device):
    """One canonical graph of the configuration at ``scale`` on ``device``:
    ``(num_nodes, u, v, w, generated)``, ``u`` and ``v`` the int64
    endpoints of ``graphs.kronecker`` at ``seed`` and ``stream``, ``w`` one
    float64 uniform in [0, 1) a row, and ``generated`` the edges generated
    before loops and repeats were dropped."""
    import torch

    gen = config["generator"]
    n, u, v, _ = graphs.kronecker(
        scale, gen["edge_factor"], a=gen["a"], b=gen["b"], c=gen["c"],
        weight_low=1, weight_high=(1 << graphs.WEIGHT_BITS) - 1,
        seed=seed, stream=stream, device=device)
    weights = torch.Generator(device=device)
    weights.manual_seed(graphs.torch_seed(seed, stream, WEIGHT_STREAM))
    w = torch.rand(u.numel(), dtype=torch.float64, generator=weights, device=device)
    return n, u, v, w, gen["edge_factor"] << scale


def _make(config: dict, *, seed: int, stream: int, scale: int, device, log):
    n, u, v, w, generated = float_kronecker(config, seed=seed, stream=stream, scale=scale,
                                            device=device)
    m = int(u.numel())
    log(f"graph {stream} at scale {scale}: {n} vertices, {generated} edges generated, {m} kept "
        f"({100.0 * (generated - m) / generated:.3f}% loops or repeats), weights "
        f"{float(w.min())!r}..{float(w.max())!r}")
    return n, u.cpu().numpy(), v.cpu().numpy(), w.cpu().numpy()


def float_checks(config: dict, forest_mismatch: int, order_mismatch: int) -> dict:
    """The checks that decide ``correct``, ``{name: (value, limit)}``: the
    harness calls a run correct where each value is at most its limit.
    ``float_control.py`` judges the control by the same checks."""
    limits = config["checks"]
    return {"forest_mismatch": (forest_mismatch, limits["forest_mismatch"]),
            "order_mismatch": (order_mismatch, limits["order_mismatch"])}


def order_mismatch(order, want) -> int:
    """Ranks whose edge differs between two rank orders of one graph (an
    order of another length differs at every rank of the longer)."""
    if order.numel() != want.numel():
        return max(order.numel(), want.numel())
    return int((order.to(want.dtype) != want).sum())


def _route_args(since: int):
    """The arguments of the ``solver.prep.rank_order`` spans the system's bus
    recorded since its mark ``since``."""
    bus = program._bus()
    if bus is None:
        return []
    return [rec[6] or {} for rec in bus.events_since(since)
            if rec[0] == "X" and rec[1] == "solver.prep.rank_order"]


def _check_route(found, solves: int, what: str) -> None:
    """Raise unless each of ``solves`` solves left one span on ``ROUTE``."""
    routes = [{k: a.get(k) for k in ROUTE} for a in found]
    if len(routes) != solves or any(r != ROUTE for r in routes):
        raise RuntimeError(
            f"{what} did not take the device rank order over float64 keys this cell "
            f"measures: solver.prep.rank_order spans {routes} for {solves} solve(s)")


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import (
        harvest,
        held_rank_order,
    )
    from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
        make_production_solver,
    )

    config, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    scale, size = int(config["generator"]["scale"]), int(mix["pool"])
    spans = harness.Spans()

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
    warm = _make(config, seed=ctx.seed, stream=size, scale=int(mix["warm_scale"]),
                 device=device, log=ctx.log)
    bus = program._bus()
    mark = bus.mark() if bus is not None else 0
    warm_ids = api_solve(Graph(*warm))
    _check_route(_route_args(mark), 1, "the warm-up solve")
    if ctx.trace:
        stepped = stepped_solve(Graph(*warm))
        spans.items.clear()
        if not np.array_equal(stepped, warm_ids):
            raise RuntimeError("the traced steps return other ids than the API on the warm graph")
    ctx.log(f"warm-up solve at scale {mix['warm_scale']}: {time.perf_counter() - t0:.3f} s")
    del warm, warm_ids

    t0 = time.perf_counter()
    pool = [_make(config, seed=ctx.seed, stream=i, scale=scale, device=device, log=ctx.log)
            for i in range(size)]
    host_bytes = sum(a.nbytes for p in pool for a in p[1:])
    ctx.log(f"pool of {size} graphs at scale {scale}: {host_bytes} bytes of host memory "
            f"({host_bytes / 2**30:.2f} GiB), {time.perf_counter() - t0:.3f} s")
    _synchronize(torch, device)
    if cuda:
        torch.cuda.empty_cache()
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
    while time.perf_counter() < close:
        k = len(solves) % size
        n, u, v, w = pool[k]
        graph = Graph(n, u, v, w)
        host = _host_reading()
        t_call = time.perf_counter()
        ids = solve(graph)
        solves.append({"graph": k, "first": len(solves) < size, "edges": int(u.size),
                       "ids": ids, "call": t_call, "return": time.perf_counter(),
                       "host": _delta(host, _host_reading())})
        with spans.span("release"):
            del graph
    end = time.perf_counter()
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
    found = [a for _, _, _, a in program.spans(record, "solver.prep.rank_order")]
    ctx.log(f"rank orders of the window's solves: "
            f"{sorted({(a.get('key'), a.get('passes')) for a in found}, key=str)}; "
            f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    _check_route(found, len(solves), "a solve of the window")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def system_order(k):
        graph = Graph(*pool[k])
        solver = make_production_solver(graph, device=device)
        order = held_rank_order(graph)
        del solver, graph
        return order

    t0 = time.perf_counter()
    mismatches, orders = [], {}
    for k in sorted({s["graph"] for s in solves}):
        order = system_order(k)
        n, *arrays = pool[k]
        u, v, w = (torch.from_numpy(a).to(device) for a in arrays)
        orders[k] = (order_mismatch(order, reference_float.rank_order(w, device=device))
                     if order is not None else int(u.numel()))
        del order
        want = reference_float.msf_ids(n, u, v, w, device=device)
        del u, v, w
        want_dev = None
        for s in (s for s in solves if s["graph"] == k):
            if np.array_equal(s["ids"], want):
                s["mismatch"] = 0
            else:
                if want_dev is None:
                    want_dev = torch.from_numpy(want).to(device)
                s["mismatch"] = reference.mismatch(s["ids"], want_dev)
            s["forest_edges"] = int(want.size)
            mismatches.append(s["mismatch"])
        del want_dev
    first = [round(s["return"] - s["call"], 4) for s in solves if s["first"]]
    later = [round(s["return"] - s["call"], 4) for s in solves if not s["first"]]
    ctx.log(f"reference over {len(orders)} pool graphs and {len(solves)} forests: "
            f"{time.perf_counter() - t0:.3f} s; forest edges "
            f"{sorted({(s['graph'], s['forest_edges']) for s in solves})}; ranks whose edge "
            f"differs from the reference's order {sorted(orders.items())}")
    ctx.log(f"first solve of each graph (s): {first}; later solves (s): {later}")
    for s in solves:
        ctx.log(f"solve of graph {s['graph']}: {s['return'] - s['call']:.4f} s, "
                f"host {s['host']}, mismatch {s['mismatch']}")

    wall = solves[-1]["return"] - solves[0]["call"] if solves else 0.0
    e2e = {"setup_s": setup_s,
           "solve_edges_per_s": stats.rate(sum(s["edges"] for s in solves), wall)}
    checks = float_checks(config, sum(mismatches), sum(orders.values()))
    return harness.Outcome(end_to_end=e2e, attempted=len(solves), failed=0,
                           checks=checks, record=record)
