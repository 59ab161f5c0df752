"""Closed loop of fresh large graphs through the system's public solve.

Set-up makes a pool of canonical Kronecker graphs on the device from the
seed (the configuration's generator and sizes) and copies each to host
memory, then solves one smaller graph of the same route to load and warm
the system. The window hands the system one pool graph after another, each
as a new ``Graph`` object over the pool's arrays, so nothing the system
keeps per graph carries over, and times
``api.minimum_spanning_forest(graph, backend="device")`` from the host
arrays to forest edge ids on the host. A solve that starts inside the
window runs to its end; none starts after the close, or once the pool is
spent (the mix sizes the pool to outlast the window).

With ``--trace`` the window drives the same steps that the route takes
(``make_production_solver``, its solve, the harvest, the components count
of the API), each inside a benchmark span, under the device trace; set-up
checks on the warm-up graph that these steps return the API's ids.

After the window every forest is compared, id for id, with the plain
reference's, computed on the device from the same arrays.
"""

from __future__ import annotations

import gc
import resource
import time

import numpy as np

from ghs_bench import graphs, harness, reference, stats


def _make(config: dict, *, seed: int, stream: int, scale: int, device):
    gen = config["generator"]
    n, u, v, w = graphs.kronecker(
        scale, gen["edge_factor"], a=gen["a"], b=gen["b"], c=gen["c"],
        weight_low=config["weights"][0], weight_high=config["weights"][1],
        seed=seed, stream=stream, device=device)
    return n, u.cpu().numpy(), v.cpu().numpy(), w.cpu().numpy()


def _host_reading() -> dict:
    """This process's CPU seconds up to now (user and system, every
    thread) and the system part, for the log beside each solve: a solve
    whose wall time grows with its CPU time ran slower, it did not wait."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime}


def _delta(a: dict, b: dict) -> dict:
    return {k: round(b[k] - a[k], 3) for k in b}


def _synchronize(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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
    scale = int(config["generator"]["scale"])
    spans = harness.Spans()

    t0 = time.perf_counter()
    pool = [_make(config, seed=ctx.seed, stream=i, scale=scale, device=device)
            for i in range(int(mix["pool"]))]
    ctx.log(f"pool of {len(pool)} graphs at scale {scale}: "
            f"{[p[1].size for p in pool]} edges, {time.perf_counter() - t0:.3f} s")
    warm = _make(config, seed=ctx.seed, stream=len(pool), scale=int(mix["warm_scale"]),
                 device=device)
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
            np.unique(frag).size
        return ids

    t0 = time.perf_counter()
    warm_ids = api_solve(Graph(*warm))
    if ctx.trace:
        stepped = stepped_solve(Graph(*warm))
        spans.items.clear()
        if not np.array_equal(stepped, warm_ids):
            raise RuntimeError("the traced steps return other ids than the API on the warm graph")
    ctx.log(f"warm-up solve at scale {mix['warm_scale']}: {time.perf_counter() - t0:.3f} s")
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
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mismatches, split = [], [0.0, 0.0, 0.0]
    for s in solves:
        t1 = time.perf_counter()
        n, *arrays = pool[s["graph"]]
        u, v, w = (torch.from_numpy(a).to(device) for a in arrays)
        _synchronize(torch, device)
        t2 = time.perf_counter()
        want = reference.msf_ids(n, u, v, w, device=device)
        del u, v, w
        t3 = time.perf_counter()
        s["mismatch"] = reference.mismatch(s["ids"], torch.from_numpy(want).to(device))
        s["forest_edges"] = int(want.size)
        mismatches.append(s["mismatch"])
        for k, dt in enumerate((t2 - t1, t3 - t2, time.perf_counter() - t3)):
            split[k] += dt
    ctx.log(f"reference over {len(solves)} forests: {time.perf_counter() - t0:.3f} s "
            f"(copies {split[0]:.3f}, forests {split[1]:.3f}, comparisons {split[2]:.3f}); "
            f"solve seconds {[round(s['return'] - s['call'], 4) for s in solves]}")
    for s in solves:
        ctx.log(f"solve {s['graph']}: {s['return'] - s['call']:.4f} s, host {s['host']}")

    wall = solves[-1]["return"] - solves[0]["call"] if solves else 0.0
    e2e = {"setup_s": setup_s,
           "solve_edges_per_s": stats.rate(sum(s["edges"] for s in solves), wall)}
    record = harness.RunRecord(cell=ctx.cell, window=(start, end),
                               spans=spans, memory_peak_bytes=peak, profile=profile,
                               solves=solves)
    limits = config["checks"]
    checks = {"forest_mismatch": (sum(mismatches), limits["forest_mismatch"])}
    return harness.Outcome(end_to_end=e2e, attempted=len(solves), failed=0,
                           checks=checks, record=record)
