"""Where one solve's time goes on the card.

    python3 -m distributed_ghs_implementation_tpu_torch.profile_solve \
        [--strategy fused|stepped|ell|rank]
        [--graph rmat|road-grid|rmat20|rmat21|rmat23|rmat24|road-usa]

Solves a graph once to warm up (``--graph rmat``: RMAT-18, edge factor 16,
seed 1, the default; ``road-grid``: ``road_grid_graph(2048, 2048,
seed=1)``; ``rmat20``: RMAT-20 ef 16 seed 24, ``rmat21``: RMAT-21 ef 16
seed 1, ``rmat23``: RMAT-23 ef 16 seed 24 (the shape of the benchmark's
``rmat24-fresh`` graphs) and ``rmat24``: RMAT-24 ef 16 seed 24, the dense
graphs of the filter route; ``road-usa``: ``random_road_network(5100,
5100, seed=1, weight_scale=4000)``, about the DIMACS USA road network's
23.9M vertices, 29M edges and lengths up to about 11,000 (the shape of
``usa-road-fresh``), on the host-L2 route; these for ``--strategy
rank``),
then once more split into its phases, timed on the host clock
around ``torch.cuda.synchronize()``, then once more under
``torch.profiler``: the device's busy time is the union of its kernel and
copy intervals, its idle share is the rest of the solve's wall time, and
each kernel name's device time, launch count and longest launch are
listed. Prints one JSON line, with the card's name and power limit.

The phases of the flat and ELL strategies: the host arrays
(``rank_arrays``, or ``ell_buckets`` for ``ell``), host-to-device copy,
level loop, harvest of the edge ids. Those of ``rank`` are read off the
solver's own spans on the event bus as the route ``solve_graph`` takes
runs, cold (the graph's rank orders dropped first): ``first_ranks`` (K6
on the card over the rank endpoints), the rest of the prep (``stage_s``:
the rank order, ``rank_order_s``, on the card; the endpoint gather; level 1 on the card, ``host_levels_s``;
split into the rank endpoints, level 1 (``level1_s``), filling the pinned
buffers, issuing the copies and waiting for them), the head (level 2 over
every rank, or over the filter route's prefix; after a misprediction, the
rejected speculation and the head that answered), each finish chunk, and on the filter route the
prefix finish, the suffix filter and the survivors' finish, then the
harvest. Each of these phases ends on a host read of its counts, except
in the speculative filter program (route ``filtered-speculative``), which
reads its head's and its filter's counts once, at its end: on the card
their work is only queued when their spans close, so there ``head_s`` and
``filter_s`` are null, and ``prefix_finish_s`` and ``survivor_finish_s``
hold the head's and the filter's device work. The profiled solve is a
warm one, from the arrays the graph keeps staged.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.generators import (
    random_road_network,
    rmat_graph,
    road_grid_graph,
)
from distributed_ghs_implementation_tpu_torch.models import boruvka
from distributed_ghs_implementation_tpu_torch.models import rank_solver as rs
from distributed_ghs_implementation_tpu_torch.obs.events import BUS


SCALE, EDGE_FACTOR, SEED = 18, 16, 1
GRAPHS = {
    "rmat": (f"rmat-{SCALE} ef {EDGE_FACTOR} seed {SEED}",
             lambda: rmat_graph(SCALE, EDGE_FACTOR, seed=SEED)),
    "road-grid": ("road_grid_graph(2048, 2048, seed=1)",
                  lambda: road_grid_graph(2048, 2048, seed=1)),
    "rmat20": ("rmat-20 ef 16 seed 24", lambda: rmat_graph(20, 16, seed=24)),
    "rmat21": ("rmat-21 ef 16 seed 1", lambda: rmat_graph(21, 16, seed=1)),
    "rmat24": ("rmat-24 ef 16 seed 24", lambda: rmat_graph(24, 16, seed=24)),
    "rmat23": ("rmat-23 ef 16 seed 24", lambda: rmat_graph(23, 16, seed=24)),
    "road-usa": ("random_road_network(5100, 5100, seed=1, weight_scale=4000)",
                 lambda: random_road_network(5100, 5100, seed=1, weight_scale=4000)),
}
#: The graphs of the rank route alone.
RANK_GRAPHS = ("rmat20", "rmat21", "rmat23", "rmat24", "road-usa")


def _drop_cached_buckets(graph) -> None:
    """Forget ``graph.ell_buckets`` (a cached property), so that the next
    ELL solve builds them as a solve of a new graph would; the rank order
    stays cached, as it does for the flat strategies."""
    graph.__dict__.pop("ell_buckets", None)


#: The steps a finish chunk's ``solver.rank.finish`` span names: the step
#: that ran its levels (a chunk with a census ends in ``_shrink_and_run``
#: or ``_levels_loop``).
_RANK_CHUNKS = ("_finish_chunk", "_shrink_and_run", "_levels_loop")


def _rank_phases(graph, device) -> dict:
    """The rank route as ``solve_graph`` runs it (``make_production_solver``,
    its ``solve``, the harvest), with its phases read off the solver's own
    spans on the event bus (on for the call): the prep's ``solver.prep.*``
    steps, the solve's ``route`` and its head, finish chunks and filter,
    each of which ends on a host read of its counts but on the card's
    ``filtered-speculative`` route (see the module's docstring). The
    graph's rank order and staged arrays are dropped first, so the prep
    runs as in a cold solve."""
    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    for key in ("_rank_order", "_device_rank_order", "_rank_stage_cache"):
        graph.__dict__.pop(key, None)
    enabled = BUS.enabled
    BUS.enable()
    mark = BUS.mark()
    try:
        t0 = clock()
        solve = rs.make_production_solver(graph, device=device)
        t2 = clock()
        mst, _, levels = solve()
        t3 = clock()
        boruvka.fetch_mst_edge_ids(graph, mst)
        t4 = clock()
    finally:
        BUS.enabled = enabled
    spans = [(name, BUS.perf_counter_s(ts), BUS.perf_counter_s(ts + dur), args or {})
             for ph, name, _cat, ts, dur, _tid, args in BUS.events_since(mark)
             if ph == "X"]

    def took(name, key=None):
        return sum(a.get(key, 0.0) if key else end - start
                   for n, start, end, a in spans if n == name)

    # The last head is the one whose result stands (a misprediction runs
    # another head): what runs before it is the head phase, the spans after
    # it the finish; on the filter route the filter splits the finish into
    # the prefix's, the filter and the survivors'.
    head_end = max(end for name, _, end, _ in spans if name == "solver.rank.head")
    after = [sp for sp in spans if sp[1] >= head_end]
    solve_args = next(a for name, _, _, a in spans if name == "solver.rank.solve")
    first_ranks = took("solver.prep.first_ranks")
    stage = took("solver.prep.stage")
    pinned = took("solver.prep.stage", "pin_s")
    out = {"levels": levels, "route": solve_args["route"], "family": solve_args["family"],
           "first_ranks_s": first_ranks, "stage_s": t2 - t0 - first_ranks,
           "rank_order_s": took("solver.prep.rank_order"),
           "host_levels_s": took("solver.prep.level1"),
           "stage_split": {
               "rank_endpoints_s": took("solver.prep.endpoints"),
               "level1_s": took("solver.prep.level1"),
               "pin_memory_s": pinned, "copy_issue_s": stage - pinned,
               "copy_wait_s": took("solver.prep.copy_wait")},
           "head_s": head_end - t2, "finish_s": t3 - head_end,
           "finish_chunks": [{"step": a["step"], "s": end - start}
                             for name, start, end, a in after if name == "solver.rank.finish"],
           "harvest_s": t4 - t3, "total_s": t4 - t0}
    filters = [(start, end, a["steps"]) for name, start, end, a in after
               if name == "solver.rank.filter"]
    if filters:
        out["prefix_finish_s"] = filters[0][0] - head_end
        out["filter_s"] = sum(end - start for start, end, _ in filters)
        out["filter_steps"] = [step for _, _, steps in filters for step in steps]
        out["survivor_finish_s"] = (out["finish_s"] - out["prefix_finish_s"]
                                    - out["filter_s"])
    if device.type == "cuda" and out["route"] == "filtered-speculative":
        # No host read ends the head or the filter: each one's device work
        # is waited for by the first read of the finish after it.
        filter_start = filters[0][0]
        out.update(head_s=None, filter_s=None, finish_s=t3 - t2,
                   prefix_finish_s=filter_start - t2, survivor_finish_s=t3 - filter_start)
    return out


def _phases(graph, strategy: str, device) -> dict:
    if strategy == "rank":
        return _rank_phases(graph, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    _drop_cached_buckets(graph)
    t0 = time.perf_counter()
    if strategy == "ell":
        host = boruvka.host_ell_arrays(graph)
    else:
        host = boruvka.host_arrays(graph)
    t1 = time.perf_counter()
    if strategy == "ell":
        buckets, ra, rb = boruvka.ell_arrays_from_numpy(*host[:3], device=device)
    else:
        args = boruvka.arrays_from_numpy(*host, device=device)
    sync()
    t2 = time.perf_counter()
    if strategy == "ell":
        mst, _, levels = boruvka.ell_solve_loop(buckets, ra, rb, num_nodes=host[3])
    elif strategy == "stepped":
        mst, _, levels = boruvka.solve_arrays_stepped(*args)
    else:
        mst, _, levels = boruvka._solve_from_iota(*args[1:], num_nodes=args[0].shape[0])
    sync()
    t3 = time.perf_counter()
    boruvka.fetch_mst_edge_ids(graph, mst)
    t4 = time.perf_counter()
    host_key = "host_ell_buckets_s" if strategy == "ell" else "host_rank_arrays_s"
    return {"levels": levels, host_key: t1 - t0, "h2d_s": t2 - t1,
            "level_loop_s": t3 - t2, "harvest_s": t4 - t3, "total_s": t4 - t0}


def _device_busy(prof) -> tuple[float, dict]:
    """Union of the device intervals (s), and the time (s), launches and
    longest launch (s) of each kernel name."""
    spans, by_name = [], defaultdict(list)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            start, end = evt.time_range.start, evt.time_range.end
            spans.append((start, end))
            by_name[evt.name[:80]].append((end - start) * 1e-6)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    return busy * 1e-6, {name: {"s": sum(ts), "launches": len(ts), "max_s": max(ts)}
                         for name, ts in ranked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", choices=("fused", "stepped", "ell", "rank"), default="fused")
    ap.add_argument("--graph", choices=tuple(GRAPHS), default="rmat")
    args = ap.parse_args(argv)
    if args.graph in RANK_GRAPHS and args.strategy != "rank":
        ap.error(f"--graph {args.graph} is for --strategy rank")
    device = resolve_device(None)
    card = card_description()
    label, make = GRAPHS[args.graph]
    graph = make()
    boruvka.solve_graph(graph, strategy=args.strategy, device=device)  # warm-up
    phases = _phases(graph, args.strategy, device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _drop_cached_buckets(graph)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        boruvka.solve_graph(graph, strategy=args.strategy, device=device)
        wall = time.perf_counter() - t0
    busy, top = _device_busy(prof)
    print(json.dumps({
        "card": card,
        "graph": label,
        "nodes": graph.num_nodes, "edges": graph.num_edges, "strategy": args.strategy,
        "phases": phases,
        "profiled_wall_s": wall,
        "device_busy_s": busy if top else None,
        "device_idle_share": 1.0 - busy / wall if top else None,
        "device_time_by_name": top,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
