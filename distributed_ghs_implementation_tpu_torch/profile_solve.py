"""Where one solve's time goes on the card.

    python3 -m distributed_ghs_implementation_tpu_torch.profile_solve \
        [--strategy fused|stepped|ell|rank] [--graph rmat|road-grid|rmat20|rmat21|rmat24]
    python3 -m distributed_ghs_implementation_tpu_torch.profile_solve \
        --staging [--graph ...]

Solves a graph once to warm up (``--graph rmat``: RMAT-18, edge factor 16,
seed 1, the default; ``road-grid``: ``road_grid_graph(2048, 2048,
seed=1)``; ``rmat20``: RMAT-20 ef 16 seed 24, ``rmat21``: RMAT-21 ef 16
seed 1 and ``rmat24``: RMAT-24 ef 16 seed 24 (the benchmark's default
graph), the dense graphs of the filter route, for ``--strategy rank``),
then once more split into its phases, timed on the host clock
around ``torch.cuda.synchronize()``, then once more under
``torch.profiler``: the device's busy time is the union of its kernel and
copy intervals, its idle share is the rest of the solve's wall time, and
each kernel name's device time, launch count and longest launch are
listed. Prints one JSON line, with the card's name and power limit.

The phases of the flat and ELL strategies: the host arrays
(``rank_arrays``, or ``ell_buckets`` for ``ell``), host-to-device copy,
level loop, harvest of the edge ids. Those of ``rank`` are read off the
route ``solve_graph`` takes, as it runs: ``first_ranks`` (taken first,
alone), the staging (the level-1 and, on the host-L2 and filter routes,
level-2 host passes under the copies, as in a solve; split into the rank
endpoints, the host passes, ``pin_memory()``, issuing the copies and
waiting for them), the head (levels 1-2, the level-3 entry of the host-L2
route, or the filter route's prefix head; after a misprediction, the
rejected speculation and the head that answered), each finish chunk, and
on the filter route the prefix finish, the suffix filter and the
survivors' finish, then the harvest. The profiled solve is a warm one, from
the arrays the graph keeps staged.

``--staging`` times the rank solver's prep head (``_prep_head``) with each
way of staging the rank endpoints, in turns (A B, then B A,
``STAGING_TURNS`` times each): the int32 copies (``int32``: the endpoints from the native
gather, two pinned int32 copies) and the 24-bit wire (``wire24``: the
native pass that also packs the three low bytes of each endpoint, one
pinned uint8 copy, the decode on the card). A turn reports the staging's
host seconds (up to the copies being issued), the host passes under the
copies, the wait for the copies, and the whole prep; the JSON line has each
way's turns, medians and spreads, and whether the two staged pairs are
equal.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from collections import defaultdict

import torch

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph, road_grid_graph
from distributed_ghs_implementation_tpu_torch.models import boruvka
from distributed_ghs_implementation_tpu_torch.models import rank_solver as rs


SCALE, EDGE_FACTOR, SEED = 18, 16, 1
GRAPHS = {
    "rmat": (f"rmat-{SCALE} ef {EDGE_FACTOR} seed {SEED}",
             lambda: rmat_graph(SCALE, EDGE_FACTOR, seed=SEED)),
    "road-grid": ("road_grid_graph(2048, 2048, seed=1)",
                  lambda: road_grid_graph(2048, 2048, seed=1)),
    "rmat20": ("rmat-20 ef 16 seed 24", lambda: rmat_graph(20, 16, seed=24)),
    "rmat21": ("rmat-21 ef 16 seed 1", lambda: rmat_graph(21, 16, seed=1)),
    "rmat24": ("rmat-24 ef 16 seed 24", lambda: rmat_graph(24, 16, seed=24)),
}


def _drop_cached_buckets(graph) -> None:
    """Forget ``graph.ell_buckets`` (a cached property), so that the next
    ELL solve builds them as a solve of a new graph would; the rank order
    stays cached, as it does for the flat strategies."""
    graph.__dict__.pop("ell_buckets", None)


# The rank solver's steps that end a phase: a head, a finish chunk (a chunk
# with a census ends in ``_shrink_and_run`` or ``_levels_loop``), a step of
# the filter; the host passes and the staging's own steps, timed without a
# sync (they run under the copies); the solves that decide the route.
_RANK_HEADS = ("_rank_head", "_head_l2", "_filtered_head", "_filtered_head_l2")
_RANK_CHUNKS = ("_finish_chunk", "_shrink_and_run", "_levels_loop")
_RANK_FILTERS = ("_filter_suffix_fused", "_filter_suffix_ends", "_filter_compact",
                 "_filter_suffix_chunked")
_RANK_HOST = ("host_level1", "host_level2")
_RANK_STAGING = ("_pinned", "_stage", "_sync")
_RANK_ROUTES = ("solve_rank_speculative", "solve_rank_filtered_speculative",
                "solve_rank_filtered")


def rank_route(family: str, calls) -> str:
    """The route that answered a rank solve, from its family and the calls
    ``(name, answered)`` of ``_RANK_ROUTES`` it made, in order."""
    names = [name for name, _ in calls]
    if rs.use_l2_path(family):
        return "host-l2"
    if "solve_rank_filtered_speculative" in names:
        return "filtered-speculative" if calls[-1] == (
            "solve_rank_filtered_speculative", True) else "filtered after a misprediction"
    if "solve_rank_filtered" in names:
        return "filtered"
    if names == ["solve_rank_speculative"] and calls[0][1]:
        return "speculative"
    return "staged after a misprediction" if names else "staged"


@contextlib.contextmanager
def _observed(owner, names, record):
    """Wrap the functions ``names`` of ``owner`` (a module, or an object
    such as a frozen ``Graph``, whose own dictionary takes the wrappers)
    for the block: each call runs as before, then ``record(name, start,
    out)`` sees it."""
    saved = {name: getattr(owner, name) for name in names}
    own = vars(owner)
    had = {name for name in names if name in own}

    def spy(name, fn):
        def call(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            record(name, start, out)
            return out
        return call

    for name, fn in saved.items():
        own[name] = spy(name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            if name in had:
                own[name] = fn
            else:
                del own[name]


def _rank_phases(graph, device) -> dict:
    """The rank route as ``solve_graph`` runs it (``make_production_solver``,
    its ``solve``, the harvest), with its phases read off the solver's own
    steps, so the route is the solver's: the head, every finish chunk and
    every filter step end on a host read of their counts, where the clock
    stops. The graph's staged arrays are dropped first, so the prep runs as
    in a cold solve; ``first_ranks`` is taken before it, out of the copies'
    overlap."""
    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    host, marks, routes = [], [], []

    def record(name, start, out):
        if name in _RANK_HOST + _RANK_STAGING + ("rank_endpoints",):
            host.append((name, time.perf_counter() - start))
        elif name in _RANK_ROUTES:
            routes.append((name, out is not None))
        else:
            end = clock()
            while marks and marks[-1][1] >= start:  # ran inside this step
                marks.pop()
            marks.append((name, end))

    for key in ("first_ranks", "_rank_stage_cache"):
        graph.__dict__.pop(key, None)
    family = rs._pick_family(graph)
    names = _RANK_HOST + _RANK_STAGING + _RANK_HEADS + _RANK_CHUNKS + _RANK_FILTERS + _RANK_ROUTES
    with _observed(rs, names, record):
        t0 = clock()
        graph.first_ranks  # noqa: B018 -- the cached pass, timed alone
        t1 = clock()
        with _observed(graph, ("rank_endpoints",), record):
            solve = rs.make_production_solver(graph, device=device)
        t2 = clock()
        mst, _, levels = solve()
        t3 = clock()
        boruvka.fetch_mst_edge_ids(graph, mst)
        t4 = clock()

    def took(*steps):
        return sum(s for name, s in host if name in steps)

    # The last head is the one whose result stands (a misprediction runs
    # another head): what runs before it is the head phase, the steps after
    # it the finish; on the filter route the filter steps split the finish
    # into the prefix's, the filter and the survivors'.
    head = max(i for i, (name, _) in enumerate(marks) if name in _RANK_HEADS)
    steps = [{"step": name, "s": t - prev} for (name, t), (_, prev) in
             zip(marks[head + 1:], marks[head:])]
    out = {"levels": levels, "route": rank_route(family, routes), "family": family,
           "first_ranks_s": t1 - t0, "stage_s": t2 - t1,
           "host_levels_s": took(*_RANK_HOST),
           "stage_split": {
               "rank_endpoints_s": took("rank_endpoints"),
               "host_level1_s": took("host_level1"), "host_level2_s": took("host_level2"),
               "pin_memory_s": took("_pinned"),
               "copy_issue_s": took("_stage") - took("_pinned"),
               "copy_wait_s": took("_sync")},
           "head_s": marks[head][1] - t2, "finish_s": t3 - marks[head][1],
           "finish_chunks": [c for c in steps if c["step"] in _RANK_CHUNKS],
           "harvest_s": t4 - t3, "total_s": t4 - t0}
    filters = [i for i, c in enumerate(steps) if c["step"] in _RANK_FILTERS]
    if filters:
        out["prefix_finish_s"] = sum(c["s"] for c in steps[:filters[0]])
        out["filter_s"] = sum(c["s"] for c in steps[filters[0]:filters[-1] + 1])
        out["filter_steps"] = [steps[i]["step"] for i in filters]
        out["survivor_finish_s"] = (out["finish_s"] - out["prefix_finish_s"]
                                    - out["filter_s"])
    return out


STAGINGS = {"int32": rs._stage_endpoints_int32, "wire24": rs._stage_endpoints_wire24}
STAGING_TURNS = 5


def _staging_turn(graph, device, how: str) -> tuple[dict, tuple]:
    """One prep head (``_prep_head``) with the endpoints staged ``how``,
    from a graph that keeps only its rank order: ``(times, (sa, sb))``."""
    graph.__dict__.pop("first_ranks", None)
    spans = {}

    def stage(*args):
        t = time.perf_counter()
        out = STAGINGS[how](*args)
        spans["host_s"] = time.perf_counter() - t
        return out

    saved = rs._stage_endpoints
    rs._stage_endpoints = stage
    try:
        rs._sync(device)
        t0 = time.perf_counter()
        head = rs._prep_head(graph, device)
        t1 = time.perf_counter()
        rs._sync(device)
        t2 = time.perf_counter()
    finally:
        rs._stage_endpoints = saved
    return ({"host_s": spans["host_s"], "under_copies_s": t1 - t0 - spans["host_s"],
             "copy_wait_s": t2 - t1, "prep_s": t2 - t0}, head[-2:])


def _summary(values) -> dict:
    values = sorted(values)
    return {"median": statistics.median(values), "min": values[0], "max": values[-1],
            "spread": values[-1] - values[0]}


def staging_turns(graph, device, turns: int) -> dict:
    """Both stagings in turns; ``int32`` first in even turns, ``wire24``
    first in odd ones."""
    graph._rank_order  # noqa: B018 -- the shared rank order, outside the turns
    runs = {how: [] for how in STAGINGS}
    staged = {}
    for i in range(turns):
        for how in (("int32", "wire24") if i % 2 == 0 else ("wire24", "int32")):
            times, pair = _staging_turn(graph, device, how)
            runs[how].append(times)
            staged[how] = pair
    equal = all(torch.equal(a, b) for a, b in zip(staged["int32"], staged["wire24"]))
    return {"turns": turns, "equal": equal,
            "chosen": next(h for h, fn in STAGINGS.items() if fn is rs._stage_endpoints),
            **{how: {"turns": r, **{k: _summary([t[k] for t in r]) for k in r[0]}}
               for how, r in runs.items()}}


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
    ap.add_argument("--staging", action="store_true",
                    help="time the rank endpoints' two stagings in turns instead")
    args = ap.parse_args(argv)
    if args.graph in ("rmat20", "rmat21", "rmat24") and args.strategy != "rank" and not (
            args.staging):
        ap.error(f"--graph {args.graph} is for --strategy rank")
    device = resolve_device(None)
    card = card_description()
    label, make = GRAPHS[args.graph]
    graph = make()
    if args.staging:
        print(json.dumps({"card": card, "graph": label, "nodes": graph.num_nodes,
                          "edges": graph.num_edges,
                          "staging": staging_turns(graph, device, STAGING_TURNS)}))
        return 0
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
