"""Where one solve's time goes on the card.

    python3 -m distributed_ghs_implementation_tpu_torch.profile_solve [--strategy fused|stepped|ell]

Solves RMAT-18 (edge factor 16, seed 1: the largest graph ``chip_smoke.py``
drives) once to warm up, then once more split into its phases (the host
arrays: ``rank_arrays`` for the flat strategies, ``ell_buckets`` for
``ell``; host-to-device copy; level loop; harvest of the edge ids), timed
on the host clock around ``torch.cuda.synchronize()``, then once more under
``torch.profiler``: the device's busy time is the union of its kernel and
copy intervals, its idle share is the rest of the solve's wall time, and
each kernel name's device time and launch count are listed. Prints one
JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph
from distributed_ghs_implementation_tpu_torch.models import boruvka


SCALE, EDGE_FACTOR, SEED = 18, 16, 1


def _drop_cached_buckets(graph) -> None:
    """Forget ``graph.ell_buckets`` (a cached property), so that the next
    ELL solve builds them as a solve of a new graph would; the rank order
    stays cached, as it does for the flat strategies."""
    graph.__dict__.pop("ell_buckets", None)


def _phases(graph, strategy: str, device) -> dict:
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
    ranks = torch.nonzero(mst).flatten().cpu().numpy()
    np.sort(graph.edge_id_of_rank(ranks))
    t4 = time.perf_counter()
    host_key = "host_ell_buckets_s" if strategy == "ell" else "host_rank_arrays_s"
    return {"levels": levels, host_key: t1 - t0, "h2d_s": t2 - t1,
            "level_loop_s": t3 - t2, "harvest_s": t4 - t3, "total_s": t4 - t0}


def _device_busy(prof) -> tuple[float, dict]:
    """Union of the device intervals (s), and the time (s) and launches of
    each kernel name."""
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            start, end = evt.time_range.start, evt.time_range.end
            spans.append((start, end))
            name = by_name[evt.name[:80]]
            name[0] += (end - start) * 1e-6
            name[1] += 1
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return busy * 1e-6, {name: {"s": t, "launches": c} for name, (t, c) in ranked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", choices=("fused", "stepped", "ell"), default="fused")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    card = card_description()
    graph = rmat_graph(SCALE, EDGE_FACTOR, seed=SEED)
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
        "graph": f"rmat-{SCALE} ef {EDGE_FACTOR} seed {SEED}",
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
