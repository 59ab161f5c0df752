"""The port's benchmark: MST throughput on RMAT graphs, and nine serving
workloads (the port's copy of the repository's root ``bench.py``).

    python -m distributed_ghs_implementation_tpu_torch.bench [--scale 24] [--device cuda]
    python -m distributed_ghs_implementation_tpu_torch bench [...]   (scale 22 by default)

Prints ONE JSON line as the last line of its standard output:
  {"metric": ..., "value": N, "unit": "edges/s", "vs_baseline": N, ...}

Baseline: the reference's best measured *correct* run, the 10-node/28-edge
thread-backend experiment at 0.41 s (BASELINE.md), about 68 edges/s.

Default workload: RMAT scale 24 (16.8M vertices, 260,380,545 undirected
edges after dedup), the size BASELINE.json's metric names, solved on
``--device`` (``cuda`` by default; without CUDA the bench exits non-zero
before any solve unless given ``--device cpu``, which runs the kernels'
plain PyTorch versions) and checked against the SciPy oracle weight
recorded for the native generator's stream (518,885,017 for seed 24).
Unknown (scale, seed, edge factor) combinations fall back to the live
SciPy oracle.

Accounting: ``value`` is the warm solve-only throughput (arrays staged);
``prep_s`` and ``e2e_edges_per_sec`` put the host prep (rank construction,
first ranks, host levels, staging) back on the clock. Every clock stops
after the card has finished (``torch.cuda.synchronize()``).

Where the port differs from the root ``bench.py`` on purpose: there is no
``--kernel`` and no ``level_kernel_speedup`` (a CUDA tensor always takes
the hand kernel; ``kernel`` reads ``cuda`` or ``torch`` by the device);
every line carries ``device`` (the card's name and power limit, or
``cpu``); the verify workload's second engine is ``torch``
(``certify_torch_p50_s``); ``--metrics-out``'s ``config`` carries
``package`` and ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device
from distributed_ghs_implementation_tpu_torch.models.boruvka import kernel_label
from distributed_ghs_implementation_tpu_torch.obs.events import quantile
from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels

BASELINE_EDGES_PER_SEC = 68.0  # reference: 28 edges / 0.41 s (BASELINE.md)

SEED = 24  # ties the generator call and the recorded-weight keys together

# SciPy-oracle MSF weights keyed by (scale, edge_factor, seed) of
# rmat_graph, deterministic per key on the native generator's stream only
# (the NumPy stream is another graph), so the lookup is gated on the
# graph's ``generator_path``.
RECORDED_ORACLE_WEIGHTS = {
    (20, 16, SEED): 35_737_768,
    (22, 16, SEED): 136_591_056,
    (24, 16, SEED): 518_885_017,
    (25, 16, SEED): 1_008_877_972,
    (26, 16, SEED): 1_960_349_712,
}


def _pctl(samples, p: float) -> float:
    # The repo-wide nearest-rank rule (obs.events.quantile): bench
    # percentiles stay comparable with histogram and SLO-report quantiles.
    return quantile(samples, p)


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a host clock stops after its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device: torch.device) -> str:
    """What each number was measured on: ``nvidia-smi``'s name and power
    limit of the card, or ``cpu``."""
    return card_description() if device.type == "cuda" else "cpu"


def _launches() -> dict:
    """Each kernel wrapper's launch count (the card only; the plain
    versions count nothing)."""
    from distributed_ghs_implementation_tpu_torch.ops import kernels

    return {w.__name__: w.launches for w in kernels.WRAPPERS}


def _emit(out: dict, device: torch.device) -> None:
    """The workload's one JSON line, with the device it ran on."""
    print(json.dumps({**out, "device": _card(device)}))


def _write_metrics(args, device: torch.device, config: dict, metrics: dict) -> None:
    """``--metrics-out``: the ``ghs-bench-metrics-v1`` schema that
    ``tools/bench_gate.py`` compares, with the JAX workload names."""
    if not args.metrics_out:
        return
    with open(args.metrics_out, "w") as f:
        json.dump(
            {
                "schema": "ghs-bench-metrics-v1",
                "config": {**config, "package": "torch", "device": _card(device)},
                "metrics": metrics,
            },
            f,
            indent=2,
        )
        f.write("\n")


def run_batch_bench(args, device) -> int:
    """Batched-serving throughput and latency: graphs/sec over K lanes
    against the sequential miss path, on same-bucket small graphs.

    Every graph is a distinct cache miss, so the sequential baseline is one
    device solve a graph and the batched run ``ceil(N / lanes)`` through
    ``batch/``. Also: the cold first query (``cold_first_solve_s``, the
    first batched solve of the process; with ``--warmup`` the bucket is
    built first by ``batch/warmup.py``), warm latency percentiles over
    per-request sequential solves, and pipelined against synchronous
    forming at a lane count that yields several batches. Every batched
    result is checked edge for edge against its sequential counterpart.
    """
    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import (
        minimum_spanning_forest,
        minimum_spanning_forest_batch,
    )
    from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
    from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy
    from distributed_ghs_implementation_tpu_torch.batch.warmup import (
        WarmupPlan,
        bucket_of,
        run_warmup,
    )
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph

    graphs = [
        gnm_random_graph(args.batch_nodes, args.batch_edges, seed=SEED * 1000 + i)
        for i in range(args.batch_graphs)
    ]
    engine = BatchEngine(policy=BatchPolicy(max_lanes=args.batch_lanes), device=device)

    warmup_s = None
    if args.warmup:
        t0 = time.perf_counter()
        report = run_warmup(
            WarmupPlan(
                buckets=(bucket_of(args.batch_nodes, args.batch_edges),),
                lanes=args.batch_lanes,
            ),
            device=device,
        )
        warmup_s = time.perf_counter() - t0
        print(f"warmup: {report} in {warmup_s:.3f}s", file=sys.stderr)

    # Cold first query: the first batched solve this process runs; with
    # --warmup the bucket was built above, without it this clock includes
    # the library load and the bucket's build.
    t0 = time.perf_counter()
    cold_first = engine.solve_many([graphs[0]])
    cold_first_solve_s = time.perf_counter() - t0
    print(
        f"cold first query ({'warmed' if args.warmup else 'no warmup'}): "
        f"{cold_first_solve_s:.3f}s",
        file=sys.stderr,
    )

    # Warm both paths: builds and the per-graph cached rank order.
    seq = [minimum_spanning_forest(g, device=device) for g in graphs]
    minimum_spanning_forest_batch(graphs, engine=engine)

    seq_times, batch_times, per_solve = [], [], []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for g in graphs:
            t1 = time.perf_counter()
            minimum_spanning_forest(g, device=device)
            per_solve.append(time.perf_counter() - t1)
        seq_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batched = minimum_spanning_forest_batch(graphs, engine=engine)
        batch_times.append(time.perf_counter() - t0)

    for s, b in zip(seq, batched):
        if not np.array_equal(s.edge_ids, b.edge_ids):
            print("BATCH PARITY FAILED vs sequential solve", file=sys.stderr)
            return 1
    if not np.array_equal(seq[0].edge_ids, cold_first[0].edge_ids):
        print("BATCH PARITY FAILED on the cold first query", file=sys.stderr)
        return 1

    # Pipelined against synchronous forming, at a lane count that yields
    # >= 4 batches; medians, not bests: the synchronous path's wall time is
    # bimodal on shared machines, and the median is what serving sees.
    pipe_lanes = max(1, min(args.batch_lanes, args.batch_graphs // 4))
    pipe_engine = BatchEngine(
        # The floor exists for production policies; this pair measures
        # pipelining, so force it on whatever the stack's size.
        policy=BatchPolicy(
            max_lanes=pipe_lanes, pipeline_depth=2, pipeline_min_stack_elems=0
        ),
        device=device,
    )
    sync_engine = BatchEngine(
        policy=BatchPolicy(max_lanes=pipe_lanes, pipeline_depth=1), device=device
    )
    pipe_engine.solve_many(graphs)  # warm the pipe-lane bucket once
    pipe_times, sync_times = [], []
    for _ in range(max(args.repeats, 5)):
        t0 = time.perf_counter()
        sync_engine.solve_many(graphs)
        sync_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pipe_engine.solve_many(graphs)
        pipe_times.append(time.perf_counter() - t0)

    n = len(graphs)
    seq_gps = n / min(seq_times)
    batch_gps = n / min(batch_times)
    speedup = batch_gps / seq_gps
    pipe_gps = n / _pctl(pipe_times, 0.50)
    sync_gps = n / _pctl(sync_times, 0.50)
    total_weight = int(sum(r.total_weight for r in seq))
    out = {
        "metric": f"batched MST graphs/sec, gnm({args.batch_nodes},"
        f"{args.batch_edges}) x {n}, {args.batch_lanes} lanes",
        "value": round(batch_gps, 1),
        "unit": "graphs/s",
        "seq_graphs_per_sec": round(seq_gps, 1),
        "batch_speedup": round(speedup, 2),
        "cold_first_solve_s": round(cold_first_solve_s, 4),
        "warm_solve_p50_s": round(_pctl(per_solve, 0.50), 5),
        "warm_solve_p95_s": round(_pctl(per_solve, 0.95), 5),
        "pipeline_graphs_per_sec": round(pipe_gps, 1),
        "sync_batch_graphs_per_sec": round(sync_gps, 1),
        "pipeline_speedup": round(pipe_gps / sync_gps, 2),
        "pipeline_lanes": pipe_lanes,
        "kernel": kernel_label(device),
        "parity": "edge-exact vs sequential",
    }
    if warmup_s is not None:
        out["warmup_s"] = round(warmup_s, 3)
    _emit(out, device)
    metrics = {
        "batch_graphs_per_sec": batch_gps,
        "seq_graphs_per_sec": seq_gps,
        "batch_speedup": speedup,
        "batch_solve_s": min(batch_times),
        "cold_first_solve_s": cold_first_solve_s,
        "warm_solve_p50_s": _pctl(per_solve, 0.50),
        "warm_solve_p95_s": _pctl(per_solve, 0.95),
        "pipeline_graphs_per_sec": pipe_gps,
        "sync_batch_graphs_per_sec": sync_gps,
        "pipeline_speedup": pipe_gps / sync_gps,
        "mst_weight": total_weight,
    }
    if warmup_s is not None:
        metrics["warmup_s"] = warmup_s
    _write_metrics(args, device, {
        "workload": f"batch-gnm({args.batch_nodes},{args.batch_edges})x{args.batch_graphs}"
        f"-lanes{args.batch_lanes}",
    }, metrics)
    return 0


def run_update_stream_bench(args, device) -> int:
    """Streaming-maintenance throughput: windowed batched apply
    (``stream/window.py``) against the sequential per-update exchange rules
    (``serve/dynamic.py``) on one seeded update stream.

    Both paths consume the same update list against the same seeded graph
    and must land on the same forest, which must also equal a fresh solve
    of the final graph edge for edge (the ``(w, u, v)`` order makes the MSF
    unique). The headline pair is ``window_updates_per_sec`` against
    ``seq_updates_per_sec``.
    """
    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import solve_graph
    from distributed_ghs_implementation_tpu_torch.serve.dynamic import DynamicMST
    from distributed_ghs_implementation_tpu_torch.stream.window import (
        WindowedMST,
        random_update_stream,
        warm_window_kernels,
    )

    n, m = args.stream_nodes, args.stream_edges
    total, window = args.stream_updates, args.stream_window
    g = gnm_random_graph(n, m, seed=SEED)
    rng = np.random.default_rng(SEED)
    seed_result = minimum_spanning_forest(g, device=device)

    # One fixed update list both paths consume, from the shared seeded
    # generator: sequential and windowed application see the same stream.
    updates = random_update_stream(rng, g, total)

    t0 = time.perf_counter()
    # Warm both the grown shape and the seed shape: inserts and deletes
    # roughly cancel, so the measured windows run near next_pow2(m).
    warm_window_kernels(n, m + total, device=device)
    warm_window_kernels(n, m, device=device)
    warmup_s = time.perf_counter() - t0
    print(f"window-kernel warmup: {warmup_s:.3f}s", file=sys.stderr)

    # Sequential per-update path, on DynamicMST itself (apply() never
    # touches the windowed machinery).
    seq = DynamicMST(seed_result, resolve_threshold=10**9, device=device)
    t0 = time.perf_counter()
    for upd in updates:
        seq.apply([upd])
    seq_s = time.perf_counter() - t0

    # Windowed batched path.
    win = WindowedMST(seed_result, resolve_threshold=10**9,
                      window_resolve_threshold=10**9, device=device)
    t0 = time.perf_counter()
    modes = {}
    for lo in range(0, total, window):
        _result, info = win.apply_window(updates[lo:lo + window])
        modes[info.mode] = modes.get(info.mode, 0) + 1
    window_s = time.perf_counter() - t0

    seq_result = seq.result()
    win_result = win.result()
    ids_ref, _, _ = solve_graph(win_result.graph, device=device)
    parity_ok = (
        np.array_equal(seq_result.graph.u, win_result.graph.u)
        and np.array_equal(seq_result.graph.v, win_result.graph.v)
        and np.array_equal(seq_result.graph.w, win_result.graph.w)
        and np.array_equal(np.sort(seq_result.edge_ids), np.sort(win_result.edge_ids))
        and np.array_equal(np.sort(win_result.edge_ids), np.sort(ids_ref))
    )
    if not parity_ok:
        print("UPDATE-STREAM PARITY FAILED (windowed vs sequential vs "
              "fresh solve)", file=sys.stderr)
        return 1

    seq_ups = total / seq_s
    win_ups = total / window_s
    _emit({
        "metric": f"streaming MSF maintenance, gnm({n},{m}), {total} updates"
        f" in windows of {window}",
        "value": round(win_ups, 1),
        "unit": "updates/s (windowed batched)",
        "seq_updates_per_sec": round(seq_ups, 1),
        "window_speedup": round(win_ups / seq_ups, 2),
        "window_size": window,
        "window_modes": modes,
        "warmup_s": round(warmup_s, 3),
        "parity": "edge-exact vs sequential AND fresh solve",
    }, device)
    _write_metrics(args, device, {
        "workload": f"update-stream-gnm({n},{m})-u{total}w{window}-seed{SEED}",
    }, {
        "window_updates_per_sec": win_ups,
        "seq_updates_per_sec": seq_ups,
        "window_speedup": win_ups / seq_ups,
        "window_apply_s": window_s,
        "seq_apply_s": seq_s,
        "warmup_s": warmup_s,
        "mst_weight": int(win_result.graph.w[win_result.edge_ids].sum()),
        "mst_edges": int(win_result.edge_ids.size),
    })
    return 0


def _echo_fleet(FleetConfig, **kw):
    """An echo fleet's config: workers that answer canned content and touch
    no device, so only the router, sockets and framing are on the clock."""
    return FleetConfig(test_echo=True, heartbeat_interval_s=0.25, ready_timeout_s=120.0,
                       request_timeout_s=60.0, **kw)


def run_fleet_tcp_bench(args, device) -> int:
    """Network-fleet transport metrics (``gate-fleet-tcp-v1``) on echo
    workers:

    * ``router_hop_{tcp,pipe}_{p50,p95}_s``: send-to-response wall time
      less the worker's own service time, a request, over sequential round
      trips and a concurrent burst;
    * ``forward_hit`` / ``forward_miss``, exact: a deterministic forwarding
      scenario (lane-steered oversize digests whose full-ring owner is
      another worker) drives exactly ``--fleet-forward`` probes down each
      path;
    * elastic churn: one warm join and one drain-aware retire; the joiner
      must serve its ring share, the retiree exit 0, and no death count
      (``elastic_scale_up`` / ``_down`` / ``elastic_unplanned_deaths`` 1/1/0).
    """
    from concurrent.futures import ThreadPoolExecutor

    from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
    from distributed_ghs_implementation_tpu_torch.fleet.router import (
        FleetConfig,
        FleetRouter,
    )
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    BUS.enable()
    workers = 3
    n_seq = args.fleet_requests
    n_burst = args.fleet_requests
    hops = {}
    for transport in ("pipe", "tcp"):
        BUS.clear()
        cfg = _echo_fleet(FleetConfig, workers=workers, transport=transport)
        with FleetRouter(cfg) as router:
            for i in range(16):  # warm: interpreter paths, first frames
                router.handle({"op": "solve", "digest": f"warm-{i}"})
            BUS.clear()
            for i in range(n_seq):
                resp = router.handle({"op": "solve", "digest": f"seq-{i}"})
                if not resp.get("ok"):
                    print(f"FLEET BENCH FAILED: {resp}", file=sys.stderr)
                    return 1
            # Concurrent burst: many requests in flight at once, where
            # per-frame syscalls (pipe) and coalesced writes (tcp) diverge.
            with ThreadPoolExecutor(max_workers=8) as pool:
                burst = list(pool.map(
                    lambda i: router.handle({"op": "solve", "digest": f"burst-{i}"}),
                    range(n_burst),
                ))
            if not all(r.get("ok") for r in burst):
                print("FLEET BENCH FAILED: burst errors", file=sys.stderr)
                return 1
            hist = BUS.histograms().get("fleet.hop_s", {})
            if not hist.get("count"):
                print("FLEET BENCH FAILED: no hop samples", file=sys.stderr)
                return 1
            hops[transport] = hist

    # Forwarding (deterministic): worker 0 owns the oversize lane subring
    # and forwarding is on (no shared disk). Hits: a digest solved at its
    # full-ring owner, then asked again oversize: the lane steers it at
    # worker 0, which probes the owner of record first. Misses: a fresh
    # oversize digest, solved locally by worker 0. Digests are screened so
    # that every full-ring owner differs from worker 0.
    BUS.clear()
    ring = HashRing(range(workers), replicas=64)
    k = args.fleet_forward
    hit_digests, miss_digests, i = [], [], 0
    while len(hit_digests) < k or len(miss_digests) < k:
        d = f"fwd-{i}"
        i += 1
        if ring.assign(d) == 0:
            continue
        if len(hit_digests) < k:
            hit_digests.append(d)
        else:
            miss_digests.append(d)
    oversize = {"num_nodes": 200_000, "edges": [[0, 1, 1]]}
    cfg = _echo_fleet(FleetConfig, workers=workers, transport="tcp",
                      sharded_lane_workers=1, forward_cache=True)
    with FleetRouter(cfg) as router:
        for d in hit_digests:
            owner = router.handle({"op": "solve", "digest": d})
            fwd = router.handle({"op": "solve", "digest": d, **oversize})
            if not (fwd.get("ok") and fwd.get("cached")
                    and fwd.get("forwarded_from") == owner["worker"]):
                print(f"FORWARD HIT FAILED: {fwd}", file=sys.stderr)
                return 1
        for d in miss_digests:
            local = router.handle({"op": "solve", "digest": d, **oversize})
            if not (local.get("ok") and local.get("worker") == 0):
                print(f"FORWARD MISS FAILED: {local}", file=sys.stderr)
                return 1
    counters = BUS.counters()
    forward_hit = int(counters.get("fleet.forward.hit", 0))
    forward_miss = int(counters.get("fleet.forward.miss", 0))
    if forward_hit != k or forward_miss != k:
        print(f"FORWARD COUNTERS WRONG: hit {forward_hit} miss {forward_miss}"
              f" (expected {k}/{k})", file=sys.stderr)
        return 1

    # Elastic churn (deterministic): the joiner serves its own ring share
    # before the retire, the retiree's keyspace stays answerable after it,
    # and a planned departure never reads as a death.
    BUS.clear()
    cfg = _echo_fleet(FleetConfig, workers=2, transport="tcp")
    with FleetRouter(cfg) as router:
        for i in range(8):
            router.handle({"op": "solve", "digest": f"pre-{i}"})
        joined = router.add_worker()
        ring3 = HashRing(range(3), replicas=cfg.ring_replicas)
        d_new = next(f"el-{i}" for i in range(1000)
                     if ring3.assign(f"el-{i}") == joined["worker"])
        served = router.handle({"op": "solve", "digest": d_new})
        if not (served.get("ok") and served.get("worker") == joined["worker"]):
            print(f"ELASTIC JOIN FAILED: {served}", file=sys.stderr)
            return 1
        retired = router.retire_worker(joined["worker"])
        if retired["exit_code"] != 0:
            print(f"ELASTIC RETIRE FAILED: {retired}", file=sys.stderr)
            return 1
        handoff = router.handle({"op": "solve", "digest": d_new})
        if not handoff.get("ok") or handoff.get("worker") == joined["worker"]:
            print(f"ELASTIC HANDOFF FAILED: {handoff}", file=sys.stderr)
            return 1
    counters = BUS.counters()
    elastic_up = int(counters.get("fleet.scale.up", 0))
    elastic_down = int(counters.get("fleet.scale.down", 0))
    elastic_deaths = int(counters.get("fleet.worker.dead", 0))
    if elastic_up != 1 or elastic_down != 1 or elastic_deaths != 0:
        print(f"ELASTIC COUNTERS WRONG: up {elastic_up} down {elastic_down} "
              f"deaths {elastic_deaths} (expected 1/1/0)", file=sys.stderr)
        return 1

    _emit({
        "metric": f"fleet router hop, {workers} echo workers, "
        f"{n_seq} sequential + {n_burst} burst requests",
        "value": round(hops["tcp"]["p50"] * 1e3, 3),
        "unit": "ms (tcp hop p50)",
        "router_hop_tcp_p50_s": round(hops["tcp"]["p50"], 6),
        "router_hop_tcp_p95_s": round(hops["tcp"]["p95"], 6),
        "router_hop_pipe_p50_s": round(hops["pipe"]["p50"], 6),
        "router_hop_pipe_p95_s": round(hops["pipe"]["p95"], 6),
        "forward_hit": forward_hit,
        "forward_miss": forward_miss,
        "elastic_join_warm_s": round(joined["warm_s"], 6),
        "elastic_scale_up": elastic_up,
        "elastic_scale_down": elastic_down,
    }, device)
    _write_metrics(args, device, {"workload": "gate-fleet-tcp-v1"}, {
        "router_hop_tcp_p50_s": hops["tcp"]["p50"],
        "router_hop_tcp_p95_s": hops["tcp"]["p95"],
        "router_hop_pipe_p50_s": hops["pipe"]["p50"],
        "router_hop_pipe_p95_s": hops["pipe"]["p95"],
        "forward_hit": forward_hit,
        "forward_miss": forward_miss,
        "elastic_join_warm_s": joined["warm_s"],
        "elastic_scale_up": elastic_up,
        "elastic_scale_down": elastic_down,
        "elastic_unplanned_deaths": elastic_deaths,
        "fleet_requests": 2 * (n_seq + n_burst + 16),
    })
    return 0


def run_wire_bench(args, device) -> int:
    """Binary wire-plane metrics (``gate-wire-v1``) on the oversize deck
    (70000 x 3000 by default):

    * ``wire_binary_ingest_per_sec`` / ``wire_json_ingest_per_sec``: graphs
      a second through the whole ingest each carrier pays (``read_frame``,
      ``Graph`` reconstruction, content digest); the bench fails below 5x.
      Parity comes first: both carriers must give the source graph's
      digest and edges;
    * ``wire_passthrough``, exact: every solve B-frame through a 3-worker
      all-binary TCP echo fleet takes the opaque passthrough;
    * ``wire_mixed_passthrough`` / ``wire_mixed_fallback_json``, exact: the
      same deck through a fleet whose worker 0 has no binary capability
      splits by ring owner, and every answer is ``ok``.
    """
    import io

    import numpy as np

    from distributed_ghs_implementation_tpu_torch.fleet.framing import (
        encode_bframe,
        encode_frame,
        read_frame,
    )
    from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
    from distributed_ghs_implementation_tpu_torch.fleet.router import (
        FleetConfig,
        FleetRouter,
    )
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    n, m = args.wire_nodes, args.wire_edges
    deck = [gnm_random_graph(n, m, seed=SEED + i) for i in range(args.wire_graphs)]

    # Both carriers encoded once: the clocks time ingest only, the work the
    # front door repeats a request.
    json_frames = [
        encode_frame(
            {"op": "solve", "num_nodes": g.num_nodes,
             "edges": np.stack([g.u, g.v, g.w], axis=1).tolist()},
            crc=True,
        )
        for g in deck
    ]
    bin_frames = [encode_bframe({"op": "solve", **g.to_wire()}) for g in deck]

    def _ingest_json(payload: bytes) -> Graph:
        req = read_frame(io.BytesIO(payload))
        return Graph.from_edges(req["num_nodes"], req["edges"])

    def _ingest_bin(payload: bytes) -> Graph:
        return Graph.from_wire(read_frame(io.BytesIO(payload)))

    # Parity before anything is timed: the same digest and edges from
    # either carrier.
    for g, jf, bf in zip(deck, json_frames, bin_frames):
        gj, gb = _ingest_json(jf), _ingest_bin(bf)
        if not (gj.digest() == gb.digest() == g.digest()):
            print("WIRE PARITY FAILED: digest mismatch", file=sys.stderr)
            return 1
        if not (np.array_equal(gb.u, g.u) and np.array_equal(gb.v, g.v)
                and np.array_equal(gb.w, g.w)
                and np.array_equal(gj.u, g.u)
                and np.array_equal(gj.w, g.w)):
            print("WIRE PARITY FAILED: edge arrays differ", file=sys.stderr)
            return 1

    def _ingest_clock(fn, frames) -> float:
        best = float("inf")
        for _ in range(max(1, args.repeats)):
            t0 = time.perf_counter()
            for payload in frames:
                fn(payload).digest()
            best = min(best, time.perf_counter() - t0)
        return len(frames) / best

    json_gps = _ingest_clock(_ingest_json, json_frames)
    bin_gps = _ingest_clock(_ingest_bin, bin_frames)
    speedup = bin_gps / json_gps
    if speedup < 5.0:
        print(f"WIRE BENCH FAILED: binary ingest {speedup:.1f}x JSON "
              f"(acceptance floor 5x)", file=sys.stderr)
        return 1

    # All-binary fleet: every solve B-frame must dispatch opaquely.
    BUS.enable()
    BUS.clear()
    requests = [{"op": "solve", **g.to_wire()} for g in deck]
    cfg = _echo_fleet(FleetConfig, workers=3, transport="tcp")
    with FleetRouter(cfg) as router:
        for g, req in zip(deck, requests):
            resp = router.handle(dict(req))
            if not (resp.get("ok") and resp.get("digest") == g.digest()):
                print(f"WIRE FLEET FAILED: {resp}", file=sys.stderr)
                return 1
    counters = BUS.counters()
    passthrough = int(counters.get("fleet.wire.passthrough", 0))
    fallback = int(counters.get("fleet.wire.fallback_json", 0))
    if passthrough != len(deck) or fallback != 0:
        print(f"WIRE COUNTERS WRONG: passthrough {passthrough} fallback "
              f"{fallback} (expected {len(deck)}/0)", file=sys.stderr)
        return 1

    # Mixed-build fleet: worker 0's hello lacks the binary capability, so
    # exactly the ring share it owns degrades to folded JSON.
    BUS.clear()
    ring = HashRing(range(3), replicas=cfg.ring_replicas)
    expect_fallback = sum(1 for g in deck if ring.assign(g.digest()) == 0)
    cfg_mixed = _echo_fleet(FleetConfig, workers=3, transport="tcp",
                            worker_env={0: {"GHS_FLEET_WIRE": "0"}})
    with FleetRouter(cfg_mixed) as router:
        for g, req in zip(deck, requests):
            resp = router.handle(dict(req))
            if not (resp.get("ok") and resp.get("digest") == g.digest()):
                print(f"WIRE MIXED FLEET FAILED: {resp}", file=sys.stderr)
                return 1
    counters = BUS.counters()
    mixed_pass = int(counters.get("fleet.wire.passthrough", 0))
    mixed_fallback = int(counters.get("fleet.wire.fallback_json", 0))
    if mixed_fallback != expect_fallback or mixed_pass != len(deck) - expect_fallback:
        print(f"WIRE MIXED COUNTERS WRONG: passthrough {mixed_pass} "
              f"fallback {mixed_fallback} (expected "
              f"{len(deck) - expect_fallback}/{expect_fallback})", file=sys.stderr)
        return 1

    _emit({
        "metric": f"binary wire ingest, gnm({n},{m}) x {len(deck)}",
        "value": round(speedup, 2),
        "unit": "x vs JSON ingest (graphs/sec)",
        "wire_binary_ingest_per_sec": round(bin_gps, 2),
        "wire_json_ingest_per_sec": round(json_gps, 2),
        "wire_passthrough": passthrough,
        "wire_fallback_json": fallback,
        "wire_mixed_passthrough": mixed_pass,
        "wire_mixed_fallback_json": mixed_fallback,
    }, device)
    _write_metrics(args, device, {
        "workload": "gate-wire-v1",
        "deck": f"gnm({n},{m},seeds {SEED}..)x{len(deck)}",
    }, {
        "wire_binary_ingest_per_sec": bin_gps,
        "wire_json_ingest_per_sec": json_gps,
        "wire_speedup": speedup,
        "wire_passthrough": passthrough,
        "wire_fallback_json": fallback,
        "wire_mixed_passthrough": mixed_pass,
        "wire_mixed_fallback_json": mixed_fallback,
        "wire_graphs": len(deck),
    })
    return 0


def run_verify_bench(args, device) -> int:
    """Certificate-checker overhead (``gate-verify-bench-v1``): what one
    MST certificate costs, by engine, at interactive and bulk scale.

    * ``verify_overhead_p50_s``: p50 of one certificate on the interactive
      pool with the default (auto) engine;
    * ``certify_np_p50_s`` / ``certify_torch_p50_s``: each engine
      explicitly (``np`` is what the router runs; ``torch`` runs its
      path-max query on the service's device);
    * ``certify_bulk_s``: one certificate at RMAT-14;
    * ``mutation_rejected``, exact: every adversarial mutation (a heavier
      swap-in, a duplicated edge id, a dropped edge) must be rejected;
    * ``mst_weight``, exact.
    """
    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
        rmat_graph,
    )
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.verify.certify import (
        certify_edge_ids,
        certify_result,
    )

    BUS.enable()
    small = [gnm_random_graph(256, 1024, seed=60 + i) for i in range(8)]
    bulk = rmat_graph(14, 8, seed=61)
    results = [minimum_spanning_forest(g, backend="host", device=device) for g in small]
    bulk_result = minimum_spanning_forest(bulk, backend="host", device=device)

    # Warm every engine once (the first call of each pays its set-up).
    for engine in ("np", "torch", "auto"):
        cert = certify_result(results[0], engine=engine, device=device)
        if not cert.ok:
            print(f"VERIFY BENCH FAILED: clean result rejected "
                  f"({engine}: {cert.reason})", file=sys.stderr)
            return 1

    timings = {"auto": [], "np": [], "torch": []}
    failed_clean = 0
    for _ in range(args.repeats):
        for engine in timings:
            for r in results:
                cert = certify_result(r, engine=engine, device=device)
                if not cert.ok:
                    failed_clean += 1
                timings[engine].append(cert.check_s)
    certify_result(bulk_result, device=device)  # warm the bulk shape
    t0 = time.perf_counter()
    bulk_cert = certify_result(bulk_result, device=device)
    certify_bulk_s = time.perf_counter() - t0
    if not bulk_cert.ok:
        failed_clean += 1

    # Adversarial mutations: each must be rejected (exact count).
    rejected = 0
    mutations = 0
    for r in results:
        g = r.graph
        ids = np.asarray(r.edge_ids)
        in_tree = np.zeros(g.num_edges, dtype=bool)
        in_tree[ids] = True
        nt = np.nonzero(~in_tree)[0]
        order = np.argsort(g.w, kind="stable")
        rank = np.empty(g.num_edges, dtype=np.int64)
        rank[order] = np.arange(g.num_edges)
        cases = [
            np.concatenate([ids[1:], ids[:1]])[:-1],      # dropped edge
            np.concatenate([ids[:-1], ids[:1]]),          # duplicated id
        ]
        if nt.size:
            swapped = ids.copy()
            swapped[int(np.argmin(rank[ids]))] = int(nt[np.argmax(rank[nt])])
            cases.append(swapped)                         # heavier swap-in
        for bad in cases:
            mutations += 1
            if not certify_edge_ids(g, bad, engine="np", device=device).ok:
                rejected += 1
    if rejected != mutations:
        print(f"VERIFY BENCH FAILED: {mutations - rejected} adversarial "
              f"mutations ACCEPTED", file=sys.stderr)
        return 1

    weight = int(sum(r.total_weight for r in results) + bulk_result.total_weight)
    metrics = {
        "verify_overhead_p50_s": quantile(timings["auto"], 0.5),
        "certify_np_p50_s": quantile(timings["np"], 0.5),
        "certify_torch_p50_s": quantile(timings["torch"], 0.5),
        "certify_bulk_s": certify_bulk_s,
        "mutation_rejected": rejected,
        "verify_failed_clean": failed_clean,
        "mst_weight": weight,
    }
    _emit({
        "metric": f"MST certificate, {len(small)} x gnm(256,1024) + "
        f"rmat-14, {args.repeats} repeats",
        "value": round(metrics["verify_overhead_p50_s"] * 1e3, 3),
        "unit": "ms (auto-engine certify p50)",
        **{name: round(metrics[name], 6) for name in (
            "verify_overhead_p50_s", "certify_np_p50_s", "certify_torch_p50_s",
            "certify_bulk_s")},
        "mutation_rejected": rejected,
        "mst_weight": weight,
    }, device)
    _write_metrics(args, device, {"workload": "gate-verify-bench-v1"}, metrics)
    return 0 if failed_clean == 0 else 1


def run_kinds_bench(args, device) -> int:
    """Per-kind analytics latency (``gate-analytics-bench-v1``): what each
    query kind costs through the whole service path, cold and warm, each
    against a fresh service (no cross-kind cache sharing):

    * ``<kind>_solve_p50_s``: the miss path, the kind's own solve;
    * ``<kind>_hit_p50_s``: the warm repeat (the kind's cache entry, or the
      host derivation off the shared MSF entry).

    ``mst_weight`` is exact (the SciPy oracle's); any non-ok or wrong-weight
    answer fails the run (``wrong_results``).
    """
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService
    from distributed_ghs_implementation_tpu_torch.utils.verify import scipy_mst_weight

    kinds = ("mst", "components", "k_msf", "bottleneck", "path_max")
    k_forest = 3
    BUS.enable()
    pool = [
        gnm_random_graph(args.batch_nodes, args.batch_edges, seed=70 + i)
        for i in range(8)
    ]
    oracle_weight = int(sum(int(scipy_mst_weight(g)) for g in pool))

    def kind_request(g, kind: str) -> dict:
        req = {
            "op": "solve",
            "num_nodes": g.num_nodes,
            "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)],
        }
        if kind != "mst":
            req["kind"] = kind
        if kind == "components":
            req["labels_out"] = True
        elif kind == "k_msf":
            req["k"] = k_forest
        elif kind == "path_max":
            req["u"], req["v"] = 0, g.num_nodes - 1
        return req

    # Warm the bucket outside the clock: boot cost, not a per-kind price.
    MSTService(backend="device", device=device).handle(kind_request(pool[0], "mst"))

    solve_lat = {k: [] for k in kinds}
    hit_lat = {k: [] for k in kinds}
    wrong = 0
    for _ in range(args.repeats):
        for kind in kinds:
            svc = MSTService(backend="device", device=device)
            served = 0
            for sink in (solve_lat, hit_lat):
                for g in pool:
                    t0 = time.perf_counter()
                    resp = svc.handle(kind_request(g, kind))
                    sink[kind].append(time.perf_counter() - t0)
                    if not resp.get("ok"):
                        wrong += 1
                    elif kind == "mst":
                        served += int(resp["total_weight"])
            if kind == "mst" and served != 2 * oracle_weight:
                wrong += 1
    if wrong:
        print(f"KINDS BENCH FAILED: {wrong} wrong/non-ok responses", file=sys.stderr)

    metrics = {"mst_weight": oracle_weight, "wrong_results": wrong}
    for kind in kinds:
        metrics[f"{kind}_solve_p50_s"] = quantile(solve_lat[kind], 0.5)
        metrics[f"{kind}_hit_p50_s"] = quantile(hit_lat[kind], 0.5)
    _emit({
        "metric": f"analytics kinds, {len(pool)} x gnm({args.batch_nodes},"
        f"{args.batch_edges}), {args.repeats} repeats",
        "value": round(metrics["mst_solve_p50_s"] * 1e3, 3),
        "unit": "ms (mst solve p50; per-kind keys in metrics)",
        **{
            name: (round(value, 6) if name.endswith("_s") else value)
            for name, value in metrics.items()
        },
    }, device)
    _write_metrics(args, device, {"workload": "gate-analytics-bench-v1"}, metrics)
    return 0 if wrong == 0 else 1


def run_tuned_bench(args, device) -> int:
    """Tuned against default launch configs (``gate-tune-v1``): warm solve
    p50 on the batch-lane path (and, on a mesh of >= 2 devices, the sharded
    lane) with a tuning record installed against none, plus the exact count
    of record consults (``kernel.selected.measured``, one a batched
    dispatch). The record comes from ``--tune-record`` (written by ``tune``)
    or a dry in-process search over the buckets this bench drives (a dry
    record pins the default config, so the bench is deterministic). Both
    phases' results must agree edge for edge.
    """
    import tempfile

    import numpy as np

    from distributed_ghs_implementation_tpu_torch.batch import lanes as lanes_mod
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
    from distributed_ghs_implementation_tpu_torch.tune import (
        load_and_install,
        save_record,
        search,
    )
    from distributed_ghs_implementation_tpu_torch.tune.measure import mesh_bucket

    BUS.enable()
    BUS.clear()
    lanes = args.batch_lanes or 8
    graphs = [
        gnm_random_graph(args.batch_nodes, args.batch_edges, seed=SEED * 1000 + i)
        for i in range(lanes)
    ]
    n_pad, m_pad = lanes_mod.bucket_of(args.batch_nodes, args.batch_edges)
    buckets = [(n_pad, m_pad, lanes, "fused"), (n_pad, m_pad, 0, "fused")]

    # The port's mesh on this device (one shard a card), as `tune
    # --mesh-buckets` counts it.
    mesh = edge_mesh(device=device)
    n_dev = mesh.size
    use_mesh = n_dev >= 2
    mesh_graph = None
    lane = None
    if use_mesh:
        from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane

        mesh_graph = gnm_random_graph(args.sharded_nodes, args.sharded_edges, seed=SEED)
        buckets.append(mesh_bucket(args.sharded_nodes, args.sharded_edges, n_dev))
        lane = ShardedLane(mesh)

    def _warm_p50(fn):
        fn()  # warm (the first phase builds, the second hits)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return _pctl(times, 0.50)

    def _batch():
        return lanes_mod.solve_lanes(graphs, lanes=lanes, mode="fused", device=device)

    # Phase 1: the default launch configs (no record installed).
    default_p50 = _warm_p50(_batch)
    default_ids = [r[0] for r in _batch()]
    mesh_default_p50 = None
    if use_mesh:
        mesh_default_p50 = _warm_p50(lambda: lane.solve(mesh_graph))

    # Phase 2: install the record and measure the same work again.
    record_path = args.tune_record
    if not record_path:
        record = search(buckets, repeats=1, dry=True, device=device)
        record_path = os.path.join(tempfile.mkdtemp(prefix="ghs-tune-bench-"), "tuning.json")
        save_record(record, record_path)
    installed = load_and_install(record_path, device=device)
    if installed < 1:
        print("TUNED BENCH FAILED: record installed 0 buckets", file=sys.stderr)
        return 1
    before = BUS.counters().get("kernel.selected.measured", 0)
    tuned_p50 = _warm_p50(_batch)
    tuned_ids = [r[0] for r in _batch()]
    mesh_tuned_p50 = None
    if use_mesh:
        mesh_tuned_p50 = _warm_p50(lambda: lane.solve(mesh_graph))
    tune_record_hits = int(BUS.counters().get("kernel.selected.measured", 0) - before)

    if not all(np.array_equal(a, b) for a, b in zip(default_ids, tuned_ids)):
        print("TUNED BENCH PARITY FAILED: tuned vs default edge ids", file=sys.stderr)
        return 1
    if tune_record_hits < 1:
        print("TUNED BENCH FAILED: the installed record was never "
              "consulted (kernel.selected.measured did not count)", file=sys.stderr)
        return 1

    total_weight = int(sum(int(g.w[ids].sum()) for g, ids in zip(graphs, tuned_ids)))
    out = {
        "metric": f"tuned vs default selector, {lanes}-lane "
        f"gnm({args.batch_nodes},{args.batch_edges})"
        + (f" + mesh gnm({args.sharded_nodes},{args.sharded_edges})"
           if use_mesh else ""),
        "value": round(default_p50 / tuned_p50, 3),
        "unit": "x (batch warm p50, default/tuned)",
        "default_warm_p50_s": round(default_p50, 4),
        "tuned_warm_p50_s": round(tuned_p50, 4),
        "tune_record_hits": tune_record_hits,
        "tuned_entries": installed,
        "record": record_path,
    }
    metrics = {
        "default_warm_p50_s": default_p50,
        "tuned_warm_p50_s": tuned_p50,
        "tune_record_hits": tune_record_hits,
        "tuned_entries": installed,
        "mst_weight": total_weight,
    }
    if use_mesh:
        out["mesh_default_warm_p50_s"] = round(mesh_default_p50, 4)
        out["mesh_tuned_warm_p50_s"] = round(mesh_tuned_p50, 4)
        metrics["mesh_default_warm_p50_s"] = mesh_default_p50
        metrics["mesh_tuned_warm_p50_s"] = mesh_tuned_p50
    _emit(out, device)
    _write_metrics(args, device, {
        "workload": f"tuned-{lanes}lane-gnm({args.batch_nodes},{args.batch_edges})-seed{SEED}"
        f"-{n_dev}dev-r{args.repeats}",
    }, metrics)
    return 0


def run_sharded_bench(args, device) -> int:
    """Oversize-lane serving: cold staging against a warm device-resident
    re-solve on the mesh (``parallel/lane.py``), and the in-place
    incremental update.

    ``resolve_cold_s`` (host prep, staging, solve) against
    ``resolve_warm_s`` (a resident graph: nothing moves from the host);
    ``reshard_skipped`` counts the solves that reused the resident arrays,
    one a warm repeat and one for the update, so it is exact.
    """
    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane

    BUS.enable()
    BUS.clear()
    lane = ShardedLane(device=device)
    g = gnm_random_graph(args.sharded_nodes, args.sharded_edges, seed=SEED)

    t0 = time.perf_counter()
    lane.precompile(g.num_nodes, g.num_edges)
    warmup_s = time.perf_counter() - t0
    print(f"mesh warmup ({lane.n_dev} device(s)): {warmup_s:.3f}s", file=sys.stderr)

    t0 = time.perf_counter()
    ids_cold, _, levels = lane.solve(g)
    resolve_cold_s = time.perf_counter() - t0

    warm_times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        ids_warm, _, _ = lane.solve(g)
        warm_times.append(time.perf_counter() - t0)
    resolve_warm_s = min(warm_times)

    # Incremental update: a top-weight true insert (one changed rank slot),
    # then the re-solve on the resident arrays.
    existing = {(int(a), int(b)) for a, b in zip(g.u, g.v)}
    ins_v = next(x for x in range(1, g.num_nodes) if (0, x) not in existing)
    g2 = Graph.from_arrays(
        g.num_nodes,
        np.concatenate([g.u, [0]]),
        np.concatenate([g.v, [ins_v]]),
        np.concatenate([g.w, [int(g.w.max()) + 1]]),
    )
    t0 = time.perf_counter()
    ids_upd, _, _ = lane.update(g.digest(), g2)
    update_donated_s = time.perf_counter() - t0

    ref = minimum_spanning_forest(g, backend="device", device=device)
    ref2 = minimum_spanning_forest(g2, backend="device", device=device)
    if not (
        np.array_equal(ids_cold, ref.edge_ids)
        and np.array_equal(ids_warm, ref.edge_ids)
        and np.array_equal(ids_upd, ref2.edge_ids)
    ):
        print("SHARDED LANE PARITY FAILED vs device solve", file=sys.stderr)
        return 1

    counters = BUS.counters()
    reshard_skipped = int(counters.get("lane.reshard.skipped", 0))
    update_donated = int(counters.get("lane.update.donated", 0))
    _emit({
        "metric": f"sharded-lane oversize serving, gnm({g.num_nodes},"
        f"{g.num_edges}) on {lane.n_dev} device(s)",
        "value": round(g.num_edges / resolve_warm_s, 1),
        "unit": "edges/s (warm resident re-solve)",
        "warmup_s": round(warmup_s, 3),
        "resolve_cold_s": round(resolve_cold_s, 3),
        "resolve_warm_s": round(resolve_warm_s, 3),
        "update_donated_s": round(update_donated_s, 3),
        "reshard_skipped": reshard_skipped,
        "update_donated": update_donated,
        "levels": int(levels),
        "kernel": lane.kernel,
        "parity": "edge-exact vs device solve (incl. updated graph)",
    }, device)
    _write_metrics(args, device, {
        "workload": f"sharded-lane-gnm({args.sharded_nodes},{args.sharded_edges})-seed{SEED}"
        f"-{lane.n_dev}dev-r{args.repeats}",
    }, {
        "warmup_s": warmup_s,
        "resolve_cold_s": resolve_cold_s,
        "resolve_warm_s": resolve_warm_s,
        "warm_edges_per_sec": g.num_edges / resolve_warm_s,
        "update_donated_s": update_donated_s,
        "reshard_skipped": reshard_skipped,
        "update_donated": update_donated,
        "levels": int(levels),
        "mst_weight": int(g.w[ids_cold].sum()),
    })
    return 0


def run_stream_sharded_bench(args, device) -> int:
    """Durable sharded streaming (``gate-stream-sharded-v1``): window
    throughput on a mesh-resident oversize stream, then the crash-rebuild
    leg, a fresh manager and lane rebuilding the head from the snapshot and
    the WAL alone, with no fresh solve.

    One seed past the lane engine's admission ceiling (by its vertex
    bucket) is solved cold on the mesh, subscribed as a durable stream on
    the lane, and driven through K published windows
    (``window_commits_per_sec`` / ``window_updates_per_sec``). The rebuild
    re-stages the snapshot once (``residency_restored``, exact), replays
    every later window, and must equal a fresh solve edge for edge; warm
    head solves on both sides move nothing (``reshard_skipped``, exact).
    """
    import tempfile

    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane
    from distributed_ghs_implementation_tpu_torch.stream.session import StreamManager
    from distributed_ghs_implementation_tpu_torch.stream.window import (
        random_update_stream,
        warm_window_kernels,
    )

    BUS.enable()
    BUS.clear()
    n, m = args.stream_sharded_nodes, args.stream_sharded_edges
    windows, per_window = args.stream_sharded_windows, args.stream_window
    g = gnm_random_graph(n, m, seed=SEED)
    rng = np.random.default_rng(SEED)

    lane = ShardedLane(device=device)
    t0 = time.perf_counter()
    lane.precompile(n, m)
    warm_window_kernels(n, m, device=device)
    warm_window_kernels(n, m + windows * per_window, device=device)
    warmup_s = time.perf_counter() - t0
    print(f"mesh + window warmup ({lane.n_dev} device(s)): {warmup_s:.3f}s", file=sys.stderr)

    t0 = time.perf_counter()
    seed_result = lane.solve_result(g)
    seed_solve_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="ghs-stream-sharded-") as root:
        # snapshot_every does not divide the window count: the rebuild must
        # find WAL entries past the last snapshot.
        mgr = StreamManager(root=root, snapshot_every=3, lane=lane, device=device)
        session = mgr.subscribe(digest=g.digest(), result=seed_result)
        if not session.sharded:
            print("STREAM NOT SHARDED: seed did not route to the mesh lane", file=sys.stderr)
            return 1

        head = session.head
        t0 = time.perf_counter()
        for _ in range(windows):
            window = random_update_stream(rng, g, per_window)
            head = mgr.publish(session.id, head, window)["digest"]
        window_commit_s = time.perf_counter() - t0

        # Warm head solve on the residency the commits kept up.
        head_graph = session.mst.result().graph
        t0 = time.perf_counter()
        ids_live, _, _ = lane.solve(head_graph)
        head_warm_solve_s = time.perf_counter() - t0

        # Crash-rebuild: a fresh lane and manager, no solver attached.
        stream_id = session.id
        del mgr, session
        lane2 = ShardedLane(device=device)
        mgr2 = StreamManager(root=root, snapshot_every=3, lane=lane2, device=device)
        t0 = time.perf_counter()
        recovered = mgr2.recover(stream_id)
        replay_rebuild_s = time.perf_counter() - t0
        if recovered is None or recovered.head != head:
            print("REPLAY REBUILD FAILED: recovered head diverged", file=sys.stderr)
            return 1
        rebuilt = recovered.mst.result()
        t0 = time.perf_counter()
        ids_replay, _, _ = lane2.solve(rebuilt.graph)
        replay_warm_solve_s = time.perf_counter() - t0

    ref = minimum_spanning_forest(rebuilt.graph, backend="device", device=device)
    if not (
        np.array_equal(np.sort(ids_live), np.sort(ref.edge_ids))
        and np.array_equal(np.sort(ids_replay), np.sort(ref.edge_ids))
        and np.array_equal(np.sort(rebuilt.edge_ids), np.sort(ref.edge_ids))
    ):
        print("STREAM-SHARDED PARITY FAILED vs fresh oracle solve", file=sys.stderr)
        return 1

    counters = BUS.counters()
    migrated = int(counters.get("stream.lane.migrated", 0)
                   + counters.get("stream.lane.restaged", 0))
    commits_per_sec = windows / window_commit_s
    metrics = {
        "warmup_s": warmup_s,
        "seed_solve_s": seed_solve_s,
        "window_commit_s": window_commit_s,
        "window_commits_per_sec": commits_per_sec,
        "window_updates_per_sec": windows * per_window / window_commit_s,
        "head_warm_solve_s": head_warm_solve_s,
        "replay_rebuild_s": replay_rebuild_s,
        "replay_warm_solve_s": replay_warm_solve_s,
        "residency_migrated": migrated,
        "residency_restored": int(counters.get("lane.resident.restored", 0)),
        "replay_windows": int(counters.get("stream.replay.windows", 0)),
        "replay_fresh_solves": int(counters.get("stream.replay.fresh_solve", 0)),
        "reshard_skipped": int(counters.get("lane.reshard.skipped", 0)),
        "mst_weight": int(rebuilt.graph.w[np.asarray(rebuilt.edge_ids)].sum()),
        "mst_edges": int(np.asarray(rebuilt.edge_ids).size),
    }
    _emit({
        "metric": f"durable sharded streaming, gnm({n},{m}) on "
        f"{lane.n_dev} device(s), {windows} windows of {per_window}",
        "value": round(commits_per_sec, 2),
        "unit": "window commits/s (mesh-resident, durable)",
        "warmup_s": round(warmup_s, 3),
        "seed_solve_s": round(seed_solve_s, 3),
        "window_commits_per_sec": round(commits_per_sec, 2),
        "window_updates_per_sec": round(metrics["window_updates_per_sec"], 1),
        "head_warm_solve_s": round(head_warm_solve_s, 3),
        "replay_rebuild_s": round(replay_rebuild_s, 3),
        "replay_warm_solve_s": round(replay_warm_solve_s, 3),
        **{name: metrics[name] for name in (
            "residency_migrated", "residency_restored", "replay_windows",
            "replay_fresh_solves", "reshard_skipped")},
        "kernel": lane.kernel,
        "parity": "edge-exact vs fresh oracle solve (live AND rebuilt head)",
    }, device)
    _write_metrics(args, device, {
        "workload": "gate-stream-sharded-v1",
        "shape": f"gnm({n},{m})-seed{SEED}-{lane.n_dev}dev-w{windows}x{per_window}",
    }, metrics)
    return 0


def run_rmat_bench(args, device) -> int:
    """MST edges/s on RMAT-``--scale`` (the default workload): generate,
    stage and solve through ``--backend``, then check the forest's weight
    against the recorded oracle weight (or the live SciPy oracle)."""
    import numpy as np

    from distributed_ghs_implementation_tpu_torch.api import (
        MSTResult,
        minimum_spanning_forest,
    )
    from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph
    from distributed_ghs_implementation_tpu_torch.utils.verify import verify_result

    t0 = time.perf_counter()
    g = rmat_graph(args.scale, args.edge_factor, seed=SEED)
    print(
        f"generated RMAT-{args.scale}: {g.num_nodes:,} nodes, {g.num_edges:,} edges "
        f"in {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _launches()

    # Timing of the solve that is also the one verified: arrays staged
    # once, each repeat a solve and a wait for the card. prep_s is the
    # whole host-side cost of getting there from the cold graph.
    times = []
    prep_s = None
    if args.backend == "device":
        from distributed_ghs_implementation_tpu_torch.models.boruvka import harvest
        from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
            make_production_solver,
        )

        # make_production_solver is the one place the route is chosen, as
        # for solve_graph_rank: the bench measures the solve production runs.
        t0 = time.perf_counter()
        solve = make_production_solver(g, device=device)
        _sync(device)
        prep_s = time.perf_counter() - t0
        print(f"host prep (ranks + first_ranks + L1/L2 + staging): "
              f"{prep_s:.1f}s", file=sys.stderr)
        t0 = time.perf_counter()
        mst, fragment, levels = solve()
        _sync(device)
        cold_first_solve_s = time.perf_counter() - t0  # library load included
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            mst, fragment, levels = solve()
            _sync(device)
            times.append(time.perf_counter() - t0)
        # The timed solve's own output is what is verified below.
        edge_ids, fragment, levels = harvest(g, mst, fragment, levels)
        result = MSTResult(
            graph=g,
            edge_ids=edge_ids,
            num_levels=levels,
            wall_time_s=min(times),
            backend="device/rank",
            num_components=count_labels(fragment),
        )
    else:
        result = minimum_spanning_forest(g, backend=args.backend, device=device)
        cold_first_solve_s = result.wall_time_s  # library load included
        for _ in range(args.repeats):
            r = minimum_spanning_forest(g, backend=args.backend, device=device)
            times.append(r.wall_time_s)
    best = min(times)
    print(f"solve times: {[f'{t:.3f}' for t in times]} "
          f"(cold first: {cold_first_solve_s:.3f})", file=sys.stderr)
    if device.type == "cuda":
        launches = {name: count - launches0[name] for name, count in _launches().items()}
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; "
              f"kernel launches: {json.dumps(launches)}", file=sys.stderr)

    # Recorded weights apply only to the native generator's stream (the
    # graph carries the tag); otherwise the live oracle.
    recorded = (
        RECORDED_ORACLE_WEIGHTS.get((args.scale, args.edge_factor, SEED))
        if g.__dict__.get("generator_path") == "rmat-native"
        else None
    )
    if not args.no_verify:
        v = verify_result(result, oracle="auto", expected_weight=recorded)
        if not v.ok:
            print(f"VERIFICATION FAILED: {v}", file=sys.stderr)
            _emit({
                "metric": f"MST edges/sec on RMAT-{args.scale} (VERIFY FAILED)",
                "value": 0.0,
                "unit": "edges/s",
                "vs_baseline": 0.0,
            }, device)
            return 1
        print(f"verified: weight {v.actual_weight} = {v.oracle} oracle", file=sys.stderr)

    edges_per_sec = g.num_edges / best
    verified = "weight-verified" if not args.no_verify else "unverified"
    out = {
        "metric": f"MST edges/sec on RMAT-{args.scale} ({g.num_nodes} nodes, "
        f"{g.num_edges} edges, {verified}, solve-only)",
        "value": round(edges_per_sec, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_sec / BASELINE_EDGES_PER_SEC, 1),
        "solve_s": round(best, 3),
        "cold_first_solve_s": round(cold_first_solve_s, 3),
        "solve_p50_s": round(_pctl(times, 0.50), 3),
        "solve_p95_s": round(_pctl(times, 0.95), 3),
    }
    metrics = {
        "solve_s": best,
        "cold_first_solve_s": cold_first_solve_s,
        "solve_p50_s": _pctl(times, 0.50),
        "solve_p95_s": _pctl(times, 0.95),
        "edges_per_sec": edges_per_sec,
        "levels": int(result.num_levels),
        "mst_weight": int(result.total_weight),
        "mst_edges": int(result.num_edges),
    }
    if prep_s is not None:
        out["prep_s"] = round(prep_s, 3)
        out["e2e_edges_per_sec"] = round(g.num_edges / (prep_s + best), 1)
        metrics["prep_s"] = prep_s
        metrics["e2e_edges_per_sec"] = g.num_edges / (prep_s + best)
    _emit(out, device)
    _write_metrics(args, device, {
        "workload": f"rmat-{args.scale}x{args.edge_factor}-seed{SEED}-{args.backend}",
    }, metrics)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scale", type=int, default=24, help="RMAT scale (2^scale vertices)")
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--backend", default="device", choices=["device", "sharded"])
    p.add_argument("--no-verify", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="where the solves run: 'cuda' (default; exits non-zero without CUDA) "
        "or 'cpu' (the kernels' plain PyTorch versions)",
    )
    p.add_argument(
        "--metrics-out",
        help="also write the run's metrics in the bench-gate schema "
        "(tools/bench_gate.py compares such files across runs)",
    )
    p.add_argument(
        "--batch-lanes", type=int, default=0,
        help="measure batched small-graph serving throughput at this lane "
        "count instead of the RMAT bench (0 = RMAT bench)",
    )
    p.add_argument("--batch-graphs", type=int, default=64,
                   help="graphs in the batched workload")
    p.add_argument("--batch-nodes", type=int, default=128)
    p.add_argument("--batch-edges", type=int, default=480)
    p.add_argument(
        "--warmup", action="store_true",
        help="build the batch bucket before the cold-first-query clock "
        "(batch/warmup.py): the cold/warm pair for cold_first_solve_s "
        "(batch mode only)",
    )
    p.add_argument(
        "--sharded-lane", action="store_true",
        help="measure the oversize sharded-lane serving path (cold staging "
        "vs warm device-resident re-solve, in-place updates) instead of the "
        "RMAT bench",
    )
    p.add_argument("--sharded-nodes", type=int, default=70_000,
                   help="oversize workload nodes for --sharded-lane")
    p.add_argument("--sharded-edges", type=int, default=140_000)
    p.add_argument(
        "--tuned", action="store_true",
        help="measure tuned vs default launch configs instead of the RMAT "
        "bench: warm solve p50 on the batch-lane (and, with >= 2 devices, "
        "mesh) paths with a tuning record installed, plus the exact count "
        "of record consults",
    )
    p.add_argument(
        "--tune-record", default=None, metavar="PATH",
        help="with --tuned: install this ghs-tuning-v1 record (from `tune`) "
        "instead of running a dry in-process search",
    )
    p.add_argument(
        "--fleet-tcp", action="store_true",
        help="measure network-fleet transport overhead instead of the RMAT "
        "bench: router-hop p50/p95 over TCP sockets vs subprocess pipes on "
        "echo workers, plus exact cache-miss forwarding counters",
    )
    p.add_argument("--fleet-requests", type=int, default=200,
                   help="round trips per transport in --fleet-tcp (each "
                   "runs once sequentially and once in a concurrent burst)")
    p.add_argument("--fleet-forward", type=int, default=6,
                   help="forwarding hits AND misses driven in --fleet-tcp "
                   "(fleet.forward.hit/miss then count exactly)")
    p.add_argument(
        "--wire", action="store_true",
        help="measure the binary wire plane instead of the RMAT bench: "
        "B-frame vs JSON ingest throughput (graphs/sec, fails below 5x), "
        "digest/edge parity, and exact opaque-passthrough counters "
        "through all-binary and mixed-build TCP echo fleets",
    )
    p.add_argument("--wire-nodes", type=int, default=70_000,
                   help="deck graph nodes for --wire (the oversize bucket)")
    p.add_argument("--wire-edges", type=int, default=3_000)
    p.add_argument("--wire-graphs", type=int, default=16,
                   help="graphs in the --wire ingest/fleet deck")
    p.add_argument(
        "--update-stream", action="store_true",
        help="measure streaming MSF maintenance: windowed batched apply "
        "(stream/window.py) vs the sequential per-update path, edge-exact "
        "parity enforced",
    )
    p.add_argument("--stream-nodes", type=int, default=1024)
    p.add_argument("--stream-edges", type=int, default=4096)
    p.add_argument("--stream-updates", type=int, default=256,
                   help="updates in the measured stream")
    p.add_argument("--stream-window", type=int, default=64,
                   help="updates per committed window (the batching unit)")
    p.add_argument(
        "--stream-sharded", action="store_true",
        help="measure durable sharded streaming: window commits on a "
        "mesh-resident oversize stream on the sharded lane, then the "
        "crash-rebuild leg (snapshot re-stage and WAL replay with zero fresh "
        "solves), edge-exact vs a fresh solve",
    )
    p.add_argument("--stream-sharded-nodes", type=int, default=70_000,
                   help="stream seed nodes for --stream-sharded (oversize "
                   "by node bucket: routes to the mesh lane)")
    p.add_argument("--stream-sharded-edges", type=int, default=3_000)
    p.add_argument("--stream-sharded-windows", type=int, default=8,
                   help="published windows in --stream-sharded (each of "
                   "--stream-window updates)")
    p.add_argument(
        "--verify", action="store_true",
        help="certificate-checker overhead bench: per-engine certify p50 at "
        "interactive and bulk scale, adversarial mutation rejection exact. "
        "Unrelated to --no-verify, which skips the RMAT run's oracle check",
    )
    p.add_argument(
        "--kinds", action="store_true",
        help="per-kind analytics latency bench: p50 of each query kind (mst, "
        "components, k_msf, bottleneck, path_max) through the service, cold "
        "(the kind's own solve) and warm (its cache entry or host derivation)",
    )
    return p


#: flag -> workload, in the root bench.py's order of precedence; none of
#: them set runs the RMAT bench.
WORKLOADS = (
    ("verify", run_verify_bench),
    ("kinds", run_kinds_bench),
    ("fleet_tcp", run_fleet_tcp_bench),
    ("wire", run_wire_bench),
    ("update_stream", run_update_stream_bench),
    ("stream_sharded", run_stream_sharded_bench),
    ("tuned", run_tuned_bench),
    ("sharded_lane", run_sharded_bench),
    ("batch_lanes", run_batch_bench),
)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # The device rule, before anything runs: without CUDA and without
    # --device cpu, a non-zero exit.
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"bench: {e}")
    for flag, run in WORKLOADS:
        if getattr(args, flag):
            return run(args, device)
    return run_rmat_bench(args, device)


if __name__ == "__main__":
    sys.exit(main())
