"""Open-loop load drill: sustained concurrent traffic against the serve stack.

Every other bench in the repo is *closed-loop* (the next request waits for
the last answer), which can never see queueing collapse. This drill is
**open-loop**: a seeded arrival schedule is generated up front (Poisson,
bursty, or ramp — arrivals never wait on completions), then threaded
clients fire a mixed scenario deck at :class:`serve.service.MSTService`:

* ``hit`` — repeats over a pre-solved pool (pure cache path),
* ``miss`` — distinct graphs across several shape buckets (solver path),
* ``batch`` — same-bucket bursts that must share lanes in the batch engine,
* ``dup`` — duplicate-digest storms (single-flight coalescing),
* ``update`` — incremental edge-update streams through ``serve/dynamic.py``
  (digest-chained, serialized per stream),
* ``oversize`` — bucket-ceiling bypasses to the single-graph path,

plus seeded **chaos faults armed mid-flight** (transient device failures,
a failed batch attempt) that the supervisor ladder must absorb: an
accepted query may degrade, it may never be *lost*.

Each request carries an ``slo_class`` tag; per-class goodput and
p50/p95/p99 latency are then **joined from the real ``serve.*`` /
``batch.*`` / ``compile.*`` bus events** by ``obs.slo`` (client-side
stopwatch accounting rides along as a cross-check). The report
(``ghs-load-report-v1``) embeds ``ghs-bench-metrics-v1`` gate metrics;
``--gate-baseline PATH`` compares them against a baseline of the same
schema with ``tools/bench_gate.py`` (``--update-baseline PATH`` writes
one), so p99 and goodput regressions fail the run the way weight parity
does.

**Fleet mode** (``--fleet N``): the same open-loop deck drives a
:class:`fleet.router.FleetRouter` over N worker subprocesses instead of the
in-process service — per-class latency then *includes* routing, framed-pipe
transport, per-worker queueing, and any failover re-queue, joined from the
router's ``fleet.request`` spans (with a per-worker SLO breakdown).
``--kill-worker [K]`` arms the fault registry inside worker K mid-window
(``fleet.worker.crash``: it dies in place of its next request, no response
flushed) and the drill then asserts the zero-lost-query contract: every
accepted query is answered (the crashed worker's in-flight requests
re-queue onto survivors), the dead worker restarts with backoff, rejoins
the ring, and serves a probe query.

**Disaster modes** (``--kill-router`` / ``--partition``, echo TCP
fleets over externally spawned ``--listen`` workers — the topology that
survives a router death): ``--kill-router`` crashes the router itself
mid-window with accepted work outstanding; a successor on the same
durable journal (``fleet/journal.py``) re-dials the still-live workers
(warm — their ``handled`` counts persist), replays the orphaned accepts,
and in-flight clients retry idempotently — ``lost_accepted == 0`` and
``journal_unanswered == 0`` gate EXACTLY (``gate-fleet-router-v1``).
``--partition K`` drives the transport chaos layer: worker K's link goes
one-way dark (frames dropped, socket OPEN — detection must come from the
lease, not EOF), heals after ``--partition-duration``, and the drill
asserts zero loss, exactly one answer per query, and no lease trips on
the healthy side.

**Elastic mode** (``--elastic``, needs ``--fleet``): an
:class:`fleet.autoscaler.Autoscaler` drives the pool during the window —
a zero-second wait budget makes the ramp deterministically provoke warm
scale-ups to ``--elastic-max``, and post-window idle drains the pool down
to ``--elastic-min`` (drain-aware retires: lowest-affinity victim, pinned
sessions migrating to ring inheritors). The drill waits for both
convergences, stops the autoscaler, and then — in ``--update-heavy`` mode
— publishes one more window per stream to prove the migrated streams
recover by snapshot+WAL replay with ZERO fresh solves. Scale event counts
gate EXACTLY (``gate-fleet-elastic-v1``) and ``fleet.join.warm_s`` p95
gates as a wall-time ceiling; ``--kill-worker`` composes (the device-free
``--test-echo`` kill-during-scale variant), asserting that a crash landing
mid-scale still loses nothing.

Everything runs on ``--device`` (``cuda`` by default: the in-process
service, the fleet's card workers, the analytics and verify services, the
stream oracle). Without CUDA the drill exits non-zero before any solve
unless given ``--device cpu``, which runs the kernels' plain PyTorch
versions. Echo workers touch no device. The report's ``config`` and
``gate_metrics.config`` carry ``package: "torch"`` and ``device`` (the
card's name and power limit, or ``cpu``).

    python -m distributed_ghs_implementation_tpu_torch.load_drill --smoke \
        --output load_report.json
    python -m distributed_ghs_implementation_tpu_torch.load_drill --chaos --duration 20
    python -m distributed_ghs_implementation_tpu_torch.load_drill --smoke --no-chaos \
        --fleet 3 --kill-worker 1 --obs-dir fleet_obs --output fleet_kill.json

Exit code 0 iff every check passed (and the gate, when a baseline is given).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device

#: The checkout's root: the package's parent, where ``tools/bench_gate.py``
#: lives and whose ``build/`` holds the kernels every card worker loads.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REPORT_SCHEMA = "ghs-load-report-v1"
WORKLOAD = "gate-load-v1"
WORKLOAD_FLEET = "gate-fleet-v1"
WORKLOAD_FLEET_KILL = "gate-fleet-kill-v1"
WORKLOAD_FLEET_ELASTIC = "gate-fleet-elastic-v1"
WORKLOAD_FLEET_ELASTIC_KILL = "gate-fleet-elastic-kill-v1"
WORKLOAD_FLEET_ROUTER = "gate-fleet-router-v1"
WORKLOAD_FLEET_PARTITION = "gate-fleet-partition-v1"
WORKLOAD_OVERSIZE = "gate-oversize-v1"
WORKLOAD_VERIFY = "gate-verify-v1"
WORKLOAD_KINDS = "gate-analytics-v1"
WORKLOAD_STREAM = "gate-stream-v1"
WORKLOAD_STREAM_FLEET = "gate-stream-fleet-v1"
WORKLOAD_STREAM_KILL = "gate-stream-kill-v1"
WORKLOAD_STREAM_SHARDED = "gate-stream-sharded-drill-v1"
WORKLOAD_STREAM_SHARDED_KILL = "gate-stream-sharded-kill-v1"
# Shape buckets the deck draws from (nodes, edges): hit/miss/batch classes
# stay inside the lane-admission ceiling; oversize deliberately exceeds it.
MISS_SHAPES = ((48, 120), (96, 280), (200, 620))
BATCH_SHAPE = (128, 400)
HIT_SHAPE = (64, 180)
UPDATE_SHAPE = (80, 240)
OVERSIZE_SHAPE = (70_000, 140_000)
STREAM_SHAPE = (128, 384)  # subscribed graphs (--update-heavy)
# --update-heavy --sharded-lane: oversize-by-node-bucket stream seeds —
# past the lane-engine admission ceiling (routes like a billion-edge
# graph), few enough edges to solve in drill time (tests/test_lane.py's
# oversize shape). Streams then run MESH-RESIDENT: windows scatter into
# the lane's donated slots and a kill is recovered by re-stage + replay.
STREAM_SHARDED_SHAPE = (70_000, 3_000)
STREAM_WINDOW_UPDATES = 6  # edge mutations per published window


def _stream_seed_shape(args):
    return STREAM_SHARDED_SHAPE if args.sharded_lane else STREAM_SHAPE


@dataclasses.dataclass
class Arrival:
    """One scheduled query: fire at ``at_s`` (relative to window start)."""

    at_s: float
    cls: str
    request: Optional[dict] = None  # None for update-stream arrivals
    stream: Optional[int] = None  # update-stream id (digest chained)
    updates: Optional[list] = None  # the update ops for a stream arrival


#: Set by main() from ``--wire binary``: solve requests then carry raw
#: u/v/w B-frame sections (Graph.to_wire) instead of the JSON edges list,
#: so the whole deck exercises the binary ingest + opaque-passthrough
#: plane end to end (same digests — the deck stays bit-reproducible).
_WIRE_BINARY = False


def _graph_request(g, cls: str) -> dict:
    if _WIRE_BINARY:
        return {"op": "solve", **g.to_wire(), "slo_class": cls}
    return {
        "op": "solve",
        "num_nodes": g.num_nodes,
        "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)],
        "slo_class": cls,
    }


def _package_fields(device: str) -> dict:
    """What the port adds to a report's ``config`` and its gate metrics'
    ``config``: the package, and the card's name and power limit as
    ``nvidia-smi`` gives them (or ``cpu``)."""
    on_card = resolve_device(device).type == "cuda"
    return {"package": "torch", "device": card_description() if on_card else "cpu"}


# ----------------------------------------------------------------------
# Arrival models (open-loop: schedules are fixed before the first dispatch)
# ----------------------------------------------------------------------
def arrival_times(
    n: int, duration_s: float, model: str, rng: np.random.Generator
) -> np.ndarray:
    """``n`` seeded arrival offsets in ``[0, duration_s)``.

    ``poisson`` — exponential inter-arrival gaps, rescaled to the window
    (open-loop Poisson traffic at the target average rate).
    ``bursty`` — four ON windows separated by silence; arrivals uniform
    inside the ON windows (a thundering-herd shape).
    ``ramp`` — arrival density grows linearly across the window (the
    rate doubles by the end; models a traffic ramp-up).
    """
    if n <= 0:
        return np.empty(0)
    if model == "poisson":
        gaps = rng.exponential(1.0, size=n)
        t = np.cumsum(gaps)
        return t * (duration_s / t[-1])
    if model == "bursty":
        bursts = 4
        on = duration_s / (2 * bursts)
        starts = np.arange(bursts) * (2 * on)
        which = rng.integers(0, bursts, size=n)
        return starts[which] + rng.uniform(0, on, size=n)
    if model == "ramp":
        # Inverse-CDF of a linearly growing rate: t = D * sqrt(u).
        return duration_s * np.sqrt(rng.uniform(0, 1, size=n))
    raise ValueError(f"unknown arrival model {model!r}")


# ----------------------------------------------------------------------
# The scenario deck
# ----------------------------------------------------------------------
def build_deck(args, rng: np.random.Generator):
    """Returns ``(schedule, warm_graphs, stream_seeds, counts)``.

    ``warm_graphs`` are solved before the measured window (cache/bucket
    priming); ``stream_seeds`` seed the update sessions. Every graph is
    seeded from ``args.seed``, so the deck is bit-reproducible.
    """
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )

    D = args.duration
    scale = args.rate / 10.0  # --rate 10 is the smoke deck's reference size
    counts = {
        "hit": max(4, int(30 * scale)),
        "miss": max(3, int(24 * scale)),
        "batch": max(4, int(24 * scale)),
        "dup": max(4, int(12 * scale)),
        "update": max(3, int(15 * scale)),
        "oversize": args.oversize,
    }
    if args.oversize_heavy:
        # The bulk-vs-interactive scenario: enough oversize solves that one
        # is in flight for most of the window, with the interactive classes
        # arriving concurrently — the drill then checks interactive p99
        # stays bounded while bulk work runs (docs/SHARDED_LANE.md).
        counts["oversize"] = max(counts["oversize"], 4)
    schedule: List[Arrival] = []

    # hit: repeats over a small pre-solved pool.
    hit_pool = [
        gnm_random_graph(*HIT_SHAPE, seed=args.seed + 100 + i) for i in range(4)
    ]
    for i, t in enumerate(
        arrival_times(counts["hit"], D, args.arrival, rng)
    ):
        schedule.append(
            Arrival(float(t), "hit", _graph_request(hit_pool[i % 4], "hit"))
        )

    # miss: every query a distinct graph, cycling the shape buckets.
    for i, t in enumerate(
        arrival_times(counts["miss"], D, args.arrival, rng)
    ):
        shape = MISS_SHAPES[i % len(MISS_SHAPES)]
        g = gnm_random_graph(*shape, seed=args.seed + 1000 + i)
        schedule.append(Arrival(float(t), "miss", _graph_request(g, "miss")))

    # batch: same-bucket bursts — distinct digests arriving together so the
    # engine's forming queue actually builds multi-graph lanes.
    n_bursts = max(1, counts["batch"] // 8)
    burst_at = np.linspace(0.15 * D, 0.85 * D, n_bursts)
    for i in range(counts["batch"]):
        g = gnm_random_graph(*BATCH_SHAPE, seed=args.seed + 2000 + i)
        t = float(burst_at[i % n_bursts]) + float(rng.uniform(0, 0.01))
        schedule.append(Arrival(t, "batch", _graph_request(g, "batch")))

    # dup: duplicate-digest storms — each storm is ONE uncached digest
    # fired ~simultaneously; single-flight must answer with one solve.
    n_storms = max(1, counts["dup"] // 6)
    counts["dup"] = n_storms * (counts["dup"] // n_storms)
    storm_at = np.linspace(0.3 * D, 0.7 * D, n_storms)
    for s in range(n_storms):
        g = gnm_random_graph(
            BATCH_SHAPE[0], BATCH_SHAPE[1], seed=args.seed + 3000 + s
        )
        req = _graph_request(g, "dup")
        for k in range(counts["dup"] // n_storms):
            t = float(storm_at[s]) + float(rng.uniform(0, 0.005))
            schedule.append(Arrival(t, "dup", req))

    # update: digest-chained incremental streams (built at dispatch time —
    # each response re-keys the session content-addressed).
    n_streams = 3
    stream_seeds = [
        gnm_random_graph(*UPDATE_SHAPE, seed=args.seed + 4000 + s)
        for s in range(n_streams)
    ]
    for i, t in enumerate(
        arrival_times(counts["update"], D, args.arrival, rng)
    ):
        s = i % n_streams
        n = stream_seeds[s].num_nodes
        a, b = 0, 0
        while a == b:
            a, b = (int(x) for x in rng.integers(0, n, 2))
        kind = "insert" if i % 3 else "reweight"
        upd = {"kind": kind, "u": min(a, b), "v": max(a, b),
               "w": int(rng.integers(1, 100))}
        if kind == "reweight":
            # Reweight an edge that certainly exists: one from the seed.
            j = int(rng.integers(0, stream_seeds[s].num_edges))
            upd["u"] = int(stream_seeds[s].u[j])
            upd["v"] = int(stream_seeds[s].v[j])
        schedule.append(
            Arrival(float(t), "update", stream=s, updates=[upd])
        )

    # oversize: beyond the lane-admission ceiling — must bypass to the
    # single-graph path without stalling small-graph traffic.
    for i, frac in enumerate(np.linspace(0.25, 0.65, counts["oversize"])):
        g = gnm_random_graph(*OVERSIZE_SHAPE, seed=args.seed + 5000 + i)
        schedule.append(
            Arrival(float(frac) * D, "oversize", _graph_request(g, "oversize"))
        )

    schedule.sort(key=lambda a: a.at_s)
    warm_graphs = (
        hit_pool
        + [gnm_random_graph(*s, seed=args.seed + 90) for s in MISS_SHAPES]
        + [gnm_random_graph(*BATCH_SHAPE, seed=args.seed + 91)]
    )
    if counts["oversize"]:  # don't warm a bucket no query will touch
        warm_graphs.append(gnm_random_graph(*OVERSIZE_SHAPE, seed=args.seed + 92))
    return schedule, warm_graphs, stream_seeds, counts


def _stream_window(rng: np.random.Generator, seed_graph, size: int) -> list:
    """One published window, as JSON-ready dicts: the shared seeded
    generator (:func:`stream.window.random_update_stream` — also the
    ``bench.py --update-stream`` workload) with an insert-heavy mix."""
    from distributed_ghs_implementation_tpu_torch.stream.window import (
        random_update_stream,
    )

    window = []
    for upd in random_update_stream(
        rng, seed_graph, size,
        kinds=("insert", "insert", "delete", "reweight"), max_w=200,
    ):
        d = {"kind": upd.kind, "u": upd.u, "v": upd.v}
        if upd.w is not None:
            d["w"] = upd.w
        window.append(d)
    return window


def build_stream_deck(args, rng: np.random.Generator):
    """The ``--update-heavy`` deck: a sustained Poisson stream of window
    publishes against long-lived subscribed graphs, each publish chased by
    a notification poll, over a thin background of cache hits. Returns the
    same ``(schedule, warm_graphs, stream_seeds, counts)`` shape as
    :func:`build_deck`."""
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )

    D = args.duration
    scale = args.rate / 10.0
    shape = _stream_seed_shape(args)
    counts = {
        # Sharded streams publish fewer, heavier windows: each seed solve
        # is a mesh solve and each commit maintains device residency, so
        # the deck trades arrival count for per-window weight.
        "publish": (max(6, int(18 * scale)) if args.sharded_lane
                    else max(9, int(45 * scale))),
        "notify": 0,  # one poll rides along with every publish
        "hit": max(4, int(10 * scale)),
    }
    counts["notify"] = counts["publish"]
    schedule: List[Arrival] = []

    n_streams = args.streams
    stream_seeds = [
        gnm_random_graph(*shape, seed=args.seed + 6000 + s)
        for s in range(n_streams)
    ]
    for i, t in enumerate(
        arrival_times(counts["publish"], D, args.arrival, rng)
    ):
        s = i % n_streams
        schedule.append(Arrival(
            float(t), "publish", stream=s,
            updates=_stream_window(rng, stream_seeds[s],
                                   STREAM_WINDOW_UPDATES),
        ))

    hit_pool = [
        gnm_random_graph(*HIT_SHAPE, seed=args.seed + 100 + i) for i in range(4)
    ]
    for i, t in enumerate(arrival_times(counts["hit"], D, args.arrival, rng)):
        schedule.append(
            Arrival(float(t), "hit", _graph_request(hit_pool[i % 4], "hit"))
        )

    schedule.sort(key=lambda a: a.at_s)
    return schedule, hit_pool, stream_seeds, counts


def _stream_oracle_check(stream_root: str, streams, device=None) -> dict:
    """Client-side durability audit, run AFTER the counter snapshots: for
    every stream, rebuild the head from the on-disk snapshot + WAL alone
    (the inheritor's exact recovery path, replayed in this process on
    ``device``), then solve the rebuilt graph fresh and require the
    maintained forest edge-exact against that oracle. Proves the durable
    artifacts — not just the live sessions — carry every stream through a
    crash."""
    from distributed_ghs_implementation_tpu_torch.api import (
        minimum_spanning_forest,
    )
    from distributed_ghs_implementation_tpu_torch.stream.log import UpdateLog
    from distributed_ghs_implementation_tpu_torch.stream.window import WindowedMST

    out = {"streams": len(streams), "rebuilt": 0, "head_match": 0,
           "edge_exact": 0}
    for state in streams:
        snap, entries, _notes = UpdateLog(stream_root, state.stream).load()
        if snap is None:
            continue
        mst = WindowedMST.from_state(snap, window_mode="batched", device=device)
        chain = snap["digest"]
        intact = True
        for entry in entries:
            if entry["prev"] != chain:
                intact = False
                break
            result, _info = mst.apply_window(entry["updates"])
            chain = result.graph.digest()
            if chain != entry["digest"]:
                intact = False
                break
        if not intact:
            continue
        out["rebuilt"] += 1
        if chain == state.digest:
            out["head_match"] += 1
        rebuilt = mst.result()
        oracle = minimum_spanning_forest(
            rebuilt.graph, backend="device", device=device
        )
        if np.array_equal(
            np.sort(np.asarray(rebuilt.edge_ids)),
            np.sort(np.asarray(oracle.edge_ids)),
        ):
            out["edge_exact"] += 1
    return out


# ----------------------------------------------------------------------
# Execution
# ----------------------------------------------------------------------
class _SubState:
    """One subscribed stream, client side: the digest-chain head plus the
    subscriber's notification cursor and integrity ledger (every sequence
    number observed via poll — the gap/duplicate check's input)."""

    __slots__ = ("stream", "digest", "lock", "after_seq", "seen", "resets",
                 "head_seq")

    def __init__(self, stream: str, digest: str, seq: int):
        self.stream = stream
        self.digest = digest
        self.lock = threading.Lock()
        self.after_seq = seq
        self.seen: List[int] = []
        self.resets = 0
        self.head_seq = seq


class _StreamState:
    __slots__ = ("digest", "lock", "seed_request")

    def __init__(self, digest: str, seed_request: Optional[dict] = None):
        self.digest = digest
        self.lock = threading.Lock()
        # Fleet mode: a worker crash loses its materialized update
        # sessions; a client re-subscribes by re-solving its seed graph.
        self.seed_request = seed_request


def run_window(service, schedule, streams, args, chaos_plan, arm_chaos):
    """Dispatch the schedule open-loop; returns client-side records + wall.

    Latency is measured from the SCHEDULED arrival instant (not dispatch),
    so client-pool backlog counts against the service — the open-loop
    convention that makes queueing delay visible. ``arm_chaos(plan)``
    applies one chaos-plan entry (in-process fault arming, or fleet-worker
    arming/kill over the control pipe).
    """
    records: List[dict] = []
    records_lock = threading.Lock()

    t0 = time.perf_counter()

    def fire(arrival: Arrival) -> None:
        scheduled = t0 + arrival.at_s
        reset = False
        try:
            if arrival.stream is not None and isinstance(
                streams[arrival.stream], _SubState
            ):
                # --update-heavy: publish one window against the stream
                # head, then poll for its notification — the poll is the
                # subscriber-visible event whose latency the report's
                # "notify" class measures (scheduled arrival -> poll
                # answered), and whose sequence numbers feed the
                # gap/duplicate ledger.
                state = streams[arrival.stream]
                with state.lock:
                    response = service.handle({
                        "op": "publish",
                        "stream": state.stream,
                        "digest": state.digest,
                        "updates": arrival.updates,
                        "slo_class": arrival.cls,
                    })
                    if response.get("ok"):
                        state.digest = response["digest"]
                    elif response.get("stale") and response.get("digest"):
                        # The chain moved under us (a failover replayed
                        # past our head): adopt the reported head. The
                        # window itself may or may not have committed —
                        # the poll below reconciles via sequence numbers.
                        state.digest = response["digest"]
                        state.resets += 1
                        reset = True
                    ok = bool(response.get("ok"))
                    err = response.get("error")
                    publish_done = time.perf_counter()
                    poll = service.handle({
                        "op": "poll",
                        "stream": state.stream,
                        "digest": state.digest,
                        "after_seq": state.after_seq,
                        "slo_class": "notify",
                    })
                    poll_ok = bool(poll.get("ok"))
                    if poll_ok:
                        for note in poll.get("notifications", []):
                            state.seen.append(int(note["seq"]))
                            state.after_seq = max(state.after_seq,
                                                  int(note["seq"]))
                        state.head_seq = max(state.head_seq,
                                             int(poll.get("seq", 0)))
                now = time.perf_counter()
                with records_lock:
                    records.append(
                        {"cls": arrival.cls, "ok": ok, "lost": False,
                         "reset": reset, "error": err,
                         "latency_s": publish_done - scheduled}
                    )
                    records.append(
                        {"cls": "notify", "ok": poll_ok, "lost": False,
                         "reset": False, "extra": True,
                         "error": poll.get("error"),
                         "latency_s": now - scheduled}
                    )
                return
            if arrival.stream is not None:
                state = streams[arrival.stream]
                with state.lock:
                    response = service.handle(
                        {
                            "op": "update",
                            "digest": state.digest,
                            "updates": arrival.updates,
                            "slo_class": arrival.cls,
                        }
                    )
                    if response.get("ok"):
                        state.digest = response["digest"]
                    elif (
                        state.seed_request is not None
                        and "no session" in str(response.get("error", ""))
                    ):
                        # The worker holding this stream's session died:
                        # the update was ANSWERED (not lost), and the
                        # client re-subscribes from its seed graph.
                        reseed = service.handle(dict(state.seed_request))
                        if reseed.get("ok"):
                            state.digest = reseed["digest"]
                            reset = True
            else:
                response = service.handle(arrival.request)
            ok = bool(response.get("ok"))
        except Exception as e:  # noqa: BLE001 — a lost query, recorded
            with records_lock:
                records.append(
                    {"cls": arrival.cls, "ok": False, "lost": True,
                     "error": f"{type(e).__name__}: {e}",
                     "latency_s": time.perf_counter() - scheduled}
                )
            return
        with records_lock:
            records.append(
                {"cls": arrival.cls, "ok": ok, "lost": False, "reset": reset,
                 "error": response.get("error"),
                 "latency_s": time.perf_counter() - scheduled}
            )

    chaos_armed: List[dict] = []
    next_chaos = 0
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        futures = []
        for arrival in schedule:
            while (
                next_chaos < len(chaos_plan)
                and arrival.at_s >= chaos_plan[next_chaos]["at_s"]
            ):
                # Chaos lands MID-FLIGHT, between dispatches: earlier
                # queries are still in the pool when the faults arm.
                plan = chaos_plan[next_chaos]
                arm_chaos(plan)
                chaos_armed.append(plan)
                next_chaos += 1
            delay = (t0 + arrival.at_s) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(fire, arrival))
        for f in futures:
            f.result()  # fire() never raises; this rejoins the pool
    wall_s = time.perf_counter() - t0
    return records, wall_s, chaos_armed


def client_summary(records, wall_s) -> dict:
    """The stopwatch cross-check: same schema, client-side measurements."""
    from distributed_ghs_implementation_tpu_torch.obs import slo

    stats = slo.ClassStats()
    for rec in records:
        stats.observe(rec["cls"], rec["latency_s"], ok=rec["ok"])
    return slo.assemble(stats, wall_s=wall_s)


# ----------------------------------------------------------------------
# The drill
# ----------------------------------------------------------------------
def _read_exported_counters(obs_dir, wid, incarnation) -> Optional[dict]:
    """A drained worker's process counters, recovered from the obs JSONL
    it exported on exit (``worker<K>.<incarnation>.jsonl`` header)."""
    if not obs_dir or incarnation is None:
        return None
    path = os.path.join(obs_dir, f"worker{wid}.{incarnation}.jsonl")
    try:
        from distributed_ghs_implementation_tpu_torch.obs.export import (
            read_events_jsonl,
        )

        _events, meta = read_events_jsonl(path)
    except (OSError, ValueError):
        return None
    counters = meta.get("counters")
    # A file without its trailing totals line (torn export) has no
    # counters — that is a miss, not an empty-but-trustworthy zero.
    return dict(counters) if isinstance(counters, dict) else None


def _fleet_worker_counters(router, obs_dir=None) -> "tuple[dict, List[str]]":
    """Per-``(worker_id, incarnation)`` counter snapshots across the
    fleet's live workers (each worker has its own bus; the router's stats
    op fans out with the incarnation alongside). Also returns the ids of
    live workers that did NOT answer the fan-out — a wedged worker's
    counters silently reading as zero would let the exact-gated checks
    (fresh solves, chain evictions) pass vacuously, so the caller must
    surface a miss as a failed check, never as zeros.

    Keyed by incarnation so window deltas stay honest across a kill: a
    restarted worker is a *new* key with no pre-window baseline, and
    every counter it accumulates — fresh solves included — lands in the
    window delta in full. Subtracting summed totals instead would let
    the victim's vanished pre-kill counters cancel real post-restart
    activity (the drill's "zero fresh solves" gate could pass vacuously)."""
    stats = router.handle({"op": "stats"})
    out, missing = {}, []
    for wid, info in (stats.get("workers") or {}).items():
        if info.get("retired") or info.get("draining"):
            # A planned departure (elastic scale-down) flushed its
            # counters to the obs export on drain — recover them from
            # there so the window delta keeps the retiree's activity. A
            # retiree with no readable export would silently zero out of
            # every exact-gated check (fresh solves, chain evictions), so
            # that is a MISS the caller must surface, never a zero.
            counters = _read_exported_counters(
                obs_dir, wid, info.get("incarnation")
            )
            if counters is None:
                missing.append(f"{wid} (retired, no obs export)")
            else:
                out[(wid, info.get("incarnation"))] = counters
            continue
        wstats = info.get("stats")
        if not wstats:
            missing.append(wid)
            continue
        out[(wid, info.get("incarnation"))] = dict(
            wstats.get("counters") or {}
        )
    return out, missing


def _window_counter_delta(pre: dict, post: dict) -> dict:
    """Summed per-incarnation counter deltas for the measured window."""
    window: dict = {}
    for key, counters in post.items():
        base = pre.get(key, {})
        for name, value in counters.items():
            window[name] = window.get(name, 0) + value - base.get(name, 0)
    return window


def _spawn_listen_workers(n: int):
    """N externally started ``fleet.worker --listen`` echo processes —
    the topology that SURVIVES a router death (``--kill-router`` /
    ``--partition``): a spawned pipe/TCP worker dies with the router's
    pipes, but a --listen worker just returns to accept() with its
    caches warm and waits for the successor to dial."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
    )}
    procs, addrs = [], []
    for wid in range(n):
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_ghs_implementation_tpu_torch.fleet.worker",
             "--worker-id", str(wid), "--test-echo",
             "--listen", "127.0.0.1:0"],
            stderr=subprocess.PIPE, env=env,
        )
        line = proc.stderr.readline().decode()
        if "listening on" not in line:
            for p in procs + [proc]:
                p.kill()
            raise RuntimeError(f"worker {wid} never listened: {line!r}")
        procs.append(proc)
        addrs.append(line.rsplit(" ", 1)[-1].strip())
    return procs, addrs


class _RouterProxy:
    """The clients' handle — survives a router swap (``--kill-router``).

    A real deployment's clients reconnect and retry when the router dies;
    here the proxy does the same: a ``router crashed`` response (or a
    request refused during the downtime window) waits for the successor
    and retries ONCE. The retry is safe by the same idempotency the
    worker re-queue relies on: results are content-addressed, so the
    worst case is a warm cache hit for work the journal replay already
    re-ran."""

    def __init__(self, router):
        import threading

        self._router = router
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._ready.set()
        self.retries = 0

    @property
    def router(self):
        with self._lock:
            return self._router

    def swap_begin(self):
        self._ready.clear()

    def swap(self, new_router):
        with self._lock:
            self._router = new_router
        self._ready.set()

    def handle(self, request: dict) -> dict:
        response = self.router.handle(request)
        err = str(response.get("error", ""))
        if not response.get("ok") and (
            response.get("router_crashed")
            or (not self._ready.is_set() and "shutting down" in err)
        ):
            if self._ready.wait(timeout=120.0):
                with self._lock:
                    self.retries += 1
                response = self.router.handle(request)
        return response

    def __getattr__(self, name):
        # Everything that is not the request path (stats fan-outs,
        # pool_size, arm_worker_fault, shutdown) hits the live router.
        return getattr(self.router, name)


def run_drill(args) -> dict:
    """Run the drill with teardown guaranteed: the fleet drains (flushing
    in-flight responses + per-worker obs exports) and its temporary shared
    store is removed even when the drill body raises."""
    import shutil

    resources: dict = {}
    report = None
    try:
        report = _run_drill(args, resources)
        return report
    finally:
        autoscaler = resources.get("autoscaler")
        if autoscaler is not None:
            autoscaler.close()
        router = resources.get("router")
        if router is not None:
            router.shutdown()
        for proc in resources.get("listen_procs", []):
            try:
                proc.wait(timeout=10)  # shutdown drained it: exit 0
            except Exception:  # noqa: BLE001 — teardown must not raise
                proc.kill()
        # Trace assembly has to wait until here: the drain above is what
        # flushes every worker's JSONL into --trace-dir, and the router's
        # own export should include the retire/drain spans too.
        if report is not None and getattr(args, "trace_dir", None):
            _merge_trace_artifacts(args, report)
        for key in ("disk_tmp", "stream_tmp", "journal_tmp"):
            tmp = resources.get(key)
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)


def _merge_trace_artifacts(args, report: dict) -> None:
    """Post-drain assembly for ``--trace-dir``: export the router's bus
    beside the workers' JSONL dumps, merge them into one Perfetto trace +
    critical-path report, and promote the join-quality numbers
    (``orphan_spans``, ``traces_joined``) into the gated metrics."""
    import glob

    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.obs.export import (
        write_events_jsonl,
        write_merged_trace,
    )

    write_events_jsonl(
        BUS, os.path.join(args.trace_dir, "router.jsonl"), label="router"
    )
    paths = sorted(
        p for p in glob.glob(os.path.join(args.trace_dir, "*.jsonl"))
        if os.path.basename(p) != "exemplars.jsonl"
    )
    merged = write_merged_trace(
        paths,
        os.path.join(args.trace_dir, "merged_trace.json"),
        os.path.join(args.trace_dir, "critical_path.json"),
    )
    report["trace"] = {
        "dir": args.trace_dir,
        "inputs": [os.path.basename(p) for p in paths],
        "processes": len(merged["processes"]),
        "traces_total": merged["traces_total"],
        "traces_rooted": merged["traces_rooted"],
        "traces_joined": merged["traces_joined"],
        "orphan_spans": merged["orphan_spans"],
        "critical_path": merged["critical_path"]["summary"],
    }
    gate = report.get("gate_metrics")
    if isinstance(gate, dict) and isinstance(gate.get("metrics"), dict):
        gate["metrics"]["orphan_spans"] = merged["orphan_spans"]
        gate["metrics"]["traces_joined"] = merged["traces_joined"]


def _run_drill(args, resources: dict) -> dict:
    import tempfile

    from distributed_ghs_implementation_tpu_torch.obs import slo
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.obs.export import write_events_jsonl
    from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

    BUS.enable()
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        if not args.obs_dir:
            # The per-worker obs JSONL exports double as the trace-merge
            # inputs, so an unset --obs-dir lands them in the trace dir.
            args.obs_dir = args.trace_dir
    rng = np.random.default_rng(args.seed)
    deck = build_stream_deck if args.update_heavy else build_deck
    schedule, warm_graphs, stream_seeds, counts = deck(args, rng)
    stream_tmp = None
    if args.update_heavy:
        # The durable stream layer under test: shared across fleet workers
        # so failover recovery is snapshot+WAL replay, never a re-solve.
        stream_tmp = resources["stream_tmp"] = tempfile.mkdtemp(
            prefix="ghs-stream-log-"
        )

    fleet_router = None
    proxy = None
    listen_addrs = ()
    journal_tmp = None
    disaster = args.kill_router or args.partition is not None
    if args.fleet and disaster:
        # The disaster modes run against externally spawned --listen echo
        # workers: the one topology whose workers OUTLIVE the router, so
        # a router death (or a healed partition) re-adopts the same warm
        # processes instead of cold-spawning new ones.
        procs, listen_addrs = _spawn_listen_workers(args.fleet)
        resources["listen_procs"] = procs
        if args.kill_router:
            journal_tmp = resources["journal_tmp"] = tempfile.mkdtemp(
                prefix="ghs-router-journal-"
            )
    if args.fleet:
        from distributed_ghs_implementation_tpu_torch.fleet.router import (
            FleetConfig,
            FleetRouter,
        )

        resources["disk_tmp"] = tempfile.mkdtemp(prefix="ghs-fleet-store-")
        config = FleetConfig(
            workers=args.fleet,
            remote_workers=tuple(listen_addrs),
            # Durable accepted-work journal: the successor router replays
            # it (--kill-router proves the whole cycle).
            journal_dir=journal_tmp,
            # Transport chaos wrapping (--partition drives it); a short
            # lease so the one-way partition is detected inside the
            # window (the socket never EOFs — silence is the only
            # signal), but not SO short that a healthy worker's read loop
            # stalling on one oversize frame parse reads as silence — the
            # no-lease-trip-on-the-healthy-side check is the point.
            chaos=args.partition is not None,
            heartbeat_interval_s=(
                0.1 if args.partition is not None else 0.25
            ),
            lease_s=(1.5 if args.partition is not None else None),
            # The transport under test: "pipe" (subprocess pipes)
            # or "tcp" (localhost sockets through fleet/transport.py —
            # dial-in hello registration, coalesced pipelined writes,
            # connection-loss death detection). Same deck, same checks;
            # the per-class router_hop_s section is the pipe-vs-TCP
            # overhead number.
            transport=args.transport,
            test_echo=args.test_echo,
            # Mixed-build fleets: the named worker spawns as a legacy
            # build (hello without caps.wire), so its connection degrades
            # binary dispatches to folded JSON while siblings stay opaque.
            worker_env=(
                {args.wire_legacy_worker: {"GHS_FLEET_WIRE": "0"}}
                if args.wire_legacy_worker is not None else None
            ),
            batch_lanes=0 if args.test_echo else args.lanes,
            batch_wait_s=args.batch_wait,
            max_sessions=256,
            store_capacity=max(256, len(schedule)),
            # Bare --sharded-lane: every worker owns a mesh lane and the
            # router steers oversize digests at lane workers.
            sharded_lane_workers=(-1 if args.sharded_lane else 0),
            # The SHARED persistent layer: a restarted worker re-serves its
            # keyspace from disk hits instead of re-solving everything.
            disk_dir=resources["disk_tmp"],
            obs_dir=args.obs_dir,
            request_timeout_s=max(120.0, 12 * args.duration),
            stream_dir=stream_tmp,
            stream_snapshot_every=4,
            # Workers AOT-warm the window kernels for the subscribed shape
            # (and the next edge bucket up, where inserts land) so the
            # first committed window pays no jit tracing.
            warmup_stream_buckets=(
                f"{_stream_seed_shape(args)[0]}x{_stream_seed_shape(args)[1]},"
                f"{_stream_seed_shape(args)[0]}x"
                f"{2 * _stream_seed_shape(args)[1]}"
                if args.update_heavy else None
            ),
            # The workers' device, and the tree's build cache, so that
            # card workers load the kernels this checkout built.
            device=args.device,
            compile_cache_dir=os.path.join(ROOT, "build"),
        )
        fleet_router = FleetRouter(config).start()
        if args.kill_router:
            proxy = fleet_router = _RouterProxy(fleet_router)
        service = fleet_router
        resources["router"] = fleet_router
    else:
        from distributed_ghs_implementation_tpu_torch.serve.service import MSTService

        service = MSTService(
            batch_lanes=args.lanes,
            batch_wait_s=args.batch_wait,
            max_sessions=256,  # solve seeds must not LRU-evict update sessions
            store_capacity=max(256, len(schedule)),
            sharded_lane=(True if args.sharded_lane == -1
                          else max(0, args.sharded_lane)),
            stream_dir=stream_tmp,
            stream_snapshot_every=4,
            device=args.device,
        )

    # Warm phase: prime every bucket the deck touches (compiles, rank
    # caches, the hit pool, update sessions) OUTSIDE the measured window —
    # sustained-load numbers should show steady-state serving, and the
    # compile.* counters inside the window then expose any request-time
    # compile as the anomaly it is.
    t_warm = time.perf_counter()
    if args.update_heavy and fleet_router is None:
        from distributed_ghs_implementation_tpu_torch.stream.window import (
            warm_window_kernels,
        )

        warm_window_kernels(*_stream_seed_shape(args), device=args.device)
        warm_window_kernels(
            _stream_seed_shape(args)[0], 2 * _stream_seed_shape(args)[1],
            device=args.device,
        )
    for g in warm_graphs:
        service.handle(_graph_request(g, "warm"))
    stream_digests = []
    for g in stream_seeds:
        response = service.handle(_graph_request(g, "warm"))
        if not response.get("ok"):
            raise RuntimeError(f"warm solve failed: {response.get('error')}")
        stream_digests.append(response["digest"])
    if args.update_heavy:
        # Subscribe each stream (still inside the warm phase): the seed
        # snapshot lands on disk and the subscriber cursor starts at the
        # returned head sequence.
        streams = []
        for d in stream_digests:
            sub = service.handle(
                {"op": "subscribe", "digest": d, "slo_class": "warm"}
            )
            if not sub.get("ok"):
                raise RuntimeError(f"subscribe failed: {sub.get('error')}")
            streams.append(
                _SubState(sub["stream"], sub["digest"], int(sub["seq"]))
            )
    else:
        streams = [
            _StreamState(
                d,
                seed_request=(
                    _graph_request(g, "update") if fleet_router is not None
                    else None
                ),
            )
            for d, g in zip(stream_digests, stream_seeds)
        ]
    warm_s = time.perf_counter() - t_warm

    # Chaos plan: transient faults armed mid-flight (seeded offsets). The
    # supervisor ladder + batch retry must absorb them — degraded latency
    # is expected, lost accepted queries are not. In fleet mode the faults
    # arm INSIDE the workers over the control pipe; ``--kill-worker`` adds
    # the fleet.worker.crash entry (the worker dies in place of its next
    # request — no response flushed, the router must re-queue).
    chaos_plan = []
    if not args.no_chaos:
        chaos_plan.append(
            {
                "at_s": 0.5 * args.duration,
                "sites": {"resilience.attempt.device": 2, "batch.attempt": 1},
            }
        )
        if args.chaos:
            chaos_plan.append(
                {
                    "at_s": 0.7 * args.duration,
                    "sites": {"resilience.attempt.device": 4, "batch.attempt": 2},
                }
            )
    if fleet_router is not None and args.kill_worker is not None:
        chaos_plan.append(
            {"at_s": 0.45 * args.duration, "kill_worker": args.kill_worker}
        )
    if fleet_router is not None and args.kill_router:
        chaos_plan.append({"at_s": 0.45 * args.duration, "kill_router": True})
    if fleet_router is not None and args.partition is not None:
        chaos_plan.append(
            {"at_s": 0.45 * args.duration, "partition": args.partition}
        )
    chaos_plan.sort(key=lambda plan: plan["at_s"])

    crash_info: dict = {}

    def do_router_crash() -> None:
        """Kill the router with accepted work provably outstanding, then
        boot its successor on the same journal + worker endpoints."""
        from distributed_ghs_implementation_tpu_torch.fleet.journal import (
            RouterJournal,
        )
        from distributed_ghs_implementation_tpu_torch.fleet.router import (
            FleetRouter,
        )

        old = proxy.router
        pre_stats = old.handle({"op": "stats"})
        crash_info["pre_handled"] = (
            pre_stats.get("counters", {}).get("echo.handled", 0)
        )
        # Guarantee accepted-work-outstanding at the crash instant: one
        # slow echo solve is in flight (journaled, unanswered) when the
        # router dies — the exact shape the journal exists for.
        slow = threading.Thread(target=service.handle, args=(
            {"op": "solve", "digest": f"orphan-{args.seed}",
             "sleep_s": 1.5, "slo_class": "miss"},
        ), daemon=True)
        slow.start()
        crash_info["extra_requests"] = 1
        time.sleep(0.3)
        proxy.swap_begin()
        t0 = time.perf_counter()
        old.crash()
        crash_info["orphans_at_crash"] = len(
            RouterJournal(journal_tmp).load().unanswered
        )
        successor = FleetRouter(config).start()
        proxy.swap(successor)
        crash_info["restart_s"] = time.perf_counter() - t0

    def do_partition(victim: int) -> None:
        fleet_router.partition_worker(victim, mode="oneway")
        crash_info["partitioned_at"] = time.perf_counter()

        def heal() -> None:
            fleet_router.heal_partition(victim)
            crash_info["healed_at"] = time.perf_counter()

        timer = threading.Timer(args.partition_duration, heal)
        timer.daemon = True
        timer.start()

    def arm_chaos(plan: dict) -> None:
        if fleet_router is not None:
            for site, times in plan.get("sites", {}).items():
                for wid in range(args.fleet):
                    fleet_router.arm_worker_fault(wid, site=site, times=times)
            if "kill_worker" in plan:
                fleet_router.arm_worker_fault(
                    plan["kill_worker"], site="fleet.worker.crash", times=1
                )
            if plan.get("kill_router"):
                # The crash + successor boot runs off-thread so arrivals
                # keep firing THROUGH the outage (that is the test).
                threading.Thread(
                    target=do_router_crash, name="drill-router-crash",
                    daemon=True,
                ).start()
            if "partition" in plan:
                do_partition(plan["partition"])
        else:
            for site, times in plan.get("sites", {}).items():
                FAULTS.arm(site, times=times)

    # A pre-window stats miss is the SAFE direction (the delta over-counts
    # that worker), so it doesn't gate; a post-window miss does.
    pre_window = (
        _fleet_worker_counters(fleet_router, args.obs_dir)[0]
        if fleet_router is not None
        else {}
    )
    BUS.clear()  # the measured window starts here
    autoscaler = None
    elastic_policy = None
    if fleet_router is not None and args.elastic:
        from distributed_ghs_implementation_tpu_torch.fleet.autoscaler import (
            Autoscaler,
            ElasticPolicy,
        )

        # Deterministic by construction: a ZERO wait budget means any
        # class-tagged request breaches, so the ramp provokes exactly
        # (max - fleet) scale-ups (one per cooldown, stopping at max) and
        # post-window idle drains exactly (max - min) retires. The drill
        # is proving the machinery — warm joins, lossless retires — not
        # tuning thresholds; production budgets live in ElasticPolicy
        # defaults / the serve CLI flags.
        elastic_policy = ElasticPolicy(
            min_workers=(args.elastic_min
                         if args.elastic_min is not None
                         else max(1, args.fleet - 1)),
            max_workers=(args.elastic_max
                         if args.elastic_max is not None
                         else args.fleet + 1),
            tick_s=0.25,
            cooldown_s=1.0,
            wait_budget_s=0.0,
            idle_ticks=10,  # 2.5s of silence = the window is over
        )
        autoscaler = Autoscaler(fleet_router, elastic_policy).start()
        resources["autoscaler"] = autoscaler
    try:
        records, wall_s, chaos_armed = run_window(
            service, schedule, streams, args, chaos_plan, arm_chaos
        )
    finally:
        FAULTS.reset()

    # Elastic convergence: the up decisions fire during the ramp, but a
    # warm join (spawn + pre-seed + warmup ladder) may outlive the window
    # — wait for the pool to reach max, then for post-window idle to
    # drain it back to min, then STOP the autoscaler so the recovery
    # probes below (real traffic) cannot provoke extra scale events and
    # break the exact counts the gate pins.
    elastic = None
    if autoscaler is not None:
        def _wait_pool(target: int, timeout_s: float) -> bool:
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                if fleet_router.pool_size() == target:
                    return True
                time.sleep(0.1)
            return fleet_router.pool_size() == target

        reached_max = _wait_pool(elastic_policy.max_workers, 240.0)
        reached_min = _wait_pool(elastic_policy.min_workers, 120.0)
        autoscaler.close()
        # Let an in-flight retire's accounting land before counters read.
        deadline = time.perf_counter() + 10.0
        expected_downs = (
            elastic_policy.max_workers - elastic_policy.min_workers
        )
        while (time.perf_counter() < deadline
               and BUS.counters().get("fleet.scale.down", 0)
               < expected_downs):
            time.sleep(0.05)
        elastic = {
            "policy": {
                "min_workers": elastic_policy.min_workers,
                "max_workers": elastic_policy.max_workers,
                "cooldown_s": elastic_policy.cooldown_s,
                "idle_ticks": elastic_policy.idle_ticks,
            },
            "reached_max": reached_max,
            "reached_min": reached_min,
            "final_pool": fleet_router.pool_size(),
            "decisions": list(autoscaler.decisions),
        }

    # Kill-drill recovery: wait for the dead worker to restart and rejoin
    # the ring, then drive a probe query onto it — "goodput recovery" is a
    # query actually served by the restarted process, not just a counter.
    # In elastic mode the scale-down may legitimately have RETIRED the
    # restarted victim (a fresh incarnation has the least affinity), so
    # the ring-heal + probe-at-victim checks don't apply there; the
    # elastic checks pin pool convergence instead.
    rejoined = None
    probe = None
    if (fleet_router is not None and args.kill_worker is not None
            and not args.elastic):
        rejoined = False
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            stats = fleet_router.handle({"op": "stats"})
            if sorted(stats.get("ring", [])) == list(range(args.fleet)):
                rejoined = True
                break
            time.sleep(0.25)
        if rejoined and not args.update_heavy:
            from distributed_ghs_implementation_tpu_torch.fleet.hashing import (
                HashRing,
            )
            from distributed_ghs_implementation_tpu_torch.graphs.generators import (
                gnm_random_graph,
            )

            ring = HashRing(
                range(args.fleet),
                replicas=fleet_router.config.ring_replicas,
            )
            hint = next(
                f"probe-{i}" for i in range(10_000)
                if ring.assign(f"probe-{i}") == args.kill_worker
            )
            probe_req = _graph_request(
                gnm_random_graph(*HIT_SHAPE, seed=args.seed + 7), "probe"
            )
            probe_req["digest"] = hint  # route straight at the rejoiner
            probe = service.handle(probe_req)

    # Router-crash recovery (--kill-router): wait for the successor's
    # journal replay to answer every orphaned accept, then read the
    # warm-re-adoption evidence (same worker processes => echo.handled
    # persists across the crash).
    router_recovery = None
    if fleet_router is not None and args.kill_router:
        stats = {}
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            stats = fleet_router.handle({"op": "stats"})
            if stats.get("journal", {}).get("unanswered", 1) == 0:
                break
            time.sleep(0.1)
        counters_bus = BUS.counters()
        router_recovery = {
            "restart_s": crash_info.get("restart_s"),
            "orphans_at_crash": crash_info.get("orphans_at_crash", 0),
            "journal_unanswered": stats.get("journal", {}).get(
                "unanswered", -1
            ),
            "journal_accepted": stats.get("journal", {}).get("accepted", 0),
            "pre_handled": crash_info.get("pre_handled", 0),
            "post_handled": stats.get("counters", {}).get(
                "echo.handled", 0
            ),
            "readopted": int(
                counters_bus.get("fleet.router.restart.readopted", 0)
            ),
            "requeued": int(
                counters_bus.get("fleet.router.restart.requeued", 0)
            ),
            "replayed": int(
                counters_bus.get("fleet.router.restart.replayed", 0)
            ),
            "crashes": int(counters_bus.get("fleet.router.crash", 0)),
            "client_retries": proxy.retries,
            "ring": sorted(stats.get("ring", [])),
        }

    # Partition recovery (--partition): wait for the healed link's redial
    # to put the victim back on the ring, then read the healthy-side
    # evidence (survivors never restarted, never tripped a lease).
    partition_recovery = None
    if fleet_router is not None and args.partition is not None:
        victim = args.partition
        stats = {}
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            stats = fleet_router.handle({"op": "stats"})
            if sorted(stats.get("ring", [])) == list(range(args.fleet)):
                break
            time.sleep(0.1)
        counters_bus = BUS.counters()
        workers_out = stats.get("workers") or {}
        partition_recovery = {
            "victim": victim,
            "mode": "oneway",
            "duration_s": args.partition_duration,
            "ring_healed": sorted(stats.get("ring", []))
            == list(range(args.fleet)),
            "victim_restarts": int(
                workers_out.get(str(victim), {}).get("restarts", 0)
            ),
            "healthy_restarts": sum(
                int(info.get("restarts", 0))
                for wid, info in workers_out.items()
                if int(wid) != victim
            ),
            "lease_expired": int(
                counters_bus.get("fleet.lease.expired", 0)
            ),
            "frames_dropped": int(
                counters_bus.get("fleet.chaos.dropped", 0)
            ),
            "post_handled": stats.get("counters", {}).get(
                "echo.handled", 0
            ),
        }

    # Stream recovery + drain (--update-heavy): after a kill, one more
    # published window per stream proves the restarted fleet serves the
    # chain (recovery = snapshot+WAL replay, asserted below via the
    # stream.replay.* / fresh-solve counters); then a final poll per
    # stream drains remaining notifications so the gap/duplicate ledger
    # is complete through the head sequence.
    recovery = None
    stream_drain = 0
    notify_gaps = notify_dups = drain_errors = 0
    if args.update_heavy:
        from distributed_ghs_implementation_tpu_torch.stream.session import (
            poll_gap_check,
        )

        if fleet_router is not None and (
            args.kill_worker is not None or args.elastic
        ):
            # After a kill OR an elastic retire, the streams' pins moved:
            # one more published window per stream proves the inheritor
            # serves the chain (recovered by snapshot+WAL replay, never a
            # fresh solve — the counters below assert it).
            recovery = []
            for s, state in enumerate(streams):
                t_r = time.perf_counter()
                attempts = 0
                with state.lock:
                    for _attempt in range(2):
                        attempts += 1
                        resp = service.handle({
                            "op": "publish",
                            "stream": state.stream,
                            "digest": state.digest,
                            "updates": _stream_window(
                                rng, stream_seeds[s], STREAM_WINDOW_UPDATES
                            ),
                            "slo_class": "publish",
                        })
                        if resp.get("stale") and resp.get("digest"):
                            # The crash landed between WAL append and the
                            # response: the window IS committed and replay
                            # moved the head past ours. Adopt and retry.
                            state.digest = resp["digest"]
                            continue
                        if resp.get("ok"):
                            state.digest = resp["digest"]
                        break
                recovery.append({
                    "ok": bool(resp.get("ok")),
                    "recover_s": time.perf_counter() - t_r,
                    "worker": resp.get("worker"),
                    "requests": attempts,
                })
        for state in streams:
            with state.lock:
                poll = service.handle({
                    "op": "poll",
                    "stream": state.stream,
                    "digest": state.digest,
                    "after_seq": state.after_seq,
                    "slo_class": "notify",
                })
                stream_drain += 1
                if poll.get("ok"):
                    for note in poll.get("notifications", []):
                        state.seen.append(int(note["seq"]))
                        state.after_seq = max(
                            state.after_seq, int(note["seq"])
                        )
                    state.head_seq = max(
                        state.head_seq, int(poll.get("seq", 0))
                    )
                else:
                    # A failed drain leaves state.head_seq stale, which
                    # would let poll_gap_check pass vacuously — count it
                    # so the gap/duplicate verdict can't silently rest on
                    # an incomplete ledger.
                    drain_errors += 1
            check = poll_gap_check(state.seen, state.head_seq)
            notify_gaps += check["gaps"]
            notify_dups += check["dups"]

    # Server-side accounting: the per-class join over real bus events (the
    # router's fleet.request spans in fleet mode — which then carry the
    # per-worker breakdown).
    summary = slo.summarize_bus(BUS, wall_s=wall_s)
    client = client_summary(records, wall_s)
    router_hop = {}
    if fleet_router is not None:
        # Router-hop latency (send-to-response minus in-worker service
        # time — transport + queueing overhead) joins the shared SLO
        # section per class, so pipe-vs-TCP cost is a tracked number in
        # every fleet report.
        for name, hist in BUS.histograms().items():
            if not name.startswith("fleet.hop_s") or not hist.get("count"):
                continue
            cls = name[len("fleet.hop_s."):] if name != "fleet.hop_s" else None
            if cls is None:
                summary["totals"]["router_hop_s"] = hist
                router_hop = hist
            elif cls in summary["classes"]:
                summary["classes"][cls]["router_hop_s"] = hist
    if fleet_router is not None:
        # Worker counters live in the worker processes; the window's share
        # is the post-minus-pre delta per (worker, incarnation). A killed
        # worker's pre-kill counters die with it (unobservable), but its
        # restarted incarnation starts from a zero baseline, so anything
        # it does during the window — a fresh solve where replay was
        # promised — shows up undiminished.
        post_window, stats_missing = _fleet_worker_counters(
            fleet_router, args.obs_dir
        )
        window_counters = _window_counter_delta(pre_window, post_window)
        fleet_counters = {
            k: v for k, v in BUS.counters().items() if k.startswith("fleet.")
        }
    else:
        window_counters = dict(BUS.counters())
        fleet_counters = {}
        stats_missing = []
    compile_counters = {
        k: v for k, v in window_counters.items() if k.startswith("compile.")
    }
    serve_counters = {
        k: v
        for k, v in window_counters.items()
        if k.startswith(("serve.", "batch.", "stream."))
    }
    if args.jsonl:
        write_events_jsonl(BUS, args.jsonl)

    # Durable-artifact oracle audit (after the counter snapshots above,
    # so its own apply/solve traffic cannot pollute the gated windows).
    stream_oracle = None
    if args.update_heavy and stream_tmp is not None:
        stream_oracle = _stream_oracle_check(stream_tmp, streams, args.device)

    # "extra" records are the chase polls riding publish arrivals — they
    # count toward latency/error accounting but not toward the
    # one-record-per-scheduled-arrival invariant.
    base_records = [rec for rec in records if not rec.get("extra")]
    lost = sum(1 for rec in records if rec["lost"])
    answered = len(base_records)
    resets = sum(1 for rec in records if rec.get("reset"))
    errors = sum(
        1 for rec in records
        if not rec["ok"] and not rec["lost"] and not rec.get("reset")
    )
    fresh_solves = window_counters.get("serve.scheduler.fresh_solve", 0)
    expected_classes = [c for c, n in counts.items() if n > 0]
    bus_classes = summary["classes"]

    # Every scheduled arrival, plus the out-of-schedule requests the drill
    # itself makes (chase polls, session re-subscribe solves, the
    # post-kill recovery probes, final drain polls), must appear as
    # exactly one request span.
    expected_spans = len(schedule) + resets + (1 if probe is not None else 0)
    if fleet_router is not None and args.kill_router:
        # The crash thread's deliberate in-flight orphan, plus one extra
        # span per client retry (the failed pre-crash attempt and its
        # post-restart retry are separate fleet.request spans).
        expected_spans += crash_info.get("extra_requests", 0) + proxy.retries
    if args.update_heavy:
        expected_spans = (
            len(schedule)
            + sum(1 for rec in records if rec.get("extra"))  # chase polls
            + stream_drain
            + (sum(r["requests"] for r in recovery) if recovery else 0)
        )
    checks = [
        ("every accepted query answered",
         answered == len(schedule) and lost == 0),
        ("all classes present in the bus-joined report",
         all(c in bus_classes for c in expected_classes)),
        ("bus join saw every request span",
         summary["totals"]["sent"] == expected_spans),
        ("no events dropped during the window (report trustworthy)",
         not summary["dropped_warning"]),
        ("chaos armed mid-flight", len(chaos_armed) == len(chaos_plan)),
    ]
    if fleet_router is not None:
        # A live worker whose stats fan-out failed contributes ZERO to
        # the window delta — every exact-gated counter check below would
        # pass vacuously, so a miss is a drill failure, not a zero.
        checks.append((
            "post-window stats from every live worker (counter gates "
            "trustworthy)", not stats_missing,
        ))
    if fleet_router is not None and args.wire == "binary":
        wire_pass = fleet_counters.get("fleet.wire.passthrough", 0)
        wire_fb = fleet_counters.get("fleet.wire.fallback_json", 0)
        checks.append(
            ("binary solve dispatches rode the wire plane", wire_pass >= 1)
        )
        if args.wire_legacy_worker is None:
            checks.append(
                ("no JSON fallback in an all-binary fleet", wire_fb == 0)
            )
        else:
            # The mixed-build contract: the legacy worker's ring share
            # degrades per connection (folded JSON), never errors — and
            # the capable workers keep the opaque path.
            checks.append(
                ("legacy worker's share degraded to folded JSON",
                 wire_fb >= 1)
            )
    if args.update_heavy:
        checks += [
            ("zero errors (stale head re-syncs excluded)", errors == 0),
            ("p99 bounded under sustained update load",
             client["totals"]["latency_s"].get("p99", float("inf"))
             <= args.p99_bound),
            ("no lost or duplicated window notifications",
             notify_gaps == 0 and notify_dups == 0),
            ("final drain polls all answered (gap ledger complete)",
             drain_errors == 0),
            ("windows applied batched, never degraded to resolve",
             window_counters.get("stream.window.batched", 0) >= 1
             and window_counters.get("stream.window.resolve", 0) == 0),
            ("superseded chain ancestors evicted from the LRU",
             window_counters.get("serve.store.chain_evicted", 0) >= 1),
            ("zero fresh solves while streams were live",
             fresh_solves == 0),
        ]
        if stream_oracle is not None:
            checks += [
                ("durable log rebuilds every stream head "
                 "(snapshot+WAL alone)",
                 stream_oracle["rebuilt"] == len(streams)
                 and stream_oracle["head_match"] == len(streams)),
                ("post-replay heads edge-exact against a fresh oracle "
                 "solve",
                 stream_oracle["edge_exact"] == len(streams)),
            ]
        if args.sharded_lane:
            checks.append(
                ("published windows migrated mesh residency (donated "
                 "scatter or bounded restage, never dropped)",
                 (window_counters.get("stream.lane.migrated", 0)
                  + window_counters.get("stream.lane.restaged", 0)) >= 1
                 and window_counters.get("lane.update.dropped", 0) == 0),
            )
        if fleet_router is not None and args.kill_worker is not None:
            checks += [
                ("worker killed mid-stream",
                 fleet_counters.get("fleet.worker.dead", 0) >= 1),
                ("dead worker restarted with backoff",
                 fleet_counters.get("fleet.worker.restart", 0) >= 1),
                ("streams recovered by snapshot+WAL replay (no re-solve)",
                 window_counters.get("stream.replay.streams", 0) >= 1),
                ("post-recovery window publishes served",
                 recovery is not None
                 and all(r["ok"] for r in recovery)),
            ]
            if args.sharded_lane:
                checks.append(
                    ("sharded residency rebuilt on replay (re-staged and "
                     "re-scattered, never unavailable)",
                     window_counters.get(
                         "stream.replay.residency_restored", 0) >= 1
                     and window_counters.get(
                         "stream.replay.residency_unavailable", 0) == 0),
                )
            if not args.elastic:  # elastic pins pool convergence instead
                checks.append(
                    ("fleet healed: full ring after the drill",
                     bool(rejoined)),
                )
        elif fleet_router is not None:
            checks += [
                ("no unplanned worker deaths",
                 fleet_counters.get("fleet.worker.dead", 0) == 0),
            ]
            if args.elastic:
                checks += [
                    ("retired workers' streams migrated by WAL replay "
                     "(no re-solve)",
                     window_counters.get("stream.replay.streams", 0) >= 1),
                    ("post-retire window publishes served by inheritors",
                     recovery is not None
                     and all(r["ok"] for r in recovery)),
                ]
    elif fleet_router is None:
        checks += [
            ("zero errors (chaos absorbed by the supervisor)", errors == 0),
            ("p99 bounded under chaos",
             client["totals"]["latency_s"].get("p99", float("inf"))
             <= args.p99_bound),
            ("duplicate storms coalesced (single-flight)",
             serve_counters.get("serve.scheduler.coalesced", 0) >= 1),
            ("cache absorbed the hit class",
             serve_counters.get("serve.store.hit", 0) >= counts["hit"]),
            ("zero request-time compiles in the measured window",
             compile_counters.get("compile.miss", 0) == 0),
        ]
        if args.oversize_heavy:
            interactive_p99 = max(
                bus_classes.get(c, {}).get("latency_s", {}).get("p99", 0.0)
                for c in ("hit", "dup")
            )
            checks.append(
                ("interactive p99 protected under concurrent bulk load",
                 interactive_p99 <= args.interactive_p99_bound),
            )
            if args.sharded_lane:
                checks.append(
                    ("oversize solves rode the mesh lane",
                     serve_counters.get("serve.route.sharded_lane", 0)
                     >= counts["oversize"]),
                )
    else:
        checks += [
            ("zero errors beyond session re-subscribes", errors == 0),
            ("p99 bounded under failover (degraded but bounded)",
             client["totals"]["latency_s"].get("p99", float("inf"))
             <= args.p99_bound),
            ("per-worker SLO breakdown present",
             bool(summary.get("workers"))),
        ]
        if args.kill_worker is not None:
            checks += [
                ("worker killed mid-traffic",
                 fleet_counters.get("fleet.worker.dead", 0) >= 1),
                ("accepted requests re-queued onto survivors",
                 fleet_counters.get("fleet.requeue", 0) >= 1),
                ("dead worker restarted with backoff",
                 fleet_counters.get("fleet.worker.restart", 0) >= 1),
            ]
            if not args.elastic:
                # Elastic scale-down may legitimately retire the restarted
                # victim (a fresh incarnation has the least affinity) —
                # pool convergence is the elastic heal check instead.
                checks += [
                    ("fleet healed: full ring after the drill",
                     bool(rejoined)),
                    ("restarted worker serves traffic (goodput recovery)",
                     bool(probe and probe.get("ok")
                          and probe.get("worker") == args.kill_worker)),
                ]
        elif args.kill_router:
            checks += [
                ("router crashed mid-flight with accepted work outstanding",
                 router_recovery["crashes"] == 1
                 and router_recovery["orphans_at_crash"] >= 1),
                ("journal replay answered every accepted query",
                 router_recovery["journal_unanswered"] == 0
                 and router_recovery["requeued"] >= 1),
                ("workers re-adopted warm (handled counts persist)",
                 router_recovery["readopted"] == args.fleet
                 and router_recovery["post_handled"]
                 >= router_recovery["pre_handled"]),
                ("full ring after router restart",
                 router_recovery["ring"] == list(range(args.fleet))),
                ("no worker died in the router crash (their processes "
                 "outlive the router)",
                 fleet_counters.get("fleet.worker.dead", 0) == 0),
            ]
        elif args.partition is not None:
            checks += [
                ("partition armed and healed",
                 fleet_counters.get("fleet.chaos.partition", 0) == 1
                 and fleet_counters.get("fleet.chaos.heal", 0) == 1),
                ("victim's link went dark (frames dropped, socket open)",
                 fleet_counters.get("fleet.chaos.dropped", 0) >= 1),
                ("ring healed after the partition (warm rejoin)",
                 partition_recovery["ring_healed"]),
                ("no lease trip on the healthy side (zero survivor "
                 "restarts)",
                 partition_recovery["healthy_restarts"] == 0),
                ("exactly one answer per accepted query (idempotent "
                 "re-queue, no duplicates)",
                 answered == len(schedule)),
            ]
        else:
            # No kill: the fleet must ride the window without ANY failover.
            checks += [
                ("no unplanned worker deaths",
                 fleet_counters.get("fleet.worker.dead", 0) == 0),
            ]
            if not args.elastic:
                # A joiner entering mid-window changes routing, so fresh
                # digests can land on it cold — zero request-time compiles
                # is a steady-state-pool property.
                checks.append(
                    ("zero request-time compiles in the measured window",
                     compile_counters.get("compile.miss", 0) == 0),
                )
    if elastic is not None:
        # Exact by construction: ups stop at max_workers, downs stop at
        # min_workers, cooldown serializes events, and the autoscaler was
        # stopped before the recovery traffic — so the counts are a
        # property of the policy, not the machine (gated exactly).
        expected_ups = elastic_policy.max_workers - args.fleet
        expected_downs = (
            elastic_policy.max_workers - elastic_policy.min_workers
        )
        scale_ups = int(fleet_counters.get("fleet.scale.up", 0))
        scale_downs = int(fleet_counters.get("fleet.scale.down", 0))
        join_hist = BUS.histograms().get("fleet.join.warm_s", {})
        checks += [
            ("fleet grew to max under load (exact scale-up events)",
             elastic["reached_max"] and scale_ups == expected_ups),
            ("fleet drained back to min on idle (exact scale-down events)",
             elastic["reached_min"] and scale_downs == expected_downs
             and elastic["final_pool"] == elastic_policy.min_workers),
            ("every joiner entered the ring warm (warmed hello confirmed)",
             fleet_counters.get("fleet.join.cold_rejected", 0) == 0
             and join_hist.get("count", 0) == scale_ups),
        ]
    ok = all(passed for _, passed in checks)

    if args.update_heavy:
        if fleet_router is None:
            workload = (WORKLOAD_STREAM_SHARDED if args.sharded_lane
                        else WORKLOAD_STREAM)
        elif args.kill_worker is not None:
            workload = (WORKLOAD_STREAM_SHARDED_KILL if args.sharded_lane
                        else WORKLOAD_STREAM_KILL)
        elif args.elastic:
            workload = WORKLOAD_FLEET_ELASTIC
        else:
            workload = WORKLOAD_STREAM_FLEET
    elif fleet_router is None:
        workload = WORKLOAD_OVERSIZE if args.oversize_heavy else WORKLOAD
    elif args.kill_router:
        workload = WORKLOAD_FLEET_ROUTER
    elif args.partition is not None:
        workload = WORKLOAD_FLEET_PARTITION
    elif args.kill_worker is not None:
        workload = (WORKLOAD_FLEET_ELASTIC_KILL if args.elastic
                    else WORKLOAD_FLEET_KILL)
    elif args.elastic:
        workload = WORKLOAD_FLEET_ELASTIC
    else:
        workload = WORKLOAD_FLEET
    config = {
        "workload": workload,
        "deck": "smoke" if args.smoke else "custom",
        "seed": args.seed,
        "arrival": args.arrival,
        "duration_s": args.duration,
        "rate": args.rate,
        "lanes": args.lanes,
        "counts": counts,
        "chaos": "off" if args.no_chaos else ("heavy" if args.chaos else "mid"),
    }
    if args.wire != "json":
        # Only stamped off the default so existing baselines' config
        # blocks keep matching byte-for-byte.
        config["wire"] = args.wire
        if args.wire_legacy_worker is not None:
            config["wire_legacy_worker"] = args.wire_legacy_worker
    if args.oversize_heavy:
        config["oversize_heavy"] = True
        config["sharded_lane"] = bool(args.sharded_lane)
    if args.update_heavy:
        config["update_heavy"] = True
        config["streams"] = args.streams
        config["window_updates"] = STREAM_WINDOW_UPDATES
        if args.sharded_lane:
            config["sharded_lane"] = True
            config["stream_shape"] = list(STREAM_SHARDED_SHAPE)
    if args.fleet:
        config["fleet"] = args.fleet
        config["kill_worker"] = args.kill_worker
        config["transport"] = args.transport
        if args.kill_router:
            config["kill_router"] = True
        if args.partition is not None:
            config["partition"] = args.partition
            config["partition_duration_s"] = args.partition_duration
        if args.test_echo:
            config["test_echo"] = True
        if elastic is not None:
            config["elastic"] = elastic["policy"]
    config.update(_package_fields(args.device))
    extra_metrics = {"lost_accepted": lost, "answered": answered}
    if router_hop:
        extra_metrics["router_hop_p50_s"] = router_hop.get("p50", 0.0)
        extra_metrics["router_hop_p95_s"] = router_hop.get("p95", 0.0)
    if args.update_heavy:
        extra_metrics["notify_gaps"] = notify_gaps
        extra_metrics["notify_dups"] = notify_dups
        extra_metrics["drain_errors"] = drain_errors
        extra_metrics["stream_resets"] = sum(s.resets for s in streams)
        extra_metrics["fresh_solves"] = fresh_solves
        if stream_oracle is not None:
            extra_metrics["oracle_exact"] = stream_oracle["edge_exact"]
        if args.sharded_lane:
            extra_metrics["residency_restored"] = window_counters.get(
                "stream.replay.residency_restored", 0
            )
            extra_metrics["residency_migrated"] = (
                window_counters.get("stream.lane.migrated", 0)
                + window_counters.get("stream.lane.restaged", 0)
            )
        if recovery:
            extra_metrics["replay_recovery_s"] = max(
                r["recover_s"] for r in recovery
            )
    if fleet_router is not None:
        if not args.update_heavy:
            extra_metrics["session_resets"] = resets
        extra_metrics["worker_restarts"] = fleet_counters.get(
            "fleet.worker.restart", 0
        )
        extra_metrics["requeued"] = fleet_counters.get("fleet.requeue", 0)
    if router_recovery is not None:
        # Exact by construction: one deliberate crash, a journal replay
        # that must drain to zero, and every --listen worker re-adopted
        # warm. fresh_solves pins the pinned-session contract (echo
        # fleets trivially report 0; a real fleet would pay a fresh
        # solve only if re-adoption silently went cold).
        extra_metrics["router_crashes"] = router_recovery["crashes"]
        extra_metrics["journal_unanswered"] = (
            router_recovery["journal_unanswered"]
        )
        extra_metrics["workers_readopted"] = router_recovery["readopted"]
        extra_metrics["fresh_solves"] = fresh_solves
        extra_metrics["router_restart_s"] = round(
            router_recovery.get("restart_s") or 0.0, 4
        )
    if partition_recovery is not None:
        extra_metrics["healthy_restarts"] = (
            partition_recovery["healthy_restarts"]
        )
        extra_metrics["frames_dropped"] = (
            partition_recovery["frames_dropped"]
        )
    if elastic is not None:
        extra_metrics["scale_up_events"] = scale_ups
        extra_metrics["scale_down_events"] = scale_downs
        if join_hist.get("count"):
            # The warm-join wall time (spawn -> pre-seed -> warmup ladder
            # -> warmed hello -> ring entry); its p95 gates as a ceiling.
            extra_metrics["fleet_join_warm_p95_s"] = join_hist["p95"]
    gate = slo.gate_metrics(
        summary,
        workload=workload,
        config=config,
        extra_metrics=extra_metrics,
    )
    if args.kill_router:
        # The whole latency envelope of this drill is downtime-dominated
        # and thread-timing shaped: WHICH class absorbs the ~1s outage
        # stall (and how many first attempts land inside it and retry) is
        # a lottery, so per-class p99/goodput/error numbers stay
        # report-only — the same reasoning that keeps the worker-kill
        # drill off a latency baseline. The gate pins the deterministic
        # survivability contract exactly.
        keep = {
            "lost_accepted", "answered", "session_resets",
            "worker_restarts", "requeued", "router_crashes",
            "journal_unanswered", "workers_readopted", "fresh_solves",
        }
        gate["metrics"] = {
            k: v for k, v in gate["metrics"].items() if k in keep
        }
    report = {
        "schema": REPORT_SCHEMA,
        "config": config,
        "wall_s": round(wall_s, 3),
        "warm_s": round(warm_s, 3),
        "slo": summary,
        "client": client,
        "compile_counters": compile_counters,
        "serve_counters": serve_counters,
        "chaos": {
            "armed": chaos_armed,
            "lost_accepted": lost,
            "errors": errors,
        },
        "events_dropped": summary["events_dropped"],
        "dropped_warning": summary["dropped_warning"],
        "checks": [{"name": n, "ok": bool(p)} for n, p in checks],
        "ok": ok,
        "gate_metrics": gate,
    }
    if args.update_heavy:
        report["stream"] = {
            "streams": args.streams,
            "notify_gaps": notify_gaps,
            "notify_dups": notify_dups,
            "drain_errors": drain_errors,
            "stream_resets": sum(s.resets for s in streams),
            "fresh_solves": fresh_solves,
            "head_seqs": {s.stream: s.head_seq for s in streams},
            "recovery": recovery,
            "oracle": stream_oracle,
        }
    if fleet_router is not None:
        report["fleet"] = {
            "workers": args.fleet,
            "transport": args.transport,
            "counters": fleet_counters,
            "session_resets": resets,
            "rejoined": rejoined,
            "probe": probe,
        }
        if router_recovery is not None:
            report["router"] = router_recovery
        if partition_recovery is not None:
            report["partition"] = partition_recovery
        if elastic is not None:
            # The elastic trace: policy, convergence, and the decision
            # log (action + reason + pool size per scale event) — the
            # "fleet grew and shrank across the run" evidence.
            report["elastic"] = {
                **elastic,
                "scale_up_events": scale_ups,
                "scale_down_events": scale_downs,
                "join_warm_s": join_hist,
            }
        if args.trace_dir:
            # One pulse scrape while every worker is still alive: the
            # merged counters/histograms + Prometheus exposition land as
            # drill artifacts (pulse.json / pulse.prom), and its totals
            # are auditable against the per-worker payloads it carries.
            from distributed_ghs_implementation_tpu_torch.obs.pulse import (
                FleetPulse,
            )

            pulse = FleetPulse(fleet_router, out_dir=args.trace_dir)
            scraped = pulse.scrape_once()
            report["pulse"] = {
                "workers_scraped": scraped["workers_scraped"],
                "counters": scraped["counters"],
                "artifacts": ["pulse.json", "pulse.prom"],
            }
        # run_drill's finally drains the fleet: workers flush in-flight
        # responses + export their per-worker obs JSONL (--obs-dir).
    return report


def _flip_bytes(path: str, rng: np.random.Generator, flips: int = 16) -> None:
    """Seeded in-place byte corruption — the bit-rot simulator. Flips land
    in the file's back half so the zip local headers usually stay parsable
    (the nastier case: ``np.load`` would SUCCEED on garbage if nothing
    checked the bytes first)."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            return
        lo = len(data) // 2
        for _ in range(flips):
            i = int(rng.integers(lo, len(data)))
            data[i] ^= 0xFF
        f.seek(0)
        f.write(data)


def run_corrupt_drill(args) -> dict:
    """The corruption audit drill (``gate-verify-v1``): prove the verify
    layer turns every corruption the stack can suffer into a counter, a
    quarantine, or a transparent correction — never a wrong answer.

    Five phases, all seeded and exactly counted:

    A. **Populate** — solve a seeded pool through a verify-enabled
       service with a disk store; record the SciPy oracle weight per
       digest (the drill's independent ground truth — every response in
       every later phase is checked against it, and ``wrong_results``
       gates EXACTLY at zero).
    B. **Bit rot** — flip seeded bytes inside K live store npz files.
    C. **Restart + re-query** — a fresh service on the same store
       directory re-serves the pool: the K rotted files must fail their
       sha256 sidecars, land in ``.quarantine/`` (``quarantined == K``
       exact), and degrade to misses that re-solve correctly; the
       untouched files must still disk-hit.
    D. **Memory corruption** — mutate the edge ids of M results inside
       the live memory LRU (the bit-flipped-RAM / miscompiled-kernel
       stand-in nothing below the certificate can see). Re-queries must
       fail their inline certificates and serve transparently corrected
       answers (``verify.corrected += M`` exact).
    E. **Payload chaos** (``--payload-chaos N``) — a one-worker TCP fleet
       with the transport chaos layer armed: ``fleet.chaos.payload``
       corrupts N solve responses PAST framing (valid length, valid CRC,
       mutated edge set + weight). The router's response verification
       must reject each one and re-dispatch (``verify.corrected += N``
       exact, ``lost_accepted == 0``).

    Plus an overhead leg: warm-hit latency with sampled async audit vs
    verification off (``verify_overhead_p50_s`` = p50 of the inline
    certificate itself, from the live ``verify.check_s`` histogram).
    """
    import tempfile

    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS, quantile
    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService
    from distributed_ghs_implementation_tpu_torch.utils.integrity import (
        list_quarantined,
    )
    from distributed_ghs_implementation_tpu_torch.utils.verify import (
        scipy_mst_weight,
    )

    BUS.enable()
    BUS.clear()
    t_start = time.perf_counter()
    checks: List[dict] = []
    device = args.device

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": str(detail)})
        if not ok:
            print(f"CHECK FAIL {name}: {detail}", file=sys.stderr)

    K = args.corrupt_store
    M = args.corrupt_results
    N = args.payload_chaos
    spec = args.verify or "full"
    rng = np.random.default_rng(args.seed)
    store_dir = tempfile.mkdtemp(prefix="ghs-verify-store-")
    pool = [
        gnm_random_graph(120, 360, seed=args.seed + 300 + i)
        for i in range(max(K + 2, 6))
    ]

    def _req(g, cls="bulk", **kw):
        out = _graph_request(g, cls)
        out.update(kw)
        return out

    expected = {}  # digest -> (graph, oracle weight)
    wrong = 0

    def _check_weight(resp, where: str) -> None:
        nonlocal wrong
        digest = resp.get("digest")
        want = expected.get(digest)
        if not resp.get("ok") or want is None or (
            resp.get("total_weight") != want[1]
        ):
            wrong += 1
            print(
                f"WRONG RESULT [{where}]: got "
                f"{resp.get('total_weight')} want "
                f"{None if want is None else want[1]} ({resp.get('error')})",
                file=sys.stderr,
            )

    # -- A: populate ----------------------------------------------------
    svc = MSTService(backend="device", disk_dir=store_dir, verify=spec,
                     device=device)
    for g in pool:
        resp = svc.handle(_req(g))
        expected[resp["digest"]] = (g, scipy_mst_weight(g))
        _check_weight(resp, "populate")
        if resp.get("verified") != "full":
            check("populate.verified_full", False, str(resp))
    check("populate.served", wrong == 0, f"wrong={wrong}")

    # -- B: bit rot in live store files ----------------------------------
    npz_files = sorted(
        e.path for e in os.scandir(store_dir)
        if e.name.endswith(".npz")
    )
    check(
        "store.populated", len(npz_files) == len(pool),
        f"{len(npz_files)} files for {len(pool)} digests",
    )
    victims = [npz_files[int(i)] for i in rng.choice(
        len(npz_files), size=min(K, len(npz_files)), replace=False
    )]
    for path in victims:
        _flip_bytes(path, rng)

    # -- C: restart + re-query -------------------------------------------
    pre = dict(BUS.counters())
    svc2 = MSTService(backend="device", disk_dir=store_dir, verify=spec,
                      device=device)
    for g in pool:
        _check_weight(svc2.handle(_req(g)), "post-rot")
    delta = {
        k: BUS.counters().get(k, 0) - pre.get(k, 0)
        for k in ("serve.store.quarantined", "serve.store.disk_hit",
                  "serve.scheduler.fresh_solve")
    }
    quarantined_files = list_quarantined(store_dir)
    check(
        "rot.quarantined_exact",
        delta["serve.store.quarantined"] == len(victims)
        and len(quarantined_files) == len(victims),
        f"counter={delta['serve.store.quarantined']} files="
        f"{len(quarantined_files)} expected={len(victims)}",
    )
    check(
        "rot.survivors_disk_hit",
        delta["serve.store.disk_hit"] == len(pool) - len(victims),
        f"disk_hit={delta['serve.store.disk_hit']}",
    )
    check(
        "rot.resolved_fresh",
        delta["serve.scheduler.fresh_solve"] == len(victims),
        f"fresh={delta['serve.scheduler.fresh_solve']}",
    )

    # -- D: memory corruption + transparent correction -------------------
    pre = dict(BUS.counters())
    mem_keys = list(svc2.store._mem)[:M]
    for key in mem_keys:
        result = svc2.store._mem[key]
        if result.num_edges >= 2:
            result.edge_ids[0] = result.edge_ids[1]  # duplicated edge id
    for key in mem_keys:
        digest = key.split(":", 1)[0]
        _check_weight(
            svc2.handle(_req(expected[digest][0])), "mem-corrupt"
        )
    delta = {
        k: BUS.counters().get(k, 0) - pre.get(k, 0)
        for k in ("verify.failed", "verify.corrected")
    }
    check(
        "mem.corrected_exact",
        delta["verify.failed"] == len(mem_keys)
        and delta["verify.corrected"] == len(mem_keys),
        f"failed={delta['verify.failed']} corrected="
        f"{delta['verify.corrected']} expected={len(mem_keys)}",
    )

    # -- E: fleet payload chaos ------------------------------------------
    fleet_section = None
    payload_rejected = 0
    lost_accepted = 0
    if N > 0:
        from distributed_ghs_implementation_tpu_torch.fleet.router import (
            FleetConfig,
            FleetRouter,
        )
        from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

        pre = dict(BUS.counters())
        cfg = FleetConfig(
            workers=1, transport="tcp", chaos=True, chaos_seed=args.seed,
            verify_responses=True, forward_cache=False, verify=spec,
            heartbeat_interval_s=0.25, ready_timeout_s=240.0,
            request_timeout_s=120.0, device=device,
            compile_cache_dir=os.path.join(ROOT, "build"),
        )
        accepted = answered = 0
        with FleetRouter(cfg) as router:
            fleet_pool = pool[: N + 2]
            for i, g in enumerate(fleet_pool):
                if 1 <= i <= N:
                    # Arm ONE shot per corrupted request (mid-run, after
                    # the first clean answer): the first response carrying
                    # an edge set is mutated past framing; the router's
                    # certificate must reject it and the single
                    # re-dispatch must come back clean — arming times=N in
                    # one shot would corrupt the retry too.
                    FAULTS.arm("fleet.chaos.payload", times=1)
                accepted += 1
                resp = router.handle(_req(g, edges_out=True))
                if resp.get("ok"):
                    answered += 1
                _check_weight(resp, "payload-chaos")
        delta = {
            k: BUS.counters().get(k, 0) - pre.get(k, 0)
            for k in ("fleet.chaos.payload_corrupted",
                      "fleet.response.rejected", "verify.failed",
                      "verify.corrected")
        }
        payload_rejected = int(delta["fleet.response.rejected"])
        check(
            "payload.rejected_exact",
            delta["fleet.chaos.payload_corrupted"] == N
            and delta["fleet.response.rejected"] == N
            and delta["verify.corrected"] == N,
            f"{delta} expected {N}",
        )
        lost_accepted = accepted - answered
        check(
            "payload.lost_accepted_zero", lost_accepted == 0,
            f"accepted={accepted} answered={answered}",
        )
        fleet_section = {
            "workers": 1, "transport": "tcp",
            "accepted": accepted, "answered": answered,
            "payload_corrupted": int(delta["fleet.chaos.payload_corrupted"]),
            "response_rejected": payload_rejected,
        }

    # -- overhead leg ----------------------------------------------------
    # Warm-hit latency with the default sampled-audit cadence vs
    # verification off, PACED (~2 ms between arrivals): the claim under
    # test is "sampled audit adds ≤5% to interactive p99 at a realistic
    # request rate", not "an audit thread saturated by a closed loop is
    # free" — at saturation the GIL contention measures the box, not the
    # design. The bound stays generous (1.5x + 5 ms absolute) because a
    # 2-core CI runner's p99 over 120 samples is one scheduler hiccup.
    hit_graph = pool[0]
    svc_off = MSTService(backend="device", device=device)
    svc_audit = MSTService(backend="device", verify="sample", device=device)
    for s in (svc_off, svc_audit):
        s.handle(_req(hit_graph, cls="interactive"))  # prime the cache
    timings = {}
    for name, s in (("off", svc_off), ("audit", svc_audit)):
        samples = []
        for _ in range(120):
            t0 = time.perf_counter()
            s.handle(_req(hit_graph, cls="interactive"))
            samples.append(time.perf_counter() - t0)
            time.sleep(0.002)
        timings[name] = samples
    svc_audit.verifier.auditor.flush()
    hist = BUS.histograms().get("verify.check_s", {})
    audit_p99 = quantile(timings["audit"], 0.99)
    off_p99 = quantile(timings["off"], 0.99)
    check(
        "audit.p99_overhead_bounded",
        audit_p99 <= max(off_p99 * 1.5, off_p99 + 0.005),
        f"audit p99 {audit_p99:.5f}s vs off {off_p99:.5f}s",
    )

    counters = BUS.counters()
    quarantined_total = int(counters.get("serve.store.quarantined", 0))
    check("wrong_results_zero", wrong == 0, f"wrong={wrong}")
    metrics = {
        "wrong_results": wrong,
        "quarantined": quarantined_total,
        "verify_failed": int(counters.get("verify.failed", 0)),
        "verify_corrected": int(counters.get("verify.corrected", 0)),
        "payload_rejected": payload_rejected,
        "lost_accepted": lost_accepted,
        "verify_checks": int(counters.get("verify.checks", 0)),
        "audit_failed": int(counters.get("verify.audit.failed", 0)),
        "verify_overhead_p50_s": float(hist.get("p50", 0.0)),
        "interactive_hit_audit_p99_s": float(audit_p99),
    }
    ok = all(c["ok"] for c in checks)
    return {
        "schema": REPORT_SCHEMA,
        "config": {
            "workload": WORKLOAD_VERIFY,
            "seed": args.seed,
            "pool": len(pool),
            "corrupt_store": len(victims),
            "corrupt_results": M,
            "payload_chaos": N,
            "verify": spec,
            **_package_fields(device),
        },
        "wall_s": round(time.perf_counter() - t_start, 3),
        "ok": ok,
        "checks": checks,
        "chaos": {"payload_armed": N, "store_corrupted": len(victims)},
        "events_dropped": BUS.dropped,
        "slo": {"classes": {}},
        "quarantine": quarantined_files,
        "fleet": fleet_section,
        "gate_metrics": {
            "schema": "ghs-bench-metrics-v1",
            "config": {
                "workload": WORKLOAD_VERIFY,
                "seed": args.seed,
                "corrupt_store": len(victims),
                "corrupt_results": M,
                "payload_chaos": N,
                **_package_fields(device),
            },
            "metrics": metrics,
        },
    }


# ----------------------------------------------------------------------
# Analytics drill (gate-analytics-v1): every query kind, oracle-exact
# ----------------------------------------------------------------------
ANALYTICS_KINDS = ("mst", "components", "k_msf", "bottleneck", "path_max")
ANALYTICS_K = 3  # the deck's k-MSF target fragment count


def _kind_request(g, kind: str, cls: Optional[str]) -> dict:
    """A full solve request for ``kind`` over ``g``. ``cls=None`` drops the
    ``slo_class`` tag so the service applies the kind's own default class
    (``obs.slo.KIND_CLASS_DEFAULTS`` — part of what the drill exercises).
    ``path_max`` endpoints are pinned at ``(0, n-1)``: deterministic, and
    disconnected by construction on the two-block graphs."""
    req = _graph_request(g, cls or "miss")
    if cls is None:
        del req["slo_class"]
    if kind != "mst":
        req["kind"] = kind
    if kind == "components":
        req["labels_out"] = True
    elif kind == "k_msf":
        req["k"] = ANALYTICS_K
    elif kind == "path_max":
        req["u"], req["v"] = 0, g.num_nodes - 1
    return req


def _two_block_graph(seed: int):
    """Deliberately disconnected deck member: two G(n,m) blocks plus three
    isolated tail nodes — the non-mst kinds then see real forests (multi-
    component partitions, the relaxed k-forest spanning predicate, and a
    disconnected ``path_max`` endpoint pair)."""
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )

    a = gnm_random_graph(40, 110, seed=seed)
    b = gnm_random_graph(30, 80, seed=seed + 17)
    return Graph.from_arrays(
        a.num_nodes + b.num_nodes + 3,
        np.concatenate([a.u, b.u + a.num_nodes]),
        np.concatenate([a.v, b.v + a.num_nodes]),
        np.concatenate([a.w, b.w]),
    )


def _kind_oracles(g) -> dict:
    """Per-kind SciPy ground truth for one graph — every served answer
    in every leg is compared against these, EXACTLY (each oracle answers in
    a tie-independent representation; see analytics/solvers.py)."""
    from distributed_ghs_implementation_tpu_torch.analytics import (
        solvers as asolvers,
    )
    from distributed_ghs_implementation_tpu_torch.utils.verify import (
        scipy_mst_weight,
    )

    parts = asolvers.oracle_components(g)
    return {
        "mst": scipy_mst_weight(g),
        "components": parts,
        "k_eff": min(g.num_nodes, max(ANALYTICS_K, len(parts))),
        "k_msf": asolvers.oracle_k_msf_weight(g, ANALYTICS_K),
        "bottleneck": asolvers.oracle_bottleneck(g),
        "path_max": asolvers.oracle_path_max(g, 0, g.num_nodes - 1),
    }


def run_kinds_drill(args) -> dict:
    """The analytics drill (``gate-analytics-v1``): all five query kinds
    served through the real front door, every answer checked EXACTLY
    against its SciPy oracle (``wrong_results == 0`` gates per kind —
    a wrong components partition or minimax value is the silent-wrong-MST
    failure mode reborn in a new query class). Five legs:

    A. **Miss** — a seeded pool (connected + deliberately disconnected
       graphs) queried with every kind through a verify-enabled disk-store
       service; per-kind p50 solve latency recorded client-side.
    B. **Hit** — the full deck repeated: every answer must come from cache
       (zero fresh solves, EXACT) and still match its oracle — the
       per-kind keys must hand back the RIGHT kind's entry.
    C. **Probes + store isolation** — ``cached_only`` probes per kind
       (the fleet's forwarding frame): all five hit kind-correctly on a
       fully-queried digest; on an mst-only digest the ``components``
       probe must MISS (per-kind keys never collide, and components never
       derives) while the derivable kinds answer from the mst entry; a
       fresh service on the same directory disk-hits a kind entry; the
       store's npz census is exact (per-kind files per digest).
    D. **Update** — reweight windows through ``op: update``; the digest
       chain is validated against a client-side rebuild, the updated mst
       entry must answer the post-update mst query from cache, and every
       kind is re-checked against fresh oracles of the mutated graph
       (components rides the unchanged connectivity twin's cache — the
       deliberate cross-kind affinity).
    E. **Fleet** — a 2-worker pipe fleet with response verification ON:
       all five kinds answer through the router (``certify_claim``'s
       per-kind adapters certify each payload router-side), plus a repeat
       to prove cross-request affinity inside the fleet.
    """
    import tempfile

    from distributed_ghs_implementation_tpu_torch.analytics import (
        solvers as asolvers,
    )
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS, quantile
    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService

    BUS.enable()
    BUS.clear()
    t_start = time.perf_counter()
    checks: List[dict] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": str(detail)})
        if not ok:
            print(f"CHECK FAIL {name}: {detail}", file=sys.stderr)

    spec = args.verify or "full"
    device = args.device
    store_dir = tempfile.mkdtemp(prefix="ghs-analytics-store-")
    pool = [
        gnm_random_graph(90, 260, seed=args.seed + 900 + i)
        for i in range(4)
    ] + [
        _two_block_graph(args.seed + 950),
        _two_block_graph(args.seed + 975),
    ]
    U = 2  # update streams (leg D)

    wrong = {k: 0 for k in ANALYTICS_KINDS}
    served = {k: 0 for k in ANALYTICS_KINDS}

    def check_kind(resp: dict, kind: str, oracles: dict, where: str) -> bool:
        served[kind] += 1
        good = bool(resp.get("ok"))
        if kind == "mst":
            good = good and resp.get("total_weight") == oracles["mst"]
        elif kind == "components":
            got = asolvers.partition_from_labels(resp.get("labels") or [])
            good = good and (
                resp.get("num_components") == len(oracles["components"])
                and got == oracles["components"]
            )
        elif kind == "k_msf":
            good = good and (
                resp.get("total_weight") == oracles["k_msf"]
                and resp.get("num_components") == oracles["k_eff"]
                and resp.get("k") == ANALYTICS_K
            )
        elif kind == "bottleneck":
            good = good and (
                resp.get("bottleneck_weight") == oracles["bottleneck"]
            )
        else:  # path_max — compare the minimax VALUE (the edge can tie)
            pm = oracles["path_max"]
            good = good and (
                resp.get("connected") == pm["connected"]
                and resp.get("path_max_weight") == pm["weight"]
            )
        if not good:
            wrong[kind] += 1
            print(
                f"WRONG RESULT [{where}/{kind}]: "
                f"{json.dumps(resp, default=str)[:400]}",
                file=sys.stderr,
            )
        return good

    # -- A: miss leg — every kind, oracle-checked, latency-sampled -------
    svc = MSTService(backend="device", disk_dir=store_dir, verify=spec,
                     device=device)
    lat = {k: [] for k in ANALYTICS_KINDS}
    oracle_of = {}  # digest of pool[i] -> its oracle dict
    for g in pool:
        oracles = _kind_oracles(g)
        oracle_of[g.digest()] = oracles
        for kind in ANALYTICS_KINDS:
            t0 = time.perf_counter()
            resp = svc.handle(
                _kind_request(g, kind, "miss" if kind == "mst" else None)
            )
            lat[kind].append(time.perf_counter() - t0)
            check_kind(resp, kind, oracles, "miss")
            if spec == "full" and resp.get("verified") != "full":
                check("miss.verified_full", False,
                      f"{kind}: verified={resp.get('verified')}")
    check(
        "miss.served_exact",
        all(wrong[k] == 0 for k in ANALYTICS_KINDS),
        f"wrong={wrong}",
    )

    # -- B: hit leg — cached answers, kind-correct, zero fresh solves ----
    pre = dict(BUS.counters())
    uncached = 0
    for g in pool:
        oracles = oracle_of[g.digest()]
        for kind in ANALYTICS_KINDS:
            resp = svc.handle(_kind_request(g, kind, "hit"))
            check_kind(resp, kind, oracles, "hit")
            if not resp.get("cached"):
                uncached += 1
    hit_fresh = int(
        BUS.counters().get("serve.scheduler.fresh_solve", 0)
        - pre.get("serve.scheduler.fresh_solve", 0)
    )
    check("hit.all_cached", uncached == 0, f"uncached={uncached}")
    check("hit.zero_fresh_solves", hit_fresh == 0, f"fresh={hit_fresh}")

    # -- C: kind probes + store isolation --------------------------------
    pre = dict(BUS.counters())
    d0 = pool[0].digest()
    oracles0 = oracle_of[d0]

    def _probe(svc_, digest: str, kind: str, n: int) -> dict:
        req = {"op": "solve", "cached_only": True, "digest": digest}
        if kind != "mst":
            req["kind"] = kind
        if kind == "components":
            req["labels_out"] = True
        elif kind == "k_msf":
            req["k"] = ANALYTICS_K
        elif kind == "path_max":
            req["u"], req["v"] = 0, n - 1
        return svc_.handle(req)

    for kind in ANALYTICS_KINDS:
        resp = _probe(svc, d0, kind, pool[0].num_nodes)
        check_kind(resp, kind, oracles0, "probe")

    # An mst-only digest: the components probe must MISS (per-kind keys
    # never collide with the mst entry, and components never derives —
    # its canonical cache entry is the connectivity forest); the derived
    # kinds answer from the cached mst entry without solving.
    g_extra = gnm_random_graph(70, 200, seed=args.seed + 990)
    oracles_extra = _kind_oracles(g_extra)
    resp = svc.handle(_kind_request(g_extra, "mst", "miss"))
    check_kind(resp, "mst", oracles_extra, "extra")
    d_extra = resp["digest"]
    resp = _probe(svc, d_extra, "components", g_extra.num_nodes)
    check(
        "probe.components_no_collision",
        not resp.get("ok") and resp.get("cache_miss") is True,
        f"components probe on an mst-only digest answered: {resp}",
    )
    for kind in ("k_msf", "bottleneck", "path_max"):
        resp = _probe(svc, d_extra, kind, g_extra.num_nodes)
        check_kind(resp, kind, oracles_extra, "probe-derive")

    delta = {
        k: BUS.counters().get(k, 0) - pre.get(k, 0)
        for k in ("serve.probe.hit", "serve.probe.miss")
    }
    probe_hits = int(delta["serve.probe.hit"])
    probe_misses = int(delta["serve.probe.miss"])
    check(
        "probe.counts_exact",
        probe_hits == 8 and probe_misses == 1,
        f"hits={probe_hits} misses={probe_misses} expected 8/1",
    )

    # A fresh service on the same directory must answer a kind query from
    # the DISK layer (a full request, not a probe: the disk round trip
    # needs the graph to rebuild the result) — with zero fresh solves.
    svc2 = MSTService(backend="device", disk_dir=store_dir, verify=spec,
                      device=device)
    pre2 = dict(BUS.counters())
    resp = svc2.handle(_kind_request(pool[0], "components", "hit"))
    check_kind(resp, "components", oracles0, "disk-restart")
    disk_delta = {
        k: BUS.counters().get(k, 0) - pre2.get(k, 0)
        for k in ("serve.store.disk_hit", "serve.scheduler.fresh_solve")
    }
    check(
        "restart.kind_disk_hit",
        disk_delta["serve.store.disk_hit"] == 1
        and disk_delta["serve.scheduler.fresh_solve"] == 0
        and bool(resp.get("cached")),
        f"{disk_delta} cached={resp.get('cached')}",
    )

    # -- D: update leg — digest chain + post-update kind queries ---------
    update_mst_hits = 0
    for si, g in enumerate(pool[:U]):
        rngu = np.random.default_rng(args.seed + 1300 + si)
        idx = rngu.choice(g.num_edges, size=3, replace=False)
        w2 = g.w.copy()
        updates = []
        for j in idx:
            new_w = int(w2[j]) + 7 + si
            w2[j] = new_w
            updates.append({
                "kind": "reweight",
                "u": int(g.u[j]), "v": int(g.v[j]), "w": new_w,
            })
        resp = svc.handle({
            "op": "update", "digest": g.digest(), "updates": updates,
            "slo_class": "update",
        })
        g2 = Graph.from_arrays(g.num_nodes, g.u, g.v, w2)
        check(
            f"update.digest_chain.{si}",
            bool(resp.get("ok")) and resp.get("digest") == g2.digest(),
            f"server {resp.get('digest')} vs client {g2.digest()}",
        )
        oracles2 = _kind_oracles(g2)
        for kind in ANALYTICS_KINDS:
            resp2 = svc.handle(_kind_request(g2, kind, "update"))
            check_kind(resp2, kind, oracles2, f"post-update/{si}")
            if kind == "mst" and resp2.get("cached"):
                update_mst_hits += 1
    check(
        "update.mst_served_from_update_cache",
        update_mst_hits == U,
        f"cached mst answers post-update: {update_mst_hits}/{U}",
    )

    # Store census, EXACT: per pool digest {mst, components kind entry,
    # k_msf kind entry, connectivity-twin mst} = 4 files; the extra graph
    # adds its mst file; each update stream adds {updated mst, components
    # kind, k_msf kind} = 3 — the twin is reweight-invariant (same
    # endpoints, index weights), so its phase-A entry is REUSED, and
    # bottleneck/path_max never store separately. Probe-derived k_msf
    # entries are memory-only by design.
    n_files = sum(
        1 for e in os.scandir(store_dir) if e.name.endswith(".npz")
    )
    expected_files = 4 * len(pool) + 1 + 3 * U
    check(
        "store.per_kind_census_exact",
        n_files == expected_files,
        f"{n_files} npz files, expected {expected_files}",
    )

    # -- E: fleet leg — all kinds through the router, certified ----------
    from distributed_ghs_implementation_tpu_torch.fleet.router import (
        FleetConfig,
        FleetRouter,
    )

    fleet_pool = [
        gnm_random_graph(80, 230, seed=args.seed + 1500),
        _two_block_graph(args.seed + 1600),
    ]
    fleet_oracles = [_kind_oracles(g) for g in fleet_pool]
    cfg = FleetConfig(
        workers=2, verify=spec, verify_responses=True,
        ready_timeout_s=240.0, request_timeout_s=120.0, device=device,
        compile_cache_dir=os.path.join(ROOT, "build"),
    )
    fleet_wrong = fleet_served = 0
    pre = dict(BUS.counters())
    with FleetRouter(cfg) as router:
        for g, oracles in zip(fleet_pool, fleet_oracles):
            for kind in ANALYTICS_KINDS:
                req = _kind_request(g, kind, "fleet")
                req["edges_out"] = True  # router-side claim certification
                resp = router.handle(req)
                fleet_served += 1
                if not check_kind(resp, kind, oracles, "fleet"):
                    fleet_wrong += 1
        # Cross-request affinity inside the fleet: the repeat must still
        # be kind-correct (same digest, same owner, cached kind entry).
        req = _kind_request(fleet_pool[0], "components", "fleet")
        req["edges_out"] = True
        resp = router.handle(req)
        fleet_served += 1
        if not check_kind(resp, "components", fleet_oracles[0], "fleet-rep"):
            fleet_wrong += 1
    fleet_rejected = int(
        BUS.counters().get("fleet.response.rejected", 0)
        - pre.get("fleet.response.rejected", 0)
    )
    check("fleet.kinds_exact", fleet_wrong == 0, f"wrong={fleet_wrong}")
    check(
        "fleet.no_rejected_responses", fleet_rejected == 0,
        f"rejected={fleet_rejected}",
    )

    counters = BUS.counters()
    total_wrong = sum(wrong.values())
    check("wrong_results_zero", total_wrong == 0, f"wrong={wrong}")
    metrics = {
        "wrong_results": total_wrong,
        "hit_leg_fresh_solves": hit_fresh,
        "probe_hits": probe_hits,
        "probe_misses": probe_misses,
        "store_files": n_files,
        "update_streams": U,
        "update_mst_hits": update_mst_hits,
        "fleet_served": fleet_served,
        "fleet_wrong_results": fleet_wrong,
        "verify_failed": int(counters.get("verify.failed", 0)),
        "verify_corrected": int(counters.get("verify.corrected", 0)),
    }
    for k in ANALYTICS_KINDS:
        metrics[f"wrong_{k}"] = wrong[k]
        metrics[f"served_{k}"] = served[k]
        metrics[f"{k}_p50_s"] = float(quantile(lat[k], 0.5))
    ok = all(c["ok"] for c in checks)
    return {
        "schema": REPORT_SCHEMA,
        "config": {
            "workload": WORKLOAD_KINDS,
            "seed": args.seed,
            "pool": len(pool),
            "kinds": list(ANALYTICS_KINDS),
            "k": ANALYTICS_K,
            "update_streams": U,
            "fleet_workers": 2,
            "verify": spec,
            **_package_fields(device),
        },
        "wall_s": round(time.perf_counter() - t_start, 3),
        "ok": ok,
        "checks": checks,
        "chaos": {},
        "events_dropped": BUS.dropped,
        "slo": {"classes": {}},
        "fleet": {
            "workers": 2, "transport": "pipe",
            "served": fleet_served, "rejected": fleet_rejected,
        },
        "gate_metrics": {
            "schema": "ghs-bench-metrics-v1",
            "config": {
                "workload": WORKLOAD_KINDS,
                "seed": args.seed,
                "pool": len(pool),
                "k": ANALYTICS_K,
                "update_streams": U,
                **_package_fields(device),
            },
            "metrics": metrics,
        },
    }


def run_gate(report: dict, baseline_path: str, time_tolerance: float):
    """Compare the report's gate metrics against a baseline (reusing
    bench_gate's classification); returns ``(ok, lines)``.
    ``tools/bench_gate.py`` is loaded by path: it reads JSON with the
    standard library only."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_gate", os.path.join(ROOT, "tools", "bench_gate.py")
    )
    bench_gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_gate)

    with open(baseline_path) as f:
        baseline = json.load(f)
    return bench_gate.compare(
        baseline, report["gate_metrics"], time_tolerance=time_tolerance
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="load_drill", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--smoke", action="store_true",
                   help="the CI deck: ~10s window, mid-flight chaos, gate-ready")
    p.add_argument("--chaos", action="store_true",
                   help="heavier chaos scenario (second mid-flight arm point)")
    p.add_argument("--no-chaos", action="store_true",
                   help="disable the deck's mid-flight fault arming")
    p.add_argument("--arrival", choices=("poisson", "bursty", "ramp"),
                   default="poisson")
    p.add_argument("--ramp", action="store_true",
                   help="shorthand for --arrival ramp (the elastic "
                   "scenario's traffic shape: density doubles across the "
                   "window)")
    p.add_argument("--duration", type=float, default=10.0,
                   help="arrival window in seconds (open-loop)")
    p.add_argument("--rate", type=float, default=10.0,
                   help="average arrivals/sec scale (10 = reference deck)")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--lanes", type=int, default=4,
                   help="batch lanes for the service under test")
    p.add_argument("--batch-wait", type=float, default=0.02,
                   help="lane-forming window (s); wider than prod default "
                   "so open-loop bursts actually share lanes")
    p.add_argument("--oversize", type=int, default=2,
                   help="oversize-bypass queries in the deck")
    p.add_argument("--oversize-heavy", action="store_true",
                   help="bulk-vs-interactive scenario (gate-oversize-v1): "
                   "more oversize solves running concurrently with the "
                   "interactive classes; checks interactive p99 stays "
                   "within --interactive-p99-bound while bulk is in flight")
    p.add_argument("--update-heavy", action="store_true",
                   help="streaming scenario (gate-stream-v1): a sustained "
                   "Poisson stream of published update windows against "
                   "subscribed graphs with a durable log, notification "
                   "latency per poll, and (with --fleet --kill-worker) a "
                   "mid-stream kill recovered by snapshot+WAL replay with "
                   "zero fresh solves and no notification gap/duplicate")
    p.add_argument("--streams", type=int, default=3,
                   help="with --update-heavy: subscribed streams in the deck")
    p.add_argument("--sharded-lane", type=int, nargs="?", const=-1, default=0,
                   metavar="N",
                   help="attach a mesh-sharded oversize lane to the service "
                   "under test (bare flag = one shard a card; with --fleet: "
                   "every worker owns a lane and the router steers "
                   "oversize digests at lane workers)")
    p.add_argument("--interactive-p99-bound", type=float, default=8.0,
                   help="with --oversize-heavy: fail if the hit/dup classes' "
                   "bus-joined p99 exceeds this while bulk solves run")
    p.add_argument("--workers", type=int, default=16,
                   help="client threads (the open-loop dispatch pool)")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="drive a fleet of N worker processes through the "
                   "digest router instead of the in-process service "
                   "(fleet/router.py, docs/FLEET.md)")
    p.add_argument("--kill-worker", type=int, nargs="?", const=1,
                   default=None, metavar="K",
                   help="with --fleet: arm fleet.worker.crash inside worker "
                   "K mid-window (it dies in place of its next request); "
                   "the drill then asserts zero lost accepted queries, "
                   "re-queue, restart-with-backoff, and goodput recovery")
    p.add_argument("--transport", choices=("pipe", "tcp"), default="pipe",
                   help="with --fleet: the router<->worker channel — "
                   "subprocess pipes or localhost TCP sockets "
                   "through fleet/transport.py (dial-in hello "
                   "registration, coalesced pipelined frame writes, "
                   "connection-loss + lease-expiry death detection); the "
                   "report's per-class router_hop_s tracks the overhead "
                   "difference")
    p.add_argument("--test-echo", action="store_true",
                   help="with --fleet: spawn device-free echo workers "
                   "(canned answers, full transport/failover fidelity) — "
                   "the TCP kill drill's mode")
    p.add_argument("--wire", choices=("json", "binary"), default="json",
                   help="solve-request carrier: 'binary' builds the deck "
                   "as B-frame section requests (Graph.to_wire — raw "
                   "little-endian u/v/w, zero-copy ingest) so the drill "
                   "exercises binary ingest and the router's opaque "
                   "passthrough end to end; digests (and so routing, "
                   "caching, and the deck's reproducibility) are "
                   "unchanged (docs/FLEET.md \"Binary wire\")")
    p.add_argument("--wire-legacy-worker", type=int, default=None,
                   metavar="K",
                   help="with --fleet --wire binary: spawn worker K as a "
                   "legacy build (GHS_FLEET_WIRE=0 — its hello carries no "
                   "caps.wire), so the drill proves the mixed-build "
                   "contract: K's ring share degrades to folded JSON per "
                   "connection, siblings stay opaque, zero lost accepted "
                   "queries")
    p.add_argument("--kill-router", action="store_true",
                   help="with --fleet --test-echo --transport tcp: crash "
                   "the ROUTER mid-window with accepted work outstanding "
                   "(workers are externally spawned --listen processes "
                   "that survive it); a successor on the same durable "
                   "journal re-adopts them warm and replays the orphaned "
                   "accepts — lost_accepted == 0 and journal_unanswered "
                   "== 0 gate exactly (gate-fleet-router-v1)")
    p.add_argument("--partition", type=int, nargs="?", const=1,
                   default=None, metavar="K",
                   help="with --fleet --test-echo --transport tcp: "
                   "one-way partition worker K's link mid-window via the "
                   "transport chaos layer (frames dropped, socket OPEN — "
                   "the lease is the only death signal), heal after "
                   "--partition-duration, assert zero loss, exactly one "
                   "answer per query, warm rejoin, and no lease trip on "
                   "the healthy side (gate-fleet-partition-v1)")
    p.add_argument("--partition-duration", type=float, default=3.0,
                   help="with --partition: seconds the link stays dark "
                   "(must exceed the drill's 1.5s partition lease, or "
                   "the fault heals before detection)")
    p.add_argument("--elastic", action="store_true",
                   help="with --fleet: attach the obs-driven autoscaler "
                   "(fleet/autoscaler.py) with a zero wait budget, so the "
                   "window deterministically grows the pool to "
                   "--elastic-max (warm-handoff joins) and post-window "
                   "idle drains it to --elastic-min (drain-aware "
                   "retires); scale event counts then gate EXACTLY "
                   "(gate-fleet-elastic-v1, docs/FLEET.md Elasticity)")
    p.add_argument("--elastic-min", type=int, default=None, metavar="N",
                   help="with --elastic: pool floor (default fleet - 1, "
                   "at least 1)")
    p.add_argument("--elastic-max", type=int, default=None, metavar="N",
                   help="with --elastic: pool ceiling (default fleet + 1)")
    p.add_argument("--kinds-mixed", action="store_true",
                   help="run the analytics drill (gate-analytics-v1): all "
                   "five query kinds (mst, components, k_msf, bottleneck, "
                   "path_max) over miss/hit/probe/update traffic plus a "
                   "2-worker fleet leg with response certification, every "
                   "answer checked EXACTLY against its SciPy oracle "
                   "and the per-kind store keys proven non-colliding "
                   "(docs/ANALYTICS.md)")
    p.add_argument("--corrupt-store", type=int, default=None, metavar="K",
                   help="run the corruption audit drill (gate-verify-v1): "
                   "flip seeded bytes inside K live store npz files "
                   "mid-run, corrupt --corrupt-results cached results "
                   "in memory, and arm --payload-chaos response "
                   "corruptions over a TCP fleet; gates wrong_results==0 "
                   "and quarantined/verify.corrected EXACT "
                   "(docs/VERIFICATION.md)")
    p.add_argument("--corrupt-results", type=int, default=2, metavar="M",
                   help="with --corrupt-store: in-memory cached results "
                   "to corrupt (inline certificates must correct each)")
    p.add_argument("--payload-chaos", type=int, default=2, metavar="N",
                   help="with --corrupt-store: fleet.chaos.payload shots "
                   "armed against the one-worker TCP fleet leg (0 skips "
                   "the fleet leg)")
    p.add_argument("--verify", default=None, metavar="SPEC",
                   help="verification policy for the service under test "
                   "(off|sample[:N]|full or per-class — "
                   "docs/VERIFICATION.md); the corrupt drill defaults "
                   "to 'full'")
    p.add_argument("--trace-dir",
                   help="with --fleet: distributed-tracing artifact dir — "
                   "per-process JSONL span logs (workers on drain, router "
                   "post-shutdown), one merged Perfetto trace "
                   "(merged_trace.json) + critical-path report "
                   "(critical_path.json), and a fleet pulse scrape "
                   "(pulse.json / pulse.prom); orphan_spans and "
                   "traces_joined join the gated metrics")
    p.add_argument("--obs-dir",
                   help="with --fleet: per-worker obs JSONL exports land "
                   "here on drain (worker<K>.<incarnation>.jsonl)")
    p.add_argument("--p99-bound", type=float, default=30.0,
                   help="degraded-but-BOUNDED: fail if total p99 exceeds this")
    p.add_argument("--jsonl", help="also export the window's bus events")
    p.add_argument("--output", help="write the JSON report here")
    p.add_argument("--gate-baseline", metavar="PATH",
                   help="gate the report against this ghs-bench-metrics-v1 "
                   "baseline (tools/bench_gate.py)")
    p.add_argument("--time-tolerance", type=float, default=0.5,
                   help="gate wall-time tolerance (CI uses 5.0)")
    p.add_argument("--update-baseline", metavar="PATH",
                   help="write the gate baseline from this run and exit")
    p.add_argument("--device", default="cuda",
                   help="where every solve runs: 'cuda' (default; exits "
                   "non-zero without CUDA) or 'cpu' (the kernels' plain "
                   "PyTorch versions); echo workers touch no device")
    args = p.parse_args(argv)
    if args.ramp:
        args.arrival = "ramp"
    global _WIRE_BINARY
    _WIRE_BINARY = args.wire == "binary"
    if args.wire_legacy_worker is not None:
        if args.wire != "binary":
            p.error("--wire-legacy-worker needs --wire binary")
        if not args.fleet or not 0 <= args.wire_legacy_worker < args.fleet:
            p.error("--wire-legacy-worker K needs --fleet N with "
                    "0 <= K < N")
    if args.kill_worker is not None and (
        not args.fleet or not 0 <= args.kill_worker < args.fleet
    ):
        p.error("--kill-worker needs --fleet N with 0 <= K < N")
    if args.trace_dir and not args.fleet:
        p.error("--trace-dir needs --fleet N (it assembles a multi-process "
                "trace; single-process runs have --jsonl)")
    if args.elastic and not args.fleet:
        p.error("--elastic needs --fleet N (it drives the fleet's pool)")
    if args.elastic and not args.obs_dir:
        # Retired workers' counters are recovered from their obs exports;
        # without the export directory the exact-gated counter checks
        # (fresh solves, chain evictions) would lose the retirees' window
        # activity and pass vacuously.
        p.error("--elastic needs --obs-dir (retired workers' counters "
                "are recovered from their obs exports)")
    if args.elastic:
        mn = (args.elastic_min if args.elastic_min is not None
              else max(1, args.fleet - 1))
        mx = (args.elastic_max if args.elastic_max is not None
              else args.fleet + 1)
        if not 1 <= mn <= args.fleet <= mx:
            p.error(f"--elastic needs 1 <= min ({mn}) <= --fleet "
                    f"({args.fleet}) <= max ({mx})")
    if args.test_echo and not args.fleet:
        p.error("--test-echo needs --fleet N (it is a worker mode)")
    if args.kill_router or args.partition is not None:
        if not args.fleet or not args.test_echo or args.transport != "tcp":
            p.error("--kill-router/--partition need --fleet N --test-echo "
                    "--transport tcp (externally spawned --listen echo "
                    "workers are the topology that survives the fault)")
        if args.kill_router and args.partition is not None:
            p.error("--kill-router and --partition are separate scenarios")
        if args.kill_worker is not None or args.elastic:
            p.error("--kill-router/--partition do not compose with "
                    "--kill-worker/--elastic")
    if args.partition is not None and not 0 <= args.partition < args.fleet:
        p.error("--partition K needs 0 <= K < --fleet")
    if args.test_echo and args.update_heavy:
        p.error("--test-echo cannot run --update-heavy (echo workers have "
                "no stream layer)")
    if args.corrupt_store is not None:
        if args.corrupt_store < 1:
            p.error("--corrupt-store K needs K >= 1")
        if args.fleet or args.kill_router or args.partition is not None:
            p.error("--corrupt-store is its own scenario (it spins its "
                    "own one-worker fleet leg via --payload-chaos)")
    if args.kinds_mixed:
        if (args.fleet or args.corrupt_store is not None or args.kill_router
                or args.partition is not None or args.test_echo
                or args.elastic or args.update_heavy or args.oversize_heavy):
            p.error("--kinds-mixed is its own scenario (it spins its own "
                    "2-worker fleet leg internally)")
    # The device rule, before anything runs: without CUDA and without
    # --device cpu, a non-zero exit.
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"load_drill: {e}")

    report = (
        run_kinds_drill(args) if args.kinds_mixed
        else run_corrupt_drill(args) if args.corrupt_store is not None
        else run_drill(args)
    )
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    brief = {
        k: report[k]
        for k in ("schema", "config", "wall_s", "checks", "ok",
                  "events_dropped", "chaos")
    }
    brief["classes"] = {
        cls: {
            "sent": c["sent"],
            "goodput_per_sec": round(c["goodput_per_sec"] or 0, 2),
            "p50_s": round(c["latency_s"].get("p50", 0), 4),
            "p95_s": round(c["latency_s"].get("p95", 0), 4),
            "p99_s": round(c["latency_s"].get("p99", 0), 4),
        }
        for cls, c in report["slo"]["classes"].items()
    }
    print(json.dumps(brief, indent=2))

    if args.update_baseline:
        with open(args.update_baseline, "w") as f:
            json.dump(report["gate_metrics"], f, indent=2)
            f.write("\n")
        print(f"load baseline written: {args.update_baseline}")
        return 0 if report["ok"] else 1

    gate_ok = True
    if args.gate_baseline:
        gate_ok, lines = run_gate(
            report, args.gate_baseline, args.time_tolerance
        )
        for line in lines:
            print(line)
        workload = report["config"]["workload"]
        print(f"load gate ({workload}): {'PASS' if gate_ok else 'FAIL'}")

    print(f"load drill: {'PASS' if report['ok'] and gate_ok else 'FAIL'}")
    return 0 if report["ok"] and gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
