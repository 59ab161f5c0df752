#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``distributed_ghs_implementation_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing a line:

1. build: compile the CUDA kernels from ``csrc/`` (or find them cached under
   ``build/kernels/``) and the native host library from ``native/`` (under
   ``build/native/``).
2. main path, fourteen paths, each with every kernel launch count set to 0
   just before it and read just after:
   a. flat: the public entry points solve the README sample, the fixture
      deck, RMAT-13 (``auto``) and RMAT-18 (``fused`` and ``stepped``, cold
      and warm). Every fused solve of L levels must launch K1 L times and K2
      L - 1 times. The library loads, and the K4 self-check runs, at the
      first solve.
   b. ELL: ``solve_graph(strategy="ell")`` on the fixture deck and on
      RMAT-18, cold (which builds the ELL buckets on the host) and warm.
      Every ELL solve of L levels must launch K3 L - 1 times (one launch a
      level past the identity level, whatever the bucket count) and K1 L
      times, and take as many levels as the fused solve.
   c. gather: the gather microbenchmark (``gather_probe``) at 2^24 and 2^26
      indices, K5 against ``torch.index_select``.
   d. rank: ``solve_graph(strategy="rank")`` on the fixture deck, then
      ``minimum_spanning_forest`` (``auto``, the rank solver at these sizes)
      on RMAT-18 (dense: the speculative route), ``road_grid_graph(2048,
      2048, seed=1)`` (grid: the host-L2 route),
      ``random_road_network(1024, 1024, seed=1)`` (sparse: host-L2), and
      the filter-Kruskal route's two dense graphs: RMAT-20 ef 16 seed 24
      (under the census size: the speculative filtered program from the
      host level 2; its forest weight also against the recorded 35,737,768)
      and RMAT-21 ef 16 seed 1 (the filtered solve from the host level 2,
      the fused filter), cold, warm, and once more reading back the form
      and jumps of every K1 launch. Prints each solve's time, edges/s,
      levels, route, census chain (``f_size`` of each shrink), the alive
      counts each finish started from (on the filter route: the prefix's,
      then the filter's survivors) and K1 launches.
   e. supervision (``_supervision_path``): supervised solves with no fault
      on RMAT-18, the road grid and RMAT-21 (the unsupervised route, timed
      in turns against the plain warm solve), a degrade to the stepped rung
      (RMAT-18; K1 once a level), the watchdog (the road grid), checkpointed
      solves of the road grid and RMAT-21 with every save timed, resumes
      from the first and the second chunk boundary and from a torn
      primary over the first boundary's state (to a mid-solve ``.bak``),
      the hooked RMAT-18 solve against the speculative one, the
      instrumented rank solve of the road grid, and a ``profiler_trace``
      that names K1.
   f. batch and serve (``_batch_serve_path``): ``solve_lanes`` at 16 lanes,
      fused and vmap, over 16 RMAT-13 ef 16 graphs (seeds 1-16, one bucket:
      K1 at n = 2^17, the grid form), 16 128-vertex graphs (n = 2,048, the
      block form) and 16 graphs of the ceiling bucket (n = 2^20): a fused
      batch of L levels launches K1 L times and K2 L - 1 times, L the most
      levels a graph takes alone, and vmap reports each graph's own; the
      batch API over a deck of both sets with a partial batch and RMAT-18
      (over the ceiling: the supervised rank route), and 8 threads
      submitting; ``run_warmup`` over the deck's buckets, then the deck
      again with no ``compile.miss``; the deck through ``SolveScheduler``
      twice (the second pass all from the cache, no K1 or K2 launch), 8
      callers of one graph (one solve, 7 joins), a disk store round trip;
      inserts, tree-edge deletes and reweights on RMAT-13 through
      ``DynamicMST``; and times in turns: graphs/s of a fused batch, of
      vmap and of 16 serial solves, ``solve_many`` pipelined against
      synchronous, the build of a bucket.
   g. the service (``_service_path``): a request deck through the port's
      ``serve_loop`` (16 batch lanes, ``verify="bulk=full"``, the RMAT-18
      stream buckets warmed): the README sample, RMAT-13 and 16
      ``gnm_random_graph(128, 500)`` graphs as JSON edges, RMAT-18 by
      ``graph_path`` (certified inline), a repeat of each from the cache,
      a ``cached_only`` hit and miss, the kinds ``components``, ``k_msf``,
      ``bottleneck`` and ``path_max`` at RMAT-13 and RMAT-18, 12 updates on
      RMAT-13, a stream on RMAT-18 with windows of 256 and 4,096 updates
      from ``random_update_stream``, a window that coalesces to a no-op, a
      publish on a stale head and a poll, the RMAT-18 answer certified with
      ``engine="torch"`` on the card and with ``np``, and a corrupted answer
      refused and corrected; then the same deck through ``serve_frames`` on
      a fresh service (RMAT-13 and RMAT-18 as B-frame sections), every
      answer equal to ``serve_loop``'s; then a restart over the stream root,
      which must replay every window with no fresh solve. Every window's cut
      pass runs K2 over e = 2^23 slots and K1 at n = 2^18, one launch each a
      round. Prints the latency of each request by op and source, a
      window's split (host apply, cut pass, cycle pass, log append), the
      certify engines' times, JSON against B-frame ingest at RMAT-13 and
      RMAT-18, and ``warm_window_kernels``' time a bucket.
   h. the sharded solvers (``_sharded_path``), 4 shards on the card: the
      fixture deck (but the README sample) through ``flat``, ``ell``,
      ``rank``, filtered and ``rank64``, each equal to the single-card solve;
      ``solve_graph_sharded(strategy="auto")`` on RMAT-18, the road grid
      (with the gather budget lowered so that the capacity guard runs),
      RMAT-20 (the sharded filter; weight 35,737,768) and RMAT-21, and
      ``rank64=True`` on RMAT-18, cold, warm, in turns beside the
      single-card ``auto`` solve and once under the profiler; a gloo group
      of 2 processes of 2 shards each on ``cuda:0`` (RMAT-12 and RMAT-18,
      ``rank`` and ``ell``, after checking gloo's collectives on CUDA
      tensors) and an NCCL group of one process (RMAT-12), each in its own
      processes (``chip_smoke.py --group-child``); ``MSTService(
      sharded_lane=4)``: RMAT-18 routed ``sharded_lane``, a resident repeat,
      12 updates written in place and a wide one restaged, no
      ``compile.miss`` after ``precompile``, a sharded stream of two windows
      and a restart that re-stages before it replays; the supervisor's
      sharded rung and a sharded checkpoint resumed from the head.
   i. the protocol, the chaos drill, the tuner and the build cache
      (``_protocol_tune_path``): ``backend="protocol"`` on the fixture deck
      and ``erdos_renyi_graph(45, 0.15)`` seeds 0-7, each forest equal to
      the card's ``backend="device"`` solve and the oracle, with its
      seconds, levels and messages by kind; ``run_chaos_drill(fast=True)``
      with its solver and checkpoint legs on the card, every case ok;
      ``tune.search`` over the three lane buckets of phase f at 16 lanes
      and RMAT-18's ``ell`` bucket (each candidate's median and spread,
      the winner), the record installed by a fresh ``run_warmup``, then a
      16-lane batch of each set and the RMAT-18 ELL solve under the
      installed configs (no ``compile.miss`` after the warmup); and a
      child process that loads both libraries from this run's ``build/``
      through ``utils.compile_cache`` with hits only.
   j. the fleet (``_fleet_path``): a pipe fleet of 2 workers on the card
      (16 batch lanes, a shared disk store, the build cache at ``build/``)
      answers the fixture deck, phase f's 21 128-vertex graphs sent together,
      4 RMAT-13 as B-frames and RMAT-18 by ``graph_path``, a cached repeat of
      each on the worker that solved it, and 12 updates pinned to one RMAT-13
      session; a kill drill (worker 0 dies in place of its 3rd request: every
      request answered, one restart, whose new incarnation loads both
      libraries from the build cache); a ``--listen`` worker in a thread of
      this process (its launches count) behind a TCP router with the chaos
      layer: a one-way partition that expires the lease and heals warm, and a
      corrupted answer the router's certificate rejects and re-dispatches;
      then a drain, every worker exiting 0. Prints each worker's seconds from
      spawn to hello, the hello caps (``kernel`` "cuda"), and by request
      class the latency through the router and the router hop beside phase
      g's in-process service.
   k. the front ends (``_front_end_path``), through ``cli.main`` in this
      process (its launches count): ``generate --kind rmat --rmat-scale 18
      --npz`` then ``run --verify --metrics-out`` on it (``auto``: the rank
      solver, K1); a reference-format partition dir through ``generate``,
      ``run --verify`` and ``verify --result``; ``experiments --extended``
      (9 records, all correct); ``serve --input`` over a JSONL deck (the
      fixture deck as JSON edges, RMAT-13 by ``graph_path``) in one process
      and through ``serve --fleet 2`` (worker processes on the card); ``run
      --backend sharded`` on RMAT-13; ``trace`` and ``stats``; ``tune
      --buckets 2048x8192 --lanes 16``; ``chaos``; then
      ``entry.dryrun_multichip(4)`` (four shards on the card), a cold
      ``strategy="ell"`` RMAT-18 solve with its ELL buckets from the native
      library against the NumPy form, in turns (K3), and one ``python -m
      distributed_ghs_implementation_tpu_torch run --verify`` subprocess.
      Every CLI step must exit 0 and every forest equal the rank oracle;
      K1, K2 and K3 must launch.
   l. the benchmark (``_bench_path``): every workload of the port's
      ``bench.py`` once in this process (its launches count), through
      ``cli.main(["bench", ...])`` where the CLI reaches it: RMAT-20 ef 16
      seed 24 (weight 35,737,768; K1), ``--backend sharded`` at RMAT-18, the
      16-lane batch and the update stream (K1, K2); then through the bench
      module's ``main``: the certify engines, the query kinds (K1), the
      tuned launch configs (K1, K2), the sharded lane (K1) and the sharded
      stream, each at its defaults, and the echo fleets of ``--fleet-tcp``
      (50 requests, 2 forwards) and ``--wire`` (8 graphs, 1 repeat), cut
      because a fleet's time is its spawn. Every workload must exit 0 with
      its JSON line last, carry the card, and pass its own exact fields
      (weights, parity, counters).
   m. the open-loop load drill (``_load_drill_path``), each run through
      ``load_drill.main`` in this process at JAX's ``--smoke`` defaults
      (a 10 s window, seed 23): the in-process service with ``--chaos``
      (hit, miss, batch, dup, update and oversize classes from 16 client
      threads, faults armed mid-flight) and with ``--update-heavy``
      (published windows and polls on 3 subscribed streams; K1 and K2 must
      launch in these), ``--kinds-mixed`` (its 2-worker fleet leg on the
      card), ``--fleet 2 --kill-worker 1`` on workers that solve on the
      card, and ``--fleet 3 --kill-router --transport tcp --test-echo``.
      Every report must be ``ok`` with ``lost_accepted`` 0 and carry the
      card; prints per class p50/p95/p99 and goodput, and the window's
      ``compile.*``.
   n. the public surface (``_surface_path``), only through the package
      exports: ``ops.fragment_moe`` and ``ops.hook_and_compress`` at
      RMAT-18's level 1 (K2, K1; equal to the torch forms on CPU copies),
      ``models.solve_graph`` and ``parallel.make_sharded_solver`` (4 shards)
      on RMAT-13, ``utils.verify_result(oracle="auto")`` on RMAT-20 and
      RMAT-21 (the native Kruskal pass, timed beside SciPy's weight of the
      same graph), SciPy's RMAT-18 weight against the native one, and
      RMAT-20's rank endpoints staged as int32 copies and over the 24-bit
      wire, equal on the card.
   Every forest must equal the SciPy rank oracle edge for edge, and every
   weight the native Kruskal pass's (SciPy's for float weights); every
   kernel of a path must have launched in it.
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, element-exact (all state is integer, tolerance 0), over a range of
   sizes: K1 in the form ``auto`` picks and in both forced forms, around
   the block form's threshold, up to 2^22, on chains (every jump needed),
   on phase 2i's traced lane-bucket inputs in every form valid at their n,
   on nothing hooked (the first jump ends the round) and on cyclic garbage
   (no jump does); K1 on its own inputs from the rank path's traced run,
   at every n it ran there (the census spaces of the road grid and the
   road network among them); K3 per bucket and as one level over RMAT-18's
   own buckets and random bucket sets, and at each tile the tuner searches
   on phase 2i's traced RMAT-18 level. Then the profiler shows one device kernel for one K1
   call and one for one K3 level. Then the K4 wrapper's host time over 10^4
   calls, split into the steps of the launch path, beside ``torch.take``'s;
   then the two choices this run measures for K1 and K3 (block form
   against grid form by n, in turns; K3's tile size); then kernel, plain
   version and (where one exists) the one PyTorch call for the same
   function timed with CUDA events at the main path's shapes: RMAT-18's
   level-1 inputs for K1, K2 and K3 (K3 as its one launch a level; K1 also
   at RMAT-13's level-1 inputs and, in the grid form, at the road grid's
   first card level taken in its vertex space, n = 2^22, with the form run
   and the jumps taken at every RMAT-18 level, at every n the filter
   route's traced run gave it, and at every level of the lane batches at
   the stacked n and at one lane; K2 also on the 16-lane stacks; K2 and K1
   on the first round of a stream window's cut pass), 2^24 and
   2^26 indices for
   K5, and K1 and K3 by the profiler's device time too. A kernel and its library call (K4 and
   ``torch.take``, K5 and ``torch.index_select``) are timed in turns, and
   K5's rate of L2 sectors (m x 32 B over its time) is printed beside it.
4. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits non-zero without the last line. The script
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_SECTOR_BYTES = 32  # what one random 4 B read costs the L2
HOST_CALLS = 10_000
TURNS = 20  # turns of each side where two solves are timed against each other
PROFILER_PAD_S = 0.05  # host time inside a profiler session before and after its calls
PROFILER_LAGS: list = []  # each profiler session's least launch-to-kernel lag, ms
# The SciPy oracle's forest weight of RMAT-20 ef 16 seed 24 on the native
# generator's stream, as the JAX package's bench.py records it.
RMAT20_ORACLE_WEIGHT = 35_737_768
FILTER_GRAPHS = ("rmat20", "rmat21")
JAX_OPS = "distributed_ghs_implementation_tpu/ops"
PORT = "distributed_ghs_implementation_tpu_torch"
#: The source of a kernel whose wrapper's name is not its file's.
SOURCE_OF = {"rank_endpoints": "rank_order"}


def _fixture_deck(Graph, gen):
    """The multichip dry-run's fixtures: ER, RMAT-12, road, a 23-component
    forest and the README sample."""
    rng = np.random.default_rng(11)
    parts, base = [], 0
    for nn in (70, 50, 40):  # three components + 20 isolated vertices
        comp = gen.rmat_graph(7, 4, seed=nn)
        keep = (comp.u < nn) & (comp.v < nn)
        parts.append(np.stack([comp.u[keep] + base, comp.v[keep] + base, comp.w[keep]], 1))
        ids = np.arange(nn - 1)
        parts.append(np.stack([ids + base, ids + 1 + base, rng.integers(1, 255, nn - 1)], 1))
        base += nn
    edges = np.concatenate(parts)
    return {
        "er48": gen.erdos_renyi_graph(48, 0.2, seed=11),
        "rmat12": gen.rmat_graph(12, 8, seed=11),
        "road40": gen.random_road_network(40, 40, seed=11),
        "forest23": Graph.from_arrays(base + 20, edges[:, 0], edges[:, 1], edges[:, 2]),
        "readme": gen.readme_sample_graph(),
    }


def _hook_forest(rng, n: int, kind: str):
    """``(has, dst_frag, fragment)`` whose hook graph is a forest whose only
    cycles are mutual pairs, as a real MOE round gives."""
    ids = np.arange(n, dtype=np.int64)
    has = np.zeros(n, dtype=bool)
    dst = rng.integers(0, max(n, 1), size=n)  # garbage where has is False
    if kind == "random":
        perm = rng.permutation(n)
        k = np.arange(n)
        pick = (rng.random(n) * k).astype(np.int64)  # an earlier position
        hooked = (rng.random(n) < 0.8) & (k > 0)
        has[perm[hooked]] = True
        dst[perm[hooked]] = perm[pick[hooked]]
        roots = rng.permutation(perm[~hooked])
        half = (roots.size // 4) * 2  # pair up about half of the roots
        a, b = roots[:half:2], roots[1:half:2]
        has[a] = has[b] = True
        dst[a], dst[b] = b, a
    elif kind == "star":
        centre = n // 2
        has[:] = True
        dst[:] = centre
        dst[centre] = 0 if centre else centre  # centre <-> 0 is a mutual pair
        has[centre] = centre != 0
    elif kind == "chain":
        has[1:] = True
        dst[1:] = ids[:-1]
    elif kind == "cycle":  # garbage no round gives: one n-cycle, never a fixpoint
        has[:] = True
        dst = (ids + 1) % max(n, 1)
    elif kind != "none":  # "none" hooks nothing: the first jump changes nothing
        raise ValueError(kind)
    fragment = rng.integers(0, max(n, 1), size=n)
    return has, dst.astype(np.int32), fragment.astype(np.int32)


def _ell_bucket(rng, n: int, rows: int, width: int, *, fragments: int, sorted_rows: bool):
    """A random ELL bucket ``(fragment, verts, dstb, rankb)``: about a tenth
    of the slots pad (rank INT32_MAX), the last row is a pad row of vertex 0,
    and the fragment labels take ``fragments`` values, so that few or many
    slots stay inside their row's fragment."""
    fragment = rng.integers(0, fragments, n).astype(np.int32)
    verts = rng.integers(0, n, rows).astype(np.int32)
    dstb = rng.integers(0, n, (rows, width)).astype(np.int32)
    rankb = rng.integers(0, 2**31 - 1, (rows, width)).astype(np.int32)
    rankb[rng.random((rows, width)) < 0.1] = 2**31 - 1
    if sorted_rows:
        rankb.sort(axis=1)
    verts[-1], dstb[-1], rankb[-1] = 0, 0, 2**31 - 1
    return fragment, verts, dstb, rankb


def _k7_weights64(rng, kind: str, m: int):
    """K7's 64-bit cases of ``m`` weights: float64 ``"specials"`` (both
    zeros, both infinities, subnormals, NaN of either sign, heavy ties, a
    third drawn normal), ``"unit"`` (uniform in [0, 1)) and int64
    ``"wide"`` (over 2^22 values, -2^62 and 2^62 among them)."""
    if kind == "unit":
        return rng.random(m)
    if kind == "wide":
        w = rng.integers(-(1 << 62), 1 << 62, m, dtype=np.int64)
        w[m // 2], w[0] = 1 << 62, -(1 << 62)
        return w
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 5e-324, -5e-324,
                         2.2250738585072014e-308, 1.5, -1.5, 0.25])
    w = rng.choice(specials, m)
    free = rng.random(m) < 0.3
    w[free] = rng.standard_normal(int(free.sum()))
    return w


def _max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    torch.cuda.synchronize()
    return err


def _in_turns(timer, kern, library, iters: int = 10) -> dict:
    """Kernel and library call timed in turns: medians and spreads."""
    t = timer(kern, library, iters=iters)
    return {"ms": t["a_ms"], "ms_spread": t["a_spread_ms"],
            "library_ms": t["b_ms"], "library_ms_spread": t["b_spread_ms"]}


def _skewed_rank_endpoints(torch, dev, scale: int, m_pad: int, m: int):
    """Rank endpoints shaped like a Graph500 graph's, made on the card: each
    endpoint's id bits set with probability 0.24 (the initiator's B + D and
    C + D), the ids then permuted as Graph500 permutes its labels, so a few
    hubs hold most ranks; ranks past ``m`` are pads (``ra == rb == 0``).
    Returns ``(ra, rb, m, n_pad)`` with ``n_pad = 2**scale``."""
    gen = torch.Generator(device=dev).manual_seed(20)
    perm = torch.randperm(1 << scale, generator=gen, device=dev).to(torch.int32)
    ends = []
    for _ in range(2):
        ids = torch.zeros(m_pad, dtype=torch.int32, device=dev)
        for bit in range(scale):
            ids |= (torch.rand(m_pad, generator=gen, device=dev) < 0.24).to(torch.int32) << bit
        ids = perm[ids]
        ids[m:] = 0
        ends.append(ids)
    return ends[0], ends[1], m, 1 << scale


def _device_kernels(torch, fn, calls: int, attempts: int = 6) -> list:
    """``(name, us)`` of every device kernel that ``calls`` calls of ``fn``
    ran, by the profiler. The calls are warmed outside the session and sit
    inside it with ``PROFILER_PAD_S`` of host time before and after them:
    Kineto keeps only the device records whose time falls inside the
    session on the host's clock, and late in a long run the device's clock
    stands off the host's by milliseconds (a kernel can seem to start before
    its launch). There a session padded by 0.05 s or less lost some or all
    of its records, and one padded by 0.1-0.2 s kept them all. A session
    that recorded fewer device kernels than ``calls`` is run again with
    twice the pad, up to ``attempts`` sessions, and says so on stderr;
    every other retry takes the profiler's schedule instead (a warm-up step
    of the same calls, then the step it keeps; the step's own range on the
    device track is not a kernel). Each session's least lag from a launch on
    the host to its kernel's start on the device goes into ``PROFILER_LAGS``.
    The callers check what the last session returns, so a session with more
    kernels than calls, or another kernel's name, still fails."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        pad_s = PROFILER_PAD_S * 2 ** attempt
        if attempt:
            print(f"profiler: session {attempt} recorded {len(kerns)} device kernels for "
                  f"{calls} calls (least launch-to-kernel lag {_ms_or_not(lag)} ms); again "
                  f"with {pad_s:.2f} s of pad", file=sys.stderr)
        torch.cuda.synchronize()
        if attempt % 2:
            schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
            with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
                for step in range(2):
                    time.sleep(pad_s * step)
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    time.sleep(pad_s * step)
                    prof.step()
        else:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(pad_s)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad_s)
        kerns = [(evt.name, evt.time_range.end - evt.time_range.start)
                 for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and not evt.name.startswith("ProfilerStep")]  # the step's own range
        lag = _launch_lag_ms(torch, prof)
        if lag is not None:
            PROFILER_LAGS.append(lag)
        if len(kerns) >= calls:
            return kerns
    return kerns


def _launch_lag_ms(torch, prof):
    """The least time from a launch's start on the host to its kernel's
    start on the device, in ms, over a session's kernels (records matched
    by correlation id), or ``None`` where the session kept no kernel."""
    launch, kernel = {}, {}
    for evt in prof.profiler.kineto_results.events():
        if not evt.correlation_id():
            continue
        side = kernel if evt.device_type() == torch.autograd.DeviceType.CUDA else launch
        side.setdefault(evt.correlation_id(), evt.start_ns())
    lags = [kernel[c] - launch[c] for c in kernel if c in launch]
    return min(lags) / 1e6 if lags else None


def _device_ms(torch, fn, calls: int):
    """The median device ms of one call of ``fn`` by the profiler, or
    ``None`` where every session of :func:`_device_kernels` came back
    without a device record. Only for a time printed beside its CUDA-event
    time: a check of what ran on the card reads :func:`_device_kernels`."""
    kerns = _device_kernels(torch, fn, calls)
    return statistics.median(us for _, us in kerns) / 1e3 if kerns else None


def _ms_or_not(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _host_us(torch, fn) -> float:
    """Host microseconds a call of ``fn`` over ``HOST_CALLS`` calls, from a
    synchronised card to a synchronised card."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t) / HOST_CALLS / 1e3


def _probe_host_split(torch, kernels, build, table, idx, idx64) -> dict:
    """Host us a call of the K4 wrapper and of each step of its launch path
    (``rest`` is the wrapper less the steps: the Python between them and the
    ``data_ptr`` reads), with ``torch.take`` beside it. Then what the launch
    path no longer pays, on this host: the same launcher called through
    ``ctypes`` instead of the extension module, a ``torch.cuda.Stream``
    object, and a set of ``torch.device``s."""
    import ctypes

    lib = kernels._lib()
    device = idx.get_device()
    stream = kernels._current_stream(device)
    out = torch.empty_like(idx)
    args = (device, table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), stream)
    via_ctypes = ctypes.CDLL(str(build.library_path())).ghs_probe
    via_ctypes.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p]
    via_ctypes.restype = ctypes.c_int
    if lib.probe(*args) or via_ctypes(*args):
        raise AssertionError("probe launcher failed")
    split = {
        "wrapper": _host_us(torch, lambda: kernels.probe(table, idx)),
        "validate": _host_us(
            torch, lambda: kernels._validate("probe", {"table": table, "idx": idx})),
        "allocate": _host_us(torch, lambda: torch.empty_like(idx)),
        "stream": _host_us(torch, lambda: kernels._current_stream(device)),
        "binding_and_launch": _host_us(torch, lambda: lib.probe(*args)),
    }
    split["rest"] = split["wrapper"] - sum(v for k, v in split.items() if k != "wrapper")
    split["torch_take"] = _host_us(torch, lambda: torch.take(table, idx64))
    split["old_ctypes_and_launch"] = _host_us(torch, lambda: via_ctypes(*args))
    split["old_stream_object"] = _host_us(
        torch, lambda: torch.cuda.current_stream(idx.device).cuda_stream)
    split["old_device_set"] = _host_us(torch, lambda: {t.device for t in (table, idx)})
    split["wrapper_again"] = _host_us(torch, lambda: kernels.probe(table, idx))
    return split


def _k1_summary(trace) -> list:
    """``(n, form, jumps)`` of each K1 launch, grouped by n and form in the
    order they first ran."""
    groups = {}
    for n, form, jumps in trace:
        groups.setdefault((n, form), []).append(jumps)
    return [{"n": n, "form": form, "launches": len(j), "jumps": j}
            for (n, form), j in groups.items()]


def _answered(call):
    """``call()``, and the route its rank solve answered on: the ``route``
    of the last ``solver.rank.solve`` span the call left on the event
    bus."""
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    mark = BUS.mark()
    res = call()
    routes = [rec[6]["route"] for rec in BUS.events_since(mark) if rec[1] == "solver.rank.solve"]
    return res, routes[-1]


def _rank_path(torch, kernels, rank_solver, boruvka, msf, deck, graphs, check) -> dict:
    """The rank solver's main path: the fixture deck through
    ``solve_graph(strategy="rank")``, then RMAT-18, the 2048 x 2048 road
    grid, the 1024 x 1024 random road network, RMAT-20 and RMAT-21 through
    ``minimum_spanning_forest`` (``auto``), cold, warm, and once more with
    the form and jumps of each K1 launch read back (a sync a launch, so
    that run is not timed). Records the route that answered, the census
    chain (``f_size`` of each shrink), the prefix of the filter route and
    the alive count each finish started from, by wrapping the solver's
    functions. Returns the records and K1's inputs at the first traced
    launch of each (graph, n): the real shapes and data of the path, census
    spaces included, for the check against the plain version. The route
    comes from the solve's own span on the event bus."""
    census, trace, finishes, prefixes = [], [], [], []
    k1_inputs, current = {}, []
    saved = {name: getattr(rank_solver, name) for name in (
        "_shrink_and_run", "_finish_to_fixpoint", "_filtered_head", "_speculative_tail",
        "hook_and_compress")}
    hook = saved["hook_and_compress"]

    def spy(name):
        def call(*a, **k):
            out = saved[name](*a, **k)
            if name == "_shrink_and_run":
                census.append(k["f_size"])
            elif name == "_finish_to_fixpoint":
                finishes.append(k["count"])
            elif name == "_speculative_tail":
                finishes.append(dict(zip(("levels", "prefix_alive_after_head",
                                          "prefix_alive_at_end", "filter_survivors",
                                          "survivors_alive_at_end"), out[2])))
            else:
                prefixes.append(k["prefix"])
            return out
        return call

    def traced_hook(has, dst, fragment):
        key = (current[-1], fragment.numel())
        if key not in k1_inputs:
            k1_inputs[key] = tuple(t.clone() for t in (has, dst, fragment))
        out = hook(has, dst, fragment)
        jumps, form = kernels.hook_compress_readout()
        n = fragment.numel()
        if form != ("block" if n <= kernels.HOOK_BLOCK_FORM_THRESHOLD else "grid"):
            raise AssertionError(f"K1 at n={n} ran the {form} form")
        trace.append((n, form, jumps))
        return out

    for name in saved:
        if name != "hook_and_compress":
            setattr(rank_solver, name, spy(name))
    out = {}
    try:
        for name, g in deck.items():
            ids, _, _ = boruvka.solve_graph(g, strategy="rank")
            check(name, ids, float(g.w[ids].sum()))
        for name in ("rmat18", "grid2048", "road1024") + FILTER_GRAPHS:
            g = graphs[name]
            if g.num_edges < boruvka.ELL_AUTO_EDGE_THRESHOLD:
                raise AssertionError(f"{name}: {g.num_edges} edges, auto would not take rank")
            family = rank_solver._pick_family(g)
            filtered = rank_solver.use_filtered_path(family, boruvka._bucket_size(g.num_edges))
            if filtered != (name in FILTER_GRAPHS):
                raise AssertionError(f"{name}: the filter route {'taken' if filtered else 'not'}")
            rec = {"family": family}
            current.append(name)
            for run in ("cold", "warm", "traced"):
                for log in (census, trace, finishes, prefixes):
                    log.clear()
                if run == "traced":
                    rank_solver.hook_and_compress = traced_hook
                k1 = kernels.hook_compress.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                res, route = _answered(lambda: msf(g))
                wall = time.perf_counter() - t
                rank_solver.hook_and_compress = hook
                check(name, res.edge_ids, float(g.w[res.edge_ids].sum()))
                k1 = kernels.hook_compress.launches - k1
                if run == "traced":
                    if k1 != len(trace):
                        raise AssertionError(f"{name}: K1 x{k1} but {len(trace)} traced")
                    rec["k1"] = _k1_summary(trace)
                    continue
                if filtered and not route.startswith("filtered") or k1 < 1:
                    raise AssertionError(f"{name}: route {route}, K1 x{k1}")
                rec[run] = {"s": wall, "edges_per_s": g.num_edges / wall,
                            "levels": res.num_levels, "route": route,
                            "census_f_sizes": list(census), "k1_launches": k1}
                if filtered:
                    rec[run].update(prefix=prefixes[-1], finishes_from=list(finishes))
            out[name] = rec
    finally:
        for name, fn in saved.items():
            setattr(rank_solver, name, fn)
    return out, k1_inputs


def _supervision_path(torch, kernels, rank_solver, msf, graphs, oracle, check,
                      scratch) -> dict:
    """Supervised solves, checkpoint and resume, and the per-level metrics,
    on the card, each against the oracle:

    * supervised, no fault, through ``minimum_spanning_forest(supervised=
      True)`` on RMAT-18, the road grid and RMAT-21: one ``device#1 ok``
      and the unsupervised route; the supervised and the plain warm solve
      timed in turns by CUDA events (20 turns each);
    * degrade: RMAT-18 with the device rung's attempt site armed twice
      (no backoff): ``device transient`` twice, then the stepped rung, which
      launches K1 once a level and K2 never: it relabels its slots to
      fragment ids every level, so each level's minimum takes the identity
      form (as in the JAX package);
    * watchdog: the road grid under a 60 s deadline with the device rung's
      slow site armed twice at 3600 s: ``device timeout`` twice, then the
      stepped rung;
    * checkpoint and resume: ``solve_graph_checkpointed(strategy="rank",
      every=1)`` on the road grid and RMAT-21 (each save timed), resumes
      from the states saved at the first and the second chunk boundary
      (off the filter route with the uninterrupted level count), and a
      resume from a torn primary: the first boundary's state saved, the
      second's save torn, so the resume falls back to a mid-solve ``.bak``,
      warns, and finishes the solve from there; the hooked (chunked)
      RMAT-18 solve timed against the unhooked (speculative) one in turns;
    * the instrumented rank solve of the road grid: one ``metrics.level``
      record a chunk boundary, the last with the component count;
    * ``profiler_trace`` around a warm RMAT-18 solve: its trace names K1.
    """
    import warnings

    from distributed_ghs_implementation_tpu_torch.device import cuda_time_in_turns_ms
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.utils import checkpoint, metrics, resilience

    out = {}
    faults = resilience.FAULTS
    faults.reset()

    def trail(log):
        return [f"{r.rung} {r.outcome}" for r in log.records]

    # Supervised, no fault.
    t = time.perf_counter()
    for name in ("rmat18", "grid2048", "rmat21"):
        g = graphs[name]
        plain, plain_route = _answered(lambda: msf(g))
        sup, sup_route = _answered(lambda: msf(g, supervised=True))
        check(name, sup.edge_ids, float(g.w[sup.edge_ids].sum()))
        if trail(sup.incidents) != ["device ok"] or sup.backend != "supervised/device":
            raise AssertionError(f"{name}: supervised {sup.backend} {sup.incidents.summary()}")
        if sup_route != plain_route or sup.num_levels != plain.num_levels:
            raise AssertionError(f"{name}: supervised route {sup_route}, {sup.num_levels} levels; "
                                 f"plain {plain_route}, {plain.num_levels} levels")
        turns = cuda_time_in_turns_ms(lambda: msf(g, supervised=True), lambda: msf(g),
                                      reps=TURNS, iters=1)
        out[f"supervised_{name}"] = {"route": sup_route, "levels": sup.num_levels,
                                     "turns": TURNS, "supervised_ms": turns["a_ms"],
                                     "supervised_spread_ms": turns["a_spread_ms"],
                                     "plain_ms": turns["b_ms"],
                                     "plain_spread_ms": turns["b_spread_ms"]}
    out["supervised_phase_s"] = time.perf_counter() - t

    # Degrade to the stepped rung.
    t = time.perf_counter()
    g = graphs["rmat18"]
    k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
    with faults.inject("resilience.attempt.device", times=2):
        res = msf(g, supervisor=resilience.Supervisor(resilience.SupervisorConfig(
            backoff_base_s=0)))
    check("rmat18", res.edge_ids, float(g.w[res.edge_ids].sum()))
    k1, k2 = kernels.hook_compress.launches - k1, kernels.gather_key.launches - k2
    want = ["device transient", "device transient", "stepped ok"]
    if trail(res.incidents) != want or k1 != res.num_levels or k2:
        raise AssertionError(f"degrade: {res.incidents.summary()}, K1 x{k1}, K2 x{k2}, "
                             f"{res.num_levels} levels")
    out["degrade_rmat18"] = {"trail": trail(res.incidents), "levels": res.num_levels,
                             "hook_compress": k1, "gather_key": k2,
                             "s": time.perf_counter() - t}

    # The watchdog, on the road grid.
    t = time.perf_counter()
    g = graphs["grid2048"]
    config = resilience.SupervisorConfig(deadline_s=60, backoff_base_s=0)
    with faults.inject("resilience.slow.device", times=2, kind="slow", value=3600):
        res = msf(g, supervisor=resilience.Supervisor(config))
    check("grid2048", res.edge_ids, float(g.w[res.edge_ids].sum()))
    if trail(res.incidents) != ["device timeout", "device timeout", "stepped ok"]:
        raise AssertionError(f"watchdog: {res.incidents.summary()}")
    out["watchdog_grid2048"] = {"trail": trail(res.incidents), "levels": res.num_levels,
                                "s": time.perf_counter() - t}

    # Checkpoint and resume.
    saves = []
    save = checkpoint.save_checkpoint

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        path = save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return path

    for name in ("grid2048", "rmat21"):
        t = time.perf_counter()
        g = graphs[name]
        uninterrupted = msf(g).num_levels
        path = str(scratch / f"{name}.npz")
        saves.clear()
        checkpoint.save_checkpoint = timed_save
        try:
            ids, _, levels = checkpoint.solve_graph_checkpointed(g, path, strategy="rank",
                                                                 every=1)
        finally:
            checkpoint.save_checkpoint = save
        check(name, ids, float(g.w[ids].sum()))
        if levels != uninterrupted:
            raise AssertionError(f"{name}: checkpointed {levels} levels, uninterrupted "
                                 f"{uninterrupted}")
        rec = {"levels": levels, "saves": len(saves), "save_s": list(saves),
               "checkpoint_bytes": os.path.getsize(path)}
        # The states at the first and the second chunk boundary, saved from
        # the card, each resumed.
        saved = {1: str(scratch / f"{name}-chunk1.npz"), 2: str(scratch / f"{name}-chunk2.npz")}
        seen = []

        def hook(level, fragment, mst, count):
            seen.append((int(level), int(count)))
            if len(seen) in saved:
                checkpoint.save_checkpoint(saved[len(seen)], fragment, mst, level,
                                           fingerprint=checkpoint.graph_fingerprint(g))

        rank_solver.make_production_solver(g)(on_chunk=hook)
        if len(seen) < 2:
            raise AssertionError(f"{name}: {len(seen)} chunk boundaries")
        filtered = rank_solver.use_filtered_path(rank_solver._pick_family(g),
                                                 rank_solver._bucket_size(g.num_edges))
        rec.update(boundaries=seen, resumed_levels={})
        # Read before the resumes below write their own states over them.
        first, second = (checkpoint.load_checkpoint(saved[k]) for k in (1, 2))
        for k, resume_path in saved.items():
            ids, _, resumed = checkpoint.solve_graph_checkpointed(g, resume_path,
                                                                  strategy="rank")
            check(name, ids, float(g.w[ids].sum()))
            rec["resumed_levels"][f"from_boundary_{k}"] = resumed
            if not filtered and resumed != levels:
                raise AssertionError(f"{name}: resumed from boundary {k} in {resumed} levels, "
                                     f"uninterrupted {levels}")
        # A torn primary over a mid-solve state: the first boundary's state
        # saved, the second's save torn; the resume falls back to the first
        # (the .bak), warns, and finishes the solve from there.
        fingerprint = checkpoint.graph_fingerprint(g)
        torn = str(scratch / f"{name}-torn.npz")
        checkpoint.save_checkpoint(torn, *first, fingerprint=fingerprint)
        with faults.inject("checkpoint.save", times=1, kind="torn"):
            try:
                checkpoint.save_checkpoint(torn, *second, fingerprint=fingerprint)
            except resilience.InjectedFault:
                pass
            else:
                raise AssertionError("the torn save did not raise")
        bak_level = checkpoint.load_checkpoint(torn + ".bak")[2]
        if bak_level != seen[0][0] or bak_level >= levels:
            raise AssertionError(f"{name}: .bak at level {bak_level}, first boundary "
                                 f"{seen[0]}, {levels} levels")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ids, _, torn_levels = checkpoint.solve_graph_checkpointed(g, torn, strategy="rank")
        check(name, ids, float(g.w[ids].sum()))
        rec["torn_resume"] = {"bak_level": bak_level, "levels": torn_levels}
        if (not filtered and torn_levels != levels) or not any(
                "previous generation" in str(w.message) for w in caught):
            raise AssertionError(f"{name}: torn resume {torn_levels} levels, warnings "
                                 f"{[str(w.message) for w in caught]}")
        rec["s"] = time.perf_counter() - t
        out[f"checkpoint_{name}"] = rec

    # The hooked (chunked) RMAT-18 solve against the unhooked (speculative).
    solve = rank_solver.make_production_solver(graphs["rmat18"])
    turns = cuda_time_in_turns_ms(lambda: solve(on_chunk=lambda *a: None), solve,
                                  reps=TURNS, iters=1)
    out["hooked_rmat18"] = {"turns": TURNS, "hooked_ms": turns["a_ms"],
                            "hooked_spread_ms": turns["a_spread_ms"],
                            "speculative_ms": turns["b_ms"],
                            "speculative_spread_ms": turns["b_spread_ms"]}

    # The instrumented rank solve of the road grid.
    t = time.perf_counter()
    g = graphs["grid2048"]
    mark = BUS.mark()
    (ids, _, levels), met = metrics.solve_graph_instrumented(g, strategy="rank")
    check("grid2048", ids, float(g.w[ids].sum()))
    chunks = [rec for rec in BUS.events_since(mark) if rec[1] == "solver.chunk"]
    components = g.num_nodes - oracle["grid2048"].size
    if (len(met.levels) != len(chunks) or met.levels[-1].fragments_after != components
            or met.levels[-1].level != levels):
        raise AssertionError(f"instrumented: {len(met.levels)} records, {len(chunks)} chunks, "
                             f"last {met.levels[-1]}, {components} components")
    out["instrumented_grid2048"] = {
        "records": [(m.level, m.fragments_before, m.fragments_after, m.edges_alive_after)
                    for m in met.levels], "s": time.perf_counter() - t}

    # profiler_trace around a warm RMAT-18 solve.
    t = time.perf_counter()
    with metrics.profiler_trace(str(scratch / "trace")) as path:
        msf(graphs["rmat18"])
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    k1_names = sorted(name for name in names if "hook_compress" in name)
    if not k1_names:
        raise AssertionError("profiler_trace: no hook_compress kernel in the trace")
    out["profiler_trace"] = {"kernels": k1_names, "bytes": os.path.getsize(path),
                             "s": time.perf_counter() - t}
    return out


def _batch_serve_path(torch, kernels, boruvka, msf, sets, set_oracle, graphs, oracle,
                      scratch) -> tuple:
    """The batch lane engine and the serve stack's solve half on the card,
    every forest against the SciPy rank oracle:

    a. lanes: ``solve_lanes`` over 16 lanes of each set (``sets``: 16
       RMAT-13 ef 16 graphs of one bucket, where K1 runs at n = 2^17 in its
       grid form; 128-vertex graphs, n = 2,048, the block form; and 16
       graphs of the ceiling bucket, 2^16 x 2^17, n = 2^20), fused and
       vmap. A fused batch of L levels launches K1 L times and K2 L - 1
       times, L the most levels a graph of it takes alone; vmap reports
       each graph's own levels. K1's inputs are traced at the stacked n and
       at one lane, for the check against the plain version;
    b. engine: ``minimum_spanning_forest_batch`` over the deck (both sets,
       a partial last batch, RMAT-18 over the ceiling, which bypasses to
       the supervised rank route), then 8 threads ``submit`` at once;
    c. warmup: ``run_warmup`` over the deck's buckets after the solver
       cache is cleared, then the request phase of b again, which must add
       no ``compile.miss``;
    d. scheduler and store: the deck through ``SolveScheduler`` with an
       engine twice (the second pass all from the cache, no K1 or K2
       launch), 8 threads asking for one graph (one solve, 7 joins), a disk
       store round trip;
    e. dynamic: inserts, deletes of tree edges and reweights on RMAT-13,
       the forest after each equal to the oracle and a fresh solve, with
       the K1 and K2 launches of the incremental path counted;
    f. times on the card, 20 turns a side by CUDA events (each side ends in
       host reads, so this is the wall clock of the call): a 16-lane fused
       batch against 16 serial ``minimum_spanning_forest`` calls and vmap
       against fused, at both sets, and a fused batch split into its host
       stack and the rest (copies, levels, unpack); ``solve_many``
       pipelined against synchronous; the build of each bucket at warmup.

    Returns the records and the traced K1 inputs ``{(set, lanes, n):
    [(has, dst_frag, fragment) a level]}``.
    """
    import threading

    from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest_batch
    from distributed_ghs_implementation_tpu_torch.batch import lanes, warmup
    from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
    from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy
    from distributed_ghs_implementation_tpu_torch.device import cuda_time_in_turns_ms, cuda_time_ms
    from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.serve import (
        DynamicMST,
        ResultStore,
        SolveScheduler,
        Update,
        solve_cache_key,
    )
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

    out = {}
    BUS.enable()
    lanes.clear_solver_cache()

    def k12():
        return kernels.hook_compress.launches, kernels.gather_key.launches

    def counter(name):
        return BUS.counters().get(name, 0)

    def same(what, ids, want):
        if not np.array_equal(np.sort(ids), want):
            raise AssertionError(f"{what}: forest differs from the rank oracle")

    # a. lanes
    t = time.perf_counter()
    k1_inputs = {}
    for name, gs in sets.items():
        gs16 = gs[:16]
        singles = [msf(g) for g in gs16]
        for i, r in enumerate(singles):
            same(f"{name}[{i}] alone", r.edge_ids, set_oracle[name][i])
        own = [r.num_levels for r in singles]
        n_pad, m_pad = lanes.bucket_key(gs16[0])
        n = 16 * n_pad
        want_form = "block" if n <= kernels.HOOK_BLOCK_FORM_THRESHOLD else "grid"
        rec = {"bucket": [n_pad, m_pad], "lanes": 16, "n": n, "own_levels": own}
        frags = {}
        for mode in ("fused", "vmap"):
            lanes.solve_lanes(gs16, lanes=16, mode=mode)  # builds the bucket
            before = k12()
            torch.cuda.synchronize()
            res = lanes.solve_lanes(gs16, lanes=16, mode=mode)
            d1, d2 = (a - b for a, b in zip(k12(), before))
            _, form = kernels.hook_compress_readout()
            levels = [lv for _, _, lv in res]
            for i, (ids, frag, _) in enumerate(res):
                same(f"{name}[{i}] {mode}", ids, set_oracle[name][i])
            frags[mode] = [frag for _, frag, _ in res]
            want_levels = [max(own)] * 16 if mode == "fused" else own
            if levels != want_levels:
                raise AssertionError(f"{name} {mode}: levels {levels}, want {want_levels}")
            if (d1, d2) != (max(levels), max(levels) - 1) or form != want_form:
                raise AssertionError(f"{name} {mode}: {max(levels)} levels but K1 x{d1}, K2 x{d2}, "
                                     f"K1 {form} form at n={n}")
            rec[mode] = {"levels": sorted(set(levels)), "hook_compress": d1, "gather_key": d2,
                         "k1_form": form}
        if any(not np.array_equal(a, b) for a, b in zip(frags["fused"], frags["vmap"])):
            raise AssertionError(f"{name}: fused and vmap fragments differ")
        # K1's inputs at the stacked n and at one lane, every level.
        hook = boruvka.hook_and_compress
        for count in (16, 1):
            lanes.precompile_bucket(n_pad, m_pad, count)  # keep the build's launch out
            key = (name, count, count * n_pad)
            traced = k1_inputs[key] = []

            def spy(has, dst_frag, fragment, *, form="auto", traced=traced):
                traced.append((has.clone(), dst_frag.clone(), fragment.clone()))
                return hook(has, dst_frag, fragment, form=form)

            boruvka.hook_and_compress = spy
            try:
                lanes.solve_lanes(gs16[:count], lanes=count)
            finally:
                boruvka.hook_and_compress = hook
        out[f"lanes_{name}"] = rec
    out["lanes_phase_s"] = time.perf_counter() - t

    # b. engine
    t = time.perf_counter()
    deck = sets["rmat13"][:16] + sets["small128"] + [graphs["rmat18"]]
    want = set_oracle["rmat13"][:16] + set_oracle["small128"] + [oracle["rmat18"]]
    backends = ["batch/fused"] * (len(deck) - 1) + ["supervised/device"]

    def check_deck(results, what):
        for i, (r, w, b) in enumerate(zip(results, want, backends)):
            same(f"{what} deck[{i}]", r.edge_ids, w)
            if r.backend != b:
                raise AssertionError(f"{what} deck[{i}]: backend {r.backend}, want {b}")

    formed = counter("batch.batches.formed")
    t1 = time.perf_counter()
    check_deck(minimum_spanning_forest_batch(deck), "batch API")
    out["batch_api_cold_s"] = time.perf_counter() - t1
    batches = counter("batch.batches.formed") - formed
    if batches != 3:
        raise AssertionError(f"the deck formed {batches} batches, not 3 (16 + 16 + 5 lanes)")
    engine = BatchEngine(policy=BatchPolicy(max_wait_s=0.05))
    picks = list(range(0, 16, 4)) + list(range(16, 36, 5))
    got = [None] * len(picks)

    def ask(j):
        got[j] = engine.submit(deck[picks[j]]).wait(timeout=300)

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(picks))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        engine.close()
    for j, i in enumerate(picks):
        if got[j] is None:
            raise AssertionError(f"submit from thread {j} did not answer")
        same(f"submit deck[{i}]", got[j].edge_ids, want[i])
    out["engine_phase_s"] = time.perf_counter() - t

    # c. warmup, then the request phase of b again
    t = time.perf_counter()
    lanes.clear_solver_cache()
    mark = BUS.mark()
    misses = counter("compile.miss")
    plan = warmup.WarmupPlan(buckets=tuple(sorted({lanes.bucket_key(g) for g in deck[:-1]})),
                             lanes=16)
    report = warmup.run_warmup(plan)
    builds = {f"{ev[6]['n_pad']}x{ev[6]['m_pad']}": ev[4] / 1e6 for ev in BUS.events_since(mark)
              if ev[1] == "compile.bucket"}
    hits = counter("compile.hit")
    t1 = time.perf_counter()
    check_deck(minimum_spanning_forest_batch(deck), "warm batch API")
    out["batch_api_warm_s"] = time.perf_counter() - t1
    if counter("compile.miss") != misses or counter("compile.hit") - hits != 3:
        raise AssertionError(f"after warmup: compile.miss {counter('compile.miss') - misses}, "
                             f"compile.hit {counter('compile.hit') - hits}")
    out["warmup"] = {"report": report, "build_ms": builds, "compile_miss_after": 0}
    out["warmup_phase_s"] = time.perf_counter() - t

    # d. scheduler and store
    t = time.perf_counter()
    engine = BatchEngine()
    try:
        sched = SolveScheduler(batch_engine=engine)
        first = sched.solve_batch(deck)
        check_deck([r for r, _ in first], "scheduler")
        before = k12()
        second = sched.solve_batch(deck)
        relaunched = [a - b for a, b in zip(k12(), before)]
        second_sources = sorted({s for _, s in second})
        if second_sources != ["cache"] or relaunched != [0, 0]:
            raise AssertionError(
                f"second pass: sources {second_sources}, K1/K2 launches {relaunched}")
    finally:
        engine.close()
    one = gnm_random_graph(128, 500, seed=99)
    one_oracle = rank_oracle_edge_ids(one)
    opened = threading.Event()

    class GatedEngine(BatchEngine):
        """Holds the leader's submit until every other caller has joined
        its flight, so that all of them must coalesce."""

        def submit(self, graph):
            if not opened.wait(timeout=120):
                raise TimeoutError("the callers never joined the flight")
            return super().submit(graph)

    gated = GatedEngine()
    joins, fresh = counter("serve.scheduler.coalesced"), counter("serve.scheduler.fresh_solve")
    answers = []
    try:
        sched = SolveScheduler(batch_engine=gated)
        threads = [threading.Thread(target=lambda: answers.append(sched.solve(one)))
                   for _ in range(8)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 120
        while counter("serve.scheduler.coalesced") - joins < 7 and time.monotonic() < deadline:
            time.sleep(0.005)
        opened.set()
        for th in threads:
            th.join(timeout=300)
    finally:
        gated.close()
    sources = sorted(s for _, s in answers)
    if sources != ["coalesced"] * 7 + ["solved"] or counter("serve.scheduler.fresh_solve") - fresh != 1:
        raise AssertionError(f"8 callers of one graph: {sources}")
    for r, _ in answers:
        same("single flight", r.edge_ids, one_oracle)
    store_dir = str(scratch / "store")
    key = solve_cache_key(one)
    ResultStore(disk_dir=store_dir).put(key, answers[0][0])
    disk_hits = counter("serve.store.disk_hit")
    cold = ResultStore(disk_dir=store_dir).get(key, graph=one)
    if cold is None or counter("serve.store.disk_hit") - disk_hits != 1:
        raise AssertionError("the disk store did not serve its own entry")
    same("disk store", cold.edge_ids, one_oracle)
    out["scheduler"] = {"first_sources": sorted({s for _, s in first}),
                        "second_sources": second_sources, "second_pass_launches": relaunched,
                        "single_flight": "1 solved, 7 joins", "disk_round_trip": key}
    out["scheduler_phase_s"] = time.perf_counter() - t

    # e. dynamic maintenance on RMAT-13
    t = time.perf_counter()
    g = sets["rmat13"][0]
    dyn = DynamicMST(msf(g), resolve_threshold=10**9)
    rng = np.random.default_rng(5)
    wmax = int(g.w.max())
    steps, dyn_k = [], [0, 0]
    for kind in ("insert", "delete", "reweight") * 4:
        tree = np.nonzero(dyn._in_tree)[0]
        if kind == "insert":
            a, b = sorted(int(x) for x in rng.choice(g.num_nodes, 2, replace=False))
            while dyn._find(a, b) >= 0:
                a, b = sorted(int(x) for x in rng.choice(g.num_nodes, 2, replace=False))
            upd = Update("insert", a, b, int(rng.integers(1, wmax + 1)))
        else:
            i = int(rng.choice(tree))
            a, b = int(dyn._u[i]), int(dyn._v[i])
            upd = (Update("delete", a, b) if kind == "delete"
                   else Update("reweight", a, b, wmax + int(rng.integers(1, 100))))
        before = k12()
        r = dyn.apply([upd])
        d = [x - y for x, y in zip(k12(), before)]
        dyn_k = [dyn_k[0] + d[0], dyn_k[1] + d[1]]
        if dyn.last_mode != "incremental":
            raise AssertionError(f"dynamic {upd}: {dyn.last_mode}")
        same(f"dynamic {upd}", r.edge_ids, rank_oracle_edge_ids(r.graph))
        if not np.array_equal(r.edge_ids, msf(r.graph).edge_ids):
            raise AssertionError(f"dynamic {upd}: forest differs from a fresh solve")
        steps.append({"update": [upd.kind, a, b], "hook_compress": d[0], "gather_key": d[1]})
    if min(dyn_k) < 1:
        raise AssertionError(f"dynamic: K1 x{dyn_k[0]}, K2 x{dyn_k[1]} on the incremental path")
    out["dynamic"] = {"graph": "rmat13 seed 1", "updates": len(steps),
                      "hook_compress": dyn_k[0], "gather_key": dyn_k[1], "steps": steps}
    out["dynamic_phase_s"] = time.perf_counter() - t

    # f. times on the card
    t = time.perf_counter()
    times = {}
    for name, gs in sets.items():
        gs16 = gs[:16]
        fs = cuda_time_in_turns_ms(lambda: lanes.solve_lanes(gs16, lanes=16),
                                   lambda: [msf(x) for x in gs16], reps=TURNS, iters=1)
        vf = cuda_time_in_turns_ms(lambda: lanes.solve_lanes(gs16, lanes=16, mode="vmap"),
                                   lambda: lanes.solve_lanes(gs16, lanes=16), reps=TURNS, iters=1)
        stacked = lanes.stack_lanes(gs16, lanes=16)
        split = {"stack_ms": cuda_time_ms(lambda: lanes.stack_lanes(gs16, lanes=16), 5, 1),
                 "execute_ms": cuda_time_ms(lambda: lanes.execute_stacked(stacked), 5, 1)}
        times[name] = {
            **split,
            "fused_ms": fs["a_ms"], "fused_spread_ms": fs["a_spread_ms"],
            "serial_ms": fs["b_ms"], "serial_spread_ms": fs["b_spread_ms"],
            "vmap_ms": vf["a_ms"], "vmap_spread_ms": vf["a_spread_ms"],
            "fused_again_ms": vf["b_ms"], "fused_again_spread_ms": vf["b_spread_ms"],
            "fused_graphs_per_s": 16e3 / fs["a_ms"], "serial_graphs_per_s": 16e3 / fs["b_ms"],
            "vmap_graphs_per_s": 16e3 / vf["a_ms"],
        }
        print(f"time batch {name} (16 lanes, n={16 * lanes.bucket_key(gs16[0])[0]}), {TURNS} "
              f"turns: fused {fs['a_ms']:.3f} ms (spread {fs['a_spread_ms']:.3f}), 16 serial "
              f"{fs['b_ms']:.3f} ms (spread {fs['b_spread_ms']:.3f}); vmap {vf['a_ms']:.3f} ms "
              f"(spread {vf['a_spread_ms']:.3f}) against fused {vf['b_ms']:.3f} ms (spread "
              f"{vf['b_spread_ms']:.3f}); of a fused batch, the host stack "
              f"{split['stack_ms']:.3f} ms and the rest {split['execute_ms']:.3f} ms (median of 5)")
    lane_deck = deck[:-1]
    piped = BatchEngine(policy=BatchPolicy(pipeline_depth=2))
    synced = BatchEngine(policy=BatchPolicy(pipeline_depth=1))
    pipelined = counter("batch.pipeline.batches")
    ps = cuda_time_in_turns_ms(lambda: piped.solve_many(lane_deck),
                               lambda: synced.solve_many(lane_deck), reps=TURNS, iters=1)
    if counter("batch.pipeline.batches") - pipelined != 3 * (TURNS + 1):
        raise AssertionError("solve_many with pipeline_depth=2 did not pipeline")
    times["solve_many"] = {"graphs": len(lane_deck), "batches": 3,
                           "pipelined_ms": ps["a_ms"], "pipelined_spread_ms": ps["a_spread_ms"],
                           "synchronous_ms": ps["b_ms"], "synchronous_spread_ms": ps["b_spread_ms"]}
    print(f"time solve_many ({len(lane_deck)} graphs, 3 batches), {TURNS} turns: pipelined "
          f"{ps['a_ms']:.3f} ms (spread {ps['a_spread_ms']:.3f}), synchronous {ps['b_ms']:.3f} ms "
          f"(spread {ps['b_spread_ms']:.3f}); bucket builds at warmup (ms): {json.dumps(builds)}")
    out["times"] = times
    out["times_phase_s"] = time.perf_counter() - t
    return out, k1_inputs


def _canon_labels(labels) -> np.ndarray:
    """Component labels renumbered by first appearance: equal arrays for
    equal partitions."""
    _, first, inv = np.unique(np.asarray(labels), return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv]


def _pairs(u, v) -> np.ndarray:
    """Edge pairs as rows, sorted: an edge set compared as a whole."""
    rows = np.stack([np.asarray(u, dtype=np.int64), np.asarray(v, dtype=np.int64)], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))] if rows.size else rows.reshape(0, 2)


def _feed(make, out, answers, requests):
    """Request lines for ``serve_loop``, each made after the answer to the
    one before it is on ``out`` (stream heads and update digests follow
    from the answers)."""
    pos = 0
    steps = make(answers)
    while True:
        text = out.getvalue()
        answers.extend(json.loads(line) for line in text[pos:].splitlines())
        pos = len(text)
        try:
            req = next(steps)
        except StopIteration:
            return
        requests.append(req)
        yield json.dumps(req) + "\n"


class _Timed:
    """A service whose ``handle`` is timed, request by request."""

    def __init__(self, service, times):
        self.service, self.times = service, times

    def handle(self, request):
        t = time.perf_counter()
        resp = self.service.handle(request)
        self.times.append((request.get("op"), request.get("kind", "mst"),
                           resp.get("source") or resp.get("mode") or
                           ("ok" if resp.get("ok") else "error"), time.perf_counter() - t))
        return resp


def _service_path(torch, kernels, msf, graphs, oracle, small, small_oracle, scratch, npz18,
                  dev) -> tuple:
    """The service on the card (phase 2g): the port's ``serve_loop`` over a
    request deck (``io.StringIO`` out, lines made from the answers so far),
    then the same deck through ``serve_frames`` on a fresh service (RMAT-13
    and RMAT-18 as B-frame sections), then a restart over the stream root.

    The service runs 16 batch lanes, ``verify="bulk=full"`` and warms the
    RMAT-18 stream buckets. The deck: the README sample and RMAT-13 as JSON
    edges, 16 ``gnm_random_graph(128, 500)`` graphs, RMAT-18 by
    ``graph_path`` (class ``bulk``: certified inline), a repeat of each
    (``cache``), a ``cached_only`` hit and miss; the kinds ``components``
    (labels), ``k_msf`` (k = 3), ``bottleneck`` and ``path_max`` at RMAT-13
    and RMAT-18; 12 updates on RMAT-13; a stream on RMAT-18 with windows of
    256 and 4,096 updates from ``random_update_stream``, a window that
    coalesces to a no-op and a publish on a stale head, then a poll; the
    RMAT-18 answer certified with ``engine="torch"`` on the card and with
    ``np``, and a corrupted answer (a tree edge swapped for a heavier
    non-tree edge) refused and corrected; ``stats`` and ``shutdown``. Every
    forest, kind answer and window head must equal its SciPy oracle; every
    window's cut pass must run at e = 2^23 directed slots and n = 2^18, with
    one K2 and one K1 launch a round. The restart must replay every window
    with no fresh solve.

    Returns the record and the traced inputs of the first round of the first
    window's cut pass ``(fragment, src, dst, rank, ra, rb)``.
    """
    import dataclasses
    import io

    from distributed_ghs_implementation_tpu_torch.analytics import solvers as asolvers
    from distributed_ghs_implementation_tpu_torch.batch.warmup import WarmupPlan
    from distributed_ghs_implementation_tpu_torch.fleet import framing
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph, component_labels
    from distributed_ghs_implementation_tpu_torch.models.boruvka import _next_pow2
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.serve.service import (
        MSTService,
        serve_frames,
        serve_loop,
    )
    from distributed_ghs_implementation_tpu_torch.serve.store import solve_cache_key
    from distributed_ghs_implementation_tpu_torch.stream import window
    from distributed_ghs_implementation_tpu_torch.stream.log import UpdateLog
    from distributed_ghs_implementation_tpu_torch.stream.session import poll_gap_check
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
    from distributed_ghs_implementation_tpu_torch.verify import certify

    out = {}
    BUS.enable()
    readme, rmat13, rmat18 = graphs["readme"], graphs["rmat13"], graphs["rmat18"]

    # SciPy oracles, each forest computed once by digest (the kinds' oracles
    # all start from the exact forest).
    forests = {graphs[name].digest(): oracle[name] for name in ("readme", "rmat13", "rmat18")}

    def oracle_ids(g):
        key = g.digest()
        if key not in forests:
            forests[key] = rank_oracle_edge_ids(g)
        return forests[key]

    real_oracle_msf = asolvers._oracle_msf
    asolvers._oracle_msf = oracle_ids

    def edges_of(g):
        return [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]

    edges13 = edges_of(rmat13)

    def forest_of(resp):
        if "mst_edges" in resp:
            pairs = np.asarray(resp["mst_edges"], dtype=np.int64).reshape(-1, 2)
            return _pairs(pairs[:, 0], pairs[:, 1])
        secs = resp[framing.SECTIONS_KEY]
        return _pairs(secs.array("mst_u"), secs.array("mst_v"))

    def check_forest(what, resp, g):
        ids = oracle_ids(g)
        if resp.get("digest") != g.digest():
            raise AssertionError(f"service {what}: digest {resp.get('digest')} != the graph's")
        if not np.array_equal(forest_of(resp), _pairs(g.u[ids], g.v[ids])):
            raise AssertionError(f"service {what}: forest differs from the rank oracle")
        if resp["total_weight"] != int(g.w[ids].sum()):
            raise AssertionError(f"service {what}: weight {resp['total_weight']}")

    # Instruments of the window path: the rounds (one K2 and one K1 each),
    # the two passes, the log append, the whole apply.
    rounds = {"calls": 0, "shapes": [], "first": None, "armed": False}
    split = []
    real_round, real_seeded = window._moe_round, window._seeded_boruvka
    real_append, real_apply = UpdateLog.append, window.WindowedMST.apply_window

    def counted_round(fragment, src, dst, rank, ra, rb):
        rounds["calls"] += 1
        rounds["shapes"].append((int(fragment.numel()), int(src.numel())))
        if rounds["armed"]:  # the first round of the first cut pass
            rounds["first"] = tuple(x.clone() for x in (fragment, src, dst, rank, ra, rb))
            rounds["armed"] = False
        return real_round(fragment, src, dst, rank, ra, rb)

    def timed_seeded(num_nodes, fragment0, eu, ev, ew, **kw):
        cycle = np.array_equal(fragment0, np.arange(num_nodes))
        rounds["armed"] = rounds["first"] is None and not cycle
        k1 = kernels.hook_compress.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = real_seeded(num_nodes, fragment0, eu, ev, ew, **kw)
        split[-1]["cycle_s" if cycle else "cut_s"] = time.perf_counter() - t
        split[-1]["cycle_rounds" if cycle else "cut_rounds"] = (
            kernels.hook_compress.launches - k1)
        return got

    def timed_append(self, **kw):
        t = time.perf_counter()
        real_append(self, **kw)
        split[-1]["log_append_s"] = time.perf_counter() - t

    def timed_apply(self, updates):
        split.append({"updates": len(updates)})
        t = time.perf_counter()
        got = real_apply(self, updates)
        split[-1]["apply_window_s"] = time.perf_counter() - t
        return got

    window._moe_round, window._seeded_boruvka = counted_round, timed_seeded
    UpdateLog.append, window.WindowedMST.apply_window = timed_append, timed_apply

    def make_service(root):
        return MSTService(batch_lanes=16, verify="bulk=full", stream_dir=str(root),
                          warmup=WarmupPlan(stream_buckets=((rmat18.num_nodes,
                                                              rmat18.num_edges),)))

    rng = np.random.default_rng(7)
    windows = [window.random_update_stream(rng, rmat18, 256),
               window.random_update_stream(rng, rmat18, 4096)]
    a, b = 0, 1
    while _has_edge(rmat18, a, b):
        b += 1
    noop = [{"kind": "insert", "u": a, "v": b, "w": 5}, {"kind": "delete", "u": a, "v": b}]
    small16 = small[:16]
    kinds_at = {}
    for name, g in (("rmat13", rmat13), ("rmat18", rmat18)):
        labels = component_labels(g.num_nodes, g.u, g.v)
        far = int(np.nonzero(labels == labels[0])[0][-1])  # connected to 0, far in id
        kinds_at[name] = (g, (0, far))
    cut_shape = (rmat18.num_nodes, 2 * _next_pow2(rmat18.num_edges))
    state = {}
    window_checks, update_checks, kind_checks = [], [], []
    certs = {}
    svc = make_service(scratch / "streams")
    warm_report = dict(svc.warmup_report)

    def deck(answers):
        def last():
            return answers[-1]

        yield {"op": "solve", "num_nodes": 6, "edges": edges_of(readme), "edges_out": True}
        check_forest("readme", last(), readme)
        for rep in ("solved", "cache"):
            yield {"op": "solve", "num_nodes": rmat13.num_nodes, "edges": edges13,
                   "edges_out": True}
            check_forest(f"rmat13 {rep}", last(), rmat13)
            state["tree13"] = forest_of(last())
            if last()["source"] != rep:
                raise AssertionError(f"service rmat13: source {last()['source']}, not {rep}")
        for i, g in enumerate(small16 + small16[:1]):
            yield {"op": "solve", "num_nodes": g.num_nodes, "edges": edges_of(g),
                   "edges_out": True}
            if not np.array_equal(forest_of(last()), _pairs(g.u[small_oracle[i % 16]],
                                                            g.v[small_oracle[i % 16]])):
                raise AssertionError(f"service small128[{i}]: forest differs from the oracle")
        if last()["source"] != "cache":
            raise AssertionError("service small128 repeat: not from the cache")
        for rep in ("solved", "cache"):
            yield {"op": "solve", "graph_path": npz18, "edges_out": True, "slo_class": "bulk"}
            check_forest(f"rmat18 {rep}", last(), rmat18)
            if last()["source"] != rep or last().get("verified") != "full":
                raise AssertionError(f"service rmat18: {last()['source']}, "
                                     f"verified {last().get('verified')}")
        yield {"op": "solve", "cached_only": True, "digest": rmat18.digest()}
        if not last()["ok"] or last()["source"] != "cache":
            raise AssertionError("service cached_only: no hit for RMAT-18")
        yield {"op": "solve", "cached_only": True, "digest": "0" * 64}
        if last()["ok"] or not last().get("cache_miss"):
            raise AssertionError("service cached_only: a miss was not a miss")
        for name, (g, (pu, pv)) in kinds_at.items():
            base = ({"graph_path": npz18} if name == "rmat18" else
                    {"num_nodes": g.num_nodes, "edges": edges13})
            yield {"op": "solve", "kind": "components", "labels_out": True, **base}
            labels = np.asarray(last()["labels"])
            want = component_labels(g.num_nodes, g.u, g.v)
            if not np.array_equal(_canon_labels(labels), _canon_labels(want)) or (
                    last()["num_components"] != int(np.unique(want).size)):
                raise AssertionError(f"service {name} components differ from SciPy's")
            yield {"op": "solve", "kind": "k_msf", "k": 3, **base}
            if last()["total_weight"] != asolvers.oracle_k_msf_weight(g, 3):
                raise AssertionError(f"service {name} k_msf differs from the oracle")
            yield {"op": "solve", "kind": "bottleneck", **base}
            if last()["bottleneck_weight"] != asolvers.oracle_bottleneck(g):
                raise AssertionError(f"service {name} bottleneck differs from the oracle")
            yield {"op": "solve", "kind": "path_max", "u": pu, "v": pv, **base}
            want_pm = asolvers.oracle_path_max(g, pu, pv)
            if (last()["connected"], last()["path_max_weight"]) != (
                    want_pm["connected"], want_pm["weight"]):
                raise AssertionError(f"service {name} path_max differs from the oracle")
            kind_checks.append({"graph": name, "components": last()["num_components"],
                                "path_max": [pu, pv, want_pm["weight"]]})
        # 12 updates on RMAT-13: inserts, tree-edge deletes, heavier
        # reweights, each applied to a mirror of the graph here too.
        n13 = rmat13.num_nodes
        mu, mv, mw = rmat13.u.copy(), rmat13.v.copy(), rmat13.w.copy()

        def find(x, y):
            keys = mu * n13 + mv
            pos = int(np.searchsorted(keys, x * n13 + y))
            return pos, pos < keys.size and keys[pos] == x * n13 + y

        digest, tree = rmat13.digest(), state["tree13"]
        wmax = int(rmat13.w.max())
        for kind in ("insert", "delete", "reweight") * 4:
            if kind == "insert":
                x, y = sorted(int(q) for q in rng.choice(n13, 2, replace=False))
                while find(x, y)[1]:
                    x, y = sorted(int(q) for q in rng.choice(n13, 2, replace=False))
                upd = {"kind": "insert", "u": x, "v": y, "w": int(rng.integers(1, wmax + 1))}
                pos, _ = find(x, y)
                mu, mv, mw = np.insert(mu, pos, x), np.insert(mv, pos, y), np.insert(mw, pos,
                                                                                     upd["w"])
            else:
                x, y = (int(q) for q in tree[int(rng.integers(0, len(tree)))])
                pos, _ = find(x, y)
                if kind == "delete":
                    upd = {"kind": "delete", "u": x, "v": y}
                    mu, mv, mw = np.delete(mu, pos), np.delete(mv, pos), np.delete(mw, pos)
                else:
                    upd = {"kind": "reweight", "u": x, "v": y,
                           "w": wmax + int(rng.integers(1, 100))}
                    mw = mw.copy()
                    mw[pos] = upd["w"]
            k12 = (kernels.hook_compress.launches, kernels.gather_key.launches)
            yield {"op": "update", "digest": digest, "updates": [upd], "edges_out": True}
            resp = last()
            check_forest(f"update {upd}", resp, Graph(n13, mu, mv, mw))
            if resp["mode"] != "incremental" or resp["prev_digest"] != digest:
                raise AssertionError(f"service update {upd}: mode {resp['mode']}")
            digest, tree = resp["digest"], forest_of(resp)
            update_checks.append({"update": [upd["kind"], upd["u"], upd["v"]],
                                  "hook_compress": kernels.hook_compress.launches - k12[0],
                                  "gather_key": kernels.gather_key.launches - k12[1]})
        # The stream on RMAT-18.
        yield {"op": "subscribe", "digest": rmat18.digest()}
        sid, head0 = last()["stream"], last()["digest"]
        head = head0
        for i, ups in enumerate(windows + [noop]):
            calls, k12 = rounds["calls"], (kernels.hook_compress.launches,
                                           kernels.gather_key.launches)
            shapes_at = len(rounds["shapes"])
            yield {"op": "publish", "stream": sid, "digest": head, "edges_out": True,
                   "updates": [u if isinstance(u, dict) else
                               {k: v for k, v in u.__dict__.items() if v is not None}
                               for u in ups]}
            resp = last()
            d1 = kernels.hook_compress.launches - k12[0]
            d2 = kernels.gather_key.launches - k12[1]
            n_rounds = rounds["calls"] - calls
            shapes = rounds["shapes"][shapes_at:]
            g = svc.streams._streams[sid].mst.result().graph
            check_forest(f"stream window {i + 1}", resp, g)
            fresh = msf(g)
            if not np.array_equal(forest_of(resp), _pairs(g.u[fresh.edge_ids],
                                                          g.v[fresh.edge_ids])):
                raise AssertionError(f"stream window {i + 1}: head differs from a fresh solve")
            if resp["seq"] != i + 1 or resp["prev_digest"] != head:
                raise AssertionError(f"stream window {i + 1}: seq {resp['seq']}")
            if (d1, d2) != (n_rounds, n_rounds) or (n_rounds < 1 and i < 2):
                raise AssertionError(f"stream window {i + 1}: {n_rounds} rounds but K1 x{d1}, "
                                     f"K2 x{d2}")
            if i < 2 and shapes[0] != cut_shape:
                raise AssertionError(f"stream window {i + 1}: cut pass at (n, e) = {shapes[0]}")
            if i == 2 and (resp["digest"] != head or resp["notification"]["entered"]
                           or resp["notification"]["left"]):
                raise AssertionError("stream no-op window moved the head")
            window_checks.append({"updates": len(ups), "net": resp["applied"],
                                  "mode": resp["mode"], "rounds": n_rounds,
                                  "hook_compress": d1, "gather_key": d2,
                                  "cut_pass_n_e": list(shapes[0]) if shapes else None,
                                  "entered": len(resp["notification"]["entered"]),
                                  "left": len(resp["notification"]["left"]),
                                  "weight_delta": resp["notification"]["weight_delta"],
                                  **{k: v for k, v in split[-1].items() if k != "updates"}})
            head = resp["digest"]
        yield {"op": "publish", "stream": sid, "digest": head0, "updates": noop}
        if last()["ok"] or not last().get("stale") or last()["digest"] != head:
            raise AssertionError("stream publish on a stale head was not refused")
        yield {"op": "poll", "stream": sid, "after_seq": 0}
        state["head"], state["notes"] = head, last()["notifications"]
        seqs = [n["seq"] for n in last()["notifications"]]
        if poll_gap_check(seqs, last()["seq"]) != {"gaps": 0, "dups": 0} or seqs != [1, 2, 3]:
            raise AssertionError(f"stream poll: {seqs}")
        # Certificates of the RMAT-18 answer, then a corrupted one.
        res, _ = svc.scheduler.solve(rmat18)
        t = time.perf_counter()
        on_card = certify.certify_result(res, engine="torch", device=dev)
        certs["torch_s"] = time.perf_counter() - t
        t = time.perf_counter()
        on_host = certify.certify_result(res, engine="np")
        certs["np_s"] = time.perf_counter() - t
        strip = ("engine", "check_s")
        if not on_card.ok or {k: v for k, v in dataclasses.asdict(on_card).items()
                              if k not in strip} != {
                k: v for k, v in dataclasses.asdict(on_host).items() if k not in strip}:
            raise AssertionError(f"certificates differ: {on_card} {on_host}")
        bad = dataclasses.replace(res, edge_ids=_heavier_swap(rmat18, res.edge_ids,
                                                              component_labels))
        before = dict(BUS.counters())
        fixed, verified = svc.verifier.check(bad, cls="bulk",
                                             key=solve_cache_key(rmat18, backend="device"),
                                             backend="device")
        after = BUS.counters()
        if verified != "full" or not np.array_equal(np.sort(fixed.edge_ids), oracle["rmat18"]):
            raise AssertionError("the corrupted RMAT-18 answer was not corrected")
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in ("verify.failed",
                                                                 "verify.corrected")}
        if delta != {"verify.failed": 1, "verify.corrected": 1}:
            raise AssertionError(f"verifier counters {delta}")
        certs.update(reason=certify.certify_result(bad, engine="torch", device=dev).reason,
                     counters=delta)
        yield {"op": "stats"}
        if not last()["ok"] or last()["streams"] != 1:
            raise AssertionError(f"service stats: {last()}")
        yield {"op": "shutdown"}

    try:
        # a. JSONL
        t = time.perf_counter()
        answers, requests, times = [], [], []
        text_out = io.StringIO()
        serve_loop(_feed(deck, text_out, answers, requests), text_out, _Timed(svc, times))
        answers.extend(json.loads(x) for x in text_out.getvalue().splitlines()[len(answers):])
        if len(answers) != len(requests) or not answers[-1].get("ok"):
            raise AssertionError("service: the JSONL loop did not answer every request")
        out["jsonl_s"] = time.perf_counter() - t
        out["requests"] = len(requests)
        stats = answers[-2]
        # b. the same deck over frames, on a fresh service, RMAT-13 and RMAT-18
        # as B-frame sections
        t = time.perf_counter()
        frames = io.BytesIO()
        wire13 = rmat13.to_wire()
        wire18 = rmat18.to_wire()
        for req in requests[:-2]:
            if req.get("edges") is not None and req["num_nodes"] == rmat13.num_nodes:
                req = {k: v for k, v in req.items() if k not in ("edges", "num_nodes")}
                req = {**req, **wire13}
            elif req.get("graph_path") == npz18:
                req = {**{k: v for k, v in req.items() if k != "graph_path"}, **wire18}
            frames.write(framing.encode_bframe(req) if framing.SECTIONS_KEY in req
                         else framing.encode_frame(req, crc=True))
        frames.write(framing.encode_frame({"op": "shutdown"}, crc=True))
        fsvc = make_service(scratch / "streams_frames")
        frame_times = []
        bin_out = io.BytesIO()
        if serve_frames(io.BytesIO(frames.getvalue()), bin_out, _Timed(fsvc, frame_times)) != 0:
            raise AssertionError("serve_frames did not end cleanly")
        bin_out.seek(0)
        got = []
        while (resp := framing.read_frame(bin_out)) is not None:
            got.append(framing.fold_sections(resp))
        want = answers[:-2] + answers[-1:]
        if len(got) != len(want):
            raise AssertionError(f"serve_frames answered {len(got)} of {len(want)}")
        for i, (f, j) in enumerate(zip(got, want)):
            for d in (f, j):
                for key in ("wall_time_s", "wall_s"):
                    d.pop(key, None)
            if f != j:
                raise AssertionError(f"serve_frames answer {i} ({requests[i].get('op')}) "
                                     f"differs from serve_loop's")
        out["frames_s"] = time.perf_counter() - t
        # c. a restart over the stream root replays every window, no solve
        t = time.perf_counter()
        before = dict(BUS.counters())
        again = MSTService(stream_dir=str(scratch / "streams"))
        sid = rmat18.digest()[:16]
        sub = again.handle({"op": "subscribe", "stream": sid})
        poll = again.handle({"op": "poll", "stream": sid, "after_seq": 0})
        after = BUS.counters()

        def moved(name):
            return after.get(name, 0) - before.get(name, 0)

        replay = {name: moved(name) for name in (
            "stream.replay.streams", "stream.replay.windows", "stream.replay.fresh_solve",
            "serve.scheduler.fresh_solve")}
        if (replay["stream.replay.windows"] != 3 or replay["stream.replay.fresh_solve"]
                or replay["serve.scheduler.fresh_solve"] or sub["digest"] != state["head"]
                or sub["seq"] != 3):
            raise AssertionError(f"restart: {replay}, head {sub['digest']} seq {sub['seq']}")
        if poll["notifications"] != state["notes"]:
            raise AssertionError("restart: the notifications differ from the live ones")
        out["restart"] = {**replay, "seq": sub["seq"], "s": time.perf_counter() - t}
    finally:
        window._moe_round, window._seeded_boruvka = real_round, real_seeded
        UpdateLog.append, window.WindowedMST.apply_window = real_append, real_apply
        asolvers._oracle_msf = real_oracle_msf

    by_op = {}
    for op, kind, source, s in times:
        by_op.setdefault(f"{op}/{kind}/{source}", []).append(s * 1e3)
    out.update(
        latency_ms={k: {"count": len(v), "median": statistics.median(v), "max": max(v)}
                    for k, v in sorted(by_op.items())},
        frames_latency_ms_total=sum(s for *_, s in frame_times) * 1e3,
        windows=window_checks, updates=update_checks, kinds=kind_checks,
        certify={**certs, "n": rmat18.num_nodes, "m": rmat18.num_edges},
        warmup=warm_report,
        stats_counters={k: v for k, v in stats["counters"].items()
                        if k.startswith(("stream.", "verify.", "serve.scheduler", "compile."))})
    if sum(u["hook_compress"] for u in update_checks) < 1:
        raise AssertionError("service updates: no K1 launch on the incremental path")
    return out, rounds["first"]


def _ingest_times(graphs, json18: str) -> dict:
    """JSON lines against B-frames: the seconds from request bytes to a
    ``Graph`` (``json.loads`` and ``Graph.from_edges``, against
    ``read_frame`` and ``Graph.from_wire``), at RMAT-13 and RMAT-18;
    ``json18`` is RMAT-18's JSON request, made in the set-up."""
    import io

    from distributed_ghs_implementation_tpu_torch.fleet import framing
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

    ingest = {}
    for name in ("rmat13", "rmat18"):
        g = graphs[name]
        line = json18 if name == "rmat18" else json.dumps(
            {"op": "solve", "num_nodes": g.num_nodes,
             "edges": np.stack([g.u, g.v, g.w], axis=1).tolist()})
        data = framing.encode_bframe({"op": "solve", **g.to_wire()})
        t = time.perf_counter()
        req = json.loads(line)
        from_json = Graph.from_edges(int(req["num_nodes"]), req["edges"])
        json_s = time.perf_counter() - t
        del req
        t = time.perf_counter()
        req = framing.read_frame(io.BytesIO(data))
        from_wire = Graph.from_wire(req)
        frame_s = time.perf_counter() - t
        if not from_json.digest() == from_wire.digest() == g.digest():
            raise AssertionError(f"ingest {name}: the graphs differ")
        ingest[name] = {"json_bytes": len(line), "json_s": json_s,
                        "bframe_bytes": len(data), "bframe_s": frame_s}
    return ingest


def _json_request(g) -> str:
    """``{"op": "solve", "num_nodes": n, "edges": [[u, v, w], ...]}`` for an
    integer-weighted graph, formatted by NumPy in one pass."""
    import io

    body = io.StringIO()
    np.savetxt(body, np.stack([g.u, g.v, g.w], axis=1), fmt="[%d,%d,%d]", newline=",")
    return f'{{"op":"solve","num_nodes":{g.num_nodes},"edges":[{body.getvalue()[:-1]}]}}'


def _has_edge(g, a, b) -> bool:
    """Is ``(a, b)`` an edge of ``g`` (canonical arrays, sorted by (u, v))?"""
    key = g.u * g.num_nodes + g.v
    want = min(a, b) * g.num_nodes + max(a, b)
    pos = int(np.searchsorted(key, want))
    return pos < key.size and key[pos] == want


def _heavier_swap(g, ids, component_labels) -> np.ndarray:
    """One tree edge swapped for a heavier non-tree edge that reconnects
    its two sides: a spanning forest that is not the minimum one."""
    ids = np.sort(np.asarray(ids))
    tree = np.zeros(g.num_edges, dtype=bool)
    tree[ids] = True
    for drop in ids[np.argsort(g.w[ids], kind="stable")]:
        keep = ids[ids != drop]
        labels = component_labels(g.num_nodes, g.u[keep], g.v[keep])
        cross = np.nonzero(~tree & (labels[g.u] != labels[g.v]) & (g.w > g.w[drop]))[0]
        if cross.size:
            return np.sort(np.append(keep, cross[0]))
    raise AssertionError("no heavier replacement edge")


SHARDS = 4  # phase 2h's mesh: four shards on the card
SHARDED_MODES = ("flat", "ell", "rank", "filtered", "rank64")
# The road grid's solve lowers the finish's gather budget to this many
# slots, so that the capacity guard's in-place levels run at full width.
GUARD_BUDGET = 1 << 21
GROUP_TIMEOUT_S = 240


def _sharded_solve(mode, graph, mesh):
    from distributed_ghs_implementation_tpu_torch.parallel import rank_sharded, sharded

    if mode == "filtered":
        return rank_sharded.solve_graph_rank_sharded(graph, mesh=mesh, filtered=True)
    if mode == "rank64":
        return rank_sharded.solve_graph_rank_sharded(graph, mesh=mesh, rank64=True)
    return sharded.solve_graph_sharded(graph, mesh=mesh, strategy=mode)


def _group_child(argv) -> int:
    """One process of phase 2h's process groups, run by the phase itself:
    ``chip_smoke.py --group-child gloo|nccl <rank> <world> <init_method>
    <out.npz>``. A gloo process first checks the collectives the mesh uses
    on CUDA int32 tensors, values included; then each solves RMAT-12 (and
    under gloo RMAT-18) through ``rank`` and ``ell`` on a mesh of 2 shards a
    process on the card, and writes the results to ``out.npz``."""
    import torch
    import torch.distributed as dist

    kind, rank, world, init_method, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    sys.path.insert(0, str(ROOT))
    from distributed_ghs_implementation_tpu_torch.graphs import generators as gen
    from distributed_ghs_implementation_tpu_torch.parallel import multihost
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    multihost.initialize(init_method=init_method, num_processes=world, process_id=rank,
                         backend=kind)
    record = {}
    if kind == "gloo":
        dev = torch.device("cuda", 0)
        probe = {}
        for name, op, want in (("all_reduce_min", dist.ReduceOp.MIN, lambda a: a),
                               ("all_reduce_sum", dist.ReduceOp.SUM, lambda a: 2 * a + 1),
                               ("all_reduce_max", dist.ReduceOp.MAX, lambda a: a + 1)):
            t = torch.arange(8, dtype=torch.int32, device=dev) + rank
            dist.all_reduce(t, op)
            probe[name] = t.tolist() == want(np.arange(8)).tolist()
        t = torch.full((4,), rank, dtype=torch.int32, device=dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        probe["all_gather"] = torch.cat(parts).tolist() == [0] * 4 + [1] * 4
        t = torch.full((4,), 7 + rank, dtype=torch.int32, device=dev)
        dist.broadcast(t, 0)
        probe["broadcast"] = t.tolist() == [7] * 4
        record["probe"] = np.array(json.dumps(probe))
    mesh = edge_mesh(num_shards=2, device="cuda")
    record["layout"] = np.array([mesh.size, mesh.first_shard, len(mesh.rep_devices)])
    graphs = {"rmat12": gen.rmat_graph(12, 8, seed=11)}
    if kind == "gloo":
        graphs["rmat18"] = gen.rmat_graph(18, 16, seed=1)
    for name, g in graphs.items():
        for strategy in ("rank", "ell"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids, frag, levels = _sharded_solve(strategy, g, mesh)
            record[f"{name}_{strategy}_ids"] = ids
            record[f"{name}_{strategy}_levels"] = np.array(levels)
            record[f"{name}_{strategy}_s"] = np.array(time.perf_counter() - t)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **record)
    return 0


def _run_groups(scratch, torch, oracle) -> dict:
    """Phase 2h's process groups, each in processes of its own so that this
    process holds no default group: 2 gloo processes of 2 shards each, both
    on ``cuda:0``, and an NCCL group of one process (2 shards). An NCCL
    group across processes needs one card a process."""
    runs = {"gloo": 2, "nccl": 1}
    procs = []
    t0 = time.perf_counter()
    for kind, world in runs.items():
        init = f"file://{scratch / (kind + '-store')}"
        out = scratch / f"{kind}.npz"
        for rank in range(world):
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--group-child", kind,
                   str(rank), str(world), init, str(out)]
            procs.append((kind, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    failed = []
    for kind, p in procs:
        try:
            _, err = p.communicate(timeout=GROUP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
                q.communicate()
            raise AssertionError(f"a {kind} group process timed out")
        if p.returncode:
            failed.append(f"{kind}: rc {p.returncode}: {err[-2000:]}")
    if failed:
        raise AssertionError("group processes failed:\n" + "\n".join(failed))
    out = {"wall_s": time.perf_counter() - t0}
    for kind in runs:
        with np.load(scratch / f"{kind}.npz") as data:
            rec = {"layout": data["layout"].tolist()}
            if "probe" in data.files:
                rec["gloo_cuda_collectives"] = json.loads(str(data["probe"]))
                if not all(rec["gloo_cuda_collectives"].values()):
                    raise AssertionError(f"gloo on CUDA tensors: {rec['gloo_cuda_collectives']}")
            for key in data.files:
                if key.endswith("_ids"):
                    name = key.split("_")[0]
                    if not np.array_equal(data[key], oracle[name]):
                        raise AssertionError(f"{kind} group: {key} differs from the oracle")
                    stem = key[:-4]
                    rec[stem] = {"levels": int(data[stem + "_levels"]),
                                 "s": float(data[stem + "_s"])}
            out[kind] = rec
    if out["gloo"]["layout"] != [4, 0, 1] or out["nccl"]["layout"] != [2, 0, 1]:
        raise AssertionError(f"group layouts: {out['gloo']['layout']}, {out['nccl']['layout']}")
    cards = torch.cuda.device_count()
    out["nccl_across_processes"] = (
        "not run: an NCCL group across processes needs a card a process (NCCL refuses two "
        f"ranks on one card), and this machine has {cards}")
    return out


def _profiled_launches(torch, fn) -> dict:
    """Device kernels of one call of ``fn`` by name, from the profiler: K1
    (``hook_compress``) and K2 (``gather_key``) launches."""
    kerns = _device_kernels(torch, fn, 1)
    return {"hook_compress": sum("hook_compress" in name for name, _ in kerns),
            "gather_key": sum("gather_key" in name for name, _ in kerns),
            "device_kernels": len(kerns)}


def _sharded_path(torch, kernels, boruvka, deck, graphs, oracle, check, scratch,
                  card: str) -> dict:
    """The sharded solvers on the card (phase 2h), 4 shards on the card.

    a. The dryrun fixtures (ER(48), RMAT-12, road 40x40, the 23-component
       forest) through ``flat``, ``ell``, ``rank``, filtered and ``rank64``:
       each equal to the single-card solve and the oracle; a flat solve of L
       levels launches K1 L times (one device) and K2 4 (L - 1) times (one a
       shard, past the identity level); every other form launches K1.
    b. ``solve_graph_sharded(strategy="auto")`` at full width: RMAT-18 (the
       plain head and finish), the road grid 2048 x 2048 (with the gather
       budget lowered to ``GUARD_BUDGET``: the capacity guard's levels),
       RMAT-20 seed 24 (the sharded filter; its weight the recorded
       35,737,768) and RMAT-21, and ``rank64=True`` at RMAT-18: cold, warm,
       in turns beside the single-card ``auto`` solve, and once under the
       profiler, which counts its K1 and K2 launches.
    c. The process groups (:func:`_run_groups`).
    d. The service with a ``ShardedLane`` of 4 shards: RMAT-18 routed
       ``sharded_lane``, a dispatch-only repeat, 12 updates written in
       place and one past ``max_update_frac`` restaged, no ``compile.miss``
       after ``precompile``, a sharded stream with two windows and a restart
       that re-stages the head before it replays.
    e. The supervisor's sharded rung, and a sharded checkpoint saved at the
       head and resumed, at RMAT-18.
    """
    from distributed_ghs_implementation_tpu_torch.graphs import io as graph_io
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.parallel import lane as plane
    from distributed_ghs_implementation_tpu_torch.parallel import rank_sharded
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService
    from distributed_ghs_implementation_tpu_torch.stream.window import random_update_stream
    from distributed_ghs_implementation_tpu_torch.utils import checkpoint, resilience

    mesh = edge_mesh(num_shards=SHARDS)
    if mesh.size != SHARDS or len(mesh.rep_devices) != min(SHARDS, torch.cuda.device_count()):
        raise AssertionError(f"mesh {mesh}")
    out = {"shards": SHARDS, "devices": [str(d) for d in mesh.devices]}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # a. the fixtures
    t_a = time.perf_counter()
    fixtures = {}
    for name in ("er48", "rmat12", "road40", "forest23"):
        g = deck[name]
        single = boruvka.solve_graph(g, strategy="rank")[0]
        for mode in SHARDED_MODES:
            k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
            ids, frag, levels = _sharded_solve(mode, g, mesh)
            d1, d2 = kernels.hook_compress.launches - k1, kernels.gather_key.launches - k2
            if not (np.array_equal(ids, oracle[name]) and np.array_equal(ids, single)):
                raise AssertionError(f"sharded {mode} on {name}: forest differs")
            if name == "forest23" and np.unique(frag).size != 23:
                raise AssertionError(f"sharded {mode} on forest23: {np.unique(frag).size} parts")
            if mode == "flat" and (d1, d2) != (levels, SHARDS * (levels - 1)):
                raise AssertionError(f"flat on {name}: {levels} levels, K1 x{d1}, K2 x{d2}")
            if d1 < 1:
                raise AssertionError(f"{mode} on {name}: K1 never launched")
            fixtures[f"{name}/{mode}"] = {"levels": levels, "hook_compress": d1,
                                          "gather_key": d2}
    out["fixtures"] = fixtures
    out["fixtures_s"] = time.perf_counter() - t_a

    # b. full width through auto, and rank64
    full = {}
    cases = [("rmat18", "rmat18", {}), ("grid2048", "grid2048", {"guard": True}),
             ("rmat20", "rmat20", {}), ("rmat21", "rmat21", {}),
             ("rmat18_rank64", "rmat18", {"rank64": True})]
    for label, name, opts in cases:
        g = graphs[name]
        guard_levels = [0]
        saved_budget = rank_sharded._FINISH_GATHER_MAX_SLOTS
        real_level = rank_sharded._sharded_level

        def level(*args, **kw):
            guard_levels[0] += 1
            return real_level(*args, **kw)

        def solve():
            if opts.get("rank64"):
                return _sharded_solve("rank64", g, mesh)
            from distributed_ghs_implementation_tpu_torch.parallel.sharded import (
                solve_graph_sharded,
            )

            return solve_graph_sharded(g, mesh=mesh, strategy="auto")

        if opts.get("guard"):
            rank_sharded._FINISH_GATHER_MAX_SLOTS = GUARD_BUDGET
        rank_sharded._sharded_level = level
        try:
            k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
            (ids, _, levels), cold = timed(solve)
            d1, d2 = kernels.hook_compress.launches - k1, kernels.gather_key.launches - k2
            check(name, ids, float(g.w[ids].sum()))
            if name == "rmat20" and int(g.w[ids].sum()) != RMAT20_ORACLE_WEIGHT:
                raise AssertionError(f"RMAT-20 sharded weight {int(g.w[ids].sum())}")
            if d1 < levels - 2:  # levels 1 and 2 may run on the host
                raise AssertionError(f"sharded {label}: {levels} levels but K1 x{d1}")
            if opts.get("guard") and guard_levels[0] < 1:
                raise AssertionError("the road grid ran no capacity-guard level")
            guards = guard_levels[0]
            _, warm = timed(solve)
            single = lambda: boruvka.solve_graph(g)  # noqa: E731 -- auto: the rank solver
            boruvka.solve_graph(g)
            turns = {"sharded": [], "single": []}
            for which in ("sharded", "single", "single", "sharded"):
                turns[which].append(timed(solve if which == "sharded" else single)[1])
            profiled = _profiled_launches(torch, solve)
        finally:
            rank_sharded._FINISH_GATHER_MAX_SLOTS = saved_budget
            rank_sharded._sharded_level = real_level
        full[label] = {"levels": levels, "cold_s": cold, "warm_s": warm,
                       "turns_sharded_s": turns["sharded"], "turns_single_s": turns["single"],
                       "hook_compress": d1, "gather_key": d2, "guard_levels": guards,
                       "profiler": profiled}
        print(f"  sharded {label} ({card}): {levels} levels, cold {cold:.3f} s, warm {warm:.3f} s; in "
              f"turns sharded {statistics.median(turns['sharded']):.3f} s, single-card "
              f"{statistics.median(turns['single']):.3f} s; K1 x{d1}, K2 x{d2} (wrappers), "
              f"profiler {profiled}; guard levels {guards}")
    out["full_width"] = full

    # c. process groups
    t_c = time.perf_counter()
    out["groups"] = _run_groups(scratch, torch, oracle)
    out["groups_s"] = time.perf_counter() - t_c

    # d. the service and streams over a lane of 4 shards
    t_d = time.perf_counter()
    rmat18 = graphs["rmat18"]
    BUS.enable()
    BUS.clear()
    npz = str(scratch / "rmat18.npz")
    graph_io.write_npz(rmat18, npz)
    svc = MSTService(sharded_lane=SHARDS, stream_dir=str(scratch / "streams"))
    lane = svc.sharded_lane
    first = svc.handle({"op": "solve", "graph_path": npz})
    if first.get("backend") != "sharded_lane" or BUS.counters().get("serve.route.sharded_lane") != 1:
        raise AssertionError(f"RMAT-18 was not routed to the lane: {first.get('backend')}")
    want_w = int(rmat18.w[oracle["rmat18"]].sum())
    if (first["total_weight"], first["num_edges_in_mst"]) != (want_w, len(oracle["rmat18"])):
        raise AssertionError(f"the service's RMAT-18 answer differs from the oracle: {first}")
    repeat = svc.handle({"op": "solve", "graph_path": npz})
    skipped0 = BUS.counters().get("lane.reshard.skipped", 0)
    (ids, _, _), dispatch_s = timed(lambda: lane.solve(rmat18))
    if repeat.get("source") != "cache" or BUS.counters().get("lane.reshard.skipped", 0) != skipped0 + 1:
        raise AssertionError("the repeat was not a cache hit and a dispatch-only lane solve")
    check("rmat18", ids, float(rmat18.w[ids].sum()))
    # 12 inserts heavier than every edge: each lands past every rank, so
    # the lane writes one slot in place.
    pairs = np.random.default_rng(12).integers(0, rmat18.num_nodes, (12, 2))
    top = int(rmat18.w.max())
    g, update_s = rmat18, []
    for i, (a, b) in enumerate(pairs):
        b = b if b != a else (a + 1) % rmat18.num_nodes
        g2 = Graph.from_arrays(g.num_nodes, np.append(g.u, a), np.append(g.v, b),
                               np.append(g.w, top + 1 + i))
        (ids, _, _), dt = timed(lambda: lane.update(g.digest(), g2))
        update_s.append(dt)
        if not np.array_equal(ids, boruvka.solve_graph(g2, strategy="rank")[0]):
            raise AssertionError(f"update {i}: the lane's forest differs from the single card's")
        g = g2
    counters = BUS.counters()
    if counters.get("lane.update.donated", 0) != 12 or counters.get("lane.restage", 0):
        raise AssertionError(f"updates: {counters}")
    flipped = Graph.from_arrays(g.num_nodes, g.u, g.v, int(g.w.max()) + 1 - g.w)
    (ids, _, _), restage_s = timed(lambda: lane.update(g.digest(), flipped))
    if BUS.counters().get("lane.restage", 0) != 1 or not np.array_equal(
            ids, boruvka.solve_graph(flipped, strategy="rank")[0]):
        raise AssertionError("the wide update did not restage to the right forest")
    plane._reset_shape_ledger()  # a fresh process's first dispatches
    warm_lane = plane.ShardedLane(mesh)
    warm_lane.precompile(rmat18.num_nodes, rmat18.num_edges)
    miss0 = BUS.counters().get("compile.miss", 0)
    ids = warm_lane.solve(rmat18)[0]
    if BUS.counters().get("compile.miss", 0) != miss0:
        raise AssertionError("a request after precompile counted compile.miss")
    check("rmat18", ids, float(rmat18.w[ids].sum()))
    sub = svc.handle({"op": "subscribe", "digest": rmat18.digest()})
    sid, head = sub["stream"], sub["digest"]
    rng = np.random.default_rng(18)
    windows = []
    for size in (64, 512):
        ups = [{k: v for k, v in u.__dict__.items() if v is not None}
               for u in random_update_stream(rng, rmat18, size)]
        pub, dt = timed(lambda: svc.handle({"op": "publish", "stream": sid, "digest": head,
                                             "updates": ups}))
        if not pub.get("ok"):
            raise AssertionError(f"publish: {pub}")
        head = pub["digest"]
        windows.append({"updates": size, "mode": pub["mode"], "s": dt})
    if svc.streams.stats()["sharded"] != 1 or lane.resident_digests()[-1] != head:
        raise AssertionError("the stream's head is not resident on the lane")
    fresh0 = BUS.counters().get("serve.scheduler.fresh_solve", 0)
    restored0 = BUS.counters().get("stream.replay.residency_restored", 0)
    svc2 = MSTService(sharded_lane=SHARDS, stream_dir=str(scratch / "streams"))
    back, replay_s = timed(lambda: svc2.handle({"op": "subscribe", "stream": sid}))
    counters = BUS.counters()
    if (back.get("digest") != head or counters.get("serve.scheduler.fresh_solve", 0) != fresh0
            or counters.get("stream.replay.residency_restored", 0) != restored0 + 1
            or svc2.sharded_lane.resident_digests() != [head]):
        raise AssertionError(f"the restart did not re-stage and replay: {back}")
    out["service"] = {"dispatch_only_s": dispatch_s, "update_s": update_s,
                      "restage_s": restage_s, "windows": windows, "replay_s": replay_s,
                      "lane_counters": {k: v for k, v in counters.items()
                                        if k.startswith(("lane.", "stream.lane",
                                                         "stream.replay", "serve.route"))}}
    out["service_s"] = time.perf_counter() - t_d

    # e. the supervisor's sharded rung and a sharded checkpoint
    t_e = time.perf_counter()
    ids, _, levels, log = resilience.Supervisor().solve(rmat18, entry="sharded")
    trail = [(r.rung, r.attempt, r.outcome) for r in log.records]
    if trail != [("sharded", 1, "ok")]:
        raise AssertionError(f"supervised trail {trail}")
    check("rmat18", ids, float(rmat18.w[ids].sum()))
    path = str(scratch / "sharded.npz")
    fp = checkpoint.graph_fingerprint(rmat18)
    seen = []

    def save_head(level, fragment, mask_fn, count):
        seen.append(level)
        if len(seen) == 1:
            checkpoint.save_checkpoint(path, fragment, mask_fn(), level, fingerprint=fp)

    rank_sharded.solve_graph_rank_sharded(rmat18, mesh=mesh, on_chunk=save_head)
    saved_level = checkpoint.load_checkpoint(path)[2]
    (ids, _, levels2), resume_s = timed(
        lambda: checkpoint.solve_graph_checkpointed_sharded(rmat18, path, mesh=mesh))
    check("rmat18", ids, float(rmat18.w[ids].sum()))
    if not 0 < saved_level < levels2 or checkpoint.load_checkpoint(path)[2] != levels2:
        raise AssertionError(f"resume from level {saved_level} ended at {levels2}")
    out["supervised"] = {"trail": trail, "levels": levels}
    out["checkpoint"] = {"saved_level": int(saved_level), "levels": levels2,
                         "resume_s": resume_s}
    out["supervised_checkpoint_s"] = time.perf_counter() - t_e
    return out


# The build-cache child of phase 2i: loads both libraries from a cache
# directory, as a restarted process would.
_CACHE_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from distributed_ghs_implementation_tpu_torch.graphs import native
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.utils import compile_cache
BUS.enable()
compile_cache.enable_persistent_cache(sys.argv[2])
torch.zeros(1, device="cuda")  # the CUDA context, outside the load times
torch.cuda.synchronize()
t0 = time.perf_counter()
kernels._lib()
t1 = time.perf_counter()
native.get_lib()
t2 = time.perf_counter()
print(json.dumps({
    "kernels_load_s": t1 - t0, "native_load_s": t2 - t1,
    "counters": {k: v for k, v in BUS.counters().items() if k.startswith("compile.")},
    "stats": compile_cache.cache_stats(),
}))
"""


def _protocol_tune_path(torch, kernels, boruvka, msf, deck, graphs, oracle, lane_sets,
                        lane_oracle, scratch, build_s) -> tuple:
    """The protocol, the chaos drill, the tuner and the build cache on the
    card (phase 2i):

    a. protocol: ``backend="protocol"`` on the fixture deck and on
       ``erdos_renyi_graph(45, 0.15)`` seeds 0-7, each forest equal to the
       card's ``backend="device"`` solve (K1 and K2) and the rank oracle;
       the seconds a solve took, its levels, and the messages by kind from
       a second run over a transport that counts them;
    b. chaos: ``run_chaos_drill(fast=True)`` with its solver and checkpoint
       legs on the card; every case ``ok``;
    c. tuner: ``tune.search`` over the three lane buckets of phase 2f at the
       batch policy's 16 lanes (128-vertex graphs, stack n = 2,048;
       RMAT-13's, n = 2^17; the ceiling bucket, n = 2^20) and RMAT-18's
       ``ell`` bucket (its 15 buckets, K3 at each tile); the record saved,
       installed by a fresh ``run_warmup(WarmupPlan(tuning=...))``, then a
       16-lane batch of each lane set and the RMAT-18 ELL solve under the
       installed configs, every forest equal to the oracle, no
       ``compile.miss`` after the warmup, and K1's form and K3's tile the
       installed ones. K1's first-level inputs of each batch and K3's
       level-1 inputs of the ELL solve are traced for phase 3;
    d. build cache: a child process pointed at this run's ``build/`` by
       ``enable_persistent_cache`` loads both libraries with hits only.

    Returns the records and the traced inputs ``{"k1": {bucket key: (n,
    inputs)}, "k3": (fragment, buckets, n_pad)}``.
    """
    from distributed_ghs_implementation_tpu_torch.batch import lanes, warmup
    from distributed_ghs_implementation_tpu_torch.graphs import generators as gen
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.protocol import SimTransport, run_protocol
    from distributed_ghs_implementation_tpu_torch.tune import measure, record, space
    from distributed_ghs_implementation_tpu_torch.utils.chaos import run_chaos_drill
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

    out = {}
    BUS.enable()

    class CountingTransport(SimTransport):
        """The simulator, counting the messages it sends by kind."""

        def __init__(self):
            super().__init__()
            self.kinds = {}

        def send(self, src, dst, msg):
            self.kinds[msg.type.value] = self.kinds.get(msg.type.value, 0) + 1
            super().send(src, dst, msg)

    # a. protocol
    t = time.perf_counter()
    proto = dict(deck)
    proto.update({f"er45-{s}": gen.erdos_renyi_graph(45, 0.15, seed=s) for s in range(8)})
    rows = {}
    for name, g in proto.items():
        want = oracle[name] if name in oracle else rank_oracle_edge_ids(g)
        t0 = time.perf_counter()
        res = msf(g, backend="protocol")
        seconds = time.perf_counter() - t0
        dev = msf(g)
        if not (np.array_equal(res.edge_ids, dev.edge_ids) and np.array_equal(res.edge_ids, want)):
            raise AssertionError(f"protocol {name}: forest differs from the card's solve or "
                                 "the rank oracle")
        if res.num_components != dev.num_components or res.backend != "protocol":
            raise AssertionError(f"protocol {name}: {res.num_components} components, "
                                 f"the card's {dev.num_components}; backend {res.backend}")
        transport = CountingTransport()
        run_protocol(g, transport=transport)
        if sum(transport.kinds.values()) != transport.messages_sent:
            raise AssertionError(f"protocol {name}: messages by kind do not add up")
        rows[name] = {"nodes": g.num_nodes, "edges": g.num_edges, "s": seconds,
                      "levels": res.num_levels, "device_levels": dev.num_levels,
                      "messages": transport.messages_sent,
                      "deferred": transport.messages_deferred, "by_kind": transport.kinds}
    out["protocol"] = rows
    out["protocol_phase_s"] = time.perf_counter() - t
    print("phase 2i, protocol (backend='protocol' = the card's solve = the rank oracle), "
          "s / levels / messages a graph: " + "; ".join(
              f"{name} {r['s']:.3f} s, {r['levels']} levels, {r['messages']} messages "
              f"{json.dumps(r['by_kind'], sort_keys=True)}" for name, r in rows.items()))

    # b. chaos
    t = time.perf_counter()
    report = run_chaos_drill(fast=True, workdir=str(scratch))
    failed = [c.get("case", c.get("graph")) for c in report["cases"] if not c["ok"]]
    if failed or not report["ok"]:
        raise AssertionError(f"chaos drill: cases failed: {failed}")
    out["chaos"] = {"cases": report["num_cases"], "channel_totals": report["channel_totals"],
                    "wall_s": time.perf_counter() - t}
    print(f"phase 2i, chaos drill (fast, solver and checkpoint legs on the card): "
          f"{report['num_cases']} cases ok in {out['chaos']['wall_s']:.2f} s; channel totals "
          f"{json.dumps(report['channel_totals'])}")

    # c. tuner
    t = time.perf_counter()
    lane_names = ("small128", "rmat13", "ceiling")
    lane_buckets = {name: (*lanes.bucket_key(lane_sets[name][0]), 16, "fused")
                    for name in lane_names}
    rmat18 = graphs["rmat18"]
    ell_bucket = (*lanes.bucket_key(rmat18), 0, "ell")
    rec = measure.search(list(lane_buckets.values()) + [ell_bucket], repeats=5,
                         workloads={ell_bucket: rmat18})
    tuned = {}
    for key, entry in rec["entries"].items():
        bucket = record.parse_bucket_key(key)
        cands = space.enumerate_candidates(*bucket, kernel="cuda")
        dead = entry["rejected"] - (space.raw_space_size(bucket[3]) - len(cands))
        if entry["source"] != "measured" or entry["parity"] != "ok" or dead:
            raise AssertionError(f"tuner {key}: {json.dumps(entry)}")
        tuned[key] = entry
        print(f"phase 2i, tuner {key} ({len(cands)} candidates, {entry['rejected']} rejected, "
              f"parity {entry['parity']}): " + ", ".join(
                  f"{label} {t['median_ms']:.4f} ms (spread {t['spread_ms']:.4f})"
                  for label, t in entry["timings"].items())
              + f"; winner {json.dumps(entry['config'])}")
    out["tuner"] = tuned
    out["tuner_search_s"] = time.perf_counter() - t
    path = str(scratch / "tuning.json")
    record.save_record(rec, path)

    # The record into a fresh process state, through warmup.
    kernels.set_tuned_configs(None)
    lanes.clear_solver_cache()
    plan = warmup.WarmupPlan(buckets=tuple(b[:2] for b in lane_buckets.values()), lanes=16,
                             tuning=path)
    report = warmup.run_warmup(plan)
    if report["tuned_entries"] != len(rec["entries"]):
        raise AssertionError(f"warmup installed {report['tuned_entries']} of "
                             f"{len(rec['entries'])} entries")
    out["warmup"] = report
    misses = BUS.counters().get("compile.miss", 0)
    traced_k1 = {}
    hook = boruvka.hook_and_compress
    for name, bucket in lane_buckets.items():
        config = kernels.tuned_config(bucket)
        n = 16 * bucket[0]
        want_form = config.hook_form
        if want_form == "auto":
            want_form = "block" if n <= kernels.HOOK_BLOCK_FORM_THRESHOLD else "grid"
        traced = []

        def spy(has, dst_frag, fragment, *, form="auto", traced=traced):
            if not traced:
                traced.append((has.clone(), dst_frag.clone(), fragment.clone()))
            return hook(has, dst_frag, fragment, form=form)

        boruvka.hook_and_compress = spy
        try:
            res = lanes.solve_lanes(lane_sets[name][:16], lanes=16)
        finally:
            boruvka.hook_and_compress = hook
        _, ran = kernels.hook_compress_readout()
        for i, (ids, _, _) in enumerate(res):
            if not np.array_equal(ids, lane_oracle[name][i]):
                raise AssertionError(f"tuned batch {name}[{i}]: forest differs from the oracle")
        if ran != want_form:
            raise AssertionError(f"tuned batch {name}: K1 ran {ran}, installed {config}")
        traced_k1[record.bucket_key_str(bucket)] = (n, traced[0])
    if BUS.counters().get("compile.miss", 0) != misses:
        raise AssertionError("a tuned batch built a solver after warmup")
    config = kernels.tuned_config(ell_bucket)
    plans, traced_k3 = [], []
    real_plan, real_level = kernels.ell_plan, kernels.ell_level_min

    def plan_spy(buckets, *, tile_slots=kernels.ELL_TILE_SLOTS):
        plans.append(tile_slots)
        return real_plan(buckets, tile_slots=tile_slots)

    def level_spy(fragment, plan, vmin):
        if not traced_k3:
            traced_k3.append((fragment.clone(), plan.buckets))
        return real_level(fragment, plan, vmin)

    kernels.ell_plan, kernels.ell_level_min = plan_spy, level_spy
    try:
        ids, _, _ = boruvka.solve_graph(rmat18, strategy="ell")
    finally:
        kernels.ell_plan, kernels.ell_level_min = real_plan, real_level
    same = np.array_equal(ids, oracle["rmat18"])
    if not same or plans != [config.tile_slots]:
        raise AssertionError(f"tuned ELL RMAT-18: forest equal {same}, plans at {plans}, "
                             f"installed {config}")
    out["installed"] = {record.bucket_key_str(b): kernels.tuned_config(b).to_json()
                        for b in [*lane_buckets.values(), ell_bucket]}
    out["tuner_phase_s"] = time.perf_counter() - t
    print(f"phase 2i, tuned: warmup installed {report['tuned_entries']} entries; 16-lane batches "
          f"and the RMAT-18 ELL solve under them equal the oracle, no compile.miss after warmup; "
          f"installed {json.dumps(out['installed'])}")

    # d. build cache
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CACHE_CHILD, str(ROOT), str(ROOT / "build")],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    if proc.returncode:
        raise AssertionError(f"build-cache child failed:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    counters = child["counters"]
    if counters.get("compile.persistent.hit", 0) < 2 or counters.get("compile.persistent.miss", 0):
        raise AssertionError(f"build-cache child: {counters}")
    out["build_cache"] = {**child, "build_s": build_s, "child_s": time.perf_counter() - t}
    print(f"phase 2i, build cache: a child process loads both libraries from build/ with "
          f"{json.dumps(counters)}: kernels {child['kernels_load_s']:.3f} s (built in "
          f"{build_s['kernels']:.2f} s), native {child['native_load_s']:.3f} s (built in "
          f"{build_s['native']:.2f} s); {child['stats']['entries']} entries, "
          f"{child['stats']['bytes']} bytes")
    return out, {"k1": traced_k1, "k3": (*traced_k3[0], ell_bucket[0])}


def _tuned_kernels_vs_plain(torch, kernels, cuda_time_ms, traced) -> tuple:
    """Phase 2i's traced inputs through K1 in every form valid at their n
    and K3 at every tile the tuner searches, each against its plain
    version (tolerance 0), and each timed by CUDA events beside its
    bound. Returns ``(max K1 error, max K3 error, K1 records, K3
    records)``."""
    from distributed_ghs_implementation_tpu_torch.tune import space

    err1 = err3 = 0
    k1 = []
    for key, (n, inputs) in traced["k1"].items():
        want = kernels.hook_compress_torch(*inputs)
        rec = {"bucket": key, "n": n, "bound_ms": 17 * n / HBM_BYTES_PER_S * 1e3, "forms": {}}
        for form in space.HOOK_FORM_CHOICES:
            if form == "block" and n > kernels.HOOK_BLOCK_MAX_NODES:
                continue
            err1 = max(err1, _max_abs_err(kernels.hook_compress(*inputs, form=form), want))
            jumps, ran = kernels.hook_compress_readout()
            if form != "auto" and ran != form:
                raise AssertionError(f"K1 {key} forced {form} ran {ran}")
            rec["forms"][form] = {"ran": ran, "jumps": jumps, "ms": cuda_time_ms(
                lambda f=form: kernels.hook_compress(*inputs, form=f))}
        rec["plain_ms"] = cuda_time_ms(lambda: kernels.hook_compress_torch(*inputs))
        k1.append(rec)
        print(f"time hook_compress (tuned bucket {key}, first-level inputs at n={n}) by form: "
              + ", ".join(f"{f} {r['ms']:.4f} ms ({r['jumps']} jumps)"
                          for f, r in rec["forms"].items())
              + f"; plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")
    fragment, buckets, n_pad = traced["k3"]
    slots = sum(b[1].numel() for b in buckets)
    rows = sum(b[0].numel() for b in buckets)
    k3 = []
    for tile in space.TILE_SLOT_CHOICES:
        plan = kernels.ell_plan(buckets, tile_slots=tile)

        def fresh():
            return torch.full((n_pad,), kernels.INT32_MAX, dtype=torch.int32, device="cuda")

        got = kernels.ell_level_min(fragment, plan, fresh())
        want = kernels.ell_level_min_torch(fragment, plan, fresh())
        err3 = max(err3, _max_abs_err((got,), (want,)))
        vmin = fresh()
        k3.append({"tile_slots": tile, "tiles": plan.tiles,
                   "ms": cuda_time_ms(lambda p=plan: kernels.ell_level_min(fragment, p, vmin)),
                   "bound_ms": (8 * slots + 4 * rows + 12 * n_pad) / HBM_BYTES_PER_S * 1e3})
    print("time ell_row_min (RMAT-18's tuned ell bucket, level-1 inputs, one launch a level) by "
          "tile slots: " + ", ".join(f"{r['tile_slots']} {r['ms']:.4f} ms ({r['tiles']} tiles)"
                                     for r in k3)
          + f"; bound {k3[0]['bound_ms']:.4f} ms; K1 error {err1}, K3 error {err3}")
    return err1, err3, k1, k3


def _timed_router(FleetRouter):
    """A ``FleetRouter`` that records each worker incarnation's seconds from
    its spawn to its hello, and the caps the hello carried."""

    class TimedRouter(FleetRouter):
        def __init__(self, config):
            super().__init__(config)
            self.spawned, self.hellos = {}, []

        def _spawn(self, w):
            self.spawned[w.id] = time.monotonic()
            super()._spawn(w)

        def _register_hello(self, w, hello):
            super()._register_hello(w, hello)
            t0 = self.spawned.get(w.id)
            self.hellos.append({
                "worker": w.id, "incarnation": w.incarnation,
                "spawn_to_hello_s": None if t0 is None else time.monotonic() - t0,
                "caps": {k: w.caps.get(k) for k in ("kernel", "warmed", "tuned", "crc",
                                                     "wire")}})

    return TimedRouter


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_path(torch, kernels, graphs, oracle, deck, lane_sets, lane_oracle, scratch,
                service_latency, card) -> dict:
    """The fleet on the card (phase 2j): the port's router over worker
    processes, each a full ``MSTService`` on the card.

    a. a pipe fleet of 2 workers (16 batch lanes, a shared disk store, the
       build cache at this run's ``build/``): the fixture deck as JSON edges,
       phase 2f's 21 ``gnm_random_graph(128, 500)`` sent together (lane-mates
       batch), 4 RMAT-13 as B-frame sections (passed through to the wire
       peers), RMAT-18 by ``graph_path``; a repeat of each kind, ``cached`` on
       the worker that solved it; 12 updates along one RMAT-13 session,
       pinned to one worker, each against the oracle of the updated graph.
    b. the kill drill: worker 0 dies in place of its 3rd request
       (``GHS_FAULT_FLEET_WORKER_CRASH=3``); every accepted request is
       answered and equals the oracle; the worker restarts once and its new
       incarnation loads both libraries from the build cache (hits, no miss).
    c. a ``--listen`` worker run in a thread of this process, so that its
       launches count on this process's wrappers, dialed by a TCP router with
       the chaos layer: batches and B-frames, then a seeded one-way partition
       that expires the lease and heals with a warm rejoin (a repeat is
       still cached). K1 and K2 must have launched in it.
    d. on that router, ``verify_responses=True`` and ``fleet.chaos.payload``
       armed once: the certificate rejects the corrupted answer, the router
       re-dispatches it, and the served answer equals the oracle.
    e. drain: every router shuts down, every worker exits 0, and no frame
       error was read outside the kill drill.

    Every answer's forest and weight must equal the SciPy rank oracle. Prints
    each worker's spawn-to-hello seconds, the hello caps (``kernel`` must be
    ``"cuda"``) and, by request class, the latency through the router, the
    router hop (latency less the worker's service time) beside phase 2g's
    in-process service.
    """
    import dataclasses
    import threading

    from distributed_ghs_implementation_tpu_torch.fleet import framing
    from distributed_ghs_implementation_tpu_torch.fleet import transport as ftransport
    from distributed_ghs_implementation_tpu_torch.fleet import worker as fworker
    from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
    from distributed_ghs_implementation_tpu_torch.fleet.router import FleetConfig, FleetRouter
    from distributed_ghs_implementation_tpu_torch.graphs import generators as gen
    from distributed_ghs_implementation_tpu_torch.graphs import io as graph_io
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

    BUS.enable()
    out = {}
    Timed = _timed_router(FleetRouter)
    small, small_oracle = lane_sets["small128"], lane_oracle["small128"]
    wire13, wire13_oracle = lane_sets["rmat13"][:4], lane_oracle["rmat13"][:4]
    rmat18 = graphs["rmat18"]
    npz18 = str(scratch / "rmat18.npz")
    graph_io.write_npz(rmat18, npz18)
    frame_errors = {"now": 0}
    real_read = ftransport.read_frame

    def counted_read(*args, **kw):
        try:
            return real_read(*args, **kw)
        except framing.FrameError:
            frame_errors["now"] += 1
            raise

    def edges_of(g):
        return [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]

    def json_req(g, cls):
        return {"op": "solve", "num_nodes": g.num_nodes, "edges": edges_of(g),
                "edges_out": True, "slo_class": cls}

    def wire_req(g, cls):
        return {"op": "solve", **g.to_wire(), "edges_out": True, "slo_class": cls}

    def forest(resp):
        pairs = np.asarray(resp["mst_edges"], dtype=np.int64).reshape(-1, 2)
        return _pairs(pairs[:, 0], pairs[:, 1])

    def check(what, resp, g, ids):
        resp = framing.fold_sections(resp)
        if not resp.get("ok"):
            raise AssertionError(f"fleet {what}: {resp}")
        if resp.get("digest") != g.digest():
            raise AssertionError(f"fleet {what}: digest {resp.get('digest')} != the graph's")
        if not np.array_equal(forest(resp), _pairs(g.u[ids], g.v[ids])):
            raise AssertionError(f"fleet {what}: forest differs from the rank oracle")
        if resp["total_weight"] != int(g.w[ids].sum()):
            raise AssertionError(f"fleet {what}: weight {resp['total_weight']}")
        return resp

    latency = {}

    def ask(router, req):
        t = time.perf_counter()
        resp = router.handle(req)
        latency.setdefault(req.get("slo_class"), []).append((time.perf_counter() - t) * 1e3)
        return resp

    def together(router, reqs):
        got = [None] * len(reqs)

        def one(i):
            got[i] = ask(router, reqs[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(g is None for g in got):
            raise AssertionError("fleet: a request was never answered")
        return got

    def counters():
        return dict(BUS.counters())

    def moved(before, names):
        now = BUS.counters()
        return {n: now.get(n, 0) - before.get(n, 0) for n in names}

    def wait_for(cond, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: {what} within {timeout} s")
            time.sleep(0.05)

    def worker_counters(router, prefixes):
        stats = router.handle({"op": "stats"})
        return {wid: {k: v for k, v in info.get("stats", {}).get("counters", {}).items()
                      if k.startswith(prefixes)} for wid, info in stats["workers"].items()}

    base = FleetConfig(workers=2, batch_lanes=16, worker_threads=16,
                       compile_cache_dir=str(ROOT / "build"), heartbeat_interval_s=0.25,
                       restart_backoff_base_s=0.05, ready_timeout_s=300.0,
                       request_timeout_s=600.0)
    routers, thread_worker = [], {}
    ftransport.read_frame = counted_read
    try:
        # a. the pipe fleet
        t = time.perf_counter()
        ra = Timed(dataclasses.replace(base, disk_dir=str(scratch / "store_a")))
        routers.append(ra)
        ra.start()
        out["a_start_s"] = time.perf_counter() - t
        first = {}
        for name, g in deck.items():
            first[name] = check(f"deck {name}", ask(ra, json_req(g, "a_deck")), g, oracle[name])
        resps = together(ra, [json_req(g, "a_small128") for g in small])
        for i, (g, resp) in enumerate(zip(small, resps)):
            first[f"small{i}"] = check(f"small128[{i}]", resp, g, small_oracle[i])
        resps = together(ra, [wire_req(g, "a_rmat13_wire") for g in wire13])
        for i, (g, resp) in enumerate(zip(wire13, resps)):
            first[f"wire{i}"] = check(f"rmat13 B-frame [{i}]", resp, g, wire13_oracle[i])
        path_req = {"op": "solve", "graph_path": npz18, "edges_out": True,
                    "slo_class": "a_rmat18_path"}
        first["rmat18"] = check("rmat18 graph_path", ask(ra, path_req), rmat18, oracle["rmat18"])
        repeats = [("readme", json_req(deck["readme"], "a_repeat"), deck["readme"],
                    oracle["readme"]),
                   ("small0", json_req(small[0], "a_repeat"), small[0], small_oracle[0]),
                   ("wire0", wire_req(wire13[0], "a_repeat"), wire13[0], wire13_oracle[0]),
                   ("rmat18", dict(path_req, slo_class="a_repeat"), rmat18, oracle["rmat18"])]
        for key, req, g, ids in repeats:
            want = first[key]
            resp = check(f"repeat {key}", ask(ra, req), g, ids)
            if not resp.get("cached") or resp["worker"] != want["worker"]:
                raise AssertionError(f"fleet repeat {key}: cached {resp.get('cached')} on "
                                     f"worker {resp['worker']}, solved on {want['worker']}")
        passthrough = BUS.counters().get("fleet.wire.passthrough", 0)
        if passthrough < len(wire13) + 1:
            raise AssertionError(f"fleet: {passthrough} B-frame passthroughs")
        # 12 updates along the session of RMAT-13 (seed 1), pinned to the
        # worker that solved it, each against the oracle of the updated graph
        g13 = wire13[0]
        n13, wdtype = g13.num_nodes, g13.w.dtype
        mirror = {(int(a), int(b)): int(c) for a, b, c in zip(g13.u, g13.v, g13.w)}
        wmax = int(g13.w.max())
        rng = np.random.default_rng(11)
        session = first["wire0"]["worker"]
        digest, tree = g13.digest(), forest(first["wire0"])
        updates = []
        for kind in ("insert", "delete", "reweight") * 4:
            if kind == "insert":
                x, y = sorted(int(q) for q in rng.choice(n13, 2, replace=False))
                while (x, y) in mirror:
                    x, y = sorted(int(q) for q in rng.choice(n13, 2, replace=False))
                upd = {"kind": "insert", "u": x, "v": y, "w": int(rng.integers(1, wmax + 1))}
                mirror[(x, y)] = upd["w"]
            else:
                x, y = (int(q) for q in tree[int(rng.integers(0, len(tree)))])
                if kind == "delete":
                    upd = {"kind": "delete", "u": x, "v": y}
                    del mirror[(x, y)]
                else:
                    upd = {"kind": "reweight", "u": x, "v": y,
                           "w": wmax + int(rng.integers(1, 100))}
                    mirror[(x, y)] = upd["w"]
            keys = np.array(sorted(mirror), dtype=np.int64)
            gu = Graph(n13, keys[:, 0], keys[:, 1],
                       np.array([mirror[(int(a), int(b))] for a, b in keys], dtype=wdtype))
            resp = ask(ra, {"op": "update", "digest": digest, "updates": [upd],
                            "edges_out": True, "slo_class": "a_update"})
            resp = check(f"update {upd}", resp, gu, rank_oracle_edge_ids(gu))
            if resp["worker"] != session or resp.get("prev_digest") != digest:
                raise AssertionError(f"fleet update {upd}: worker {resp['worker']} (session on "
                                     f"{session}), prev {resp.get('prev_digest')}")
            digest, tree = resp["digest"], forest(resp)
            updates.append([kind, resp.get("mode")])
        out["a_updates"] = updates
        out["a_workers"] = worker_counters(ra, ("compile.persistent", "batch.", "serve.requests"))
        a_counters = {k: v for k, v in BUS.counters().items() if k.startswith("fleet.")}
        if a_counters.get("fleet.worker.dead", 0) or frame_errors["now"]:
            raise AssertionError(f"fleet a: {a_counters}, {frame_errors['now']} frame errors")
        ra.shutdown()
        out["a_exit_codes"] = [w.proc.returncode for w in ra._workers]
        if out["a_exit_codes"] != [0, 0]:
            raise AssertionError(f"fleet a: worker exit codes {out['a_exit_codes']}")

        # b. the kill drill
        before, errors_before = counters(), frame_errors["now"]
        rb = Timed(dataclasses.replace(
            base, disk_dir=str(scratch / "store_b"),
            worker_env={0: {"GHS_FAULT_FLEET_WORKER_CRASH": "3"}}))
        routers.append(rb)
        rb.start()
        reqs = [json_req(g, "b_drill") for g in small] + [
            json_req(g, "b_drill") for g in deck.values()]
        gs = list(small) + list(deck.values())
        ids = list(small_oracle) + [oracle[name] for name in deck]
        for i, resp in enumerate(together(rb, reqs)):
            check(f"kill drill [{i}]", resp, gs[i], ids[i])
        wait_for(lambda: BUS.counters().get("fleet.worker.restart", 0)
                 > before.get("fleet.worker.restart", 0), "worker 0 never rejoined")
        ring = HashRing(range(2), replicas=base.ring_replicas)
        fresh = next(g for g in (gen.gnm_random_graph(128, 500, seed=s) for s in range(100, 400))
                     if ring.assign(g.digest()) == 0)
        resp = check("after the restart", ask(rb, json_req(fresh, "b_drill")), fresh,
                     rank_oracle_edge_ids(fresh))
        if resp["worker"] != 0:
            raise AssertionError(f"fleet b: the restarted worker's digest went to {resp['worker']}")
        drill = moved(before, ("fleet.worker.dead", "fleet.requeue", "fleet.worker.restart"))
        reborn = worker_counters(rb, ("compile.persistent",))["0"]
        if drill["fleet.worker.dead"] != 1 or drill["fleet.worker.restart"] != 1 or (
                drill["fleet.requeue"] < 1):
            raise AssertionError(f"fleet b: {drill}")
        if reborn.get("compile.persistent.hit", 0) < 1 or reborn.get("compile.persistent.miss"):
            raise AssertionError(f"fleet b: the new incarnation's build cache {reborn}")
        out["b"] = {**drill, "requests": len(reqs) + 1, "reborn": reborn,
                    "incarnation": rb._workers[0].incarnation,
                    "frame_errors": frame_errors["now"] - errors_before}
        errors_before = frame_errors["now"]
        rb.shutdown()
        out["b_exit_codes"] = [w.proc.returncode for w in rb._workers]
        if out["b_exit_codes"] != [0, 0]:
            raise AssertionError(f"fleet b: worker exit codes {out['b_exit_codes']}")

        # c. a --listen worker in a thread of this process, a TCP router with
        # the chaos layer
        port = _free_port()
        args = fworker.build_parser().parse_args([
            "--worker-id", "0", "--listen", f"127.0.0.1:{port}", "--batch-lanes", "16",
            "--threads", "16", "--no-compile-cache"])
        th = threading.Thread(target=lambda: thread_worker.setdefault(
            "rc", fworker.run_worker(args)), name="fleet-worker-thread", daemon=True)
        k12 = (kernels.hook_compress.launches, kernels.gather_key.launches)
        th.start()
        rc_ = Timed(FleetConfig(
            remote_workers=(f"127.0.0.1:{port}",), transport="tcp", chaos=True, chaos_seed=12,
            verify_responses=True, lease_s=2.0, heartbeat_interval_s=0.2,
            restart_backoff_base_s=0.05, ready_timeout_s=300.0, request_timeout_s=600.0))
        routers.append(rc_)
        rc_.start()
        before = counters()
        for i, resp in enumerate(together(rc_, [json_req(g, "c_small128") for g in small[:16]])):
            check(f"tcp small128[{i}]", resp, small[i], small_oracle[i])
        for i, resp in enumerate(together(rc_, [wire_req(g, "c_rmat13_wire") for g in wire13])):
            check(f"tcp rmat13 B-frame [{i}]", resp, wire13[i], wire13_oracle[i])
        for name, g in deck.items():
            check(f"tcp deck {name}", ask(rc_, json_req(g, "c_deck")), g, oracle[name])
        if frame_errors["now"] != errors_before:
            raise AssertionError(f"fleet c: {frame_errors['now'] - errors_before} frame errors")
        rc_.partition_worker(0, mode="oneway")
        wait_for(lambda: BUS.counters().get("fleet.lease.expired", 0)
                 > before.get("fleet.lease.expired", 0), "the partition never expired the lease")
        held = {}
        during = threading.Thread(target=lambda: held.setdefault("resp", ask(
            rc_, json_req(small[16], "c_partition"))))
        during.start()
        rc_.heal_partition(0)
        wait_for(lambda: rc_._workers[0].alive, "no rejoin after the heal")
        # A link torn by the lease may cut a frame in two: counted apart.
        out["c_partition_frame_errors"] = frame_errors["now"] - errors_before
        errors_before = frame_errors["now"]
        during.join(timeout=600)
        check("answered across the partition", held["resp"], small[16], small_oracle[16])
        warm = check("repeat after the rejoin", ask(rc_, json_req(small[0], "c_repeat")),
                     small[0], small_oracle[0])
        if not warm.get("cached"):
            raise AssertionError("fleet c: the rejoin was not warm (the repeat was not cached)")
        chaos = moved(before, ("fleet.chaos.partition", "fleet.chaos.heal", "fleet.chaos.dropped",
                               "fleet.lease.expired", "fleet.worker.restart"))
        if chaos["fleet.chaos.partition"] != 1 or chaos["fleet.chaos.heal"] != 1 or (
                chaos["fleet.chaos.dropped"] < 1 or chaos["fleet.worker.restart"] != 1):
            raise AssertionError(f"fleet c: {chaos}")
        k1 = kernels.hook_compress.launches - k12[0]
        k2 = kernels.gather_key.launches - k12[1]
        if k1 < 1 or k2 < 1:
            raise AssertionError(f"fleet c: the counted worker launched K1 x{k1}, K2 x{k2}")
        out["c"] = {**chaos, "hook_compress": k1, "gather_key": k2,
                    "worker": worker_counters(rc_, ("batch.", "serve.requests"))["0"]}

        # d. a corrupted answer, certified and re-dispatched
        before = counters()
        FAULTS.arm(ftransport.CHAOS_PAYLOAD_SITE, times=1)
        check("certified", ask(rc_, json_req(small[17], "d_certified")), small[17],
              small_oracle[17])
        cert = moved(before, ("fleet.chaos.payload_corrupted", "verify.failed",
                              "fleet.response.rejected", "verify.corrected"))
        if set(cert.values()) != {1}:
            raise AssertionError(f"fleet d: {cert}")
        out["d"] = cert

        # e. drain
        rc_.shutdown()
        th.join(timeout=120)
        if th.is_alive() or thread_worker.get("rc") != 0:
            raise AssertionError(f"fleet e: the thread worker returned {thread_worker}")
        if frame_errors["now"] != errors_before:
            raise AssertionError(f"fleet: {frame_errors['now'] - errors_before} frame errors")
        out["e"] = {"exit_codes": out.pop("a_exit_codes") + out.pop("b_exit_codes")
                    + [thread_worker["rc"]], "frame_errors_outside_the_drill": 0}
    finally:
        ftransport.read_frame = real_read
        for router in routers:
            if not router._closed:
                router.shutdown(drain=False)

    hellos = [dict(h, step=step) for step, router in zip("abc", routers) for h in router.hellos]
    if any(h["caps"]["kernel"] != "cuda" for h in hellos):
        raise AssertionError(f"fleet: a worker's hello does not read kernel cuda: {hellos}")
    print(f"phase 2j ({card}), spawn to hello s by step, worker, incarnation: " + ", ".join(
        f"{h['step']} {h['worker']}.{h['incarnation']} "
        + ("dialed" if h["spawn_to_hello_s"] is None else f"{h['spawn_to_hello_s']:.3f}")
        for h in hellos))
    print(f"phase 2j ({card}), hello caps: " + json.dumps([
        {"step": h["step"], "worker": h["worker"], **h["caps"]} for h in hellos]))
    hists = BUS.histograms()
    by_class = {}
    for cls, values in sorted(latency.items()):
        hop = hists.get(f"fleet.hop_s.{cls}", {})
        by_class[cls] = {"count": len(values), "router_median_ms": statistics.median(values),
                         "router_max_ms": max(values),
                         "hop_median_ms": hop.get("p50", float("nan")) * 1e3,
                         "hop_max_ms": hop.get("max", float("nan")) * 1e3}
    in_process = {k: service_latency[k]["median"] for k in (
        "solve/mst/solved", "solve/mst/cache", "update/mst/incremental") if k in service_latency}
    print(f"phase 2j ({card}), latency ms by class through the router and the router hop "
          f"(latency less the worker's service time): " + json.dumps(by_class)
          + "; phase 2g's in-process service, median ms: " + json.dumps(in_process))
    out.update(hellos=hellos, latency_ms=by_class, in_process_ms=in_process)
    return out


def _cli(cli, argv) -> str:
    """``cli.main(argv)`` in this process; returns its standard output. A
    non-zero exit raises."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}")
    return out.getvalue()


def _front_end_path(torch, kernels, graphs, oracle, scratch, card) -> dict:
    """The front ends on the card (phase 2k): the port's CLI in this process,
    so that its launches count on this process's wrappers, plus the entry
    module, the native ELL buckets against their NumPy form, and one
    ``python -m`` subprocess. Every step's forest must equal the SciPy rank
    oracle; a CLI step that exits non-zero fails the phase."""
    from distributed_ghs_implementation_tpu_torch import cli, entry
    from distributed_ghs_implementation_tpu_torch.graphs import io as graph_io
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models import boruvka
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

    steps, out = {}, {"card": card}
    build = str(ROOT / "build")

    def step(name, fn):
        t = time.perf_counter()
        got = fn()
        steps[name] = time.perf_counter() - t
        return got

    def same_forest(what, pairs, g, ids):
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if not np.array_equal(_pairs(pairs[:, 0], pairs[:, 1]), _pairs(g.u[ids], g.v[ids])):
            raise AssertionError(f"front ends, {what}: forest differs from the rank oracle")

    def result_file(what, path, g, ids):
        res = json.loads(Path(path).read_text())
        same_forest(what, res["mst_edges"], g, ids)
        if res["total_weight"] != int(g.w[ids].sum()):
            raise AssertionError(f"front ends, {what}: weight {res['total_weight']}")
        return res

    # a. RMAT-18 through generate --npz, then run --verify --metrics-out
    rmat18 = graphs["rmat18"]
    d18 = scratch / "rmat18"
    step("generate_rmat18_s", lambda: _cli(cli, [
        "generate", "--kind", "rmat", "--rmat-scale", "18", "--rmat-edge-factor", "16",
        "--seed", "1", "--npz", "--output-dir", str(d18)]))
    npz18 = str(d18 / "graph.npz")
    if graph_io.read_npz(npz18).digest() != rmat18.digest():
        raise AssertionError("front ends: generate --kind rmat gave another RMAT-18")
    k1 = kernels.hook_compress.launches
    step("run_rmat18_s", lambda: _cli(cli, [
        "run", "--graph-dir", npz18, "--verify", "--output", str(scratch / "r18.json"),
        "--metrics-out", str(scratch / "r18.metrics.json")]))
    if kernels.hook_compress.launches == k1:
        raise AssertionError("front ends: run on RMAT-18 launched no K1")
    res = result_file("run RMAT-18", scratch / "r18.json", rmat18, oracle["rmat18"])
    metrics = json.loads((scratch / "r18.metrics.json").read_text())
    if metrics["schema"] != "ghs-bench-metrics-v1" or metrics["metrics"]["mst_edges"] != len(
            oracle["rmat18"]):
        raise AssertionError(f"front ends: metrics {metrics}")
    out["run_rmat18"] = {"execution_time": res["execution_time"], "levels": res["num_levels"],
                         "backend": res["backend"]}

    # b. a reference-format partition dir: generate, run --verify, verify --result
    ref = scratch / "ref"
    step("reference_dir_s", lambda: (
        _cli(cli, ["generate", "--nodes", "60", "--edge-prob", "0.1", "--seed", "7",
                   "--output-dir", str(ref)]),
        _cli(cli, ["run", "--graph-dir", str(ref), "--verify", "--output",
                   str(scratch / "ref.json")]),
        _cli(cli, ["verify", "--graph-dir", str(ref), "--result", str(scratch / "ref.json")])))
    gref = graph_io.read_partition_dir(str(ref))
    result_file("reference dir", scratch / "ref.json", gref, rank_oracle_edge_ids(gref))

    # c. experiments --extended
    step("experiments_s", lambda: _cli(cli, [
        "experiments", "--extended", "--output", str(scratch / "exp.json")]))
    records = json.loads((scratch / "exp.json").read_text())
    if len(records) != 9 or not all(r["is_correct"] for r in records):
        raise AssertionError(f"front ends: experiments {records}")

    # d. serve --input, one process and a fleet of 2 workers
    deck = {name: graphs[name] for name in ("readme", "er48", "rmat12", "road40", "forest23")}
    npz13 = str(scratch / "rmat13.npz")
    graph_io.write_npz(graphs["rmat13"], npz13)
    reqs = [({"op": "solve", "num_nodes": g.num_nodes, "edges_out": True,
              "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]}, name)
            for name, g in deck.items()]
    reqs.append(({"op": "solve", "graph_path": npz13, "edges_out": True}, "rmat13"))
    jsonl = scratch / "deck.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r, _ in reqs) + "\n")

    def serve(extra):
        text = _cli(cli, ["serve", "--input", str(jsonl), "--batch-lanes", "16",
                             "--compile-cache-dir", build] + extra)
        answers = [json.loads(line) for line in text.splitlines()]
        if len(answers) != len(reqs):
            raise AssertionError(f"front ends: serve {extra}: {len(answers)} answers")
        for (_, name), ans in zip(reqs, answers):
            if not ans.get("ok"):
                raise AssertionError(f"front ends: serve {extra} {name}: {ans}")
            same_forest(f"serve {extra} {name}", ans["mst_edges"], graphs[name], oracle[name])
        return answers

    k2 = kernels.gather_key.launches
    step("serve_s", lambda: serve([]))
    if kernels.gather_key.launches == k2:
        raise AssertionError("front ends: serve launched no K2")
    step("serve_fleet2_s", lambda: serve(["--fleet", "2", "--disk-cache",
                                          str(scratch / "store")]))

    # e. run --backend sharded (one shard a card)
    step("run_sharded_s", lambda: _cli(cli, [
        "run", "--graph-dir", npz13, "--backend", "sharded", "--output",
        str(scratch / "sharded.json")]))
    result_file("run --backend sharded", scratch / "sharded.json", graphs["rmat13"],
                oracle["rmat13"])

    # f. trace and stats
    def trace():
        _cli(cli, ["trace", "--out", str(scratch / "trace.json"), "--jsonl",
                   str(scratch / "trace.jsonl")])
        text = _cli(cli, ["stats", "--input", str(scratch / "trace.jsonl")])
        if "solver.level" not in text:
            raise AssertionError("front ends: stats shows no solver.level span")

    step("trace_stats_s", trace)

    # g. tune, h. chaos
    def tune():
        return json.loads(_cli(cli, ["tune", "--buckets", "2048x8192", "--lanes", "16",
                                     "--out", str(scratch / "tuning.json")]))

    tuned = step("tune_s", tune)
    out["tune"] = {"buckets": tuned["buckets"], "winners": tuned["winners"],
                   "pinned": tuned["pinned"]}
    step("chaos_s", lambda: _cli(cli, ["chaos", "--output", str(scratch / "chaos.json")]))

    # i. the entry module: four shards on the card
    out["dryrun"] = step("dryrun_multichip_s", lambda: entry.dryrun_multichip(4))

    # j. a cold ELL solve of RMAT-18, its buckets native against NumPy, in
    # turns (native, NumPy, NumPy, native, ...): a fresh Graph each time, so
    # the rank order is cold too.
    def cold_ell(native):
        g = Graph(rmat18.num_nodes, rmat18.u, rmat18.v, rmat18.w)
        torch.cuda.synchronize()
        t = time.perf_counter()
        g.__dict__["ell_buckets"] = g.build_ell_buckets(native=native)
        buckets_s = time.perf_counter() - t
        ids, _, _ = boruvka.solve_graph(g, strategy="ell")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not np.array_equal(ids, oracle["rmat18"]):
            raise AssertionError("front ends: the cold ELL solve differs from the rank oracle")
        return wall, buckets_s

    def ell_turns():
        times = {True: [], False: []}
        for turn in range(2):
            for native in ((True, False) if turn % 2 == 0 else (False, True)):
                times[native].append(cold_ell(native))
        return times

    k3 = kernels.ell_row_min.launches
    times = step("ell_turns_s", ell_turns)
    if kernels.ell_row_min.launches == k3:
        raise AssertionError("front ends: the ELL solves launched no K3")
    out["ell_cold_rmat18"] = {
        side: {"solve_s": [w for w, _ in times[flag]], "buckets_s": [b for _, b in times[flag]],
               "solve_median_s": statistics.median(w for w, _ in times[flag])}
        for side, flag in (("native", True), ("numpy", False))}

    # k. python -m on the card, a process of its own
    def module_run():
        proc = subprocess.run(
            [sys.executable, "-m", PORT, "run", "--graph-dir", str(ref), "--verify",
             "--output", str(scratch / "module.json")],
            cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"front ends: python -m {PORT} run: {proc.stderr[-2000:]}")
        result_file("python -m run", scratch / "module.json", gref, rank_oracle_edge_ids(gref))

    step("python_m_run_s", module_run)
    out["steps_s"] = steps
    return out


#: Phase 2l's workloads: (name, argv, entry, kernels that must launch in
#: it, the check of its JSON line and metrics). ``cli`` is
#: ``cli.main(["bench", ...])``; the workloads the CLI does not reach go
#: through the bench module's ``main``, both in this process.
BENCH_WORKLOADS = (
    ("rmat20", ["--scale", "20"], "cli", ("hook_compress",),
     lambda line, m: "weight-verified" in line["metric"]
     and m["mst_weight"] == RMAT20_ORACLE_WEIGHT),
    ("sharded18", ["--scale", "18", "--backend", "sharded"], "cli", ("hook_compress",),
     lambda line, m: "weight-verified" in line["metric"]),
    ("batch16", ["--batch-lanes", "16"], "cli", ("gather_key", "hook_compress"),
     lambda line, m: line["parity"] == "edge-exact vs sequential"),
    ("update_stream", ["--update-stream"], "cli", ("gather_key", "hook_compress"),
     lambda line, m: line["parity"] == "edge-exact vs sequential AND fresh solve"),
    ("verify", ["--verify"], "bench", (),
     lambda line, m: line["mutation_rejected"] == 24 and m["verify_failed_clean"] == 0),
    ("kinds", ["--kinds"], "bench", ("hook_compress",),
     lambda line, m: line["wrong_results"] == 0),
    ("tuned", ["--tuned"], "bench", ("gather_key", "hook_compress"),
     lambda line, m: line["tune_record_hits"] >= 1),
    # One resident re-solve a warm repeat (3) and one for the update.
    ("sharded_lane", ["--sharded-lane"], "bench", ("hook_compress",),
     lambda line, m: (line["reshard_skipped"], line["update_donated"]) == (4, 1)),
    ("stream_sharded", ["--stream-sharded"], "bench", (),
     lambda line, m: (line["replay_fresh_solves"], line["residency_restored"]) == (0, 1)),
    # The echo fleets at a cut depth (defaults 200 requests, 6 forwards, 16
    # graphs, 3 repeats): their time is the workers' spawn, about 6 s a
    # fleet on the card, and the phase keeps to its budget.
    ("fleet_tcp", ["--fleet-tcp", "--fleet-requests", "50", "--fleet-forward", "2"], "bench",
     (), lambda line, m: (line["forward_hit"], line["forward_miss"], line["elastic_scale_up"],
                          line["elastic_scale_down"]) == (2, 2, 1, 1)),
    ("wire", ["--wire", "--wire-graphs", "8", "--repeats", "1"], "bench", (),
     lambda line, m: (line["wire_passthrough"], line["wire_fallback_json"]) == (8, 0)
     and line["wire_mixed_passthrough"] + line["wire_mixed_fallback_json"] == 8),
)


def _bench_path(kernels, scratch, card) -> dict:
    """The benchmark on the card (phase 2l): each workload of the port's
    ``bench.py`` once, at its defaults but RMAT-20 and sharded RMAT-18, in
    this process so that its launches count. Each must exit 0 with a JSON
    line as its last line, carry the card, pass its own correctness
    fields, and launch the kernels ``BENCH_WORKLOADS`` names."""
    import contextlib
    import io

    from distributed_ghs_implementation_tpu_torch import bench, cli

    out = {}
    for name, argv, entry, want, check in BENCH_WORKLOADS:
        path = scratch / f"{name}.json"
        before = {w.__name__: w.launches for w in kernels.WRAPPERS}
        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = (cli.main(["bench"] + argv + ["--metrics-out", str(path)]) if entry == "cli"
                  else bench.main(argv + ["--metrics-out", str(path)]))
        wall = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"bench {name}: exit {rc}: {text.getvalue()[-2000:]}")
        line = json.loads(text.getvalue().strip().splitlines()[-1])
        metrics = json.loads(path.read_text())["metrics"]
        launched = {w.__name__: w.launches - before[w.__name__] for w in kernels.WRAPPERS}
        idle = [k for k in want if launched[k] < 1]
        if idle or line["device"] != card or line.get("kernel", "cuda") != "cuda":
            raise AssertionError(f"bench {name}: {idle} never launched ({launched}), {line}")
        if not check(line, metrics):
            raise AssertionError(f"bench {name}: wrong result: {line}")
        out[name] = {"wall_s": wall, "launches": launched,
                     **{k: v for k, v in line.items() if k not in ("metric", "device")}}
        print(f"bench {name} ({card}, {wall:.2f} s): {json.dumps(line)}")
    return out


#: Phase 2m's drill runs: (name, argv, kernels that must launch in this
#: process). The fleet runs' solves are in their worker processes.
LOAD_DRILL_RUNS = (
    ("service_chaos", ["--smoke", "--chaos"], ("gather_key", "hook_compress")),
    ("stream", ["--smoke", "--no-chaos", "--update-heavy"], ("gather_key", "hook_compress")),
    ("kinds", ["--kinds-mixed"], ("hook_compress",)),
    ("fleet2_kill1", ["--smoke", "--no-chaos", "--fleet", "2", "--kill-worker", "1"], ()),
    ("router_kill", ["--smoke", "--no-chaos", "--fleet", "3", "--kill-router", "--transport",
                     "tcp", "--test-echo"], ()),
)


def _load_drill_path(kernels, scratch, card) -> dict:
    """The open-loop load drill on the card (phase 2m): each run of
    ``LOAD_DRILL_RUNS`` through ``load_drill.main`` in this process, so that
    the in-process service's launches count. Each must exit 0 with a report
    that is ``ok``, loses no accepted query, carries the card, and launched
    the kernels the run names. The drill's temporary stores go under
    ``scratch``."""
    import contextlib
    import io
    import tempfile

    from distributed_ghs_implementation_tpu_torch import load_drill

    out = {}
    tmp = scratch / "tmp"
    tmp.mkdir()
    tempfile.tempdir = str(tmp)
    try:
        for name, argv, want in LOAD_DRILL_RUNS:
            path = scratch / f"{name}.json"
            before = {w.__name__: w.launches for w in kernels.WRAPPERS}
            text = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = load_drill.main(argv + ["--obs-dir", str(scratch / f"{name}_obs"),
                                             "--output", str(path)])
            wall = time.perf_counter() - t
            report = json.loads(path.read_text())
            metrics = report["gate_metrics"]["metrics"]
            launched = {w.__name__: w.launches - before[w.__name__] for w in kernels.WRAPPERS}
            idle = [k for k in want if launched[k] < 1]
            failed = [c["name"] for c in report["checks"] if not c["ok"]]
            lost = metrics.get("lost_accepted", 0)
            if (rc != 0 or not report["ok"] or lost or metrics.get("wrong_results", 0)
                    or report["config"]["device"] != card or idle):
                raise AssertionError(f"load drill {name}: exit {rc}, failed {failed}, lost "
                                     f"{lost}, {idle} never launched ({launched}), "
                                     f"{text.getvalue()[-2000:]}")
            classes = {cls: {"sent": c["sent"], "goodput_per_sec": c["goodput_per_sec"],
                             **{p: c["latency_s"].get(p) for p in ("p50", "p95", "p99")}}
                       for cls, c in report["slo"]["classes"].items()}
            out[name] = {"wall_s": wall, "workload": report["config"]["workload"],
                         "checks": len(report["checks"]), "lost_accepted": lost,
                         "launches": launched, "classes": classes,
                         "compile": report.get("compile_counters")}
            print(f"load drill {name} ({card}, {wall:.2f} s, {report['config']['workload']}, "
                  f"{len(report['checks'])} checks passed, lost_accepted {lost}): per class "
                  f"p50/p95/p99 s and goodput/s "
                  + json.dumps({cls: [round(c[p], 5) for p in ("p50", "p95", "p99")]
                                + [round(c["goodput_per_sec"] or 0, 3)]
                                for cls, c in classes.items()})
                  + f"; window compile.* {json.dumps(out[name]['compile'])}")
    finally:
        tempfile.tempdir = None
    return out


def _surface_path(torch, kernels, graphs, oracle, oracle_w, card) -> dict:
    """The public surface on the card (phase 2n), reached only through the
    port's package exports (``graphs``, ``models``, ``ops``, ``utils``,
    ``parallel`` and the package itself):

    a. ``ops.fragment_moe`` and ``ops.hook_and_compress`` at RMAT-18's level
       1 (the partition after the identity level) on CUDA tensors: K2 and
       K1 must launch, and equal the torch forms on CPU copies, element for
       element;
    b. ``models.solve_graph`` on RMAT-13 and ``parallel.make_sharded_solver``
       over 4 shards on the card on RMAT-13, each equal to the rank oracle;
    c. ``utils.verify_result(oracle="auto")`` on RMAT-20 and RMAT-21: the
       native Kruskal pass (``native``), ``ok``, timed beside SciPy's
       weight of the same graph (on two threads under the rest of the
       phase); SciPy's weight of RMAT-18 equal to its native weight.
    """
    from distributed_ghs_implementation_tpu_torch import (
        minimum_spanning_forest,
        models,
        ops,
        parallel,
        utils,
    )
    from distributed_ghs_implementation_tpu_torch import graphs as pgraphs

    dev = torch.device("cuda")
    out = {}

    def scipy_timed(g):
        t = time.perf_counter()
        return utils.scipy_mst_weight(g), time.perf_counter() - t

    with ThreadPoolExecutor(2) as pool:
        scipy_f = {name: pool.submit(scipy_timed, graphs[name]) for name in FILTER_GRAPHS}
        # a. K2 and K1 through the ops exports at RMAT-18's level 1.
        g18 = graphs["rmat18"]
        if not isinstance(g18, pgraphs.Graph):
            raise AssertionError("RMAT-18 is not the exported Graph")
        src, dst, rank, ra, rb = (torch.from_numpy(a).to(dev) for a in g18.rank_arrays())
        f0 = torch.arange(g18.num_nodes, dtype=torch.int32, device=dev)
        has0, _, d0 = ops.fragment_moe(f0, src, dst, rank, ra, rb, identity_fragment=True)
        f1, _ = ops.hook_and_compress(has0, d0, f0)
        before = {w.__name__: w.launches for w in kernels.WRAPPERS}
        moe = ops.fragment_moe(f1, src, dst, rank, ra, rb)
        hooked = ops.hook_and_compress(moe[0], moe[2], f1)
        torch.cuda.synchronize()
        launched = {w.__name__: w.launches - before[w.__name__] for w in kernels.WRAPPERS}
        if launched["gather_key"] < 1 or launched["hook_compress"] < 1:
            raise AssertionError(f"surface: ops exports launched {launched}")
        cpu = [t.cpu() for t in (f1, src, dst, rank, ra, rb)]
        want_moe = ops.fragment_moe(*cpu)
        want_hook = ops.hook_and_compress(want_moe[0], want_moe[2], cpu[0])
        err = max(_max_abs_err([t.cpu() for t in moe], want_moe),
                  _max_abs_err([t.cpu() for t in hooked], want_hook))
        if err:
            raise AssertionError(f"surface: ops exports differ from the torch forms by {err}")
        out["ops"] = {"graph": "rmat18 level 1", "n": g18.num_nodes, "slots": src.numel(),
                      "launches": launched, "max_abs_err": err}
        # b. the solver and the sharded solver factory through the exports.
        g13 = graphs["rmat13"]
        t = time.perf_counter()
        ids, _, levels = models.solve_graph(g13)
        solve_s = time.perf_counter() - t
        if not np.array_equal(ids, oracle["rmat13"]):
            raise AssertionError("surface: models.solve_graph differs from the rank oracle")
        mesh = parallel.edge_mesh(num_shards=4)
        e_pad = -(-2 * g13.num_edges // (2 * mesh.size)) * 2 * mesh.size
        arrays = g13.rank_arrays(pad_edges_to=e_pad, pad_ranks_to=e_pad // 2)
        t = time.perf_counter()
        mst, fragment, sharded_levels = parallel.make_sharded_solver(mesh, g13.num_nodes)(*arrays)
        sharded_ids = np.sort(g13.edge_id_of_rank(np.nonzero(mst.cpu().numpy())[0]))
        sharded_s = time.perf_counter() - t
        if not np.array_equal(sharded_ids, oracle["rmat13"]) or sharded_levels != levels:
            raise AssertionError("surface: make_sharded_solver differs from the rank oracle")
        out["solve_graph"] = {"graph": "rmat13", "levels": levels, "s": solve_s}
        out["make_sharded_solver"] = {"graph": "rmat13", "shards": mesh.size,
                                      "levels": sharded_levels, "s": sharded_s}
        # c. the native oracle through verify_result, beside SciPy's.
        t = time.perf_counter()
        scipy18 = utils.scipy_mst_weight(g18)
        scipy18_s = time.perf_counter() - t
        if scipy18 != oracle_w["rmat18"]:
            raise AssertionError(f"surface: RMAT-18's SciPy weight {scipy18} != native "
                                 f"{oracle_w['rmat18']}")
        out["rmat18_weight"] = {"scipy_s": scipy18_s, "scipy": scipy18,
                                "native": oracle_w["rmat18"]}
        verified = {}
        for name in FILTER_GRAPHS:
            r = minimum_spanning_forest(graphs[name])
            if not np.array_equal(r.edge_ids, oracle[name]):
                raise AssertionError(f"surface: {name} differs from the rank oracle")
            t = time.perf_counter()
            v = utils.verify_result(r, oracle="auto")
            verified[name] = {"oracle": v.oracle, "ok": v.ok, "native_s": time.perf_counter() - t,
                              "weight": v.expected_weight}
            if v.oracle != "native" or not v.ok:
                raise AssertionError(f"surface: verify_result on {name}: {v}")
        for name, f in scipy_f.items():
            weight, seconds = f.result()
            verified[name]["scipy_s"] = seconds
            if weight != verified[name]["weight"]:
                raise AssertionError(f"surface: {name}'s SciPy weight {weight} != native "
                                     f"{verified[name]['weight']}")
        out["verify_result"] = verified
    print(f"phase 2n ({card}), verify_result(oracle='auto') s, the native pass beside SciPy's "
          "weight of the same graph (SciPy on two threads under the phase): " + json.dumps(
              {name: {k: v for k, v in rec.items() if k != "weight"}
               for name, rec in out["verify_result"].items()})
          + f"; RMAT-18: SciPy {scipy18_s:.3f} s, equal to the native weight")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_ghs_implementation_tpu_torch import (
        gather_probe,
        minimum_spanning_forest,
        minimum_spanning_tree,
    )
    from distributed_ghs_implementation_tpu_torch.batch.lanes import bucket_key
    from distributed_ghs_implementation_tpu_torch.device import (
        card_description,
        cuda_time_in_turns_ms,
        cuda_time_ms,
    )
    from distributed_ghs_implementation_tpu_torch.graphs import generators as gen
    from distributed_ghs_implementation_tpu_torch.graphs import native
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models import boruvka
    from distributed_ghs_implementation_tpu_torch.models import rank_solver
    from distributed_ghs_implementation_tpu_torch.ops import _build, kernels
    from distributed_ghs_implementation_tpu_torch.ops.segment_ops import fragment_moe
    from distributed_ghs_implementation_tpu_torch.utils.verify import (
        native_mst_weight,
        rank_oracle_edge_ids,
        scipy_mst_weight,
        verify_result,
    )

    print(f"card: {card_description()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    cached = _build.library_path().is_file()
    lib_path = _build.build_library()
    t1 = time.perf_counter()
    native_cached = native.library_path().is_file()
    native_path = native.build_library()
    native.get_lib()
    build_s = {"kernels": t1 - t0, "native": time.perf_counter() - t1}
    print(f"build: kernels {t1 - t0:.2f} s ({'cached' if cached else 'compiled'}) "
          f"{lib_path.relative_to(ROOT)}; native host library {time.perf_counter() - t1:.2f} s "
          f"({'cached' if native_cached else 'compiled'}) {native_path.relative_to(ROOT)}")

    # Host-side inputs and oracles: set-up, outside the main path's window.
    # The oracles run on a thread each core (their sorts, csgraph's tree
    # and the native pass release the GIL) while the lane sets are
    # generated: SciPy's rank oracle for every edge id, the native Kruskal
    # pass for every weight (SciPy's where it has nothing to do).
    t0 = time.perf_counter()
    deck = _fixture_deck(Graph, gen)
    rmat13 = gen.rmat_graph(13, 16, seed=1)
    rmat18 = gen.rmat_graph(18, 16, seed=1)
    grid2048 = gen.road_grid_graph(2048, 2048, seed=1)
    road1024 = gen.random_road_network(1024, 1024, seed=1)
    rmat20 = gen.rmat_graph(20, 16, seed=24)
    rmat21 = gen.rmat_graph(21, 16, seed=1)
    graphs = {**deck, "rmat13": rmat13, "rmat18": rmat18, "grid2048": grid2048,
              "road1024": road1024, "rmat20": rmat20, "rmat21": rmat21}
    setup_s = {"graphs": time.perf_counter() - t0}
    oracle_s = {}

    def timed(key, fn, g):
        t = time.perf_counter()
        value = fn(g)
        oracle_s[key] = time.perf_counter() - t
        return value

    def expected_weight(g):
        weight = native_mst_weight(g)
        return scipy_mst_weight(g) if weight is None else weight

    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        oracle_f = {name: pool.submit(timed, f"rank {name}", rank_oracle_edge_ids, g)
                    for name, g in graphs.items()}
        weight_f = {name: pool.submit(timed, f"weight {name}", expected_weight, g)
                    for name, g in graphs.items()}
        # Phase 2f's lane sets: 16 RMAT-13 graphs of one bucket, 21
        # 128-vertex graphs of one bucket (16 lanes and a partial batch of
        # 5), and 16 graphs of the policy's ceiling bucket, 2^16 vertices
        # and 2^17 ranks.
        t = time.perf_counter()
        lane_sets = {
            "rmat13": [rmat13] + [gen.rmat_graph(13, 16, seed=s) for s in range(2, 17)],
            "small128": [gen.gnm_random_graph(128, 500, seed=s) for s in range(1, 22)],
            "ceiling": [gen.gnm_random_graph(60000, 120000, seed=s) for s in range(1, 17)]}
        setup_s["lane_sets"] = time.perf_counter() - t
        lane_f = {name: [pool.submit(timed, f"rank {name}[{i}]", rank_oracle_edge_ids, g)
                         for i, g in enumerate(gs)] for name, gs in lane_sets.items()}
        for name, gs in lane_sets.items():
            buckets = {bucket_key(g) for g in gs}
            if len(buckets) != 1:
                raise AssertionError(f"{name}: the lane set spans buckets {buckets}")
        t = time.perf_counter()
        oracle = {name: f.result() for name, f in oracle_f.items()}
        lane_oracle = {name: [f.result() for f in fs] for name, fs in lane_f.items()}
        oracle_w = {name: f.result() for name, f in weight_f.items()}
    setup_s["oracles_wait"] = time.perf_counter() - t
    # Phase 2g's inputs: RMAT-18 as an .npz for ``graph_path``, and as one
    # JSON request for the ingest timing.
    from distributed_ghs_implementation_tpu_torch.graphs import io as graph_io

    inputs = ROOT / "build" / "smoke_inputs"
    shutil.rmtree(inputs, ignore_errors=True)
    inputs.mkdir(parents=True)
    npz18 = str(inputs / "rmat18.npz")
    graph_io.write_npz(rmat18, npz18)
    json18 = _json_request(rmat18)
    if rmat13.num_edges >= boruvka.ELL_AUTO_EDGE_THRESHOLD:
        raise AssertionError(f"RMAT-13 has {rmat13.num_edges} edges: auto would not run fused")
    if oracle_w["rmat20"] != RMAT20_ORACLE_WEIGHT:
        raise AssertionError(f"RMAT-20 seed 24: oracle weight {oracle_w['rmat20']}, recorded "
                             f"{RMAT20_ORACLE_WEIGHT}")
    setup_s["oracles_summed"] = sum(oracle_s.values())
    slowest = sorted(oracle_s.items(), key=lambda kv: -kv[1])[:6]
    print(f"setup: {time.perf_counter() - t0:.2f} s, split s: " + json.dumps(setup_s)
          + f"; oracles on {os.cpu_count()} threads, the slowest s: " + json.dumps(dict(slowest)))
    print(f"setup: {time.perf_counter() - t0:.2f} s; " + "; ".join(
        f"{name} {graphs[name].num_nodes} vertices {graphs[name].num_edges} edges "
        f"{getattr(graphs[name], 'generator_path', '')}"
        for name in ("rmat13", "rmat18", "grid2048", "road1024") + FILTER_GRAPHS)
        + f"; RMAT-20's oracle weight is the recorded {RMAT20_ORACLE_WEIGHT}")

    # -- 2. main path -------------------------------------------------------
    def zero_counts():
        for w in kernels.WRAPPERS:
            w.launches = 0

    def read_counts(path, want):
        counts = {w.__name__: w.launches for w in kernels.WRAPPERS}
        idle = [name for name in want if counts[name] < 1]
        if idle:
            raise AssertionError(f"{path} path: {idle} never launched: {counts}")
        return counts

    def check(name, edge_ids, weight):
        if not np.array_equal(edge_ids, oracle[name]):
            raise AssertionError(f"{name}: forest differs from the rank oracle")
        if weight != oracle_w[name]:
            raise AssertionError(f"{name}: weight {weight} != oracle {oracle_w[name]}")

    def counted_fused(name, solve):
        """Run a fused solve; K1 must launch once per level, K2 once per
        level after level 0."""
        k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        edge_ids, levels = solve()
        wall = time.perf_counter() - t
        d1 = kernels.hook_compress.launches - k1
        d2 = kernels.gather_key.launches - k2
        if (d1, d2) != (levels, levels - 1):
            raise AssertionError(f"{name}: {levels} levels but K1 x{d1}, K2 x{d2}")
        check(name, edge_ids, float(graphs[name].w[edge_ids].sum()))
        return wall, {"levels": levels, "hook_compress": d1, "gather_key": d2}

    def counted_ell(name):
        """Run an ELL solve; K1 must launch once per level, K3 once on every
        level after level 0."""
        g = graphs[name]
        k1, k3 = kernels.hook_compress.launches, kernels.ell_row_min.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        edge_ids, _, levels = boruvka.solve_graph(g, strategy="ell")
        wall = time.perf_counter() - t
        d1 = kernels.hook_compress.launches - k1
        d3 = kernels.ell_row_min.launches - k3
        buckets = len(g.ell_buckets)
        if (d1, d3) != (levels, levels - 1):
            raise AssertionError(
                f"{name}: {levels} levels over {buckets} buckets but K1 x{d1}, K3 x{d3}")
        check(name, edge_ids, float(g.w[edge_ids].sum()))
        return wall, {"levels": levels, "buckets": buckets, "hook_compress": d1,
                      "ell_row_min": d3}

    # 2a. flat path
    zero_counts()
    t_main = time.perf_counter()
    r = minimum_spanning_tree(deck["readme"])
    if r.total_weight != 20 or not verify_result(r).ok:
        raise AssertionError(f"README sample: weight {r.total_weight}, not 20")
    main = {}

    def via_api(g):
        res = minimum_spanning_forest(g)  # strategy auto: fused below 2^17 edges
        return res.edge_ids, res.num_levels

    def fused(g):
        ids, _, levels = boruvka.solve_graph(g, strategy="fused")
        return ids, levels

    for name, g in deck.items():
        counted_fused(name, lambda: via_api(g))
        ids, _, _ = boruvka.solve_graph(g, strategy="stepped")
        check(name, ids, float(g.w[ids].sum()))
    main["rmat13_auto_s"], _ = counted_fused("rmat13", lambda: via_api(rmat13))
    for run in ("cold", "warm"):
        main[f"rmat18_fused_{run}_s"], per_solve = counted_fused("rmat18", lambda: fused(rmat18))
        main["rmat18_fused_launches"] = per_solve
    for run in ("cold", "warm"):
        before = [w.launches for w in kernels.WRAPPERS]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, _, stepped_levels = boruvka.solve_graph(rmat18, strategy="stepped")
        main[f"rmat18_stepped_{run}_s"] = time.perf_counter() - t
        main["rmat18_stepped_launches"] = {
            w.__name__: w.launches - b for w, b in zip(kernels.WRAPPERS, before)}
        check("rmat18", ids, float(rmat18.w[ids].sum()))
        if stepped_levels != per_solve["levels"]:
            raise AssertionError(
                f"stepped took {stepped_levels} levels, fused {per_solve['levels']}")
    flat_counts = read_counts("flat", ("gather_key", "hook_compress", "probe"))
    main["launches"] = flat_counts
    main["rmat18_fused_warm_edges_per_s"] = rmat18.num_edges / main["rmat18_fused_warm_s"]
    print(f"main path, flat: {time.perf_counter() - t_main:.2f} s, all forests equal the rank "
          f"oracle; {json.dumps(main)}")

    # 2b. ELL path
    zero_counts()
    t_ell = time.perf_counter()
    ell = {}
    for name in deck:
        counted_ell(name)
    for run in ("cold", "warm"):  # cold builds RMAT-18's ELL buckets on the host
        ell[f"rmat18_ell_{run}_s"], ell_solve = counted_ell("rmat18")
        ell["rmat18_ell_launches"] = ell_solve
    if ell_solve["levels"] != per_solve["levels"]:
        raise AssertionError(f"ELL took {ell_solve['levels']} levels, fused {per_solve['levels']}")
    ell_counts = read_counts("ELL", ("ell_row_min", "hook_compress"))
    ell["launches"] = ell_counts
    ell["rmat18_ell_warm_edges_per_s"] = rmat18.num_edges / ell["rmat18_ell_warm_s"]
    print(f"main path, ELL: {time.perf_counter() - t_ell:.2f} s, all forests equal the rank "
          f"oracle; {json.dumps(ell)}")

    # 2c. gather microbenchmark path
    zero_counts()
    t_probe = time.perf_counter()
    probe_records = gather_probe.run()
    probe_counts = read_counts("gather", ("gather",))
    print(f"main path, gather probe: {time.perf_counter() - t_probe:.2f} s; "
          f"{json.dumps({'records': probe_records, 'launches': probe_counts})}")

    # 2d. rank path
    zero_counts()
    t_rank = time.perf_counter()
    rank_solves, rank_k1_inputs = _rank_path(
        torch, kernels, rank_solver, boruvka, minimum_spanning_forest, deck, graphs, check)
    rank_counts = read_counts("rank", ("hook_compress", "first_rank", "rank_order",
                                       "rank_endpoints"))
    print(f"main path, rank: {time.perf_counter() - t_rank:.2f} s, all forests equal the rank "
          f"oracle; {json.dumps({**rank_solves, 'launches': rank_counts})}")
    # The smallest graph on the rank route, 2^17 edges: ``auto`` takes the
    # rank route, one K7 sort and one gather.
    g17 = gen.gnm_random_graph(60_000, 1 << 17, seed=17)
    if g17.num_edges < boruvka.ELL_AUTO_EDGE_THRESHOLD:
        raise AssertionError(f"the 2^17-edge graph has {g17.num_edges} edges: auto runs fused")
    k7 = kernels.rank_order.launches
    r17 = minimum_spanning_forest(g17)
    if not np.array_equal(r17.edge_ids, rank_oracle_edge_ids(g17)):
        raise AssertionError("the 2^17-edge graph: forest differs from the rank oracle")
    if kernels.rank_order.launches != k7 + 1 or "_rank_order" in g17.__dict__:
        raise AssertionError(f"the 2^17-edge graph: {kernels.rank_order.launches - k7} K7 "
                             f"launches, host order filled: {'_rank_order' in g17.__dict__}")
    print(f"main path, rank at 2^17 edges ({g17.num_edges}): one K7 launch, forest equals the "
          "rank oracle")

    # 2e. supervision, checkpoint and resume, per-level metrics
    zero_counts()
    t_sup = time.perf_counter()
    scratch = ROOT / "build" / "smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        supervision = _supervision_path(
            torch, kernels, rank_solver, minimum_spanning_forest, graphs, oracle, check,
            scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    sup_counts = read_counts("supervision", ("hook_compress",))
    print(f"main path, supervision: {time.perf_counter() - t_sup:.2f} s, all forests equal the "
          f"rank oracle; {json.dumps({**supervision, 'launches': sup_counts})}")

    # 2f. batch lanes, the engine, warmup, the scheduler and store, dynamic
    zero_counts()
    t_batch = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        batch_serve, batch_k1_inputs = _batch_serve_path(
            torch, kernels, boruvka, minimum_spanning_forest, lane_sets, lane_oracle, graphs,
            oracle, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    batch_counts = read_counts("batch and serve", ("gather_key", "hook_compress"))
    print(f"main path, batch and serve: {time.perf_counter() - t_batch:.2f} s, all forests equal "
          f"the rank oracle; {json.dumps({**batch_serve, 'launches': batch_counts})}")

    # 2g. the service: serve_loop and serve_frames, streams, certificates, kinds
    zero_counts()
    t_service = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        service, window_inputs = _service_path(
            torch, kernels, minimum_spanning_forest, graphs, oracle, lane_sets["small128"],
            lane_oracle["small128"], scratch, npz18, torch.device("cuda"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(inputs, ignore_errors=True)
    service_counts = read_counts("service", ("gather_key", "hook_compress"))
    service["phase_s"] = time.perf_counter() - t_service
    print(f"main path, service: {service['phase_s']:.2f} s, every forest, kind answer and window "
          f"head equals its oracle; {json.dumps({**service, 'launches': service_counts})}")
    # 2h. the sharded solvers, the lane, process groups, rung and checkpoint
    zero_counts()
    t_sharded = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        sharded = _sharded_path(torch, kernels, boruvka, deck, graphs, oracle, check, scratch,
                                card_description())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    sharded_counts = read_counts("sharded", ("gather_key", "hook_compress"))
    sharded["phase_s"] = time.perf_counter() - t_sharded
    print(f"main path, sharded ({card_description()}): {sharded['phase_s']:.2f} s, every "
          f"forest equals its oracle; {json.dumps({**sharded, 'launches': sharded_counts})}")
    # 2i. the protocol, the chaos drill, the tuner and the build cache
    zero_counts()
    t_tune = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        protocol_tune, tuned_inputs = _protocol_tune_path(
            torch, kernels, boruvka, minimum_spanning_forest, deck, graphs, oracle, lane_sets,
            lane_oracle, scratch, build_s)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    tune_counts = read_counts("protocol and tune", ("gather_key", "hook_compress", "ell_row_min"))
    protocol_tune["phase_s"] = time.perf_counter() - t_tune
    print(f"main path, protocol, chaos, tuner and build cache ({card_description()}): "
          f"{protocol_tune['phase_s']:.2f} s; "
          f"{json.dumps({**protocol_tune, 'launches': tune_counts})}")
    # 2j. the fleet: the router over worker processes on the card
    zero_counts()
    t_fleet = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        fleet = _fleet_path(torch, kernels, graphs, oracle, deck, lane_sets, lane_oracle, scratch,
                            service["latency_ms"], card_description())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    fleet_counts = read_counts("fleet", ("gather_key", "hook_compress"))
    fleet["phase_s"] = time.perf_counter() - t_fleet
    print(f"main path, fleet ({card_description()}): {fleet['phase_s']:.2f} s, every answer "
          f"equals the rank oracle; {json.dumps({**fleet, 'launches': fleet_counts})}")
    # 2k. the front ends: the CLI, the entry module, the native ELL buckets
    zero_counts()
    t_front = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        front = _front_end_path(torch, kernels, graphs, oracle, scratch, card_description())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    front_counts = read_counts("front ends", ("gather_key", "hook_compress", "ell_row_min"))
    front["phase_s"] = time.perf_counter() - t_front
    print(f"main path, front ends ({card_description()}): {front['phase_s']:.2f} s, every "
          f"forest equals the rank oracle; {json.dumps({**front, 'launches': front_counts})}")
    # 2l. the benchmark: every workload of the port's bench.py
    zero_counts()
    t_bench = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        bench_runs = _bench_path(kernels, scratch, card_description())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bench_counts = read_counts("bench", ("gather_key", "hook_compress"))
    bench_s = time.perf_counter() - t_bench
    print(f"main path, bench ({card_description()}): {bench_s:.2f} s, every workload "
          f"passed its checks; {json.dumps({'workloads': bench_runs, 'launches': bench_counts})}")
    # 2m. the open-loop load drill: service, streams, kinds, fleets
    zero_counts()
    t_drill = time.perf_counter()
    scratch.mkdir(parents=True)
    try:
        drill_runs = _load_drill_path(kernels, scratch, card_description())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    drill_counts = read_counts("load drill", ("gather_key", "hook_compress"))
    drill_s = time.perf_counter() - t_drill
    print(f"main path, load drill ({card_description()}): {drill_s:.2f} s, every report ok "
          f"with no accepted query lost; "
          f"{json.dumps({'runs': drill_runs, 'launches': drill_counts})}")
    # 2n. the public surface: the package exports, the native oracle, the
    # sharded solver factory
    zero_counts()
    t_surface = time.perf_counter()
    surface = _surface_path(torch, kernels, graphs, oracle, oracle_w, card_description())
    surface_counts = read_counts("surface", ("gather_key", "hook_compress"))
    surface["phase_s"] = time.perf_counter() - t_surface
    print(f"main path, surface ({card_description()}): {surface['phase_s']:.2f} s, every forest "
          f"equals the rank oracle; {json.dumps({**surface, 'launches': surface_counts})}")
    launches = {name: flat_counts[name] + ell_counts[name] + probe_counts[name]
                + rank_counts[name] + sup_counts[name] + batch_counts[name]
                + service_counts[name] + sharded_counts[name] + tune_counts[name]
                + fleet_counts[name] + front_counts[name] + bench_counts[name]
                + drill_counts[name] + surface_counts[name]
                for name in flat_counts}

    # -- 3. kernels vs plain on the card ------------------------------------
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    err = {w.__name__: 0 for w in kernels.WRAPPERS}
    n18 = rmat18.num_nodes
    for e in (1, 1000, (1 << 20) + 3, 1 << 23):
        frag = put(rng.integers(0, n18, n18).astype(np.int32))
        src, dst = (put(rng.integers(0, n18, e).astype(np.int32)) for _ in range(2))
        rank = put(rng.integers(0, 2**31 - 1, e).astype(np.int32))
        err["gather_key"] = max(err["gather_key"], _max_abs_err(
            kernels.gather_key(frag, src, dst, rank),
            kernels.gather_key_torch(frag, src, dst, rank)))
    # K1 in the form auto picks, around the block form's threshold and up to
    # 2^20; then both forms forced on the same inputs, on garbage too.
    cut = kernels.HOOK_BLOCK_FORM_THRESHOLD
    cases = [(n, kind, "auto")
             for n in (1, 2, 127, 128, 129, 5000, cut - 1, cut, cut + 1, n18, 1 << 20)
             for kind in ("random", "star")]
    cases += [(n, "chain", "auto") for n in (4096, cut - 1, cut, cut + 1, 1 << 20)]
    cases += [(n, kind, form) for n in (3, 8192, kernels.HOOK_BLOCK_MAX_NODES)
              for kind in ("random", "chain", "none", "cycle") for form in ("block", "grid")]
    cases += [(n, kind, "grid") for n in (n18, 1 << 20) for kind in ("none", "cycle")]
    cases += [(1 << 22, kind, "auto") for kind in ("random", "chain")]
    for n, kind, form in cases:
        has, d, frag = (put(a) for a in _hook_forest(rng, n, kind))
        got = kernels.hook_compress(has, d, frag, form=form)
        want = kernels.hook_compress_torch(has, d, frag)
        err["hook_compress"] = max(err["hook_compress"], _max_abs_err(got, want))
        jumps, ran = kernels.hook_compress_readout()
        if form == "auto":
            form = "block" if n <= cut else "grid"
        if ran != form or not 1 <= jumps <= kernels.num_jumps(n):
            raise AssertionError(f"K1 {kind} n={n}: ran {ran} (want {form}), {jumps} jumps")
        if kind == "none" and jumps != 1 or kind == "cycle" and n > 2 and jumps != kernels.num_jumps(n):
            raise AssertionError(f"K1 {kind} n={n}: {jumps} jumps")
    # K1 in every form and K3 at every tile on phase 2i's tuned buckets.
    tuned_err1, tuned_err3, k1_tuned, k3_tuned = _tuned_kernels_vs_plain(
        torch, kernels, cuda_time_ms, tuned_inputs)
    err["hook_compress"] = max(err["hook_compress"], tuned_err1)
    err["ell_row_min"] = max(err["ell_row_min"], tuned_err3)
    table = torch.arange(256, dtype=torch.int32, device=dev)
    for idx in (torch.full((2, 128), 3, dtype=torch.int32, device=dev),
                put(rng.integers(0, 256, (2, 128)).astype(np.int32))):
        err["probe"] = max(err["probe"], _max_abs_err(
            (kernels.probe(table, idx),), (kernels.probe_torch(table, idx),)))

    # K3 on RMAT-18's own buckets with its level-1 fragment, per bucket and
    # as one level ...
    buckets, ra18, rb18, n_pad = boruvka.prepare_ell_arrays(rmat18)
    plan18 = kernels.ell_plan(buckets)
    frag1_ell, _, _ = boruvka._ell_level(
        torch.arange(n_pad, dtype=torch.int32, device=dev),
        torch.zeros(ra18.shape[0], dtype=torch.uint8, device=dev),
        plan18, ra18, rb18, identity_fragment=True)
    for b in buckets:
        err["ell_row_min"] = max(err["ell_row_min"], _max_abs_err(
            (kernels.ell_row_min(frag1_ell, *b),), (kernels.ell_row_min_torch(frag1_ell, *b),)))

    def level_err(fragment, plan):
        fresh = lambda: torch.full_like(fragment, kernels.INT32_MAX)  # noqa: E731
        return _max_abs_err((kernels.ell_level_min(fragment, plan, fresh()),),
                            (kernels.ell_level_min_torch(fragment, plan, fresh()),))

    for tile_slots in (kernels.ELL_TILE_SLOTS, 1000):
        err["ell_row_min"] = max(err["ell_row_min"], level_err(
            frag1_ell, kernels.ell_plan(buckets, tile_slots=tile_slots)))
    # ... and on random buckets of every width class, odd widths and 1-row
    # buckets, one by one and together as one level.
    ell_cases = [(max(1, (1 << 20) // w), w) for w in (1 << k for k in range(16))]
    ell_cases += [(1, 32768), (1, 1), (3, 7), (5, 33), (7, 600), (2, 5000)]
    for fragments in (3, n18):
        level = []
        for i, (rows, width) in enumerate(ell_cases):
            arrays = _ell_bucket(rng, n18, rows, width, fragments=fragments,
                                 sorted_rows=i % 3 == 0)
            args = [put(a) for a in arrays]
            err["ell_row_min"] = max(err["ell_row_min"], _max_abs_err(
                (kernels.ell_row_min(*args),), (kernels.ell_row_min_torch(*args),)))
            level.append(args[1:])
        fragment = args[0]  # one table for the whole level
        for tile_slots in (kernels.ELL_TILE_SLOTS, 777):
            err["ell_row_min"] = max(err["ell_row_min"], level_err(
                fragment, kernels.ell_plan(level, tile_slots=tile_slots)))

    # K5 at 1 to 2^26 indices, around every tail length of its vector body,
    # and from offsets 1, 2 and 3, where idx and out are not 16-byte aligned.
    gtable = put(rng.integers(0, 1 << 30, gather_probe.TABLE_SIZE).astype(np.int32))
    k5_sizes = (1, 5, 7, 8, 9, 15, 17, 1000, (1 << 24) + 3, 1 << 26)
    for m in k5_sizes:
        gidx = put(rng.integers(0, gather_probe.TABLE_SIZE, m).astype(np.int32))
        err["gather"] = max(err["gather"], _max_abs_err(
            (kernels.gather(gtable, gidx),), (kernels.gather_torch(gtable, gidx),)))
    for offset in (1, 2, 3):
        view = gidx[offset:offset + 1001]
        err["gather"] = max(err["gather"], _max_abs_err(
            (kernels.gather(gtable, view),), (kernels.gather_torch(gtable, view),)))
    # K6 at the filter route's shape on the benchmark's graphs (2^27 ranks,
    # 2^23 vertices, RMAT's hubs), its pad ranks left out, and on RMAT-21's
    # rank endpoints from offsets 0 and 1 (no 16-byte loads at 1).
    fr_ra, fr_rb, fr_m, fr_n = _skewed_rank_endpoints(torch, dev, 23, 1 << 27, (1 << 27) - 4093)
    err["first_rank"] = _max_abs_err((kernels.first_rank(fr_ra, fr_rb, fr_m, fr_n),),
                                     (kernels.first_rank_torch(fr_ra, fr_rb, fr_m, fr_n),))
    g21 = graphs["rmat21"]
    ra21, rb21 = (put(a) for a in g21.rank_endpoints(pad_to=boruvka._bucket_size(g21.num_edges)))
    n21 = boruvka._bucket_size(g21.num_nodes)
    for offset in (0, 1):
        a21, b21, m21 = ra21[offset:], rb21[offset:], g21.num_edges - offset
        err["first_rank"] = max(err["first_rank"], _max_abs_err(
            (kernels.first_rank(a21, b21, m21, n21),),
            (kernels.first_rank_torch(a21, b21, m21, n21),)))
    del ra21, rb21, a21, b21
    # K7 against NumPy's stable argsort at sizes around its 4,096-key tile,
    # over one, two and three digit passes, equal weights and exactly 2^22
    # values; its gather against the plain version, pad ranks zero.
    k7_cases = 0
    for m in (1, 33, 4095, 4096, 4097, 1_000_003):
        for lo, span in ((1, 255), (42, 1), (-3, 11_600), (1000, 70_000), (1 << 33, 1 << 22)):
            w = rng.integers(lo, lo + span, m, dtype=np.int64)
            w[0], w[m // 2] = lo, lo + span - 1
            order = kernels.rank_order(put(w), lo, lo + span - 1)
            want = put(np.argsort(w, kind="stable").astype(np.int32))
            err["rank_order"] = max(err["rank_order"], _max_abs_err((order,), (want,)))
            args = (order, *(put(rng.integers(0, max(2, m // 3), m).astype(np.int32))
                             for _ in range(2)), m + 37)
            err["rank_endpoints"] = max(err["rank_endpoints"], _max_abs_err(
                kernels.rank_endpoints(*args), kernels.rank_endpoints_torch(*args)))
            k7_cases += 1
    # K7 over 64-bit keys at the same sizes: float64 with both zeros, both
    # infinities, subnormals, NaN of either sign and heavy ties; uniform in
    # [0, 1), the float cell's weights; int64 over 2^22 values out to
    # +-2^62. Against NumPy's stable argsort, passes as the torch form's.
    for m in (1, 33, 4095, 4096, 4097, 1_000_003):
        for kind in ("specials", "unit", "wide"):
            w = _k7_weights64(rng, kind, m)
            sort = kernels.sort_rank_order(put(w))
            want = put(np.argsort(w, kind="stable").astype(np.int32))
            err["rank_order"] = max(err["rank_order"], _max_abs_err((sort.order,), (want,)))
            plain = kernels.sort_rank_order(torch.from_numpy(w))
            if (sort.key, sort.passes) != (plain.key, plain.passes):
                raise AssertionError(f"K7 on {m} {kind} weights: key and passes "
                                     f"{(sort.key, sort.passes)}, torch form "
                                     f"{(plain.key, plain.passes)}")
            k7_cases += 1
    # At the float cell's shape: one scale-24 graph's 260,377,349 float64
    # weights in [0, 1), 8 passes (some draw below 2^-15 changes the top
    # digit), against the torch form.
    k7_gen = torch.Generator(device=dev)
    k7_gen.manual_seed(24)
    w24 = torch.rand(260_377_349, dtype=torch.float64, device=dev, generator=k7_gen)
    sort = kernels.sort_rank_order(w24)
    if (sort.key, sort.passes) != ("float64", 8):
        raise AssertionError(f"K7 at the float cell's shape: {(sort.key, sort.passes)}")
    err["rank_order"] = max(err["rank_order"], _max_abs_err(
        (sort.order,), (kernels.rank_order_torch(w24),)))
    del sort
    # At the cells' shapes: a scale-23 Graph500 graph's 129,337,845 edges
    # (weights 1..255, one pass; edge ids ascending in u, as the canonical
    # list has them) and the DIMACS USA road network's 29,166,672 (lengths
    # 1..11,600, two passes), with u and v int32, as the prep stages them.
    k7_shapes = {}
    for key, m, span, n in (("graph500-23", 129_337_845, 255, 1 << 23),
                            ("usa-road", 29_166_672, 11_600, 23_947_347)):
        w = torch.randint(1, 1 + span, (m,), dtype=torch.int64, device=dev)
        u = torch.sort(torch.randint(0, n, (m,), dtype=torch.int32, device=dev)).values
        v = torch.randint(0, n, (m,), dtype=torch.int32, device=dev)
        order = kernels.rank_order(w, 1, span)
        err["rank_order"] = max(err["rank_order"], _max_abs_err(
            (order,), (kernels.rank_order_torch(w, 1, span),)))
        m_pad = boruvka._bucket_size(m)
        err["rank_endpoints"] = max(err["rank_endpoints"], _max_abs_err(
            kernels.rank_endpoints(order, u, v, m_pad),
            kernels.rank_endpoints_torch(order, u, v, m_pad)))
        k7_shapes[key] = (w, u, v, order, span, m_pad)
    if any(err.values()):
        raise AssertionError(f"kernel and plain version disagree: {err}")
    print(f"kernels vs plain: element-exact over 4 K2 sizes, {len(cases)} K1 rounds "
          f"(forms, jumps and early exits as expected), 2 K4 blocks, {len(buckets)} RMAT-18 + "
          f"{2 * len(ell_cases)} random K3 buckets and 6 K3 levels, {len(k5_sizes)} K5 sizes "
          f"and 3 K5 views at offsets 1-3, K6 at m={fr_m} n={fr_n} and on RMAT-21 from "
          f"offsets 0-1, K7 and its gather in {k7_cases} cases (32- and 64-bit keys) and at "
          f"the three cells' shapes")

    # The K4 wrapper's host time, split into the steps of the launch path.
    idx = torch.full((2, 128), 3, dtype=torch.int32, device=dev)
    idx64 = idx.long()  # torch.take wants int64 indices
    split = _probe_host_split(torch, kernels, _build, table, idx, idx64)
    print("host us a call of K4 probe over 10^4 calls: " + json.dumps(split))

    # Inputs at the main path's shapes and data: RMAT-18's and RMAT-13's
    # level-1 inputs; the form K1 runs and the jumps it takes at every level
    # of the fused RMAT-18 solve.
    def level1(graph):
        f0, s0, d0, r0, a0, b0 = boruvka.prepare_device_arrays(graph)
        st = boruvka.BoruvkaState(
            f0, torch.zeros(a0.shape[0], dtype=torch.uint8, device=dev), 0,
            torch.ones((), dtype=torch.bool, device=dev))
        st = boruvka.boruvka_level(st, s0, d0, r0, a0, b0, identity_fragment=True)
        ran = [kernels.hook_compress_readout()]
        f1 = st.fragment
        h, _, d = fragment_moe(f1, s0, d0, r0, a0, b0)
        return st, (s0, d0, r0, a0, b0), (h, d, f1), ran

    def level3_hook(graph):
        """K1's inputs at level 3 of the host-L2 route, taken in the vertex
        space (n = n_pad) instead of the census space the route shrinks to
        first: the level over the fragments of its head's level 2."""
        fragment2, _, fa, fb, _ = rank_solver._rank_head(
            *rank_solver.prepare_rank_arrays_full(graph), compact_after=2)
        n = fragment2.numel()
        slot = torch.arange(fa.numel(), dtype=torch.int32, device=dev)
        moe = rank_solver._moe_over(fa, fb, torch.where(fa != fb, slot, kernels.INT32_MAX), n)
        has = moe < kernels.INT32_MAX
        safe = torch.where(has, moe, 0)
        wa, wb = fa[safe], fb[safe]
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        return has, torch.where(has, torch.where(wa == ids, wb, wa), ids), fragment2

    state, arrays18, (has1, d1, frag1), k1_levels = level1(rmat18)
    src, dst, rank, ra, rb = arrays18
    while state.level < boruvka._max_levels(frag1.numel()) and bool(state.progress):
        state = boruvka.boruvka_level(state, *arrays18)
        k1_levels.append(kernels.hook_compress_readout())
    _, _, hook13, _ = level1(rmat13)
    hook22 = level3_hook(grid2048)
    if _max_abs_err(kernels.hook_compress(*hook22), kernels.hook_compress_torch(*hook22)):
        raise AssertionError("K1 and its plain version disagree at the road grid's n_pad")
    # K1 on its own inputs from the rank path's traced run, at every n it
    # ran there: RMAT-18's n_pad and the census spaces of the road grid and
    # the road network, among them. Tolerance 0.
    for name, rec in rank_solves.items():
        missing = [f for f in rec["warm"]["census_f_sizes"] if (name, f) not in rank_k1_inputs]
        if missing:
            raise AssertionError(f"{name}: no K1 launch traced at census size {missing}")
    for (name, n), inputs in rank_k1_inputs.items():
        gap = _max_abs_err(kernels.hook_compress(*inputs), kernels.hook_compress_torch(*inputs))
        err["hook_compress"] = max(err["hook_compress"], gap)
        if gap:
            raise AssertionError(f"K1 and its plain version disagree on {name}'s inputs at n={n}")
    print("K1 vs plain on the rank path's own inputs, element-exact at (graph, n): "
          + ", ".join(f"{name} {n}" for name, n in rank_k1_inputs))
    # K1 on the lane batches' own inputs, every level, at the stacked n (16
    # lanes) and at one lane: the same graphs on both sides of the block
    # form's threshold. Tolerance 0.
    k1_batch = []
    for (name, count, n), levels in batch_k1_inputs.items():
        gap = max(_max_abs_err(kernels.hook_compress(*inputs),
                               kernels.hook_compress_torch(*inputs)) for inputs in levels)
        err["hook_compress"] = max(err["hook_compress"], gap)
        if gap:
            raise AssertionError(f"K1 and its plain version disagree on {name} x{count} at n={n}")
        inputs = levels[1]  # level 1: the first partition that is not the identity
        kernels.hook_compress(*inputs)
        jumps, form = kernels.hook_compress_readout()
        k1_batch.append({
            "set": name, "lanes": count, "n": n, "levels_checked": len(levels), "form": form,
            "jumps": jumps, "max_abs_err": gap,
            "ms": cuda_time_ms(lambda: kernels.hook_compress(*inputs)),
            "plain_ms": cuda_time_ms(lambda: kernels.hook_compress_torch(*inputs)),
            "bound_ms": 17 * n / HBM_BYTES_PER_S * 1e3})
    print("K1 vs plain on the lane batches' own inputs, element-exact at (set, lanes, n, form): "
          + ", ".join(f"{r['set']} x{r['lanes']} n={r['n']} {r['form']}" for r in k1_batch))
    # K2 on the 16-lane stacks' slots with their level-1 partition.
    from distributed_ghs_implementation_tpu_torch.batch.lanes import stack_lanes

    for name, gs in lane_sets.items():
        stacked = stack_lanes(gs[:16], lanes=16)
        src_b, dst_b, rank_b = (put(a) for a in stacked.arrays[:3])
        frag_b = batch_k1_inputs[(name, 16, 16 * stacked.n_pad)][1][2]
        gap = _max_abs_err(kernels.gather_key(frag_b, src_b, dst_b, rank_b),
                           kernels.gather_key_torch(frag_b, src_b, dst_b, rank_b))
        err["gather_key"] = max(err["gather_key"], gap)
        if gap:
            raise AssertionError(f"K2 and its plain version disagree on the {name} stack")
    print("K2 vs plain on the 16-lane stacks (level-1 partition), element-exact: "
          + ", ".join(lane_sets))
    # K2 and K1 on the stream window's own inputs: the first round of the
    # first cut pass (n = 2^18, e = 2^23, fragments seeded from the tree).
    wf, ws, wd, wr, wa, wb = window_inputs
    gap = _max_abs_err(kernels.gather_key(wf, ws, wd, wr), kernels.gather_key_torch(wf, ws, wd, wr))
    err["gather_key"] = max(err["gather_key"], gap)
    if gap:
        raise AssertionError("K2 and its plain version disagree on the window's cut pass")
    w_has, _, w_dst = fragment_moe(wf, ws, wd, wr, wa, wb)
    w_hook = (w_has, w_dst, wf)
    gap = _max_abs_err(kernels.hook_compress(*w_hook), kernels.hook_compress_torch(*w_hook))
    err["hook_compress"] = max(err["hook_compress"], gap)
    if gap:
        raise AssertionError("K1 and its plain version disagree on the window's cut pass")
    wn, we = wf.numel(), ws.numel()
    kernels.hook_compress(*w_hook)
    w_jumps, w_form = kernels.hook_compress_readout()
    window_k = {
        "gather_key": {
            "shape": f"n={wn} e={we}, a stream window's cut pass (seeded fragments)",
            "ms": cuda_time_ms(lambda: kernels.gather_key(wf, ws, wd, wr)),
            "plain_ms": cuda_time_ms(lambda: kernels.gather_key_torch(wf, ws, wd, wr)),
            "bound_ms": (4 * wn + 20 * we) / HBM_BYTES_PER_S * 1e3},
        "hook_compress": {
            "shape": f"n={wn}, a stream window's cut pass, round 1", "form": w_form,
            "jumps": w_jumps,
            "ms": cuda_time_ms(lambda: kernels.hook_compress(*w_hook)),
            "plain_ms": cuda_time_ms(lambda: kernels.hook_compress_torch(*w_hook)),
            "bound_ms": 17 * wn / HBM_BYTES_PER_S * 1e3},
    }
    for name, rec in window_k.items():
        print(f"time {name} ({rec['shape']}): kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms; element-exact")
    # The service's ingest, JSON against B-frames, and the stream window's
    # warm a bucket.
    from distributed_ghs_implementation_tpu_torch.stream.window import warm_window_kernels

    ingest = _ingest_times(graphs, json18)
    del json18
    t = time.perf_counter()
    shapes = warm_window_kernels(rmat18.num_nodes, rmat18.num_edges)
    warm_ms = (time.perf_counter() - t) * 1e3 / shapes
    print("time service ingest, request bytes to a Graph (s): " + json.dumps(ingest)
          + f"; warm_window_kernels at RMAT-18: {shapes} buckets, {warm_ms:.4f} ms a bucket")
    print("K1 on the fused RMAT-18 solve, (form, jumps taken of num_jumps) a level: " + ", ".join(
        f"{form} {jumps}/{kernels.num_jumps(frag1.numel())}" for jumps, form in k1_levels))
    n, e = frag1.numel(), src.numel()
    vmin_k, vmin_p = (torch.full((n_pad,), kernels.INT32_MAX, dtype=torch.int32, device=dev)
                      for _ in range(2))

    # One device kernel for one K1 call and for one K3 level, by the
    # profiler, and their device time (median of 20 calls).
    device_ms = {}
    for key, fn, want in (
        ("hook_compress n=2^18", lambda: kernels.hook_compress(has1, d1, frag1), "hook_compress"),
        ("hook_compress n=8192", lambda: kernels.hook_compress(*hook13), "hook_compress"),
        ("hook_compress n=2^22", lambda: kernels.hook_compress(*hook22), "hook_compress"),
        ("ell_row_min one level", lambda: kernels.ell_level_min(frag1_ell, plan18, vmin_k),
         "ell_level"),
    ):
        fn()
        kerns = _device_kernels(torch, fn, 20)
        if len(kerns) != 20 or any(want not in name for name, _ in kerns):
            raise AssertionError(f"{key}: 20 calls ran {[name for name, _ in kerns]}")
        device_ms[key] = statistics.median(us for _, us in kerns) / 1e3
    print("profiler: one device kernel a call; device ms (median of 20): "
          + json.dumps(device_ms))

    # The two choices this run measures: K1's form by n (block against grid,
    # in turns; RMAT-13's level-1 inputs at n = 8192), K3's tile size (one
    # RMAT-18 level, CUDA events).
    forms = {}
    for m in (1024, 4096, 8192, 16384, 20480, 24576, kernels.HOOK_BLOCK_MAX_NODES):
        hook = hook13 if m == 8192 else [put(a) for a in _hook_forest(rng, m, "random")]
        block = lambda: kernels.hook_compress(*hook, form="block")  # noqa: E731
        grid = lambda: kernels.hook_compress(*hook, form="grid")  # noqa: E731
        t = cuda_time_in_turns_ms(block, grid)
        forms[m] = (t["a_ms"], t["b_ms"], *(_device_ms(torch, fn, 10) for fn in (block, grid)))
    print("K1 forms by n, ms in turns by CUDA events (block, grid) and device ms by the "
          "profiler (block, grid; 'not measured' where the tracer dropped every session's "
          "records): " + ", ".join(
              f"{m} ({b:.4f}, {g:.4f}; {_ms_or_not(db)}, {_ms_or_not(dg)})"
              for m, (b, g, db, dg) in forms.items())
          + f"; auto takes the block form up to n = {kernels.HOOK_BLOCK_FORM_THRESHOLD}")
    print(f"profiler: least launch-to-kernel lag a session, ms, in run order ({len(PROFILER_LAGS)} "
          "sessions that kept a kernel; a negative lag is the device clock's offset from the "
          "host's): " + json.dumps(PROFILER_LAGS))
    tiles = {t: cuda_time_ms(lambda p=kernels.ell_plan(buckets, tile_slots=t):
                             kernels.ell_level_min(frag1_ell, p, vmin_k))
             for t in (1024, 2048, 4096, 8192, 16384)}
    print("K3 tiles, one RMAT-18 level ms by tile slots: " + ", ".join(
        f"{t} {ms:.4f}" for t, ms in tiles.items())
        + f"; the plan takes {kernels.ELL_TILE_SLOTS}")

    per_bucket = [
        (tuple(b[1].shape), cuda_time_ms(lambda b=b: kernels.ell_row_min(frag1_ell, *b)))
        for b in buckets]
    print("time ell_row_min per RMAT-18 bucket (rows, W), one launch each: " + ", ".join(
        f"{shape} {ms:.4f} ms" for shape, ms in per_bucket))
    ell_slots = sum(b[1].numel() for b in buckets)
    ell_rows = sum(b[0].numel() for b in buckets)
    g24 = put(rng.integers(0, gather_probe.TABLE_SIZE, 1 << 24).astype(np.int32))
    g26 = put(rng.integers(0, gather_probe.TABLE_SIZE, 1 << 26).astype(np.int32))
    # (name, replaces, kernel, plain, library call, bytes, shape); a kernel
    # with a library call is timed in turns with it. A turn lasts at least
    # about a millisecond, so that the host's wake-up after each synchronise
    # does not weigh on a call that takes ten microseconds: 100 calls a
    # turn for K4, 10 for K5. K3's bytes: the slots, verts, the fragment
    # table, and the per-vertex minima read and written.
    rows = [
        ("gather_key", f"{JAX_OPS}/pallas_kernels.py:492",
         lambda: kernels.gather_key(frag1, src, dst, rank),
         lambda: kernels.gather_key_torch(frag1, src, dst, rank),
         None, 4 * n + 20 * e, f"n={n} e={e}"),
        ("hook_compress", f"{JAX_OPS}/pallas_kernels.py:516",
         lambda: kernels.hook_compress(has1, d1, frag1),
         lambda: kernels.hook_compress_torch(has1, d1, frag1),
         None, 17 * n, f"n={n}, RMAT-18 level-1 inputs"),
        ("probe", f"{JAX_OPS}/pallas_kernels.py:210",
         lambda: kernels.probe(table, idx),
         lambda: kernels.probe_torch(table, idx),
         lambda: torch.take(table, idx64), 3 * 1024, "table=256 idx=2x128"),
        ("ell_row_min", f"{JAX_OPS}/pallas_kernels.py:465",
         lambda: kernels.ell_level_min(frag1_ell, plan18, vmin_k),
         lambda: kernels.ell_level_min_torch(frag1_ell, plan18, vmin_p),
         None, 8 * ell_slots + 4 * ell_rows + 12 * n_pad,
         f"one level in one launch: {len(buckets)} buckets, {ell_rows} rows, {ell_slots} slots, "
         f"{plan18.tiles} tiles, n={n_pad}"),
        ("gather", "tools/test_pallas_gather.py:46",
         lambda: kernels.gather(gtable, g24),
         lambda: kernels.gather_torch(gtable, g24),
         lambda: torch.index_select(gtable, 0, g24),
         8 * g24.numel() + 4 * gtable.numel(), "table=2^20 idx=2^24"),
        ("first_rank", "none: the JAX package's Graph.first_ranks, a host pass",
         lambda: kernels.first_rank(fr_ra, fr_rb, fr_m, fr_n),
         lambda: kernels.first_rank_torch(fr_ra, fr_rb, fr_m, fr_n),
         lambda: torch.full((fr_n,), kernels.INT32_MAX, dtype=torch.int32,
                            device=dev).scatter_reduce_(0, fr_idx, fr_val, "amin"),
         8 * fr_m + 4 * fr_n, f"m={fr_m} of 2^27 ranks, n={fr_n}, RMAT hubs"),
    ]
    # K7 and its gather at each cell's shape: the sort against
    # torch.sort(stable=True), which the port never calls; bytes: w read
    # and order written once (sort), order, u, v read and ra, rb written
    # once (gather: 12 bytes an edge read, 8 a padded rank written).
    k7_rows = {}
    for key, (w7, u7, v7, o7, span, m_pad7) in k7_shapes.items():
        m7 = w7.numel()
        shape = f"{key}: m={m7}, weights 1..{span}, {kernels.rank_order_passes(1, span)} pass(es)"
        k7_rows[key] = [
            ("rank_order", "none: the JAX package's Graph._rank_order, a host counting sort",
             lambda w7=w7, span=span: kernels.rank_order(w7, 1, span),
             lambda w7=w7, span=span: kernels.rank_order_torch(w7, 1, span),
             lambda w7=w7: torch.sort(w7, stable=True), 12 * m7, shape),
            ("rank_endpoints", "none: the JAX package's Graph.rank_endpoints, a host gather",
             lambda o7=o7, u7=u7, v7=v7, p=m_pad7: kernels.rank_endpoints(o7, u7, v7, p),
             lambda o7=o7, u7=u7, v7=v7, p=m_pad7: kernels.rank_endpoints_torch(o7, u7, v7, p),
             None, 12 * m7 + 8 * m_pad7, f"{shape}, int32 tables, m_pad={m_pad7}"),
        ]
    rows += k7_rows["graph500-23"]
    # The library yardstick of K6: scatter_reduce_ "amin" alone, from its
    # int64 indices made beforehand.
    fr_idx = torch.cat([fr_ra[:fr_m], fr_rb[:fr_m]]).long()
    fr_val = torch.arange(fr_m, dtype=torch.int32, device=dev).repeat(2)

    def timed_row(name, replaces, kern, plain, library, nbytes, shape):
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/csrc/{SOURCE_OF.get(name, name)}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "launches_batch_serve": batch_counts[name],
            "launches_service": service_counts[name],
            "launches_sharded": sharded_counts[name],
            "launches_protocol_tune": tune_counts[name],
            "launches_fleet": fleet_counts[name],
            "launches_front_ends": front_counts[name],
            "launches_bench": bench_counts[name],
            "launches_load_drill": drill_counts[name],
            "launches_surface": surface_counts[name],
            "max_abs_err": err[name],
            "plain_ms": cuda_time_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "shape": shape,
        }
        if library:
            iters = {"probe": 100, "first_rank": 3, "rank_order": 3}.get(name, 10)
            rec.update(_in_turns(cuda_time_in_turns_ms, kern, library, iters), turn_calls=iters)
        else:
            rec.update(ms=cuda_time_ms(kern), library_ms=None)
        print(f"time {name} ({shape}): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']}, bound {rec['bound_ms']:.4f} ms")
        return rec

    out = [timed_row(*row) for row in rows]
    for rec, row in zip(out[-2:], k7_rows["usa-road"]):
        rec["at_usa_road"] = {k: v for k, v in timed_row(*row).items() if not k.startswith(
            ("launches", "name", "route", "source", "replaces"))}
    # K7 over 64-bit keys: at the float cell's shape, and over the int64
    # key at both integer cells' shapes (the same weights as their 32-bit
    # rows, passed without their range); bytes as the 32-bit rows'.
    k7_key64 = out[-2]["key64"] = {}
    key64_rows = [("graph500-24-float", w24, "260,377,349 float64 in [0, 1), 8 passes",
                   lambda: torch.sort(w24, stable=True))]
    key64_rows += [(f"{key}-int64", w7, f"{w7.numel()} int64 weights 1..{span} by the 64-bit "
                    f"key, {1 if span < 256 else 2} pass(es)",
                    lambda w7=w7: torch.sort(w7, stable=True))
                   for key, (w7, _u, _v, _o, span, _p) in k7_shapes.items()]
    for key, w7, shape, library in key64_rows:
        k7_key64[key] = {k: v for k, v in timed_row(
            "rank_order", "none: the JAX package's Graph._rank_order, a host stable argsort",
            lambda w7=w7: kernels.rank_order(w7), lambda w7=w7: kernels.rank_order_torch(w7),
            library, 12 * w7.numel(), shape).items()
            if not k.startswith(("launches", "name", "route", "source", "replaces"))}
    del k7_shapes, k7_rows, w24, key64_rows
    k1, k3 = out[1], out[3]
    out[0]["stream_window"] = window_k["gather_key"]
    k1["stream_window"] = window_k["hook_compress"]
    k1.update(device_ms=device_ms["hook_compress n=2^18"], levels_rmat18=[
        {"form": form, "jumps": jumps} for jumps, form in k1_levels])
    kernels.hook_compress(has1, d1, frag1)
    k1["jumps"], k1["form"] = kernels.hook_compress_readout()
    kernels.hook_compress(*hook13)
    k1["at_n8192"] = {
        "shape": "n=8192, RMAT-13 level-1 inputs",
        "ms": cuda_time_ms(lambda: kernels.hook_compress(*hook13)),
        "plain_ms": cuda_time_ms(lambda: kernels.hook_compress_torch(*hook13)),
        "bound_ms": 17 * 8192 / HBM_BYTES_PER_S * 1e3,
        "device_ms": device_ms["hook_compress n=8192"],
    }
    k1["at_n8192"]["jumps"], k1["at_n8192"]["form"] = kernels.hook_compress_readout()
    n22 = hook22[2].numel()
    kernels.hook_compress(*hook22)
    k22 = k1["at_n2^22"] = {
        "shape": f"n={n22}, road grid 2048x2048 level-3 inputs in the vertex space",
        "ms": cuda_time_ms(lambda: kernels.hook_compress(*hook22)),
        "plain_ms": cuda_time_ms(lambda: kernels.hook_compress_torch(*hook22)),
        "bound_ms": 17 * n22 / HBM_BYTES_PER_S * 1e3,
        "device_ms": device_ms["hook_compress n=2^22"],
    }
    k22["jumps"], k22["form"] = kernels.hook_compress_readout()
    if k22["form"] != "grid":
        raise AssertionError(f"K1 at n={n22} ran the {k22['form']} form")
    print(f"time hook_compress ({k22['shape']}): kernel {k22['ms']:.4f} ms, device "
          f"{k22['device_ms']:.4f} ms, plain {k22['plain_ms']:.4f} ms, bound "
          f"{k22['bound_ms']:.5f} ms; grid form, {k22['jumps']} jumps")
    k1["rank_path"] = {name: rec["k1"] for name, rec in rank_solves.items()}
    k1["batch_lanes"] = k1_batch
    for rec in k1_batch:
        print(f"time hook_compress ({rec['set']} x{rec['lanes']} lanes, level-1 inputs at "
              f"n={rec['n']}): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.6f} ms; {rec['form']} form, {rec['jumps']} jumps")
    # K1 at the filter route's own n: each traced input of RMAT-20 and
    # RMAT-21, the vertex space and any census space.
    k1["filter_route"] = []
    for (name, n), inputs in rank_k1_inputs.items():
        if name in FILTER_GRAPHS:
            kernels.hook_compress(*inputs)
            rec = {"graph": name, "n": n,
                   "ms": cuda_time_ms(lambda: kernels.hook_compress(*inputs)),
                   "plain_ms": cuda_time_ms(lambda: kernels.hook_compress_torch(*inputs)),
                   "bound_ms": 17 * n / HBM_BYTES_PER_S * 1e3}
            rec["jumps"], rec["form"] = kernels.hook_compress_readout()
            k1["filter_route"].append(rec)
            print(f"time hook_compress ({name}'s first traced inputs at n={n}): kernel "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.5f} ms; {rec['form']} form, {rec['jumps']} jumps")
    print(f"time hook_compress (n=8192, RMAT-13 level-1 inputs): kernel "
          f"{k1['at_n8192']['ms']:.4f} ms, plain {k1['at_n8192']['plain_ms']:.4f} ms, "
          f"bound {k1['at_n8192']['bound_ms']:.6f} ms; {k1['at_n8192']['form']} form, "
          f"{k1['at_n8192']['jumps']} jumps; at n=2^18 {k1['form']} form, {k1['jumps']} jumps")
    k1["tuned_buckets"] = k1_tuned
    k3.update(device_ms=device_ms["ell_row_min one level"], tiles=plan18.tiles,
              tuned_tiles=k3_tuned)
    print(f"time K3 one RMAT-18 level (one launch) by CUDA events: {k3['ms']:.4f} ms, by the "
          f"profiler {k3['device_ms']:.4f} ms of device time, bound {k3['bound_ms']:.4f} ms")
    at26 = {
        "shape": "table=2^20 idx=2^26",
        "plain_ms": cuda_time_ms(lambda: kernels.gather_torch(gtable, g26)),
        "bound_ms": (8 * g26.numel() + 4 * gtable.numel()) / HBM_BYTES_PER_S * 1e3,
        **_in_turns(cuda_time_in_turns_ms, lambda: kernels.gather(gtable, g26),
                    lambda: torch.index_select(gtable, 0, g26)),
    }
    k5 = out[4]
    for rec, m in ((k5, g24.numel()), (at26, g26.numel())):
        rec["l2_sector_tb_per_s"] = m * L2_SECTOR_BYTES / rec["ms"] / 1e9
        print(f"time gather ({rec['shape']}) in turns: kernel {rec['ms']:.4f} ms "
              f"(spread {rec['ms_spread']:.4f}), index_select {rec['library_ms']:.4f} ms "
              f"(spread {rec['library_ms_spread']:.4f}), bound {rec['bound_ms']:.4f} ms, "
              f"L2 sectors {rec['l2_sector_tb_per_s']:.3f} TB/s")
    k5["at_2^26"] = at26
    del fr_idx, fr_val

    # -- 4. result ----------------------------------------------------------
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group-child"]:
        sys.exit(_group_child(sys.argv[2:]))
    sys.exit(main())
