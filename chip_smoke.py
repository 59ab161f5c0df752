#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``distributed_ghs_implementation_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing a line:

1. build: compile the CUDA kernels from ``csrc/`` (or find them cached under
   ``build/kernels/``) and the native host library from ``native/`` (under
   ``build/native/``).
2. main path, four paths, each with every kernel launch count set to 0 just
   before it and read just after:
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
   Every forest must equal the SciPy rank oracle edge for edge; every
   kernel of a path must have launched in it.
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, element-exact (all state is integer, tolerance 0), over a range of
   sizes: K1 in the form ``auto`` picks and in both forced forms, around
   the block form's threshold, up to 2^22, on chains (every jump needed),
   on nothing hooked (the first jump ends the round) and on cyclic garbage
   (no jump does); K1 on its own inputs from the rank path's traced run,
   at every n it ran there (the census spaces of the road grid and the
   road network among them); K3 per bucket and as one level over RMAT-18's
   own buckets and random bucket sets. Then the profiler shows one device kernel for one K1
   call and one for one K3 level. Then the K4 wrapper's host time over 10^4
   calls, split into the steps of the launch path, beside ``torch.take``'s;
   then the two choices this run measures for K1 and K3 (block form
   against grid form by n, in turns; K3's tile size); then kernel, plain
   version and (where one exists) the one PyTorch call for the same
   function timed with CUDA events at the main path's shapes: RMAT-18's
   level-1 inputs for K1, K2 and K3 (K3 as its one launch a level; K1 also
   at RMAT-13's level-1 inputs and, in the grid form, at the road grid's
   first card level taken in its vertex space, n = 2^22, with the form run
   and the jumps taken at every RMAT-18 level, and at every n the filter
   route's traced run gave it), 2^24 and 2^26 indices for
   K5, and K1 and K3 by the profiler's device time too. A kernel and its library call (K4 and
   ``torch.take``, K5 and ``torch.index_select``) are timed in turns, and
   K5's rate of L2 sectors (m x 32 B over its time) is printed beside it.
4. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits non-zero without the last line. The script
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_SECTOR_BYTES = 32  # what one random 4 B read costs the L2
HOST_CALLS = 10_000
# The SciPy oracle's forest weight of RMAT-20 ef 16 seed 24 on the native
# generator's stream, as the JAX package's bench.py records it.
RMAT20_ORACLE_WEIGHT = 35_737_768
FILTER_GRAPHS = ("rmat20", "rmat21")
JAX_OPS = "distributed_ghs_implementation_tpu/ops"
PORT = "distributed_ghs_implementation_tpu_torch"


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


def _device_kernels(torch, fn, calls: int) -> list:
    """``(name, us)`` of every device kernel that ``calls`` calls of ``fn``
    ran, by the profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(evt.name, evt.time_range.end - evt.time_range.start) for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA]


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


def _rank_path(torch, kernels, rank_solver, rank_route, boruvka, msf, deck, graphs,
               check) -> dict:
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
    spaces included, for the check against the plain version."""
    routes, census, trace, finishes, prefixes = [], [], [], [], []
    k1_inputs, current = {}, []
    saved = {name: getattr(rank_solver, name) for name in (
        "solve_rank_speculative", "solve_rank_filtered_speculative", "solve_rank_filtered",
        "_shrink_and_run", "_finish_to_fixpoint", "_filtered_head", "_filtered_head_l2",
        "_speculative_tail", "hook_and_compress")}
    hook = saved["hook_and_compress"]

    def spy(name):
        def call(*a, **k):
            out = saved[name](*a, **k)
            if name.startswith("solve_rank"):
                routes.append((name, out is not None))
            elif name == "_shrink_and_run":
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
                for log in (routes, census, trace, finishes, prefixes):
                    log.clear()
                if run == "traced":
                    rank_solver.hook_and_compress = traced_hook
                k1 = kernels.hook_compress.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = msf(g)
                wall = time.perf_counter() - t
                rank_solver.hook_and_compress = hook
                check(name, res.edge_ids, float(g.w[res.edge_ids].sum()))
                k1 = kernels.hook_compress.launches - k1
                if run == "traced":
                    if k1 != len(trace):
                        raise AssertionError(f"{name}: K1 x{k1} but {len(trace)} traced")
                    rec["k1"] = _k1_summary(trace)
                    continue
                route = rank_route(family, routes)
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
    from distributed_ghs_implementation_tpu_torch.profile_solve import rank_route
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
    print(f"build: kernels {t1 - t0:.2f} s ({'cached' if cached else 'compiled'}) "
          f"{lib_path.relative_to(ROOT)}; native host library {time.perf_counter() - t1:.2f} s "
          f"({'cached' if native_cached else 'compiled'}) {native_path.relative_to(ROOT)}")

    # Host-side inputs and oracles: set-up, outside the main path's window.
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
    oracle = {name: rank_oracle_edge_ids(g) for name, g in graphs.items()}
    oracle_w = {name: scipy_mst_weight(g) for name, g in graphs.items()}
    if rmat13.num_edges >= boruvka.ELL_AUTO_EDGE_THRESHOLD:
        raise AssertionError(f"RMAT-13 has {rmat13.num_edges} edges: auto would not run fused")
    if oracle_w["rmat20"] != RMAT20_ORACLE_WEIGHT:
        raise AssertionError(f"RMAT-20 seed 24: oracle weight {oracle_w['rmat20']}, recorded "
                             f"{RMAT20_ORACLE_WEIGHT}")
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
        torch, kernels, rank_solver, rank_route, boruvka, minimum_spanning_forest, deck, graphs,
        check)
    rank_counts = read_counts("rank", ("hook_compress",))
    print(f"main path, rank: {time.perf_counter() - t_rank:.2f} s, all forests equal the rank "
          f"oracle; {json.dumps({**rank_solves, 'launches': rank_counts})}")
    launches = {name: flat_counts[name] + ell_counts[name] + probe_counts[name]
                + rank_counts[name] for name in flat_counts}

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
    if any(err.values()):
        raise AssertionError(f"kernel and plain version disagree: {err}")
    print(f"kernels vs plain: element-exact over 4 K2 sizes, {len(cases)} K1 rounds "
          f"(forms, jumps and early exits as expected), 2 K4 blocks, {len(buckets)} RMAT-18 + "
          f"{2 * len(ell_cases)} random K3 buckets and 6 K3 levels, {len(k5_sizes)} K5 sizes "
          f"and 3 K5 views at offsets 1-3")

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
        """K1's inputs at the first card level of the host-L2 route, taken
        in the vertex space (n = n_pad) instead of the census space the
        route shrinks to first: the level over ``parent12``'s fragments."""
        _, ra_d, rb_d, parent12, _ = rank_solver.prepare_rank_arrays_l2(graph)
        fa, fb = parent12[ra_d], parent12[rb_d]
        n = parent12.numel()
        slot = torch.arange(fa.numel(), dtype=torch.int32, device=dev)
        moe = rank_solver._moe_over(fa, fb, torch.where(fa != fb, slot, kernels.INT32_MAX), n)
        has = moe < kernels.INT32_MAX
        safe = torch.where(has, moe, 0)
        wa, wb = fa[safe], fb[safe]
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        return has, torch.where(has, torch.where(wa == ids, wb, wa), ids), parent12

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
        forms[m] = (t["a_ms"], t["b_ms"], *(
            statistics.median(us for _, us in _device_kernels(torch, fn, 10)) / 1e3
            for fn in (block, grid)))
    print("K1 forms by n, ms in turns by CUDA events (block, grid) and device ms by the "
          "profiler (block, grid): " + ", ".join(
              f"{m} ({b:.4f}, {g:.4f}; {db:.4f}, {dg:.4f})" for m, (b, g, db, dg) in forms.items())
          + f"; auto takes the block form up to n = {kernels.HOOK_BLOCK_FORM_THRESHOLD}")
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
    ]
    out = []
    for name, replaces, kern, plain, library, nbytes, shape in rows:
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err[name],
            "plain_ms": cuda_time_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "shape": shape,
        }
        if library:
            iters = 100 if name == "probe" else 10
            rec.update(_in_turns(cuda_time_in_turns_ms, kern, library, iters), turn_calls=iters)
        else:
            rec.update(ms=cuda_time_ms(kern), library_ms=None)
        out.append(rec)
        print(f"time {name} ({shape}): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']}, bound {rec['bound_ms']:.4f} ms")
    k1, k3 = out[1], out[3]
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
    k3.update(device_ms=device_ms["ell_row_min one level"], tiles=plan18.tiles)
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

    # -- 4. result ----------------------------------------------------------
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
