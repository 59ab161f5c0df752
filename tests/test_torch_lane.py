"""The port's ``ShardedLane`` (``parallel/lane.py``) against the JAX
package's, on the CPU.

The JAX lane runs on its 8 virtual CPU devices, the port's on 8 CPU shards.
Every sequence of solves and updates runs through both, and the forests,
fragments, levels, resident digests, pins and the ``lane.*`` and
``compile.*`` counters must be equal. Where the port differs on purpose it
is pinned: an update writes the resident shards in place (JAX donates them
to a scatter), and while a solve holds an entry the write goes to fresh
copies, leaving the solve's tensors as they were.
"""

import threading

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.batch import lanes as jlanes
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.parallel import lane as jlane
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.parallel import lane as tlane
from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "fresh")

SIDES = {
    "jax": (jlane, jgen, jedge, JBUS),
    "port": (tlane, tgen, tedge, TBUS),
}


@pytest.fixture
def fresh():
    """Both lanes' shape ledgers, both buses and both packages' batch
    solver caches reset: a fresh process. The services below stack small
    graphs through ``batch/lanes.py``, whose module-level cache another test
    file may have warmed in one package only."""
    for mod, _, _, bus in SIDES.values():
        mod._reset_shape_ledger()
        bus.clear()
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()
    yield


def _lane(side, **kw):
    mod = SIDES[side][0]
    if side == "jax":
        return mod.ShardedLane(**kw)
    return mod.ShardedLane(edge_mesh(num_shards=8, device=CPU), **kw)


def _edges(g):
    return [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]


def _counters(bus):
    return {k: v for k, v in bus.counters().items()
            if k.startswith(("lane.", "compile.warmup", "compile.miss", "compile.hit"))}


def _out(result):
    ids, frag, lv = result
    return (np.asarray(ids).tolist(), np.asarray(frag).tolist(), int(lv))


def _both(script):
    """Run ``script(side, lane_module, generators, edgelist)`` in both
    packages; return ``{"jax": ..., "port": ...}`` of ``(its result, the
    lane counters)``."""
    out = {}
    for side, (mod, gen, edge, bus) in SIDES.items():
        out[side] = (script(side, mod, gen, edge), _counters(bus))
    return out


def _equal(out):
    assert out["port"] == out["jax"]
    return out["port"]


# ----------------------------------------------------------------------
# Solves
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(300, 900, 0), (300, 900, 1), (70_000, 3_000, 5),
                                   (2_000, 6_000, 11)])
def test_lane_solve_matches_jax(shape):
    n, m, seed = shape

    def script(side, mod, gen, edge):
        g = gen.gnm_random_graph(n, m, seed=seed)
        return _out(_lane(side).solve(g))

    (got, counters) = _equal(_both(script))
    g = tgen.gnm_random_graph(n, m, seed=seed)
    assert got[0] == tapi.minimum_spanning_forest(g, device=CPU).edge_ids.tolist()
    assert counters["lane.resident.miss"] == 1 and counters["compile.miss"] >= 1


def test_disconnected_and_trivial_match_jax():
    def script(side, mod, gen, edge):
        lane = _lane(side)
        g = edge.Graph.from_edges(9, [(0, 1, 1), (1, 2, 2), (3, 4, 1), (4, 5, 5)])
        return [_out(lane.solve(g)), _out(lane.solve(edge.Graph.from_edges(3, [])))]

    (got, _), = [_equal(_both(script))]
    assert len(got[0][0]) == 4 and len(set(got[0][1])) == 5 and got[1] == ([], [0, 1, 2], 0)


def test_solve_result_and_admits_match_jax():
    def script(side, mod, gen, edge):
        lane = _lane(side)
        g = gen.gnm_random_graph(400, 1_600, seed=3)
        r = lane.solve_result(g)
        return (r.backend, r.edge_ids.tolist(), r.num_levels, r.num_components,
                lane.pad_shape(70_000, 3_000), lane.admits(g), lane.n_dev)

    got, _ = _equal(_both(script))
    assert got[0] == "sharded_lane" and got[-1] == 8


def test_kernel_and_arguments_are_checked():
    lane = tlane.ShardedLane(edge_mesh(num_shards=2, device=CPU), kernel="torch")
    assert lane.kernel == "torch"
    with pytest.raises(ValueError, match="does not run on this mesh"):
        tlane.ShardedLane(edge_mesh(device=CPU), kernel="cuda")
    for bad in ({"capacity": 0}, {"max_update_frac": 1.5}, {"max_in_flight": 0}):
        with pytest.raises(ValueError):
            tlane.ShardedLane(edge_mesh(device=CPU), **bad)
        with pytest.raises(ValueError):
            jlane.ShardedLane(**bad)


# ----------------------------------------------------------------------
# Residency
# ----------------------------------------------------------------------
def test_warm_resolve_moves_nothing_from_the_host():
    def script(side, mod, gen, edge):
        lane = _lane(side)
        g = gen.gnm_random_graph(400, 1_600, seed=3)
        bus = SIDES[side][3]
        first = _out(lane.solve(g))
        stages = sum(1 for e in bus.events() if e[1] == "lane.stage")
        second = _out(lane.solve(g))
        return first, second, stages, sum(1 for e in bus.events() if e[1] == "lane.stage")

    (first, second, stages, stages_after), counters = _equal(_both(script))
    assert first == second and stages == stages_after == 1
    assert (counters["lane.resident.hit"], counters["lane.reshard.skipped"]) == (1, 1)


def test_residency_lru_pins_and_eviction_match_jax():
    def script(side, mod, gen, edge):
        lane = _lane(side, capacity=2)
        graphs = [gen.gnm_random_graph(200, 600, seed=s) for s in range(4)]
        lane.pin(graphs[0].digest())
        trail = []
        for g in graphs[:3]:
            lane.solve(g)
            trail.append(lane.resident_digests())
        lane.pin(graphs[1].digest())
        lane.solve(graphs[3])  # every entry pinned: over capacity
        trail.append(lane.resident_digests())
        lane.unpin(graphs[0].digest())
        lane.move_pins(graphs[1].digest(), "elsewhere")
        lane.solve(graphs[2])
        trail.append(lane.resident_digests())
        trail.append((lane.pin_count("elsewhere"), lane.evict(graphs[3].digest()),
                      lane.evict("nope"), lane.resident_digests()))
        trail.append((lane.ensure_resident(graphs[3], pin=True),
                      lane.ensure_resident(edge.Graph.from_edges(3, [])),
                      lane.resident_digests()))
        # Every entry pinned: the LRU runs over capacity rather than evict.
        tight = _lane(side, capacity=1)
        for g in graphs[:2]:
            tight.pin(g.digest())
            tight.solve(g)
        trail.append(tight.resident_digests())
        return trail

    trail, counters = _equal(_both(script))
    assert len(trail[-1]) == 2 and counters["lane.resident.pin_overflow"] == 1
    assert counters["lane.resident.evict"] >= 2 and counters["lane.resident.restored"] == 1


# ----------------------------------------------------------------------
# Updates: in place in the port, donated in JAX
# ----------------------------------------------------------------------
def _updated(edge, g, change):
    edges = _edges(g)
    change(edges)
    return edge.Graph.from_edges(g.num_nodes, edges)


def _reweight(edges):
    edges[10][2] += 1


def _heavy_insert(edges):
    edges.append([0, 399, 10_000])


@pytest.mark.parametrize("change", ["reweight", "heavy_insert", "reverse", "grow", "none"])
def test_updates_match_jax(change):
    def script(side, mod, gen, edge):
        lane = _lane(side)
        g = gen.gnm_random_graph(400, 1_600, seed=7)
        lane.solve(g)
        if change == "reweight":
            g2 = _updated(edge, g, _reweight)
        elif change == "heavy_insert":
            g2 = _updated(edge, g, _heavy_insert)
        elif change == "reverse":  # every rank slot moves: past max_update_frac
            top = int(g.w.max()) + 1
            g2 = edge.Graph.from_edges(g.num_nodes, [[u, v, top - w] for u, v, w in _edges(g)])
        elif change == "grow":  # a new edge bucket: the residency drops
            g2 = edge.Graph.from_edges(
                g.num_nodes, _edges(g) + [[i, i + 50, 1000 + i] for i in range(300)])
        else:
            g2 = g
        out = _out(lane.update(g.digest(), g2))
        return out, lane.resident_digests(), g2.digest()

    (out, resident, digest), counters = _equal(_both(script))
    assert resident == [digest]
    expect = {"reweight": "lane.update.donated", "heavy_insert": "lane.update.donated",
              "reverse": "lane.restage", "grow": "lane.update.dropped",
              "none": "lane.update.donated"}[change]
    assert counters.get(expect) == 1


def test_an_update_writes_the_resident_shards_in_place():
    """The port's in-place write: the resident tensors are the same objects
    after a small update, and hold the new graph's rank endpoints."""
    lane = tlane.ShardedLane(edge_mesh(num_shards=4, device=CPU))
    g = tgen.gnm_random_graph(400, 1_600, seed=7)
    lane.solve(g)
    before = lane._get_resident(g.digest())
    g2 = _updated(tedge, g, _reweight)
    assert lane.refresh_resident(g.digest(), g2)
    after = lane._get_resident(g2.digest())
    assert all(a is b for a, b in zip(after.ra, before.ra))
    ra, rb = g2.rank_endpoints(pad_to=after.m_pad)
    np.testing.assert_array_equal(torch.cat(after.ra).numpy(), ra)
    np.testing.assert_array_equal(torch.cat(after.rb).numpy(), rb)


def test_refresh_while_a_solve_holds_the_entry_keeps_its_tensors():
    """A refresh racing an in-flight solve must not write the tensors that
    solve still holds: the write goes to fresh copies, the reader's stay as
    they were, and both packages land on the same answers."""
    def script(side, mod, gen, edge):
        lane = _lane(side)
        g = gen.gnm_random_graph(300, 900, seed=13)
        lane.solve(g)
        digest = g.digest()
        res = lane._get_resident(digest, checkout=True)  # a simulated reader
        held = [np.asarray(a).copy() for a in (res.ra if side == "port" else [res.ra])]
        try:
            g2 = _updated(edge, g, lambda e: e[5].__setitem__(2, e[5][2] + 1))
            assert lane.refresh_resident(digest, g2)
            now = [np.asarray(a) for a in (res.ra if side == "port" else [res.ra])]
            unchanged = all(np.array_equal(a, b) for a, b in zip(held, now))
            out = _out(lane.solve(g2))
        finally:
            lane._release(digest)
        return unchanged, out, lane._in_use

    (unchanged, out, in_use), _ = _equal(_both(script))
    assert unchanged and in_use == {}


def test_concurrent_distinct_solves_are_admission_bounded():
    lane = tlane.ShardedLane(edge_mesh(num_shards=4, device=CPU), max_in_flight=2)
    graphs = [tgen.gnm_random_graph(250, 800, seed=40 + s) for s in range(4)]
    results = [None] * len(graphs)

    def solve_one(i):
        results[i] = lane.solve(graphs[i])[0]

    threads = [threading.Thread(target=solve_one, args=(i,)) for i in range(len(graphs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for jg_seed, ids in zip(range(4), results):
        jg = jgen.gnm_random_graph(250, 800, seed=40 + jg_seed)
        assert ids.tolist() == japi.minimum_spanning_forest(jg).edge_ids.tolist()
    assert not lane._in_use


def test_yield_fn_runs_between_dispatches():
    calls = []

    def script(side, mod, gen, edge):
        calls.clear()
        lane = _lane(side)
        lane.solve(gen.gnm_random_graph(2_000, 6_000, seed=2), yield_fn=lambda: calls.append(1))
        return len(calls)

    got, _ = _equal(_both(script))
    assert got >= 2


# ----------------------------------------------------------------------
# Warmup
# ----------------------------------------------------------------------
def test_precompile_covers_request_shapes_as_in_jax():
    def script(side, mod, gen, edge):
        lane = _lane(side)
        report = lane.precompile(2_000, 6_000)
        report = {**report, "kernel": "torch", "bucket": list(report["bucket"])}
        bus = SIDES[side][3]
        miss0 = bus.counters().get("compile.miss", 0)
        out = _out(lane.solve(gen.gnm_random_graph(2_000, 6_000, seed=11)))
        g = gen.gnm_random_graph(2_000, 6_000, seed=11)
        small = _updated(edge, g, lambda e: e.append([0, 1999, 10 ** 6]))
        lane.update(g.digest(), small)
        return report, miss0, bus.counters().get("compile.miss", 0), out

    (report, miss0, miss1, _), counters = _equal(_both(script))
    assert miss0 == miss1 == 0 and counters["compile.warmup"] >= 2
    assert lane_resident_free(report)


def lane_resident_free(report):
    """precompile leaves the LRU alone: its report names the bucket only."""
    return set(report) == {"bucket", "devices", "kernel"}


# ----------------------------------------------------------------------
# Scheduler and service routing
# ----------------------------------------------------------------------
def test_scheduler_routes_oversize_to_the_lane_and_caches():
    from distributed_ghs_implementation_tpu.serve import scheduler as jsched
    from distributed_ghs_implementation_tpu_torch.serve import scheduler as tsched

    def script(side, mod, gen, edge):
        lane = _lane(side)
        sched = (jsched.SolveScheduler(sharded_lane=lane) if side == "jax"
                 else tsched.SolveScheduler(sharded_lane=lane, device=CPU))
        g = gen.gnm_random_graph(70_000, 3_000, seed=21)
        r1, s1 = sched.solve(g)
        r2, s2 = sched.solve(g)
        bus = SIDES[side][3]
        routes = [e[6].get("route") for e in bus.events() if e[1] == "serve.solve"]
        return (r1.backend, s1, s2, r1.edge_ids.tolist(), r2.edge_ids.tolist(), routes,
                bus.counters().get("serve.route.sharded_lane"),
                sum(1 for e in bus.events() if e[1] == "lane.solve"))

    got, _ = _equal(_both(script))
    assert got[:3] == ("sharded_lane", "solved", "cache") and got[5] == ["sharded_lane"]
    assert got[6] == 1 and got[7] == 1


def test_service_update_moves_the_residency_and_disk_round_trip(tmp_path):
    from distributed_ghs_implementation_tpu.serve import service as jsvc
    from distributed_ghs_implementation_tpu_torch.serve import service as tsvc

    def script(side, mod, gen, edge):
        svc_mod, kw = (jsvc, {"sharded_lane": True}) if side == "jax" else (
            tsvc, {"sharded_lane": 8, "device": CPU})
        disk = str(tmp_path / side)
        g = gen.gnm_random_graph(70_000, 3_000, seed=23)
        svc = svc_mod.MSTService(disk_dir=disk, **kw)
        r1 = svc.handle({"op": "solve", "num_nodes": g.num_nodes, "edges": _edges(g)})
        resident = svc.sharded_lane.resident_digests()
        up = svc.handle({"op": "update", "digest": r1["digest"],
                         "updates": [{"kind": "insert", "u": 0, "v": 1, "w": 10_000}]})
        moved = svc.sharded_lane.resident_digests()
        svc2 = svc_mod.MSTService(disk_dir=disk, **kw)
        bus = SIDES[side][3]
        spans = sum(1 for e in bus.events() if e[1] == "lane.solve")
        r2 = svc2.handle({"op": "solve", "num_nodes": g.num_nodes, "edges": _edges(g)})
        return ((r1["backend"], r1["total_weight"], r1["digest"]), resident == [r1["digest"]],
                moved == [up["digest"]], r2["cached"], r2["total_weight"],
                sum(1 for e in bus.events() if e[1] == "lane.solve") - spans)

    got, _ = _equal(_both(script))
    assert got[0][0] == "sharded_lane" and got[1] and got[2] and got[3] is True and got[5] == 0


def test_solve_batch_peels_oversize_to_the_lane():
    from distributed_ghs_implementation_tpu.serve import service as jsvc
    from distributed_ghs_implementation_tpu_torch.serve import service as tsvc

    def script(side, mod, gen, edge):
        svc = (jsvc.MSTService(batch_lanes=4, sharded_lane=True) if side == "jax"
               else tsvc.MSTService(batch_lanes=4, sharded_lane=8, device=CPU))
        small = [gen.gnm_random_graph(128, 400, seed=s) for s in range(3)]
        big = gen.gnm_random_graph(70_000, 3_000, seed=25)
        results = svc.scheduler.solve_batch(small + [big])
        return [(r.backend, r.edge_ids.tolist(), src) for r, src in results]

    got, _ = _equal(_both(script))
    assert [b for b, _, _ in got] == ["batch/fused"] * 3 + ["sharded_lane"]
