"""The port's ``batch/`` against the JAX package's, on the CPU.

The same graphs, made from seeds by each package's own makers, go through
the JAX module as ``tests/test_batch.py`` and ``tests/test_warmup.py`` run
it (CPU XLA) and through the port with ``device="cpu"``. All state is
integer, so the tolerance is 0: stacked arrays, edge ids, fragments and
level counts in both lane modes, policy forms, batch API results, incident
trails and ``compile.*`` counter sequences must be equal element for
element. Where the port differs on purpose it is pinned: a kernel fault or
a failed build raises out of the engine with no fallback, the solver
cache's kernel label is ``torch`` on the CPU. Every warmup input warms or
installs as in the JAX package (``tests/test_torch_tune.py`` holds the
tuning record's install).
"""

import contextlib
import dataclasses
import json
import re
import threading

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.batch import engine as jengine
from distributed_ghs_implementation_tpu.batch import lanes as jlanes
from distributed_ghs_implementation_tpu.batch import policy as jpolicy
from distributed_ghs_implementation_tpu.batch import warmup as jwarmup
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.utils import resilience as jres
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.batch import engine as tengine
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.batch import policy as tpolicy
from distributed_ghs_implementation_tpu_torch.batch import warmup as twarmup
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.ops._build import KernelBuildError
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres
from torch_pairs import CPU, incident_trail, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "fresh")

#: A kernel launch that failed, as the wrappers raise it (``ops/kernels.py``).
LAUNCH_ERROR = "gather_key kernel launch failed: CUDA error 700 (an illegal memory access)"

SIDES = (
    ("jax", jedge, jgen, jlanes, jpolicy, jengine, jres, JBUS, {}),
    ("port", tedge, tgen, tlanes, tpolicy, tengine, tres, TBUS, {"device": CPU}),
)


@pytest.fixture
def fresh():
    """Both buses cleared and both solver caches empty: a fresh process."""
    for bus in (JBUS, TBUS):
        bus.clear()
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()
    yield
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()


def _gnm(gen, n, m, seed, **kw):
    return gen.gnm_random_graph(n, m, seed=seed, **kw)


def _deck(edge, gen):
    """Graphs of one bucket (128, 512): connected ones, a forest of two
    components, and a graph with 10 isolated vertices."""
    a = _gnm(gen, 50, 150, 21)
    b = _gnm(gen, 50, 140, 22)
    forest = edge.Graph.from_arrays(100, np.concatenate([a.u, b.u + 50]),
                                    np.concatenate([a.v, b.v + 50]), np.concatenate([a.w, b.w]))
    loose = _gnm(gen, 100, 300, 9, ensure_connected=False)
    isolated_vs = edge.Graph.from_arrays(110, loose.u, loose.v, loose.w)
    return [_gnm(gen, 100, 300, s) for s in range(3)] + [forest, isolated_vs]


def _tiny(edge, gen):
    """Graphs of bucket (1, 1): no vertex, and one vertex without edges."""
    return [edge.Graph.from_edges(0, []), edge.Graph.from_edges(1, [])]


def _mixed(edge, gen):
    """A request deck over three buckets, with a duplicate, an empty edge
    set, a single vertex and two graphs past ``SMALL``'s ceiling."""
    rng = np.random.default_rng(3)
    graphs = []
    for i in range(9):
        n = int(rng.integers(8, 60))
        m = int(rng.integers(0, max(1, min(2 * n, n * (n - 1) // 2))))
        graphs.append(_gnm(gen, n, m, 300 + i, ensure_connected=bool(i % 2)))
    graphs.append(graphs[4])
    graphs += [edge.Graph.from_edges(4, []), edge.Graph.from_edges(1, []),
               _gnm(gen, 100, 200, 7), _gnm(gen, 50, 400, 8)]
    return graphs


SMALL = dict(max_lanes=4, max_bucket_nodes=64, max_bucket_edges=256)


def _fast(res):
    return res.SupervisorConfig(retries_per_rung=1, backoff_base_s=0.0)


def _eq(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


def _eq_lanes(jout, tout):
    assert len(jout) == len(tout)
    for (je, jf, jl), (te, tf, tl) in zip(jout, tout):
        _eq(je, te)
        _eq(np.asarray(jf), tf)
        assert jl == tl


def _results(rs):
    return [(r.edge_ids.tolist(), r.num_levels, r.num_components, r.backend) for r in rs]


# ----------------------------------------------------------------------
# Lanes
# ----------------------------------------------------------------------
def test_bucket_keys_equal_jax():
    for n, m in ((0, 0), (1, 1), (9, 8), (100, 300), (129, 257), (1 << 16, 1 << 17)):
        assert tlanes.bucket_of(n, m) == jlanes.bucket_of(n, m)
    for jg, tg in zip(_deck(jedge, jgen) + _tiny(jedge, jgen), _deck(tedge, tgen) + _tiny(tedge, tgen)):
        assert tlanes.bucket_key(tg) == jlanes.bucket_key(jg)


@pytest.mark.parametrize("mode", ["fused", "vmap"])
@pytest.mark.parametrize("count,lanes", [(5, None), (3, 8), (1, 1), (1, 16)])
def test_stack_lanes_arrays_equal_jax(mode, count, lanes):
    """Filled and unfilled lanes, lanes > graphs, one lane."""
    js = jlanes.stack_lanes(_deck(jedge, jgen)[:count], lanes=lanes, mode=mode)
    ts = tlanes.stack_lanes(_deck(tedge, tgen)[:count], lanes=lanes, mode=mode)
    assert (ts.n_pad, ts.m_pad, ts.lanes, ts.mode) == (js.n_pad, js.m_pad, js.lanes, js.mode)
    assert len(ts.arrays) == len(js.arrays) == 5
    for ja, ta in zip(js.arrays, ts.arrays):
        _eq(np.asarray(ja), ta)


@pytest.mark.parametrize("mode", ["fused", "vmap"])
@pytest.mark.parametrize("deck,count,lanes", [
    ("deck", 5, None), ("deck", 3, 8), ("deck", 1, 1), ("tiny", 2, 3),
])
def test_solve_lanes_equals_jax(mode, deck, count, lanes):
    """Edge ids, fragments (local to each lane) and levels (the stack's in
    fused mode, each lane's own in vmap mode)."""
    make = {"deck": _deck, "tiny": _tiny}[deck]
    jout = jlanes.solve_lanes(make(jedge, jgen)[:count], lanes=lanes, mode=mode)
    tout = tlanes.solve_lanes(make(tedge, tgen)[:count], lanes=lanes, mode=mode, device=CPU)
    _eq_lanes(jout, tout)


def test_vmap_levels_are_each_lanes_own_and_fused_the_slowest():
    graphs = _deck(tedge, tgen)
    fused = tlanes.solve_lanes(graphs, lanes=8, mode="fused", device=CPU)
    vmap = tlanes.solve_lanes(graphs, lanes=8, mode="vmap", device=CPU)
    own = [tapi.minimum_spanning_forest(g, device=CPU).num_levels for g in graphs]
    assert [lv for _, _, lv in vmap] == own
    assert len(set(own)) > 1  # the deck's lanes do finish at different levels
    assert {lv for _, _, lv in fused} == {max(own)}
    for (fe, ff, _), (ve, vf, _) in zip(fused, vmap):
        _eq(fe, ve)
        _eq(ff, vf)


def test_solve_lanes_rejects_what_jax_rejects():
    a, b = _gnm(tgen, 60, 150, 1), _gnm(tgen, 600, 1500, 2)
    with pytest.raises(ValueError, match="mixed buckets"):
        tlanes.solve_lanes([a, b], device=CPU)
    with pytest.raises(ValueError, match="lanes"):
        tlanes.solve_lanes([a, a], lanes=1, device=CPU)
    with pytest.raises(ValueError, match="unknown lane mode"):
        tlanes.solve_lanes([a], mode="turbo", device=CPU)
    with pytest.raises(ValueError, match="int32 id space"):
        tlanes.precompile_bucket(1 << 30, 1 << 20, 16, "fused", device=CPU)
    with pytest.raises(ValueError, match="lanes"):
        tlanes.precompile_bucket(64, 256, 0, "fused", device=CPU)
    assert tlanes.solve_lanes([], device=CPU) == []


def test_execute_stacked_raises_a_failed_build_and_a_kernel_fault(monkeypatch):
    """No fallback: a library that fails to build and a kernel that fails
    to launch both raise out of ``execute_stacked``."""
    stack = tlanes.stack_lanes(_deck(tedge, tgen)[:2], lanes=4)

    def no_build(*a, **k):
        raise KernelBuildError("nvcc failed")

    monkeypatch.setattr(tlanes, "_compile_bucket", no_build)
    with pytest.raises(KernelBuildError):
        tlanes.execute_stacked(stack, device=CPU)
    assert tlanes.compiled_bucket_keys() == []
    monkeypatch.undo()

    def launch_fails(*a, **k):
        raise RuntimeError(LAUNCH_ERROR)

    tlanes.precompile_bucket(stack.n_pad, stack.m_pad, 4, device=CPU)
    monkeypatch.setattr(tb, "fragment_moe", launch_fails)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tlanes.execute_stacked(stack, device=CPU)


def test_warmup_kernel_takes_only_the_devices_label():
    plan = dict(buckets=((64, 256),), lanes=2)
    assert twarmup.run_warmup(twarmup.WarmupPlan(**plan, kernel="torch"),
                              device=CPU)["compiled"] == 1
    for bad in ("cuda", "pallas", "xla"):
        with pytest.raises(ValueError, match="does not run on"):
            twarmup.run_warmup(twarmup.WarmupPlan(**plan, kernel=bad), device=CPU)


def test_concurrent_get_solver_builds_once():
    """Racing threads on a cold bucket: one builds, the others wait and
    read its entry; exactly one ``batch.compile.miss``."""
    results = []

    def worker():
        results.append(tlanes._get_solver(32, 64, 3, "fused", device=CPU))

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 6 and all(r is results[0] for r in results)
    counters = TBUS.counters()
    assert counters["batch.compile.miss"] == 1 and counters["batch.compile.hit"] == 5
    assert tlanes.lane_compile_stats() == {"entries": 1, "keys": [(32, 64, 3, "fused", "torch")]}


# ----------------------------------------------------------------------
# Policy and the batch API
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, SMALL, dict(max_lanes=2)])
def test_policy_form_equals_jax(kw):
    jp, tp = jpolicy.BatchPolicy(**kw), tpolicy.BatchPolicy(**kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    jb, jby = jp.form(_mixed(jedge, jgen))
    tb, tby = tp.form(_mixed(tedge, tgen))
    assert [(b.key, b.indices) for b in tb] == [(b.key, b.indices) for b in jb]
    assert tby == jby
    for jg, tg in zip(_mixed(jedge, jgen), _mixed(tedge, tgen)):
        assert tp.route(tg) == jp.route(jg)


def test_policy_validation_equals_jax():
    for kw in (dict(max_lanes=0), dict(max_wait_s=-1), dict(mode="turbo"),
               dict(pipeline_depth=0), dict(pipeline_min_stack_elems=-1)):
        with pytest.raises(ValueError):
            jpolicy.BatchPolicy(**kw)
        with pytest.raises(ValueError):
            tpolicy.BatchPolicy(**kw)


@pytest.mark.parametrize("mode", ["fused", "vmap"])
def test_batch_api_equals_jax(mode):
    """Edge ids, levels, components and backend labels, in input order,
    lanes and bypasses alike."""
    policy = dict(SMALL, mode=mode)
    jr = japi.minimum_spanning_forest_batch(_mixed(jedge, jgen),
                                            policy=jpolicy.BatchPolicy(**policy))
    tr = tapi.minimum_spanning_forest_batch(_mixed(tedge, tgen),
                                            policy=tpolicy.BatchPolicy(**policy), device=CPU)
    assert _results(tr) == _results(jr)
    assert {r.backend for r in tr} == {f"batch/{mode}", "supervised/device"}
    singles = [tapi.minimum_spanning_forest(g, device=CPU) for g in _mixed(tedge, tgen)]
    for r, s in zip(tr, singles):
        _eq(r.edge_ids, s.edge_ids)
    counters = {k: v for k, v in TBUS.counters().items() if k.startswith("batch.")
                and not k.startswith("batch.compile")}
    assert counters == {k: v for k, v in JBUS.counters().items() if k.startswith("batch.")
                        and not k.startswith("batch.compile")}


def test_batch_api_on_another_backend_solves_one_by_one():
    graphs = _deck(tedge, tgen)[:2]
    tr = tapi.minimum_spanning_forest_batch(graphs, backend="host", device=CPU)
    assert _results(tr) == _results(
        [tapi.minimum_spanning_forest(g, backend="host", device=CPU) for g in graphs])
    assert TBUS.counters().get("batch.batches.formed", 0) == 0


# ----------------------------------------------------------------------
# The engine: supervision, pipelining, the queue
# ----------------------------------------------------------------------
def _engines(policy=None, **kw):
    for name, edge, gen, lanes, pol, eng, res, bus, dev in SIDES:
        yield name, edge, gen, eng.BatchEngine(
            policy=pol.BatchPolicy(**(policy or dict(max_lanes=4))),
            supervisor_config=_fast(res), **dev), res, bus


@pytest.mark.parametrize("times", [1, 10])
def test_engine_fault_trail_equals_jax(times):
    """``times=1``: one transient batch attempt, then ok on the retry;
    ``times=10``: retries exhausted, each lane alone under the ladder."""
    out = {}
    for name, edge, gen, engine, res, bus in _engines():
        graphs = [_gnm(gen, 40, 100, s) for s in range(3)]
        with res.FAULTS.inject("batch.attempt", times=times):
            results = engine.solve_many(graphs)
        out[name] = ([incident_trail(r.incidents) for r in results], _results(results),
                     {k: v for k, v in bus.counters().items() if k.startswith("batch.")
                      and not k.startswith("batch.compile")})
    assert out["port"] == out["jax"]
    trails = out["port"][0]
    if times == 1:
        assert {tuple(o for _, _, o, _, _ in t) for t in trails} == {("transient", "ok")}
    else:
        assert all([r for r, *_ in t][:2] == ["batch", "batch"] and t[-1][:3] == ("device", 1, "ok")
                   for t in trails)


@pytest.mark.parametrize("error", [RuntimeError(LAUNCH_ERROR), KernelBuildError("nvcc failed")])
def test_engine_kernel_fault_raises_with_no_retry_or_fallback(monkeypatch, error):
    """The port's deliberate difference: a CUDA error from a kernel and a
    failed build are fatal, so a batch neither retries nor degrades its
    lanes to the supervised ladder (whose host rung would hide the fault)."""
    def boom(*a, **k):
        raise error

    monkeypatch.setattr(tengine, "execute_stacked", boom)
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(max_lanes=4),
                                 supervisor_config=_fast(tres), device=CPU)
    with pytest.raises(type(error), match=re.escape(str(error))):
        engine.solve_many([_gnm(tgen, 40, 100, s) for s in range(3)])
    counters = TBUS.counters()
    assert counters.get("batch.retry", 0) == 0
    assert counters.get("batch.lane.fallback", 0) == 0
    attempts = [e[6] for e in TBUS.events() if e[1].startswith("resilience.")]
    assert [(a["rung"], a["outcome"]) for a in attempts] == [("batch", "fatal")]


def test_engine_programming_error_raises_as_in_jax(monkeypatch):
    def boom(*a, **k):
        raise ValueError("programming error")

    for name, edge, gen, engine, res, bus in _engines():
        monkeypatch.setattr(jengine if name == "jax" else tengine, "execute_stacked", boom)
        with pytest.raises(ValueError, match="programming error"):
            engine.solve_many([_gnm(gen, 40, 100, 1)])


@pytest.mark.parametrize("faults", [0, 100])
def test_pipelined_solve_many_equals_jax(faults):
    """The former thread stacks ahead; results, trails and counters are
    the synchronous path's and JAX's."""
    policy = dict(max_lanes=4, pipeline_depth=2, pipeline_min_stack_elems=0)
    out = {}
    for name, edge, gen, engine, res, bus in _engines(policy):
        graphs = [_gnm(gen, 60, 150, s) for s in range(10)]
        armed = res.FAULTS.inject("batch.attempt", times=faults) if faults else None
        with armed or contextlib.nullcontext():
            results = engine.solve_many(graphs)
        out[name] = (_results(results), [incident_trail(r.incidents) if r.incidents else None
                                         for r in results],
                     {k: v for k, v in bus.counters().items() if k.startswith("batch.")
                      and not k.startswith("batch.compile")})
    assert out["port"] == out["jax"]
    assert out["port"][2]["batch.pipeline.batches"] == 3


def test_pipelined_forming_error_propagates(monkeypatch):
    def boom(*a, **k):
        raise ValueError("stacking exploded")

    monkeypatch.setattr(tengine, "stack_lanes", boom)
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(
        max_lanes=4, pipeline_depth=2, pipeline_min_stack_elems=0), device=CPU)
    with pytest.raises(ValueError, match="stacking exploded"):
        engine.solve_many([_gnm(tgen, 60, 150, s) for s in range(8)])


def test_submit_full_bucket_forms_one_batch_as_in_jax():
    out = {}
    for name, edge, gen, engine, res, bus in _engines(dict(max_lanes=4, max_wait_s=30.0)):
        try:
            graphs = [_gnm(gen, 40, 100, s) for s in range(4)]
            results = [p.wait(timeout=60) for p in [engine.submit(g) for g in graphs]]
        finally:
            engine.close()
        c = bus.counters()
        out[name] = (_results(results), c["batch.batches.formed"], c["batch.lanes.formed"])
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (1, 4)


def test_concurrent_submit_from_threads():
    """Eight threads submit; each gets its own graph's forest, and the
    worker formed whole batches of the bucket."""
    graphs = [_gnm(tgen, 40, 100, 50 + s) for s in range(8)]
    want = [tapi.minimum_spanning_forest(g, device=CPU).edge_ids for g in graphs]
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(max_lanes=4, max_wait_s=0.05),
                                 supervisor_config=_fast(tres), device=CPU)
    got = [None] * 8
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, engine.submit(graphs[i]).wait(timeout=60))) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        engine.close()
    for r, w in zip(got, want):
        _eq(r.edge_ids, w)
        assert r.backend == "batch/fused"
    assert TBUS.counters()["batch.lanes.formed"] == 8


def test_engine_oversize_submit_solves_inline():
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(**SMALL),
                                 supervisor_config=_fast(tres), device=CPU)
    g = _gnm(tgen, 300, 900, 2)
    r = engine.submit(g).wait(timeout=60)
    assert r.backend == "supervised/device" and TBUS.counters()["batch.bypass"] == 1
    _eq(r.edge_ids, tapi.minimum_spanning_forest(g, device=CPU).edge_ids)
    engine.close()


# ----------------------------------------------------------------------
# Warmup
# ----------------------------------------------------------------------
def test_bucket_records_are_interchangeable(tmp_path):
    """A record written by either package loads in the other, byte for
    byte the same file."""
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()
    jlanes.precompile_bucket(64, 256, 4, "fused")
    jlanes.precompile_bucket(32, 64, 2, "vmap")
    tlanes.precompile_bucket(64, 256, 4, "fused", device=CPU)
    tlanes.precompile_bucket(32, 64, 2, "vmap", device=CPU)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jwarmup.save_bucket_record(jpath, [(128, 4)]) == 3
    assert twarmup.save_bucket_record(tpath, [(128, 4)]) == 3
    assert open(tpath).read() == open(jpath).read()
    want = ((32, 64, 2, "vmap"), (64, 256, 4, "fused"), (128, 4, 0, "fused"))
    assert twarmup.load_bucket_record(jpath).keys == want
    assert jwarmup.load_bucket_record(tpath).keys == want
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": twarmup.RECORD_SCHEMA,
                               "buckets": [[64, 256, 4, "fused"], [64, 256, 4, "warp"]]}))
    with pytest.raises(twarmup.WarmupRecordError, match="#1"):
        twarmup.load_bucket_record(str(bad))


@pytest.mark.parametrize("flags", [
    {},
    dict(buckets="128x512,300x1200", lanes=4),
    dict(buckets="auto", lanes=16, kernel="auto"),
    dict(mesh_buckets="70000x140000,70000x140000", stream_buckets="100x300"),
    dict(buckets="64x256", lanes=2, tuning="/tmp/t.json", kernel="torch"),
])
def test_plan_from_flags_equals_jax(flags):
    jp, tp = jwarmup.plan_from_flags(**flags), twarmup.plan_from_flags(**flags)
    if jp is None:
        assert tp is None
    else:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert twarmup.parse_bucket_list("auto") == jwarmup.parse_bucket_list("auto")
    assert twarmup.default_ladder() == jwarmup.default_ladder()


def _compile_counters(bus):
    """The ``compile.*`` counters but the port's build-cache telemetry
    (``compile.persistent.*``), which counts once a process, at the load of
    the native library: whichever test loads it first sees it."""
    return {("compile.kernel.torch" if k == "compile.kernel.xla" else k): v
            for k, v in bus.counters().items()
            if k.startswith(("compile.", "batch.compile."))
            and not k.startswith("compile.persistent.")}


def test_compile_counters_over_warmup_then_requests_equal_jax():
    """Warm two buckets, then serve traffic on them and on a cold one: the
    ``compile.*`` totals after each step equal JAX's (``xla`` read as
    ``torch``); after the warmup, the warmed buckets add no
    ``compile.miss``."""
    plan = dict(buckets=((64, 256), (32, 64)), lanes=4)
    steps = {}
    for name, edge, gen, engine, res, bus in _engines():
        warm = (jwarmup if name == "jax" else twarmup)
        kw = {} if name == "jax" else {"device": CPU}
        seq = []
        report = warm.run_warmup(warm.WarmupPlan(**plan), **kw)
        seq.append(({k: v for k, v in report.items() if k != "wall_s"}, _compile_counters(bus)))
        for graphs in ([_gnm(gen, 60, 150, s) for s in range(3)],
                       [_gnm(gen, 20, 40, s) for s in range(5)],
                       [_gnm(gen, 200, 600, 1)]):
            engine.solve_many(graphs)
            seq.append(_compile_counters(bus))
        seq.append(warm.run_warmup(warm.WarmupPlan(**plan), **kw)["cached"])
        steps[name] = seq
    steps["jax"][0][0]["kernel"] = "torch"
    assert steps["port"] == steps["jax"]
    (report, after_warmup), first, second, cold, cached = steps["port"]
    assert report["compiled"] == 2 and report["single_warmed"] == 2
    assert after_warmup["compile.warmup"] == 2 and "compile.miss" not in after_warmup
    assert "compile.miss" not in first and "compile.miss" not in second
    assert cold["compile.miss"] == 1 and cached == 2


def test_record_replay_after_restart_builds_nothing_at_request_time(tmp_path):
    graphs = [_gnm(tgen, 40, 100, s) for s in range(4)]
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(max_lanes=4), device=CPU)
    engine.solve_many(graphs)
    assert TBUS.counters()["compile.miss"] == 1
    record = str(tmp_path / "buckets.json")
    assert twarmup.save_bucket_record(record) == 1
    tlanes.clear_solver_cache()  # a restart
    TBUS.clear()
    twarmup.run_warmup(twarmup.load_bucket_record(record), device=CPU)
    results = tengine.BatchEngine(policy=tpolicy.BatchPolicy(max_lanes=4),
                                  device=CPU).solve_many(graphs)
    counters = TBUS.counters()
    assert "compile.miss" not in counters and counters["batch.compile.hit"] == 1
    for g, r in zip(graphs, results):
        _eq(r.edge_ids, tapi.minimum_spanning_forest(g, device=CPU).edge_ids)


def test_warmup_skips_and_counts_as_jax():
    """Past the admission ceiling, shape-only entries, mesh buckets without
    a lane: the reports equal JAX's."""
    big = 4 * twarmup.MAX_SINGLE_WARM_EDGES
    plans = [dict(buckets=((64, big),), lanes=4), dict(keys=((128, 4, 0, "fused"),)),
             dict(buckets=((64, 256),), mesh_buckets=((70000, 140000),)),
             dict(buckets=((64, 256),), lanes=2, warm_single=False)]
    for plan in plans:
        jr = jwarmup.run_warmup(jwarmup.WarmupPlan(**plan))
        tr = twarmup.run_warmup(twarmup.WarmupPlan(**plan), device=CPU)
        jr.update(kernel="torch", wall_s=0.0)
        tr["wall_s"] = 0.0
        assert tr == jr
    assert tlanes.compiled_bucket_keys() == jlanes.compiled_bucket_keys() == [(64, 256, 2, "fused")]
    assert twarmup.summarize_report(None) is None
    assert twarmup.summarize_report(tr) == jwarmup.summarize_report(jr)


def test_warmup_stream_buckets_warm_as_jax():
    """Stream buckets warm the window round at the same padded buckets as
    the JAX package: equal reports, ``stream_warmed`` counting them."""
    for plan in (dict(stream_buckets=((100, 300),)),
                 dict(stream_buckets=((100, 300), (5000, 200)), buckets=((64, 256),))):
        jr = jwarmup.run_warmup(jwarmup.WarmupPlan(**plan))
        tr = twarmup.run_warmup(twarmup.WarmupPlan(**plan), device=CPU)
        jr.update(kernel="torch", wall_s=0.0)
        tr["wall_s"] = 0.0
        assert tr == jr and tr["stream_warmed"] > 0


def test_warmup_inputs_that_wait_for_other_items_raise(tmp_path):
    """No warmup input waits any more (the name is kept from when some
    raised). A tuning record that is not there installs nothing, is counted
    ``tune.record.miss`` and warmup goes on, as in the JAX package; mesh
    buckets with a lane warm, as in the JAX package (report, ``compile.*``
    and ``lane.*`` counters equal; JAX's lane on its 8 CPU devices, the
    port's on 8 CPU shards), and a request in the bucket then counts no
    ``compile.miss``."""
    from distributed_ghs_implementation_tpu.parallel import lane as jlane
    from distributed_ghs_implementation_tpu_torch.parallel import lane as tlane
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    missing = {}
    for side, warm, bus, kw in (("jax", jwarmup, JBUS, {}), ("port", twarmup, TBUS, {"device": CPU})):
        bus.clear()
        report = warm.run_warmup(
            warm.WarmupPlan(buckets=((64, 256),), tuning=str(tmp_path / "t.json")), **kw)
        report.update(kernel="torch", wall_s=0.0)
        missing[side] = (report, bus.counters().get("tune.record.miss"))
    assert missing["port"] == missing["jax"]
    assert missing["port"][0]["tuned_entries"] == 0 and missing["port"][1] == 1
    assert tlanes.compiled_bucket_keys() == []
    reports = {}
    for side, warm, lane_mod, gen, bus, lane in (
        ("jax", jwarmup, jlane, jgen, JBUS, None),
        ("port", twarmup, tlane, tgen, TBUS, edge_mesh(num_shards=8, device=CPU)),
    ):
        lane_mod._reset_shape_ledger()
        bus.clear()
        lane = lane_mod.ShardedLane() if lane is None else lane_mod.ShardedLane(lane)
        kw = {} if side == "jax" else {"device": CPU}
        report = warm.run_warmup(warm.WarmupPlan(mesh_buckets=((2000, 6000), (70000, 3000))),
                                 lane=lane, **kw)
        report.update(kernel="torch", wall_s=0.0)
        warm_counts = {k: v for k, v in bus.counters().items()
                       if k.startswith(("compile.warmup", "compile.miss", "lane."))}
        ids = lane.solve(gen.gnm_random_graph(2000, 6000, seed=11))[0].tolist()
        reports[side] = (report, warm_counts, bus.counters().get("compile.miss", 0), ids)
    assert reports["port"] == reports["jax"]
    assert reports["port"][0]["mesh_warmed"] == 2 and reports["port"][2] == 0
    empty = twarmup.run_warmup(twarmup.WarmupPlan(), device=CPU)
    assert empty == {**jwarmup.run_warmup(jwarmup.WarmupPlan()), "kernel": "torch"}
