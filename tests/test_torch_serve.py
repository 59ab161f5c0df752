"""The port's ``serve/store``, ``serve/scheduler`` and ``serve/dynamic``
against the JAX package's, on the CPU.

The same graphs and the same request and update sequences go through the
JAX modules as ``tests/test_serve.py`` and ``tests/test_serve_dynamic.py``
run them and through the port with ``device="cpu"``: sources, forests,
counters, digests and maintenance modes must be equal. Where the port
differs on purpose it is pinned: its store keys carry its own backend
token, so that neither package ever serves the other's entry from a shared
disk directory, and ``sharded_lane=`` raises until the lane is ported.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.batch import engine as jengine
from distributed_ghs_implementation_tpu.batch import lanes as jlanes
from distributed_ghs_implementation_tpu.batch import policy as jpolicy
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.serve import dynamic as jdyn
from distributed_ghs_implementation_tpu.serve import scheduler as jsched
from distributed_ghs_implementation_tpu.serve import store as jstore
from distributed_ghs_implementation_tpu.utils import resilience as jres
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.batch import engine as tengine
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.batch import policy as tpolicy
from distributed_ghs_implementation_tpu_torch.batch import warmup as twarmup
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.serve import dynamic as tdyn
from distributed_ghs_implementation_tpu_torch.serve import scheduler as tsched
from distributed_ghs_implementation_tpu_torch.serve import store as tstore
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "fresh")

SMALL = dict(max_lanes=4, max_bucket_nodes=64, max_bucket_edges=256)


@pytest.fixture
def fresh():
    for bus in (JBUS, TBUS):
        bus.clear()
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()
    yield


def _gnm(gen, n, m, seed, **kw):
    return gen.gnm_random_graph(n, m, seed=seed, **kw)


def _fast(res):
    return res.SupervisorConfig(retries_per_rung=1, backoff_base_s=0.0)


def _serve_counters(bus):
    return {k: v for k, v in bus.counters().items()
            if k.startswith(("serve.", "batch.")) and not k.startswith("batch.compile")}


def _res(r):
    return (r.edge_ids.tolist(), r.num_levels, r.num_components, r.backend)


# ----------------------------------------------------------------------
# Store
# ----------------------------------------------------------------------
def test_store_keys_differ_from_jax_by_the_backend_token():
    jg, tg = _gnm(jgen, 40, 100, 5), _gnm(tgen, 40, 100, 5)
    assert tg.digest() == jg.digest()
    for backend in ("device", "host"):
        for kind in ("mst", "components"):
            jk = jstore.solve_cache_key(jg, backend=backend, kind=kind)
            tk = tstore.solve_cache_key(tg, backend=backend, kind=kind)
            assert tk != jk
            assert tk == jk.replace(f":{backend}", f":torch_{backend}", 1)
            assert tstore._disk_path("d", tk) != jstore._disk_path("d", jk)
    assert tstore.cache_key_for_digest(tg.digest()) == tstore.solve_cache_key(tg)
    with pytest.raises(ValueError, match="kind token"):
        tstore.cache_key_for_digest(tg.digest(), kind="a:b")


def test_shared_disk_directory_never_serves_the_other_packages_entry(tmp_path):
    """Both packages write the same graph's result into one directory; each
    reads back only its own. A JAX file planted under the port's name is a
    miss for the port too: it has no ``package`` field."""
    jg, tg = _gnm(jgen, 40, 120, 5), _gnm(tgen, 40, 120, 5)
    d = str(tmp_path)
    jres_ = japi.minimum_spanning_forest(jg)
    tres_ = tapi.minimum_spanning_forest(tg, device=CPU)
    jk, tk = jstore.solve_cache_key(jg), tstore.solve_cache_key(tg)
    jstore.ResultStore(disk_dir=d).put(jk, jres_)
    assert tstore.ResultStore(disk_dir=d).get(tk, graph=tg) is None
    tstore.ResultStore(disk_dir=d).put(tk, tres_)
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == sorted(
        os.path.basename(p) for p in (jstore._disk_path(d, jk), tstore._disk_path(d, tk)))
    got = tstore.ResultStore(disk_dir=d).get(tk, graph=tg)
    assert got is not None and got.edge_ids.tolist() == tres_.edge_ids.tolist()
    assert jstore.ResultStore(disk_dir=d).get(jk, graph=jg).backend == jres_.backend
    other = tmp_path / "planted"
    other.mkdir()
    shutil.copy(jstore._disk_path(d, jk), tstore._disk_path(str(other), tk))
    assert tstore.ResultStore(disk_dir=str(other)).get(tk, graph=tg) is None
    assert TBUS.counters().get("serve.store.quarantined", 0) == 0  # not ours: not corrupt


def test_store_lru_and_counters_equal_jax():
    out = {}
    for name, gen, mod, api, bus, kw in (("jax", jgen, jstore, japi, JBUS, {}),
                                         ("port", tgen, tstore, tapi, TBUS, {"device": CPU})):
        store = mod.ResultStore(capacity=2)
        graphs = [_gnm(gen, 24, 48, s) for s in range(3)]
        keys = [mod.solve_cache_key(g) for g in graphs]
        for key, g in zip(keys, graphs):
            store.put(key, api.minimum_spanning_forest(g, **kw))
        seen = [store.get(k) is not None for k in keys]
        assert store.invalidate(keys[2]) and not store.invalidate(keys[0])
        assert store.evict_chain(keys[1]) and len(store) == 0
        out[name] = (seen, _serve_counters(bus), store.stats()["capacity"])
    assert out["port"] == out["jax"]


def test_store_disk_round_trip_digest_guard_and_torn_write(tmp_path):
    g = _gnm(tgen, 40, 120, 5)
    result = tapi.minimum_spanning_forest(g, device=CPU)
    key = tstore.solve_cache_key(g)
    store = tstore.ResultStore(capacity=4, disk_dir=str(tmp_path))
    store.put(key, result)
    cold = tstore.ResultStore(capacity=4, disk_dir=str(tmp_path)).get(key, graph=g)
    assert cold is not None and cold.edge_ids.tolist() == result.edge_ids.tolist()
    assert (cold.num_levels, cold.num_components, cold.backend) == (
        result.num_levels, result.num_components, result.backend)
    other = _gnm(tgen, 40, 120, 6)
    assert tstore.ResultStore(disk_dir=str(tmp_path)).get(key, graph=other) is None
    with tres.FAULTS.inject("serve.store.save", kind="torn"):
        with pytest.raises(tres.InjectedFault):
            store._disk_put(key, result)
    assert tstore.ResultStore(disk_dir=str(tmp_path)).get(key, graph=g) is not None
    with tres.FAULTS.inject("serve.store.save", kind="torn"):
        store.put(key, result)  # write-behind: never fails the caller
    assert TBUS.counters()["serve.store.disk_write_failed"] == 1


# ----------------------------------------------------------------------
# Scheduler
# ----------------------------------------------------------------------
def _schedulers(engine_policy=None, **kw):
    for name, gen, sched, eng, pol, res, bus, dev in (
        ("jax", jgen, jsched, jengine, jpolicy, jres, JBUS, {}),
        ("port", tgen, tsched, tengine, tpolicy, tres, TBUS, {"device": CPU}),
    ):
        engine = None
        if engine_policy is not None:
            engine = eng.BatchEngine(policy=pol.BatchPolicy(**engine_policy),
                                     supervisor_config=_fast(res), **dev)
        yield name, gen, sched.SolveScheduler(batch_engine=engine,
                                              supervisor_config=_fast(res), **kw, **dev), bus


def test_single_flight_makes_one_solve_for_many_callers(monkeypatch):
    """The leader's solve blocks until every other caller has joined its
    flight, so all of them coalesce."""
    g = _gnm(tgen, 60, 180, 9)
    gate = threading.Event()
    real = tsched.minimum_spanning_forest
    calls = []

    def blocking_solve(graph, **kwargs):
        calls.append(kwargs["device"])
        assert gate.wait(timeout=30)
        return real(graph, **kwargs)

    monkeypatch.setattr(tsched, "minimum_spanning_forest", blocking_solve)
    sched = tsched.SolveScheduler(max_concurrent=2, device=CPU)
    outcomes = []
    threads = [threading.Thread(target=lambda: outcomes.append(sched.solve(g)))
               for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while TBUS.counters().get("serve.scheduler.coalesced", 0) < 7 and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(s for _, s in outcomes) == ["coalesced"] * 7 + ["solved"]
    assert len(calls) == 1 and str(calls[0]) == CPU
    assert len({tuple(r.edge_ids) for r, _ in outcomes}) == 1
    assert sched.solve(g)[1] == "cache"


@pytest.mark.parametrize("engine", [None, SMALL])
def test_solve_batch_with_duplicates_equals_jax(engine):
    out = {}
    for name, gen, sched, bus in _schedulers(engine):
        g1, g2, big = _gnm(gen, 40, 100, 1), _gnm(gen, 40, 100, 2), _gnm(gen, 100, 300, 4)
        edge = jedge if name == "jax" else tedge
        g1_again = edge.Graph.from_arrays(40, g1.v[::-1], g1.u[::-1], g1.w[::-1])
        first = sched.solve_batch([g1, g1_again, g2, g1, big])
        again = sched.solve_batch([g2, big])
        out[name] = ([(s, _res(r)) for r, s in first], [(s, _res(r)) for r, s in again],
                     _serve_counters(bus))
    assert out["port"] == out["jax"]
    assert [s for s, _ in out["port"][0]] == ["solved", "coalesced", "solved", "coalesced",
                                             "solved"]
    assert [s for s, _ in out["port"][1]] == ["cache", "cache"]


@pytest.mark.parametrize("engine", [None, SMALL])
def test_solve_routes_equal_jax(engine):
    """Small misses go to the engine when there is one, oversize ones
    bypass to the semaphore path: sources, backends and counters."""
    out = {}
    for name, gen, sched, bus in _schedulers(engine):
        small, big = _gnm(gen, 50, 150, 3), _gnm(gen, 100, 300, 4)
        try:
            seq = [sched.solve(g) for g in (small, big, small, big)]
            seq.append(sched.solve(small, backend="protocol"))  # enters the ladder at device
        finally:
            if sched.batch_engine is not None:
                sched.batch_engine.close()
        out[name] = ([(s, _res(r)) for r, s in seq], _serve_counters(bus))
    assert out["port"] == out["jax"]
    backends = [r[3] for _, r in out["port"][0]]
    assert backends[0] == ("batch/fused" if engine else "supervised/device")
    assert backends[1] == backends[4] == "supervised/device"
    assert out["port"][1].get("serve.route.bypass", 0) == (1 if engine else 0)


def test_scheduler_miss_runs_supervised_as_in_jax():
    out = {}
    for name, gen, sched, bus in _schedulers():
        res = jres if name == "jax" else tres
        with res.FAULTS.inject("resilience.attempt.device", times=1):
            result, source = sched.solve(_gnm(gen, 60, 180, 11))
        out[name] = (source, result.backend,
                     [r.outcome for r in result.incidents.records])
    assert out["port"] == out["jax"] == ("solved", "supervised/device", ["transient", "ok"])


def test_scheduler_after_warmup_builds_nothing_at_request_time():
    engine = tengine.BatchEngine(policy=tpolicy.BatchPolicy(max_lanes=4), device=CPU)
    twarmup.run_warmup(twarmup.WarmupPlan(buckets=((64, 256),), lanes=4), device=CPU)
    sched = tsched.SolveScheduler(batch_engine=engine, device=CPU)
    out = sched.solve_batch([_gnm(tgen, 50, 150, 31), _gnm(tgen, 50, 150, 32)])
    assert [s for _, s in out] == ["solved", "solved"]
    counters = TBUS.counters()
    assert "compile.miss" not in counters and counters["compile.warmup"] == 1
    assert counters["batch.compile.hit"] == 1


def test_solve_batch_lands_flights_when_publish_raises():
    sched = tsched.SolveScheduler(device=CPU)
    g1, g2 = _gnm(tgen, 40, 100, 21), _gnm(tgen, 40, 100, 22)
    calls = []

    def failing_put(key, result):
        calls.append(key)
        raise RuntimeError("store exploded")

    real_put, sched.store.put = sched.store.put, failing_put
    try:
        with pytest.raises(RuntimeError, match="store exploded"):
            sched.solve_batch([g1, g2])
    finally:
        sched.store.put = real_put
    assert len(calls) == 1 and sched._flights == {}
    assert [s for _, s in sched.solve_batch([g1, g2])] == ["solved", "solved"]


def test_sharded_lane_waits_for_its_port():
    """The lane is ported: an oversize miss routes ``sharded_lane`` in both
    packages (JAX's lane on its 8-device CPU mesh, the port's on 8 CPU
    shards) with the same forest, spans and counters, and its repeat is a
    cache hit with no second lane solve; a small graph stays off the
    lane, and a batch peels the oversize miss off to it."""
    from distributed_ghs_implementation_tpu.parallel import lane as jlane
    from distributed_ghs_implementation_tpu_torch.parallel import lane as tlane
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    out = {}
    for side, gen, sched_mod, lane_mod, engine_mod, policy_mod, bus, kw in (
        ("jax", jgen, jsched, jlane, jengine, jpolicy, JBUS, {}),
        ("port", tgen, tsched, tlane, tengine, tpolicy, TBUS, {"device": CPU}),
    ):
        lane = (lane_mod.ShardedLane() if side == "jax"
                else lane_mod.ShardedLane(edge_mesh(num_shards=8, device=CPU)))
        sched = sched_mod.SolveScheduler(sharded_lane=lane, **kw)
        big, small = _gnm(gen, 70_000, 3_000, 21), _gnm(gen, 60, 150, 3)
        first, src1 = sched.solve(big)
        again, src2 = sched.solve(big)
        tiny, src3 = sched.solve(small)
        engine = engine_mod.BatchEngine(policy=policy_mod.BatchPolicy(**SMALL), **kw)
        batch_sched = sched_mod.SolveScheduler(sharded_lane=lane, batch_engine=engine, **kw)
        batch = batch_sched.solve_batch([_gnm(gen, 40, 100, s) for s in (1, 2)]
                                        + [_gnm(gen, 70_000, 3_000, 22)])
        engine.close()
        spans = [e[6].get("route") for e in bus.events() if e[1] == "serve.solve"]
        lane_solves = sum(1 for e in bus.events() if e[1] == "lane.solve")
        out[side] = ([_res(first), _res(again), _res(tiny), [src1, src2, src3]],
                     [(_res(r), src) for r, src in batch], spans, lane_solves,
                     _serve_counters(bus))
    assert out["port"] == out["jax"]
    assert out["port"][0][0][3] == "sharded_lane" and out["port"][0][3] == ["solved", "cache",
                                                                            "solved"]
    assert out["port"][3] == 2


def test_priority_gate_yields_to_interactive_work():
    gate = tsched.PriorityGate(max_pause_s=0.2)
    with gate.interactive():
        gate.checkpoint()  # the thread's own registration does not count
    entered, done = threading.Event(), threading.Event()

    def hold():
        with gate.interactive():
            entered.set()
            done.wait(timeout=5)

    t = threading.Thread(target=hold)
    t.start()
    assert entered.wait(timeout=5)
    t0 = time.monotonic()
    gate.checkpoint()
    paused = time.monotonic() - t0
    done.set()
    t.join(timeout=5)
    assert 0.15 <= paused < 2 and TBUS.counters()["serve.gate.yields"] == 1


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    g = _gnm(tgen, 10, 20, 1)
    for call in (
        lambda: tlanes.solve_lanes([g]),
        lambda: tengine.BatchEngine(),
        lambda: tapi.minimum_spanning_forest_batch([g]),
        lambda: twarmup.run_warmup(twarmup.WarmupPlan()),
        lambda: tsched.SolveScheduler(),
        lambda: tdyn.components_via_unionfind(3, np.array([0]), np.array([1])),
        lambda: tdyn.DynamicMST(tapi.minimum_spanning_forest(g, device=CPU)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ----------------------------------------------------------------------
# Dynamic maintenance
# ----------------------------------------------------------------------
def _random_graph(edge, rng_seed, n, m, wmax=50):
    rng = np.random.default_rng(rng_seed)
    return edge.Graph.from_arrays(n, rng.integers(0, n, m), rng.integers(0, n, m),
                                  rng.integers(1, wmax + 1, m))


def _random_update(rng, dyn, n, mod, wmax=50):
    kind = str(rng.choice(["insert", "delete", "reweight"]))
    if kind in ("delete", "reweight") and dyn._u.size:
        i = int(rng.integers(0, dyn._u.size))
        a, b = int(dyn._u[i]), int(dyn._v[i])
        if kind == "delete":
            return mod.Update("delete", a, b)
        return mod.Update("reweight", a, b, int(rng.integers(1, wmax + 1)))
    a, b = (int(x) for x in rng.integers(0, n, 2))
    while a == b:
        a, b = (int(x) for x in rng.integers(0, n, 2))
    return mod.Update("insert", a, b, int(rng.integers(1, wmax + 1)))


def _state(dyn, r):
    return (r.graph.digest(), dyn.last_mode, r.edge_ids.tolist(), r.num_components,
            r.backend, dyn.num_tree_edges)


def _dyn_pair(n, m, seed, **kw):
    jd = jdyn.DynamicMST(japi.minimum_spanning_forest(_random_graph(jedge, seed, n, m)), **kw)
    td = tdyn.DynamicMST(tapi.minimum_spanning_forest(_random_graph(tedge, seed, n, m),
                                                      device=CPU), device=CPU, **kw)
    return jd, td


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_update_stream_equals_jax(seed):
    """One update at a time, incremental throughout: digest, mode, forest
    after each, and the forest equals a fresh solve."""
    jd, td = _dyn_pair(100, 300, 100 + seed, resolve_threshold=10**9)
    rng = np.random.default_rng(7 + seed)
    for step in range(24):
        upd = _random_update(rng, jd, 100, jdyn)
        jr = jd.apply([upd])
        tr = td.apply([tdyn.Update(upd.kind, upd.u, upd.v, upd.w)])
        assert _state(td, tr) == _state(jd, jr), (seed, step, upd)
        assert td.last_mode == "incremental"
    fresh = tapi.minimum_spanning_forest(tr.graph, device=CPU)
    assert fresh.edge_ids.tolist() == tr.edge_ids.tolist()


def test_dynamic_batches_and_resolve_equal_jax():
    """Mixed batches of 8, then a batch over ``resolve_threshold``, which
    re-solves supervised."""
    jd, td = _dyn_pair(120, 400, 7, resolve_threshold=10)
    rng = np.random.default_rng(7)
    for size in (8, 8, 12, 8):
        batch = [_random_update(rng, jd, 120, jdyn) for _ in range(size)]
        jr = jd.apply(batch)
        tr = td.apply([tdyn.Update(u.kind, u.u, u.v, u.w) for u in batch])
        assert _state(td, tr) == _state(jd, jr)
        assert td.last_mode == ("resolve" if size > 10 else "incremental")
    counters = {k: v for k, v in TBUS.counters().items() if k.startswith("serve.dynamic.")}
    assert counters == {k: v for k, v in JBUS.counters().items() if k.startswith("serve.dynamic.")}
    assert counters["serve.dynamic.resolve"] == 1


def test_dynamic_exchange_rules_equal_jax():
    """Inserts that join components, bridge deletes that split them, a
    tree delete with a minimum replacement, reweights both ways, a float
    weight, and the rejected updates."""
    edges = [(0, 1, 1), (1, 2, 2), (2, 3, 1), (0, 3, 10), (1, 3, 5), (4, 5, 3)]
    steps = [
        [("delete", 1, 2, None)],
        [("insert", 3, 4, 7)],
        [("delete", 3, 4, None)],
        [("reweight", 2, 3, 20)],
        [("reweight", 2, 3, 1), ("reweight", 0, 3, 11)],
        [("insert", 0, 2, 5.5)],
        [("insert", 0, 2, 1), ("delete", 0, 1, None), ("delete", 0, 1, None)],
    ]
    jd = jdyn.DynamicMST(japi.minimum_spanning_forest(jedge.Graph.from_edges(6, edges)))
    td = tdyn.DynamicMST(tapi.minimum_spanning_forest(tedge.Graph.from_edges(6, edges),
                                                      device=CPU), device=CPU)
    for step in steps:
        jr = jd.apply([jdyn.Update(*u) for u in step])
        tr = td.apply([tdyn.Update(*u) for u in step])
        assert _state(td, tr) == _state(jd, jr), step
        assert tr.total_weight == jr.total_weight
    for bad, match in ((("frobnicate", 0, 1, 2), "unknown update kind"),
                       (("insert", 0, 99, 2), "out of range"), (("insert", 1, 1, 2), "self-loop"),
                       (("insert", 0, 2, None), "requires a weight"),
                       (("insert", 0, 2, "abc"), "non-numeric"),
                       (("reweight", 0, 1, float("inf")), "non-finite")):
        with pytest.raises(ValueError, match=match):
            td.apply([tdyn.Update(*bad)])
    assert not td.dirty
    assert tdyn.Update.from_dict({"op": "insert", "u": 1, "v": 2, "w": 3}) == tdyn.Update(
        "insert", 1, 2, 3)


def test_verification_failure_resolves_as_in_jax(monkeypatch):
    jd, td = _dyn_pair(40, 100, 3, resolve_threshold=10**9)
    for d in (jd, td):
        monkeypatch.setattr(d, "_forest_ok", lambda: False)
    jr = jd.apply([jdyn.Update("insert", 0, 1, 1)])
    tr = td.apply([tdyn.Update("insert", 0, 1, 1)])
    assert _state(td, tr) == _state(jd, jr)
    assert td.last_mode == "resolve" and TBUS.counters()["serve.dynamic.verify_failed"] == 1


@pytest.mark.parametrize("n,m,seed", [(0, 0, 1), (7, 0, 1), (60, 40, 2), (300, 280, 3)])
def test_components_and_path_max_equal_jax(n, m, seed):
    g = _random_graph(tedge, seed, max(n, 1), m) if m else None
    eu = g.u if g is not None else np.zeros(0, np.int64)
    ev = g.v if g is not None else np.zeros(0, np.int64)
    want = jdyn.components_via_unionfind(n, eu, ev)
    got = tdyn.components_via_unionfind(n, eu, ev, device=CPU)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if g is not None:
        r = tapi.minimum_spanning_forest(g, device=CPU)
        tu, tv, tw = g.u[r.edge_ids], g.v[r.edge_ids], g.w[r.edge_ids]
        rng = np.random.default_rng(seed)
        for a, b in rng.integers(0, n, (20, 2)):
            assert tdyn.tree_path_max(n, tu, tv, tw, a, b) == jdyn.tree_path_max(
                n, tu, tv, tw, a, b)


def test_resolve_hooks_run_as_in_jax():
    """``pre_resolve`` runs before an injected ``solver`` answers the
    re-solve; a failing ``pre_resolve`` is counted and does not stop it."""
    out = {}
    for name, edge, dyn, api, bus, kw in (
        ("jax", jedge, jdyn, japi, JBUS, {}),
        ("port", tedge, tdyn, tapi, TBUS, {"device": CPU}),
    ):
        calls = []

        def solver(g, api=api, kw=kw, calls=calls):
            calls.append("solve")
            return api.minimum_spanning_forest(g, **kw)

        def failing(g, calls=calls):
            calls.append("pre")
            raise RuntimeError("residency lost")

        d = dyn.DynamicMST(api.minimum_spanning_forest(_random_graph(edge, 5, 40, 100), **kw),
                           resolve_threshold=0, solver=solver, pre_resolve=failing, **kw)
        r = d.apply([dyn.Update("insert", 0, 1, 1)])
        out[name] = (_state(d, r), calls, bus.counters().get("serve.dynamic.pre_resolve_failed"))
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (["pre", "solve"], 1)
