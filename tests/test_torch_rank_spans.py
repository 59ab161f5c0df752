"""The rank route's spans on the port's event bus: the prep's steps under
``solver.prep``, the solve's phases under ``solver.rank.solve`` with the
route that answered, the staging counter, the harvest and the API's
components count. They are the port's own (the JAX package emits none of
them), so these tests hold the port to what the spans promise: the order
each route takes, leaf steps that never overlap, bytes that match what was
staged, and nothing at all on a disabled bus.
"""

import time

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS

CPU = "cpu"
COUNTER = "solver.stage.h2d_bytes"
PREP_LEAVES = ("solver.prep.rank_order", "solver.prep.endpoints", "solver.prep.stage",
               "solver.prep.first_ranks", "solver.prep.level1", "solver.prep.copy_wait")

GRAPHS = {
    "rmat": lambda: tgen.rmat_graph(10, 16, seed=3),
    "rmat11": lambda: tgen.rmat_graph(11, 16, seed=3),
    "grid": lambda: tgen.road_grid_graph(40, 50, seed=2),
}


@pytest.fixture(autouse=True)
def _bus_on(monkeypatch):
    monkeypatch.setattr(BUS, "enabled", True)


def _lower_filter_width(monkeypatch):
    """Dense graphs of 2^14 ranks and more take the filter route."""
    monkeypatch.setattr(trs, "_FILTER_MIN_RANKS", 1024)


def _spans(mark):
    """``(name, start_ns, end_ns, args)`` of the spans since ``mark``."""
    return [(rec[1], rec[3], rec[3] + rec[4], rec[6] or {})
            for rec in BUS.events_since(mark) if rec[0] == "X"]


def _solve(graph):
    """``make_production_solver`` and its solve, in one sampled trace: the
    spans since the mark, and the solve's result."""
    mark = BUS.mark()
    with tracing.activated(tracing.TraceContext("f" * 32)):
        out = trs.make_production_solver(graph, device=CPU)()
    return _spans(mark), out


def _children(spans, parent):
    """The names of the spans whose ``parent`` is ``parent``'s id, in the
    order they closed."""
    pid = next(a["span"] for name, _, _, a in spans if name == parent)
    return [name for name, _, _, a in spans if a.get("parent") == pid]


def _phases(spans):
    """The solve's phases in order, a finish named by its phase."""
    return [f"finish.{a['phase']}" if name == "solver.rank.finish" else name.rsplit(".", 1)[1]
            for name, _, _, a in spans if name.startswith("solver.rank.") and
            name != "solver.rank.solve"]


def _accepted_speculation(monkeypatch):
    """The dense speculation at half the ranks, where the head's survivors
    fit and it answers."""
    speculate = trs.solve_rank_speculative

    def wider(vmin0, ra, rb, *, out_size, **kw):
        return speculate(vmin0, ra, rb, out_size=tb._bucket_size(ra.shape[0] // 2), **kw)

    monkeypatch.setattr(trs, "solve_rank_speculative", wider)


def _filter_route(census):
    def arm(monkeypatch):
        _lower_filter_width(monkeypatch)
        monkeypatch.setattr(trs, "_CENSUS_MIN_SPACE", census)
    return arm


def _filter_misprediction(monkeypatch):
    _lower_filter_width(monkeypatch)
    monkeypatch.setattr(trs, "solve_rank_filtered_speculative", lambda *a, **k: None)


#: route -> (graph, how the route is reached, the solve's phases in order).
ROUTES = {
    "host-l2": ("grid", None, None),
    "speculative": ("rmat", _accepted_speculation, ["head", "finish.staged"]),
    "staged after a misprediction": ("rmat", None, None),
    "staged": ("rmat", lambda mp: mp.setattr(trs, "_CENSUS_MIN_SPACE", 64), None),
    "filtered-speculative": ("rmat11", _filter_route(1 << 21),
                             ["head", "finish.prefix", "filter", "finish.survivors"]),
    "filtered": ("rmat11", _filter_route(64), None),
    "filtered after a misprediction": ("rmat11", _filter_misprediction, None),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_names_itself_and_orders_its_phases(monkeypatch, route):
    """``solver.rank.solve`` names the route that answered; its phases are
    its children in the trace, a head first; the filter route's finish
    splits at its filter into the prefix's and the survivors'."""
    name, arm, want = ROUTES[route]
    if arm is not None:
        arm(monkeypatch)
    graph = GRAPHS[name]()
    spans, (mst, _, _) = _solve(graph)
    solve = next(a for n, _, _, a in spans if n == "solver.rank.solve")
    assert solve["route"] == route and solve["family"] == trs._pick_family(graph)
    phases = _phases(spans)
    assert _children(spans, "solver.rank.solve") == [
        n for n, _, _, _ in spans if n.startswith("solver.rank.") and n != "solver.rank.solve"]
    if want is not None:
        assert phases == want
    assert phases[0] == "head"
    if route.startswith("filtered"):
        last_head = len(phases) - 1 - phases[::-1].index("head")
        tail = phases[last_head + 1:]
        split = tail.index("filter")
        assert set(tail[:split]) == {"finish.prefix"}
        assert set(tail[split + 1:]) <= {"finish.survivors"}
    else:
        assert set(phases[phases.index("head") + 1:]) <= {"head", "finish.staged"}
    chunks = [a["step"] for n, _, _, a in spans if n == "solver.rank.finish"]
    assert set(chunks) <= {"_finish_chunk", "_shrink_and_run", "_levels_loop"}
    ids = tb.fetch_mst_edge_ids(graph, mst)
    np.testing.assert_array_equal(ids, tb.solve_graph(GRAPHS[name](), strategy="rank",
                                                      device=CPU)[0])


#: graph -> (prep route, how it is reached). Every prep of these integer
#: graphs copies the raw edge arrays, ``w``, ``u`` and ``v``, alone.
PREPS = {
    "grid": ("l2", None),
    "rmat": ("full", None),
    "rmat11": ("filtered", _filter_route(1 << 21)),
}

LEVEL_STEPS = ("solver.prep.first_ranks", "solver.prep.level1")


@pytest.mark.parametrize("name", list(PREPS))
def test_prep_steps_run_in_order_under_solver_prep(monkeypatch, name):
    """The prep's leaf steps are ``solver.prep``'s children, in the order
    the prep runs them: the edges staged, the wait for them, the rank order
    and the endpoint gather on the device, the first ranks and level 1 (one
    prep for every route, level 2 in the solve's head); they never overlap
    and lie inside it; each carries its CPU seconds; the stage spans' bytes
    are the staged edges' and the counter's."""
    route, arm = PREPS[name]
    if arm is not None:
        arm(monkeypatch)
    graph = GRAPHS[name]()
    before = BUS.counters().get(COUNTER, 0)
    spans, _ = _solve(graph)
    assert _children(spans, "solver.prep") == [
        "solver.prep.stage", "solver.prep.stage", "solver.prep.stage", "solver.prep.copy_wait",
        "solver.prep.rank_order", "solver.prep.endpoints", "solver.prep.first_ranks",
        "solver.prep.level1", "solver.prep.copy_wait"]
    prep = next(sp for sp in spans if sp[0] == "solver.prep")
    assert {k: prep[3][k] for k in ("family", "route", "m_pad")} == {
        "family": trs._pick_family(graph), "route": route,
        "m_pad": tb._bucket_size(graph.num_edges)}
    leaves = sorted((sp for sp in spans if sp[0] in PREP_LEAVES), key=lambda sp: sp[1])
    assert all(a[2] <= b[1] for a, b in zip(leaves, leaves[1:]))  # no overlap
    assert prep[1] <= leaves[0][1] and leaves[-1][2] <= prep[2]
    assert all(sp[3]["cpu_s"] >= 0 for sp in leaves + [prep])
    order = next(sp[3] for sp in leaves if sp[0] == "solver.prep.rank_order")
    assert order["where"] == "device" and order["on"] == "device"
    stages = [sp[3] for sp in leaves if sp[0] == "solver.prep.stage"]
    assert all(a["pin_s"] == 0.0 for a in stages)  # no page locking on the CPU
    m = graph.num_edges
    uv = 4 * m  # u and v narrowed to int32
    assert [a["bytes"] for a in stages] == [8 * m, uv, uv]
    assert BUS.counters()[COUNTER] - before == 8 * m + 2 * uv
    samples = [rec[6]["value"] for rec in BUS.events() if rec[1] == COUNTER]
    assert samples[-1] == BUS.counters()[COUNTER]


@pytest.mark.parametrize("name", list(PREPS))
def test_prep_levels_run_on_the_device(monkeypatch, name):
    """Every route's first ranks and level 1 run on the device (K6 and K1
    from the staged endpoints): their spans say ``on="device"``, K6's
    wrapper runs once a fresh prep and not for a cached one, no host pass
    runs, and the graph's ``first_ranks`` stays unfilled."""
    _, arm = PREPS[name]
    if arm is not None:
        arm(monkeypatch)
    ran = []
    for mod, fn in ((tedge, "first_ranks_of"), (trs, "host_level1"), (trs.kernels, "first_rank")):
        def spy(*a, _fn=getattr(mod, fn), _name=fn, **k):
            ran.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    steps = []
    for graph in (GRAPHS[name](), GRAPHS[name]()):
        for _ in range(2):  # the second prep of a graph is its cached one
            spans, _ = _solve(graph)
            steps.append([(n, a.get("on")) for n, _, _, a in spans if n in LEVEL_STEPS])
        assert "first_ranks" not in graph.__dict__
    fresh = [(n, "device") for n in LEVEL_STEPS]
    assert steps == [fresh, [], fresh, []]
    assert ran == ["first_rank", "first_rank"]


def test_a_cached_prep_says_so_and_runs_no_step():
    """A prep from the graph's staged arrays is a ``solver.prep`` span with
    no child."""
    graph = GRAPHS["rmat"]()
    _solve(graph)
    spans, _ = _solve(graph)
    assert [n for n, _, _, _ in spans if n == "solver.prep"] == ["solver.prep"]
    assert not [n for n, _, _, _ in spans if n.startswith("solver.prep.")]


def test_bus_timestamps_read_on_the_host_clock():
    before = time.perf_counter()
    mark = BUS.mark()
    with BUS.span("probe"):
        pass
    after = time.perf_counter()
    (_, start, end, _), = _spans(mark)
    assert before <= BUS.perf_counter_s(start) <= BUS.perf_counter_s(end) <= after


def test_harvest_and_components_spans_count_what_they_return():
    graph = GRAPHS["grid"]()
    mark = BUS.mark()
    result = tapi.minimum_spanning_forest(graph, device=CPU)
    spans = {n: a for n, _, _, a in _spans(mark)}
    assert spans["solver.harvest"]["forest_edges"] == result.edge_ids.size
    assert spans["api.components"]["components"] == result.num_components
    fragment = np.array([4, 4, 1, 7, 1, 9], dtype=np.int32)
    assert tapi.count_components(fragment) == np.unique(fragment).size == 4


def test_a_disabled_bus_records_nothing_and_reads_no_cpu_clock(monkeypatch):
    monkeypatch.setattr(BUS, "enabled", False)

    def no_cpu_clock():
        raise AssertionError("process_time() read with the bus off")

    monkeypatch.setattr(time, "process_time", no_cpu_clock)
    counters = BUS.counters()
    mark = BUS.mark()
    graph = GRAPHS["rmat"]()
    mst, fragment, levels = trs.make_production_solver(graph, device=CPU)()
    tapi.count_components(tb.harvest(graph, mst, fragment, levels)[1])
    assert BUS.events_since(mark) == [] and BUS.counters() == counters


def test_the_profiler_reads_the_rank_order_off_the_bus(monkeypatch):
    """``profile_solve`` takes its rank phases from these spans, with the
    bus on for its call only, and wraps nothing of the solver's."""
    from distributed_ghs_implementation_tpu_torch import profile_solve

    monkeypatch.setattr(BUS, "enabled", False)
    own = dict(vars(trs))
    phases = profile_solve._phases(GRAPHS["grid"](), "rank", torch.device(CPU))
    assert 0 < phases["rank_order_s"] <= phases["stage_s"]
    assert phases["route"] == "host-l2" and not BUS.enabled
    assert vars(trs) == own
