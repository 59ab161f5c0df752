"""The host-L2 route on connected road networks from the benchmark's own
generator (``ghs_bench/roads.py``): the route the ``usa-road-fresh`` cell
measures. A road network (average degree 2.44) takes the ``l2`` prep and
answers on ``host-l2`` with the plain reference's forest, id for id; the
finish's shrink chain ends in one ``solver.rank.replay`` span that names
the shrinks it replays, and a solve that never shrank has none; the
``solver.rank.host_reads`` counter grows by one a host read of the
solve's small device tensors (``rank_solver._ints``), its total sampled on
the bus's timeline.
"""

import numpy as np
import pytest

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from ghs_bench import reference, roads

CPU = "cpu"
READS = "solver.rank.host_reads"
#: The DIMACS USA graph's undirected edges a vertex.
EDGES_PER_VERTEX = 29166672 / 23947347
SEEDS = (7, 2**31 + 11, 2**40 + 5)
LATTICE = (200, 310)  # about 40k vertices: the finish shrinks its space once


def _deeper_chain(monkeypatch):
    """Short chunks and a low shrink floor: the 40k-vertex finish shrinks
    twice, as the cell's 24M-vertex one does."""
    monkeypatch.setattr(trs, "_ONE_SHOT_MAX_SLOTS", 1024)
    monkeypatch.setattr(trs, "_SHRINK_MIN_SPACE", 2048)


#: case -> (lattice, how it is reached, the fewest shrinks its solve makes).
SHRINKS = {
    "once": (LATTICE, None, 1),
    "twice": (LATTICE, _deeper_chain, 2),
    "never": ((20, 30), None, 0),
}


@pytest.fixture(autouse=True)
def _bus_on(monkeypatch):
    monkeypatch.setattr(BUS, "enabled", True)


def _road(lattice, seed):
    n, u, v, w = roads.road_network(*lattice, occupancy=0.65,
                                    edges_per_vertex=EDGES_PER_VERTEX, seed=seed)
    return Graph(n, u.numpy(), v.numpy(), w.numpy())


def _solve(graph):
    """``make_production_solver``, its solve and the harvest in one sampled
    trace: ``(spans since the mark, edge ids, reads counted)``, each span
    ``(name, args)`` in the order it closed."""
    before = BUS.counters().get(READS, 0)
    mark = BUS.mark()
    with tracing.activated(tracing.TraceContext("e" * 32)):
        ids, _, _ = tb.harvest(graph, *trs.make_production_solver(graph, device=CPU)())
    spans = [(rec[1], rec[6] or {}) for rec in BUS.events_since(mark) if rec[0] == "X"]
    return spans, ids, BUS.counters().get(READS, 0) - before


@pytest.mark.parametrize("seed", SEEDS)
def test_a_road_network_takes_the_l2_route_to_the_reference_forest(seed):
    graph = _road(LATTICE, seed)
    assert 2.40 <= 2 * graph.num_edges / graph.num_nodes <= 2.48
    spans, ids, _ = _solve(graph)
    prep = [a for name, a in spans if name == "solver.prep"]
    solve = [a for name, a in spans if name == "solver.rank.solve"]
    assert [a["route"] for a in prep] == ["l2"] and [a["route"] for a in solve] == ["host-l2"]
    want = reference.msf_ids(graph.num_nodes, graph.u, graph.v, graph.w)
    np.testing.assert_array_equal(ids, want)
    assert ids.size == graph.num_nodes - 1  # one component: a spanning tree


@pytest.mark.parametrize("case", list(SHRINKS))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_replay_span_closes_a_shrink_chain(seed, case, monkeypatch):
    """One ``solver.rank.replay`` span, a child of the solve on the device,
    after every finish chunk of a solve that shrank, naming as many stages
    as the chunks that shrank; none where no chunk shrank."""
    lattice, arm, fewest = SHRINKS[case]
    if arm is not None:
        arm(monkeypatch)
    graph = _road(lattice, seed)
    spans, ids, _ = _solve(graph)
    shrinks = sum(1 for name, a in spans
                  if name == "solver.rank.finish" and a["step"] == "_shrink_and_run")
    replays = [a for name, a in spans if name == "solver.rank.replay"]
    assert shrinks >= fewest and (shrinks == 0) == (fewest == 0)
    np.testing.assert_array_equal(
        ids, reference.msf_ids(graph.num_nodes, graph.u, graph.v, graph.w))
    if not shrinks:
        assert replays == []
        return
    (replay,) = replays
    assert replay["stages"] == shrinks and replay["on"] == "device"
    solve_id = next(a["span"] for name, a in spans if name == "solver.rank.solve")
    assert replay["parent"] == solve_id
    names = [name for name, _ in spans]
    assert names.index("solver.rank.replay") > max(
        i for i, name in enumerate(names) if name == "solver.rank.finish")


@pytest.mark.parametrize("seed", SEEDS)
def test_host_reads_count_each_read_of_small_tensors(seed, monkeypatch):
    calls = []
    real = trs._ints

    def counted(*scalars):
        calls.append(len(scalars))
        return real(*scalars)

    monkeypatch.setattr(trs, "_ints", counted)
    _, _, reads = _solve(_road(LATTICE, seed))
    assert reads == len(calls) > 0
    samples = [rec[6]["value"] for rec in BUS.events() if rec[1] == READS]
    assert samples[-1] == BUS.counters()[READS]


def test_a_disabled_bus_counts_no_read(monkeypatch):
    monkeypatch.setattr(BUS, "enabled", False)
    counters = BUS.counters()
    mark = BUS.mark()
    trs.make_production_solver(_road(LATTICE, SEEDS[0]), device=CPU)()
    assert BUS.events_since(mark) == [] and BUS.counters() == counters
