"""The rank order and the endpoint gather of the rank route's prep.

For integer weights whose range spans at most 2^22 values the prep copies
``w`` (int64), ``u`` and ``v`` (int32) to the device and computes the rank
order there (K7, ``kernels.rank_order``; its plain version on the CPU)
and the rank endpoints from it (``kernels.rank_endpoints``); the order
stays on the graph for the harvest (for the graph's life up to the stage
cache's size, else until the harvest reads it), and the graph's host
``_rank_order`` stays unfilled. Float weights and wider ranges keep the host order and
the host gather. Every case here holds the device path element for
element to ``graphs.edgelist.rank_order`` and ``Graph.rank_endpoints``.
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.graphs import native as tnative
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels

CPU = torch.device("cpu")
TILE = 4096  # K7's keys a tile (csrc/rank_order.cu kTile)
SPAN = kernels.RANK_ORDER_MAX_RANGE


def _weights(kind: str, m: int, seed: int = 0) -> np.ndarray:
    """int64 weights of one kind: its low and high values both present."""
    rng = np.random.default_rng(seed)
    lo, count = {
        "graph500": (1, 255),          # Graph500's 1..255: one digit pass
        "equal": (42, 1),              # every weight equal
        "ties": (7, 3),                # many ties
        "two-pass": (1, 11_600),       # road lengths: two passes
        "three-pass": (-5, 70_000),    # over 2^16 values: three passes
        "span-2^22": (1 << 33, SPAN),  # exactly 2^22 values: the device path
        "span-2^22+1": (-9, SPAN + 1),  # one more: the host path
    }[kind]
    w = rng.integers(lo, lo + count, m, dtype=np.int64)
    w[0], w[m // 2] = lo, lo + count - 1
    return w


KINDS = ("graph500", "equal", "ties", "two-pass", "three-pass", "span-2^22")
#: Sizes around K7's tile: under one, one, one and a bit, several and a tail.
SIZES = (1, 3, TILE - 1, TILE, TILE + 1, 5 * TILE + 77)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", SIZES)
def test_plain_k7_equals_the_host_rank_order(kind, m):
    w = _weights(kind, m, seed=m)
    wlow, whigh = int(w.min()), int(w.max())
    got = kernels.rank_order(torch.from_numpy(w), wlow, whigh)
    assert got.dtype == torch.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), tedge.rank_order(w))
    np.testing.assert_array_equal(got.numpy(), np.argsort(w, kind="stable"))


@pytest.mark.parametrize("values,passes", [
    (1, 1), (2, 1), (256, 1), (257, 2), (1 << 16, 2), ((1 << 16) + 1, 3), (SPAN, 3)])
def test_digit_passes_follow_the_range(values, passes):
    assert kernels.rank_order_passes(-3, -3 + values - 1) == passes


@pytest.mark.parametrize("wlow,whigh", [(0, SPAN), (5, 4), (-(1 << 40), 1 << 40)])
def test_k7_refuses_a_range_it_cannot_sort(wlow, whigh):
    with pytest.raises(ValueError, match="weight range"):
        kernels.rank_order(torch.zeros(4, dtype=torch.int64), wlow, whigh)


def _graph(kind: str, m: int, *, seed: int = 1, n: int | None = None) -> tedge.Graph:
    """A graph of ``m`` edges (loops and repeats allowed: the order and the
    gather do not care) with weights of ``kind``."""
    rng = np.random.default_rng(seed)
    n = n or max(2, m // 3)
    u = rng.integers(0, n, m, dtype=np.int64)
    v = rng.integers(0, n, m, dtype=np.int64)
    if kind == "float":
        w = rng.random(m) * 100.0
        w[: m // 4] = 3.5  # ties
    else:
        w = _weights(kind, m, seed)
    return tedge.Graph(n, u, v, w)


def _prep_endpoints(graph, m_pad):
    """The prep's rank endpoints on the CPU, and the ``where`` of its
    ``solver.prep.rank_order`` span."""
    enabled = BUS.enabled
    BUS.enable()
    mark = BUS.mark()
    try:
        ra, rb = trs._rank_endpoints(graph, m_pad, CPU)
    finally:
        BUS.enabled = enabled
    where = [rec[6]["where"] for rec in BUS.events_since(mark)
             if rec[0] == "X" and rec[1] == "solver.prep.rank_order"]
    return ra, rb, where


@pytest.mark.parametrize("kind", KINDS + ("span-2^22+1", "float"))
@pytest.mark.parametrize("m,extra", [(TILE + 1, 0), (5 * TILE + 77, 1000)])
def test_prep_order_and_endpoints_equal_the_host_ones(kind, m, extra):
    """The prep's ``(ra, rb)`` and the order it keeps equal the host's, pad
    ranks zero; integer weights within 2^22 values take the device path and
    leave the host order unfilled, the others take the host path."""
    graph = _graph(kind, m)
    m_pad = m + extra
    ra, rb, where = _prep_endpoints(graph, m_pad)
    device = kind not in ("span-2^22+1", "float")
    assert where == ["device" if device else "host"]
    assert ("_rank_order" in graph.__dict__) is not device
    held = tb.held_rank_order(graph, CPU)
    assert (held is not None) is device
    fresh = tedge.Graph(graph.num_nodes, graph.u, graph.v, graph.w)
    want_ra, want_rb = fresh.rank_endpoints(pad_to=m_pad)
    assert ra.dtype == rb.dtype == torch.int32 and ra.shape == (m_pad,)
    np.testing.assert_array_equal(ra.numpy(), want_ra)
    np.testing.assert_array_equal(rb.numpy(), want_rb)
    assert not ra[m:].any() and not rb[m:].any()
    if device:
        np.testing.assert_array_equal(held.numpy(), tedge.rank_order(graph.w))


@pytest.mark.parametrize("extra", [0, 11])
def test_plain_gather_equals_the_native_endpoints(extra):
    graph = _graph("ties", 3 * TILE + 5, seed=4)
    order = tedge.rank_order(graph.w)
    m_pad = graph.num_edges + extra
    ra, rb = kernels.rank_endpoints(torch.from_numpy(order).to(torch.int32),
                                    torch.from_numpy(graph.u).to(torch.int32),
                                    torch.from_numpy(graph.v).to(torch.int32), m_pad)
    want = tnative.rank_endpoints_i32(order, graph.u, graph.v, m_pad)
    np.testing.assert_array_equal(ra.numpy(), want[0])
    np.testing.assert_array_equal(rb.numpy(), want[1])


def test_gather_refuses_a_pad_under_the_edge_count():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="m_pad >= m"):
        kernels.rank_endpoints(t, t, t, 7)


@pytest.mark.parametrize("cached", [True, False])
def test_a_held_order_lives_as_long_as_the_stage_cache_would_keep_the_prep(monkeypatch, cached):
    """Up to ``_STAGE_CACHE_MAX_RANKS`` padded ranks the order stays with the
    cached prep, for every later harvest; above it, where the stage cache
    keeps nothing, the harvest that reads it releases it, and a later
    harvest maps the ranks with the host order, to the same ids."""
    graph = tgen.rmat_graph(11, 16, seed=3)
    m_pad = tb._bucket_size(graph.num_edges)
    if not cached:
        monkeypatch.setattr(trs, "_STAGE_CACHE_MAX_RANKS", m_pad - 1)
    mst, fragment, levels = trs.make_production_solver(graph, device=CPU)()
    assert tb.held_rank_order(graph, CPU) is not None
    ids, _, _ = tb.harvest(graph, mst, fragment, levels)
    assert (tb.held_rank_order(graph, CPU) is not None) is cached
    assert bool(graph.__dict__.get("_rank_stage_cache")) is cached
    assert "_rank_order" not in graph.__dict__
    again = tb.fetch_mst_edge_ids(graph, mst)
    assert ("_rank_order" in graph.__dict__) is not cached
    np.testing.assert_array_equal(again, ids)
    ranks = torch.nonzero(mst).flatten().numpy()
    np.testing.assert_array_equal(ids, np.sort(graph.edge_id_of_rank(ranks)))


SOLVES = {
    "rmat": lambda: tgen.rmat_graph(12, 16, seed=5),
    "grid": lambda: tgen.road_grid_graph(50, 60, seed=3),
    "road": lambda: tgen.random_road_network(60, 70, seed=2, weight_scale=4000),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_a_rank_solve_leaves_the_host_order_unfilled_and_harvests_the_same_ids(name):
    """A rank-route solve of an integer graph never fills ``_rank_order``;
    the harvest through the device order gives the ids the host order
    gives, and so does the packed harvest."""
    graph = SOLVES[name]()
    mst, fragment, levels = trs.make_production_solver(graph, device=CPU)()
    ids, _, _ = tb.harvest(graph, mst, fragment, levels)
    assert "_rank_order" not in graph.__dict__
    assert tb.held_rank_order(graph, CPU) is not None
    ranks = torch.nonzero(mst).flatten().numpy()
    want = np.sort(tedge.Graph(graph.num_nodes, graph.u, graph.v, graph.w)
                   .edge_id_of_rank(ranks))
    assert ids.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(ids, want)
    m_pad = mst.shape[0]
    packed = np.packbits(mst.numpy().astype(bool))
    np.testing.assert_array_equal(trs.packed_to_edge_ids(graph, packed, m_pad), want)
    assert "_rank_order" not in graph.__dict__


def test_a_float_solve_keeps_the_host_order():
    g = tgen.gnm_random_graph(2000, 9000, seed=3)
    graph = tedge.Graph(g.num_nodes, g.u, g.v, g.w + 0.25)
    ids, _, _ = trs.solve_graph_rank(graph, device=CPU)
    assert "_rank_order" in graph.__dict__ and tb.held_rank_order(graph) is None
    int_ids, _, _ = trs.solve_graph_rank(tedge.Graph(g.num_nodes, g.u, g.v, g.w), device=CPU)
    np.testing.assert_array_equal(ids, int_ids)


@pytest.mark.parametrize("keep", [True, False])
def test_orders_are_held_by_device(keep):
    graph = _graph("graph500", 100)
    order = torch.arange(100, dtype=torch.int32)
    tb.hold_rank_order(graph, order, keep=keep)
    assert tb.held_rank_order(graph, CPU) is order and tb.held_rank_order(graph) is order
    assert tb.held_rank_order(graph, torch.device("meta")) is None
    ranks = torch.tensor([7, 3, 50])
    np.testing.assert_array_equal(tb.edge_ids_of_ranks(graph, ranks), [3, 7, 50])
    assert (tb.held_rank_order(graph, CPU) is order) is keep
