"""The rank order and the endpoint gather of the rank route's prep.

The prep copies ``w`` (int64 or float64, as it is), ``u`` and ``v`` (int32)
to the device and computes the rank order there (K7,
``kernels.sort_rank_order``; its plain version on the CPU) and the rank
endpoints from it (``kernels.rank_endpoints``); the order stays on the
graph for the harvest (for the graph's life up to the stage cache's size,
else until the harvest reads it), and the graph's host ``_rank_order``
stays unfilled. Integer weights whose range spans at most 2^22 values sort
by 32-bit keys, wider integers and floats by 64-bit keys, over the digits
that are not the same in every key. Every case here holds the device path
element for element to ``graphs.edgelist.rank_order`` (NumPy's stable
argsort), the JAX package's ``Graph._rank_order`` and
``Graph.rank_endpoints``.
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu_torch import api as tapi
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
        "span-2^22": (1 << 33, SPAN),  # exactly 2^22 values: the 32-bit key
        "span-2^22+1": (-9, SPAN + 1),  # one more: the 64-bit key
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


@pytest.mark.parametrize("wlow,whigh", [(5, 4), (0, None), (None, 1 << 40)])
def test_k7_refuses_a_range_it_cannot_sort(wlow, whigh):
    """A range of no values, or half a range: every range of at least one
    value sorts (wider ones by 64-bit keys, :func:`test_a_wide_range_takes_the_64_bit_key`)."""
    with pytest.raises(ValueError, match="weight range"):
        kernels.rank_order(torch.zeros(4, dtype=torch.int64), wlow, whigh)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k7_refuses_weights_of_another_type(dtype):
    with pytest.raises(TypeError, match="int64 or torch.float64"):
        kernels.rank_order(torch.zeros(4, dtype=dtype))


@pytest.mark.parametrize("wlow,whigh,key", [
    (0, SPAN - 1, "int32"), (0, SPAN, "int64"), (-(1 << 40), 1 << 40, "int64"),
    (None, None, "int64")])
def test_a_wide_range_takes_the_64_bit_key(wlow, whigh, key):
    w = torch.tensor([3, 0, 3, 1, 0, 2], dtype=torch.int64)
    sort = kernels.sort_rank_order(w, wlow, whigh)
    assert sort.key == key
    np.testing.assert_array_equal(sort.order.numpy(), [1, 4, 3, 5, 0, 2])


_F64 = np.finfo(np.float64)
#: Float64 values of every class: both zeros, both infinities, subnormals,
#: the extremes, NaN of both signs.
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, _F64.tiny, -_F64.tiny,
                     _F64.max, -_F64.max, _F64.eps, 1.0, -1.0, np.nan, -np.nan])


def _weights64(kind: str, m: int, seed: int = 0) -> np.ndarray:
    """float64 or int64 weights of one kind, for the 64-bit key."""
    rng = np.random.default_rng(seed)
    if kind == "float-specials":  # every class, heavily tied
        return rng.choice(SPECIALS, m)
    if kind == "float-mixed":  # specials among random normals of both signs
        w = rng.standard_normal(m) * 10.0 ** rng.integers(-300, 300, m)
        pick = rng.random(m) < 0.3
        w[pick] = rng.choice(SPECIALS, int(pick.sum()))
        return w
    if kind == "float-unit":  # the Graph500 SSSP weights: uniform in [0, 1)
        return rng.random(m)
    if kind == "float-ties":  # few values: long runs of equal keys
        return rng.choice(np.array([-2.5, -0.0, 0.0, 0.125, 7.0]), m)
    if kind == "int64-wide":  # the whole int64 range, and +-2^62
        w = rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64, endpoint=True)
        w[: m // 3] = rng.choice(np.array([-(1 << 62), 1 << 62, -(1 << 63), (1 << 63) - 1, 0, -1]),
                                 m // 3)
        return w
    if kind == "int64-high":  # only the digit at shift 40 differs
        return rng.integers(0, 256, m, dtype=np.int64) << 40 | 0x1234
    raise KeyError(kind)


KINDS64 = ("float-specials", "float-mixed", "float-unit", "float-ties", "int64-wide",
           "int64-high")


@pytest.mark.parametrize("kind", KINDS64)
@pytest.mark.parametrize("m", SIZES)
def test_plain_64_bit_k7_equals_numpy_and_the_jax_order(kind, m):
    """The 64-bit key's torch form equals NumPy's stable argsort and the JAX
    package's ``Graph._rank_order`` element for element: -0.0 with +0.0 by
    edge id, subnormals in place, NaN after +inf by edge id."""
    w = _weights64(kind, m, seed=m)
    sort = kernels.sort_rank_order(torch.from_numpy(w))
    assert sort.key == ("float64" if w.dtype == np.float64 else "int64")
    assert sort.order.dtype == torch.int32 and sort.order.shape == (m,)
    want = np.argsort(w, kind="stable")
    np.testing.assert_array_equal(sort.order.numpy(), want)
    zeros = np.zeros(m, dtype=np.int64)
    jax_order = jedge.Graph(2, zeros, zeros + 1, w)._rank_order
    np.testing.assert_array_equal(sort.order.numpy(), jax_order)
    np.testing.assert_array_equal(sort.order.numpy(), tedge.rank_order(w))


@pytest.mark.parametrize("w,digits", [
    (np.full(9, 0.375), 0),
    (np.array([0.0, -0.0, 0.0]), 0),
    (np.array([np.nan, -np.nan, np.nan]), 0),
    (np.array([1.0, 2.0]), 1 << 7 | 1 << 6),
    (np.array([1.0, -1.0]), 0xFF),  # a negative key is every bit flipped
    # Uniform in [0, 1): the top digit (sign and exponent's top bits) is the
    # same for every draw of 2^-15 and more, so a small sample skips it.
    (np.random.default_rng(1).random(5000), 0x7F),
    (np.append(np.random.default_rng(1).random(5000), 2.0 ** -16), 0xFF),
    (np.arange(256, dtype=np.int64) << 40 | 7, 1 << 5),
    (np.array([-1, 0], dtype=np.int64), 0xFF),
    (np.array([5, 260], dtype=np.int64), 0b11),
])
def test_the_64_bit_sort_passes_over_the_digits_that_differ(w, digits):
    """A digit the same in every key is skipped: the torch form's digit mask,
    and the mask of the OR and AND of the keys (the kernel's first read)."""
    key = kernels.rank_key64_torch(torch.from_numpy(w))
    assert kernels._digits_of_bits(*kernels.rank_key_bits_torch(key)) == digits
    unsigned = [int(k) & ((1 << 64) - 1) ^ (1 << 63) for k in key]
    any_bits = all_bits = unsigned[0]
    for k in unsigned:
        any_bits, all_bits = any_bits | k, all_bits & k
    assert kernels._digits_of_bits(any_bits, all_bits) == digits
    assert kernels.sort_rank_order(torch.from_numpy(w)).passes == bin(digits).count("1")


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
    """The prep's rank endpoints on the CPU, and the arguments of its
    ``solver.prep.rank_order`` spans."""
    enabled = BUS.enabled
    BUS.enable()
    mark = BUS.mark()
    try:
        ra, rb = trs._rank_endpoints(graph, m_pad, CPU)
    finally:
        BUS.enabled = enabled
    spans = [rec[6] for rec in BUS.events_since(mark)
             if rec[0] == "X" and rec[1] == "solver.prep.rank_order"]
    return ra, rb, spans


@pytest.mark.parametrize("kind", KINDS + ("span-2^22+1", "float"))
@pytest.mark.parametrize("m,extra", [(TILE + 1, 0), (5 * TILE + 77, 1000)])
def test_prep_order_and_endpoints_equal_the_host_ones(kind, m, extra):
    """The prep's ``(ra, rb)`` and the order it keeps equal the host's, pad
    ranks zero; every weight takes the device path and leaves the host
    order unfilled: integers within 2^22 values by the 32-bit key, a wider
    range by the 64-bit key of int64, floats by that of float64."""
    graph = _graph(kind, m)
    m_pad = m + extra
    ra, rb, spans = _prep_endpoints(graph, m_pad)
    key = {"span-2^22+1": "int64", "float": "float64"}.get(kind, "int32")
    assert [(a["where"], a["key"]) for a in spans] == [("device", key)]
    assert "_rank_order" not in graph.__dict__
    held = tb.held_rank_order(graph, CPU)
    fresh = tedge.Graph(graph.num_nodes, graph.u, graph.v, graph.w)
    want_ra, want_rb = fresh.rank_endpoints(pad_to=m_pad)
    assert ra.dtype == rb.dtype == torch.int32 and ra.shape == (m_pad,)
    np.testing.assert_array_equal(ra.numpy(), want_ra)
    np.testing.assert_array_equal(rb.numpy(), want_rb)
    assert not ra[m:].any() and not rb[m:].any()
    np.testing.assert_array_equal(held.numpy(), tedge.rank_order(graph.w))


def test_the_prep_span_names_the_key_and_its_passes_and_the_counter_counts_them():
    """``solver.prep.rank_order`` says which key K7 sorted and over how many
    digit passes; ``kernels.rank_order.passes`` grows by them, its total
    sampled on the timeline."""
    name = "kernels.rank_order.passes"
    for kind, key, passes in (("graph500", "int32", 1), ("three-pass", "int32", 3),
                              ("float", "float64", 8)):
        before = BUS.counters().get(name, 0)
        mark = BUS.mark()
        _, _, spans = _prep_endpoints(_graph(kind, 3 * TILE), 3 * TILE)
        assert [(a["key"], a["passes"]) for a in spans] == [(key, passes)]
        assert BUS.counters()[name] - before == passes
        samples = [rec[6]["value"] for rec in BUS.events_since(mark)
                   if rec[0] == "C" and rec[1] == name]
        assert samples == [BUS.counters()[name]]


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


def test_a_float_solve_takes_the_device_order():
    """A float solve sorts by the 64-bit key, holds the device order and
    leaves ``_rank_order`` unfilled; weights shifted by a constant give the
    integer solve's ids."""
    g = tgen.gnm_random_graph(2000, 9000, seed=3)
    graph = tedge.Graph(g.num_nodes, g.u, g.v, g.w + 0.25)
    ids, _, _ = trs.solve_graph_rank(graph, device=CPU)
    assert "_rank_order" not in graph.__dict__ and tb.held_rank_order(graph) is not None
    int_ids, _, _ = trs.solve_graph_rank(tedge.Graph(g.num_nodes, g.u, g.v, g.w), device=CPU)
    np.testing.assert_array_equal(ids, int_ids)


def _parity_weights(kind: str, m: int) -> np.ndarray:
    rng = np.random.default_rng(17)
    if kind == "float":  # the Graph500 SSSP weights, some tied, some -0.0
        w = rng.random(m)
        w[rng.random(m) < 0.05] = 0.5
        w[rng.random(m) < 0.01] = -0.0
        return w
    return rng.integers(-(1 << 62), 1 << 62, m, dtype=np.int64)  # "wide"


@pytest.mark.parametrize("kind", ["float", "wide"])
def test_float_and_wide_solves_equal_the_jax_forest(kind):
    """Over 2^17 edges, where both packages take the rank route: float and
    wide-range weights give the JAX package's forest through the public
    API, edge id for edge id."""
    g = tgen.rmat_graph(13, 22, seed=5)
    assert g.num_edges >= tb.ELL_AUTO_EDGE_THRESHOLD
    w = _parity_weights(kind, g.num_edges)
    got = tapi.minimum_spanning_forest(tedge.Graph(g.num_nodes, g.u, g.v, w), device=CPU)
    want = japi.minimum_spanning_forest(jedge.Graph(g.num_nodes, g.u, g.v, w))
    np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    assert got.num_components == want.num_components


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
