"""The PyTorch port's Borůvka solve against the JAX package, edge-exact.

Sorted edge ids, ``fragment[:n]`` and the level count must equal JAX
``solve_graph`` for the ``fused`` and ``stepped`` strategies on the
multichip dry-run's fixture deck; generators must give the same graphs;
mid-solve state carried from JAX into the port must finish where JAX
finishes. The port runs with ``device="cpu"`` (its plain versions), JAX on
the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.models import boruvka as jb
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import DECK, build_deck

CPU = "cpu"


@pytest.fixture(scope="module")
def deck():
    return build_deck(jedge, jgen, tedge, tgen)


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("name", list(DECK))
@pytest.mark.parametrize("strategy", ["fused", "stepped"])
def test_solve_graph_matches_jax_on_the_deck(deck, name, strategy):
    jg, tg = deck[name]
    for a in "uvw":
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
    got = tb.solve_graph(tg, strategy=strategy, device=CPU)
    _assert_same_result(got, jb.solve_graph(jg, strategy=strategy))
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))
    if name == "forest23":
        assert np.unique(got[1]).size == 23


@pytest.mark.parametrize("strategy", ["fused", "stepped"])
def test_unbucketed_shapes_match_jax(deck, strategy):
    jg, tg = deck["road40"]
    got = tb.solve_graph(tg, strategy=strategy, bucket_shapes=False, device=CPU)
    _assert_same_result(got, jb.solve_graph(jg, strategy=strategy, bucket_shapes=False))


GENERATORS = {
    "er": lambda g, **k: g.erdos_renyi_graph(60, 0.1, seed=3),
    "er_sparse": lambda g, **k: g.erdos_renyi_graph(90, 0.01, seed=4, weight_high=1000),
    "gnm": lambda g, **k: g.gnm_random_graph(300, 900, seed=5),
    "rmat": lambda g, **k: g.rmat_graph(9, 8, seed=6, **k),
    "rmat_nodedup": lambda g, **k: g.rmat_graph(8, 4, seed=7, dedup=False, **k),
    "road": lambda g, **k: g.random_road_network(25, 30, seed=8),
    "road_dead_ends": lambda g, **k: g.random_road_network(25, 30, seed=9, dead_end_prob=0.3),
    "line": lambda g, **k: g.line_graph(17, weight=3),
    "simple": lambda g, **k: g.simple_test_graph(),
    "readme": lambda g, **k: g.readme_sample_graph(),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_jax(name):
    kw = {"use_native": False} if name.startswith("rmat") else {}
    jg = GENERATORS[name](jgen, **kw)
    tg = GENERATORS[name](tgen)
    assert tg.num_nodes == jg.num_nodes
    for a in "uvw":
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
        assert getattr(tg, a).dtype == getattr(jg, a).dtype


def test_graph_staging_matches_jax(deck):
    jg, tg = deck["forest23"]
    for pads in ({}, {"pad_edges_to": 2048, "pad_ranks_to": 1024}):
        for got, want in zip(tg.rank_arrays(**pads), jg.rank_arrays(**pads)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.prepare_device_arrays(tg, device=CPU), jb.prepare_device_arrays(jg)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ranks = np.arange(0, tg.num_edges, 7)
    np.testing.assert_array_equal(tg.edge_id_of_rank(ranks), jg.edge_id_of_rank(ranks))
    np.testing.assert_array_equal(
        tedge.component_labels(tg.num_nodes, tg.u, tg.v),
        jedge.component_labels(jg.num_nodes, jg.u, jg.v),
    )


def test_graph_from_edges_matches_jax():
    edges = [(0, 1, 4), (1, 0, 2), (2, 2, 1), (1, 3, 5.5), (3, 4, 1)]
    for src in (edges, iter(edges), np.asarray(edges)):
        tg = tedge.Graph.from_edges(5, src)
        jg = jedge.Graph.from_edges(5, list(edges))
        for a in "uvw":
            np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
    assert tedge.Graph.from_edges(3, []).num_edges == 0
    with pytest.raises(ValueError):
        tedge.Graph.from_arrays(2, np.array([0]), np.array([2]), np.array([1]))


@pytest.mark.parametrize("x", [0, 1, 2, 3, 4, 5, 9, 100, 1000, 4097, 1 << 20])
def test_size_helpers_match_jax(x):
    assert tb._next_pow2(x) == jb._next_pow2(x)
    assert tb._bucket_size(x) == jb._bucket_size(x)
    assert tb._max_levels(x) == jb._max_levels(x)


def test_rank_zero_survives_padding_collisions():
    """Isolated vertices and padding vertices have no MOE at every level;
    they all mark rank 0 with False. Rank 0 (the global minimum edge) must
    stay in the forest."""
    u = np.array([10, 11, 12, 10])
    v = np.array([11, 12, 13, 13])
    w = np.array([1, 5, 2, 9])
    g = tedge.Graph.from_arrays(21, u, v, w)  # 21 -> 32 padded vertices
    for strategy in ("fused", "stepped"):
        ids, frag, _ = tb.solve_graph(g, strategy=strategy, device=CPU)
        assert g.edge_id_of_rank(np.array([0]))[0] in ids
        np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
        jids, jfrag, _ = jb.solve_graph(jedge.Graph.from_arrays(21, u, v, w), strategy=strategy)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(frag, jfrag)
    mst = torch.zeros(4, dtype=torch.uint8)
    has = torch.tensor([False, True, False, False])
    marked = tb._mark(mst, has, torch.tensor([tedge.INT32_MAX, 0, tedge.INT32_MAX, 2**31 - 1]))
    assert marked.tolist() == [1, 0, 0, 0]


def test_stepped_compaction_matches_jax(monkeypatch, deck):
    """RMAT-12 stages 2^16 slots; after one level far fewer survive, so the
    slots compact (>= 2x shrink past _COMPACT_MIN_SLOTS)."""
    compactions = []
    real = tb._compact_kernel

    def spy(src_f, dst_f, rank, out_size):
        compactions.append((src_f.shape[0], out_size))
        out = real(src_f, dst_f, rank, out_size)
        want = jb._compact_kernel(*(jnp.asarray(t.numpy()) for t in (src_f, dst_f, rank)),
                                  out_size)
        for got, w in zip(out, want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        return out

    monkeypatch.setattr(tb, "_compact_kernel", spy)
    jg, tg = deck["rmat12"]
    args_t = tb.prepare_device_arrays(tg, device=CPU)
    args_j = jb.prepare_device_arrays(jg)
    for stepped_levels in (2, None):
        got = tb.solve_arrays_stepped(*args_t, stepped_levels=stepped_levels)
        want = jb.solve_arrays_stepped(*args_j, stepped_levels=stepped_levels)
        np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == int(want[2])
    assert compactions and all(2 * out <= cur for cur, out in compactions)
    assert min(out for _, out in compactions) >= tb._COMPACT_MIN_SLOTS


def test_state_carried_from_jax_finishes_like_jax(deck):
    """Two levels in JAX, the state carried across, the rest in the port."""
    jg, _ = deck["rmat12"]
    args_j = jb.prepare_device_arrays(jg)
    seen = {}

    def on_level(level, fragment, mst_ranks, has, count, wall):
        seen[level] = (np.asarray(fragment), np.asarray(mst_ranks))

    jb.solve_arrays_stepped(*args_j, stepped_levels=2, on_level=on_level)
    fragment, mst_ranks = seen[2]
    want = jb.solve_arrays_stepped(*args_j, initial_state=(fragment, mst_ranks, 2))
    args_t = tb.arrays_from_numpy(*(np.asarray(a) for a in args_j), device=CPU)
    state = tb.state_from_numpy(fragment, mst_ranks, 2, device=CPU)
    got = tb.solve_arrays_stepped(*args_t, initial_state=state)
    np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


def test_on_level_reports_each_stepped_level(deck):
    _, tg = deck["road40"]
    seen = []
    tb.solve_arrays_stepped(*tb.prepare_device_arrays(tg, device=CPU), stepped_levels=None,
                            on_level=lambda lv, f, m, has, count, wall: seen.append((lv, has)))
    _, _, levels = tb.solve_graph(tg, strategy="stepped", device=CPU)
    assert [lv for lv, _ in seen] == list(range(1, levels + 1))
    assert seen[-1][1] is False and all(h for _, h in seen[:-1])


def test_boruvka_solve_from_a_premerged_partition(deck):
    """Vertices pre-merged in pairs (root = the even id) solve to the same
    state in both packages."""
    jg, _ = deck["road40"]
    args_j = jb.prepare_device_arrays(jg)
    n = args_j[0].shape[0]
    fragment0 = (np.arange(n) & ~1).astype(np.int32)
    want = jb.boruvka_solve(jnp.asarray(fragment0), *args_j[1:])
    args_t = tb.arrays_from_numpy(fragment0, *(np.asarray(a) for a in args_j[1:]), device=CPU)
    got = tb.boruvka_solve(*args_t)
    np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


def test_strategies_not_ported_raise(monkeypatch):
    """An unknown strategy raises; the rank solver's filter-Kruskal route,
    which raised before it was ported, equals JAX's, by ``rank`` and by
    ``auto`` at the threshold (the rank width lowered on both sides so that
    small dense graphs take the route)."""
    from distributed_ghs_implementation_tpu.graphs import native as jnative
    from distributed_ghs_implementation_tpu.models import rank_solver as jrs
    from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs

    with pytest.raises(ValueError, match="unknown strategy"):
        tb.solve_graph(tgen.readme_sample_graph(), strategy="bogus", device=CPU)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)  # JAX's NumPy host passes
    for mod in (trs, jrs):
        monkeypatch.setattr(mod, "_FILTER_MIN_RANKS", 1024)
    _assert_same_result(tb.solve_graph(tgen.rmat_graph(10, 16, seed=3), strategy="rank",
                                       device=CPU),
                        jb.solve_graph(jgen.rmat_graph(10, 16, seed=3), strategy="rank"))
    dense = tgen.rmat_graph(13, 22, seed=5)
    assert dense.num_edges >= tb.ELL_AUTO_EDGE_THRESHOLD
    assert trs.use_filtered_path(trs._pick_family(dense), tb._bucket_size(dense.num_edges))
    _assert_same_result(tb.solve_graph(dense, device=CPU),
                        jb.solve_graph(jgen.rmat_graph(13, 22, seed=5)))


def test_rank_and_auto_at_the_threshold_take_the_rank_solver(monkeypatch):
    """``rank``, and ``auto`` at the threshold, run the rank solver and equal
    JAX on the graphs that raised before the rank solver was ported."""
    from distributed_ghs_implementation_tpu.graphs import native as jnative

    monkeypatch.setattr(jnative, "get_lib", lambda: None)  # JAX's NumPy host passes
    _assert_same_result(tb.solve_graph(tgen.readme_sample_graph(), strategy="rank", device=CPU),
                        jb.solve_graph(jgen.readme_sample_graph(), strategy="rank"))
    m = tb.ELL_AUTO_EDGE_THRESHOLD
    edges = (m + 1, np.arange(m), np.arange(m) + 1, np.ones(m, dtype=np.int64))
    got = tb.solve_graph(tedge.Graph(*edges), device=CPU)
    _assert_same_result(got, jb.solve_graph(jedge.Graph(*edges)))
    assert got[0].size == m


def test_empty_graphs():
    for g in (tedge.Graph.from_edges(0, []), tedge.Graph.from_edges(4, [])):
        ids, frag, levels = tb.solve_graph(g, device=CPU)
        assert ids.size == 0 and levels == 0
        np.testing.assert_array_equal(frag, np.arange(g.num_nodes))
