"""The port's rank-space solver against the JAX package's, element-exact.

The same NumPy inputs from a seed go to both: forest masks, fragment
labels, level counts and every intermediate the two modules share must be
equal. The port runs on the CPU (its plain versions); JAX on the CPU. The
JAX package's native library stays out of these tests: its ``get_lib`` is
patched to report no library, so every JAX host pass takes its NumPy
branch, as the port's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import native as jnative
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch import profile_solve
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import build_deck

CPU = "cpu"
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def _two_grids(edge_mod, gen):
    """Two road grids and 7 isolated vertices: 9 components."""
    g1 = gen.road_grid_graph(30, 30, seed=5)
    g2 = gen.road_grid_graph(12, 12, seed=6)
    off = g1.num_nodes
    return edge_mod.Graph.from_arrays(
        off + g2.num_nodes + 7, np.concatenate([g1.u, g2.u + off]),
        np.concatenate([g1.v, g2.v + off]), np.concatenate([g1.w, g2.w]))


#: name -> maker(edgelist module, generators module, **rmat keywords); one
#: graph of each family and a forest with isolated vertices.
GRAPHS = {
    "rmat": lambda e, g, **k: g.rmat_graph(10, 16, seed=3, **k),
    "grid": lambda e, g, **k: g.road_grid_graph(40, 50, seed=2),
    "road": lambda e, g, **k: g.random_road_network(40, 40, seed=3),
    "forest": lambda e, g, **k: _two_grids(e, g),
}


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, make in GRAPHS.items():
        kw = {"use_native": False} if name == "rmat" else {}
        out[name] = (make(jedge, jgen, **kw), make(tedge, tgen))
    return out


def _host(g):
    """``(vmin0, ra, rb)`` as NumPy from the port's graph."""
    n_pad, m_pad = tb._bucket_size(g.num_nodes), tb._bucket_size(g.num_edges)
    ra, rb = g.rank_endpoints(pad_to=m_pad)
    vmin0 = np.full(n_pad, INT32_MAX, dtype=np.int32)
    vmin0[: g.num_nodes] = g.first_ranks
    return vmin0, ra, rb


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _same(got, want):
    """Tensors, ints and (nested) tuples of them equal element for element;
    the port's uint8 masks against JAX's bool ones."""
    if isinstance(got, (tuple, list)):
        want = [int(x) for x in np.asarray(want)] if not isinstance(want, (tuple, list)) else want
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g.astype(bool) if w.dtype == bool else g, w)
    else:
        assert got == int(want), (got, want)


def _same_solve(got, want):
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2] == int(want[2])


# ---------------------------------------------------------------------------
# Host helpers and host level passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_first_ranks_matches_jax(graphs, name):
    jg, tg = graphs[name]
    np.testing.assert_array_equal(tg.first_ranks, jg.first_ranks)
    assert tg.first_ranks.dtype == np.int32


@pytest.mark.parametrize("kw", [{}, {"diag_prob": 0.3, "keep_prob": 0.6}, {"diag_prob": 0.0}])
def test_road_grid_graph_matches_jax(kw):
    jg = jgen.road_grid_graph(17, 23, seed=4, **kw)
    tg = tgen.road_grid_graph(17, 23, seed=4, **kw)
    assert tg.num_nodes == jg.num_nodes
    for a in "uvw":
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_level1_matches_jax_and_the_device(graphs, name):
    vmin0, ra, rb = _host(graphs[name][1])
    want = jrs.host_level1(vmin0, ra, rb)
    np.testing.assert_array_equal(trs.host_level1(vmin0, ra, rb), want)
    np.testing.assert_array_equal(trs._device_level1(*_t(vmin0, ra, rb)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jrs._device_level1(*_j(vmin0, ra, rb))), want)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_rank_head_level2_equals_the_jax_host_pass(graphs, name):
    """The head's level 2 over every rank (``_rank_head`` at
    ``compact_after=2``) is the JAX package's host level 2: the two-level
    partition, the endpoints relabeled by it, and the marks of levels 1
    and 2."""
    tg = graphs[name][1]
    vmin0, ra, rb = _host(tg)
    parent1 = trs.host_level1(vmin0, ra, rb)
    fragment, mst, fa, fb, _ = trs._rank_head(*_t(vmin0, ra, rb, parent1), compact_after=2)
    fragment2, l2r = jrs.host_level2(parent1, ra, rb, tg.num_edges)
    np.testing.assert_array_equal(fragment.numpy(), fragment2)
    np.testing.assert_array_equal(fa.numpy(), fragment2[ra])
    np.testing.assert_array_equal(fb.numpy(), fragment2[rb])
    np.testing.assert_array_equal(np.nonzero(mst.numpy())[0],
                                  np.union1d(vmin0[vmin0 < INT32_MAX], l2r))


def test_host_levels_raise_on_a_long_hook_cycle():
    """A vmin0 that is no per-vertex minimum can hook a 3-cycle: both
    packages raise instead of looping."""
    ra = np.array([0, 1, 2], dtype=np.int32)
    rb = np.array([1, 2, 0], dtype=np.int32)
    vmin0 = np.array([0, 1, 2], dtype=np.int32)
    for mod in (trs, jrs):
        with pytest.raises(ValueError, match="did not converge"):
            mod.host_level1(vmin0, ra, rb)


@pytest.mark.parametrize("name", ["rmat", "forest"])
def test_preps_match_jax(graphs, name):
    jg, tg = graphs[name]
    full = trs.prepare_rank_arrays_full(tg, device=CPU)
    assert all(t.dtype == torch.int32 for t in full)
    _same(tuple(full), tuple(jrs.prepare_rank_arrays_full(jg)))
    assert trs.prepare_rank_arrays_full(tg, device=CPU) is full  # cached
    assert trs.prepare_rank_arrays(tg, device=CPU) == full[:3]


# ---------------------------------------------------------------------------
# Level core
# ---------------------------------------------------------------------------


def _relabeled(tg):
    """``(vmin0, ra, rb, parent1, fa, fb)``: the head's level-1 relabel."""
    vmin0, ra, rb = _host(tg)
    parent1 = trs.host_level1(vmin0, ra, rb)
    return vmin0, ra, rb, parent1, parent1[ra], parent1[rb]


@pytest.mark.parametrize("two_pass", [False, True])
def test_moe_over_both_forms_match_jax(graphs, monkeypatch, two_pass):
    if two_pass:
        monkeypatch.setattr(trs, "_MOE_TWO_PASS_SLOTS", 0)
    *_, parent1, fa, fb = _relabeled(graphs["rmat"][1])
    key = np.where(fa != fb, np.arange(fa.size, dtype=np.int32), INT32_MAX).astype(np.int32)
    n = parent1.size
    _same(trs._moe_over(*_t(fa, fb, key), n), jrs._moe_over(*_j(fa, fb, key), n))


def test_prefix_level2_core_matches_jax(graphs):
    *_, parent1, fa, fb = _relabeled(graphs["rmat"][1])
    got = trs._prefix_level2_core(*_t(parent1, fa, fb))
    want = jrs._prefix_level2_core(*_j(parent1, fa, fb))
    _same(got[:5], tuple(want[:5]))
    assert int(got[5]) == int(want[5])


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("compact_after", [1, 2])
def test_rank_head_matches_jax(graphs, name, compact_after):
    vmin0, ra, rb, parent1, _, _ = _relabeled(graphs[name][1])
    got = trs._rank_head(*_t(vmin0, ra, rb, parent1), compact_after=compact_after)
    want = jrs._rank_head(*_j(vmin0, ra, rb, parent1), compact_after=compact_after)
    _same(got, tuple(want))


def _head(tg, compact_after=2):
    vmin0, ra, rb, parent1, _, _ = _relabeled(tg)
    _, mst, fa, fb, (lv, count) = trs._rank_head(*_t(vmin0, ra, rb, parent1),
                                                 compact_after=compact_after)
    return mst.numpy().astype(bool), fa.numpy(), fb.numpy(), count


@pytest.mark.parametrize("out", ["pads", "exact", "drops"])
def test_compact_slots_matches_jax_with_dead_and_pad_slots(graphs, out):
    _, fa, fb, count = _head(graphs["grid"][1], compact_after=1)
    assert 0 < count < fa.size  # dead slots to skip
    out_size = {"pads": 2 * count + 3, "exact": count, "drops": count // 3}[out]
    rank_of_slot = np.random.default_rng(1).permutation(fa.size).astype(np.int32)
    got = trs._compact_slots(*_t(fa, fb, rank_of_slot), out_size)
    _same(got, tuple(jrs._compact_slots(*_j(fa, fb, rank_of_slot), out_size)))
    assert all(t.dtype == torch.int32 for t in got[:3])


@pytest.mark.parametrize("name", ["grid", "forest"])
def test_compact_and_mark_matches_jax(graphs, name):
    tg = graphs[name][1]
    _, fa, fb, count = _head(tg, compact_after=1)
    n = tb._bucket_size(tg.num_nodes)
    out_size = tb._bucket_size(count)
    slots = np.arange(fa.size, dtype=np.int32)
    got = trs._compact_and_mark(*_t(fa, fb, slots), n=n, out_size=out_size)
    want = jrs._compact_and_mark(*_j(fa, fb, slots), n=n, out_size=out_size)
    _same(got, tuple(want))
    assert got[4].dtype == torch.int32


@pytest.mark.parametrize("chunk_levels", [1, 4])
def test_shrink_and_run_matches_jax(graphs, chunk_levels):
    """From the census of a real head, with root 0 unmarked in the census
    (pad slots read newid[0] == -1)."""
    tg = graphs["forest"][1]
    mst, fa, fb, count = _head(tg, compact_after=1)
    n = tb._bucket_size(tg.num_nodes)
    out_size = tb._bucket_size(count) + 5
    slots = np.arange(fa.size, dtype=np.int32)
    c = trs._compact_and_mark(*_t(fa, fb, slots), n=n, out_size=out_size)
    f_size = tb._bucket_size(c[5][0])
    assert not bool(c[3][0]) and int(c[4][0]) == -1
    rep_prev = np.arange(n, dtype=np.int32)[::-1].copy()
    args = [c[3].numpy(), c[4].numpy(), rep_prev, mst, c[0].numpy(), c[1].numpy(), c[2].numpy()]
    got = trs._shrink_and_run(*_t(*args[:3]), torch.from_numpy(mst.astype(np.uint8)),
                              *_t(*args[4:]), f_size=f_size, chunk_levels=chunk_levels)
    want = jrs._shrink_and_run(*_j(*args), f_size=f_size, chunk_levels=chunk_levels)
    _same(got, tuple(want))


def test_levels_loop_runs_no_level_when_nothing_is_alive():
    fragment = np.arange(8, dtype=np.int32)
    mst = np.zeros(16, dtype=bool)
    cfa = cfb = np.zeros(16, dtype=np.int32)
    crank = np.arange(16, dtype=np.int32)
    got = trs._levels_loop(*_t(fragment), torch.zeros(16, dtype=torch.uint8), *_t(cfa, cfb, crank),
                           chunk_levels=3)
    want = jrs._run_levels(*_j(fragment, mst, cfa, cfb, crank), chunk_levels=3)
    _same(got, tuple(want))
    assert got[4] == (0, 0)


def _stages(rng, sizes):
    """Random shrink stages over spaces ``sizes[0] > sizes[1] > ...``: a
    census ``mark`` of ``sizes[k+1]`` live roots over space k, its
    ``newid``, a ``rep`` and a compact fragment state."""
    stages = []
    for space, f in zip(sizes, sizes[1:]):
        mark = np.zeros(space, dtype=bool)
        mark[rng.choice(space, f, replace=False)] = True
        newid = (np.cumsum(mark) - 1).astype(np.int32)
        rep = rng.integers(0, sizes[0], f).astype(np.int32)
        cfrag = rng.integers(0, f, f).astype(np.int32)
        stages.append((mark, newid, rep, cfrag))
    return stages


@pytest.mark.parametrize("sizes", [[64], [64, 40], [500, 120, 100, 30, 3]])
def test_replay_stages_matches_jax(sizes):
    """Dead entries keep ids of older spaces, past the newer arrays: JAX
    clamps that gather, the port reads id 0; the results agree."""
    rng = np.random.default_rng(len(sizes))
    fragment = rng.integers(0, sizes[0], sizes[0]).astype(np.int32)
    stages = _stages(rng, sizes)
    got = trs._replay_stages(*_t(fragment), [_t(*s) for s in stages])
    _same(got, jrs._replay_stages(*_j(fragment), [_j(*s) for s in stages]))


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def _spy(monkeypatch, mod, log):
    orig = mod._shrink_and_run

    def spy(*a, **k):
        log.append(k["f_size"])
        return orig(*a, **k)

    monkeypatch.setattr(mod, "_shrink_and_run", spy)


def _force_census(monkeypatch):
    """A census chain at these sizes: shrink from 64 roots up, and no
    one-shot chunk."""
    for mod in (trs, jrs):
        monkeypatch.setattr(mod, "_SHRINK_MIN_SPACE", 64)
        monkeypatch.setattr(mod, "_ONE_SHOT_MAX_SLOTS", 0)


@pytest.mark.parametrize("name,compact_space,chunk_levels", [
    ("grid", True, 2), ("grid", True, 3), ("grid", False, 2), ("grid", False, 3),
    ("forest", True, 2)])
def test_solve_rank_staged_matches_jax(graphs, monkeypatch, name, compact_space, chunk_levels):
    _force_census(monkeypatch)
    shrinks_t, shrinks_j = [], []
    _spy(monkeypatch, trs, shrinks_t)
    _spy(monkeypatch, jrs, shrinks_j)
    tg = graphs[name][1]
    arrays = _host(tg)
    kw = dict(compact_after=1, chunk_levels=chunk_levels, compact_space=compact_space)
    got = trs.solve_rank_staged(*_t(*arrays), **kw)
    _same_solve(got, jrs.solve_rank_staged(*_j(*arrays), **kw))
    assert shrinks_t == shrinks_j
    assert len(shrinks_t) >= 2 if compact_space else not shrinks_t
    np.testing.assert_array_equal(trs.fetch_mst_edge_ids(tg, got[0]), rank_oracle_edge_ids(tg))


def test_solve_rank_staged_default_head_matches_jax(graphs):
    arrays = _host(graphs["rmat"][1])
    _same_solve(trs.solve_rank_staged(*_t(*arrays)), jrs.solve_rank_staged(*_j(*arrays)))


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_solve_rank_speculative_accepted_matches_jax(graphs, name):
    tg = graphs[name][1]
    arrays = _host(tg)
    out_size = tb._bucket_size(arrays[1].size // 2)
    got = trs.solve_rank_speculative(*_t(*arrays), out_size=out_size)
    want = jrs.solve_rank_speculative(*_j(*arrays), out_size=out_size)
    assert got is not None and want is not None
    _same_solve(got, want)
    _same_solve(got, trs.solve_rank_staged(*_t(*arrays)))


def test_solve_rank_speculative_mispredicts_to_none(graphs):
    arrays = _host(graphs["rmat"][1])
    assert trs.solve_rank_speculative(*_t(*arrays), out_size=2) is None
    assert jrs.solve_rank_speculative(*_j(*arrays), out_size=2) is None


@pytest.mark.parametrize("hooked", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_l2_route_matches_jax(graphs, name, hooked):
    """The host-L2 route's solve (the staged solve from the one prep, level
    2 in its head, two-level chunks, the census) against JAX's
    ``solve_rank_l2`` from its prep's host level 2: the forest, the
    fragment and the levels, and with a hook every chunk state. Where the
    family routes there, the production solver is that solve."""
    jg, tg = graphs[name]
    seen_t, seen_j = [], []
    vmin0, ra, rb, parent1 = trs.prepare_rank_arrays_full(tg, device=CPU)
    got = trs.solve_rank_staged(vmin0, ra, rb, compact_after=2, chunk_levels=2,
                                compact_space=True, parent1=parent1,
                                on_chunk=_recorder(seen_t, True) if hooked else None)
    want = jrs.solve_rank_l2(*jrs.prepare_rank_arrays_l2(jg),
                             on_chunk=_recorder(seen_j, False) if hooked else None)
    _same_solve(got, want)
    assert len(seen_t) == len(seen_j) >= (2 if hooked else 0)
    for (lt, ft, mt, ct), (lj, fj, mj, cj) in zip(seen_t, seen_j):
        assert (lt, ct) == (lj, cj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
    if trs.use_l2_path(trs._pick_family(tg)):
        _same_solve(trs.make_production_solver(tg, device=CPU)(), want)


@pytest.mark.parametrize("nodes", [1, 5])
def test_production_solver_on_a_graph_with_no_edge_matches_jax(nodes):
    """No edge: the host-L2 route (the family of degree 0) hooks nothing
    and counts no level, as JAX's ``solve_rank_l2`` does."""
    none = np.zeros(0, dtype=np.int64)
    tg, jg = (mod.Graph.from_arrays(nodes, none, none, none) for mod in (tedge, jedge))
    got = trs.make_production_solver(tg, device=CPU)()
    _same_solve(got, jrs.make_production_solver(jg)())
    assert got[2] == 0 and not got[0].any()


def _recorder(seen, copy):
    def hook(level, fragment, mst, count):
        arr = (lambda t: t.numpy().copy()) if copy else np.asarray
        seen.append((int(level), arr(fragment), arr(mst).astype(bool), int(count)))
    return hook


def test_resume_from_a_jax_on_chunk_state(graphs, monkeypatch):
    """The JAX solve's state after its first chunk, carried across as NumPy,
    finishes in the port where it finishes in JAX, chunk for chunk."""
    _force_census(monkeypatch)
    tg = graphs["grid"][1]
    arrays = _host(tg)
    kw = dict(compact_after=1, chunk_levels=2)
    seen_j, seen_t = [], []
    full_j = jrs.solve_rank_staged(*_j(*arrays), on_chunk=_recorder(seen_j, False), **kw)
    full_t = trs.solve_rank_staged(*_t(*arrays), on_chunk=_recorder(seen_t, True), **kw)
    _same_solve(full_t, full_j)
    assert [(s[0], s[3]) for s in seen_t] == [(s[0], s[3]) for s in seen_j]
    assert len(seen_j) >= 3
    for (_, ft, mt, _), (_, fj, mj, _) in zip(seen_t, seen_j):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
    level, fragment, mask, _ = seen_j[1]
    state = (fragment, mask, level)
    rest_j, rest_t = [], []
    want = jrs.solve_rank_staged(*_j(*arrays), initial_state=state,
                                 on_chunk=_recorder(rest_j, False), **kw)
    got = trs.solve_rank_staged(*_t(*arrays), initial_state=state,
                                on_chunk=_recorder(rest_t, True), **kw)
    _same_solve(got, want)
    assert [(s[0], s[3]) for s in rest_t] == [(s[0], s[3]) for s in rest_j]
    np.testing.assert_array_equal(got[0].numpy().astype(bool), full_t[0].numpy().astype(bool))


def test_restore_state_host_matches_jax():
    rng = np.random.default_rng(2)
    for n_state, m_state in ((10, 30), (20, 12), (16, 16)):
        state = (rng.integers(0, n_state, n_state), rng.random(m_state) < 0.3, 4)
        got = trs._restore_state_host(state, 16, 16)
        want = jrs._restore_state_host(state, 16, 16)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2] == 4


# ---------------------------------------------------------------------------
# Routing, entry points, envelope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("avg_degree", [0.0, 1.0, 3.0, 3.02, 5.0, 8.0, 8.02, 30.0])
def test_routing_predicates_match_jax(avg_degree):
    n = 100
    m = int(round(avg_degree * n / 2))
    e = np.zeros(m, dtype=np.int64)
    tg, jg = tedge.Graph(n, e, e, e), jedge.Graph(n, e, e, e)
    family = trs._pick_family(tg)
    assert family == jrs._pick_family(jg)
    assert trs._family_params(family) == jrs._family_params(family)
    assert trs.use_l2_path(family) == jrs.use_l2_path(family)
    for ranks in (1 << 17, (1 << 23) - 1, 1 << 23, 1 << 25):
        assert trs.use_filtered_path(family, ranks) == jrs.use_filtered_path(family, ranks)


@pytest.mark.parametrize("n_pad,m_pad,raises", [
    ((1 << 31) - 1, (1 << 31) - 1, False), (1 << 31, 8, True), (8, 1 << 31, True)])
def test_check_rank_envelope_matches_jax(n_pad, m_pad, raises):
    for mod in (trs, jrs):
        if raises:
            with pytest.raises(ValueError, match="int32 rank envelope"):
                mod.check_rank_envelope(n_pad, m_pad)
        else:
            mod.check_rank_envelope(n_pad, m_pad)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_solve_graph_rank_matches_jax(graphs, name):
    jg, tg = graphs[name]
    got = tb.solve_graph(tg, strategy="rank", device=CPU)
    want = jrs.solve_graph_rank(jg)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))


def test_deck_rank_solves_match_jax():
    for name, (jg, tg) in build_deck(jedge, jgen, tedge, tgen).items():
        got = tb.solve_graph(tg, strategy="rank", device=CPU)
        want = jrs.solve_graph_rank(jg)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert got[2] == want[2], name


def test_auto_over_the_threshold_takes_the_rank_solver():
    """Just over 2^17 edges, ``auto`` takes the rank solver in both
    packages, through the public API."""
    jg = jgen.rmat_graph(13, 22, seed=5, use_native=False)
    tg = tgen.rmat_graph(13, 22, seed=5)
    assert tg.num_edges >= tb.ELL_AUTO_EDGE_THRESHOLD
    got = tapi.minimum_spanning_forest(tg, device=CPU)
    want = japi.minimum_spanning_forest(jg)
    np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    assert got.num_levels == want.num_levels
    assert got.num_components == want.num_components
    rank = tb.solve_graph(tg, strategy="rank", device=CPU)
    np.testing.assert_array_equal(got.edge_ids, rank[0])
    assert got.num_levels == rank[2]


def test_stage_cache_is_keyed_by_device():
    tg = tgen.road_grid_graph(9, 9, seed=1)
    staged = trs.prepare_rank_arrays_full(tg, device=CPU)
    assert trs.prepare_rank_arrays_full(tg, device=torch.device("cpu")) is staged
    cache = tg.__dict__["_rank_stage_cache"]
    assert set(cache) == {torch.device("cpu")}


@pytest.mark.parametrize("name,route", [
    ("rmat", "staged after a misprediction"), ("grid", "host-l2"), ("road", "host-l2")])
def test_profile_phases_split_a_rank_solve_on_the_cpu(graphs, name, route):
    """The profiler times the solver's own route: the same levels as
    ``solve_graph``, the route the solver's predicates give, and phases that
    add up to the whole."""
    tg = graphs[name][1]
    phases = profile_solve._phases(tg, "rank", torch.device(CPU))
    assert phases["levels"] == tb.solve_graph(tg, strategy="rank", device=CPU)[2]
    assert phases["route"] == route
    assert phases["family"] == trs._pick_family(tg)
    chunks = phases["finish_chunks"]
    assert chunks and {c["step"] for c in chunks} <= set(profile_solve._RANK_CHUNKS)
    assert sum(c["s"] for c in chunks) <= phases["finish_s"] + 1e-9
    assert 0 < phases["host_levels_s"] <= phases["stage_s"]
    assert phases["total_s"] == pytest.approx(sum(phases[k] for k in (
        "first_ranks_s", "stage_s", "head_s", "finish_s", "harvest_s")))
    for fn in ("_rank_head", "host_level1", "solve_rank_speculative"):  # unwrapped after
        assert getattr(trs, fn).__module__ == trs.__name__


def test_profile_phases_report_an_accepted_speculation(graphs, monkeypatch):
    """At a speculative width the head's survivors fit (half the ranks, as
    in the accepted test above), the speculation answers in one finish
    chunk, and the profiler says so."""
    tg = graphs["rmat"][1]
    speculate = trs.solve_rank_speculative

    def wider(vmin0, ra, rb, *, out_size, **kw):
        return speculate(vmin0, ra, rb, out_size=tb._bucket_size(ra.shape[0] // 2), **kw)

    monkeypatch.setattr(trs, "solve_rank_speculative", wider)
    phases = profile_solve._phases(tg, "rank", torch.device(CPU))
    assert phases["route"] == "speculative"
    assert [c["step"] for c in phases["finish_chunks"]] == ["_finish_chunk"]
    assert phases["levels"] == tb.solve_graph(tg, strategy="rank", device=CPU)[2]


def test_production_solver_routes_as_jax(graphs):
    """``make_production_solver``'s ``solve()`` equals JAX's on every
    family: the host-L2 route and ``solve_rank_auto``."""
    for name, (jg, tg) in graphs.items():
        got = trs.make_production_solver(tg, device=CPU)()
        want = jrs.make_production_solver(jg)()
        np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(want[0]),
                                      err_msg=name)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg=name)
        assert got[2] == int(want[2]), name


def test_device_busy_merges_overlapping_spans_and_keeps_the_longest_launch():
    from types import SimpleNamespace as NS

    def evt(name, start, end, dev=torch.autograd.DeviceType.CUDA):
        return NS(name=name, device_type=dev, time_range=NS(start=start, end=end))

    events = [evt("scatter", 0, 10), evt("scatter", 5, 30), evt("hook", 40, 44),
              evt("host", 0, 100, torch.autograd.DeviceType.CPU)]
    busy, by_name = profile_solve._device_busy(NS(events=lambda: events))
    assert busy == pytest.approx(34e-6)  # [0, 30] and [40, 44], in us
    assert list(by_name) == ["scatter", "hook"]
    assert by_name["scatter"] == {"s": pytest.approx(35e-6), "launches": 2,
                                  "max_s": pytest.approx(25e-6)}
