"""The port's filter-Kruskal route against the JAX package's, element-exact.

The route serves dense graphs at ``_FILTER_MIN_RANKS`` (2^23) padded ranks
and above; here the thresholds are lowered on both sides so that graphs of
a thousand vertices take it, and every sub-route must give JAX's forest
mask, fragment labels and level count: the speculative program (accepted
and mispredicted), the filtered solve (the fused filter overflowing to the
two-step one, the chunked filter), the degenerate split, the resume's wide
branch. The port's heads run level 2 from the prep's ``parent1``, where
JAX's production solves read the host's level 2 from their prep. The
prep's first ranks and level 1, which run on the device from the staged
endpoints, and the heads' level 2 must also equal the host passes. The
JAX package's native library stays out: its ``get_lib`` is patched to
report none, so its host passes take their NumPy branches.
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
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

CPU = "cpu"
INT32_MAX = np.iinfo(np.int32).max
BIG_CENSUS = 1 << 21  # the default: these graphs stay under it (speculative)
SMALL_CENSUS = 64  # these graphs reach it (the filtered solve)


@pytest.fixture(autouse=True)
def _filter_at_small_sizes(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    for mod in (trs, jrs):
        monkeypatch.setattr(mod, "_FILTER_MIN_RANKS", 1024)


def _set(monkeypatch, **values):
    for name, value in values.items():
        for mod in (trs, jrs):
            monkeypatch.setattr(mod, name, value)


def _clique_prefix(edge_mod, gen):
    """The lightest ranks all inside a 64-vertex clique, then 10,000
    random heavier edges over 1,024 vertices: the prefix forest joins the
    clique only, so most suffix edges survive the filter, past its
    predicted width."""
    iu, iv = np.triu_indices(64, 1)
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 1024, (2, 10_000))
    w = np.concatenate([rng.integers(1, 50, iu.size), rng.integers(100, 10_000, 10_000)])
    return edge_mod.Graph.from_arrays(1024, np.concatenate([iu, a]), np.concatenate([iv, b]), w)


#: name -> maker(edgelist module, generators module). Dense, all of them.
GRAPHS = {
    "rmat10": lambda e, g: g.rmat_graph(10, 16, seed=3),
    "rmat11": lambda e, g: g.rmat_graph(11, 16, seed=3),
    "clique": _clique_prefix,
}


def _pair(name):
    """A fresh ``(jax_graph, port_graph)``: the preps cache on the graph."""
    return GRAPHS[name](jedge, jgen), GRAPHS[name](tedge, tgen)


def _host(g):
    """``(vmin0, ra, rb, parent1)`` as NumPy from the port's graph."""
    n_pad, m_pad = tb._bucket_size(g.num_nodes), tb._bucket_size(g.num_edges)
    ra, rb = g.rank_endpoints(pad_to=m_pad)
    vmin0 = np.full(n_pad, INT32_MAX, dtype=np.int32)
    vmin0[: g.num_nodes] = g.first_ranks
    return vmin0, ra, rb, trs.host_level1(vmin0, ra, rb)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _same(got, want):
    """Tensors, ints and (nested) tuples of them, element for element; the
    port's uint8 masks against JAX's bool ones."""
    if isinstance(got, (tuple, list)):
        if not isinstance(want, (tuple, list)):
            want = [int(x) for x in np.asarray(want)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g.astype(bool) if w.dtype == bool else g, w)
    else:
        assert int(got) == int(want), (got, want)


def _same_solve(got, want, graph=None):
    _same(tuple(got), tuple(want))
    if graph is not None:
        np.testing.assert_array_equal(trs.fetch_mst_edge_ids(graph, got[0]),
                                      rank_oracle_edge_ids(graph))


def _calls(monkeypatch, names):
    """Record each call of the port's ``names`` as ``(name, result)``."""
    log = []
    for name in names:
        fn = getattr(trs, name)

        def spy(*a, _name=name, _fn=fn, **k):
            out = _fn(*a, **k)
            log.append((_name, out))
            return out

        monkeypatch.setattr(trs, name, spy)
    return log


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pad,m_pad", [
    (1024, 12288), (1024, 1536), (1 << 20, 1 << 24), (1 << 21, 1 << 25), (1 << 24, 1 << 29),
    (1 << 25, 1 << 30), (1 << 24, 3 << 28)])
def test_prefix_plan_matches_jax(n_pad, m_pad):
    assert trs._prefix_plan(n_pad, m_pad) == jrs._prefix_plan(n_pad, m_pad)
    for mult in (1, 2, 4):
        assert trs._prefix_size(n_pad, m_pad, mult) == jrs._prefix_size(n_pad, m_pad, mult)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_filtered_heads_match_jax(name):
    tg = _pair(name)[1]
    vmin0, ra, rb, parent1 = _host(tg)
    prefix = 2 * vmin0.size
    got = trs._filtered_head(*_t(vmin0, ra, rb, parent1), prefix=prefix)
    _same(got, tuple(jrs._filtered_head(*_j(vmin0, ra, rb, parent1), prefix=prefix)))
    # JAX's production head from its prep's host level 2: the same head.
    jprep = jrs.prepare_rank_arrays_filtered(_pair(name)[0])
    jhead = jrs._filtered_head_l2(*_j(vmin0, ra, rb), *jprep[4:6], prefix=prefix)
    assert jprep[6] == prefix
    _same(got, tuple(jhead))


def _after_prefix(name):
    """The vertex partition after the prefix's levels (a filtered solve
    with nothing past the prefix), and the port's rank endpoints."""
    tg = _pair(name)[1]
    vmin0, ra, rb, parent1 = _host(tg)
    prefix = tb._bucket_size(vmin0.size)
    ra_p, rb_p = ra.copy(), rb.copy()
    ra_p[prefix:] = rb_p[prefix:] = 0  # the prefix alone
    _, fragment, _ = trs.solve_rank_filtered(*_t(vmin0, ra_p, rb_p), parent1=torch.tensor(parent1))
    return fragment.numpy(), ra, rb, prefix


@pytest.mark.parametrize("name", ["rmat10", "clique"])
def test_filter_pieces_match_jax(name):
    fragment, ra, rb, prefix = _after_prefix(name)
    ends = trs._filter_suffix_ends(*_t(fragment, ra, rb), prefix=prefix)
    _same(ends, tuple(jrs._filter_suffix_ends(*_j(fragment, ra, rb), prefix=prefix)))
    count = int(ends[2])
    assert 0 < count < ra.size - prefix
    for out_size in (count, tb._bucket_size(count) + 7, count // 2):
        got = trs._filter_compact(*ends[:2], prefix, out_size=out_size)
        _same(got, tuple(jrs._filter_compact(*_j(*ends[:2]), prefix, out_size=out_size)))
        got = trs._filter_suffix_fused(*_t(fragment, ra, rb), prefix=prefix, out_size=out_size)
        want = jrs._filter_suffix_fused(*_j(fragment, ra, rb), prefix=prefix, out_size=out_size)
        _same(got, tuple(want))
        assert all(t.dtype == torch.int32 for t in got[:3])


@pytest.mark.parametrize("chunk_ranks", [1 << 30, 4096, 1000, 333])
def test_filter_suffix_chunked_matches_jax(monkeypatch, chunk_ranks):
    """One chunk, chunks that divide the suffix, and chunk counts that do
    not (the last chunk moved back and its overlap masked)."""
    _set(monkeypatch, _FILTER_CHUNK_RANKS=chunk_ranks)
    fragment, ra, rb, prefix = _after_prefix("clique")
    got = trs._filter_suffix_chunked(*_t(fragment, ra, rb), prefix)
    want = jrs._filter_suffix_chunked(*_j(fragment, ra, rb), prefix)
    _same(got[:3], tuple(want[:3]))
    assert got[3] == want[3] > 0
    fused = trs._filter_suffix_fused(*_t(fragment, ra, rb), prefix=prefix, out_size=got[0].numel())
    _same(got, fused)


def test_filter_suffix_chunked_with_no_survivors_matches_jax():
    fragment, ra, rb, _ = _after_prefix("rmat10")
    n = fragment.size
    got = trs._filter_suffix_chunked(torch.zeros(n, dtype=torch.int32), *_t(ra, rb), 512)
    assert got == (None, None, None, 0)
    assert jrs._filter_suffix_chunked(jnp.zeros(n, jnp.int32), *_j(ra, rb), 512)[3] == 0


@pytest.mark.parametrize("census", [BIG_CENSUS, SMALL_CENSUS])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_filtered_route_matches_jax_from_its_prep(monkeypatch, census, name):
    """The filter route's one prep holds JAX's filtered prep's arrays, but
    its level 2 (JAX stages ``parent1`` under the census size only), and is
    cached; the route's solve from it is JAX's from its own prep."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=census)
    jg, tg = _pair(name)
    got = trs.prepare_rank_arrays_full(tg, device=CPU)
    want = jrs.prepare_rank_arrays_filtered(jg)
    assert (want[3] is None) == (census == SMALL_CENSUS)
    _same(got[:3], tuple(want[:3]))
    if want[3] is not None:
        _same(got[3], want[3])
    _same(got[3], trs.host_level1(*(t.numpy() for t in got[:3])))
    solve = trs.make_production_solver(tg, device=CPU)
    assert trs.prepare_rank_arrays_full(tg, device=CPU) is got  # cached
    _same_solve(solve(), jrs.make_production_solver(jg)(), tg)


def _isolated_zero(edge_mod, gen):
    """3,000 random edges over vertices 1-299: vertex 0 has no edge, and
    the 3,072 padded ranks hold 72 pad ranks (``ra == rb == 0``), which must
    not reach vertex 0's first rank."""
    rng = np.random.default_rng(7)
    a, b = rng.integers(1, 300, (2, 3_200))
    g = edge_mod.Graph.from_arrays(300, a, b, rng.integers(1, 1_000, a.size))
    return edge_mod.Graph.from_arrays(300, g.u[:3_000], g.v[:3_000], g.w[:3_000])


def _edgeless_inside(edge_mod, gen):
    """RMAT-10 with every edge of vertices 137 and 1,023 (the last) cut:
    two vertices below ``n`` with no edge."""
    g = gen.rmat_graph(10, 16, seed=3)
    keep = ~np.isin(g.u, (137, 1023)) & ~np.isin(g.v, (137, 1023))
    return edge_mod.Graph.from_arrays(1024, g.u[keep], g.v[keep], g.w[keep])


def _one_hub(edge_mod, gen):
    """Every vertex's lightest edge goes to vertex 0, so level 1 leaves one
    fragment and level 2 hooks nothing; 2,000 heavier edges among the
    others."""
    rng = np.random.default_rng(5)
    a, b = rng.integers(1, 200, (2, 2_000))
    u = np.concatenate([np.zeros(199, dtype=np.int64), a])
    v = np.concatenate([np.arange(1, 200), b])
    w = np.concatenate([rng.integers(1, 10, 199), rng.integers(100, 1_000, a.size)])
    return edge_mod.Graph.from_arrays(200, u, v, w)


#: Dense graphs at the edges of the device levels' input.
EDGE_CASES = {"isolated-zero": _isolated_zero, "edgeless-inside": _edgeless_inside,
              "one-hub": _one_hub}


def _host_levels(g, prefix: int):
    """``(vmin0, parent1, fragment2, marks)`` as the host passes compute
    them (the native first ranks padded, :func:`host_level1`, and the JAX
    package's host level 2 over ranks ``[0, prefix)``): the two-level
    partition and the sorted ranks levels 1 and 2 mark, for the device
    levels to equal."""
    vmin0, ra, rb, parent1 = _host(g)
    fragment2, l2r = jrs.host_level2(parent1, ra, rb, prefix)
    return vmin0, parent1, fragment2, np.union1d(vmin0[vmin0 < INT32_MAX], l2r)


def _same_level2(head, want):
    """A head's ``(fragment, mst, ...)`` against :func:`_host_levels`: the
    partition and the marked ranks."""
    _same(head[0], want[2])
    np.testing.assert_array_equal(np.nonzero(head[1].numpy())[0], want[3])


@pytest.mark.parametrize("census", [BIG_CENSUS, SMALL_CENSUS])
@pytest.mark.parametrize("name", list(GRAPHS) + list(EDGE_CASES))
def test_filtered_prep_device_levels_equal_the_host_passes(monkeypatch, census, name):
    """The filter route's device levels (K6 and K1's torch forms here): the
    prep's first ranks and level 1, and level 2 in the head over the prefix
    the unhooked solve runs first (the speculative program's under the
    census size, :func:`_prefix_plan`'s from it up), equal the host passes
    element for element, in both regimes, and JAX's prep; the solve gives
    the oracle's forest."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=census)
    make = GRAPHS.get(name) or EDGE_CASES[name]
    tg = make(tedge, tgen)
    vmin0, ra, rb, parent1 = trs.prepare_rank_arrays_full(tg, device=CPU)
    n_pad, m_pad = vmin0.shape[0], ra.shape[0]
    prefix = (trs._prefix_size(n_pad, m_pad, 2) if census == BIG_CENSUS
              else trs._prefix_plan(n_pad, m_pad)[0])
    assert 2 * prefix <= m_pad
    head = trs._filtered_head(vmin0, ra, rb, parent1, prefix=prefix)
    want = _host_levels(tg, prefix)
    _same((vmin0, parent1), want[:2])
    _same_level2(head, want)
    if name == "isolated-zero":
        assert ra.shape[0] > tg.num_edges and int(vmin0[0]) == INT32_MAX
    elif name == "edgeless-inside":
        assert (vmin0[[137, 1023]] == INT32_MAX).all() and tg.num_nodes == 1024
    elif name == "one-hub":
        assert (head[0][: tg.num_nodes] == 0).all() and int(head[4][0]) == 1  # no level 2
    jg = make(jedge, jgen)
    jwant = jrs.prepare_rank_arrays_filtered(jg)
    assert jwant[6] == prefix
    _same((vmin0, ra, rb, head[0]), (*jwant[:3], jwant[4]))
    if jwant[3] is not None:
        _same(parent1, jwant[3])
    np.testing.assert_array_equal(tapi.minimum_spanning_forest(tg, device=CPU).edge_ids,
                                  rank_oracle_edge_ids(tg))


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_first_rank_plain_version_equals_the_host_pass(name):
    """``kernels.first_rank`` (its torch form on the CPU) against
    ``first_ranks_of``, NumPy and native, over the first ``m`` ranks; pad
    ranks past ``m`` and pad vertices stay out."""
    from distributed_ghs_implementation_tpu_torch.ops import kernels

    g = EDGE_CASES[name](tedge, tgen)
    n, m = g.num_nodes, g.num_edges
    ra, rb = g.rank_endpoints(pad_to=tb._bucket_size(m))
    got = kernels.first_rank(*_t(ra, rb), m, tb._bucket_size(n)).numpy()
    for native in (True, False):
        np.testing.assert_array_equal(got[:n], tedge.first_ranks_of(n, ra[:m], rb[:m],
                                                                    native=native))
    assert (got[n:] == INT32_MAX).all()
    assert (kernels.first_rank(*_t(ra, rb), 0, 8).numpy() == INT32_MAX).all()


def _edgeless(edge_mod, gen):
    """Five vertices and no edge: one pad rank, nothing to hook."""
    none = np.zeros(0, dtype=np.int64)
    return edge_mod.Graph.from_arrays(5, none, none, none)


@pytest.mark.parametrize("route", ["full", "l2"])
@pytest.mark.parametrize("name", ["rmat10", "isolated-zero", "edgeless-inside", "one-hub",
                                  "edgeless"])
def test_full_and_l2_preps_equal_the_host_passes(route, name):
    """The full route's and the host-L2 route's prep (one prep) runs the
    device levels, and the host-L2 route's head its level 2 over every
    rank: element for element the host passes, and JAX's preps."""
    make = {**GRAPHS, **EDGE_CASES, "edgeless": _edgeless}[name]
    tg, jg = make(tedge, tgen), make(jedge, jgen)
    want = _host_levels(tg, tg.num_edges)
    got = trs.prepare_rank_arrays_full(tg, device=CPU)
    _same((got[0], got[3]), want[:2])
    if route == "full":
        _same(got, tuple(jrs.prepare_rank_arrays_full(jg)))
    else:
        head = trs._rank_head(*got, compact_after=2)
        _same_level2(head, want)
        jwant = jrs.prepare_rank_arrays_l2(jg)
        _same((*got[:3], head[0]), tuple(jwant[:4]))


def test_filtered_route_under_the_filter_width_matches_jax(monkeypatch):
    """Under the filter width the dense graph takes no filter step: the
    prep is JAX's filtered prep's full one, and the solve JAX's."""
    _set(monkeypatch, _FILTER_MIN_RANKS=1 << 23)
    log = _calls(monkeypatch, _ROUTE_STEPS)
    jg, tg = _pair("rmat10")
    want = jrs.prepare_rank_arrays_filtered(jg)
    assert want[4:6] == (None, None)
    _same(trs.prepare_rank_arrays_full(tg, device=CPU), tuple(want[:4]))
    _same_solve(trs.make_production_solver(tg, device=CPU)(), jrs.make_production_solver(jg)(),
                tg)
    assert not {"_filtered_head", "solve_rank_filtered"} & {step for step, _ in log}


# ---------------------------------------------------------------------------
# The routes, through make_production_solver / solve_rank_auto
# ---------------------------------------------------------------------------


_ROUTE_STEPS = ("solve_rank_filtered_speculative", "_filtered_speculative_program",
                "solve_rank_filtered", "_filter_suffix_fused", "_filter_suffix_ends",
                "_filter_suffix_chunked", "solve_rank_staged", "_filtered_head")


def _production(monkeypatch, name):
    log = _calls(monkeypatch, _ROUTE_STEPS)
    jg, tg = _pair(name)
    got = trs.make_production_solver(tg, device=CPU)()
    _same_solve(got, jrs.make_production_solver(jg)(), tg)
    return [step for step, _ in log], dict(log)


@pytest.mark.parametrize("name", ["rmat10", "rmat11"])
def test_speculative_program_accepted_from_parent1(monkeypatch, name):
    """The production route's speculative program, its head's level 2 from
    the prep's ``parent1``, answers as JAX's from its host level 2."""
    steps, out = _production(monkeypatch, name)
    assert steps[-1] == "solve_rank_filtered_speculative" and out[steps[-1]] is not None
    assert steps[0] == "_filtered_head" and "_filtered_speculative_program" in steps
    assert "solve_rank_filtered" not in steps


def test_speculative_program_accepted_from_the_device_head(monkeypatch):
    """No host level 2: ``solve_rank_auto`` from ``parent1`` alone."""
    log = _calls(monkeypatch, _ROUTE_STEPS)
    vmin0, ra, rb, parent1 = _host(_pair("rmat10")[1])
    got = trs.solve_rank_auto(*_t(vmin0, ra, rb), family="dense", parent1=torch.tensor(parent1))
    want = jrs.solve_rank_auto(*_j(vmin0, ra, rb), family="dense", parent1=jnp.asarray(parent1))
    _same_solve(got, want)
    steps = [step for step, _ in log]
    assert "_filtered_speculative_program" in steps and "solve_rank_filtered" not in steps


def test_speculative_program_mispredicted_then_the_filtered_solve(monkeypatch):
    """The clique's filter survivors overflow the program's width: it
    answers ``None``, and ``solve_rank_filtered`` runs from ``parent1``
    with its own head over its own prefix, its fused filter overflowing to
    the two-step filter."""
    steps, out = _production(monkeypatch, "clique")
    assert out["solve_rank_filtered_speculative"] is None
    after = steps[steps.index("solve_rank_filtered_speculative") + 1:]
    assert after == ["_filtered_head", "_filter_suffix_fused", "_filter_suffix_ends",
                     "solve_rank_filtered"]


@pytest.mark.parametrize("widths", [dict(prefix_out=8), dict(out_size=8)])
def test_speculative_program_answers_none_at_small_widths(widths):
    vmin0, ra, rb, parent1 = _host(_pair("rmat10")[1])
    assert trs.solve_rank_filtered_speculative(*_t(vmin0, ra, rb, parent1)[:3],
                                               parent1=torch.tensor(parent1), **widths) is None
    assert jrs.solve_rank_filtered_speculative(*_j(vmin0, ra, rb), parent1=jnp.asarray(parent1),
                                               **widths) is None


@pytest.mark.parametrize("name", list(GRAPHS))
def test_filtered_solve_from_parent1(monkeypatch, name):
    """From the census size up: ``solve_rank_filtered``, its head's level 2
    over ``_prefix_plan``'s prefix from the prep's ``parent1``, against
    JAX's from its host level 2; the fused filter, overflowing to the
    two-step one on the clique."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS)
    steps, _ = _production(monkeypatch, name)
    assert steps[0] == "_filtered_head" and steps[-1] == "solve_rank_filtered"
    assert "solve_rank_filtered_speculative" not in steps
    assert ("_filter_suffix_ends" in steps) == (name == "clique")


@pytest.mark.parametrize("name", ["rmat11", "clique"])
def test_filtered_solve_from_the_device_head(monkeypatch, name):
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS)
    vmin0, ra, rb, parent1 = _host(_pair(name)[1])
    got = trs.solve_rank_filtered(*_t(vmin0, ra, rb), parent1=torch.tensor(parent1))
    want = jrs.solve_rank_filtered(*_j(vmin0, ra, rb), parent1=jnp.asarray(parent1))
    _same_solve(got, want)
    staged = trs.solve_rank_staged(*_t(vmin0, ra, rb))  # the same forest, other level counts
    _same(got[:2], staged[:2])


def test_filtered_solve_with_a_census_chain(monkeypatch):
    """Census shrinks inside the filtered solve's finishes."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS, _SHRINK_MIN_SPACE=64,
         _ONE_SHOT_MAX_SLOTS=0)
    shrinks = _calls(monkeypatch, ["_shrink_and_run"])
    _production(monkeypatch, "rmat11")
    assert len(shrinks) >= 2


@pytest.mark.parametrize("chunk_ranks", [4096, 1000])
@pytest.mark.parametrize("name", ["rmat11", "clique"])
def test_filtered_solve_with_the_chunked_filter(monkeypatch, name, chunk_ranks):
    """Above ``_FILTER_CHUNK_BYTES`` the prefix is the mult-2 one and the
    filter runs in chunks, whether or not they divide the suffix."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS, _FILTER_CHUNK_BYTES=1024,
         _FILTER_CHUNK_RANKS=chunk_ranks)
    jg, tg = _pair(name)
    n_pad, m_pad = tb._bucket_size(tg.num_nodes), tb._bucket_size(tg.num_edges)
    prefix, force_chunked = trs._prefix_plan(n_pad, m_pad)
    assert (prefix, force_chunked) == (trs._prefix_size(n_pad, m_pad, 2), True)
    chunks = -(-(m_pad - prefix) // chunk_ranks)
    if chunk_ranks == 1000:  # the last chunk moves back
        assert (m_pad - prefix) % chunks
    steps, _ = _production(monkeypatch, name)
    assert "_filter_suffix_chunked" in steps and "_filter_suffix_fused" not in steps


def test_degenerate_split_runs_the_staged_solve(monkeypatch):
    """A prefix over half the ranks leaves too little suffix: the staged
    solve answers, and the speculative program declines."""
    log = _calls(monkeypatch, ["solve_rank_staged"])
    vmin0, ra, rb, parent1 = _host(_pair("rmat10")[1])
    assert 2 * trs._prefix_size(vmin0.size, ra.size, 8) > ra.size
    got = trs.solve_rank_filtered(*_t(vmin0, ra, rb), prefix_mult=8,
                                  parent1=torch.tensor(parent1))
    want = jrs.solve_rank_filtered(*_j(vmin0, ra, rb), prefix_mult=8,
                                   parent1=jnp.asarray(parent1))
    _same_solve(got, want)
    assert [step for step, _ in log] == ["solve_rank_staged"]
    assert trs.solve_rank_filtered_speculative(*_t(vmin0, ra, rb), prefix_mult=8) is None


def test_hooked_filter_route_under_the_census_size_matches_jax(monkeypatch):
    """Under the census size a hook selects the chunked filtered solve,
    whose prefix (``_prefix_plan``'s, mult 1 here) is not the speculative
    program's (mult 2), for which JAX's prep computed its host level 2:
    the port's head computes level 2 over the solve's own prefix, and every
    chunk state and the result are JAX's."""
    jg, tg = _pair("rmat10")
    n_pad, m_pad = tb._bucket_size(tg.num_nodes), tb._bucket_size(tg.num_edges)
    assert trs._prefix_plan(n_pad, m_pad)[0] != jrs.prepare_rank_arrays_filtered(jg)[6]
    log = _calls(monkeypatch, _ROUTE_STEPS)
    seen_t, seen_j = [], []
    got = trs.make_production_solver(tg, device=CPU)(on_chunk=_recorder(seen_t))
    want = jrs.make_production_solver(jg)(on_chunk=_recorder(seen_j))
    _same_solve(got, want, tg)
    assert [step for step, _ in log][0] == "_filtered_head"
    assert "solve_rank_filtered_speculative" not in [step for step, _ in log]
    assert len(seen_t) == len(seen_j) >= 2
    for (lt, ft, mt, ct), (lj, fj, mj, cj) in zip(seen_t, seen_j):
        assert (lt, ct) == (lj, cj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)


# ---------------------------------------------------------------------------
# Checkpoint states, resume, the public entry points
# ---------------------------------------------------------------------------


def _recorder(seen):
    def hook(level, fragment, mst, count):
        arr = (lambda t: t.numpy().copy()) if isinstance(fragment, torch.Tensor) else np.asarray
        seen.append((int(level), arr(fragment), arr(mst).astype(bool), int(count)))
    return hook


def test_filtered_on_chunk_states_match_jax(monkeypatch):
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS, _ONE_SHOT_MAX_SLOTS=0)
    vmin0, ra, rb, parent1 = _host(_pair("clique")[1])
    seen_t, seen_j = [], []
    got = trs.solve_rank_filtered(*_t(vmin0, ra, rb), parent1=torch.tensor(parent1),
                                  chunk_levels=1, on_chunk=_recorder(seen_t))
    want = jrs.solve_rank_filtered(*_j(vmin0, ra, rb), parent1=jnp.asarray(parent1),
                                   chunk_levels=1, on_chunk=_recorder(seen_j))
    _same_solve(got, want)
    assert len(seen_t) == len(seen_j) >= 4
    for (lt, ft, mt, ct), (lj, fj, mj, cj) in zip(seen_t, seen_j):
        assert (lt, ct) == (lj, cj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("wide", [False, True])
def test_resume_from_a_jax_on_chunk_state(monkeypatch, wide):
    """A JAX filtered solve's state after its first finish chunk, carried
    across as NumPy, finishes in the port where it finishes in JAX: by the
    staged path, or (``wide``, over ``_FILTER_CHUNK_BYTES``) by the
    chunked filter over every rank."""
    _set(monkeypatch, _CENSUS_MIN_SPACE=SMALL_CENSUS, _ONE_SHOT_MAX_SLOTS=0,
         _FILTER_CHUNK_RANKS=1000)
    vmin0, ra, rb, parent1 = _host(_pair("clique")[1])
    seen = []
    full = jrs.solve_rank_filtered(*_j(vmin0, ra, rb), parent1=jnp.asarray(parent1),
                                   chunk_levels=1, on_chunk=_recorder(seen))
    if wide:
        _set(monkeypatch, _FILTER_CHUNK_BYTES=8 * ra.size - 1)
    log = _calls(monkeypatch, ["_filter_suffix_chunked", "solve_rank_staged"])
    level, fragment, mask, _ = seen[1]
    state = (fragment, mask, level)
    got = trs.solve_rank_resume(*_t(vmin0, ra, rb), state)
    want = jrs.solve_rank_resume(*_j(vmin0, ra, rb), state)
    _same_solve(got, want)
    np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(full[0]))
    assert [step for step, _ in log] == (["_filter_suffix_chunked"] if wide
                                         else ["solve_rank_staged"])


def test_resume_wide_from_a_finished_state(monkeypatch):
    """Nothing alive: the resume returns the state as it was."""
    _set(monkeypatch, _FILTER_CHUNK_BYTES=1024)
    tg = _pair("rmat10")[1]
    vmin0, ra, rb, _ = _host(tg)
    mst, fragment, lv = trs.solve_rank_staged(*_t(vmin0, ra, rb))
    state = (fragment.numpy(), mst.numpy().astype(bool), lv)
    got = trs.solve_rank_resume(*_t(vmin0, ra, rb), state)
    _same_solve(got, jrs.solve_rank_resume(*_j(vmin0, ra, rb), state), tg)
    assert got[2] == lv


def test_auto_takes_the_filter_route_through_the_api(monkeypatch):
    """``minimum_spanning_forest`` and ``solve_graph`` (``auto``) on a dense
    graph over the lowered width: the filter route, equal to JAX's (here
    the speculative program mispredicts: 2,048 prefix slots are too few)."""
    route = _calls(monkeypatch, ["solve_rank_filtered_speculative"])
    jg = jgen.rmat_graph(13, 22, seed=5, use_native=False)
    tg = tgen.rmat_graph(13, 22, seed=5)
    assert tg.num_edges >= tb.ELL_AUTO_EDGE_THRESHOLD
    got = tapi.minimum_spanning_forest(tg, device=CPU)
    want = japi.minimum_spanning_forest(jg)
    np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    assert (got.num_levels, got.num_components) == (want.num_levels, want.num_components)
    np.testing.assert_array_equal(got.edge_ids, rank_oracle_edge_ids(tg))
    ids, frag, levels = tb.solve_graph(tg, device=CPU)
    np.testing.assert_array_equal(ids, got.edge_ids)
    np.testing.assert_array_equal(frag, tb.solve_graph(tg, strategy="rank", device=CPU)[1])
    assert levels == got.num_levels
    assert [out for _, out in route] == [None] * 3


@pytest.mark.parametrize("census,route", [(BIG_CENSUS, "filtered-speculative"),
                                          (SMALL_CENSUS, "filtered")])
def test_profile_phases_read_the_filter_route(monkeypatch, census, route):
    """The profiler reads the filter route off the solver's steps: the
    prefix finish, the filter and the survivors' finish make up the finish,
    and the staging's split is there."""
    from distributed_ghs_implementation_tpu_torch import profile_solve

    _set(monkeypatch, _CENSUS_MIN_SPACE=census)
    tg = _pair("rmat11")[1]
    phases = profile_solve._phases(tg, "rank", torch.device(CPU))
    assert phases["route"] == route
    assert phases["levels"] == tb.solve_graph(tg, strategy="rank", device=CPU)[2]
    assert phases["filter_steps"][0] in ("_filter_suffix_ends", "_filter_suffix_fused")
    assert phases["finish_s"] == pytest.approx(
        phases["prefix_finish_s"] + phases["filter_s"] + phases["survivor_finish_s"])
    split = phases["stage_split"]
    assert split["level1_s"] > 0 and split["rank_endpoints_s"] > 0
    assert split["pin_memory_s"] == 0  # no page locking on the CPU
    assert "rank_endpoints" not in tg.__dict__  # unwrapped after
