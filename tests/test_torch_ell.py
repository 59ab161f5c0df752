"""The PyTorch port's ELL solve and its two kernels (K3 ``ell_row_min``, per
bucket and per level, and K5 ``gather``) against the JAX package,
element-exact (all state is integer: tolerance 0).

The port runs with ``device="cpu"``, so its wrappers take their plain
versions. The JAX side runs on the CPU, its Pallas kernels in interpret
mode: ``fused_ell_row_min`` directly, ``solve_graph(strategy="ell",
kernel="pallas")`` through the solver, and the gather tool's own kernel body
through ``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs.
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.models import boruvka as jb
from distributed_ghs_implementation_tpu.ops import pallas_kernels as pk
from distributed_ghs_implementation_tpu_torch import gather_probe, profile_solve
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import DECK, RMAT18_BUCKETS, build_deck, ell_bucket_set, ell_inputs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import test_pallas_gather as gather_tool  # noqa: E402  (the JAX package's gather tool)

CPU = "cpu"
INT32_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_same_result(got, want):
    """``(edge_ids, fragment, levels)`` equal."""
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[2] == want[2]


@pytest.fixture(autouse=True)
def _fresh_kernel_selection():
    """No sticky Pallas fallback or default from another test: a request
    for ``kernel="pallas"`` must really run the interpreted kernels."""
    pk._reset_for_tests()
    yield
    pk._reset_for_tests()


@pytest.fixture(scope="module")
def deck():
    return build_deck(jedge, jgen, tedge, tgen)


# ---------------------------------------------------------------------------
# K3 ell_row_min
# ---------------------------------------------------------------------------
def _check_ell_row_min(fragment, verts, dstb, rankb):
    jargs = [jnp.asarray(a) for a in (fragment, verts, dstb, rankb)]
    assert pk.ell_shape_ok(fragment.shape[0], *dstb.shape)
    want_pallas = pk.fused_ell_row_min(*jargs)
    fv = jargs[0][jargs[1]]
    fd = jargs[0][jargs[2]]
    want_xla = jnp.min(jnp.where(fd != fv[:, None], jargs[3], INT32_MAX), axis=1)
    args = [_t(a) for a in (fragment, verts, dstb, rankb)]
    for got in (kernels.ell_row_min_torch(*args), kernels.ell_row_min(*args)):
        assert got.dtype == torch.int32 and got.shape == (dstb.shape[0],)
        _eq(got, want_pallas)
        _eq(got, want_xla)
    return want_xla


@pytest.mark.parametrize("width", [1, 2, 8, 32, 64, 1024])
def test_ell_row_min_matches_pallas_and_xla(width):
    rows = max(2, 4096 // width)
    _check_ell_row_min(*ell_inputs(width, 500, rows, width))


def test_ell_row_min_pad_rows_read_int32_max():
    n, rows, width = 64, 16, 4
    got = _check_ell_row_min(
        np.arange(n, dtype=np.int32), np.zeros(rows, np.int32),
        np.zeros((rows, width), np.int32), np.full((rows, width), INT32_MAX, np.int32))
    assert (np.asarray(got) == INT32_MAX).all()


def test_ell_row_min_one_row_bucket():
    fragment, verts, dstb, rankb = ell_inputs(5, 300, 2, 512)
    _check_ell_row_min(fragment, verts[:1], dstb[:1], rankb[:1])


# ---------------------------------------------------------------------------
# K3 over a whole level: the plan's tiles and ell_level_min
# ---------------------------------------------------------------------------
def _tile_spans(shapes, tile_slots):
    """Each tile as the level kernel decodes it (``csrc/ell_row_min.cu``:
    the bucket by a scan of first tiles, then rows and columns):
    ``(bucket, r0, r1, c0, c1)``."""
    tiling, tiles = kernels.ell_tiling(shapes, tile_slots)
    for tile in range(tiles):
        k = 0
        while k + 1 < len(shapes) and tile >= tiling[k + 1][0]:
            k += 1
        first, per_tile, seg, chunks = tiling[k]
        rows, width = shapes[k]
        local = tile - first
        r0, c0 = local // chunks * per_tile, local % chunks * seg
        yield k, r0, min(rows, r0 + per_tile), c0, min(width, c0 + seg)


ODD_SHAPES = [(3, 7), (0, 5), (5, 33), (1, 1), (7, 600), (2, 5000), (9, 4097), (4, 1)]


@pytest.mark.parametrize("shapes,tile_slots", [
    (RMAT18_BUCKETS, kernels.ELL_TILE_SLOTS), (RMAT18_BUCKETS, 1000), (ODD_SHAPES, 64),
    (ODD_SHAPES, kernels.ELL_TILE_SLOTS), (ODD_SHAPES, 1),
])
def test_ell_plan_tiles_cover_every_slot_once(shapes, tile_slots):
    """Every slot of every bucket in exactly one tile, no tile across two
    buckets or above ``tile_slots`` slots, and a row wider than a tile in
    ceil(W / tile_slots) chunks."""
    cover = [np.zeros((rows, width), np.uint8) for rows, width in shapes]
    chunks_of_row = [np.zeros(rows, np.int64) for rows, _ in shapes]
    for k, r0, r1, c0, c1 in _tile_spans(shapes, tile_slots):
        assert 0 <= r0 < r1 <= shapes[k][0] and 0 <= c0 < c1 <= shapes[k][1]
        assert (r1 - r0) * (c1 - c0) <= tile_slots
        cover[k][r0:r1, c0:c1] += 1
        chunks_of_row[k][r0:r1] += 1
    for (rows, width), c, per_row in zip(shapes, cover, chunks_of_row):
        assert (c == 1).all()
        want = 1 if width <= tile_slots else -(-width // tile_slots)
        assert (per_row == want).all()
    tiling, tiles = kernels.ell_tiling(shapes, tile_slots)
    assert tiles == sum(1 for _ in _tile_spans(shapes, tile_slots))
    assert [t[0] for t in tiling] == sorted(t[0] for t in tiling)


def test_ell_plan_tiles_rmat18_evenly():
    """RMAT-18's level at the default tile: every tile but a bucket's last
    holds exactly ``ELL_TILE_SLOTS`` slots."""
    tiling, tiles = kernels.ell_tiling(RMAT18_BUCKETS)
    sizes = [(r1 - r0) * (c1 - c0) for _, r0, r1, c0, c1 in
             _tile_spans(RMAT18_BUCKETS, kernels.ELL_TILE_SLOTS)]
    slots = sum(r * w for r, w in RMAT18_BUCKETS)
    assert sum(sizes) == slots == 17_104_896
    assert tiles == len(sizes) and sizes.count(kernels.ELL_TILE_SLOTS) >= len(sizes) - 15
    assert tiling[-1][3] == 32768 // kernels.ELL_TILE_SLOTS  # the hub row's chunks


def test_ell_plan_keeps_the_buckets_and_lays_out_the_descriptors():
    fragment, buckets = ell_bucket_set(1, 300, [(4, 2), (2, 100)])
    tensors = [tuple(_t(a) for a in b) for b in buckets]
    plan = kernels.ell_plan(tensors, tile_slots=64)
    assert plan.device is None and plan.tiles == 1 + 2 * 2
    assert plan.desc.dtype == torch.int64
    assert plan.desc.shape == (2, len(kernels.ELL_FIELDS)) == (2, 9)
    first = dict(zip(kernels.ELL_FIELDS, plan.desc[1].tolist()))
    assert first["verts"] == tensors[1][0].data_ptr() and first["rankb"] == tensors[1][2].data_ptr()
    assert (first["rows"], first["width"], first["first_tile"]) == (2, 100, 1)
    assert (first["rows_per_tile"], first["seg"], first["chunks"]) == (1, 64, 2)
    assert all(a is b for pb, b in zip(plan.buckets, tensors) for a, b in zip(pb, b))


def test_ell_plan_refuses_what_one_launch_cannot_take():
    one = tuple(_t(a) for a in ell_inputs(0, 10, 2, 2)[1:])
    with pytest.raises(ValueError, match="at most 32"):
        kernels.ell_plan([one] * 33)
    with pytest.raises(ValueError, match="dstb/rankb"):
        kernels.ell_plan([(one[0], one[1], one[2][:, :1])])
    with pytest.raises(ValueError, match="tile_slots"):
        kernels.ell_plan([one], tile_slots=0)
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.ell_plan([(meta, meta.view(8, 1), meta.view(8, 1))])
    plan = kernels.ell_plan([one])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.ell_level_min(meta, plan, meta)
    assert len(kernels.ell_plan([one] * 32).buckets) == 32


def _jax_level_min(fragment, buckets):
    """The JAX package's per-level form: ``fused_ell_row_min`` (Pallas,
    interpret mode) per bucket, then ``vmin.at[verts].min(row_min)``."""
    frag = jnp.asarray(fragment)
    vmin = jnp.full(fragment.shape[0], INT32_MAX, dtype=jnp.int32)
    for verts, dstb, rankb in buckets:
        assert pk.ell_shape_ok(fragment.shape[0], *dstb.shape)
        row_min = pk.fused_ell_row_min(frag, *(jnp.asarray(a) for a in (verts, dstb, rankb)))
        vmin = vmin.at[jnp.asarray(verts)].min(row_min)
    return vmin


def _check_level_min(fragment, buckets, tile_slots):
    want = _jax_level_min(fragment, buckets)
    plan = kernels.ell_plan([tuple(_t(a) for a in b) for b in buckets], tile_slots=tile_slots)
    n = fragment.shape[0]
    for level_min in (kernels.ell_level_min_torch, kernels.ell_level_min):
        vmin = torch.full((n,), INT32_MAX, dtype=torch.int32)
        got = level_min(_t(fragment), plan, vmin)
        assert got is vmin
        _eq(got, want)
    return want


@pytest.mark.parametrize("shapes", [
    [(8, 1), (4, 2), (4, 8), (2, 64)],
    [(16, 4), (3, 40), (1, 130)],
    [(5, 33), (2, 70), (1, 1)],
])
def test_ell_level_min_matches_pallas_per_bucket_and_scatter(shapes):
    """Synthetic bucket sets: pad rows of vertex 0, a real row of vertex 0,
    all-INT32_MAX rows, widths above the tile (16 slots here)."""
    fragment, buckets = ell_bucket_set(len(shapes), 200, shapes)
    want = np.asarray(_check_level_min(fragment, buckets, tile_slots=16))
    assert want[0] < INT32_MAX  # the real vertex-0 row reached vmin[0]
    assert (want == INT32_MAX).any()


def test_ell_level_min_all_int32_max_leaves_vmin():
    fragment, buckets = ell_bucket_set(9, 64, [(4, 3), (2, 20)])
    for _, _, rankb in buckets:
        rankb[:] = INT32_MAX
    want = np.asarray(_check_level_min(fragment, buckets, tile_slots=8))
    assert (want == INT32_MAX).all()


@pytest.mark.parametrize("name", ["road40", "rmat12", "forest23"])
def test_ell_level_min_on_the_deck_at_a_premerged_partition(deck, name):
    """The deck's own buckets with vertices pre-merged in pairs (root = the
    even id), at the default tile and one of 4 slots."""
    jg, _ = deck[name]
    jbuckets, _, _, n_pad = jb.prepare_ell_arrays(jg)
    buckets = [tuple(np.asarray(a) for a in b) for b in jbuckets]
    fragment = (np.arange(n_pad) & ~1).astype(np.int32)
    for tile_slots in (kernels.ELL_TILE_SLOTS, 4):
        _check_level_min(fragment, buckets, tile_slots)


# ---------------------------------------------------------------------------
# K5 gather
# ---------------------------------------------------------------------------
def _tool_gather_interpret(table, idx, block):
    """The JAX tool's ``pallas_gather`` (``tools/test_pallas_gather.py:46-61``)
    with ``interpret=True``: its own kernel body and BlockSpecs."""
    lanes = 128
    rows = idx.shape[0] // lanes
    return pl.pallas_call(
        gather_tool.gather_kernel,
        grid=(rows // block,),
        in_specs=[
            pl.BlockSpec(table.shape, lambda i: (0,)),
            pl.BlockSpec((block, lanes), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((block, lanes), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, lanes), table.dtype),
        interpret=True,
    )(table, idx.reshape(rows, lanes)).reshape(-1)


@pytest.mark.parametrize("block", [2, 8])
def test_gather_matches_the_tools_kernel_and_take(block):
    rng = np.random.default_rng(block)
    table = rng.integers(0, 1 << 30, 1 << 10, dtype=np.int32)
    idx = rng.integers(0, 1 << 10, 8 * 128, dtype=np.int32)
    want = _tool_gather_interpret(jnp.asarray(table), jnp.asarray(idx), block)
    _eq(want, jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    for got in (kernels.gather_torch(_t(table), _t(idx)), kernels.gather(_t(table), _t(idx))):
        assert got.dtype == torch.int32
        _eq(got, want)


@pytest.mark.parametrize("m", [0, 1, 3, 1001])
def test_gather_any_length_matches_take(m):
    rng = np.random.default_rng(m)
    table = rng.integers(0, 1 << 30, 257, dtype=np.int32)
    idx = rng.integers(0, 257, m, dtype=np.int32)
    got = kernels.gather(_t(table), _t(idx))
    _eq(got, jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    _eq(got, torch.index_select(_t(table), 0, _t(idx)))


def test_gather_probe_checks_and_times_nothing_on_the_cpu():
    records = gather_probe.run(table_size=1 << 10, log_sizes=(4, 12), device=CPU)
    assert [r["m"] for r in records] == [16, 4096]
    assert all(r["match"] and r["kernel_ms"] is None and r["library_ms"] is None
               for r in records)


def test_gather_probe_raises_on_a_mismatch(monkeypatch):
    monkeypatch.setattr(kernels, "gather", lambda table, idx: kernels.gather_torch(table, idx) + 1)
    with pytest.raises(AssertionError, match="index 0"):
        gather_probe.run(table_size=1 << 8, log_sizes=(4,), device=CPU)


def test_new_wrappers_refuse_devices_they_have_no_kernel_for():
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.ell_row_min(meta, meta, meta.reshape(8, 1), meta.reshape(8, 1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.gather(meta, meta)
    before = [w.launches for w in kernels.WRAPPERS]
    kernels.ell_row_min(*(_t(a) for a in ell_inputs(0, 10, 4, 2)))
    kernels.gather(torch.arange(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    assert [w.launches for w in kernels.WRAPPERS] == before


# ---------------------------------------------------------------------------
# The ELL buckets
# ---------------------------------------------------------------------------
def _assert_same_buckets(tg, jg):
    got, want = tg.ell_buckets, jg.ell_buckets
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(DECK))
def test_ell_buckets_match_jax_on_the_deck(deck, name):
    jg, tg = deck[name]
    _assert_same_buckets(tg, jg)
    for verts, dstb, rankb in tg.ell_buckets:
        rows, width = dstb.shape
        assert rows & (rows - 1) == 0 and width & (width - 1) == 0
        assert (np.diff(rankb.astype(np.int64), axis=1) >= 0).all()  # rank order


@pytest.mark.parametrize("name", ["gnm", "line", "road_dead_ends"])
def test_ell_buckets_match_jax_on_more_generators(name):
    make = {
        "gnm": lambda g: g.gnm_random_graph(300, 900, seed=5),
        "line": lambda g: g.line_graph(17, weight=3),
        "road_dead_ends": lambda g: g.random_road_network(25, 30, seed=9, dead_end_prob=0.3),
    }[name]
    _assert_same_buckets(make(tgen), make(jgen))


def test_ell_staging_matches_jax(deck):
    jg, tg = deck["forest23"]
    buckets, ra, rb, n_pad = tb.prepare_ell_arrays(tg, device=CPU)
    jbuckets, jra, jrb, jn_pad = jb.prepare_ell_arrays(jg)
    assert n_pad == jn_pad
    _eq(ra, jra)
    _eq(rb, jrb)
    assert ra.dtype == torch.int32 and ra.shape[0] == tb._next_pow2(tg.num_edges)
    for got, want in zip(buckets, jbuckets):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            _eq(g, w)


# ---------------------------------------------------------------------------
# The slice: solve_graph(strategy="ell")
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(DECK))
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_ell_solve_matches_jax_on_the_deck(deck, name, kernel):
    jg, tg = deck[name]
    got = tb.solve_graph(tg, strategy="ell", device=CPU)
    assert pk.kernel_choice(kernel) == kernel
    _assert_same_result(got, jb.solve_graph(jg, strategy="ell", kernel=kernel))
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))
    _assert_same_result(got, tb.solve_graph(tg, strategy="fused", device=CPU))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_ell_level_from_a_premerged_partition(deck, kernel):
    """Vertices pre-merged in pairs (root = the even id): one ELL level on
    JAX's staged arrays, carried across, equals JAX's level."""
    jg, _ = deck["road40"]
    jbuckets, jra, jrb, n_pad = jb.prepare_ell_arrays(jg)
    fragment0 = (np.arange(n_pad) & ~1).astype(np.int32)
    m_pad = jra.shape[0]
    want = jb._ell_level(jnp.asarray(fragment0), jnp.zeros(m_pad, bool), jbuckets, jra, jrb,
                         kernel=kernel)
    buckets, ra, rb = tb.ell_arrays_from_numpy(
        [[np.asarray(a) for a in b] for b in jbuckets], np.asarray(jra), np.asarray(jrb),
        device=CPU)
    got = tb._ell_level(_t(fragment0), torch.zeros(m_pad, dtype=torch.uint8),
                        kernels.ell_plan(buckets), ra, rb)
    _eq(got[0], want[0])
    _eq(got[1].numpy().astype(bool), want[1])
    assert bool(got[2]) == bool(want[2])


def test_ell_solve_loop_counts_levels_like_jax(deck):
    jg, _ = deck["rmat12"]
    jbuckets, jra, jrb, n_pad = jb.prepare_ell_arrays(jg)
    want = jb._solve_ell(jbuckets, jra, jrb, num_nodes=n_pad)
    buckets, ra, rb = tb.ell_arrays_from_numpy(
        [[np.asarray(a) for a in b] for b in jbuckets], np.asarray(jra), np.asarray(jrb),
        device=CPU)
    got = tb.ell_solve_loop(buckets, ra, rb, num_nodes=n_pad)
    _eq(got[0].numpy().astype(bool), want[0])
    _eq(got[1], want[1])
    assert got[2] == int(want[2]) > 1


def test_ell_rank_zero_survives_padding_collisions():
    """Pad rows of vertex 0 and vertices without an MOE all scatter to rank
    0; the global minimum edge must stay in the forest."""
    u, v, w = np.array([10, 11, 12, 10]), np.array([11, 12, 13, 13]), np.array([1, 5, 2, 9])
    g = tedge.Graph.from_arrays(21, u, v, w)
    ids, frag, levels = tb.solve_graph(g, strategy="ell", device=CPU)
    assert g.edge_id_of_rank(np.array([0]))[0] in ids
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
    _assert_same_result((ids, frag, levels),
                        jb.solve_graph(jedge.Graph.from_arrays(21, u, v, w), strategy="ell"))


def test_profile_phases_split_an_ell_solve_on_the_cpu(deck):
    _, tg = deck["rmat12"]
    tg.ell_buckets  # cached by an earlier solve: the phase must rebuild them
    phases = profile_solve._phases(tg, "ell", torch.device(CPU))
    _, _, levels = tb.solve_graph(tg, strategy="ell", device=CPU)
    assert phases["levels"] == levels
    assert set(phases) == {"levels", "host_ell_buckets_s", "h2d_s", "level_loop_s",
                           "harvest_s", "total_s"}
