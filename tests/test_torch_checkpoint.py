"""The port's checkpoints against the JAX package's.

The file format is shared (npz keys ``fragment``, ``mst_ranks``, ``level``,
``fingerprint``; the ``.bak`` generation; the ``.sha256`` sidecar), so a
state captured at a chunk boundary by one package's
``make_production_solver(...)(on_chunk=...)`` (or its stepped solve's
``on_level``) and saved by that package resumes in the other, to the edge
ids and fragments of the uninterrupted solve, and the level count the
source package's own resume takes. Recovery (a torn primary to ``.bak``,
double corruption to a fresh solve, the warning of a degraded resume) and
the fingerprint guard behave the same in both.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu.models import boruvka as jb
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.utils import checkpoint as jck
from distributed_ghs_implementation_tpu.utils import resilience as jres
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.utils import checkpoint as tck
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import build_deck
from torch_pairs import CPU, FAMILIES, isolated, pair, set_both  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")

#: route -> (graph, rank-solver constants set on both sides). Census
#: shrinks from 64 vertices, and no one-shot finish, so that the chunks are
#: many and the hooks see replayed partitions.
ROUTES = {
    "dense-staged": ("rmat", {}),
    "filtered": ("rmat11", {"_FILTER_MIN_RANKS": 1024}),
    "filtered-host-l2": ("rmat11", {"_FILTER_MIN_RANKS": 1024, "_CENSUS_MIN_SPACE": 64}),
    "grid": ("grid", {}),
    "sparse": ("road", {}),
}
SMALL_CHUNKS = {"_SHRINK_MIN_SPACE": 64, "_ONE_SHOT_MAX_SLOTS": 0}


def _ids(graph, mst):
    """Sorted edge ids of a forest mask of either package."""
    if isinstance(mst, torch.Tensor):
        return tb.fetch_mst_edge_ids(graph, mst)
    return np.sort(graph.edge_id_of_rank(np.nonzero(np.asarray(mst))[0]))


def _host(a, n):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))[:n]


def _capture(side, graph, path, k, *, stepped=False):
    """Solve ``graph`` in package ``side`` uninterrupted, saving the state
    at its ``k``-th boundary (chunk, or stepped level) with that package's
    ``save_checkpoint``. Returns ``(ids, fragment, levels, boundaries)``."""
    ck = jck if side == "jax" else tck
    seen = []

    def save(level, fragment, mst):
        seen.append(int(level))
        if len(seen) == k:
            ck.save_checkpoint(path, fragment, mst, level, fingerprint=ck.graph_fingerprint(graph))

    if stepped:
        def on_level(level, fragment, mst, has, count, dt):
            save(level, fragment, mst)

        args = (jb.prepare_device_arrays(graph) if side == "jax"
                else tb.prepare_device_arrays(graph, device=CPU))
        solve = jb.solve_arrays_stepped if side == "jax" else tb.solve_arrays_stepped
        mst, fragment, levels = solve(*args, stepped_levels=None, on_level=on_level)
    else:
        solver = (jrs.make_production_solver(graph) if side == "jax"
                  else trs.make_production_solver(graph, device=CPU))
        mst, fragment, levels = solver(
            on_chunk=lambda level, fragment, mst, count: save(level, fragment, mst))
    assert len(seen) >= k, seen
    return _ids(graph, mst), _host(fragment, graph.num_nodes), int(levels), seen


def _resume(side, graph, path, strategy):
    if side == "jax":
        return jck.solve_graph_checkpointed(graph, path, strategy=strategy)
    return tck.solve_graph_checkpointed(graph, path, strategy=strategy, device=CPU)


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["er48", "rmat12", "road40", "forest23", "readme"])
def test_fingerprint_and_digest_match_jax_on_the_deck(name):
    from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
    from distributed_ghs_implementation_tpu.graphs import generators as jgen
    from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
    from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen

    jg, tg = build_deck(jedge, jgen, tedge, tgen)[name]
    assert tg.digest() == jg.digest()
    np.testing.assert_array_equal(tg.digest_words(), jg.digest_words())
    np.testing.assert_array_equal(tck.graph_fingerprint(tg), jck.graph_fingerprint(jg))
    assert tck.graph_fingerprint(tg).dtype == np.int64


@pytest.mark.parametrize("edges", [
    [(0, 1, 5), (1, 2, 3)],
    [(0, 1, 5.0), (1, 2, 3.5)],
    [(1, 0, 5), (2, 1, 3)],
])
def test_digest_keys_on_weights_type_and_canonical_edges(edges):
    from distributed_ghs_implementation_tpu import api as japi
    from distributed_ghs_implementation_tpu_torch import api as tapi

    tg, jg = tapi.Graph.from_edges(3, edges), japi.Graph.from_edges(3, edges)
    assert tg.digest() == jg.digest()
    ints = tapi.Graph.from_edges(3, [(0, 1, 5), (1, 2, 3)])
    assert (tg.digest() == ints.digest()) == (tg.w.dtype == ints.w.dtype)


# ---------------------------------------------------------------------------
# Across the packages, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_rank_checkpoint_resumes_across_packages(monkeypatch, tmp_path, route, direction, k):
    name, consts = ROUTES[route]
    set_both(monkeypatch, **SMALL_CHUNKS, **consts)
    jg, tg = pair(name)
    src, dst = direction.split("-to-")
    path = str(tmp_path / "state.npz")
    ids, fragment, levels, seen = _capture(src, jg if src == "jax" else tg, path, k)
    shutil.copy(path, path + ".own")
    shutil.copy(path + ".sha256", path + ".own.sha256")
    got = _resume(dst, jg if dst == "jax" else tg, path, "rank")
    own = _resume(src, jg if src == "jax" else tg, path + ".own", "rank")
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_array_equal(got[1], fragment)
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))
    # The resume runs the staged finish from the saved partition in both
    # packages: the level count is the source package's own resume's, and
    # off the filter route the uninterrupted solve's (on it, the staged
    # finish over every rank takes fewer levels than the prefix-then-filter
    # one it replaces).
    assert got[2] == own[2]
    np.testing.assert_array_equal(own[1], fragment)
    if not route.startswith("filtered"):
        assert got[2] == levels
    # The resumed solve saved its final state: the destination's own file.
    final = (jck if dst == "jax" else tck).load_checkpoint(path)
    assert final[2] == got[2] and np.asarray(final[1]).dtype == bool


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_stepped_checkpoint_resumes_across_packages(tmp_path, direction, k):
    jg, tg = pair("grid")
    src, dst = direction.split("-to-")
    path = str(tmp_path / "state.npz")
    ids, fragment, levels, _ = _capture(src, jg if src == "jax" else tg, path, k, stepped=True)
    got = _resume(dst, jg if dst == "jax" else tg, path, "stepped")
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_array_equal(got[1], fragment)
    assert got[2] == levels


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunk_boundaries_match_jax(monkeypatch, route):
    """The hook fires at JAX's ``(level, count)`` points with JAX's vertex
    partition and mask, census shrinks and replays included."""
    name, consts = ROUTES[route]
    set_both(monkeypatch, **SMALL_CHUNKS, **consts)
    jg, tg = pair(name)
    seen_j, seen_t = [], []

    def recorder(seen):
        def hook(level, fragment, mst, count):
            seen.append((int(level), int(count), _host(fragment, tg.num_nodes).copy(),
                         _host(mst, None).astype(bool).copy()))
        return hook

    jrs.make_production_solver(jg)(on_chunk=recorder(seen_j))
    trs.make_production_solver(tg, device=CPU)(on_chunk=recorder(seen_t))
    assert [s[:2] for s in seen_t] == [s[:2] for s in seen_j]
    assert len(seen_t) >= 2
    for (_, _, ft, mt), (_, _, fj, mj) in zip(seen_t, seen_j):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("strategy", ["rank", "stepped"])
@pytest.mark.parametrize("name", FAMILIES)
def test_checkpointed_solves_write_the_files_jax_writes(tmp_path, name, strategy):
    jg, tg = pair(name)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = jck.solve_graph_checkpointed(jg, pj, strategy=strategy)
    got = tck.solve_graph_checkpointed(tg, pt, strategy=strategy, device=CPU)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    for suffix in ("", ".bak"):
        with np.load(pt + suffix) as t, np.load(pj + suffix) as j:
            assert sorted(t.files) == sorted(j.files) == [
                "fingerprint", "fragment", "level", "mst_ranks"]
            for key in j.files:
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert os.path.exists(pt + suffix + ".sha256")


def test_auto_takes_the_rank_route_at_the_threshold_in_both(tmp_path, monkeypatch):
    jg, tg = pair("grid")
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "ELL_AUTO_EDGE_THRESHOLD", tg.num_edges)
    calls = []
    solver = trs.make_production_solver
    monkeypatch.setattr(trs, "make_production_solver",
                        lambda *a, **k: calls.append(1) or solver(*a, **k))
    got = tck.solve_graph_checkpointed(tg, str(tmp_path / "t.npz"), device=CPU)
    want = jck.solve_graph_checkpointed(jg, str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2] and calls == [1]
    with pytest.raises(ValueError, match="unknown strategy"):
        tck.solve_graph_checkpointed(tg, str(tmp_path / "x.npz"), strategy="ell", device=CPU)


# ---------------------------------------------------------------------------
# Saving live tensors
# ---------------------------------------------------------------------------


def test_a_save_copies_the_tensors_it_is_given(tmp_path):
    """The solve updates its tensors in place after the hook returns: what
    was saved is what they held at the save."""
    path = str(tmp_path / "live.npz")
    fragment = torch.arange(6, dtype=torch.int32)
    mask = torch.tensor([1, 0, 1, 0], dtype=torch.uint8)
    tck.save_checkpoint(path, fragment, mask, 3)
    fragment.zero_()
    mask.fill_(1)
    frag, mst, level = tck.load_checkpoint(path)
    assert frag.tolist() == list(range(6)) and frag.dtype == np.int32
    assert mst.tolist() == [True, False, True, False] and mst.dtype == bool
    assert level == 3
    assert jck.load_checkpoint(path)[2] == 3  # the JAX package reads it


# ---------------------------------------------------------------------------
# Recovery, in both packages
# ---------------------------------------------------------------------------


def _pkg(side):
    return (jck, jres, {}) if side == "jax" else (tck, tres, {"device": CPU})


@pytest.mark.parametrize("side", ["jax", "port"])
def test_torn_write_recovers_from_bak(tmp_path, side):
    ck, res, kw = _pkg(side)
    g = pair("road")[0 if side == "jax" else 1]
    fp = ck.graph_fingerprint(g)
    full = str(tmp_path / "full.npz")
    _, _, levels = ck.solve_graph_checkpointed(g, full, every=1, strategy="rank", **kw)
    last = ck.load_checkpoint(full, expect_fingerprint=fp)
    # The state at the first chunk boundary, a mid-solve one.
    first = str(tmp_path / "first.npz")
    _capture(side, g, first, 1)
    mid = ck.load_checkpoint(first, expect_fingerprint=fp)
    assert mid[2] < last[2] == levels
    # The mid-solve state saved, the next save torn: recovery resumes mid-solve.
    p = str(tmp_path / "torn.npz")
    ck.save_checkpoint(p, *mid, fingerprint=fp)
    with res.FAULTS.inject("checkpoint.save", times=1, kind="torn"):
        with pytest.raises(res.InjectedFault, match="torn"):
            ck.save_checkpoint(p, *last, fingerprint=fp)
    with pytest.raises(Exception):
        ck.load_checkpoint(p)
    state, source, notes = ck.load_checkpoint_resilient(p, expect_fingerprint=fp)
    assert state is not None and source == p + ".bak" and notes[0][0] == p
    assert state[2] == mid[2]
    with pytest.warns(RuntimeWarning, match="previous generation"):
        ids, _, resumed = ck.solve_graph_checkpointed(g, p, resume=True, strategy="rank", **kw)
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(pair("road")[1]))
    assert resumed == levels
    with warnings.catch_warnings():  # a clean resume stays silent
        warnings.simplefilter("error")
        ck.solve_graph_checkpointed(g, p, resume=True, strategy="rank", **kw)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_double_corruption_falls_back_to_a_fresh_solve(tmp_path, side):
    ck, _, kw = _pkg(side)
    g = pair("grid")[0 if side == "jax" else 1]
    p = str(tmp_path / "dead.npz")
    ck.solve_graph_checkpointed(g, p, every=1, strategy="rank", **kw)
    for victim in (p, p + ".bak"):
        with open(victim, "wb") as f:
            f.write(b"\x00not-a-zip")
    state, source, notes = ck.load_checkpoint_resilient(p)
    assert state is None and source is None and len(notes) == 2
    with pytest.warns(RuntimeWarning, match="solving from scratch"):
        ids, _, _ = ck.solve_graph_checkpointed(g, p, resume=True, strategy="rank", **kw)
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(pair("grid")[1]))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_bit_flip_is_refused_before_parsing(tmp_path, side):
    ck, _, kw = _pkg(side)
    g = pair("rmat")[0 if side == "jax" else 1]
    p = str(tmp_path / "rot.npz")
    ck.solve_graph_checkpointed(g, p, every=1, strategy="stepped", **kw)
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    state, source, notes = ck.load_checkpoint_resilient(p)
    assert source == p + ".bak" and notes[0][1].startswith("IntegrityError")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_a_checkpoint_of_another_graph_is_refused(tmp_path, direction):
    src, dst = direction.split("-to-")
    p = str(tmp_path / "fp.npz")
    _resume(src, pair("grid")[0 if src == "jax" else 1], p, "rank")
    other = pair("road")[0 if dst == "jax" else 1]
    ck = jck if dst == "jax" else tck
    with pytest.raises(ck.CheckpointMismatch, match="different graph"):
        _resume(dst, other, p, "rank")


def test_a_torn_primary_is_dropped_not_rotated(tmp_path):
    p = str(tmp_path / "rot.npz")
    tck.save_checkpoint(p, np.arange(4, dtype=np.int32), np.zeros(8, bool), 1)
    with tres.FAULTS.inject("checkpoint.save", times=1, kind="torn"):
        with pytest.raises(tres.InjectedFault):
            tck.save_checkpoint(p, np.arange(4, dtype=np.int32), np.ones(8, bool), 2)
    tck.save_checkpoint(p, np.arange(4, dtype=np.int32), np.ones(8, bool), 3)
    assert tck.load_checkpoint(p)[2] == 3
    assert tck.load_checkpoint(p + ".bak")[2] == 1


def test_the_port_registry_alone_arms_the_ports_save(tmp_path):
    """Arming the JAX package's ``checkpoint.save`` leaves the port's save
    alone, and the other way round: two registries."""
    p = str(tmp_path / "two.npz")
    with jres.FAULTS.inject("checkpoint.save", times=1):
        tck.save_checkpoint(p, np.arange(4, dtype=np.int32), np.zeros(8, bool), 1)
        assert jres.FAULTS.armed("checkpoint.save")
    with tres.FAULTS.inject("checkpoint.save", times=1):
        jck.save_checkpoint(p, np.arange(4, dtype=np.int32), np.zeros(8, bool), 2)
        assert tres.FAULTS.armed("checkpoint.save")
    assert tck.load_checkpoint(p)[2] == 2


def test_sharded_checkpointing_is_not_ported(tmp_path):
    """Sharded checkpointing is ported: the checkpointed sharded solve of
    each package (JAX on its 8-device CPU mesh, the port on 8 CPU shards)
    gives the same forest and writes the same final file, and a second
    call resumes from the other package's file to the same answer."""
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    mesh = edge_mesh(num_shards=8, device=CPU)
    for name in ("rmat", "road"):
        jg, tg = pair(name)
        pj, pt = str(tmp_path / f"{name}-j.npz"), str(tmp_path / f"{name}-t.npz")
        want = jck.solve_graph_checkpointed_sharded(jg, pj)
        got = tck.solve_graph_checkpointed_sharded(tg, pt, mesh=mesh)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tck.load_checkpoint(pt), jck.load_checkpoint(pj)):
            np.testing.assert_array_equal(a, b)
        # Each package resumes the other's converged checkpoint.
        for a, b in zip(tck.solve_graph_checkpointed_sharded(tg, pj, mesh=mesh), want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jck.solve_graph_checkpointed_sharded(jg, pt), want):
            np.testing.assert_array_equal(a, b)


def test_checkpointed_solve_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for g in (pair("rmat")[1], tb.Graph.from_edges(2, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tck.solve_graph_checkpointed(g, str(tmp_path / "c.npz"))
    ids, frag, levels = tck.solve_graph_checkpointed(tb.Graph.from_edges(2, []),
                                                     str(tmp_path / "c.npz"), device=CPU)
    assert ids.size == 0 and frag.tolist() == [0, 1] and levels == 0
