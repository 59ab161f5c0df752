"""The port's native host library against its NumPy forms and the JAX
package's, element-exact.

Each pass the port runs natively (the rank order, the rank endpoints, the
first ranks, level 2's first cross ranks, the RMAT generator) must equal the
port's own NumPy form of it and the JAX package's NumPy branch. The JAX
package's native library stays out of these tests: its ``get_lib`` is
patched to report no library. The JAX native generator's stream is pinned
by recorded fixtures instead.
"""

import hashlib
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import native as jnative
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.graphs import native
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from torch_inputs import build_deck

ROOT = Path(__file__).resolve().parent.parent
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _no_jax_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def _float_weighted(edge_mod, gen):
    g = gen.road_grid_graph(25, 31, seed=8)
    w = np.round(np.random.default_rng(8).random(g.num_edges) * 100, 2)
    return edge_mod.Graph.from_arrays(g.num_nodes, g.u, g.v, w)


def _wide_weights(edge_mod, gen):
    """Integer weights over more than 2^22 values: the counting sort
    declines them, in both packages."""
    g = gen.random_road_network(30, 30, seed=2)
    w = np.random.default_rng(2).integers(-(1 << 40), 1 << 40, g.num_edges)
    return edge_mod.Graph.from_arrays(g.num_nodes, g.u, g.v, w)


#: name -> maker(edgelist module, generators module): RMAT-13, a road grid,
#: float weights (no counting sort), a wide integer range, ties everywhere.
GRAPHS = {
    "rmat13": lambda e, g: g.rmat_graph(13, 16, seed=1),
    "grid": lambda e, g: g.road_grid_graph(40, 50, seed=2),
    "float": _float_weighted,
    "wide": _wide_weights,
    "ties": lambda e, g: e.Graph.from_arrays(
        300, *np.random.default_rng(4).integers(0, 300, (2, 4000)), np.ones(4000, np.int64)),
}


def _pairs():
    out = {name: (make(jedge, jgen), make(tedge, tgen)) for name, make in GRAPHS.items()}
    out.update(build_deck(jedge, jgen, tedge, tgen))
    return out


@pytest.fixture(scope="module")
def graphs():
    return _pairs()


NAMES = list(GRAPHS) + ["er48", "rmat12", "road40", "forest23", "readme"]


# ---------------------------------------------------------------------------
# The library
# ---------------------------------------------------------------------------


def test_the_source_is_the_jax_packages_code():
    """The port's copy differs only in its opening note."""
    def code(path):
        text = path.read_text()
        return text[text.index("#include"):]

    assert code(native.SOURCE) == code(ROOT / "native" / "graph_native.cpp")


def test_every_function_of_the_source_is_bound():
    exported = set(re.findall(r"^(?:void|int|int64_t) (\w+)\(", native.SOURCE.read_text(), re.M))
    assert exported == set(native.SIGNATURES)
    lib = native.get_lib()
    for name, (restype, argtypes) in native.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype == restype, name


def test_the_build_is_keyed_and_cached():
    path = native.build_library()
    assert path == native.library_path() and path.is_file()
    assert path.parent.parent == native.BUILD_ROOT
    mtime = path.stat().st_mtime_ns
    assert native.build_library() == path and path.stat().st_mtime_ns == mtime  # not rebuilt


def test_concurrent_builds_both_load(tmp_path):
    """Processes that build into an empty cache at once each load a whole
    library, and no temporary file is left behind."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from distributed_ghs_implementation_tpu_torch.graphs import native
        native.BUILD_ROOT = Path({str(tmp_path)!r})
        out = native.rmat_edges(8, 4, seed=1, a=0.57, b=0.19, c=0.19, weight_low=1,
                                weight_high=9)
        print(native.library_path(), out[0].size)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1  # the same library, the same graph
    lib_path = Path(lines.pop().split()[0])
    assert lib_path.is_file() and lib_path.parent.parent == tmp_path
    assert [p.name for p in lib_path.parent.iterdir()] == [native.LIB_NAME]


def test_a_failing_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed.*no-such-option"):
        native.build_library()
    assert not any(p.is_file() for p in tmp_path.rglob("*"))


def test_a_missing_library_raises_through_every_pass(monkeypatch):
    """No pass falls back to NumPy on its own."""
    def unavailable():
        raise RuntimeError("no library")

    monkeypatch.setattr(native, "get_lib", unavailable)
    g = tedge.Graph.from_arrays(4, [0, 1, 2], [1, 2, 3], [3, 2, 1])
    for fn in (lambda: g._rank_order, lambda: tgen.rmat_graph(16, 1, use_native=True)):
        with pytest.raises(RuntimeError, match="no library"):
            fn()
    g.__dict__["_rank_order"] = np.arange(3)
    for fn in (lambda: g.first_ranks, lambda: g.rank_endpoints(),
               lambda: trs.host_level2(np.arange(4, dtype=np.int32), *g.rank_endpoints(
                   native=False), 3)):
        with pytest.raises(RuntimeError, match="no library"):
            fn()
    assert tedge.rank_order(g.w, native=False).tolist() == [2, 1, 0]


# ---------------------------------------------------------------------------
# The passes: native = the port's NumPy form = JAX's NumPy branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_rank_order_matches_numpy_and_jax(graphs, name):
    jg, tg = graphs[name]
    got = tedge.rank_order(tg.w)
    np.testing.assert_array_equal(got, tedge.rank_order(tg.w, native=False))
    np.testing.assert_array_equal(got, jg._rank_order)
    np.testing.assert_array_equal(tg._rank_order, got)


@pytest.mark.parametrize("name", NAMES)
def test_rank_endpoints_match_numpy_and_jax(graphs, name):
    jg, tg = graphs[name]
    for pad in (None, tb._bucket_size(tg.num_edges) + 3):
        got = tg.rank_endpoints(pad_to=pad)
        for want in (tg.rank_endpoints(pad_to=pad, native=False), jg.rank_endpoints(pad_to=pad)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.int32


@pytest.mark.parametrize("name", NAMES)
def test_first_ranks_match_numpy_and_jax(graphs, name):
    jg, tg = graphs[name]
    ra, rb = tg.rank_endpoints()
    got = tedge.first_ranks_of(tg.num_nodes, ra, rb)
    np.testing.assert_array_equal(got, tedge.first_ranks_of(tg.num_nodes, ra, rb, native=False))
    np.testing.assert_array_equal(got, jg.first_ranks)
    np.testing.assert_array_equal(tg.first_ranks, got)
    assert got.dtype == np.int32


@pytest.mark.parametrize("name", NAMES)
def test_host_level2_matches_numpy_and_jax(graphs, name):
    """Over the true edge count and over a prefix past it, into the pad
    ranks (self-edges of vertex 0), as the filter route's prep runs it."""
    tg = graphs[name][1]
    n_pad, m_pad = tb._bucket_size(tg.num_nodes), tb._bucket_size(tg.num_edges)
    ra, rb = tg.rank_endpoints(pad_to=m_pad + 64)
    vmin0 = np.full(n_pad, INT32_MAX, dtype=np.int32)
    vmin0[: tg.num_nodes] = tg.first_ranks
    parent1 = trs.host_level1(vmin0, ra, rb)
    for m in {tg.num_edges, tg.num_edges // 3, m_pad + 64}:
        got = trs.host_level2(parent1, ra, rb, m)
        for want in (trs.host_level2(parent1, ra, rb, m, native=False),
                     jrs.host_level2(parent1, ra, rb, m)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["rmat13", "grid", "forest23"])
def test_staging_matches_the_numpy_passes(graphs, name):
    """The host-L2 prep, native, equals its arrays built by every pass in
    its NumPy form, and the JAX package's prep."""
    jg, tg = graphs[name]
    got = [t.numpy() for t in trs.prepare_rank_arrays_l2(tg, device="cpu")]
    n_pad, m_pad = tb._bucket_size(tg.num_nodes), tb._bucket_size(tg.num_edges)
    np.testing.assert_array_equal(tg._rank_order, tedge.rank_order(tg.w, native=False))
    ra, rb = tg.rank_endpoints(pad_to=m_pad, native=False)
    vmin0 = np.full(n_pad, INT32_MAX, dtype=np.int32)
    vmin0[: tg.num_nodes] = tedge.first_ranks_of(tg.num_nodes, ra[: tg.num_edges],
                                                 rb[: tg.num_edges], native=False)
    parent12, l2r = trs.host_level2(trs.host_level1(vmin0, ra, rb), ra, rb, tg.num_edges,
                                    native=False)
    want = (vmin0, ra, rb, parent12, trs._pad_l2_ranks(l2r, m_pad))
    for a, b, c in zip(got, want, jrs.prepare_rank_arrays_l2(jg)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------


def _digest(g):
    return hashlib.sha256(b"".join(a.astype(np.int64).tobytes() for a in (g.u, g.v, g.w))
                          ).hexdigest()


#: (scale, edge factor, seed) -> (edges, sha256 of u || v || w as int64) of
#: the JAX package's rmat_graph(..., use_native=True): its native stream.
JAX_NATIVE_RMAT = {
    (16, 16, 1): (909_461, "86166b0721d30ce224347104f3455010eb84691d7cf380677cb2f588cfe718a4"),
    (10, 16, 3): (10_550, "07fa5aa5854805d4d4f031f87d5996c172829bd48d7c0a7f9be86439657f9929"),
    (11, 8, 7): (12_750, "6d86ded6c8ff8c271728ba594ed11bc598f0ce33f7661425dbdf0d05630e3700"),
    (12, 16, 1): (48_472, "186cbb7843ec8e49dbbf6c0e220cf4105bc008beac664dfc607447f9948bbb37"),
    (13, 4, 2): (29_432, "01c54187603c7f6eee112c153371ebea36d9c8f8d567069f22b46c4afa7c64d4"),
}


@pytest.mark.parametrize("key", list(JAX_NATIVE_RMAT))
def test_rmat_native_is_the_jax_native_stream(key):
    """RMAT-16 through ``auto`` (the default), the smaller ones by
    ``use_native=True``."""
    scale, ef, seed = key
    g = tgen.rmat_graph(scale, ef, seed=seed, **({} if scale >= 16 else {"use_native": True}))
    assert g.generator_path == "rmat-native"
    assert (g.num_nodes, g.num_edges) == (1 << scale, JAX_NATIVE_RMAT[key][0])
    assert _digest(g) == JAX_NATIVE_RMAT[key][1]
    assert np.all(g.u < g.v)


@pytest.mark.parametrize("scale,ef,seed,kw", [
    (7, 4, 70, {}), (12, 8, 11, {}), (15, 2, 3, {}), (16, 2, 5, {"use_native": False}),
    (9, 8, 1, {"dedup": False}), (16, 1, 2, {"dedup": False})])
def test_rmat_numpy_stream_matches_jax(scale, ef, seed, kw):
    """Under scale 16, with ``use_native=False`` and without dedup, the
    port draws JAX's NumPy stream."""
    jg = jgen.rmat_graph(scale, ef, seed=seed, **kw)
    tg = tgen.rmat_graph(scale, ef, seed=seed, **kw)
    assert jg.generator_path == tg.generator_path == "rmat-numpy"
    assert _digest(tg) == _digest(jg) and tg.num_nodes == jg.num_nodes


def test_rmat_native_refuses_no_dedup():
    for gen in (jgen, tgen):
        with pytest.raises(ValueError, match="always dedups"):
            gen.rmat_graph(8, 4, use_native=True, dedup=False)


def test_rmat_native_does_not_depend_on_the_thread_count():
    """Each edge is seeded on its own: one OpenMP thread draws the graph
    that many draw."""
    script = textwrap.dedent(f"""
        import sys, hashlib
        sys.path.insert(0, {str(ROOT)!r})
        from distributed_ghs_implementation_tpu_torch.graphs import generators
        g = generators.rmat_graph(14, 8, seed=9, use_native=True)
        print(hashlib.sha256(g.u.tobytes() + g.v.tobytes() + g.w.tobytes()).hexdigest())
    """)
    digests = {subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              check=True, env={**os.environ, "OMP_NUM_THREADS": t}).stdout
               for t in ("1", "3")}
    assert len(digests) == 1


def test_the_wrappers_refuse_sizes_the_loops_would_overrun():
    a = np.arange(4, dtype=np.int32)
    for call in (lambda: native.rank_endpoints_i32(np.arange(4), a, a, 3),
                 lambda: native.rank_endpoints_i32(np.arange(4), a, a[:3], 8),
                 lambda: native.first_rank_i32(4, a, a[:3]),
                 lambda: native.first_cross_rank(4, a, a, a[:3])):
        with pytest.raises(ValueError, match="native host library"):
            call()
