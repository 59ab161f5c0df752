"""The port's public surface against the JAX package's, on the CPU.

* The package exports: every name of the JAX ``graphs``, ``models``,
  ``ops``, ``utils`` and ``parallel`` ``__all__`` imports from the port's
  counterpart, with ``jax`` made unimportable and no module of the JAX
  package loaded; ``shard_map_compat`` (a shim between JAX versions) is the
  one name not carried over.
* ``Graph``'s helpers (``total_weight``, ``edge_triples``,
  ``device_weight_dtype``, ``directed_arrays``, ``csr``, ``degrees``,
  ``to_networkx``, ``from_networkx``) equal JAX's on the fixture deck,
  RMAT-13 and a float-weighted ``gnm`` graph.
* The native bindings ``kruskal_msf``, ``rank_endpoints_i32_planes``,
  ``first_rank``, ``first_rank64`` and ``build_csr`` equal the JAX
  package's natives (its library built into a temporary directory by
  ``jax_native``), the planes buffer byte for byte with endpoint ids near
  2^24 - 1, and Kruskal raises ``ValueError`` on a corrupted order in both.
* The oracles: ``native_mst_weight`` and ``networkx_mst_*`` equal JAX's;
  ``verify_result`` routes ``auto`` to ``native`` above 200,000 integer
  edges and to ``scipy`` otherwise (JAX takes NetworkX there: a deliberate
  difference), float weights to ``scipy``.
* ``make_sharded_solver`` and ``make_sharded_ell_solver`` on 2 CPU shards
  equal JAX's factories on 2 devices and the rank oracle.
* The 24-bit wire: the encode and ``decode_planes24`` equal JAX's
  ``_stage_pair_packed24`` and ``_decode_planes24``, and both stagings of
  the rank endpoints give the same pair.

Every integer result is held exactly (tolerance 0).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_ghs_implementation_tpu import graphs as jgraphs
from distributed_ghs_implementation_tpu import models as jmodels
from distributed_ghs_implementation_tpu import ops as jops
from distributed_ghs_implementation_tpu import parallel as jparallel
from distributed_ghs_implementation_tpu import utils as jutils
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import native as jnative
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.parallel import mesh as jmesh
from distributed_ghs_implementation_tpu.parallel import sharded as jsh
from distributed_ghs_implementation_tpu.utils import verify as jverify
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.graphs import native as tnative
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.parallel import mesh as tmesh
from distributed_ghs_implementation_tpu_torch.parallel import sharded as tsh
from distributed_ghs_implementation_tpu_torch.utils import verify as tverify
from torch_inputs import build_deck
from torch_pairs import CPU, isolated, jax_native, jax_native_library  # noqa: F401 -- fixtures

pytestmark = pytest.mark.usefixtures("isolated")

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGES = {"graphs": jgraphs, "models": jmodels, "ops": jops, "utils": jutils,
                "parallel": jparallel}
#: The names of the JAX ``__all__``s the port does not carry, by package.
NOT_CARRIED = {"parallel": {"shard_map_compat"}}


# ----------------------------------------------------------------------
# Package exports
# ----------------------------------------------------------------------
def test_every_jax_export_imports_from_the_port():
    want = {pkg: sorted(set(mod.__all__) - NOT_CARRIED.get(pkg, set()))
            for pkg, mod in JAX_PACKAGES.items()}
    assert NOT_CARRIED["parallel"] <= set(jparallel.__all__)
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "want = json.loads(sys.argv[1])\n"
        "got = {}\n"
        "for pkg, names in want.items():\n"
        "    mod = importlib.import_module('distributed_ghs_implementation_tpu_torch.' + pkg)\n"
        "    exec(f'from distributed_ghs_implementation_tpu_torch.{pkg} import *', {})\n"
        "    objs = {n: getattr(mod, n) for n in names}\n"
        "    got[pkg] = {'all': sorted(mod.__all__), 'homes': sorted({\n"
        "        getattr(o, '__module__', None) or type(o).__module__ for o in objs.values()})}\n"
        "got['jax'] = sorted(m for m in sys.modules if m == 'distributed_ghs_implementation_tpu'\n"
        "                    or m.startswith('distributed_ghs_implementation_tpu.'))\n"
        "print(json.dumps(got))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, json.dumps(want)], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("jax") == []
    for pkg, names in want.items():
        assert set(names) <= set(got[pkg]["all"]), pkg
        assert all(h.startswith("distributed_ghs_implementation_tpu_torch.")
                   for h in got[pkg]["homes"]), got[pkg]["homes"]


# ----------------------------------------------------------------------
# Graph helpers
# ----------------------------------------------------------------------
def _gnm_float(edge_mod, gen):
    g = gen.gnm_random_graph(300, 1200, seed=5)
    w = np.round(np.random.default_rng(5).random(g.num_edges) * 100, 3)
    return edge_mod.Graph.from_arrays(g.num_nodes, g.u, g.v, w)


@pytest.fixture(scope="module")
def graphs():
    out = build_deck(jedge, jgen, tedge, tgen)
    out["rmat13"] = (jgen.rmat_graph(13, 16, seed=1, use_native=False),
                     tgen.rmat_graph(13, 16, seed=1))
    out["gnm-float"] = (_gnm_float(jedge, jgen), _gnm_float(tedge, tgen))
    return out


GRAPH_NAMES = ["er48", "rmat12", "road40", "forest23", "readme", "rmat13", "gnm-float"]


def _same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_graph_helpers_match_jax(graphs, name):
    jg, tg = graphs[name]
    assert tg.total_weight == jg.total_weight
    assert type(tg.total_weight) is type(jg.total_weight)
    assert tg.edge_triples() == jg.edge_triples()
    assert [type(t[2]) for t in tg.edge_triples()[:3]] == [
        type(t[2]) for t in jg.edge_triples()[:3]]
    assert tg.device_weight_dtype() == jg.device_weight_dtype()
    _same_arrays(tg.directed_arrays(), jg.directed_arrays())
    pad = 2 * tg.num_edges + 6
    _same_arrays(tg.directed_arrays(pad_to=pad), jg.directed_arrays(pad_to=pad))
    with pytest.raises(ValueError, match="pad_to"):
        tg.directed_arrays(pad_to=2 * tg.num_edges - 1)
    _same_arrays(tg.csr(), jg.csr())
    _same_arrays([tg.degrees()], [jg.degrees()])


@pytest.mark.parametrize("name", ["readme", "forest23", "gnm-float"])
def test_networkx_round_trip_matches_jax(graphs, name):
    jg, tg = graphs[name]
    tnx, jnx = tg.to_networkx(), jg.to_networkx()
    assert sorted(tnx.nodes) == sorted(jnx.nodes) == list(range(tg.num_nodes))
    assert sorted(tnx.edges(data="weight")) == sorted(jnx.edges(data="weight"))
    back, jback = tedge.Graph.from_networkx(tnx), jedge.Graph.from_networkx(jnx)
    assert back.num_nodes == jback.num_nodes == tg.num_nodes
    _same_arrays((back.u, back.v, back.w), (jback.u, jback.v, jback.w))
    _same_arrays((back.u, back.v, back.w), (tg.u, tg.v, tg.w))
    assert back.digest() == tg.digest()


# ----------------------------------------------------------------------
# Native bindings
# ----------------------------------------------------------------------
def _high_ids():
    """A graph on 2^24 vertices whose edges touch ids near 2^24 - 1 (every
    byte of the 24-bit wire in use)."""
    n = 1 << 24
    rng = np.random.default_rng(24)
    u = np.concatenate([rng.integers(n - 300, n, 400), rng.integers(0, n, 200)])
    v = np.concatenate([rng.integers(n - 300, n, 400), [n - 1] * 200])
    w = rng.integers(1, 40, u.size)
    return jedge.Graph.from_arrays(n, u, v, w), tedge.Graph.from_arrays(n, u, v, w)


@pytest.mark.parametrize("name", ["er48", "road40", "forest23", "rmat13", "high-ids"])
def test_native_bindings_match_jax_natives(graphs, jax_native, name):
    jg, tg = _high_ids() if name == "high-ids" else graphs[name]
    n, m = tg.num_nodes, tg.num_edges
    order = tg._rank_order
    np.testing.assert_array_equal(order, jg._rank_order)
    pad = m + 37
    got = tnative.rank_endpoints_i32_planes(order, tg.u, tg.v, pad)
    want = jnative.rank_endpoints_i32_planes_native(order, jg.u, jg.v, pad)
    _same_arrays(got, want)
    assert got[2].tobytes() == want[2].tobytes()
    ra, rb = got[0][:m].astype(np.int64), got[1][:m].astype(np.int64)
    _same_arrays([tnative.first_rank(n, ra, rb)], [jnative.first_rank_native(n, ra, rb)])
    _same_arrays([tnative.first_rank64(n, ra, rb)], [jnative.first_rank64_native(n, ra, rb)])
    np.testing.assert_array_equal(tnative.first_rank(n, ra, rb), tg.first_ranks)
    _same_arrays(tnative.build_csr(n, tg.u, tg.v, tg.w), jnative.build_csr_native(n, jg.u, jg.v,
                                                                                 jg.w))
    total = tnative.kruskal_msf(n, order, tg.u, tg.v, tg.w)
    assert total == jnative.kruskal_msf_native(n, order, jg.u, jg.v, jg.w)
    if n < (1 << 20):
        assert total[0] == tverify.scipy_mst_weight(tg)


def test_kruskal_refuses_a_corrupt_order_like_jax(graphs, jax_native):
    jg, tg = graphs["rmat13"]
    order = tg._rank_order.copy()
    heavy = int(np.argmax(tg.w[order]))
    order[[0, heavy]] = order[[heavy, 0]]  # weights no longer nondecreasing
    dup = tg._rank_order.copy()
    dup[5] = dup[6]  # not a permutation
    for bad in (order, dup):
        with pytest.raises(ValueError, match="permutation"):
            tnative.kruskal_msf(tg.num_nodes, bad, tg.u, tg.v, tg.w)
        with pytest.raises(ValueError, match="permutation"):
            jnative.kruskal_msf_native(jg.num_nodes, bad, jg.u, jg.v, jg.w)
    with pytest.raises(ValueError, match="native host library"):
        tnative.kruskal_msf(tg.num_nodes, tg._rank_order, tg.u, tg.v[:-1], tg.w)


# ----------------------------------------------------------------------
# Oracles and verify_result's routing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["er48", "readme", "forest23", "rmat13", "gnm-float"])
def test_oracles_match_jax(graphs, jax_native, name):
    jg, tg = graphs[name]
    assert tverify.native_mst_weight(tg) == jverify.native_mst_weight(jg)
    if tg.is_integer_weighted:
        assert tverify.native_mst_weight(tg) == tverify.scipy_mst_weight(tg)
    else:
        assert tverify.native_mst_weight(tg) is None
    assert tverify.networkx_mst_weight(tg) == pytest.approx(jverify.networkx_mst_weight(jg),
                                                            abs=1e-9)
    if name != "gnm-float":
        assert tverify.networkx_mst_weight(tg) == jverify.networkx_mst_weight(jg)
    if name in ("er48", "gnm-float"):  # distinct enough weights for one forest
        assert tverify.networkx_mst_edges(tg) == jverify.networkx_mst_edges(jg)


def test_native_oracle_has_nothing_to_do_without_edges():
    g = tedge.Graph.from_arrays(5, np.zeros(0, int), np.zeros(0, int), np.zeros(0, int))
    assert tverify.native_mst_weight(g) is None


def _result(graph):
    """The forest of the rank oracle as a result, as a solve would give it."""
    ids = tverify.rank_oracle_edge_ids(graph)
    return tapi.MSTResult(graph=graph, edge_ids=ids, num_levels=1, wall_time_s=0.0,
                          backend="oracle", num_components=graph.num_nodes - ids.size)


def _wide(edges: int, *, float_weights: bool = False):
    """A grid with exactly ``edges`` edges."""
    g = tgen.road_grid_graph(330, 330, seed=4)
    w = g.w[:edges] + (0.5 if float_weights else 0)
    return tedge.Graph(g.num_nodes, g.u[:edges], g.v[:edges], w)


def test_verify_result_routes_like_jax_but_scipy_below_the_threshold(graphs):
    big = _wide(200_001)
    v = tverify.verify_result(_result(big))
    assert v.ok and v.oracle == "native"
    assert v.expected_weight == tverify.scipy_mst_weight(big)
    at = _wide(200_000)
    assert tverify.verify_result(_result(at)).oracle == "scipy"
    jg, tg = graphs["rmat13"]
    assert tverify.verify_result(_result(tg)).oracle == "scipy"  # JAX: networkx here
    assert tverify.verify_result(_result(_wide(200_001, float_weights=True))).oracle == "scipy"
    assert tverify.verify_result(_result(tg), oracle="native").oracle == "native"
    r = _result(tg)
    for oracle in ("native", "scipy", "networkx"):
        v = tverify.verify_result(r, oracle=oracle)
        assert v.ok and v.oracle == oracle and v.expected_weight == jverify.scipy_mst_weight(jg)
    with pytest.raises(ValueError, match="oracle"):
        tverify.verify_result(r, oracle="exact")


def test_networkx_oracle_names_networkx_where_it_is_missing(graphs, monkeypatch):
    monkeypatch.setitem(sys.modules, "networkx", None)
    tg = graphs["readme"][1]
    for fn in (tverify.networkx_mst_weight, tverify.networkx_mst_edges):
        with pytest.raises(ImportError, match="NetworkX"):
            fn(tg)
    assert tverify.verify_result(tapi.minimum_spanning_tree(tg, device=CPU)).ok


# ----------------------------------------------------------------------
# Sharded solver factories
# ----------------------------------------------------------------------
def _rank_inputs(graph, shards):
    e_pad = tb._bucket_size(2 * graph.num_edges)
    e_pad = -(-e_pad // (2 * shards)) * 2 * shards
    return graph.rank_arrays(pad_edges_to=e_pad, pad_ranks_to=e_pad // 2)


@pytest.mark.parametrize("name", ["rmat13", "forest23", "road40"])
def test_make_sharded_solver_matches_jax_and_the_oracle(graphs, name):
    jg, tg = graphs[name]
    arrays = _rank_inputs(tg, 2)
    n_pad = tb._bucket_size(tg.num_nodes)
    tm = tmesh.edge_mesh(num_shards=2, device=CPU)
    mst, fragment, levels = tsh.make_sharded_solver(tm, n_pad)(*arrays)
    jm = jmesh.edge_mesh(num_devices=2)
    spec = NamedSharding(jm, P(jmesh.EDGE_AXIS))
    want = jsh.make_sharded_solver(jm, n_pad)(*(jax.device_put(jnp.asarray(a), spec)
                                                for a in arrays))
    assert mst.dtype == torch.bool and fragment.dtype == torch.int32
    np.testing.assert_array_equal(mst.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(fragment.numpy(), np.asarray(want[1]))
    assert levels == int(want[2])
    ids = np.sort(tg.edge_id_of_rank(np.nonzero(mst.numpy())[0]))
    np.testing.assert_array_equal(ids, tverify.rank_oracle_edge_ids(tg))
    torch_args = [torch.from_numpy(a) for a in arrays]
    again = tsh.make_sharded_solver(tm, n_pad)(*torch_args)
    assert torch.equal(again[0], mst) and torch.equal(again[1], fragment)
    with pytest.raises(ValueError, match="divide"):
        tsh.make_sharded_solver(tm, n_pad)(*(a[:-1] for a in arrays))


@pytest.mark.parametrize("name", ["rmat13", "forest23"])
def test_make_sharded_ell_solver_matches_jax(graphs, name):
    jg, tg = graphs[name]
    n_pad = tb._bucket_size(tg.num_nodes)
    ra, rb = tg.rank_endpoints(pad_to=tb._bucket_size(tg.num_edges))
    buckets = []
    for verts, dstb, rankb in tg.ell_buckets:
        pad = -verts.shape[0] % 2
        buckets.append((np.concatenate([verts, np.zeros(pad, np.int32)]),
                        np.vstack([dstb, np.zeros((pad, dstb.shape[1]), np.int32)]),
                        np.vstack([rankb, np.full((pad, dstb.shape[1]), np.iinfo(np.int32).max,
                                                  np.int32)])))
    tm = tmesh.edge_mesh(num_shards=2, device=CPU)
    mst, fragment, levels = tsh.make_sharded_ell_solver(tm, n_pad)(buckets, ra, rb)
    jm = jmesh.edge_mesh(num_devices=2)
    want = jsh.make_sharded_ell_solver(jm, n_pad)(
        tuple(tuple(jnp.asarray(a) for a in b) for b in buckets), jnp.asarray(ra), jnp.asarray(rb))
    np.testing.assert_array_equal(mst.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(fragment.numpy(), np.asarray(want[1]))
    assert levels == int(want[2])
    ids = np.sort(tg.edge_id_of_rank(np.nonzero(mst.numpy())[0]))
    np.testing.assert_array_equal(ids, tverify.rank_oracle_edge_ids(tg))


# ----------------------------------------------------------------------
# The 24-bit wire
# ----------------------------------------------------------------------
def _pair24(size: int):
    rng = np.random.default_rng(size)
    ra = rng.integers(0, 1 << 24, size).astype(np.int32)
    rb = rng.integers((1 << 24) - 512, 1 << 24, size).astype(np.int32)
    ra[:3] = [0, 255, (1 << 24) - 1]
    return ra, rb


@pytest.mark.parametrize("size", [3, 7, 4096 + 3])
def test_wire24_encode_and_decode_match_jax(size):
    ra, rb = _pair24(size)
    got = trs.stage_pair_packed24(ra, rb, CPU)
    want = jrs._stage_pair_packed24(ra, rb)
    for g, w, host in zip(got, want, (ra, rb)):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), host)
    planes = trs.pack_planes24(ra, rb)
    decoded = trs.decode_planes24(torch.from_numpy(planes))
    jdecoded = jrs._decode_planes24(jnp.asarray(planes))
    for g, w in zip(decoded, jdecoded):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_native_planes_equal_the_numpy_encode():
    _, tg = _high_ids()
    m_pad = trs._bucket_size(tg.num_edges)
    ra, rb, planes = tnative.rank_endpoints_i32_planes(tg._rank_order, tg.u, tg.v, m_pad)
    assert planes.tobytes() == trs.pack_planes24(ra, rb).tobytes()


@pytest.mark.parametrize("name", ["rmat13", "road40", "high-ids"])
def test_both_stagings_give_the_same_pair(graphs, name):
    tg = _high_ids()[1] if name == "high-ids" else graphs[name][1]
    m_pad = trs._bucket_size(tg.num_edges)
    cpu = torch.device(CPU)
    int32 = trs._stage_endpoints_int32(tg, m_pad, cpu)
    wire = trs._stage_endpoints_wire24(tg, m_pad, cpu)
    _same_arrays(int32[:2], wire[:2])
    for a, b in zip(int32[2:], wire[2:]):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


def test_staging_turns_time_both_ways_and_name_the_one_taken(graphs):
    from distributed_ghs_implementation_tpu_torch import profile_solve

    out = profile_solve.staging_turns(graphs["rmat13"][1], torch.device(CPU), 2)
    assert out["equal"] and out["chosen"] == "int32" and out["turns"] == 2
    assert trs._stage_endpoints is trs._stage_endpoints_int32
    for how in ("int32", "wire24"):
        assert len(out[how]["turns"]) == 2
        for key in ("host_s", "under_copies_s", "copy_wait_s", "prep_s"):
            assert 0 <= out[how][key]["min"] <= out[how][key]["median"] <= out[how][key]["max"]
