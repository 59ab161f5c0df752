"""The port's sharded solvers (``parallel/``) against the JAX package's, on
the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(meshes of 8 and 2 devices), the port on meshes of 8 and 2 CPU shards
(``edge_mesh(num_shards=..., device="cpu")``). On the same graph and shard
count the two must give the same sorted forest edge ids, fragment labels
and level counts: the dryrun fixtures (``__graft_entry__.py``) through
every strategy, the filtered and split-key (``rank64``) programs, and
graphs without edges. The mesh's collectives
and layout and the packed harvest are held against NumPy. The capacity
guard, the filtered policy, the families through ``auto``, the chunk hooks
and the resumes are in ``test_torch_sharded_routes.py``.
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.parallel import mesh as jmesh
from distributed_ghs_implementation_tpu.parallel import rank_sharded as jrsh
from distributed_ghs_implementation_tpu.parallel import sharded as jsh
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.parallel import mesh as tmesh
from distributed_ghs_implementation_tpu_torch.parallel import rank_sharded as trsh
from distributed_ghs_implementation_tpu_torch.parallel import sharded as tsh
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import build_deck
from torch_pairs import CPU, isolated, pair  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")

FIXTURES = ["er48", "rmat12", "road40", "forest23", "readme"]
MODES = ["flat", "ell", "rank", "filtered", "rank64"]


@pytest.fixture(scope="module")
def deck():
    return build_deck(jedge, jgen, tedge, tgen)


def _meshes(nd):
    return jmesh.edge_mesh(num_devices=nd), tmesh.edge_mesh(num_shards=nd, device=CPU)


def _solve(mode, side, graph, mesh, **kw):
    if side == "jax":
        sh, rsh = jsh, jrsh
    else:
        sh, rsh = tsh, trsh
    if mode == "filtered":
        return rsh.solve_graph_rank_sharded(graph, mesh=mesh, filtered=True, **kw)
    if mode == "rank64":
        return rsh.solve_graph_rank_sharded(graph, mesh=mesh, rank64=True, **kw)
    if mode in ("rank-plain", "rank-kw"):
        return rsh.solve_graph_rank_sharded(graph, mesh=mesh, **kw)
    return sh.solve_graph_sharded(graph, mesh=mesh, strategy=mode, **kw)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == int(want[2])
    assert got[1].dtype == np.int32


def _both(mode, jg, tg, nd, **kw):
    jm, tm = _meshes(nd)
    want = _solve(mode, "jax", jg, jm, **kw)
    got = _solve(mode, "port", tg, tm, **kw)
    _same(got, want)
    return got


# ---------------------------------------------------------------------------
# The dryrun fixtures through every strategy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nd", [8, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax(deck, name, mode, nd):
    jg, tg = deck[name]
    got = _both(mode, jg, tg, nd)
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))


def test_forest_keeps_its_23_components(deck):
    jg, tg = deck["forest23"]
    tm = tmesh.edge_mesh(num_shards=8, device=CPU)
    for mode in MODES:
        ids, frag, _ = _solve(mode, "port", tg, tm)
        assert np.unique(frag).size == 23, mode


@pytest.mark.parametrize("mode", MODES)
def test_graphs_without_edges(mode):
    for n in (0, 1, 5):
        got = _both(mode, jedge.Graph.from_edges(n, []), tedge.Graph.from_edges(n, []), 8)
        assert got[0].size == 0 and got[2] == 0


# ---------------------------------------------------------------------------
# The mesh, the packed harvest, first_ranks64
# ---------------------------------------------------------------------------


def test_edge_mesh_layout_and_device_rule(monkeypatch):
    mesh = tmesh.edge_mesh(num_shards=4, device=CPU)
    assert (mesh.size, mesh.local_shards, mesh.first_shard) == (4, 4, 0)
    assert mesh.rep_devices == (torch.device("cpu"),) and mesh.rep_of_shard == (0, 0, 0, 0)
    assert [mesh.axis_index(j) for j in range(4)] == [0, 1, 2, 3]
    assert tmesh.edge_mesh(device=CPU).size == 1
    a = np.arange(16, dtype=np.int32)
    parts = mesh.shard_host(a)
    assert [p.tolist() for p in parts] == [a[4 * k:4 * k + 4].tolist() for k in range(4)]
    assert len({p.data_ptr() for p in parts}) == 4  # no two shards share a buffer
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_host(np.arange(10))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.edge_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsh.solve_graph_sharded(pair("road")[1])


def test_mesh_collectives_match_numpy():
    rng = np.random.default_rng(3)
    mesh = tmesh.edge_mesh(num_shards=5, device=CPU)
    parts = [rng.integers(-50, 50, 37).astype(np.int32) for _ in range(5)]
    tparts = [torch.from_numpy(p) for p in parts]
    np.testing.assert_array_equal(mesh.pmin(tparts)[0].numpy(), np.min(parts, 0))
    np.testing.assert_array_equal(mesh.psum(tparts)[0].numpy(), np.sum(parts, 0))
    np.testing.assert_array_equal(mesh.all_gather(tparts)[0].numpy(), np.concatenate(parts))
    for p, t in zip(parts, tparts):  # the combines leave the parts alone
        np.testing.assert_array_equal(t.numpy(), p)
    rows = [[torch.tensor(int(p.sum())), torch.tensor(int(p.max()))] for p in parts]
    assert mesh.host_reduce(rows, ("sum", "max")) == [int(np.sum(parts)), int(np.max(parts))]


@pytest.mark.parametrize("width", [8, 64, 4096])
def test_packbits_and_the_packed_harvest_match_numpy(width):
    rng = np.random.default_rng(width)
    mask = rng.random(width) < 0.3
    np.testing.assert_array_equal(trs.packbits(torch.from_numpy(mask.astype(np.uint8))).numpy(),
                                  np.packbits(mask))
    mesh = tmesh.edge_mesh(num_shards=8 if width >= 64 else 1, device=CPU)
    shards = mesh.shard_host(mask.astype(np.uint8), torch.uint8)
    np.testing.assert_array_equal(trsh.mask_harvest(mesh, shards), np.packbits(mask))
    jg, tg = pair("road")
    m = tg.num_edges - tg.num_edges % 8
    bits = np.packbits(rng.random(m) < 0.5)
    np.testing.assert_array_equal(trs.packed_to_edge_ids(tg, bits, m),
                                  jrs.packed_to_edge_ids(jg, bits, m))
    with pytest.raises(ValueError, match="divides by 8"):
        trs.packbits(torch.zeros(12, dtype=torch.uint8))


@pytest.mark.parametrize("name", ["road", "forest", "rmat"])
def test_first_ranks64_matches_jax(name):
    jg, tg = pair(name)
    want = jg.first_ranks64
    np.testing.assert_array_equal(tg.first_ranks64, want)
    assert tg.first_ranks64.dtype == np.int64
    np.testing.assert_array_equal(
        tedge.first_ranks64_of(tg.num_nodes, *tg.rank_endpoints(), native=False), want)


def test_harvests_agree():
    """The flat solve's concatenated shard masks and the rank solve's packed
    harvest name the same forest."""
    tg = pair("rmat")[1]
    mesh = tmesh.edge_mesh(num_shards=8, device=CPU)
    want = rank_oracle_edge_ids(tg)
    for strategy in ("flat", "ell", "rank"):
        np.testing.assert_array_equal(
            tsh.solve_graph_sharded(tg, mesh=mesh, strategy=strategy)[0], want)
    np.testing.assert_array_equal(tb.solve_graph(tg, device=CPU)[0], want)
