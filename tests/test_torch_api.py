"""The PyTorch port's public API: results, the device rule, the backends
(every backend of the JAX package is ported), and import hygiene (the port
imports nothing of JAX or of the JAX package)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_ghs_implementation_tpu as jax_pkg
import distributed_ghs_implementation_tpu_torch as port
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu_torch import (
    GHSAlgorithm,
    minimum_spanning_forest,
    minimum_spanning_tree,
)
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.utils.verify import (
    rank_oracle_edge_ids,
    scipy_mst_weight,
    verify_result,
)

PORT_DIR = Path(port.__file__).resolve().parent
REPO = PORT_DIR.parent
CPU = "cpu"


def test_readme_sample_weight_20():
    r = minimum_spanning_tree(tgen.readme_sample_graph(), device=CPU)
    assert r.total_weight == 20
    assert r.num_edges == 5 and r.is_spanning_tree
    v = verify_result(r)
    assert v.ok and v.oracle == "scipy" and v.expected_weight == 20
    assert verify_result(r, expected_weight=20).oracle == "recorded"
    assert not verify_result(r, expected_weight=21).ok
    assert verify_result(r, oracle="networkx").oracle == "networkx"
    with pytest.raises(ValueError, match="oracle"):
        verify_result(r, oracle="exact")


@pytest.mark.parametrize("make", [
    lambda g: g.readme_sample_graph(),
    lambda g: g.random_road_network(12, 12, seed=2),
    lambda g: g.erdos_renyi_graph(30, 0.15, seed=5),
])
def test_results_match_the_jax_api(make):
    got = minimum_spanning_forest(make(tgen), device=CPU)
    want = jax_pkg.minimum_spanning_forest(make(jgen))
    np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    assert got.edges == want.edges
    assert got.weighted_edges == want.weighted_edges
    assert got.total_weight == want.total_weight
    assert got.num_levels == want.num_levels
    assert got.num_components == want.num_components
    assert got.backend == "device" and got.incidents is None


def test_ghs_algorithm_run():
    edges = [(0, 1, 1), (0, 2, 4), (1, 2, 2), (1, 3, 5), (2, 3, 3),
             (2, 4, 7), (3, 4, 6), (3, 5, 8), (4, 5, 9)]
    ghs = GHSAlgorithm(6, edges, device=CPU)
    with pytest.raises(RuntimeError, match="run"):
        ghs.get_mst_weight()
    assert ghs.run() == [(0, 1), (1, 2), (2, 3), (3, 4), (3, 5)]
    assert ghs.get_mst_weight() == 20


def test_disconnected_graph_is_a_forest_not_a_tree():
    g = Graph.from_edges(5, [(0, 1, 1), (2, 3, 1)])
    r = minimum_spanning_forest(g, device=CPU)
    assert r.num_components == 3 and r.num_edges == 2 and not r.is_spanning_tree
    with pytest.raises(ValueError, match="disconnected"):
        minimum_spanning_tree(g, device=CPU)


def test_rank_oracle_is_exact_and_ignores_parallel_edges():
    g = Graph.from_arrays(4, np.array([0, 0, 1, 2, 0]), np.array([1, 1, 2, 3, 3]),
                          np.array([5, 1, 1, 1, 1]), dedup=False)
    ids = rank_oracle_edge_ids(g)
    assert g.w[ids].sum() == scipy_mst_weight(g) == 3
    assert 0 not in ids  # the heavier parallel (0, 1) edge
    assert rank_oracle_edge_ids(Graph.from_edges(3, [])).size == 0


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tgen.readme_sample_graph()
    for call in (
        lambda: minimum_spanning_forest(g),
        lambda: minimum_spanning_tree(g, device="cuda"),
        lambda: GHSAlgorithm(3, [(0, 1, 1)]).run(),
        lambda: tb.solve_graph(Graph.from_edges(3, [])),
        lambda: tb.prepare_device_arrays(g),
        lambda: tb.state_from_numpy(np.arange(3), np.zeros(2, bool), 0, device=None),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unsupported_device_type_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        minimum_spanning_forest(tgen.readme_sample_graph(), device="meta")


def test_backends_not_ported_raise():
    """No backend is left unported: ``protocol`` and ``sharded`` solve as
    the JAX package's do (edge ids, fragments and levels), and so do
    ``host`` and supervised solves; a supervised ``protocol`` solve enters
    the ladder at ``device``, as in JAX. The name is kept from when
    ``protocol`` raised here."""
    from distributed_ghs_implementation_tpu import api as japi

    g = tgen.readme_sample_graph()
    supervised = minimum_spanning_forest(g, backend="protocol", supervised=True, device=CPU)
    want_sup = japi.minimum_spanning_forest(jgen.readme_sample_graph(), backend="protocol",
                                            supervised=True)
    assert supervised.backend == want_sup.backend == "supervised/device"
    assert supervised.total_weight == 20
    for graph, jgraph in ((g, jgen.readme_sample_graph()),
                          (tgen.erdos_renyi_graph(60, 0.2, seed=4),
                           jgen.erdos_renyi_graph(60, 0.2, seed=4))):
        for backend in ("sharded", "protocol"):
            got = minimum_spanning_forest(graph, backend=backend, device=CPU)
            want = japi.minimum_spanning_forest(jgraph, backend=backend)
            assert got.backend == want.backend == backend
            np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
            assert (got.num_levels, got.num_components) == (want.num_levels,
                                                             want.num_components)
    supervised = minimum_spanning_forest(g, backend="sharded", supervised=True, device=CPU)
    assert supervised.backend == "supervised/sharded" and supervised.total_weight == 20
    assert minimum_spanning_forest(g, backend="host", device=CPU).total_weight == 20
    with pytest.raises(ValueError, match="unknown backend"):
        minimum_spanning_forest(g, backend="nope", device=CPU)


def test_public_names_are_the_jax_packages_minus_the_batch_api():
    """The batch API is ported too now: the names are the JAX package's."""
    assert set(port.__all__) == set(jax_pkg.__all__)
    for name in port.__all__:
        assert hasattr(port, name)


def test_port_imports_and_solves_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['networkx'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from distributed_ghs_implementation_tpu_torch import minimum_spanning_tree\n"
        "from distributed_ghs_implementation_tpu_torch.graphs.generators import "
        "readme_sample_graph\n"
        "import distributed_ghs_implementation_tpu_torch.utils.verify\n"
        "from distributed_ghs_implementation_tpu_torch.models import rank_solver\n"
        "r = minimum_spanning_tree(readme_sample_graph(), device='cpu')\n"
        "assert r.total_weight == 20, r.total_weight\n"
        "ids, _, lv = rank_solver.solve_graph_rank(readme_sample_graph(), device='cpu')\n"
        "assert ids.tolist() == r.edge_ids.tolist() and lv > 0, (ids, lv)\n"
        "import tempfile\n"
        "from distributed_ghs_implementation_tpu_torch import obs\n"
        "from distributed_ghs_implementation_tpu_torch.obs import export, pulse, slo, tracing\n"
        "from distributed_ghs_implementation_tpu_torch.utils import (\n"
        "    checkpoint, integrity, locking, metrics, resilience)\n"
        "from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest\n"
        "g = readme_sample_graph()\n"
        "s = minimum_spanning_forest(g, supervised=True, device='cpu')\n"
        "assert s.backend == 'supervised/device' and s.total_weight == 20, s.backend\n"
        "assert minimum_spanning_forest(g, backend='host', device='cpu').total_weight == 20\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    c = checkpoint.solve_graph_checkpointed(g, d + '/c.npz', device='cpu')\n"
        "    assert c[0].tolist() == r.edge_ids.tolist()\n"
        "    export.write_chrome_trace(obs.BUS, d + '/t.json')\n"
        "(m, _, _), lm = metrics.solve_graph_instrumented(g, strategy='rank', device='cpu')\n"
        "assert m.tolist() == r.edge_ids.tolist() and lm.levels\n"
        "from distributed_ghs_implementation_tpu_torch import batch, serve\n"
        "from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest_batch\n"
        "from distributed_ghs_implementation_tpu_torch.batch import engine, lanes, policy, warmup\n"
        "from distributed_ghs_implementation_tpu_torch.serve import dynamic, scheduler, store\n"
        "rs = minimum_spanning_forest_batch([g, g], device='cpu')\n"
        "assert [x.edge_ids.tolist() for x in rs] == [r.edge_ids.tolist()] * 2, rs\n"
        "assert lanes.solve_lanes([g], mode='vmap', device='cpu')[0][0].tolist() == "
        "r.edge_ids.tolist()\n"
        "assert warmup.run_warmup(warmup.WarmupPlan(buckets=((8, 16),), lanes=2), "
        "device='cpu')['compiled'] == 1\n"
        "sched = serve.SolveScheduler(device='cpu')\n"
        "assert sched.solve(g)[0].total_weight == 20 and sched.solve(g)[1] == 'cache'\n"
        "dyn = serve.DynamicMST(r, device='cpu')\n"
        "assert dyn.apply([serve.Update('insert', 0, 5, 1)]).total_weight <= 20\n"
        "import io, json\n"
        "from distributed_ghs_implementation_tpu_torch import analytics, fleet, stream, verify\n"
        "from distributed_ghs_implementation_tpu_torch.fleet import framing\n"
        "from distributed_ghs_implementation_tpu_torch.graphs import io as gio\n"
        "from distributed_ghs_implementation_tpu_torch.stream import log, session, window\n"
        "from distributed_ghs_implementation_tpu_torch.utils import wal\n"
        "from distributed_ghs_implementation_tpu_torch.verify import certify, policy\n"
        "for spec in analytics.KINDS.values():\n"
        "    spec.solver, spec.oracle, spec.certify\n"
        "edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]\n"
        "reqs = [{'op': 'solve', 'num_nodes': 6, 'edges': edges, 'kind': k} for k in\n"
        "        ('mst', 'components', 'bottleneck')]\n"
        "reqs += [{'op': 'subscribe', 'digest': g.digest()}, {'op': 'stats'}]\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    svc = serve.MSTService(device='cpu', verify='full', stream_dir=d)\n"
        "    out = io.StringIO()\n"
        "    serve.serve_loop(io.StringIO('\\n'.join(map(json.dumps, reqs))), out, svc)\n"
        "answers = [json.loads(x) for x in out.getvalue().splitlines()]\n"
        "assert all(a['ok'] for a in answers) and answers[0]['total_weight'] == 20, answers\n"
        "bad = [m for m in sys.modules if m == 'distributed_ghs_implementation_tpu' "
        "or m.startswith('distributed_ghs_implementation_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_imports_and_solves_without_jax():
    """The sharded modules (``parallel/``) import and solve with JAX
    blocked, and load no module of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['networkx'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest, parallel\n"
        "from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph\n"
        "from distributed_ghs_implementation_tpu_torch.parallel import (\n"
        "    lane, mesh, multihost, rank_sharded, sharded)\n"
        "from distributed_ghs_implementation_tpu_torch.utils import checkpoint\n"
        "g = rmat_graph(9, 8, seed=2)\n"
        "want = minimum_spanning_forest(g, device='cpu').edge_ids.tolist()\n"
        "m = mesh.edge_mesh(num_shards=4, device='cpu')\n"
        "for strategy in ('flat', 'ell', 'rank'):\n"
        "    got = sharded.solve_graph_sharded(g, mesh=m, strategy=strategy)[0].tolist()\n"
        "    assert got == want, strategy\n"
        "assert rank_sharded.solve_graph_rank_sharded(g, mesh=m, rank64=True)[0].tolist() == want\n"
        "assert lane.ShardedLane(m).solve(g)[0].tolist() == want\n"
        "assert multihost.is_primary() and multihost.broadcast_resume_state(None) is None\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    c = checkpoint.solve_graph_checkpointed_sharded(g, d + '/s.npz', mesh=m)\n"
        "    assert c[0].tolist() == want\n"
        "bad = [n for n in sys.modules if n == 'distributed_ghs_implementation_tpu' "
        "or n.startswith('distributed_ghs_implementation_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_neither_jax_nor_the_jax_package():
    """Nor NetworkX at module level, which the card's machine does not
    have: only the NetworkX oracles and ``Graph``'s conversions import it,
    when they are called."""
    jax_import = re.compile(r"^\s*(import jax|from jax)\b|^(import networkx|from networkx)\b",
                            re.M)
    files = sorted(PORT_DIR.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
        REPO / "tests" / "torch_inputs.py", REPO / "tests" / "torch_multihost_child.py",
    ]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not jax_import.search(text), path
        assert "distributed_ghs_implementation_tpu." not in text, path
        assert "import distributed_ghs_implementation_tpu\n" not in text, path


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA it exits non-zero and prints no result line; alone in
    a directory it cannot import the port either."""
    env_code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = [{str(REPO / 'chip_smoke.py')!r}]\n"
        f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", env_code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
