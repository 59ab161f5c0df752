"""The port's ``analytics/`` against the JAX package's, on the CPU.

The registry rows must equal the JAX package's (names, schemas, parameters,
cache tokens, SLO classes, parameter errors), with every ref naming the
port's own modules. The kind solvers must give the JAX package's answers on
the same graphs, and the port's SciPy and NumPy oracles (the machine with
the card has no NetworkX) must give the JAX package's NetworkX oracles'
answers. Resolving every ref imports neither JAX, nor NetworkX, nor the
JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import analytics as janalytics
from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.analytics import solvers as jsolvers
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu_torch import analytics as tanalytics
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.analytics import solvers as tsolvers
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_ghs_implementation_tpu_torch"


def _pair(kind, seed):
    """The same graph in both packages: ``int`` and ``float`` weights with
    ties, ``forest`` (several components and isolated vertices)."""
    rng = np.random.default_rng(seed)
    if kind == "forest":
        parts = [(rng.integers(0, 15, 40) + 15 * p, rng.integers(0, 15, 40) + 15 * p)
                 for p in range(3)]
        u = np.concatenate([a for a, _ in parts])
        v = np.concatenate([b for _, b in parts])
        n = 50
    else:
        n = 60
        u, v = rng.integers(0, n, 200), rng.integers(0, n, 200)
    w = rng.integers(1, 8, u.size) if kind != "float" else rng.integers(1, 8, u.size) / 4.0
    return jedge.Graph.from_arrays(n, u, v, w), tedge.Graph.from_arrays(n, u, v, w)


def _solve_j(g):
    return japi.minimum_spanning_forest(g), "solved"


def _solve_t(g):
    return tapi.minimum_spanning_forest(g, device=CPU), "solved"


def test_registry_rows_equal_jax_and_name_the_port():
    assert tanalytics.known() == janalytics.known()
    for name in tanalytics.known():
        t, j = tanalytics.get(name), janalytics.get(name)
        assert (t.schema, t.params, t.cached, t.slo_class) == (j.schema, j.params, j.cached,
                                                               j.slo_class)
        for ref in (t.solver_ref, t.oracle_ref, t.certify_ref):
            assert ref is None or ref.startswith(PORT + ".")
        for ref_t, ref_j in ((t.solver_ref, j.solver_ref), (t.certify_ref, j.certify_ref)):
            assert (ref_t is None) == (ref_j is None)
            if ref_t is not None:
                assert ref_t.split(".", 1)[1] == ref_j.split(".", 1)[1]
    assert tanalytics.get(None).name == "mst"
    for kind, k in (("mst", None), ("components", None), ("k_msf", 4), ("path_max", None)):
        assert tanalytics.cache_token(kind, k=k) == janalytics.cache_token(kind, k=k)


@pytest.mark.parametrize("kind,request_", [
    ("k_msf", {"k": 3}), ("k_msf", {}), ("k_msf", {"k": 0}), ("k_msf", {"k": "x"}),
    ("path_max", {"u": 1, "v": 2}), ("path_max", {"u": 1}), ("bottleneck", {}),
    ("nope", {}),
])
def test_parse_params_equal_jax(kind, request_):
    outs = []
    for mod in (janalytics, tanalytics):
        try:
            outs.append(("ok", mod.parse_params(kind, request_)))
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", ["int", "float", "forest"])
def test_kind_solvers_equal_jax(kind):
    jg, tg = _pair(kind, 3)
    jr, js = jsolvers.solve_components(jg, _solve_j)
    tr, ts = tsolvers.solve_components(tg, _solve_t)
    assert np.array_equal(tr.edge_ids, jr.edge_ids) and tr.num_components == jr.num_components
    assert np.array_equal(tsolvers.labels_for_forest(tr), jsolvers.labels_for_forest(jr))
    for k in (1, 2, 5, 100):
        jt, _, jfull = jsolvers.solve_k_msf(jg, _solve_j, k)
        tt, _, tfull = tsolvers.solve_k_msf(tg, _solve_t, k)
        assert np.array_equal(tt.edge_ids, jt.edge_ids)
        assert (tt.num_components, tt.total_weight) == (jt.num_components, jt.total_weight)
    _, _, jb = jsolvers.solve_bottleneck(jg, _solve_j)
    _, _, tb = tsolvers.solve_bottleneck(tg, _solve_t)
    assert tb == jb
    n = tg.num_nodes
    for u, v in ((0, 7), (3, 3), (0, n - 5), (10, n - 1)):
        _, _, ja = jsolvers.solve_path_max(jg, _solve_j, u, v)
        _, _, ta = tsolvers.solve_path_max(tg, _solve_t, u, v)
        assert ta == ja
    with pytest.raises(ValueError, match="out of range"):
        tsolvers.path_max_of(tfull, 0, 1000)


@pytest.mark.parametrize("kind", ["int", "float", "forest"])
def test_scipy_oracles_equal_networkx_oracles(kind):
    jg, tg = _pair(kind, 5)
    assert tsolvers.oracle_components(tg) == jsolvers.oracle_components(jg)
    for k in (1, 3, 10, 100):
        t, j = tsolvers.oracle_k_msf_weight(tg, k), jsolvers.oracle_k_msf_weight(jg, k)
        assert t == j and type(t) is type(j)
    assert tsolvers.oracle_bottleneck(tg) == jsolvers.oracle_bottleneck(jg)
    n = tg.num_nodes
    for u, v in ((0, 7), (3, 3), (0, n - 5), (10, n - 1), (14, 1), (16, 29)):
        assert tsolvers.oracle_path_max(tg, u, v) == jsolvers.oracle_path_max(jg, u, v)
    from distributed_ghs_implementation_tpu.utils.verify import networkx_mst_weight

    mst_oracle = tanalytics.get("mst").oracle
    assert mst_oracle(tg) == pytest.approx(networkx_mst_weight(jg))
    empty_t = tedge.Graph.from_arrays(4, np.zeros(0, int), np.zeros(0, int), np.zeros(0, int))
    empty_j = jedge.Graph.from_arrays(4, np.zeros(0, int), np.zeros(0, int), np.zeros(0, int))
    assert tsolvers.oracle_bottleneck(empty_t) is jsolvers.oracle_bottleneck(empty_j) is None
    assert tsolvers.oracle_path_max(empty_t, 0, 1) == jsolvers.oracle_path_max(empty_j, 0, 1)


def test_every_ref_resolves_without_jax_networkx_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['networkx'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"from {PORT} import analytics\n"
        "n = 0\n"
        "for spec in analytics.KINDS.values():\n"
        "    for fn in (spec.solver, spec.oracle, spec.certify):\n"
        "        n += fn is not None\n"
        f"from {PORT}.graphs.generators import gnm_random_graph\n"
        f"from {PORT}.analytics import solvers\n"
        "g = gnm_random_graph(30, 80, seed=1)\n"
        "assert solvers.oracle_bottleneck(g) is not None\n"
        "assert solvers.oracle_path_max(g, 0, 5)['connected'] in (True, False)\n"
        "bad = [m for m in sys.modules if (m == 'distributed_ghs_implementation_tpu' or "
        "m.startswith('distributed_ghs_implementation_tpu.')) and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print(n)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "13"  # 15 refs, two of them None
