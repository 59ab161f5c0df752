"""The port's ``verify/`` against the JAX package's, on the CPU.

The port's certificate engine ``torch`` (plain PyTorch ops, never a hand
kernel) stands where the JAX package's ``xla`` engine stands. On the same
graphs and claims, the port's ``torch`` and ``np`` engines and the JAX
package's ``np`` and ``xla`` engines must give the same verdict, reason,
detail and counts, for a passing forest and for every failure reason. The
serving policy (``VerifyPolicy``, ``ResultVerifier``, ``AsyncAuditor``)
must count and correct as the JAX package's does.
"""

import dataclasses

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.verify import certify as jcert
from distributed_ghs_implementation_tpu.verify import policy as jpolicy
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.verify import certify as tcert
from distributed_ghs_implementation_tpu_torch.verify import policy as tpolicy
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "fresh")


@pytest.fixture
def fresh():
    for bus in (JBUS, TBUS):
        bus.clear()
    yield


def _pair(n, m, seed, *, float_w=False, parts=1):
    """The same graph in both packages; ``parts`` disjoint blocks."""
    rng = np.random.default_rng(seed)
    size = n // parts
    u = np.concatenate([rng.integers(0, size, m // parts) + p * size for p in range(parts)])
    v = np.concatenate([rng.integers(0, size, m // parts) + p * size for p in range(parts)])
    w = rng.random(u.size) * 10 if float_w else rng.integers(1, 20, u.size)
    return jedge.Graph.from_arrays(n, u, v, w), tedge.Graph.from_arrays(n, u, v, w)


def _verdict(cert):
    fields = dataclasses.asdict(cert)
    for key in ("engine", "check_s"):
        fields.pop(key)
    return fields


def _all_engines(fn_j, fn_t, *args, **kwargs):
    """The verdicts of the four engines; asserts each names its engine."""
    out = {}
    for name, fn, engine, extra in (("jax_np", fn_j, "np", {}), ("jax_xla", fn_j, "xla", {}),
                                    ("np", fn_t, "np", {"device": CPU}),
                                    ("torch", fn_t, "torch", {"device": CPU})):
        cert = fn(*args[0 if name.startswith("jax") else 1], engine=engine, **kwargs, **extra)
        assert cert.engine == engine
        out[name] = _verdict(cert)
    return out


def _check_equal(verdicts, reason):
    first = verdicts["jax_xla"]
    for name, v in verdicts.items():
        assert v == first, name
    assert first["reason"] == reason


def _msf(jg, tg):
    ids = tapi.minimum_spanning_forest(tg, device=CPU).edge_ids
    assert np.array_equal(ids, japi.minimum_spanning_forest(jg).edge_ids)
    return ids


def _heavier_swap(graph, ids):
    """One tree edge swapped for a heavier non-tree edge that reconnects
    the two sides: a spanning forest that is not minimal."""
    ids = np.asarray(ids)
    in_tree = np.zeros(graph.num_edges, dtype=bool)
    in_tree[ids] = True
    for drop in ids[np.argsort(graph.w[ids])]:
        keep = ids[ids != drop]
        labels = tedge.component_labels(graph.num_nodes, graph.u[keep], graph.v[keep])
        cross = np.nonzero(~in_tree & (labels[graph.u] != labels[graph.v])
                           & (graph.w > graph.w[drop]))[0]
        if cross.size:
            return np.sort(np.append(keep, cross[0]))
    raise AssertionError("no heavier replacement edge")


@pytest.mark.parametrize("case", ["int", "float", "forest", "path"])
def test_forest_certificate_equal_on_all_engines(case):
    if case == "path":  # a deep tree: many lifting levels
        n = 300
        u = np.arange(n - 1)
        jg = jedge.Graph.from_arrays(n, u, u + 1, np.ones(n - 1, dtype=np.int64))
        tg = tedge.Graph.from_arrays(n, u, u + 1, np.ones(n - 1, dtype=np.int64))
    else:
        jg, tg = _pair(120, 400, 3, float_w=case == "float",
                       parts=3 if case == "forest" else 1)
    ids = _msf(jg, tg)
    verdicts = _all_engines(jcert.certify_edge_ids, tcert.certify_edge_ids, (jg, ids),
                            (tg, ids))
    _check_equal(verdicts, None)
    assert verdicts["torch"]["ok"]
    bad = _heavier_swap(tg, ids) if case != "path" else None
    if bad is not None:
        verdicts = _all_engines(jcert.certify_edge_ids, tcert.certify_edge_ids, (jg, bad),
                                (tg, bad))
        _check_equal(verdicts, "not_minimal")
        assert verdicts["torch"]["violations"] >= 1


def test_path_max_query_equal_to_numpy():
    """The torch query against the NumPy one on random pairs of a random
    forest, deep and shallow."""
    rng = np.random.default_rng(4)
    n = 500
    parent = np.array([0] + [int(rng.integers(max(0, i - 3), i)) for i in range(1, n)])
    tu, tv = parent[1:], np.arange(1, n)
    ranks = rng.permutation(n - 1)
    p, depth, perank = tcert._root_forest(n, tu, tv, ranks)
    up, mx = tcert._lift_tables(p, perank, depth)
    a, b = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    got = tcert._path_max_torch(up, mx, depth, a, b, CPU)
    assert got.dtype == np.int64
    assert np.array_equal(got, tcert._path_max_np(up, mx, depth, a, b))


@pytest.mark.parametrize("reason", ["bad_edge_ids_range", "bad_edge_ids_dup", "cycle",
                                    "not_spanning", "metadata_mismatch"])
def test_each_forest_failure_equal_on_all_engines(reason):
    jg, tg = _pair(80, 240, 7, parts=2)
    ids = _msf(jg, tg)
    kwargs = {}
    if reason == "bad_edge_ids_range":
        claim = np.append(ids[1:], tg.num_edges)
    elif reason == "bad_edge_ids_dup":
        claim = np.append(ids[1:], ids[1])
    elif reason == "cycle":
        claim = np.sort(np.append(ids, np.setdiff1d(np.arange(tg.num_edges), ids)[0]))
    elif reason == "not_spanning":
        claim = ids[1:]
    else:
        claim, kwargs = ids, {"expect_components": 1}
    verdicts = _all_engines(jcert.certify_edge_ids, tcert.certify_edge_ids, (jg, claim),
                            (tg, claim), **kwargs)
    _check_equal(verdicts, reason.rsplit("_range", 1)[0].rsplit("_dup", 1)[0])


def test_kind_adapters_equal_on_all_engines():
    jg, tg = _pair(90, 260, 9, parts=3)
    ids = _msf(jg, tg)
    comps = int(np.unique(tedge.component_labels(90, tg.u, tg.v)).size)
    cases = [
        (jcert.certify_components, tcert.certify_components, ids, {}, None),
        (jcert.certify_components, tcert.certify_components, ids[1:], {}, "cross_edge"),
        (jcert.certify_components, tcert.certify_components, ids,
         {"expect_components": comps + 1}, "metadata_mismatch"),
        (jcert.certify_bottleneck, tcert.certify_bottleneck, ids,
         {"bottleneck_weight": float(tg.w[ids].max())}, None),
        (jcert.certify_bottleneck, tcert.certify_bottleneck, ids,
         {"bottleneck_weight": float(tg.w[ids].max()) + 1}, "weight_mismatch"),
    ]
    for fj, ft, claim, kw, reason in cases:
        _check_equal(_all_engines(fj, ft, (jg, claim), (tg, claim), **kw), reason)
    order = np.argsort(tg.w[ids], kind="stable")  # the tree edges by rank
    k = comps + 2
    want = 90 - k
    for k_, claim, reason in ((k, ids[np.sort(order[:want])], None),
                              (k, ids[np.sort(order[1:want + 1])], "not_spanning"),
                              (1, _heavier_swap(tg, ids), "not_minimal"),
                              (k, ids[:3], "not_spanning"),
                              (1, ids, None)):
        _check_equal(_all_engines(jcert.certify_k_forest, tcert.certify_k_forest,
                                  (jg, claim, k_), (tg, claim, k_)), reason)


def test_payload_claims_equal_on_all_engines():
    jg, tg = _pair(50, 150, 12)
    ids = _msf(jg, tg)
    edges = [[int(a), int(b), int(w)] for a, b, w in zip(tg.u, tg.v, tg.w)]
    pairs = [[int(tg.v[i]), int(tg.u[i])] for i in ids]  # reversed endpoints map back
    total = int(tg.w[ids].sum())
    cases = [
        (dict(mst_edges=pairs, total_weight=total), None),
        (dict(mst_edges=pairs, total_weight=total + 1), "weight_mismatch"),
        (dict(mst_edges=pairs[:-1] + [[0, 49]] if [0, 49] not in pairs else pairs[:-1]
              + [[1, 48]]), "unknown_edge"),
        (dict(mst_edges=[[0, 1, 2], [3]]), "malformed_claim"),
        (dict(mst_edges=pairs, kind="k_msf"), "malformed_claim"),
        (dict(mst_edges=pairs, kind="k_msf", k=2), "not_spanning"),
        (dict(mst_edges=pairs, kind="components", num_components=1), None),
        (dict(mst_edges=pairs, kind="bottleneck",
              bottleneck_weight=int(tg.w[ids].max())), None),
    ]
    for kw, reason in cases:
        verdicts = _all_engines(jcert.certify_claim, tcert.certify_claim, (50, edges),
                                (50, edges), **kw)
        _check_equal(verdicts, reason)
    assert tcert.describe_violations(tcert.certify_claim(50, edges, [[0, 1, 2]])) == \
        jcert.describe_violations(jcert.certify_claim(50, edges, [[0, 1, 2]]))


def test_engines_and_the_device_rule(monkeypatch):
    import torch

    jg, tg = _pair(30, 80, 1)
    ids = _msf(jg, tg)
    assert tcert._resolve_engine("auto") == "torch"
    assert tcert.certify_edge_ids(tg, ids, device=CPU).engine == "torch"
    with pytest.raises(ValueError, match="unknown certificate engine 'xla'"):
        tcert.certify_edge_ids(tg, ids, engine="xla", device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcert.certify_edge_ids(tg, ids)
    assert tcert.certify_edge_ids(tg, ids, engine="np").ok  # no device needed
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpolicy.ResultVerifier(tpolicy.VerifyPolicy("full"))
    tpolicy.ResultVerifier(tpolicy.VerifyPolicy("full", engine="np"))


def test_torch_engine_never_launches_a_hand_kernel(monkeypatch):
    """The certify engine shares nothing with the solver's kernels."""
    from distributed_ghs_implementation_tpu_torch.ops import kernels

    def bomb(*a, **k):
        raise AssertionError("the certify engine must not reach a kernel")

    _, tg = _pair(60, 200, 2)
    res = tapi.minimum_spanning_forest(tg, device=CPU)
    for w in kernels.WRAPPERS:
        monkeypatch.setattr(kernels, w.__name__, bomb)
    assert tcert.certify_result(res, device=CPU).ok
    assert not tcert.certify_edge_ids(tg, _heavier_swap(tg, res.edge_ids), device=CPU).ok


# ----------------------------------------------------------------------
# The policy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["full", "sample", "sample:4", "bulk=full,interactive=sample",
                                  "off", "", "default=full,bulk=off"])
def test_policy_parse_equals_jax(spec):
    jp, tp = jpolicy.VerifyPolicy.parse(spec), tpolicy.VerifyPolicy.parse(spec)
    assert tp.describe() == jp.describe() and tp.enabled == jp.enabled
    for cls in (None, "bulk", "interactive", "other"):
        assert tp.mode_for(cls) == jp.mode_for(cls)
        assert [tp.should_sample(cls) for _ in range(9)] == [jp.should_sample(cls)
                                                             for _ in range(9)]


def _poisoned(api_mod, graph, **kw):
    good = api_mod.minimum_spanning_forest(graph, **kw)
    return dataclasses.replace(good, edge_ids=_heavier_swap(graph, good.edge_ids)), good


def test_inline_check_refuses_and_corrects_as_jax():
    jg, tg = _pair(70, 220, 5)
    runs = {}
    for name, pol, api_mod, graph, bus, kw in (
            ("jax", jpolicy, japi, jg, JBUS, {}),
            ("port", tpolicy, tapi, tg, TBUS, {"device": CPU})):
        bad, good = _poisoned(api_mod, graph, **kw)
        calls = []
        verifier = pol.ResultVerifier(
            pol.VerifyPolicy.parse("full"),
            invalidate=lambda key, digest: calls.append(("invalidate", key, digest)),
            resolve=lambda g, backend: calls.append(("resolve", backend)) or good,
            **kw)
        result, verified = verifier.check(bad, cls=None, key="k", backend="device")
        assert verified == "full" and np.array_equal(result.edge_ids, good.edge_ids)
        again, _ = verifier.check(good, cls=None, key="k", backend="device")
        assert again is good
        verifier_broken = pol.ResultVerifier(pol.VerifyPolicy.parse("full"), **kw)
        with pytest.raises(pol.VerificationError):
            verifier_broken.check(bad, cls=None, key=None, backend="device")
        runs[name] = (calls, {k: v for k, v in bus.counters().items()
                              if k.startswith("verify.")})
    assert runs["port"] == runs["jax"]
    assert runs["port"][1]["verify.corrected"] == 1


def test_async_audit_evicts_a_failing_entry_as_jax():
    jg, tg = _pair(70, 220, 6)
    runs = {}
    for name, pol, api_mod, graph, bus, kw in (
            ("jax", jpolicy, japi, jg, JBUS, {}),
            ("port", tpolicy, tapi, tg, TBUS, {"device": CPU})):
        bad, good = _poisoned(api_mod, graph, **kw)
        evicted = []
        verifier = pol.ResultVerifier(pol.VerifyPolicy.parse("sample:2"),
                                      invalidate=lambda key, d: evicted.append(key), **kw)
        marks = [verifier.check(r, cls="c", key=f"k{i}", backend="device")[1]
                 for i, r in enumerate((bad, good, good, bad))]
        assert verifier.audit(bad, cls="c", key="upd") in ("audit", None)
        assert verifier.auditor.flush(timeout_s=30)
        runs[name] = (marks, evicted, {k: v for k, v in bus.counters().items()
                                       if k.startswith("verify.")})
    assert runs["port"] == runs["jax"]
    assert runs["port"][1][0] == "k0" and runs["port"][2]["verify.audit.failed"] >= 1
