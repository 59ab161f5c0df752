"""Host oracles for the port: SciPy, the native Kruskal pass, NetworkX.

``scipy.sparse.csgraph`` sorts the edges itself, so it is independent of
the code under test; it is the oracle of every small graph and of float
weights. The native Kruskal pass (``graphs/native.py``) walks the graph's
own ``(weight, edge id)`` rank order, which it checks, and is the oracle of
integer-weighted graphs above 200,000 edges, as in the JAX package. NetworkX
is the reference's oracle; the machine with the card has no NetworkX, so it
is imported only when it is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph


#: ``verify_result(oracle="auto")`` takes the native pass above this many edges.
AUTO_NATIVE_MIN_EDGES = 200_000


def _networkx():
    try:
        import networkx
    except ImportError as e:
        raise ImportError("this oracle needs NetworkX, which is not installed") from e
    return networkx


def networkx_mst_weight(graph: Graph) -> float:
    """Minimum-spanning-forest weight per NetworkX (the reference's oracle)."""
    mst = _networkx().minimum_spanning_tree(graph.to_networkx())
    return sum(d["weight"] for _, _, d in mst.edges(data=True))


def networkx_mst_edges(graph: Graph) -> set:
    """NetworkX's forest as ``{(min(a, b), max(a, b))}``: the forest only
    where it is unique (distinct weights)."""
    mst = _networkx().minimum_spanning_tree(graph.to_networkx())
    return {(min(a, b), max(a, b)) for a, b in mst.edges()}


def native_mst_weight(graph: Graph) -> Optional[float]:
    """Minimum-spanning-forest weight from one native Kruskal pass over the
    graph's ``(weight, edge id)`` rank order (``native.kruskal_msf``).

    ``None`` where no native pass applies: float weights, or no edges. A
    library that cannot be built raises ``KernelBuildError``, and an order
    that is not a weight-nondecreasing permutation of the edges raises
    ``ValueError``: the solver shares that order, so neither is hidden."""
    if not graph.is_integer_weighted or graph.num_edges == 0:
        return None
    from distributed_ghs_implementation_tpu_torch.graphs import native

    total, _count = native.kruskal_msf(graph.num_nodes, graph._rank_order, graph.u, graph.v,
                                       graph.w)
    return float(total)


def scipy_mst_weight(graph: Graph) -> float:
    """Minimum-spanning-forest weight via ``scipy.sparse.csgraph``.

    ``csgraph`` treats zero entries as absent edges and ``coo_matrix`` sums
    duplicate coordinates, so edges are deduped (min weight) and shifted
    positive first; the shift is subtracted back out per forest edge.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree as sp_mst

    n = graph.num_nodes
    u, v, w = graph.u, graph.v, graph.w.astype(np.float64)
    if u.size:
        order = np.lexsort((w, v, u))
        u, v, w = u[order], v[order], w[order]
        first = np.ones(u.size, dtype=bool)
        first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
        u, v, w = u[first], v[first], w[first]
    shift = 1.0 - min(0.0, float(w.min()) if w.size else 0.0)
    t = sp_mst(coo_matrix((w + shift, (u, v)), shape=(n, n)))
    return float(t.sum() - shift * t.nnz)


def rank_oracle_edge_ids(graph: Graph) -> np.ndarray:
    """The exact minimum spanning forest as sorted edge ids.

    Ranks the edges by ``(weight, edge id)`` here, independently of the
    solver's staging, and runs SciPy's minimum spanning tree with weights
    ``rank + 1``. Those weights are distinct, so the forest is unique, and
    each forest entry maps back to its edge through its weight.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree as sp_mst

    m = graph.num_edges
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.lexsort((np.arange(m), graph.w))  # edge id of each rank
    u, v = graph.u[order], graph.v[order]
    # Parallel edges: keep the lowest rank of each pair (coo sums duplicates).
    _, first = np.unique(u * graph.num_nodes + v, return_index=True)
    weights = first.astype(np.float64) + 1.0
    t = sp_mst(coo_matrix((weights, (u[first], v[first])),
                          shape=(graph.num_nodes, graph.num_nodes)))
    ranks = t.tocoo().data.astype(np.int64) - 1
    return np.sort(order[ranks])


@dataclasses.dataclass
class Verification:
    ok: bool
    expected_weight: float
    actual_weight: float
    expected_edges: int
    actual_edges: int
    oracle: str

    def __bool__(self) -> bool:
        return self.ok


def verify_result(
    result,
    *,
    oracle: str = "auto",
    atol: float = 1e-6,
    expected_weight: float | None = None,
) -> Verification:
    """Check an :class:`~distributed_ghs_implementation_tpu_torch.api.MSTResult`.

    Checks weight parity with the oracle and the edge count ``n - c`` for
    ``c`` components; together they imply an exact minimum spanning forest.
    ``oracle``: ``native``, ``scipy``, ``networkx``, or ``auto``, which is
    ``native`` above :data:`AUTO_NATIVE_MIN_EDGES` edges and ``scipy``
    otherwise (the JAX package takes NetworkX there; the card's machine has
    none). ``native`` on float weights reports ``scipy``, the oracle it
    fell back to. ``expected_weight`` checks against a recorded weight
    instead (``oracle`` reads ``recorded``).
    """
    graph: Graph = result.graph
    if expected_weight is not None:
        expected = float(expected_weight)
        oracle = "recorded"
    else:
        if oracle == "auto":
            oracle = "native" if graph.num_edges > AUTO_NATIVE_MIN_EDGES else "scipy"
        if oracle == "native":
            expected = native_mst_weight(graph)
            if expected is None:
                oracle = "scipy"
        if oracle == "scipy":
            expected = scipy_mst_weight(graph)
        elif oracle == "networkx":
            expected = networkx_mst_weight(graph)
        elif oracle != "native":
            raise ValueError(
                f"unknown oracle {oracle!r}; expected auto, native, scipy or networkx")
    actual = result.total_weight
    expected_edges = graph.num_nodes - result.num_components
    ok = abs(float(expected) - float(actual)) <= atol and result.num_edges == expected_edges
    return Verification(
        ok=ok,
        expected_weight=float(expected),
        actual_weight=float(actual),
        expected_edges=expected_edges,
        actual_edges=result.num_edges,
        oracle=oracle,
    )
