"""Thin per-kind solver wrappers over the scheduler's MSF solve.

Every kind here is derived from the same GHS/Borůvka level loop the MST
path runs (``models/boruvka.py`` via the injected ``solve`` callable — in
the service that is ``SolveScheduler.solve``, so analytics traffic rides
single-flight dedup, admission control, the batch engine, the sharded
oversize lane, and supervision for free):

* ``components`` — the *weight-free* instantiation: solve the graph's
  index-weighted twin (rank = edge position; any all-distinct rank yields
  the same connectivity), producing a connectivity forest whose labels are
  the component answer.
* ``k_msf`` — full MSF, then trim to the lightest ``n - max(k, c)`` tree
  edges by solver rank. The early exit at ``k`` fragments, an obvious
  short cut, is **unsound** and deliberately not used: with edges
  ``(0,1,w=1) (2,3,w=2) (0,2,w=5) (4,5,w=10)`` on 6 nodes, Borůvka's first
  level adds MOEs ``{1, 2, 10}`` and reaches exactly 3 fragments with total
  13, while the optimal 3-forest drops the heaviest MST edge (``w=10``)
  from the 4-edge MSF for total 8. Cut-property trimming is exact (the
  k-forest matroid optimum is the lightest ``n - k'`` MST edges); early
  exit commits to whole levels and cannot shed the heavy MOE a later level
  would have made droppable.
* ``bottleneck`` — the max-tree-edge reduction over the MSF (the minimum
  bottleneck spanning value; unique across MSTs since all MSTs share one
  sorted weight sequence).
* ``path_max`` — :func:`serve.dynamic.tree_path_max` over the MSF's tree
  arrays: the minimax (bottleneck-optimal) edge between two nodes.

``solve`` contract: ``solve(graph) -> (MSTResult, source_str)``.

Port of the JAX package's ``analytics/solvers.py``. The solvers are that
package's; the oracles are SciPy and NumPy forms of its NetworkX oracles
(the machine with the card has no NetworkX), built on the SciPy rank
oracle (``utils/verify.rank_oracle_edge_ids``), which shares nothing with
the solver. Tests hold them equal to the NetworkX oracles on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.api import MSTResult
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
    Graph,
    component_labels,
)

SolveFn = Callable[[Graph], Tuple[MSTResult, str]]


# -- shared plumbing ---------------------------------------------------------

def connectivity_graph(graph: Graph) -> Graph:
    """The index-weighted twin used by the ``components`` kind.

    Built with the **direct** :class:`Graph` constructor, not
    ``from_arrays``: ``graph`` is already canonical (sorted, deduped,
    ``u < v``), so reusing its endpoint arrays guarantees 1:1 edge-id
    alignment — edge ``i`` of the twin IS edge ``i`` of the original, and
    the twin's MSF edge ids can be read back against the original graph.
    ``from_arrays`` would re-canonicalize and could in principle re-dedup,
    breaking that alignment.
    """
    m = graph.num_edges
    return Graph(
        graph.num_nodes,
        graph.u,
        graph.v,
        np.arange(m, dtype=np.int32),
    )


def edge_ranks(graph: Graph) -> np.ndarray:
    """Each edge's position in the solver's ``(w, edge id)`` total order."""
    order = np.argsort(graph.w, kind="stable")
    ranks = np.empty(graph.num_edges, dtype=np.int64)
    ranks[order] = np.arange(graph.num_edges)
    return ranks


def labels_for_forest(result: MSTResult) -> np.ndarray:
    """Component labels (``0..k-1``, scipy ordering) implied by a forest
    result — exact for any maximal spanning forest, MSF included."""
    g = result.graph
    ids = result.edge_ids
    return component_labels(g.num_nodes, g.u[ids], g.v[ids])


def partition_from_labels(labels) -> frozenset:
    """Label array → canonical partition (frozenset of node frozensets),
    the representation both oracle and served labels are compared in —
    label *values* are arbitrary, the grouping is the answer."""
    groups: dict = {}
    for node, lab in enumerate(np.asarray(labels).tolist()):
        groups.setdefault(lab, []).append(node)
    return frozenset(frozenset(g) for g in groups.values())


# -- per-kind solvers --------------------------------------------------------

def solve_components(
    graph: Graph, solve: SolveFn
) -> Tuple[MSTResult, str]:
    """Connectivity forest of ``graph`` via the weight-free level loop.

    Returns an :class:`MSTResult` whose ``graph`` is the **original** graph
    (so store digest validation and disk round trips under the kind key
    work unchanged) and whose ``edge_ids`` form a maximal spanning forest —
    a complete connectivity certificate. Labels are derived on demand by
    :func:`labels_for_forest`.
    """
    inner, source = solve(connectivity_graph(graph))
    return (
        MSTResult(
            graph=graph,
            edge_ids=np.asarray(inner.edge_ids).copy(),
            num_levels=inner.num_levels,
            wall_time_s=inner.wall_time_s,
            backend=inner.backend,
            num_components=inner.num_components,
        ),
        source,
    )


def trim_to_k_forest(result: MSTResult, k: int) -> MSTResult:
    """The optimal ``k``-forest derived from a full MSF result: keep the
    lightest ``n - k'`` tree edges by solver rank, ``k' = min(n, max(k,
    c))`` (``c`` = the graph's component count — fewer than ``c`` parts is
    infeasible, hence the *relaxed* spanning predicate)."""
    g = result.graph
    n = g.num_nodes
    k_eff = min(n, max(int(k), int(result.num_components)))
    keep = max(0, n - k_eff)
    ids = np.asarray(result.edge_ids)
    ranks = edge_ranks(g)[ids]
    trimmed = ids[np.argsort(ranks, kind="stable")][:keep]
    return MSTResult(
        graph=g,
        edge_ids=np.sort(trimmed),
        num_levels=result.num_levels,
        wall_time_s=result.wall_time_s,
        backend=result.backend,
        num_components=k_eff,
    )


def solve_k_msf(
    graph: Graph, solve: SolveFn, k: int
) -> Tuple[MSTResult, str, MSTResult]:
    """Optimal ``k``-forest: full MSF (shared with the ``mst`` cache entry),
    then :func:`trim_to_k_forest`. Returns ``(trimmed, source, full_msf)``
    — the caller caches the trimmed answer under the kind key and may park
    the full MSF as the digest's session seed."""
    inner, source = solve(graph)
    return trim_to_k_forest(inner, k), source, inner


def bottleneck_of(result: MSTResult) -> Optional[tuple]:
    """The max tree edge by the solver's ``(w, u, v)`` order: ``(weight, u,
    v)``, or ``None`` for an edgeless forest. Its weight is the minimum
    bottleneck spanning value of the graph."""
    ids = np.asarray(result.edge_ids)
    if ids.size == 0:
        return None
    g = result.graph
    u, v, w = g.u[ids], g.v[ids], g.w[ids]
    top = int(np.lexsort((v, u, w))[-1])
    cast = int if g.is_integer_weighted else float
    return (cast(w[top]), int(u[top]), int(v[top]))


def solve_bottleneck(
    graph: Graph, solve: SolveFn
) -> Tuple[MSTResult, str, Optional[tuple]]:
    """Minimum bottleneck spanning value: the MSF plus its max-tree-edge
    reduction. Returns ``(mst_result, source, (weight, u, v) | None)``."""
    inner, source = solve(graph)
    return inner, source, bottleneck_of(inner)


def path_max_of(result: MSTResult, u: int, v: int) -> dict:
    """Minimax edge between ``u`` and ``v`` over the forest: ``{"connected",
    "weight", "edge"}``. ``u == v`` is trivially connected with no edge;
    different fragments report ``connected: False``."""
    from distributed_ghs_implementation_tpu_torch.serve.dynamic import tree_path_max

    g = result.graph
    n = g.num_nodes
    u, v = int(u), int(v)
    if not (0 <= u < n and 0 <= v < n):
        raise ValueError(f"path_max endpoints out of range: ({u}, {v}), n={n}")
    if u == v:
        return {"connected": True, "weight": None, "edge": None}
    ids = np.asarray(result.edge_ids)
    rel = tree_path_max(n, g.u[ids], g.v[ids], g.w[ids], u, v)
    if rel is None:
        return {"connected": False, "weight": None, "edge": None}
    idx = int(ids[rel])
    cast = int if g.is_integer_weighted else float
    return {
        "connected": True,
        "weight": cast(g.w[idx]),
        "edge": (int(g.u[idx]), int(g.v[idx])),
    }


def solve_path_max(
    graph: Graph, solve: SolveFn, u: int, v: int
) -> Tuple[MSTResult, str, dict]:
    """Minimax path query: MSF (cache-shared with ``mst``) +
    :func:`path_max_of`. Returns ``(mst_result, source, answer_dict)``."""
    inner, source = solve(graph)
    return inner, source, path_max_of(inner, u, v)


# -- SciPy and NumPy oracles -------------------------------------------------
#
# The exactness contracts, in the JAX package's tie-independent
# representations: partitions for components, total weight for k-MSF (the
# sorted MSF weight multiset is unique across tie-breaks), the bottleneck
# scalar, and the minimax path value.

def _oracle_msf(graph: Graph) -> np.ndarray:
    """The exact MSF's edge ids from SciPy (ranks as distinct weights)."""
    from distributed_ghs_implementation_tpu_torch.utils.verify import (
        rank_oracle_edge_ids,
    )

    return rank_oracle_edge_ids(graph)


def _cast(graph: Graph, x):
    return int(x) if graph.is_integer_weighted else float(x)


def oracle_components(graph: Graph) -> frozenset:
    """Canonical partition via ``scipy.sparse.csgraph.connected_components``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = graph.num_nodes
    adj = coo_matrix(
        (np.ones(graph.num_edges, dtype=np.int8), (graph.u, graph.v)), shape=(n, n)
    )
    _, labels = connected_components(adj, directed=False)
    return partition_from_labels(labels)


def oracle_k_msf_weight(graph: Graph, k: int):
    """Total weight of the optimal ``k``-forest: lightest ``n - max(k, c)``
    MSF edges by weight (tie-independent — all MSFs share one sorted
    weight sequence)."""
    weights = np.sort(graph.w[_oracle_msf(graph)])
    n = graph.num_nodes
    c = n - weights.size
    keep = max(0, n - min(n, max(int(k), c)))
    return _cast(graph, weights[:keep].sum())


def oracle_bottleneck(graph: Graph):
    """Max edge weight of the MSF (``None`` when edgeless)."""
    ids = _oracle_msf(graph)
    if ids.size == 0:
        return None
    return _cast(graph, graph.w[ids].max())


def oracle_path_max(graph: Graph, u: int, v: int) -> dict:
    """Minimax path value between ``u`` and ``v``: max edge weight on the
    MSF path (the optimum over all graph paths, and unique), found by a
    SciPy breadth-first search of the forest from ``u``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    u, v = int(u), int(v)
    if u == v:
        return {"connected": True, "weight": None}
    n = graph.num_nodes
    ids = _oracle_msf(graph)
    tu, tv, tw = graph.u[ids], graph.v[ids], graph.w[ids]
    adj = coo_matrix(
        (np.ones(2 * ids.size, dtype=np.int8),
         (np.concatenate([tu, tv]), np.concatenate([tv, tu]))),
        shape=(n, n),
    ).tocsr()
    _, pred = breadth_first_order(adj, u, directed=False, return_predecessors=True)
    if pred[v] < 0:
        return {"connected": False, "weight": None}
    weight_of = {}
    for a, b, w in zip(tu.tolist(), tv.tolist(), tw.tolist()):
        weight_of[(a, b)] = weight_of[(b, a)] = w
    top = None
    node = v
    while node != u:
        w = weight_of[(int(pred[node]), node)]
        top = w if top is None else max(top, w)
        node = int(pred[node])
    return {"connected": True, "weight": _cast(graph, top)}
