"""MST certificates: prove a claimed forest IS the minimum spanning forest.

A certificate check costs O(m α + m log n) — union-find over the claimed
tree edges plus one batch of tree path-max queries — against the O(m log n)
*per level* of re-solving, and runs through an entirely independent code
path: no Borůvka kernel, no hand-written CUDA kernel, no fragment arrays.
That independence
is the point. The solver stack routes through fused kernels, donated
device buffers, disk caches, WAL replay, and cross-host forwarding; any of
those can hand back a *plausible* wrong answer (the reference
implementation served weight-57 "MSTs" whose true weight was 53 and never
noticed). The certificate re-derives correctness from first principles:

1. **Forest validity** — the claimed edge ids are in range and distinct,
   and union-find over them finds no cycle (``bad_edge_ids`` / ``cycle``).
2. **Spanning parity** — the claimed forest has exactly as many components
   as the input graph: dropping a component (or splitting one) is caught
   by comparing component counts (``not_spanning``).
3. **Cycle property** — every non-tree edge is heavier than every tree
   edge on the path between its endpoints (``not_minimal``). Weights are
   compared as *ranks* in the total order ``(weight, edge id)`` — the same
   tie-breaking contract the whole repo solves under — so the MSF is
   unique and conditions 1–3 are necessary AND sufficient: a passing
   certificate means the claimed forest is edge-for-edge THE minimum
   spanning forest, not merely one of equal weight.

The path-max queries use binary lifting over the rooted claimed forest
(ancestor tables ``up[k][v]`` and max-edge-rank tables ``mx[k][v]``,
``k ≤ log2(depth)``), answered for all non-tree edges at once. Two
engines share the host-built tables:

* ``engine="np"`` — pure NumPy.
* ``engine="torch"`` — the same query in plain PyTorch ops on an explicit
  device (``device=None`` means CUDA). It is deliberately never one of the
  port's hand kernels, so a kernel-routed solve is cross-checked by a code
  path that shares nothing with the kernel under suspicion. The JAX
  package's counterpart is its ``engine="xla"`` (plain XLA, never Pallas).

``engine="auto"`` means ``torch``. Both engines are bit-identical (tests
pin it, against the JAX package's ``xla`` engine too). This is the JAX
package's ``verify/certify.py`` with that engine in place of ``xla``;
reasons and :class:`Certificate` fields are that package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS

#: Failure reasons, in check order. ``None`` reason == certificate passed.
REASONS = (
    "bad_edge_ids",   # out of range / duplicate claimed edge ids
    "cycle",          # claimed edges close a cycle (not a forest)
    "not_spanning",   # component count differs from the input graph
    "cross_edge",     # components claim: a graph edge crosses two claimed
                      # components (the forest is not maximal)
    "not_minimal",    # a non-tree edge beats a tree edge on its path
    "unknown_edge",   # a claimed (u, v) pair is not an input edge
    "weight_mismatch",  # claimed total weight != recomputed edge sum
    "metadata_mismatch",  # claimed component count != certified count
    "malformed_claim",  # the claim could not even be parsed as edges
)


@dataclasses.dataclass
class Certificate:
    """One verification verdict. ``bool(cert)`` is ``cert.ok``."""

    ok: bool
    reason: Optional[str]  # one of REASONS, None when ok
    detail: str = ""
    num_tree_edges: int = 0
    expected_edges: int = 0
    num_components: int = 0       # of the certified forest
    graph_components: int = 0     # of the input graph
    violations: int = 0           # offending non-tree edges (not_minimal)
    engine: str = "np"
    check_s: float = 0.0

    def __bool__(self) -> bool:
        return self.ok

    def summary(self) -> dict:
        out = {"ok": self.ok, "engine": self.engine,
               "check_s": round(self.check_s, 6)}
        if not self.ok:
            out["reason"] = self.reason
            out["detail"] = self.detail
        return out


def _fail(reason: str, detail: str, **fields) -> Certificate:
    return Certificate(ok=False, reason=reason, detail=detail, **fields)


def _edge_ranks(graph: Graph) -> np.ndarray:
    """Rank of each edge in the total order ``(weight, edge id)`` —
    re-derived here with a plain stable argsort (never the graph's cached
    native-sorted order: the certificate must not trust inputs it can
    cheaply recompute)."""
    order = np.argsort(graph.w, kind="stable")
    rank = np.empty(graph.num_edges, dtype=np.int64)
    rank[order] = np.arange(graph.num_edges, dtype=np.int64)
    return rank


def _components(num_nodes: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Component label per vertex (C-speed scipy union-find equivalent)."""
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
        component_labels,
    )

    return component_labels(num_nodes, u, v)


def _root_forest(
    num_nodes: int, tu: np.ndarray, tv: np.ndarray, tranks: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Root the claimed forest: ``(parent, depth, parent_edge_rank)``.

    BFS with predecessors via scipy (C speed, depth-independent — a road
    network MST is a few vertices wide and tens of thousands deep, where a
    level-synchronous NumPy BFS would crawl). Roots carry ``parent ==
    self`` and ``parent_edge_rank == -1`` (the neutral element under max).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    parent = np.arange(num_nodes, dtype=np.int64)
    depth = np.zeros(num_nodes, dtype=np.int64)
    perank = np.full(num_nodes, -1, dtype=np.int64)
    if tu.size == 0:
        return parent, depth, perank
    adj = coo_matrix(
        (np.ones(2 * tu.size, dtype=np.int8),
         (np.concatenate([tu, tv]), np.concatenate([tv, tu]))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    labels = _components(num_nodes, tu, tv)
    # One BFS per NON-TRIVIAL tree component, from its first vertex.
    # Singleton components (isolated vertices — RMAT graphs have tens of
    # thousands) are already correct as self-parented roots; a scipy BFS
    # call per singleton turned an RMAT-17 certificate into minutes.
    uniq, first = np.unique(labels, return_index=True)
    sizes = np.bincount(labels, minlength=uniq.max() + 1 if uniq.size else 0)
    first = first[sizes[uniq] >= 2]
    seen = np.zeros(num_nodes, dtype=bool)
    for root in first:
        if seen[root]:
            continue
        order, pred = breadth_first_order(
            adj, int(root), directed=False, return_predecessors=True
        )
        seen[order] = True
        pred = pred[order]
        has_parent = order != root
        kids = order[has_parent]
        parent[kids] = pred[has_parent]
    # Parent-edge ranks by packed-key binary search over both orientations
    # of the tree edges (child-side key -> the connecting edge's rank).
    src = np.concatenate([tu, tv]).astype(np.int64)
    dst = np.concatenate([tv, tu]).astype(np.int64)
    ranks2 = np.concatenate([tranks, tranks]).astype(np.int64)
    key = src * num_nodes + dst
    korder = np.argsort(key)
    key, ranks2 = key[korder], ranks2[korder]
    child = np.nonzero(parent != np.arange(num_nodes, dtype=np.int64))[0]
    want = parent[child] * num_nodes + child
    perank[child] = ranks2[np.searchsorted(key, want)]
    # Depth by pointer doubling: after k rounds, cnt(v) = min(depth(v),
    # 2^k) — converges in log2(max depth) vectorized passes, so a
    # 10^5-deep road-network MST costs ~17 array ops, not 10^5.
    idx = np.arange(num_nodes, dtype=np.int64)
    anc = parent.copy()
    depth = (anc != idx).astype(np.int64)
    while True:
        nxt = anc[anc]
        if np.array_equal(nxt, anc):
            break
        depth = depth + depth[anc]
        anc = nxt
    return parent, depth, perank


def _lift_tables(
    parent: np.ndarray, perank: np.ndarray, depth: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary-lifting tables ``(up[K, n], mx[K, n])``: ``up[k][v]`` is
    ``v``'s ``2^k``-th ancestor, ``mx[k][v]`` the max tree-edge rank on
    that ancestor path (-1 past the root)."""
    n = parent.shape[0]
    levels = max(1, int(depth.max()).bit_length()) if n else 1
    # Rounded up to a multiple of 4, as in the JAX package (the recurrence
    # is closed past the root: up saturates at the root, mx at -1 — extra
    # levels are semantically inert).
    levels = -(-levels // 4) * 4
    up = np.empty((levels, n), dtype=np.int64)
    mx = np.empty((levels, n), dtype=np.int64)
    up[0] = parent
    mx[0] = perank
    for k in range(1, levels):
        up[k] = up[k - 1][up[k - 1]]
        mx[k] = np.maximum(mx[k - 1], mx[k - 1][up[k - 1]])
    return up, mx


def _path_max_np(
    up: np.ndarray, mx: np.ndarray, depth: np.ndarray,
    a: np.ndarray, b: np.ndarray,
) -> np.ndarray:
    """Max tree-edge rank on the tree path ``a[i] .. b[i]``, vectorized
    over all queries at once (the NumPy engine)."""
    K = up.shape[0]
    a = a.copy()
    b = b.copy()
    best = np.full(a.shape[0], -1, dtype=np.int64)
    # Lift the deeper endpoint up to the shallower one's depth.
    diff = depth[a] - depth[b]
    swap = diff < 0
    a[swap], b[swap] = b[swap], a[swap]
    diff = np.abs(diff)
    for k in range(K):
        take = (diff >> k) & 1 == 1
        best[take] = np.maximum(best[take], mx[k][a[take]])
        a[take] = up[k][a[take]]
    # Lift both while their 2^k ancestors differ; afterwards both sit one
    # step below the LCA.
    meet = a == b
    for k in range(K - 1, -1, -1):
        split = ~meet & (up[k][a] != up[k][b])
        best[split] = np.maximum(
            best[split], np.maximum(mx[k][a[split]], mx[k][b[split]])
        )
        a[split] = up[k][a[split]]
        b[split] = up[k][b[split]]
    final = ~meet
    best[final] = np.maximum(
        best[final], np.maximum(mx[0][a[final]], mx[0][b[final]])
    )
    return best


def _path_max_torch(
    up: np.ndarray, mx: np.ndarray, depth: np.ndarray,
    a: np.ndarray, b: np.ndarray, device,
) -> np.ndarray:
    """The same query batch in plain PyTorch ops on ``device`` — no hand
    kernel anywhere on this path. Tables are int32 (vertex ids and edge
    ranks both fit: the certify entry points bound ``n`` and ``m`` below
    2^31); every gather indexes with int64."""
    import torch

    up_t = torch.from_numpy(np.ascontiguousarray(up, dtype=np.int32)).to(device)
    mx_t = torch.from_numpy(np.ascontiguousarray(mx, dtype=np.int32)).to(device)
    depth_t = torch.from_numpy(np.ascontiguousarray(depth, dtype=np.int32)).to(device)
    aq = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)
    bq = torch.from_numpy(np.ascontiguousarray(b, dtype=np.int64)).to(device)
    levels = up_t.shape[0]
    da, db = depth_t[aq], depth_t[bq]
    swap = da < db
    aq, bq = torch.where(swap, bq, aq), torch.where(swap, aq, bq)
    diff = (da - db).abs()
    best = torch.full(aq.shape, -1, dtype=torch.int32, device=device)
    # Lift the deeper endpoint up to the shallower one's depth.
    for k in range(levels):
        take = ((diff >> k) & 1) == 1
        best = torch.where(take, torch.maximum(best, mx_t[k][aq]), best)
        aq = torch.where(take, up_t[k][aq].long(), aq)
    # Lift both while their 2^k ancestors differ; afterwards both sit one
    # step below the LCA.
    meet = aq == bq
    for k in range(levels - 1, -1, -1):
        ua, ub = up_t[k][aq], up_t[k][bq]
        split = ~meet & (ua != ub)
        cand = torch.maximum(mx_t[k][aq], mx_t[k][bq])
        best = torch.where(split, torch.maximum(best, cand), best)
        aq = torch.where(split, ua.long(), aq)
        bq = torch.where(split, ub.long(), bq)
    last = torch.maximum(mx_t[0][aq], mx_t[0][bq])
    out = torch.where(meet, best, torch.maximum(best, last))
    return out.cpu().numpy().astype(np.int64)


ENGINES = ("np", "torch")


def _resolve_engine(engine: str) -> str:
    """``auto`` means ``torch``."""
    if engine == "auto":
        return "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown certificate engine {engine!r}")
    return engine


def _engine_device(engine: str, device):
    """The device the ``torch`` engine runs on (``None`` = CUDA; raises
    without CUDA); nothing for ``np``."""
    if engine != "torch":
        return None
    from distributed_ghs_implementation_tpu_torch.device import resolve_device

    return resolve_device(device)


def certify_edge_ids(
    graph: Graph,
    edge_ids: np.ndarray,
    *,
    engine: str = "auto",
    expect_components: Optional[int] = None,
    device=None,
) -> Certificate:
    """Certify that ``edge_ids`` (indices into ``graph.u/v/w``) are THE
    minimum spanning forest of ``graph``. See the module docstring for
    what a passing certificate proves. ``device`` is where the ``torch``
    engine runs (``None`` = CUDA)."""
    t0 = time.perf_counter()
    engine = _resolve_engine(engine)
    n, m = graph.num_nodes, graph.num_edges
    if engine == "torch" and max(n, m) >= 2**31:
        engine = "np"  # the torch engine's tables are int32
    dev = _engine_device(engine, device)

    def done(cert: Certificate) -> Certificate:
        cert.engine = engine
        cert.check_s = time.perf_counter() - t0
        BUS.count("verify.checks")
        BUS.record("verify.check_s", cert.check_s)
        return cert

    ids = np.asarray(edge_ids, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= m):
        return done(_fail(
            "bad_edge_ids",
            f"edge id out of range [0, {m}): "
            f"[{ids.min()}, {ids.max()}]",
        ))
    if np.unique(ids).size != ids.size:
        return done(_fail(
            "bad_edge_ids",
            f"{ids.size - np.unique(ids).size} duplicate edge ids claimed",
        ))

    tu, tv = graph.u[ids], graph.v[ids]
    tree_labels = _components(n, tu, tv)
    c_tree = int(np.unique(tree_labels).size) if n else 0
    if ids.size != n - c_tree:
        # More claimed edges than a forest on these components can hold ==
        # at least one cycle (self-loops/duplicates were already rejected).
        return done(_fail(
            "cycle",
            f"{ids.size} claimed edges over {c_tree} components "
            f"(a forest has exactly {n - c_tree})",
            num_tree_edges=int(ids.size), num_components=c_tree,
        ))
    c_graph = (
        int(np.unique(_components(n, graph.u, graph.v)).size) if n else 0
    )
    if c_tree != c_graph:
        return done(_fail(
            "not_spanning",
            f"claimed forest has {c_tree} components, the input graph "
            f"has {c_graph} — a component was dropped or split",
            num_tree_edges=int(ids.size),
            num_components=c_tree, graph_components=c_graph,
            expected_edges=n - c_graph,
        ))
    if expect_components is not None and int(expect_components) != c_graph:
        return done(_fail(
            "metadata_mismatch",
            f"result metadata claims {expect_components} components, "
            f"certificate finds {c_graph}",
            num_tree_edges=int(ids.size),
            num_components=c_tree, graph_components=c_graph,
        ))

    # Cycle property over ranks: every non-tree edge must out-rank every
    # tree edge on the path between its endpoints.
    if m and ids.size:
        rank = _edge_ranks(graph)
        in_tree = np.zeros(m, dtype=bool)
        in_tree[ids] = True
        parent, depth, perank = _root_forest(n, tu, tv, rank[ids])
        up, mx = _lift_tables(parent, perank, depth)
        nt = np.nonzero(~in_tree)[0]
        if nt.size:
            if engine == "torch":
                path_max = _path_max_torch(
                    up, mx, depth, graph.u[nt], graph.v[nt], dev
                )
            else:
                path_max = _path_max_np(up, mx, depth, graph.u[nt], graph.v[nt])
            bad = rank[nt] < path_max
            if bad.any():
                worst = nt[bad][:4]
                return done(_fail(
                    "not_minimal",
                    f"{int(bad.sum())} non-tree edges are lighter than a "
                    f"tree edge on their path (e.g. edge ids "
                    f"{worst.tolist()})",
                    num_tree_edges=int(ids.size),
                    num_components=c_tree, graph_components=c_graph,
                    expected_edges=n - c_graph,
                    violations=int(bad.sum()),
                ))
    return done(Certificate(
        ok=True, reason=None,
        num_tree_edges=int(ids.size), expected_edges=n - c_graph,
        num_components=c_tree, graph_components=c_graph,
    ))


def certify_result(result, *, engine: str = "auto", device=None) -> Certificate:
    """Certify an :class:`api.MSTResult` — the serve-side entry point.

    Checks the result's ``num_components`` metadata against the certified
    count too: a deserialized cache entry can corrupt metadata and arrays
    independently."""
    return certify_edge_ids(
        result.graph,
        result.edge_ids,
        engine=engine,
        expect_components=result.num_components,
        device=device,
    )


# -- analytics kind adapters -------------------------------------------------
#
# Per-kind certificates for the analytics front door (``analytics/``). Each
# certifies a *served answer*, not a recompute: the components adapter
# proves partition exactness from forest validity + the cross-edge check,
# and the k-forest adapter reduces to the rank-order MSF certificate on the
# rank-prefix subgraph (the "relaxed spanning predicate").


def certify_components(
    graph: Graph,
    edge_ids: np.ndarray,
    *,
    engine: str = "auto",
    expect_components: Optional[int] = None,
    device=None,
) -> Certificate:
    """Certify a connectivity answer: ``edge_ids`` must be a *maximal*
    spanning forest of ``graph``.

    Two checks, jointly exact: (1) the claimed edges form a forest
    (``bad_edge_ids`` / ``cycle``), so the claimed partition can only
    *refine* the graph's true partition (tree edges are graph edges); and
    (2) no graph edge crosses two claimed components (``cross_edge``), so
    the true partition also refines the claimed one. Refinement both ways
    is equality — a passing certificate proves the served labels are THE
    component partition, with no oracle in the loop. No path-max query runs
    here, so ``device`` is only checked, as every torch-engine entry point
    checks it.
    """
    t0 = time.perf_counter()
    engine = _resolve_engine(engine)
    _engine_device(engine, device)
    n, m = graph.num_nodes, graph.num_edges

    def done(cert: Certificate) -> Certificate:
        cert.engine = engine
        cert.check_s = time.perf_counter() - t0
        BUS.count("verify.checks")
        BUS.record("verify.check_s", cert.check_s)
        return cert

    ids = np.asarray(edge_ids, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= m):
        return done(_fail(
            "bad_edge_ids",
            f"edge id out of range [0, {m}): [{ids.min()}, {ids.max()}]",
        ))
    if np.unique(ids).size != ids.size:
        return done(_fail(
            "bad_edge_ids",
            f"{ids.size - np.unique(ids).size} duplicate edge ids claimed",
        ))
    tu, tv = graph.u[ids], graph.v[ids]
    tree_labels = _components(n, tu, tv)
    c_tree = int(np.unique(tree_labels).size) if n else 0
    if ids.size != n - c_tree:
        return done(_fail(
            "cycle",
            f"{ids.size} claimed edges over {c_tree} components "
            f"(a forest has exactly {n - c_tree})",
            num_tree_edges=int(ids.size), num_components=c_tree,
        ))
    if m:
        cross = tree_labels[graph.u] != tree_labels[graph.v]
        if cross.any():
            worst = np.nonzero(cross)[0][:4]
            return done(_fail(
                "cross_edge",
                f"{int(cross.sum())} graph edges cross claimed components "
                f"(e.g. edge ids {worst.tolist()}) — forest not maximal",
                num_tree_edges=int(ids.size), num_components=c_tree,
                violations=int(cross.sum()),
            ))
    if expect_components is not None and int(expect_components) != c_tree:
        return done(_fail(
            "metadata_mismatch",
            f"result metadata claims {expect_components} components, "
            f"certificate finds {c_tree}",
            num_tree_edges=int(ids.size),
            num_components=c_tree, graph_components=c_tree,
        ))
    return done(Certificate(
        ok=True, reason=None,
        num_tree_edges=int(ids.size), expected_edges=n - c_tree,
        num_components=c_tree, graph_components=c_tree,
    ))


def certify_k_forest(
    graph: Graph,
    edge_ids: np.ndarray,
    k: int,
    *,
    engine: str = "auto",
    device=None,
) -> Certificate:
    """Certify an optimal-``k``-forest answer (the ``k_msf`` kind).

    The target size is ``n - k'`` with ``k' = min(n, max(k, c_graph))`` —
    the *relaxed spanning predicate* (fewer than ``c_graph`` parts is
    infeasible, more than ``n`` is meaningless). Optimality reduces to the
    rank-order MSF certificate on a subgraph: with ``r* = max`` solver
    rank over the claimed edges, the claim is the optimal ``k'``-forest
    iff it is THE MSF of the rank-prefix subgraph ``{edges with rank <=
    r*}`` and has exactly ``n - k'`` edges (Kruskal's partial forest after
    processing rank ``r*`` is precisely the prefix subgraph's MSF). The
    heavy lifting is the existing :func:`certify_edge_ids` cycle
    certificate, run on that subgraph.
    """
    t0 = time.perf_counter()
    engine = _resolve_engine(engine)
    _engine_device(engine, device)
    n, m = graph.num_nodes, graph.num_edges

    def done(cert: Certificate) -> Certificate:
        cert.engine = engine
        cert.check_s = time.perf_counter() - t0
        return cert

    ids = np.asarray(edge_ids, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= m):
        BUS.count("verify.checks")
        return done(_fail(
            "bad_edge_ids",
            f"edge id out of range [0, {m}): [{ids.min()}, {ids.max()}]",
        ))
    if np.unique(ids).size != ids.size:
        BUS.count("verify.checks")
        return done(_fail(
            "bad_edge_ids",
            f"{ids.size - np.unique(ids).size} duplicate edge ids claimed",
        ))
    c_graph = (
        int(np.unique(_components(n, graph.u, graph.v)).size) if n else 0
    )
    k_eff = min(n, max(int(k), c_graph))
    want = n - k_eff
    if ids.size != want:
        BUS.count("verify.checks")
        return done(_fail(
            "not_spanning",
            f"k-forest claim has {ids.size} edges; k={k} over a "
            f"{c_graph}-component graph requires exactly {want} "
            f"(relaxed k' = {k_eff})",
            num_tree_edges=int(ids.size), expected_edges=want,
            graph_components=c_graph,
        ))
    if want == 0:
        BUS.count("verify.checks")
        return done(Certificate(
            ok=True, reason=None, num_tree_edges=0, expected_edges=0,
            num_components=k_eff, graph_components=c_graph,
        ))
    rank = _edge_ranks(graph)
    r_star = int(rank[ids].max())
    mask = rank <= r_star
    # Direct constructor: the masked arrays keep the canonical sorted
    # order, and positions in the subgraph map back via cumsum.
    sub = Graph(n, graph.u[mask], graph.v[mask], graph.w[mask])
    sub_pos = np.cumsum(mask) - 1
    inner = certify_edge_ids(sub, sub_pos[ids], engine=engine, device=device)
    if not inner.ok:
        inner.detail = (
            f"[k_msf prefix subgraph, rank <= {r_star}] " + inner.detail
        )
        return done(inner)
    return done(Certificate(
        ok=True, reason=None,
        num_tree_edges=int(ids.size), expected_edges=want,
        num_components=k_eff, graph_components=c_graph,
    ))


def certify_bottleneck(
    graph: Graph,
    edge_ids: np.ndarray,
    *,
    bottleneck_weight=None,
    engine: str = "auto",
    expect_components: Optional[int] = None,
    atol: float = 1e-6,
    device=None,
) -> Certificate:
    """Certify a bottleneck answer: the full MSF certificate plus the
    claimed scalar against the recomputed max-tree-edge weight (the MSF's
    max edge weight is the graph's minimum bottleneck spanning value, and
    identical across all MSTs)."""
    cert = certify_edge_ids(
        graph, edge_ids, engine=engine, expect_components=expect_components,
        device=device,
    )
    if not cert.ok:
        return cert
    ids = np.asarray(edge_ids, dtype=np.int64).ravel()
    actual = float(graph.w[ids].max()) if ids.size else None
    if bottleneck_weight is not None and (
        actual is None or abs(actual - float(bottleneck_weight)) > atol
    ):
        return _fail(
            "weight_mismatch",
            f"claimed bottleneck weight {bottleneck_weight} != recomputed "
            f"{actual}",
            num_tree_edges=cert.num_tree_edges,
            num_components=cert.num_components,
            graph_components=cert.graph_components,
            engine=cert.engine,
        )
    return cert


def certify_claim(
    num_nodes: int,
    edges: Sequence,
    mst_edges: Sequence,
    *,
    total_weight=None,
    engine: str = "np",
    atol: float = 1e-6,
    kind: str = "mst",
    k: Optional[int] = None,
    num_components: Optional[int] = None,
    bottleneck_weight=None,
    device=None,
) -> Certificate:
    """Certify a *payload-shaped* claim: the request's raw edge list plus
    a response's ``mst_edges`` pairs (and optional claimed total weight).

    This is the fleet router's form — it holds the original request (the
    graph) and a forwarded response (the claim) as plain JSON, never as
    repo objects (the default engine here is ``"np"``; ``device`` is where
    ``engine="torch"`` runs). A claimed pair that is not an input
    edge fails ``unknown_edge``; a claimed weight that disagrees with the
    recomputed edge sum fails ``weight_mismatch`` even when the edge set
    itself is plausible (the corruption a bit-flipped weight field is).

    ``kind`` selects the analytics adapter for forwarded non-MST answers:
    ``components`` (against the claimed ``num_components``), ``k_msf``
    (requires ``k``), ``bottleneck`` (against the claimed
    ``bottleneck_weight``); the default certifies an MST claim. All kinds
    share the edge-mapping and total-weight checks above.
    """
    t0 = time.perf_counter()

    def done(cert: Certificate) -> Certificate:
        cert.check_s = time.perf_counter() - t0
        return cert

    try:
        graph = Graph.from_edges(int(num_nodes), edges)
        pairs = np.asarray(list(mst_edges), dtype=np.int64).reshape(-1, 2)
    except Exception as e:  # noqa: BLE001 — adversarial input IS the job
        # A ragged/non-numeric claim (a buggy, older-build, or lying
        # peer) must FAIL its certificate, not crash the verifier — the
        # caller's rejection path is the same either way.
        BUS.count("verify.checks")
        return done(_fail(
            "malformed_claim", f"{type(e).__name__}: {e}", engine=engine,
        ))
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])

    if pairs.size and (
        graph.num_edges == 0
        or lo.min() < 0 or hi.max() >= graph.num_nodes
    ):
        BUS.count("verify.checks")
        return done(_fail(
            "unknown_edge",
            "claimed edges against an edgeless graph" if
            graph.num_edges == 0 else "claimed edge endpoint out of range",
            engine=engine,
        ))
    # Graph arrays are lexsorted by (u, v) after canonicalization: claimed
    # pairs map to edge ids by binary search on the packed key.
    key = graph.u.astype(np.int64) * graph.num_nodes + graph.v
    want = lo * graph.num_nodes + hi
    pos = np.searchsorted(key, want)
    ok_pos = (pos < key.size) & (key[np.minimum(pos, key.size - 1)] == want)
    if pairs.size and not ok_pos.all():
        missing = pairs[~ok_pos][:4]
        BUS.count("verify.checks")
        return done(_fail(
            "unknown_edge",
            f"claimed edges are not input edges: {missing.tolist()}",
            engine=engine,
        ))
    ids = pos.astype(np.int64)
    if total_weight is not None and pairs.size:
        recomputed = graph.w[ids].sum()
        if abs(float(recomputed) - float(total_weight)) > atol:
            BUS.count("verify.checks")
            return done(_fail(
                "weight_mismatch",
                f"claimed total weight {total_weight} != recomputed "
                f"{recomputed}",
                engine=engine,
            ))
    if kind == "components":
        return done(certify_components(
            graph, ids, engine=engine, expect_components=num_components,
            device=device,
        ))
    if kind == "k_msf":
        if k is None:
            BUS.count("verify.checks")
            return done(_fail(
                "malformed_claim", "k_msf claim without k", engine=engine,
            ))
        return done(certify_k_forest(graph, ids, int(k), engine=engine, device=device))
    if kind == "bottleneck":
        return done(certify_bottleneck(
            graph, ids, bottleneck_weight=bottleneck_weight, engine=engine,
            device=device,
        ))
    return done(certify_edge_ids(graph, ids, engine=engine, device=device))


def describe_violations(cert: Certificate) -> List[str]:
    """Human-readable failure rows for incident logs and drill reports."""
    if cert.ok:
        return []
    return [f"{cert.reason}: {cert.detail}"]
