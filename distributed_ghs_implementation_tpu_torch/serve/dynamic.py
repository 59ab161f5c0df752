"""Incremental MSF maintenance: edge insert / delete / reweight on a cached
result, without re-running the solver.

Port of the JAX package's ``serve/dynamic.py``. The searches run on one
explicit device (``device=None`` means CUDA) through the port's
``fragment_moe`` and ``hook_and_compress``, so on the card K2 and K1 launch
on partitions that are not the identity (the cut-side labels); each
connectivity level reads ``has_moe`` on the host once.

The GHS fragment structure is what makes this cheap (PAPER.md): a single
edge change resolves against the existing tree by the classic exchange
rules —

* **insert** (cycle rule): a new edge ``(a, b, w)`` enters the tree iff it
  beats the maximum edge on the tree path ``a..b`` (which it then evicts);
  endpoints in different components just join their fragments.
* **delete** (cut rule): removing a non-tree edge changes nothing; removing
  a tree edge splits its fragment in two, and the replacement is the
  minimum edge crossing that cut — found here with ONE
  ``ops.segment_ops.fragment_moe`` over the edge list keyed by cut-side
  labels, exactly the solver's per-fragment MOE search. The side labels
  themselves come from a mini-Borůvka connectivity pass over the remaining
  tree edges built on the same ``fragment_moe`` +
  ``ops.union_find.hook_and_compress`` primitives.
* **reweight**: up-weighting a tree edge triggers a cut-rule replacement
  check; down-weighting a non-tree edge triggers a cycle-rule check; the
  other two directions never change the tree.

All comparisons use the lexicographic ``(w, u, v)`` triple — identical to
the solvers' global ``(weight, edge id)`` rank order, because edge ids are
positions in the sorted-``(u, v)`` canonical layout. The maintained forest
is therefore *edge-for-edge* the one a fresh solve would return, not merely
weight-equal (tests assert exact parity).

Fallback: a batch larger than ``resolve_threshold``, or one that leaves the
structure failing the forest check, is answered by a supervised full
re-solve instead (``serve.dynamic.resolve`` vs ``serve.dynamic.incremental``
on the bus tell the two paths apart; the incremental path records zero
``solver.*`` spans).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.api import MSTResult, minimum_spanning_forest
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph, component_labels
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX, fragment_moe
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress

_KINDS = ("insert", "delete", "reweight")


@dataclasses.dataclass(frozen=True)
class Update:
    """One edge mutation. ``w`` is required for insert/reweight."""

    kind: str
    u: int
    v: int
    w: Optional[float] = None

    @staticmethod
    def from_dict(d: dict) -> "Update":
        return Update(
            kind=d.get("kind", d.get("op")),
            u=int(d["u"]),
            v=int(d["v"]),
            w=d.get("w"),
        )


def _int32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def components_via_unionfind(
    num_nodes: int, eu: np.ndarray, ev: np.ndarray, *, device=None
) -> np.ndarray:
    """Connected-component root labels via the solver's own primitives, on
    ``device`` (``None`` = CUDA).

    Public API (the JAX package's analytics ``components`` kind and stream
    layer use it): repeated ``fragment_moe`` (per-fragment minimum outgoing edge)
    + ``hook_and_compress`` rounds — Borůvka connectivity, converging in
    ``<= ceil(log2 n)`` rounds. The weight key is the edge *index* (any
    all-distinct rank yields the same connectivity), which is exactly the
    "weight-free" instantiation of the GHS level loop.

    Args:
        num_nodes: node count ``n``; labels are returned for every node.
        eu, ev: endpoint arrays (any integer dtype; orientation and order
            do not matter — both directions are added internally).

    Returns:
        ``int64`` array of length ``n``: each node's fragment root. Two
        nodes are connected iff their labels are equal; isolated nodes
        label themselves.
    """
    device = resolve_device(device)
    n = int(num_nodes)
    m = int(eu.size)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if m == 0:
        return np.arange(n, dtype=np.int64)
    # For connectivity any all-distinct rank works; edge index is one.
    src = _int32(np.concatenate([eu, ev]), device)
    dst = _int32(np.concatenate([ev, eu]), device)
    rank = _int32(np.concatenate([np.arange(m), np.arange(m)]), device)
    ra = _int32(eu, device)
    rb = _int32(ev, device)
    fragment = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(max(1, n).bit_length() + 2):
        has, _moe_rank, dstf = fragment_moe(fragment, src, dst, rank, ra, rb)
        if not bool(has.any()):  # the level's one host read
            return fragment.cpu().numpy().astype(np.int64)
        fragment, _ = hook_and_compress(has, dstf, fragment)
    raise RuntimeError("union-find connectivity did not converge")  # unreachable


def tree_path_max(
    num_nodes: int,
    tu: np.ndarray,
    tv: np.ndarray,
    tw: np.ndarray,
    a: int,
    b: int,
) -> Optional[int]:
    """Maximum-weight edge on the unique forest path between ``a`` and ``b``.

    Public API (the analytics ``path_max`` kind queries it directly; the
    dynamic-update cycle rule uses it via :meth:`DynamicMST._tree_path_max`).
    Edges are compared by the solver's total order — lexicographic
    ``(w, u, v)`` — so ties break exactly as the MST solver breaks them,
    and for an MST the returned edge is the *minimax* (bottleneck-optimal)
    answer for the pair.

    Args:
        num_nodes: node count the forest spans.
        tu, tv, tw: the forest's edge arrays, ``tu[i] < tv[i]`` per edge
            (any order across edges). Must actually be a forest: each node
            pair connected by at most one path.
        a, b: node ids.

    Returns:
        Index **into the tree arrays** of the maximum-order path edge, or
        ``None`` when ``a == b`` or the nodes are in different fragments.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    n = int(num_nodes)
    tu = np.asarray(tu)
    tv = np.asarray(tv)
    tw = np.asarray(tw)
    if tu.size == 0 or int(a) == int(b):
        return None
    adj = coo_matrix(
        (np.ones(tu.size, dtype=np.int8), (tu, tv)), shape=(n, n)
    ).tocsr()
    _order, pred = breadth_first_order(
        adj, int(a), directed=False, return_predecessors=True
    )
    if pred[int(b)] < 0:
        return None  # disconnected (scipy sentinel is -9999)
    keys = tu.astype(np.int64) * n + tv.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    is_int = tw.dtype.kind in "iu"

    def _triple(i: int):
        w = int(tw[i]) if is_int else float(tw[i])
        return (w, int(tu[i]), int(tv[i]))

    best: Optional[int] = None
    cur = int(b)
    a = int(a)
    while cur != a:
        p = int(pred[cur])
        lo, hi = (p, cur) if p < cur else (cur, p)
        key = lo * n + hi
        pos = int(np.searchsorted(skeys, key))
        if pos >= skeys.size or skeys[pos] != key:
            raise ValueError(f"tree edge ({lo}, {hi}) missing from arrays")
        idx = int(order[pos])
        if best is None or _triple(idx) > _triple(best):
            best = idx
        cur = p
    return best


class DynamicMST:
    """A cached solve made updatable.

    Holds the graph as canonical sorted arrays plus an in-tree mask, applies
    update batches by the exchange rules above, and yields a fresh
    :class:`MSTResult` (under a new content digest) per batch.
    """

    def __init__(
        self,
        result: MSTResult,
        *,
        resolve_threshold: Optional[int] = None,
        backend: str = "device",
        supervisor=None,
        solver=None,
        pre_resolve=None,
        device=None,
    ):
        # ``solver`` (graph -> MSTResult) overrides the direct supervised
        # solve in :meth:`_resolve` — the stream layer injects the serving
        # scheduler here so a windowed session's full-re-solve escape hatch
        # is cached, single-flighted, and capacity-bounded like any other
        # miss (stream/session.py). ``pre_resolve`` (graph -> None) runs
        # just before that solve: the stream layer migrates a mesh-resident
        # session's device residency onto the resolve graph here, so an
        # oversize resolve dispatches on already-scattered slots instead of
        # cold-staging mid-publish. Best effort — a hook failure costs a
        # cold stage, never the resolve.
        g = result.graph
        self._n = g.num_nodes
        # Canonical layout: sorted by (u, v), unique. Graph construction
        # guarantees canonical u < v; re-sort defensively (dedup=False
        # callers may have bypassed the sort).
        order = np.lexsort((g.v, g.u))
        self._u = g.u[order].astype(np.int64)
        self._v = g.v[order].astype(np.int64)
        self._w = g.w[order].copy()
        self._k = self._u * self._n + self._v  # sorted lookup keys
        in_tree = np.zeros(g.num_edges, dtype=bool)
        in_tree[result.edge_ids] = True
        self._in_tree = in_tree[order]
        self._device = resolve_device(device)
        self._backend = backend
        self._supervisor = supervisor
        self._solver = solver
        self._pre_resolve = pre_resolve
        self._threshold = resolve_threshold
        self._last_mode = "seed"
        self._dirty = False

    # -- public state ---------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_tree_edges(self) -> int:
        return int(self._in_tree.sum())

    @property
    def num_components(self) -> int:
        return self._n - self.num_tree_edges  # forest invariant

    @property
    def last_mode(self) -> str:
        """How the previous :meth:`apply` was answered:
        ``"incremental"`` / ``"resolve"`` / ``"seed"``."""
        return self._last_mode

    @property
    def backend(self) -> str:
        """The solver backend this session's results are keyed/re-solved
        under (set at construction from the solve that seeded it)."""
        return self._backend

    @property
    def dirty(self) -> bool:
        """True iff an :meth:`apply` failed after mutation began — the state
        no client has seen; holders should discard the session."""
        return self._dirty

    def result(self, wall_time_s: float = 0.0) -> MSTResult:
        graph = Graph(
            self._n, self._u.copy(), self._v.copy(), self._w.copy()
        )
        return MSTResult(
            graph=graph,
            edge_ids=np.nonzero(self._in_tree)[0],
            num_levels=0,
            wall_time_s=wall_time_s,
            backend=f"serve/{self._last_mode}",
            num_components=self.num_components,
        )

    # -- the batch entry -------------------------------------------------
    def apply(self, updates: Iterable[Union[Update, dict]]) -> MSTResult:
        """Apply one update batch; returns the post-batch result."""
        batch = [
            u if isinstance(u, Update) else Update.from_dict(u) for u in updates
        ]
        self._validate(batch)
        t0 = time.perf_counter()
        threshold = (
            self._threshold
            if self._threshold is not None
            else max(64, self._u.size // 10)
        )
        with BUS.span(
            "serve.dynamic.apply", cat="serve",
            updates=len(batch), nodes=self._n,
        ) as span:
            self._dirty = True  # cleared only when a batch completes
            if len(batch) > threshold:
                span.set(mode="resolve", reason="batch_over_threshold")
                out = self._resolve(batch, t0)
            else:
                for upd in batch:
                    BUS.count(f"serve.dynamic.{upd.kind}")
                    self._apply_one(upd)
                if not self._forest_ok():
                    BUS.count("serve.dynamic.verify_failed")
                    span.set(mode="resolve", reason="verification_failed")
                    out = self._resolve([], t0)
                else:
                    BUS.count("serve.dynamic.incremental")
                    span.set(mode="incremental")
                    self._last_mode = "incremental"
                    out = self.result(time.perf_counter() - t0)
            self._dirty = False
            return out

    # -- single-update rules ---------------------------------------------
    def _apply_one(self, upd: Update) -> None:
        a, b = (upd.u, upd.v) if upd.u < upd.v else (upd.v, upd.u)
        idx = self._find(a, b)
        if upd.kind == "delete":
            if idx < 0:
                return  # deleting an absent edge is a no-op
            self._delete_at(idx)
        elif idx >= 0:  # insert of an existing edge == reweight
            self._reweight_at(idx, upd.w)
        else:
            self._insert(a, b, upd.w)

    def _insert(self, a: int, b: int, w) -> None:
        path_max = self._tree_path_max(a, b)
        idx = self._splice(a, b, w, in_tree=path_max is None)
        if path_max is None:
            return  # different fragments: the new edge joins them
        # Cycle rule: evict the path maximum iff the new edge beats it
        # (the splice shifted indices at/after the insertion point by one).
        mi = path_max if path_max < idx else path_max + 1
        if self._triple(idx) < self._triple(mi):
            self._in_tree[mi] = False
            self._in_tree[idx] = True

    def _delete_at(self, idx: int) -> None:
        was_tree = bool(self._in_tree[idx])
        a, b = int(self._u[idx]), int(self._v[idx])
        self._remove(idx)
        if not was_tree:
            return
        # Cut rule: label the two sides of the broken fragment from the
        # remaining tree edges, then one MOE search for the replacement.
        sides = components_via_unionfind(
            self._n, self._u[self._in_tree], self._v[self._in_tree],
            device=self._device,
        )
        repl = self._min_crossing(sides, sides[a], sides[b])
        if repl is not None:
            self._in_tree[repl] = True

    def _reweight_at(self, idx: int, w) -> None:
        old = self._triple(idx)
        self._set_weight(idx, w)
        new = self._triple(idx)
        if self._in_tree[idx] and new > old:
            # A tree edge got heavier: re-run the cut rule across its cut.
            a, b = int(self._u[idx]), int(self._v[idx])
            keep = self._in_tree.copy()
            keep[idx] = False
            sides = components_via_unionfind(
                self._n, self._u[keep], self._v[keep], device=self._device,
            )
            repl = self._min_crossing(sides, sides[a], sides[b])
            if repl is not None and repl != idx:
                self._in_tree[idx] = False
                self._in_tree[repl] = True
        elif not self._in_tree[idx] and new < old:
            # A non-tree edge got lighter: cycle rule against the tree path.
            a, b = int(self._u[idx]), int(self._v[idx])
            path_max = self._tree_path_max(a, b)
            if path_max is None:
                self._in_tree[idx] = True  # endpoints were disconnected
            elif self._triple(idx) < self._triple(path_max):
                self._in_tree[path_max] = False
                self._in_tree[idx] = True

    # -- searches --------------------------------------------------------
    def _min_crossing(
        self, sides: np.ndarray, root_a, root_b
    ) -> Optional[int]:
        """Minimum-order edge crossing the (root_a | root_b) cut, via the
        solver's ``fragment_moe`` keyed by side labels; ``None`` when the
        cut has no crossing edge (the fragment stays split)."""
        m = self._u.size
        if m == 0 or root_a == root_b:
            return None
        order = np.lexsort((self._v, self._u, self._w))
        rank_of_edge = np.empty(m, dtype=np.int64)
        rank_of_edge[order] = np.arange(m)
        dev = self._device
        src = _int32(np.concatenate([self._u, self._v]), dev)
        dst = _int32(np.concatenate([self._v, self._u]), dev)
        rank = _int32(np.concatenate([rank_of_edge, rank_of_edge]), dev)
        ra = _int32(self._u[order], dev)
        rb = _int32(self._v[order], dev)
        fragment = _int32(sides, dev)
        _has, moe_rank, _dstf = fragment_moe(fragment, src, dst, rank, ra, rb)
        best = int(moe_rank[[int(root_a), int(root_b)]].min())
        if best >= int(INT32_MAX):
            return None
        return int(order[best])

    def _tree_path_max(self, a: int, b: int) -> Optional[int]:
        """Index (into the *full* edge arrays) of the maximum-order edge on
        the tree path ``a..b``, or ``None`` when ``a`` and ``b`` are in
        different fragments. Thin wrapper over the public module-level
        :func:`tree_path_max`, mapping its tree-relative index back."""
        tree_idx = np.nonzero(self._in_tree)[0]
        rel = tree_path_max(
            self._n,
            self._u[tree_idx],
            self._v[tree_idx],
            self._w[tree_idx],
            a,
            b,
        )
        return None if rel is None else int(tree_idx[rel])

    # -- structural invariants -------------------------------------------
    def _forest_ok(self) -> bool:
        """Structural check: the in-tree mask is a spanning forest of the
        current graph. Two halves, both needed: ``t == n - k_tree`` over the
        *tree* subgraph's own components rejects cycles (a cyclic mask can
        still satisfy the graph-level count), and ``k_tree == k_graph``
        rejects a non-maximal forest (two fragments the graph could
        connect left apart)."""
        t = self.num_tree_edges
        if self._u.size == 0:
            return t == 0
        k_graph = int(np.unique(component_labels(self._n, self._u, self._v)).size)
        k_tree = int(
            np.unique(
                component_labels(
                    self._n, self._u[self._in_tree], self._v[self._in_tree]
                )
            ).size
        )
        return t == self._n - k_tree and k_tree == k_graph

    # -- fallback ---------------------------------------------------------
    def _resolve(self, pending: Sequence[Update], t0: float) -> MSTResult:
        """Apply ``pending`` structurally, then hand the whole graph to a
        supervised full solve (the degradation path for oversized batches
        and failed verification)."""
        for upd in pending:
            BUS.count(f"serve.dynamic.{upd.kind}")
            a, b = (upd.u, upd.v) if upd.u < upd.v else (upd.v, upd.u)
            idx = self._find(a, b)
            if upd.kind == "delete":
                if idx >= 0:
                    self._remove(idx)
            elif idx >= 0:
                self._set_weight(idx, upd.w)
            else:
                self._splice(a, b, upd.w, in_tree=False)
        BUS.count("serve.dynamic.resolve")
        graph = Graph(self._n, self._u.copy(), self._v.copy(), self._w.copy())
        if self._pre_resolve is not None:
            try:
                self._pre_resolve(graph)
            except Exception:  # noqa: BLE001 — residency is best effort
                BUS.count("serve.dynamic.pre_resolve_failed")
        if self._solver is not None:
            solved = self._solver(graph)
        else:
            solved = minimum_spanning_forest(
                graph, backend=self._backend, supervised=True,
                supervisor=self._supervisor, device=self._device,
            )
        in_tree = np.zeros(graph.num_edges, dtype=bool)
        in_tree[solved.edge_ids] = True
        self._in_tree = in_tree
        self._last_mode = "resolve"
        return self.result(time.perf_counter() - t0)

    # -- array plumbing ---------------------------------------------------
    def _key(self, lo: int, hi: int) -> int:
        return lo * self._n + hi

    def _find(self, lo: int, hi: int) -> int:
        """Index of edge ``(lo, hi)`` in the sorted arrays, or -1 — one
        O(log m) bisect over the maintained key array (``_k`` is kept in
        lock-step by ``_splice``/``_remove``; rebuilding it per lookup would
        make a path walk O(path * m))."""
        key = self._key(lo, hi)
        pos = int(np.searchsorted(self._k, key))
        if pos < self._k.size and self._k[pos] == key:
            return pos
        return -1

    def _triple(self, idx: int):
        """The solver's total order on edges: lexicographic ``(w, u, v)``
        (== (weight, edge id), since ids follow the sorted (u, v) layout)."""
        w = self._w[idx]
        w = int(w) if self._w.dtype.kind in "iu" else float(w)
        return (w, int(self._u[idx]), int(self._v[idx]))

    def _splice(self, lo: int, hi: int, w, *, in_tree: bool) -> int:
        if w is None:
            raise ValueError(f"insert ({lo}, {hi}) requires a weight")
        self._promote_weight_dtype(w)
        key = self._key(lo, hi)
        pos = int(np.searchsorted(self._k, key))
        self._u = np.insert(self._u, pos, lo)
        self._v = np.insert(self._v, pos, hi)
        self._w = np.insert(self._w, pos, w)
        self._k = np.insert(self._k, pos, key)
        self._in_tree = np.insert(self._in_tree, pos, in_tree)
        return pos

    def _remove(self, idx: int) -> None:
        self._u = np.delete(self._u, idx)
        self._v = np.delete(self._v, idx)
        self._w = np.delete(self._w, idx)
        self._k = np.delete(self._k, idx)
        self._in_tree = np.delete(self._in_tree, idx)

    def _set_weight(self, idx: int, w) -> None:
        if w is None:
            raise ValueError(
                f"reweight ({self._u[idx]}, {self._v[idx]}) requires a weight"
            )
        self._promote_weight_dtype(w)
        self._w = self._w.copy()  # never mutate arrays shared with a result
        self._w[idx] = w

    def _promote_weight_dtype(self, w) -> None:
        if self._w.dtype.kind in "iu" and float(w) != int(w):
            self._w = self._w.astype(np.float64)

    def _validate(self, batch: List[Update]) -> None:
        for upd in batch:
            if upd.kind not in _KINDS:
                raise ValueError(
                    f"unknown update kind {upd.kind!r}; expected {_KINDS}"
                )
            if not (0 <= upd.u < self._n and 0 <= upd.v < self._n):
                raise ValueError(
                    f"endpoint out of range in {upd} (num_nodes={self._n})"
                )
            if upd.u == upd.v:
                raise ValueError(f"self-loop in {upd}")
            if upd.kind != "delete":
                if upd.w is None:
                    raise ValueError(f"{upd.kind} requires a weight: {upd}")
                import math

                try:  # reject non-numeric weights BEFORE any edge is touched
                    finite = math.isfinite(float(upd.w))
                except (TypeError, ValueError):
                    raise ValueError(f"non-numeric weight in {upd}") from None
                if not finite:  # NaN breaks the total order, inf int-casts
                    raise ValueError(f"non-finite weight in {upd}")
