"""Windowed batched MSF maintenance: one batched pass per update window.

Port of the JAX package's ``stream/window.py``. The Borůvka round
(:func:`_moe_round`) is a plain function over the port's ``fragment_moe``
and ``hook_and_compress``, on the session's explicit device (``device=None``
means CUDA): on the card each round launches K2 (``kernels.gather_key``, in
its full form, since the cut pass seeds the fragments from the surviving
tree) and K1 (``kernels.hook_compress``). The port has no jit, so
:func:`warm_window_kernels` warms the library load and one inert launch at
each bucket, which is what a batch solver-cache entry is.

``serve/dynamic.py`` proves the exchange rules one update at a time: every
insert walks a tree path (host BFS), every delete runs its own
``fragment_moe`` dispatch, and every structural change is an ``O(m)``
``np.insert``. At thousands of updates/sec that per-update walk is the
bottleneck, and it is also semantically awkward: a window containing
``insert(e) -> delete(e)`` applies both in arrival order when only the net
effect matters.

This module applies a whole window at once:

1. **Coalesce** (:func:`coalesce`) — last-write-wins per undirected edge.
   A window's worth of churn on the same edge collapses to its net op
   (``set`` to the final weight, or ``delete``); self-cancelling pairs
   vanish before any array is touched.
2. **Structural batch apply** — one vectorized rebuild of the canonical
   sorted arrays (``concatenate`` + ``lexsort``) instead of per-update
   splices.
3. **Cut pass** — deletions and weight *increases* first. Surviving tree
   edges whose weight did not increase are provably still in the MSF of
   that intermediate graph (cut property: every other edge got heavier or
   vanished), so their components seed a batched Borůvka
   (``fragment_moe`` + ``hook_and_compress`` rounds over all remaining
   edges) that finds every replacement edge for every broken cut in
   ``O(log n)`` batched rounds — not one MOE dispatch per deletion.
4. **Cycle pass** — insertions and weight *decreases*. The new MSF is a
   subset of (cut-pass MSF ∪ changed edges) — the classic insert-only
   sparsification — so one more seeded-Borůvka pass over that ``O(n)``-edge
   subgraph finishes the window exactly.

The result is *edge-for-edge* identical to a fresh solve (the ``(w, u, v)``
total order makes the MSF unique; property tests randomize whole update
streams against fresh solves). Escape hatches, test-pinned: ``sequential``
mode replays the coalesced window through the per-update exchange rules,
and ``resolve`` (also taken when a window exceeds the resolve threshold or
fails the forest check) hands the graph to a supervised full solve.

The Borůvka rounds run through :func:`_moe_round` with edge arrays padded
to power-of-two buckets, so a long-lived stream meets a handful of shapes;
:func:`warm_window_kernels` lets ``batch/warmup.py`` pay their first
launches before traffic arrives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.models.boruvka import _next_pow2
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX, fragment_moe
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress
from distributed_ghs_implementation_tpu_torch.serve.dynamic import (
    DynamicMST,
    Update,
    _int32,
)

_MODES = ("batched", "sequential", "resolve")


# ----------------------------------------------------------------------
# Coalescing
# ----------------------------------------------------------------------
def coalesce(updates: Sequence[Union[Update, dict]]) -> List[Update]:
    """Collapse a window to its net per-edge effect (last write wins).

    The last update touching an undirected edge decides its final state:
    ``delete`` nets to a delete (a no-op when the edge never existed —
    which is how ``insert -> delete`` self-cancels), anything carrying a
    weight nets to a ``set`` (emitted as kind ``insert``, which the
    exchange rules already treat as reweight-if-present). Output order is
    canonical ``(u, v)``, so a window's net effect is independent of
    arrival order — the semantic fix for ``dynamic.py``'s
    arrival-order-sensitive same-edge pairs.
    """
    net: Dict[Tuple[int, int], Update] = {}
    for upd in updates:
        if not isinstance(upd, Update):
            upd = Update.from_dict(upd)
        a, b = (upd.u, upd.v) if upd.u < upd.v else (upd.v, upd.u)
        if upd.kind == "delete":
            net[(a, b)] = Update("delete", a, b)
        else:
            net[(a, b)] = Update("insert", a, b, upd.w)
    return [net[key] for key in sorted(net)]


def random_update_stream(
    rng,
    seed_graph,
    size: int,
    *,
    kinds: Sequence[str] = ("insert", "delete", "reweight"),
    max_w: int = 1000,
) -> List[Update]:
    """``size`` seeded mutations valid against ANY chain state grown from
    ``seed_graph``: inserts of fresh random pairs, deletes and reweights
    drawn from the SEED's edge set. Deleting an already-deleted edge is a
    defined no-op, so the stream is path-independent: a publisher sends
    windows of these without tracking the evolving edge set. The draws are
    the JAX package's, so one ``rng`` seed gives both packages the same
    stream. ``kinds`` weights the mix by repetition; weights draw from
    ``[1, max_w)``.
    """
    n = int(seed_graph.num_nodes)
    out: List[Update] = []
    for _ in range(size):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if kind == "insert":
            a, b = (int(x) for x in rng.integers(0, n, 2))
            while a == b:
                a, b = (int(x) for x in rng.integers(0, n, 2))
            out.append(Update("insert", min(a, b), max(a, b),
                              int(rng.integers(1, max_w))))
        else:
            j = int(rng.integers(0, seed_graph.num_edges))
            u, v = int(seed_graph.u[j]), int(seed_graph.v[j])
            if kind == "delete":
                out.append(Update("delete", u, v))
            else:
                out.append(Update("reweight", u, v,
                                  int(rng.integers(1, max_w))))
    return out


# ----------------------------------------------------------------------
# The Borůvka round (padded shapes -> a few buckets)
# ----------------------------------------------------------------------
def _moe_round(fragment, src, dst, rank, ra, rb):
    """One batched Borůvka round: per-fragment MOE + hook-and-compress.

    Returns ``(has, moe_rank, new_fragment)`` — the chosen ranks are read
    out *before* the merge so the host loop can accumulate the window's
    replacement edges round by round. On CUDA tensors the round is one K2
    launch (``fragment`` is never taken as the identity) and one K1
    launch.
    """
    has, moe_rank, dstf = fragment_moe(fragment, src, dst, rank, ra, rb)
    new_fragment, _ = hook_and_compress(has, dstf, fragment)
    return has, moe_rank, new_fragment


def _round_inputs(fragment0: np.ndarray, eu: np.ndarray, ev: np.ndarray, ew: np.ndarray,
                  device) -> tuple:
    """The rounds' inputs on ``device``: ``(order, fragment, src, dst, rank,
    ra, rb)``. ``order`` sorts the edges by ``(w, u, v)``; a rank is a
    position in it. The rank slots are padded to ``m_pad = next_pow2(m)``
    and the directed slots to ``2 * m_pad``, with INT32_MAX ranks on the
    padding."""
    m = int(eu.size)
    order = np.lexsort((ev, eu, ew))
    rank_of_edge = np.empty(m, dtype=np.int64)
    rank_of_edge[order] = np.arange(m)

    m_pad = _next_pow2(m)
    ra = np.zeros(m_pad, dtype=np.int32)
    rb = np.zeros(m_pad, dtype=np.int32)
    ra[:m] = eu[order]
    rb[:m] = ev[order]
    e_pad = 2 * m_pad
    src = np.zeros(e_pad, dtype=np.int32)
    dst = np.zeros(e_pad, dtype=np.int32)
    rank = np.full(e_pad, int(INT32_MAX), dtype=np.int32)
    src[:m], src[m_pad:m_pad + m] = eu, ev
    dst[:m], dst[m_pad:m_pad + m] = ev, eu
    rank[:m] = rank_of_edge
    rank[m_pad:m_pad + m] = rank_of_edge
    return (order,) + tuple(_int32(a, device) for a in (fragment0, src, dst, rank, ra, rb))


def _seeded_boruvka(
    num_nodes: int,
    fragment0: np.ndarray,
    eu: np.ndarray,
    ev: np.ndarray,
    ew: np.ndarray,
    *,
    device=None,
) -> np.ndarray:
    """Exact MSF of the graph *contracted by* ``fragment0``, as positions
    into the given edge arrays, with the rounds on ``device`` (``None`` =
    CUDA).

    Classic Borůvka over the total order ``(w, u, v)``: every fragment
    hooks across its minimum outgoing edge each round, so the union of
    chosen edges across rounds is exactly ``MSF(G / fragment0)`` (ties are
    impossible — the order is total). Edge arrays are padded to
    power-of-two buckets (:func:`_round_inputs`). Each round reads ``has``
    on the host once (and the chosen ranks after it, when any fragment
    hooked).
    """
    device = resolve_device(device)
    m = int(eu.size)
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    order, fragment, src, dst, rank, ra, rb = _round_inputs(fragment0, eu, ev, ew, device)
    chosen: set = set()
    for _ in range(max(1, num_nodes).bit_length() + 2):
        has, moe_rank, fragment = _moe_round(fragment, src, dst, rank, ra, rb)
        has_np = has.cpu().numpy()
        if not has_np.any():
            return order[np.fromiter(chosen, dtype=np.int64, count=len(chosen))]
        for r in np.unique(moe_rank.cpu().numpy()[has_np]):
            if r < m:  # guard the padding sentinel
                chosen.add(int(r))
    raise RuntimeError("windowed Borůvka did not converge")  # unreachable


def warm_window_kernels(num_nodes: int, num_edges: int, *, device=None) -> int:
    """Warm the window round for the padded buckets a stream of this size
    dispatches: the full-edge-set cut pass (``m`` edges) and the
    ``O(n)``-sized cycle pass. Returns the number of shapes touched, as the
    JAX package does. Each warm is one round on inert all-sentinel slots on
    ``device`` (``None`` = CUDA): on the card the kernel library's first
    load (with its K4 self-check) and one K2 and one K1 launch at the
    bucket's shape.
    """
    device = resolve_device(device)
    n = max(1, int(num_nodes))
    m = max(1, int(num_edges))
    # The cycle pass runs over MSF ∪ changed edges — bounded by the TREE
    # size, which is min(n-1, m)-ish, not n. Capping at min(n, m) keeps
    # n >> m streams from warming pow2(n)-wide rounds no window dispatches;
    # for the common n <= m streams the cap is a no-op.
    t = min(n, m)
    shapes = sorted({
        _next_pow2(m),
        # Slightly MORE than tree-size edges can enter the cycle pass, so
        # warm one bucket above next_pow2(t) too.
        _next_pow2(t),
        2 * _next_pow2(t),
    })
    for m_pad in shapes:
        fragment = torch.arange(n, dtype=torch.int32, device=device)
        zeros_e = torch.zeros(2 * m_pad, dtype=torch.int32, device=device)
        rank = torch.full((2 * m_pad,), int(INT32_MAX), dtype=torch.int32, device=device)
        zeros_m = torch.zeros(m_pad, dtype=torch.int32, device=device)
        has, _, _ = _moe_round(fragment, zeros_e, zeros_e, rank, zeros_m, zeros_m)
        bool(has.any())  # wait for it: a fault shows here, not at a window
    return len(shapes)


# ----------------------------------------------------------------------
# The windowed session
# ----------------------------------------------------------------------
@dataclasses.dataclass
class WindowInfo:
    """What one committed window did to the forest (the notification
    payload): membership changes by ``(u, v, w)`` triple, the tree-weight
    delta, and how the window was answered."""

    mode: str
    applied: int
    coalesced_from: int
    entered: List[Tuple[int, int, float]]
    left: List[Tuple[int, int, float]]
    weight_delta: float


class WindowedMST(DynamicMST):
    """A :class:`~serve.dynamic.DynamicMST` whose unit of work is a window.

    ``window_mode`` pins the path: ``"batched"`` (the two-pass algorithm
    above — the default), ``"sequential"`` (coalesce, then the per-update
    exchange rules — the escape hatch that IS the old behavior), or
    ``"resolve"`` (structural apply + supervised full solve). A batched
    window larger than ``window_resolve_threshold`` net updates, or one
    that leaves the forest check failing, degrades to ``resolve`` on its
    own — same discipline as the per-update path.
    """

    def __init__(
        self,
        result,
        *,
        window_mode: str = "batched",
        window_resolve_threshold: Optional[int] = None,
        **kwargs,
    ):
        if window_mode not in _MODES:
            raise ValueError(
                f"unknown window_mode {window_mode!r}; expected {_MODES}"
            )
        super().__init__(result, **kwargs)
        self.window_mode = window_mode
        self._window_threshold = window_resolve_threshold

    # -- durable-state plumbing (stream/log.py snapshots) ----------------
    def state_arrays(self) -> dict:
        """The session's whole durable state as arrays — what a snapshot
        persists (``stream/log.py``) and :meth:`from_state` rebuilds."""
        return {
            "num_nodes": np.asarray(self._n, dtype=np.int64),
            "u": self._u.copy(),
            "v": self._v.copy(),
            "w": self._w.copy(),
            "in_tree": self._in_tree.copy(),
        }

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "WindowedMST":
        """Rebuild a session from snapshot arrays WITHOUT solving — the
        replay path's entry: the maintained forest is the persisted mask,
        so recovery never touches the solver."""
        from distributed_ghs_implementation_tpu_torch.api import MSTResult
        from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

        n = int(state["num_nodes"])
        in_tree = np.asarray(state["in_tree"], dtype=bool)
        graph = Graph(
            n,
            np.asarray(state["u"], dtype=np.int64),
            np.asarray(state["v"], dtype=np.int64),
            np.asarray(state["w"]),
        )
        result = MSTResult(
            graph=graph,
            edge_ids=np.nonzero(in_tree)[0],
            num_levels=0,
            wall_time_s=0.0,
            backend="stream/replay",
            num_components=n - int(in_tree.sum()),
        )
        return cls(result, **kwargs)

    # -- the window entry ------------------------------------------------
    def apply_window(
        self, updates: Iterable[Union[Update, dict]]
    ) -> Tuple[object, WindowInfo]:
        """Apply one update window; returns ``(MSTResult, WindowInfo)``."""
        import time

        batch = [
            u if isinstance(u, Update) else Update.from_dict(u) for u in updates
        ]
        self._validate(batch)
        net = coalesce(batch)
        if len(batch) > len(net):
            BUS.count("stream.window.coalesced", len(batch) - len(net))
        threshold = (
            self._window_threshold
            if self._window_threshold is not None
            else max(256, self._u.size // 4)
        )
        t0 = time.perf_counter()
        before_k, before_w = self._tree_snapshot()
        before_weight = self._tree_weight()
        with BUS.span(
            "stream.window.apply", cat="stream",
            updates=len(batch), net=len(net), nodes=self._n,
        ) as span:
            self._dirty = True
            mode = self.window_mode
            if mode == "batched" and len(net) > threshold:
                BUS.count("stream.window.over_threshold")
                mode = "resolve"
            if not net:
                mode = "noop"
                self._last_mode = "window"
            elif mode == "batched":
                self._apply_batched(net)
                if not self._forest_ok():
                    BUS.count("stream.window.verify_failed")
                    span.set(verify_failed=True)
                    mode = "resolve"
                    self._resolve([], t0)
                else:
                    self._last_mode = "window"
            elif mode == "sequential":
                for upd in net:
                    self._apply_one(upd)
                if not self._forest_ok():
                    BUS.count("stream.window.verify_failed")
                    mode = "resolve"
                    self._resolve([], t0)
                else:
                    self._last_mode = "window"
            else:  # resolve
                self._apply_structural(net)
                self._resolve([], t0)
            BUS.count(f"stream.window.{mode}")
            span.set(mode=mode)
            self._dirty = False
        after_k, after_w = self._tree_snapshot()
        info = WindowInfo(
            mode=mode,
            applied=len(net),
            coalesced_from=len(batch),
            entered=self._changed_triples(
                after_k, after_w, np.isin(after_k, before_k, invert=True)
            ),
            left=self._changed_triples(
                before_k, before_w, np.isin(before_k, after_k, invert=True)
            ),
            weight_delta=self._tree_weight() - before_weight,
        )
        return self.result(time.perf_counter() - t0), info

    # -- bookkeeping -----------------------------------------------------
    def _tree_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(keys, weights)`` of the current tree edges. The diff that
        feeds MST-change notifications is a vectorized set difference over
        these — a window touches O(window) edges, so Python-object work
        stays proportional to the change, not to the forest size."""
        idx = np.nonzero(self._in_tree)[0]
        keys = (
            self._u[idx].astype(np.int64) * self._n
            + self._v[idx].astype(np.int64)
        )
        return keys, self._w[idx].copy()

    def _changed_triples(
        self, keys: np.ndarray, ws: np.ndarray, mask: np.ndarray
    ) -> List[Tuple[int, int, float]]:
        """Materialize ``(u, v, w)`` triples for the masked (changed)
        edges, in ``(u, v)`` order — key order IS lexicographic order
        since ``v < n``."""
        keys, ws = keys[mask], ws[mask]
        order = np.argsort(keys, kind="stable")
        cast = int if ws.dtype.kind in "iu" else float
        return [
            (int(k // self._n), int(k % self._n), cast(w))
            for k, w in zip(keys[order], ws[order])
        ]

    def _tree_weight(self):
        w = self._w[self._in_tree].sum()
        return int(w) if self._w.dtype.kind in "iu" else float(w)

    # -- structural batch apply -----------------------------------------
    def _apply_structural(self, net: Sequence[Update]) -> dict:
        """Vectorized rebuild of the canonical arrays for a coalesced
        window. Returns the classification the cut/cycle passes need, in
        NEW index space: ``inserted`` / ``increased`` / ``decreased``
        boolean masks and ``w_before`` (the pre-window weight of every
        surviving edge; inserted slots hold the new weight).
        """
        for upd in net:
            if upd.kind != "delete":
                self._promote_weight_dtype(upd.w)
        m = self._u.size
        removed = np.zeros(m, dtype=bool)
        old_w = self._w.copy()
        new_w = self._w.copy()
        ins_u: List[int] = []
        ins_v: List[int] = []
        ins_w: List[float] = []
        for upd in net:
            idx = self._find(upd.u, upd.v)
            if upd.kind == "delete":
                if idx >= 0:
                    removed[idx] = True
            elif idx >= 0:
                new_w[idx] = upd.w
            else:
                ins_u.append(upd.u)
                ins_v.append(upd.v)
                ins_w.append(upd.w)

        keep = ~removed
        n_keep = int(keep.sum())
        u2 = np.concatenate([self._u[keep], np.asarray(ins_u, dtype=np.int64)])
        v2 = np.concatenate([self._v[keep], np.asarray(ins_v, dtype=np.int64)])
        w2 = np.concatenate(
            [new_w[keep], np.asarray(ins_w, dtype=new_w.dtype)]
        )
        wb2 = np.concatenate(
            [old_w[keep], np.asarray(ins_w, dtype=old_w.dtype)]
        )
        tree2 = np.concatenate(
            [self._in_tree[keep], np.zeros(len(ins_u), dtype=bool)]
        )
        inserted2 = np.concatenate(
            [np.zeros(n_keep, dtype=bool), np.ones(len(ins_u), dtype=bool)]
        )
        order = np.lexsort((v2, u2))
        self._u, self._v, self._w = u2[order], v2[order], w2[order]
        self._k = self._u * self._n + self._v
        self._in_tree = tree2[order]
        w_before = wb2[order]
        inserted = inserted2[order]
        return {
            "inserted": inserted,
            "increased": ~inserted & (self._w > w_before),
            "decreased": ~inserted & (self._w < w_before),
            "w_before": w_before,
        }

    # -- the batched two-pass algorithm ---------------------------------
    def _apply_batched(self, net: Sequence[Update]) -> None:
        from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
            component_labels,
        )

        tree_before = self._in_tree.copy()
        info = self._apply_structural(net)
        inserted = info["inserted"]
        increased = info["increased"]
        decreased = info["decreased"]
        n, m = self._n, self._u.size
        if m == 0:
            self._in_tree = np.zeros(0, dtype=bool)
            return

        # Cut pass: the intermediate graph G_A applies only deletions and
        # weight increases (decreased edges stay at their OLD weight,
        # inserted edges are absent). Surviving non-increased tree edges
        # are provably still MSF(G_A) edges, so contract them and let the
        # seeded Borůvka find every replacement at once.
        kept = self._in_tree & ~increased
        tree_broken = (
            bool(tree_before.sum() > self._in_tree.sum())  # a tree edge died
            or bool((self._in_tree & increased).any())
        )
        w_a = self._w.copy()
        w_a[decreased] = info["w_before"][decreased]
        mask_a = ~inserted
        if tree_broken:
            if kept.any():
                fragment0 = component_labels(
                    n, self._u[kept], self._v[kept]
                ).astype(np.int32)
            else:
                fragment0 = np.arange(n, dtype=np.int32)
            idx_a = np.nonzero(mask_a)[0]
            chosen = _seeded_boruvka(
                n, fragment0, self._u[idx_a], self._v[idx_a], w_a[idx_a],
                device=self._device,
            )
            msf_a = kept.copy()
            msf_a[idx_a[chosen]] = True
        else:
            msf_a = self._in_tree.copy()

        # Cycle pass: insertions + decreases. MSF(G') ⊆ MSF(G_A) ∪ C, so
        # one more pass over that small subgraph (at FINAL weights)
        # finishes exactly.
        cyc = inserted | decreased
        if cyc.any():
            idx_s = np.nonzero(msf_a | cyc)[0]
            chosen = _seeded_boruvka(
                n,
                np.arange(n, dtype=np.int32),
                self._u[idx_s],
                self._v[idx_s],
                self._w[idx_s],
                device=self._device,
            )
            in_tree = np.zeros(m, dtype=bool)
            in_tree[idx_s[chosen]] = True
            self._in_tree = in_tree
        else:
            self._in_tree = msf_a
