"""Dense edge-list graph container feeding the Borůvka solver.

A graph is three NumPy arrays ``(u, v, w)`` of undirected edges. The solver
consumes the *interleaved directed layout*: undirected edge ``e = (a, b, w)``
becomes directed slots ``2e = a->b`` and ``2e+1 = b->a``, and every edge
carries its *rank*, its position in the total order ``(weight, edge id)``.
That order makes the minimum spanning forest unique, so two solvers that are
both right return the same edge ids.

This is the port's own copy of the JAX package's ``graphs/edgelist.py``.
The rank order and the first ranks run in the port's native library
(``graphs/native.py``), as they do in the JAX package; each keeps its NumPy
form, which ``native=False`` selects.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs import native as native_lib

INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted graph as dense arrays.

    Attributes:
      num_nodes: vertex count ``n``; vertices are ``0..n-1``.
      u, v, w: parallel arrays of undirected edges (``u[i] < v[i]`` after
        canonicalization). ``w`` is int64 or float64.
    """

    num_nodes: int
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.u.shape[0])

    @property
    def is_integer_weighted(self) -> bool:
        return self.w.dtype.kind in "iu"

    @staticmethod
    def from_edges(
        num_nodes: int,
        edges: Iterable[Tuple[int, int, float]] | np.ndarray,
        *,
        dedup: bool = True,
    ) -> "Graph":
        """Build from an iterable of ``(u, v, weight)`` triples.

        Self-loops are dropped; parallel edges keep the minimum weight when
        ``dedup``. A generator is read in bounded chunks; any float triple
        makes every weight float, as one ``np.asarray`` would.
        """
        if isinstance(edges, np.ndarray):
            arr = edges
        elif isinstance(edges, (list, tuple)):
            arr = np.asarray(edges)
        else:
            it = iter(edges)
            blocks = []
            while block := list(itertools.islice(it, 65536)):
                blocks.append(np.asarray(block))
            arr = np.concatenate(blocks) if blocks else np.empty((0, 3))
        if arr.size == 0:
            e = np.zeros(0, dtype=np.int64)
            return Graph(int(num_nodes), e, e.copy(), np.zeros(0, dtype=np.int64))
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise ValueError(f"edges must be (m, 3) triples, got shape {arr.shape}")
        u = arr[:, 0].astype(np.int64)
        v = arr[:, 1].astype(np.int64)
        wcol = arr[:, 2]
        if np.all(wcol == np.floor(wcol)):
            w = wcol.astype(np.int64)
        else:
            w = wcol.astype(np.float64)
        return Graph.from_arrays(num_nodes, u, v, w, dedup=dedup)

    @staticmethod
    def from_arrays(
        num_nodes: int,
        u: np.ndarray,
        v: np.ndarray,
        w: np.ndarray,
        *,
        dedup: bool = True,
    ) -> "Graph":
        """Build from parallel arrays; canonicalizes, drops loops, dedups."""
        num_nodes = int(num_nodes)
        u = np.asarray(u)
        v = np.asarray(v)
        w = np.asarray(w)
        if (
            min(u.min(initial=0), v.min(initial=0)) < 0
            or max(u.max(initial=-1), v.max(initial=-1)) >= num_nodes
        ):
            raise ValueError("edge endpoint out of range")
        lo = np.minimum(u, v).astype(np.int64)
        hi = np.maximum(u, v).astype(np.int64)
        keep = lo != hi
        lo, hi, w = lo[keep], hi[keep], w[keep]
        if dedup and lo.size:
            # Keep the min weight per (lo, hi) pair: stable sort by (lo, hi, w).
            order = np.lexsort((w, hi, lo))
            lo, hi, w = lo[order], hi[order], w[order]
            first = np.ones(lo.size, dtype=bool)
            first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
            lo, hi, w = lo[first], hi[first], w[first]
        w = w.astype(np.int64) if w.dtype.kind in "iu" else w.astype(np.float64)
        return Graph(num_nodes, lo, hi, w)

    def rank_arrays(
        self, *, pad_edges_to: int | None = None, pad_ranks_to: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Rank-based device layout: ``(src, dst, rank, ra, rb)``, all int32.

        ``rank[slot]`` is the rank of the slot's undirected edge; ``ra[r],
        rb[r]`` are the endpoints of the rank-``r`` edge. Pad slots are
        self-edges at vertex 0 with rank INT32_MAX, so they are never
        outgoing; pad ranks have endpoints 0 and are never chosen.
        """
        m = self.num_edges
        rank_of_edge = np.empty(m, dtype=np.int64)
        rank_of_edge[self._rank_order] = np.arange(m)
        e2 = 2 * m
        e_size = e2 if pad_edges_to is None else int(pad_edges_to)
        m_size = m if pad_ranks_to is None else int(pad_ranks_to)
        if e_size < e2 or m_size < m:
            raise ValueError("pad sizes smaller than graph")
        src = np.zeros(e_size, dtype=np.int32)
        dst = np.zeros(e_size, dtype=np.int32)
        rank = np.full(e_size, INT32_MAX, dtype=np.int32)
        src[0:e2:2] = self.u
        dst[0:e2:2] = self.v
        src[1:e2:2] = self.v
        dst[1:e2:2] = self.u
        rank[0:e2:2] = rank_of_edge
        rank[1:e2:2] = rank_of_edge
        ra, rb = self.rank_endpoints(pad_to=m_size)
        return src, dst, rank, ra, rb

    def rank_endpoints(
        self, *, pad_to: int | None = None, native: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(ra, rb)``: endpoints of the rank-``r`` edge, indexed by rank,
        right-padded with zeros, int32; one native pass unless ``native`` is
        False."""
        m = self.num_edges
        size = m if pad_to is None else int(pad_to)
        if size < m:
            raise ValueError("pad_to smaller than edge count")
        order = self._rank_order
        if native:
            return native_lib.rank_endpoints_i32(order, self.u, self.v, size)
        ra = np.zeros(size, dtype=np.int32)
        rb = np.zeros(size, dtype=np.int32)
        ra[:m] = self.u[order]
        rb[:m] = self.v[order]
        return ra, rb

    @functools.cached_property
    def _rank_order(self) -> np.ndarray:
        """Edge ids sorted by ``(weight, edge id)``."""
        return rank_order(self.w)

    @functools.cached_property
    def first_ranks(self) -> np.ndarray:
        """Per-vertex minimum incident rank, int32 (INT32_MAX when isolated).

        This is Borůvka's level 1 computed on the host: at the identity
        partition every incident edge leaves its fragment, so each vertex's
        minimum outgoing edge is its minimum-rank incident edge.
        """
        return first_ranks_of(self.num_nodes, *self.rank_endpoints())

    @functools.cached_property
    def ell_buckets(self):
        """Degree-bucketed ELL layout of the directed adjacency.

        Vertices split by degree class ``(W/2, W]`` (``W`` a power of two)
        into one bucket each: ``(verts[Vb], dst[Vb, W], rank[Vb, W])``, int32.
        A row holds one vertex's slots in rank order (the identity level
        reads the first entry as the row minimum); short rows pad with the
        vertex itself as destination and rank INT32_MAX. ``Vb`` pads to a
        power of two with rows of vertex 0, destination 0 and rank
        INT32_MAX, inert under the scatter-min that collects per-vertex
        minima.
        """
        n, m = self.num_nodes, self.num_edges
        rank_of_edge = np.empty(m, dtype=np.int64)
        rank_of_edge[self._rank_order] = np.arange(m)
        ds = np.concatenate([self.u, self.v])
        dd = np.concatenate([self.v, self.u])
        dr = np.concatenate([rank_of_edge, rank_of_edge])
        o2 = np.lexsort((dr, ds))
        dd, dr, ds = dd[o2], dr[o2], ds[o2]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, ds + 1, 1)
        np.cumsum(indptr, out=indptr)
        deg = np.diff(indptr)

        def pow2(x: int) -> int:
            return 1 << max(0, int(x - 1).bit_length())

        buckets = []
        w = 1
        max_deg = int(deg.max()) if n else 0
        while w <= max(1, pow2(max_deg)):
            lo = (w >> 1) + 1 if w > 1 else 1
            sel = (deg >= lo) & (deg <= w)
            if sel.any():
                verts = np.nonzero(sel)[0].astype(np.int64)
                vb = len(verts)
                vb_pad = pow2(vb)
                pos = indptr[verts][:, None] + np.arange(w)[None, :]
                valid = np.arange(w)[None, :] < deg[verts][:, None]
                pos = np.where(valid, pos, 0)
                dstb = np.where(valid, dd[pos], verts[:, None]).astype(np.int32)
                rankb = np.where(valid, dr[pos], INT32_MAX).astype(np.int32)
                if vb_pad > vb:
                    pad = vb_pad - vb
                    verts = np.concatenate([verts, np.zeros(pad, dtype=np.int64)])
                    dstb = np.vstack([dstb, np.zeros((pad, w), dtype=np.int32)])
                    rankb = np.vstack([rankb, np.full((pad, w), INT32_MAX, dtype=np.int32)])
                buckets.append((verts.astype(np.int32), dstb, rankb))
            w <<= 1
        return buckets

    def edge_id_of_rank(self, ranks: np.ndarray) -> np.ndarray:
        """Map ranks (as produced by :meth:`rank_arrays`) back to edge ids."""
        return self._rank_order[ranks]


def rank_order(w: np.ndarray, *, native: bool = True) -> np.ndarray:
    """Edge ids sorted by ``(weight, edge id)``. Integer weights whose range
    spans at most 2^22 values take the native stable counting sort; float
    weights and wider ranges take a stable argsort, as in the JAX package.
    ``native=False`` takes the argsort for every weight."""
    if native and w.dtype.kind in "iu" and w.size:
        order = native_lib.rank_order_counting(w)
        if order is not None:
            return order
    return np.argsort(w, kind="stable")


def first_ranks_of(num_nodes: int, ra: np.ndarray, rb: np.ndarray, *,
                   native: bool = True) -> np.ndarray:
    """:attr:`Graph.first_ranks` from the unpadded rank endpoints: one native
    pass, or with ``native=False`` the first occurrence of each vertex in
    rank-interleaved endpoint order."""
    if native:
        return native_lib.first_rank_i32(num_nodes, ra, rb)
    arr = np.empty(2 * ra.size, dtype=np.int64)
    arr[0::2] = ra
    arr[1::2] = rb
    verts, first_pos = np.unique(arr, return_index=True)
    out = np.full(num_nodes, INT32_MAX, dtype=np.int32)
    out[verts] = (first_pos // 2).astype(np.int32)
    return out


def component_labels(num_nodes: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Component label per vertex of the undirected edge list (one
    ``scipy.sparse.csgraph`` pass)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix(
        (np.ones(u.size, dtype=np.int8), (u, v)),
        shape=(num_nodes, num_nodes),
    )
    _, labels = connected_components(adj, directed=False)
    return labels.astype(np.int64)
