"""Dense edge-list graph container feeding the Borůvka solver.

A graph is three NumPy arrays ``(u, v, w)`` of undirected edges. The solver
consumes the *interleaved directed layout*: undirected edge ``e = (a, b, w)``
becomes directed slots ``2e = a->b`` and ``2e+1 = b->a``, and every edge
carries its *rank*, its position in the total order ``(weight, edge id)``.
That order makes the minimum spanning forest unique, so two solvers that are
both right return the same edge ids.

This is the port's own copy of the JAX package's ``graphs/edgelist.py``.
The rank order, the first ranks and the ELL buckets' CSR run in the port's
native library (``graphs/native.py``), as they do in the JAX package; each
keeps its NumPy form, which ``native=False`` selects.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
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

    @property
    def total_weight(self):
        """The sum of every edge's weight (a NumPy scalar)."""
        return self.w.sum()

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

    @staticmethod
    def from_networkx(g) -> "Graph":
        """Convert a ``networkx.Graph`` whose edges carry ``weight`` (1
        where they do not); its nodes must be ``0..n-1``."""
        edges = [(a, b, d.get("weight", 1)) for a, b, d in g.edges(data=True)]
        return Graph.from_edges(g.number_of_nodes(), edges)

    # ------------------------------------------------------------------
    # Identity
    # ------------------------------------------------------------------
    @functools.cached_property
    def _digest(self) -> str:
        h = hashlib.sha256()
        h.update(np.int64(self.num_nodes).tobytes())
        h.update(self.w.dtype.char.encode())  # int 5 vs float 5.0 differ
        h.update(np.ascontiguousarray(self.u).tobytes())
        h.update(np.ascontiguousarray(self.v).tobytes())
        h.update(np.ascontiguousarray(self.w).tobytes())
        return h.hexdigest()

    def digest(self) -> str:
        """Content hash over ``(num_nodes, w.dtype.char, u, v, w)``, hex
        sha256: the JAX package's ``Graph.digest``, byte for byte, so a
        checkpoint fingerprint means the same graph in both packages.
        Construction canonicalizes the edges, so two graphs of the same
        weighted edge set share a digest whatever their input order.
        Computed once per instance."""
        return self._digest

    def digest_words(self) -> np.ndarray:
        """:meth:`digest` as four int64 words, the array form a checkpoint
        fingerprint embeds."""
        return np.frombuffer(bytes.fromhex(self._digest), dtype=np.int64).copy()

    # ------------------------------------------------------------------
    # Binary wire codec (fleet/framing.py B-frames)
    # ------------------------------------------------------------------
    def to_wire(self) -> dict:
        """This graph as a binary request fragment: ``num_nodes``,
        ``num_edges`` and ``digest`` as JSON fields plus ``u``/``v``/``w``
        as raw little-endian sections. The canonical arrays go onto the
        wire as they are, so the receiver's :meth:`from_wire` digest equals
        this one."""
        from distributed_ghs_implementation_tpu_torch.fleet.framing import (
            SECTIONS_KEY,
            WireSections,
        )

        return {
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "digest": self.digest(),
            SECTIONS_KEY: WireSections().add("u", self.u).add("v", self.v).add("w", self.w),
        }

    @staticmethod
    def from_wire(payload: dict) -> "Graph":
        """Rebuild from a binary request fragment: ``np.frombuffer`` views
        over the received frame buffer, no copies.

        The arrays are taken as canonical only after a vectorized check
        (in range, ``u < v``, strictly lexsorted: what :meth:`from_arrays`
        would produce); a non-canonical sender goes through
        :meth:`from_arrays`, so the digest always names the canonical form,
        as on the JSON ``edges`` path. The arrays of the canonical case are
        read-only views; nothing writes to a ``Graph``'s arrays."""
        from distributed_ghs_implementation_tpu_torch.fleet.framing import SECTIONS_KEY

        secs = payload.get(SECTIONS_KEY)
        if secs is None or not all(n in secs for n in ("u", "v", "w")):
            raise ValueError(
                "binary graph payload needs u/v/w sections "
                f"(got {getattr(secs, 'names', None)})"
            )
        num_nodes = int(payload["num_nodes"])
        u, v, w = secs.array("u"), secs.array("v"), secs.array("w")
        if u.dtype != np.int64 or v.dtype != np.int64:
            raise ValueError(f"endpoint sections must be int64, got {u.dtype}/{v.dtype}")
        if w.dtype not in (np.dtype(np.int64), np.dtype(np.float64)):
            raise ValueError(f"weight section must be i8/f8, got {w.dtype}")
        if not (u.shape == v.shape == w.shape):
            raise ValueError(f"section lengths disagree: {u.size}/{v.size}/{w.size}")
        m = u.size
        canonical = m == 0 or (
            int(u.min()) >= 0
            and int(v.max()) < num_nodes
            and bool(np.all(u < v))
            and bool(np.all((u[1:] > u[:-1]) | ((u[1:] == u[:-1]) & (v[1:] > v[:-1]))))
        )
        if canonical:
            if m == 0:
                e = np.zeros(0, dtype=np.int64)
                return Graph(num_nodes, e, e.copy(), w.astype(w.dtype))
            return Graph(num_nodes, u, v, w)
        return Graph.from_arrays(num_nodes, u, v, w)

    # ------------------------------------------------------------------
    # Views
    # ------------------------------------------------------------------
    def edge_triples(self) -> list:
        """The edges as ``[(u, v, w), ...]`` of Python scalars (``w`` an int
        for integer weights, else a float)."""
        cast = int if self.is_integer_weighted else float
        return [(int(a), int(b), cast(c)) for a, b, c in zip(self.u, self.v, self.w)]

    def to_networkx(self):
        """A ``networkx.Graph`` over ``0..n-1`` with ``weight`` on every edge.
        NetworkX is imported here: the card's machine has none."""
        import networkx as nx

        g = nx.Graph()
        g.add_nodes_from(range(self.num_nodes))
        g.add_weighted_edges_from(self.edge_triples())
        return g

    def device_weight_dtype(self) -> np.dtype:
        """The weight type of the directed layout: int32 where every weight
        lies strictly inside its range, else float32."""
        i32 = np.iinfo(np.int32)
        if self.is_integer_weighted and (
                self.w.size == 0 or (self.w.min() > i32.min and self.w.max() < i32.max)):
            return np.dtype(np.int32)
        return np.dtype(np.float32)

    def directed_arrays(self, *, pad_to: int | None = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The interleaved directed layout ``(src, dst, w)`` of length
        ``2m``: slot ``2e`` is ``u[e] -> v[e]``, slot ``2e + 1`` is ``v[e] ->
        u[e]``. ``pad_to`` right-pads with self-edges at vertex 0 of the
        weight type's largest value (``inf`` for floats), which are never
        outgoing."""
        n2 = 2 * self.num_edges
        wd = self.device_weight_dtype()
        sentinel = np.iinfo(wd).max if wd.kind == "i" else np.inf
        size = n2 if pad_to is None else int(pad_to)
        if size < n2:
            raise ValueError(f"pad_to={pad_to} < 2*m={n2}")
        src = np.zeros(size, dtype=np.int32)
        dst = np.zeros(size, dtype=np.int32)
        w = np.full(size, sentinel, dtype=wd)
        src[0:n2:2] = self.u
        dst[0:n2:2] = self.v
        src[1:n2:2] = self.v
        dst[1:n2:2] = self.u
        w[0:n2:2] = self.w.astype(wd)
        w[1:n2:2] = self.w.astype(wd)
        return src, dst, w

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR adjacency over the directed slots: ``(indptr, dst, w)``, the
        slots sorted by source, stably (each row in slot order)."""
        src, dst, w = self.directed_arrays()
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, dst, w

    def degrees(self) -> np.ndarray:
        """Each vertex's number of incident edges, int64."""
        return np.bincount(self.u, minlength=self.num_nodes) + np.bincount(
            self.v, minlength=self.num_nodes)

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
    def first_ranks64(self) -> np.ndarray:
        """:attr:`first_ranks` with int64 ranks and an INT64_MAX isolated
        sentinel, for the sharded ``rank64`` path, whose rank space can pass
        2^31 (ranks outgrow int32 long before vertex ids do)."""
        return first_ranks64_of(self.num_nodes, *self.rank_endpoints())

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
        minima. The slots' CSR comes from the native library
        (:meth:`build_ell_buckets`).
        """
        return self.build_ell_buckets()

    def build_ell_buckets(self, *, native: bool = True) -> list:
        """:attr:`ell_buckets`, computed anew (not cached). The directed
        slots' CSR, rows in rank order, is one native pass
        (``build_rank_csr``, as the JAX package's ``ell_buckets`` calls
        it), or with ``native=False`` a NumPy ``lexsort``; the buckets are
        cut from it in NumPy either way."""
        rank_of_edge = np.empty(self.num_edges, dtype=np.int64)
        rank_of_edge[self._rank_order] = np.arange(self.num_edges)
        n = self.num_nodes
        if native:
            indptr, dd, dr = native_lib.build_rank_csr(n, self.u, self.v, rank_of_edge)
        else:
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


def first_ranks64_of(num_nodes: int, ra: np.ndarray, rb: np.ndarray, *,
                     native: bool = True) -> np.ndarray:
    """:attr:`Graph.first_ranks64` from the unpadded int32 rank endpoints:
    one native pass, or with ``native=False`` its NumPy form."""
    if native:
        return native_lib.first_rank_i32_out64(num_nodes, ra, rb)
    arr = np.empty(2 * ra.size, dtype=np.int64)
    arr[0::2] = ra
    arr[1::2] = rb
    verts, first_pos = np.unique(arr, return_index=True)
    out = np.full(num_nodes, np.iinfo(np.int64).max, dtype=np.int64)
    out[verts] = first_pos // 2
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
