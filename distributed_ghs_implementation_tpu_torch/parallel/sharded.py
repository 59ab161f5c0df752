"""Edge-sharded MST solve over an :class:`EdgeMesh` (the JAX package's
``parallel/sharded.py``).

Layout: directed slots are block-sharded over the mesh (global shard ``k``
owns slots ``[k * e_local, (k + 1) * e_local)`` and ranks ``[k * m_local,
(k + 1) * m_local)``, the contiguity the global tie-break ids rely on);
``fragment`` is replicated and every device runs the same hook-and-compress
update (K1, once a device), so the merge needs no collective. A level's
only combines are three n-sized ``pmin``s: the per-fragment minimum rank,
then the two endpoint fragments the shard owning the winning rank proposes
(every other shard proposes the ``INT32_MAX`` sentinel). Past level 0 each
shard's slot block gathers its source fragment and key through K2.

The ELL form shards each degree bucket's rows over the mesh (rows padded to
a multiple of the shard count) with ``ra``/``rb`` replicated, and combines
the per-vertex minima with one ``pmin`` a level. Its row minimum is JAX's
XLA form, as plain torch ops: the JAX sharded ELL never takes the fused row
kernel, so K3 does not run here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    ELL_AUTO_EDGE_THRESHOLD,
    _bucket_size,
    _mark,
    _max_levels,
    fetch_mst_edge_ids,
)
from distributed_ghs_implementation_tpu_torch.models.rank_solver import _iota
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX, segment_min
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress
from distributed_ghs_implementation_tpu_torch.parallel.mesh import EdgeMesh, edge_mesh


def _empty(n: int):
    return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0


def _hook_all(mesh: EdgeMesh, has, dst_frag, fragment):
    """The replicated merge: K1 once a device. Returns ``(fragment,
    parent)`` lists."""
    out = [hook_and_compress(h, d, f) for h, d, f in zip(has, dst_frag, fragment)]
    return [o[0] for o in out], [o[1] for o in out]


def _far_side(fa, fb, has):
    """Each fragment's hook target from its MOE's endpoint fragments."""
    ids = _iota(fa.shape[0], fa.device)
    return torch.where(has, torch.where(fa == ids, fb, fa), ids)


# ---------------------------------------------------------------------------
# Flat edge-sharded level loop
# ---------------------------------------------------------------------------


def sharded_level(mesh: EdgeMesh, fragment, mst, src, dst, rank, ra, rb, *,
                  identity_fragment: bool = False):
    """One Borůvka level over the sharded slots (JAX ``boruvka_level`` with
    ``axis_name``). ``fragment`` is replicated (a list a device); ``mst``,
    ``src``, ``dst``, ``rank``, ``ra`` and ``rb`` are sharded (a list a
    shard); each shard's mask is marked in place where it owns the winning
    rank. Returns ``(fragment, progress)``."""
    n = fragment[0].shape[0]
    m_local = ra[0].shape[0]
    parts = []
    for j in range(mesh.local_shards):
        if identity_fragment:
            f_src = src[j]
            key = torch.where(src[j] != dst[j], rank[j], INT32_MAX)
        else:
            f_src, key = kernels.gather_key(mesh.shard_rep(fragment, j), src[j], dst[j], rank[j])
        parts.append(segment_min(key, f_src, n))
    moe = mesh.pmin(parts)
    has = [m < INT32_MAX for m in moe]
    prop_a, prop_b = [], []
    for j in range(mesh.local_shards):
        d = mesh.rep_of_shard[j]
        local = moe[d] - mesh.axis_index(j) * m_local
        mine = has[d] & (local >= 0) & (local < m_local)
        safe = torch.where(mine, local, 0)
        frag = fragment[d]
        prop_a.append(torch.where(mine, frag[ra[j][safe]], INT32_MAX))
        prop_b.append(torch.where(mine, frag[rb[j][safe]], INT32_MAX))
        _mark(mst[j], mine, safe)
    fa, fb = mesh.pmin(prop_a), mesh.pmin(prop_b)
    dst_frag = [_far_side(a, b, h) for a, b, h in zip(fa, fb, has)]
    fragment, _ = _hook_all(mesh, has, dst_frag, fragment)
    return fragment, bool(has[0].any())


def sharded_solve(mesh: EdgeMesh, num_nodes: int, src, dst, rank, ra, rb):
    """The flat sharded solve from the identity partition (JAX
    ``make_sharded_solver``): level 0 unrolled with the identity fragment,
    then levels while a fragment has an outgoing edge, capped at
    ``_max_levels(num_nodes)``. Returns ``(mst shards, fragment list,
    levels)``."""
    fragment = [_iota(num_nodes, d) for d in mesh.rep_devices]
    mst = [torch.zeros(r.shape[0], dtype=torch.uint8, device=r.device) for r in ra]
    fragment, progress = sharded_level(mesh, fragment, mst, src, dst, rank, ra, rb,
                                       identity_fragment=True)
    level, max_levels = 1, _max_levels(num_nodes)
    while progress and level < max_levels:
        fragment, progress = sharded_level(mesh, fragment, mst, src, dst, rank, ra, rb)
        level += 1
    return mst, fragment, level


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _shard_buckets(mesh: EdgeMesh, buckets) -> list:
    """Each bucket's rows block-sharded over the mesh: a list a local shard
    of ``(verts, dst, rank)`` tensors."""
    shards = [[] for _ in range(mesh.local_shards)]
    for verts, dstb, rankb in buckets:
        for j, parts in enumerate(zip(*(mesh.shard_host(a) for a in (verts, dstb, rankb)))):
            shards[j].append(parts)
    return shards


def make_sharded_solver(mesh: EdgeMesh, num_nodes: int):
    """JAX ``make_sharded_solver``: a solver ``(src, dst, rank, ra, rb) ->
    (mst_ranks, fragment, levels)`` over ``mesh`` from the identity
    partition of ``num_nodes`` vertices (:func:`sharded_solve`).

    The arguments are the global arrays of ``Graph.rank_arrays`` (NumPy, or
    tensors, read back to the host), each block-sharded here
    (``mesh.shard_host``, which raises unless the slot count and the rank
    count divide by the shard count: pad with inert entries first).
    ``mst_ranks`` is the bool mask over every rank, gathered from the
    shards, ``fragment`` the replicated int32 labels and ``levels`` an int,
    all on the mesh's first device."""
    def solve(src, dst, rank, ra, rb):
        shards = (mesh.shard_host(_host(a)) for a in (src, dst, rank, ra, rb))
        mst, fragment, levels = sharded_solve(mesh, num_nodes, *shards)
        return mesh.all_gather(mst)[0].bool(), fragment[0], int(levels)

    return solve


def _harvest_shards(graph: Graph, mst: List[torch.Tensor], fragment, levels):
    home = mst[0].device
    mask = torch.cat([m.to(home) for m in mst])
    return (fetch_mst_edge_ids(graph, mask), fragment[0][: graph.num_nodes].cpu().numpy(),
            int(levels))


# ---------------------------------------------------------------------------
# Row-sharded ELL
# ---------------------------------------------------------------------------


def _ell_row_min(fragment, verts, dstb, rankb):
    """JAX's XLA form of a bucket's row minimum: both fragment gathers, the
    outgoing mask, the row reduction."""
    fv = fragment[verts]
    fd = fragment[dstb]
    key = torch.where(fd != fv[:, None], rankb, INT32_MAX)
    return key.amin(1)


def _ell_sharded_level(mesh: EdgeMesh, fragment, mst, buckets, ra, rb, *,
                       identity_fragment: bool = False):
    """One level over the row-sharded buckets (JAX ``_ell_level`` with
    ``axis_name``): per-shard per-vertex minima, one ``pmin``, the rest
    replicated. ``buckets[j]`` is shard ``j``'s row slice of every bucket;
    ``fragment``, ``mst``, ``ra`` and ``rb`` are replicated (a list a
    device). Returns ``(fragment, has_any)``."""
    n = fragment[0].shape[0]
    parts = []
    for j in range(mesh.local_shards):
        frag = mesh.shard_rep(fragment, j)
        vmin = torch.full((n,), INT32_MAX, dtype=torch.int32, device=frag.device)
        for verts, dstb, rankb in buckets[j]:
            if identity_fragment:
                row_min = rankb[:, 0]  # rank-sorted rows: the first entry is the minimum
            else:
                row_min = _ell_row_min(frag, verts, dstb, rankb)
            # Pad rows alias vertex 0 with the sentinel: a min-scatter is inert.
            vmin.scatter_reduce_(0, verts.long(), row_min, "amin")
        parts.append(vmin)
    vmin = mesh.pmin(parts)
    has, dst_frag = [], []
    for d in range(len(mesh.rep_devices)):
        frag = fragment[d]
        moe = vmin[d] if identity_fragment else segment_min(vmin[d], frag, n)
        h = moe < INT32_MAX
        safe = torch.where(h, moe, 0)
        if identity_fragment:
            fa, fb = ra[d][safe], rb[d][safe]
        else:
            fa, fb = frag[ra[d][safe]], frag[rb[d][safe]]
        dst_frag.append(_far_side(fa, fb, h))
        _mark(mst[d], h, moe)
        has.append(h)
    fragment, _ = _hook_all(mesh, has, dst_frag, fragment)
    return fragment, bool(has[0].any())


def sharded_ell_solve(mesh: EdgeMesh, num_nodes: int, buckets, ra, rb):
    """The row-sharded ELL solve from the identity partition (JAX
    ``make_sharded_ell_solver``). Returns ``(mst list, fragment list,
    levels)``, both replicated."""
    fragment = [_iota(num_nodes, d) for d in mesh.rep_devices]
    mst = [torch.zeros(r.shape[0], dtype=torch.uint8, device=r.device) for r in ra]
    fragment, has = _ell_sharded_level(mesh, fragment, mst, buckets, ra, rb,
                                       identity_fragment=True)
    level, max_levels = 1, _max_levels(num_nodes)
    while has and level < max_levels:
        fragment, has = _ell_sharded_level(mesh, fragment, mst, buckets, ra, rb)
        level += 1
    return mst, fragment, level


def make_sharded_ell_solver(mesh: EdgeMesh, num_nodes: int):
    """JAX ``make_sharded_ell_solver``: a solver ``(buckets, ra, rb) ->
    (mst_ranks, fragment, levels)`` over ``mesh`` (:func:`sharded_ell_solve`).

    ``buckets`` is a sequence of global ``(verts, dst, rank)`` buckets
    (NumPy, as ``Graph.ell_buckets`` gives them), whose row counts must
    divide by the shard count; each bucket's rows are block-sharded here
    (:func:`_shard_buckets`), and ``ra``/``rb`` replicated. The results are replicated: the bool rank
    mask, the int32 labels and the level count, on the mesh's first
    device."""
    def solve(buckets, ra, rb):
        mst, fragment, levels = sharded_ell_solve(
            mesh, num_nodes, _shard_buckets(mesh, buckets), mesh.replicate_host(_host(ra)),
            mesh.replicate_host(_host(rb)))
        return mst[0].bool(), fragment[0], int(levels)

    return solve


def solve_graph_sharded_ell(graph: Graph, *, mesh: Optional[EdgeMesh] = None,
                            device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """ELL strategy on a mesh; ``solve_graph_sharded``'s contract. Each
    bucket's rows pad to a multiple of the shard count with rows of vertex
    0, destination 0 and rank ``INT32_MAX``."""
    if mesh is None:
        mesh = edge_mesh(device=device)
    n_dev = mesh.size
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return _empty(n)
    n_pad = _bucket_size(n)
    m_pad = _bucket_size(graph.num_edges)
    ra_np, rb_np = graph.rank_endpoints(pad_to=m_pad)
    with BUS.span("parallel.stage", cat="parallel", strategy="ell", devices=n_dev):
        buckets = []
        for verts, dstb, rankb in graph.ell_buckets:
            vb, w = dstb.shape
            vb_pad = int(math.ceil(vb / n_dev) * n_dev)
            if vb_pad > vb:
                pad = vb_pad - vb
                verts = np.concatenate([verts, np.zeros(pad, dtype=np.int32)])
                dstb = np.vstack([dstb, np.zeros((pad, w), dtype=np.int32)])
                rankb = np.vstack([rankb, np.full((pad, w), INT32_MAX, dtype=np.int32)])
            buckets.append((verts, dstb, rankb))
        buckets = _shard_buckets(mesh, buckets)
        ra = mesh.replicate_host(ra_np)
        rb = mesh.replicate_host(rb_np)
    with BUS.span("parallel.sharded.solve", cat="parallel", strategy="ell", devices=n_dev):
        mst, fragment, levels = sharded_ell_solve(mesh, n_pad, buckets, ra, rb)
    return (fetch_mst_edge_ids(graph, mst[0]), fragment[0][:n].cpu().numpy(), int(levels))


def solve_graph_sharded(
    graph: Graph,
    *,
    mesh: Optional[EdgeMesh] = None,
    bucket_shapes: bool = True,
    strategy: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host entry mirroring ``models.boruvka.solve_graph`` on a mesh
    (``mesh=None``: :func:`edge_mesh` on ``device``, ``None`` = CUDA).

    ``strategy``: ``"rank"`` = the rank-space solver (sharded head, then
    the all-gathered compact finish; ``parallel/rank_sharded.py``);
    ``"flat"`` = the edge-sharded flat level loop; ``"ell"`` = the
    row-sharded ELL loop; ``"auto"`` = ``rank`` at ``ELL_AUTO_EDGE_THRESHOLD``
    edges and above, below it ``flat`` in one process and ``ell`` across
    processes. Returns ``(sorted edge ids, fragment[:n], levels)``, equal to
    the JAX package's on the same graph and shard count.
    """
    if strategy not in ("auto", "rank", "flat", "ell"):
        raise ValueError(f"unknown strategy {strategy!r}; expected auto|rank|flat|ell")
    if mesh is None:
        mesh = edge_mesh(device=device)
    if mesh.process_count > 1:
        # The flat solve's slot-sharded mask is harvested by concatenating
        # local shards: one process cannot read the others'. Rank (packed
        # all_gather harvest) and ELL (replicated mask) harvest everywhere.
        if strategy == "flat":
            raise ValueError(
                "strategy='flat' is single-process only (slot-sharded outputs are not "
                "harvestable across processes); use 'rank', 'ell' or 'auto'")
        if strategy == "auto":
            strategy = "rank" if graph.num_edges >= ELL_AUTO_EDGE_THRESHOLD else "ell"
    if strategy == "auto":
        strategy = "rank" if graph.num_edges >= ELL_AUTO_EDGE_THRESHOLD else "flat"
    if strategy == "rank":
        from distributed_ghs_implementation_tpu_torch.parallel.rank_sharded import (
            solve_graph_rank_sharded,
        )

        return solve_graph_rank_sharded(graph, mesh=mesh)
    if strategy == "ell":
        return solve_graph_sharded_ell(graph, mesh=mesh)
    n_dev = mesh.size
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return _empty(n)
    n_pad = _bucket_size(n) if bucket_shapes else n
    e2 = 2 * graph.num_edges
    e_pad = _bucket_size(e2) if bucket_shapes else e2
    # Both the slot axis and the rank axis (e_pad // 2) divide by the shard count.
    e_pad = int(math.ceil(e_pad / (2 * n_dev)) * 2 * n_dev)
    arrays = graph.rank_arrays(pad_edges_to=e_pad, pad_ranks_to=e_pad // 2)
    with BUS.span("parallel.stage", cat="parallel", strategy="flat", devices=n_dev):
        src, dst, rank, ra, rb = (mesh.shard_host(a) for a in arrays)
    with BUS.span("parallel.sharded.solve", cat="parallel", strategy="flat", devices=n_dev):
        mst, fragment, levels = sharded_solve(mesh, n_pad, src, dst, rank, ra, rb)
    return _harvest_shards(graph, mst, fragment, levels)
