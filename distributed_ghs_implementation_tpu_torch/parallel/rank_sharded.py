"""Sharded rank-space solver: the mesh's fast path (the JAX package's
``parallel/rank_sharded.py``).

* **Layout.** The undirected rank space is block-sharded: global shard
  ``k`` owns ranks ``[k * mb, (k + 1) * mb)``, so the blocks keep the global
  rank order, the tie-break total order. ``vmin0`` (each vertex's minimum
  incident rank, from the host) and all fragment state are replicated, one
  copy a device; each shard's forest mask marks the ranks it owns.
* **Level 1** comes from the host (``host_level1``); each shard only marks
  the level-1 ranks it owns.
* **Level 2** is one per-shard segment minimum over the local block and
  one n-sized ``pmin``; the owner of each winning rank proposes its
  endpoints' fragments, every other shard proposes ``INT32_MAX``, and two
  more ``pmin``s select them. K1 runs the merge once a device.
* **Capacity guard.** While the survivors are too many to gather, whole
  levels run in place over the sharded blocks.
* **Finish.** Survivors are compacted per shard and gathered: shard-block
  concatenation keeps the global rank order, so the gathered slot index is
  a valid tie-break. The remaining levels run replicated.
* **Filtered** (dense graphs at the filter width): level 1 stays sharded,
  the prefix's levels run through the single-card helpers of
  ``models/rank_solver.py`` on the first device (their result is copied to
  the others), and the filter relabels each shard's block against the
  prefix's partition and compacts its survivors for the finish.
* **Split keys** (``rank64``): every global rank is ``k * mb + local``, so
  the lexicographic order on ``(shard, local)`` is the rank order. The MOE
  combine is two int32 ``pmin``s (the smallest shard holding a candidate,
  then its local minimum); marks and owner lookups derive the shard from
  position. No rank wider than int32 reaches the card.

The harvest of one process concatenates its shards' masks; across
processes each shard's mask packs to bits (big-endian, widths a multiple of
8) and one tiled ``all_gather`` gives every process the whole mask.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    _bucket_size,
    _mark,
    _max_levels,
    fetch_mst_edge_ids,
)
from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
    _CENSUS_MIN_SPACE,
    _INT32_RANK_LIMIT,
    _compact_slots,
    _finish_to_fixpoint,
    _iota,
    _level_core,
    _moe_over,
    _pad_l2_ranks,
    _pick_family,
    _prefix_size,
    _restore_state_host,
    check_rank_envelope,
    host_level1,
    host_level2,
    packbits,
    packed_to_edge_ids,
    use_filtered_path,
)
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX
from distributed_ghs_implementation_tpu_torch.parallel.mesh import EdgeMesh, edge_mesh
from distributed_ghs_implementation_tpu_torch.parallel.sharded import _far_side, _hook_all

_U8 = torch.uint8

# The finish gathers three size * fs_local int32 arrays onto every device;
# past 2^25 gathered slots in-place sharded levels run first (JAX's value).
_FINISH_GATHER_MAX_SLOTS = 1 << 25
# Checkpoint cadence inside the capacity-guard level loop.
_GUARD_CHECKPOINT_EVERY = 4


def _l1_marks(mesh: EdgeMesh, vmin0, mb: int) -> List[torch.Tensor]:
    """Level-1 marks of each local rank block: the chosen ranks are the
    ``vmin0`` values the block owns."""
    out = []
    for j in range(mesh.local_shards):
        v = mesh.shard_rep(vmin0, j)
        has1 = v < INT32_MAX
        local = torch.where(has1, v, 0) - mesh.axis_index(j) * mb
        mine = has1 & (local >= 0) & (local < mb)
        mst = torch.zeros(mb, dtype=_U8, device=v.device)
        _mark(mst, mine, local)
        out.append(mst)
    return out


def _l1_marks_kl(mesh: EdgeMesh, vk, vl, mb: int) -> List[torch.Tensor]:
    """Split-key level-1 marks: vertex ``v``'s minimum incident rank lives
    at shard ``vk[v]``, local offset ``vl[v]`` (``vk == INT32_MAX`` when
    isolated)."""
    out = []
    for j in range(mesh.local_shards):
        k_v, l_v = mesh.shard_rep(vk, j), mesh.shard_rep(vl, j)
        mst = torch.zeros(mb, dtype=_U8, device=k_v.device)
        _mark(mst, k_v == mesh.axis_index(j), l_v)
        out.append(mst)
    return out


# ---------------------------------------------------------------------------
# MOE strategies: int32 global keys and split keys. Each returns the
# replicated ``has`` and winners' endpoint fragments ``wa``/``wb`` (lists a
# device) and each shard's ``(mine, li)`` for its marks.
# ---------------------------------------------------------------------------


def _moe_int32(mesh: EdgeMesh, fa, fb, n: int):
    mb = fa[0].shape[0]
    parts = []
    for j in range(mesh.local_shards):
        gslot = mesh.axis_index(j) * mb + _iota(mb, fa[j].device)
        key = torch.where(fa[j] != fb[j], gslot, INT32_MAX)
        parts.append(_moe_over(fa[j], fb[j], key, n))
    moe = mesh.pmin(parts)
    has = [m < INT32_MAX for m in moe]
    pa, pb, owned = [], [], []
    for j in range(mesh.local_shards):
        d = mesh.rep_of_shard[j]
        local = torch.where(has[d], moe[d], 0) - mesh.axis_index(j) * mb
        mine = has[d] & (local >= 0) & (local < mb)
        li = torch.where(mine, local, 0)
        pa.append(torch.where(mine, fa[j][li], INT32_MAX))
        pb.append(torch.where(mine, fb[j][li], INT32_MAX))
        owned.append((mine, li))
    return has, mesh.pmin(pa), mesh.pmin(pb), owned


def _moe_kl(mesh: EdgeMesh, fa, fb, n: int):
    mb = fa[0].shape[0]
    local_moe, has_local = [], []
    for j in range(mesh.local_shards):
        key = torch.where(fa[j] != fb[j], _iota(mb, fa[j].device), INT32_MAX)
        lm = _moe_over(fa[j], fb[j], key, n)
        local_moe.append(lm)
        has_local.append(lm < INT32_MAX)
    kmin = mesh.pmin([torch.where(h, mesh.axis_index(j), INT32_MAX).to(torch.int32)
                      for j, h in enumerate(has_local)])
    lmin = mesh.pmin([
        torch.where(has_local[j] & (mesh.shard_rep(kmin, j) == mesh.axis_index(j)),
                    local_moe[j], INT32_MAX)
        for j in range(mesh.local_shards)])
    has = [k < INT32_MAX for k in kmin]
    pa, pb, owned = [], [], []
    for j in range(mesh.local_shards):
        d = mesh.rep_of_shard[j]
        mine = has[d] & (kmin[d] == mesh.axis_index(j))
        li = torch.where(mine, lmin[d], 0)
        pa.append(torch.where(mine, fa[j][li], INT32_MAX))
        pb.append(torch.where(mine, fb[j][li], INT32_MAX))
        owned.append((mine, li))
    return has, mesh.pmin(pa), mesh.pmin(pb), owned


def _moe_level(mesh: EdgeMesh, fragment, mst, fa, fb, moe_fn):
    """One hook level over relabeled sharded endpoints, the shared body of
    the int32 and split-key programs. Marks ``mst`` in place. Returns
    ``(fragment, fa, fb, has)``."""
    n = fragment[0].shape[0]
    has, wa, wb, owned = moe_fn(mesh, fa, fb, n)
    dst = [_far_side(a, b, h) for a, b, h in zip(wa, wb, has)]
    fragment, parent = _hook_all(mesh, has, dst, fragment)
    for j, (mine, li) in enumerate(owned):
        _mark(mst[j], mine, li)
    p = [mesh.shard_rep(parent, j) for j in range(mesh.local_shards)]
    return fragment, [p[j][fa[j]] for j in range(len(fa))], \
        [p[j][fb[j]] for j in range(len(fb))], has


def _alive_stats(mesh: EdgeMesh, fa, fb) -> Tuple[int, int]:
    """``(total, cmax)``: the alive slots summed over every shard, and the
    most any one shard holds (JAX's ``psum`` and ``pmax``)."""
    rows = [[(a != b).sum()] * 2 for a, b in zip(fa, fb)]
    total, cmax = mesh.host_reduce(rows, ("sum", "max"))
    return total, cmax


def _head(mesh: EdgeMesh, vmin0, parent1, ra, rb, split=None):
    """Levels 1-2, level 1 from the host's partition (JAX
    ``_rank_sharded_head``; with ``split = (vk, vl)`` the split-key
    ``_rank_sharded_head_kl``, ``vmin0`` unused). Returns ``(fragment,
    mst, fa, fb, levels, total, cmax)``."""
    mb = ra[0].shape[0]
    if split is None:
        mst, has1 = _l1_marks(mesh, vmin0, mb), vmin0[0] < INT32_MAX
    else:
        mst, has1 = _l1_marks_kl(mesh, *split, mb), split[0][0] < INT32_MAX
    fa = [mesh.shard_rep(parent1, j)[ra[j]] for j in range(mesh.local_shards)]
    fb = [mesh.shard_rep(parent1, j)[rb[j]] for j in range(mesh.local_shards)]
    fragment, fa, fb, has2 = _moe_level(mesh, list(parent1), mst, fa, fb,
                                        _moe_int32 if split is None else _moe_kl)
    lv = int(has1.any()) + int(has2[0].any())
    return (fragment, mst, fa, fb, lv, *_alive_stats(mesh, fa, fb))


def _sharded_level(mesh: EdgeMesh, fragment, mst, fa, fb, rank64: bool):
    """One in-place level over the sharded blocks (the capacity guard).
    Returns ``(fragment, fa, fb, total, cmax, progressed)``."""
    fragment, fa, fb, has = _moe_level(mesh, fragment, mst, fa, fb,
                                       _moe_kl if rank64 else _moe_int32)
    total, cmax = _alive_stats(mesh, fa, fb)
    return fragment, fa, fb, total, cmax, bool(has[0].any())


def _gathered_loop(mesh: EdgeMesh, fragment, mst, cfa, cfb, crank, max_levels: int,
                   owner_of):
    """Gather every shard's compacted survivors and run the remaining levels
    replicated; each shard marks the winners it owns. ``owner_of(j, safe,
    winners)`` gives shard ``j``'s ``(mine, local)`` for the gathered
    winners. Returns ``(fragment, levels)``."""
    gfa, gfb, gcrank = mesh.all_gather(cfa), mesh.all_gather(cfb), mesh.all_gather(crank)
    n = fragment[0].shape[0]
    cslot = [_iota(g.shape[0], g.device) for g in gfa]
    alive = bool((gfa[0] != gfb[0]).any())
    lv = 0
    while alive and lv < max_levels:
        parent, has, safe = [], [], []
        for d in range(len(mesh.rep_devices)):
            key = torch.where(gfa[d] != gfb[d], cslot[d], INT32_MAX)
            f, p, h, s = _level_core(fragment[d], gfa[d], gfb[d], key, n)
            fragment[d] = f
            parent.append(p)
            has.append(h)
            safe.append(s)
        for j in range(mesh.local_shards):
            d = mesh.rep_of_shard[j]
            mine, local = owner_of(j, has[d], safe[d], gcrank[d])
            _mark(mst[j], mine, local)
        gfa = [p[a] for p, a in zip(parent, gfa)]
        gfb = [p[b] for p, b in zip(parent, gfb)]
        alive = bool(has[0].any())
        lv += 1
    return fragment, lv


def _finish_pre(mesh: EdgeMesh, fragment, mst, cfa, cfb, crank, max_levels: int):
    """The finish over already-compacted survivors whose ``crank`` carries
    global ranks (JAX ``_rank_sharded_finish_pre``)."""
    mb = mst[0].shape[0]

    def owner_of(j, has, safe, gcrank):
        winners = gcrank[safe] - mesh.axis_index(j) * mb
        return has & (winners >= 0) & (winners < mb), winners

    return _gathered_loop(mesh, fragment, mst, cfa, cfb, crank, max_levels, owner_of)


def _finish(mesh: EdgeMesh, fragment, mst, fa, fb, fs_local: int, max_levels: int,
            rank64: bool):
    """Compact each shard's survivors to ``fs_local`` slots, gather, run the
    remaining levels (JAX ``_rank_sharded_finish`` and, with ``rank64``,
    ``_rank_sharded_finish_kl``: survivors carry local offsets and the
    owning shard is the gathered block, ``slot // fs_local``)."""
    mb = fa[0].shape[0]
    cfa, cfb, crank = [], [], []
    for j in range(mesh.local_shards):
        base = 0 if rank64 else mesh.axis_index(j) * mb
        a, b, r, _ = _compact_slots(fa[j], fb[j], base + _iota(mb, fa[j].device), fs_local)
        cfa.append(a)
        cfb.append(b)
        crank.append(r)
    if not rank64:
        return _finish_pre(mesh, fragment, mst, cfa, cfb, crank, max_levels)

    def owner_of(j, has, safe, gcrank):
        return has & (torch.div(safe, fs_local, rounding_mode="floor") == mesh.axis_index(j)), \
            gcrank[safe]

    return _gathered_loop(mesh, fragment, mst, cfa, cfb, crank, max_levels, owner_of)


def _filter(mesh: EdgeMesh, fragment, prefix_mask, mst, ra, rb, prefix: int,
            fs_local: Optional[int]):
    """The filter: each shard relabels its block against the prefix's final
    partition and merges the prefix marks it owns into its mask (JAX
    ``_filter_core``); with ``fs_local`` it also compacts its survivors
    (``_rank_filter_compact``). Returns ``(fa, fb)`` or ``(cfa, cfb,
    crank)``, and ``(total, cmax)``."""
    mb = ra[0].shape[0]
    fa, fb, gis = [], [], []
    for j in range(mesh.local_shards):
        frag = mesh.shard_rep(fragment, j)
        gi = mesh.axis_index(j) * mb + _iota(mb, frag.device)
        a, b = frag[ra[j]], frag[rb[j]]
        pm = mesh.shard_rep(prefix_mask, j)
        in_prefix = gi < prefix
        merged = in_prefix & (pm[torch.clamp(gi, max=prefix - 1)] != 0)
        mst[j] |= merged.to(_U8)
        fa.append(a)
        fb.append(b)
        gis.append(gi)
    stats = _alive_stats(mesh, fa, fb)
    if fs_local is None:
        return (fa, fb), stats
    out = [_compact_slots(a, b, gi, fs_local)[:3] for a, b, gi in zip(fa, fb, gis)]
    return tuple([o[i] for o in out] for i in range(3)), stats


def mask_harvest(mesh: EdgeMesh, mst: List[torch.Tensor]) -> np.ndarray:
    """Each shard's mask packed to bits, then one tiled ``all_gather`` of
    the bytes (JAX ``make_mask_harvest``): shard widths are multiples of 8,
    so the concatenation is a global ``packbits`` of the whole mask, on
    every process."""
    return mesh.all_gather([packbits(m) for m in mst])[0].cpu().numpy()


def _full_mask_host(mesh: EdgeMesh, mst, m_pad: int, mst_p=None, prefix: int = 0) -> np.ndarray:
    """The whole rank mask on the host (checkpoint saves): the packed
    harvest, then the replicated prefix marks laid over it. Every process
    gets the whole mask, so only the primary need write it."""
    mask = np.unpackbits(mask_harvest(mesh, mst), count=m_pad).astype(bool)
    if mst_p is not None:
        mask[:prefix] |= mst_p[:prefix].cpu().numpy().astype(bool)
    return mask


def solve_graph_rank_sharded(
    graph: Graph,
    *,
    mesh: Optional[EdgeMesh] = None,
    filtered: bool | None = None,
    on_chunk=None,
    initial_state: tuple | None = None,
    rank64: bool | None = None,
    kernel: str | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host entry mirroring ``solve_graph_rank`` on a mesh (``mesh=None``:
    :func:`edge_mesh` on ``device``, ``None`` = CUDA).

    The plain path runs the sharded head (levels 1-2), the capacity-guard
    levels while the survivors are too many to gather, then the compact /
    all-gather finish. Dense graphs at the filter width take the sharded
    filter route instead; ``filtered`` overrides that policy, except that a
    graph without enough suffix past the prefix (``2 * prefix > m_pad``)
    always takes the plain path.

    ``on_chunk(level, vertex_fragment, mask_fn, count)`` fires after the
    head, each prefix chunk, every ``_GUARD_CHECKPOINT_EVERY`` capacity-guard
    levels, and the finish. ``mask_fn`` is a zero-argument callable that
    gives the whole rank mask on the host; it runs a collective, so every
    process must decide alike whether to call it. The mask and the
    fragment are live: a hook consumes them during its call. Prefix-phase
    ``mask_fn`` calls return one shared host array, laid over in place.
    ``initial_state`` is ``(fragment, mask, level)`` from a checkpoint: each
    shard relabels its block against the restored partition and the
    survivors finish as usual.

    ``rank64`` runs the split-key program (auto at 2^31 padded ranks; force
    it to test at small widths); it takes the plain path. ``kernel`` takes
    ``None`` or the mesh's label (``cuda`` or ``torch``): the port has no
    other kernel to choose.
    """
    if mesh is None:
        mesh = edge_mesh(device=device)
    label = "cuda" if mesh.kind == "cuda" else "torch"
    if kernel not in (None, label):
        raise ValueError(f"kernel {kernel!r} does not run on this mesh; it runs {label!r}")
    n_dev = mesh.size
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0

    n_pad = _bucket_size(n)
    # Shard widths divide by 8, so the packed harvest's per-shard bytes
    # concatenate into a global packbits (pad ranks are inert).
    unit = 8 * n_dev
    m_pad = int(math.ceil(_bucket_size(graph.num_edges) / unit) * unit)
    if rank64 is None:
        rank64 = m_pad >= _INT32_RANK_LIMIT
    mb = m_pad // n_dev
    if rank64:
        if n_pad >= _INT32_RANK_LIMIT:
            raise ValueError(
                f"rank64 lifts only the RANK space: padded vertex count {n_pad:,} must "
                f"stay below 2^31 (vertex ids are int32 everywhere).")
        if mb >= _INT32_RANK_LIMIT:
            raise ValueError(
                f"split-key rank64 needs the per-shard rank block below 2^31: {m_pad:,} "
                f"ranks over {n_dev} shard(s) gives mb = {mb:,}. Use more shards.")
        filtered = False
    else:
        check_rank_envelope(n_pad, m_pad)
    ra_np, rb_np = graph.rank_endpoints(pad_to=m_pad)
    ra = mesh.shard_host(ra_np)
    rb = mesh.shard_host(rb_np)
    if initial_state is None:
        if rank64:
            int64_max = np.iinfo(np.int64).max
            vmin0_np = np.full(n_pad, int64_max, dtype=np.int64)
            if m_pad >= _INT32_RANK_LIMIT:
                vmin0_np[:n] = graph.first_ranks64
            else:
                # Small widths: widen the int32 first ranks, remapping the
                # isolated-vertex sentinel.
                fr = graph.first_ranks.astype(np.int64)
                vmin0_np[:n] = np.where(fr == INT32_MAX, int64_max, fr)
        else:
            vmin0_np = np.full(n_pad, INT32_MAX, dtype=np.int32)
            vmin0_np[:n] = graph.first_ranks
        parent1_np = host_level1(vmin0_np, ra_np, rb_np)
        parent1 = mesh.replicate_host(parent1_np)
        if rank64:
            isolated = vmin0_np == np.iinfo(np.int64).max
            vk = mesh.replicate_host(np.where(isolated, INT32_MAX, vmin0_np // mb))
            vl = mesh.replicate_host(np.where(isolated, 0, vmin0_np % mb))
        else:
            vmin0 = mesh.replicate_host(vmin0_np)

    def mask_fn_of(mst_):
        return lambda: _full_mask_host(mesh, mst_, m_pad)

    prefix = _prefix_size(n_pad, m_pad, mult=1)
    if filtered is None:
        filtered = use_filtered_path(_pick_family(graph), m_pad) and 2 * prefix <= m_pad
    fused = None  # the compacted survivors, when the filter's fused compact fits
    if initial_state is not None:
        frag_np, mask_np, lv = _restore_state_host(initial_state, n_pad, m_pad)
        fragment = mesh.replicate_host(frag_np)
        mst = mesh.shard_host(mask_np, torch.uint8)
        fa = [mesh.shard_rep(fragment, j)[ra[j]] for j in range(mesh.local_shards)]
        fb = [mesh.shard_rep(fragment, j)[rb[j]] for j in range(mesh.local_shards)]
        total, cmax = _alive_stats(mesh, fa, fb)
    elif filtered and 2 * prefix <= m_pad:
        fused, fa, fb, fragment, mst, lv, total, cmax = _filtered_phase(
            mesh, graph, vmin0, parent1_np, ra_np, rb_np, ra, rb, n_pad, m_pad, prefix,
            on_chunk)
    else:
        fragment, mst, fa, fb, lv, total, cmax = _head(
            mesh, None if rank64 else vmin0, parent1, ra, rb, (vk, vl) if rank64 else None)
    if on_chunk is not None and initial_state is None:
        on_chunk(lv, fragment[0], mask_fn_of(mst), total)
    if fused is not None:
        # The fused filter's survivors arrive compacted, under the gather
        # budget by construction: no capacity guard.
        if total > 0:
            fragment, extra = _finish_pre(mesh, fragment, mst, *fused, _max_levels(n_pad))
            lv += extra
            if on_chunk is not None:
                on_chunk(lv, fragment[0], mask_fn_of(mst), 0)
    else:
        # Capacity guard: in-place sharded levels while the gathered width
        # would pass the budget. The checkpoint decision is a function of
        # the loop counter alone, the same in every process.
        guard_iters = 0
        while total > 0 and n_dev * _bucket_size(cmax) > _FINISH_GATHER_MAX_SLOTS:
            fragment, fa, fb, total, cmax, progressed = _sharded_level(
                mesh, fragment, mst, fa, fb, rank64)
            lv += 1
            guard_iters += 1
            if not progressed:
                break  # an isolated remainder (disconnected pads)
            if on_chunk is not None and guard_iters % _GUARD_CHECKPOINT_EVERY == 0:
                on_chunk(lv, fragment[0], mask_fn_of(mst), total)
        if total > 0:
            fs_local = max(_bucket_size(cmax), 1024)
            fragment, extra = _finish(mesh, fragment, mst, fa, fb, fs_local,
                                      _max_levels(n_pad), rank64)
            lv += extra
            if on_chunk is not None:
                on_chunk(lv, fragment[0], mask_fn_of(mst), 0)
    if mesh.process_count > 1:
        edge_ids = packed_to_edge_ids(graph, mask_harvest(mesh, mst), m_pad)
    else:
        home = mst[0].device
        edge_ids = fetch_mst_edge_ids(graph, torch.cat([m.to(home) for m in mst]))
    return edge_ids, fragment[0][:n].cpu().numpy(), lv


def _filtered_phase(mesh, graph, vmin0, parent1_np, ra_np, rb_np, ra, rb, n_pad, m_pad,
                    prefix, on_chunk):
    """The sharded filter route up to the finish: level-1 marks on the
    shards, the host's level 2 over the prefix, the prefix's levels through
    the single-card helpers on the first device, then the filter fused with
    the compaction (or, when a shard's survivors overflow the speculative
    width, the two-step filter). Returns ``(fused, fa, fb, fragment, mst,
    levels, total, cmax)``, ``fused`` the compacted survivors or ``None``."""
    mb = m_pad // mesh.size
    home = mesh.rep_devices[0]
    mst = _l1_marks(mesh, vmin0, mb)
    # The prefix comes from the host, which holds the whole graph in every
    # process: 2 * prefix int32 ranks, no gather over the mesh.
    ra_p = torch.from_numpy(np.ascontiguousarray(ra_np[:prefix])).to(home)
    rb_p = torch.from_numpy(np.ascontiguousarray(rb_np[:prefix])).to(home)
    parent12_np, l2r = host_level2(parent1_np, ra_np, rb_np, prefix)
    parent12 = torch.from_numpy(parent12_np).to(home)
    l2 = torch.from_numpy(_pad_l2_ranks(l2r, m_pad)).to(home)
    fa_p, fb_p = parent12[ra_p], parent12[rb_p]
    has2 = l2 < prefix  # pads carry m_pad and are dropped
    mst_p = torch.zeros(prefix, dtype=_U8, device=home)
    _mark(mst_p, has2, l2)
    lv = 1 + int(has2.any())
    count = int((fa_p != fb_p).sum())
    hook = None
    if on_chunk is not None:
        # The sharded mask holds only the level-1 marks through the prefix
        # phase: harvest it at most once and lay the prefix marks over it
        # at each save. The marks only grow, so the shared array stays
        # right.
        l1_cache = []

        def hook(lv_, frag_, mstp_, count_):
            def mask_fn():
                if not l1_cache:
                    l1_cache.append(_full_mask_host(mesh, mst, m_pad))
                full = l1_cache[0]
                full[:prefix] |= mstp_[:prefix].cpu().numpy().astype(bool)
                return full

            on_chunk(lv_, frag_, mask_fn, count_)

        hook(lv, parent12, mst_p, count)
    mst_p, frag_home, lv = _finish_to_fixpoint(
        parent12, mst_p, fa_p, fb_p, _iota(prefix, home),
        lv=lv, count=count, space=n_pad, max_levels=lv + _max_levels(n_pad),
        chunk_levels=3, compact_space=n_pad >= _CENSUS_MIN_SPACE, on_chunk=hook,
    )
    fragment = mesh.replicate(frag_home)
    prefix_mask = mesh.replicate(mst_p)
    fs_spec = min(max(_bucket_size(mb // 128), 1024), _FINISH_GATHER_MAX_SLOTS // mesh.size)
    fused, (total, cmax) = _filter(mesh, fragment, prefix_mask, mst, ra, rb, prefix, fs_spec)
    if cmax <= fs_spec:
        return fused, None, None, fragment, mst, lv, total, cmax
    del fused
    # The two-step filter: merging the prefix marks again changes nothing.
    (fa, fb), (total, cmax) = _filter(mesh, fragment, prefix_mask, mst, ra, rb, prefix, None)
    return None, fa, fb, fragment, mst, lv, total, cmax
