"""Rank-space Borůvka solver: the route ``solve_graph`` takes at 2^17 edges
and above.

Port of the JAX package's ``models/rank_solver.py`` without its
filter-Kruskal route (dense graphs at ``_FILTER_MIN_RANKS`` padded ranks and
above), which raises here.

* **Level 1 runs on the host.** At the identity partition each vertex's
  minimum outgoing edge is its minimum-rank incident edge
  (``Graph.first_ranks``), and :func:`host_level1` hooks and compresses on
  the host while the rank endpoints are copied to the card. Grid and sparse
  graphs run level 2 on the host as well (:func:`host_level2`).
* **Rank space.** The state of undirected rank ``r`` is its two current
  fragment endpoints ``(fa[r], fb[r])``; the rank (or, after a compaction,
  the slot index) is the tie-break order, so weights never reach the card.
* **Both spaces shrink.** Finish chunks compact the surviving slots and,
  where it pays, census the live roots and renumber them densely, so late
  levels cost O(alive) instead of O(n); one replay brings the vertex labels
  back at the end.

One level is the segment minimum over both directions of the alive slots
(``scatter_reduce_`` "amin"), the hook and compress (K1 ``hook_compress``
on the card, through ``union_find.hook_and_compress``) and a max-scatter
into the forest mask. Each JAX ``while_loop`` is a Python loop here that
reads one small tensor a level: the loop's one host sync. JAX donates the
mask to each chunk; here each chunk updates it in place, so an ``on_chunk``
hook that keeps the mask or the fragment past its call copies it. State is
int32; the mask is uint8 (0/1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    _COMPACT_MIN_SLOTS,
    _bucket_size,
    _mark,
    _max_levels,
    fetch_mst_edge_ids,
)
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX, segment_min
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress

# Above this many slots the segment minimum runs over each direction in
# turn instead of over their concatenation, which would double the slot
# arrays' memory.
_MOE_TWO_PASS_SLOTS = 1 << 28


def _iota(size: int, device) -> torch.Tensor:
    return torch.arange(size, dtype=torch.int32, device=device)


def _ints(*scalars) -> list:
    """Small device tensors as Python ints: one host sync."""
    return torch.stack([s.long() for s in scalars]).tolist()


def _moe_over(fa, fb, key, n: int) -> torch.Tensor:
    """Per-fragment minimum key over both edge directions."""
    if fa.shape[0] > _MOE_TWO_PASS_SLOTS:
        return torch.minimum(segment_min(key, fa, n), segment_min(key, fb, n))
    return segment_min(torch.cat([key, key]), torch.cat([fa, fb]), n)


def _level1_hook(vmin0, ra, rb):
    """Level 1: hook every vertex on its minimum incident rank. Returns
    ``(fragment, parent1, has1, safe1)``."""
    ids = _iota(vmin0.shape[0], vmin0.device)
    has1 = vmin0 < INT32_MAX
    safe1 = torch.where(has1, vmin0, 0)
    a = ra[safe1]
    b = rb[safe1]
    dst1 = torch.where(has1, torch.where(a == ids, b, a), ids)
    fragment, parent1 = hook_and_compress(has1, dst1, ids)
    return fragment, parent1, has1, safe1


def host_level1(vmin0: np.ndarray, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """The level-1 partition on the host, equal to :func:`_device_level1`:
    the same hooks, the mutual-pair break (the smaller id becomes the root)
    and pointer jumping to the fixpoint."""
    n = vmin0.shape[0]
    ids = np.arange(n, dtype=np.int32)
    has1 = vmin0 < np.iinfo(vmin0.dtype).max
    safe1 = np.where(has1, vmin0, 0)
    a = ra[safe1]
    b = rb[safe1]
    parent = np.where(has1, np.where(a == ids, b, a), ids).astype(np.int32)
    return _host_break_and_jump(parent, "host_level1")


def _host_break_and_jump(parent: np.ndarray, what: str) -> np.ndarray:
    """Mutual-pair break and pointer jumping, bounded: a hook forest whose
    only cycles are mutual pairs converges in ``ceil(log2 n) + 1`` jumps, so
    input that does not converge raises instead of hanging the host."""
    n = parent.shape[0]
    ids = np.arange(n, dtype=np.int32)
    mutual = parent[parent] == ids
    parent = np.where(mutual & (ids < parent), ids, parent)
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)):
        p2 = parent[parent]
        if np.array_equal(p2, parent):
            return parent
        parent = p2
    raise ValueError(
        f"{what} did not converge: hook input is not a true per-vertex/"
        f"per-fragment minimum (hook graph has a cycle longer than 2)"
    )


def host_level2(parent1: np.ndarray, ra: np.ndarray, rb: np.ndarray, m: int):
    """Level 2 on the host, equal to the card's level over the level-1
    fragments: each fragment's first cross rank, the hook with the
    mutual-pair break, pointer jumping. Returns ``(parent12, l2_ranks)``,
    the composed two-level vertex partition and the sorted ranks level 2
    chose. ``m`` is the true (unpadded) edge count."""
    n = parent1.shape[0]
    fa = parent1[ra[:m]]
    fb = parent1[rb[:m]]
    cross = np.nonzero(fa != fb)[0]
    arr = np.empty(2 * cross.size, dtype=np.int64)
    arr[0::2] = fa[cross]
    arr[1::2] = fb[cross]
    frags, first_pos = np.unique(arr, return_index=True)
    moe2 = np.full(n, INT32_MAX, dtype=np.int32)
    moe2[frags] = cross[first_pos // 2].astype(np.int32)
    has = moe2 < INT32_MAX
    safe = np.where(has, moe2, 0)
    wa = parent1[ra[safe]]
    wb = parent1[rb[safe]]
    ids = np.arange(n, dtype=np.int32)
    parent = np.where(has, np.where(wa == ids, wb, wa), ids).astype(np.int32)
    parent = _host_break_and_jump(parent, "host_level2")
    return parent[parent1], np.unique(moe2[has])


def _pad_l2_ranks(l2r: np.ndarray, m_pad: int) -> np.ndarray:
    """The level-2 ranks padded for staging with ``m_pad``, above every real
    rank, which every consumer drops; at least 1,024 entries."""
    l2_pad = _bucket_size(max(int(l2r.size), 1024))
    out = np.full(l2_pad, m_pad, dtype=np.int32)
    out[: l2r.size] = l2r
    return out


def _device_level1(vmin0, ra, rb):
    """Level 1 on the device, for callers that stage no host ``parent1``."""
    _fragment, parent1, _has1, _safe1 = _level1_hook(vmin0, ra, rb)
    return parent1


def _ensure_parent1(vmin0, ra, rb, parent1):
    if parent1 is None:
        return _device_level1(vmin0, ra, rb)
    return parent1


def _prefix_level2_core(fragment, fa, fb):
    """Level 2 over relabeled slots (slot index = rank). Returns
    ``(fragment, fa, fb, has2, safe2, count)``, ``count`` a 0-d tensor."""
    slot = _iota(fa.shape[0], fa.device)
    key2 = torch.where(fa != fb, slot, INT32_MAX)
    fragment, parent2, has2, safe2 = _level_core(fragment, fa, fb, key2, fragment.shape[0])
    fa = parent2[fa]
    fb = parent2[fb]
    return fragment, fa, fb, has2, safe2, (fa != fb).sum()


def _level_core(fragment, fa, fb, key_of_slot, n: int):
    """MOE and hook for one level; returns ``(fragment2, parent, has, safe)``."""
    ids = _iota(n, fragment.device)
    moe = _moe_over(fa, fb, key_of_slot, n)
    has = moe < INT32_MAX
    safe = torch.where(has, moe, 0)
    wa = fa[safe]
    wb = fb[safe]
    dst_frag = torch.where(has, torch.where(wa == ids, wb, wa), ids)
    fragment2, parent = hook_and_compress(has, dst_frag, fragment)
    return fragment2, parent, has, safe


def _rank_head(vmin0, ra, rb, parent1, *, compact_after: int = 2):
    """Levels 1 (from the level-1 partition ``parent1``) and, with
    ``compact_after >= 2``, 2 at full width. Returns ``(fragment, mst, fa,
    fb, (levels, alive_count))``."""
    mp = ra.shape[0]
    has1 = vmin0 < INT32_MAX
    safe1 = torch.where(has1, vmin0, 0)
    # The relabel of the rank endpoints: two m-sized gathers.
    fa = parent1[ra]
    fb = parent1[rb]
    mst = torch.zeros(mp, dtype=torch.uint8, device=ra.device)
    _mark(mst, has1, safe1)
    if compact_after >= 2:
        fragment, fa, fb, has2, safe2, count = _prefix_level2_core(parent1, fa, fb)
        _mark(mst, has2, safe2)
        any2, count = _ints(has2.any(), count)
        lv = 1 + any2
    else:
        fragment = parent1
        lv, count = _ints(has1.any(), (fa != fb).sum())
    return fragment, mst, fa, fb, (lv, count)


def _compact_slots(fa, fb, rank_of_slot, out_size: int):
    """Order-preserving compaction of the alive slots into ``out_size``
    slots (the slot index stays a valid tie-break order; ``crank`` carries
    each slot's rank). Pad slots come out with ``cfa == cfb == 0``. Dead
    slots, and alive ones past ``out_size``, scatter to one spare slot past
    the end, which is cut off: JAX drops them (``mode="drop"``), CUDA
    indexing would assert. Returns ``(cfa, cfb, crank, valid)``."""
    alive = fa != fb
    pos = torch.cumsum(alive, 0, dtype=torch.int32) - 1
    idx = torch.where(alive & (pos < out_size), pos, out_size)
    cpos = torch.zeros(out_size + 1, dtype=torch.int32, device=fa.device)
    cpos[idx] = _iota(fa.shape[0], fa.device)
    cpos = cpos[:out_size]
    valid = _iota(out_size, fa.device) < alive.sum()
    cfa = torch.where(valid, fa[cpos], 0)
    cfb = torch.where(valid, fb[cpos], 0)
    return cfa, cfb, rank_of_slot[cpos], valid


def _finish_chunk(fragment, mst, fa, fb, rank_of_slot, *, out_size: int, chunk_levels: int = 3):
    """Compact the surviving slots to ``out_size`` and run up to
    ``chunk_levels`` more levels. Updates ``mst`` in place. Returns
    ``(fragment, mst, cfa, cfb, crank, (levels_run, alive_count))``."""
    cfa, cfb, crank, _valid = _compact_slots(fa, fb, rank_of_slot, out_size)
    fragment, mst, cfa, cfb, stats = _levels_loop(
        fragment, mst, cfa, cfb, crank, chunk_levels=chunk_levels
    )
    return fragment, mst, cfa, cfb, crank, stats


# ---------------------------------------------------------------------------
# Compact fragment space. Once few fragments still merge, a level over the
# whole vertex space costs O(n) in its segment minimum and hook. A census
# numbers the live roots densely; the next levels run in that F-sized space,
# and the vertex labels come back in one pass at the end.
# ---------------------------------------------------------------------------


def _compact_and_mark(fa, fb, rank_of_slot, *, n: int, out_size: int):
    """Slot compaction plus the live-root census: marks every root on an
    alive slot and numbers the marked roots densely (``newid``, int32).
    Returns ``(cfa_o, cfb_o, crank, mark, newid, (live_roots, alive))``
    with the endpoints still in the old root space."""
    cfa_o, cfb_o, crank, valid = _compact_slots(fa, fb, rank_of_slot, out_size)
    mark = torch.zeros(n + 1, dtype=torch.bool, device=fa.device)  # + a spare slot
    mark[torch.where(valid, cfa_o, n)] = True
    mark[torch.where(valid, cfb_o, n)] = True
    mark = mark[:n]
    cums = torch.cumsum(mark, 0, dtype=torch.int32)
    stats = tuple(_ints(cums[-1], valid.sum()))
    return cfa_o, cfb_o, crank, mark, cums - 1, stats


def _shrink_and_run(mark, newid, rep_prev, mst, cfa_o, cfb_o, crank, *, f_size: int,
                    chunk_levels: int):
    """Relabel the alive slots into the dense root space and run up to
    ``chunk_levels`` levels there. ``rep[f]`` is the original root id of
    compact id ``f``, composed through ``rep_prev``. Returns ``(rep, cfrag,
    mst, cfa, cfb, (levels_run, alive_count))``."""
    dev = mark.device
    back = torch.zeros(f_size + 1, dtype=torch.int32, device=dev)  # + a spare slot
    back[torch.where(mark, newid, f_size)] = _iota(mark.shape[0], dev)
    rep = rep_prev[back[:f_size]]
    cfa = newid[cfa_o]
    cfb = newid[cfb_o]
    # Pad slots (cfa_o == cfb_o == 0) read newid[0], which is -1 when root 0
    # is unmarked. JAX's next gather wraps -1 to the last id; taking it here
    # keeps the segment minimum's ids in range and the pads inert and equal.
    cfa = torch.where(cfa < 0, f_size - 1, cfa)
    cfb = torch.where(cfb < 0, f_size - 1, cfb)
    cfrag, mst, cfa, cfb, stats = _levels_loop(
        _iota(f_size, dev), mst, cfa, cfb, crank, chunk_levels=chunk_levels
    )
    return rep, cfrag, mst, cfa, cfb, stats


def _levels_loop(fragment, mst, cfa, cfb, crank, *, chunk_levels: int):
    """Up to ``chunk_levels`` levels over compacted slots (also JAX's
    ``_run_levels``, which jits this loop alone), stopping after
    the first level that finds no MOE, as JAX's ``while_loop`` does; that
    level counts. One host sync a level reads (any alive, any MOE, alive
    count). With no slot alive JAX runs no level; the first level here then
    changed nothing and is not counted. Returns ``(fragment, mst, cfa, cfb,
    (levels_run, alive_count))``."""
    n = fragment.shape[0]
    cslot = _iota(cfa.shape[0], cfa.device)
    k = 0
    count = None
    while k < chunk_levels:
        alive = cfa != cfb
        key = torch.where(alive, cslot, INT32_MAX)
        fragment, parent, has, safe = _level_core(fragment, cfa, cfb, key, n)
        _mark(mst, has, crank[safe])
        cfa = parent[cfa]
        cfb = parent[cfb]
        any_alive, any_has, count = _ints(alive.any(), has.any(), (cfa != cfb).sum())
        if k == 0 and not any_alive:
            break
        k += 1
        if not any_has:
            break
    if count is None:
        count = int((cfa != cfb).sum())
    return fragment, mst, cfa, cfb, (k, count)


def _replay_stages(fragment, stages):
    """The final vertex relabel after a shrink chain.

    ``stages`` holds one ``(mark_k, newid_k, rep_k, cfrag_k)`` a shrink, in
    order: the census over the previous space, the compact -> original map,
    and the compact fragment state as of the next shrink (or the end). The
    walk runs in the first compact space, then one n-sized expansion; a
    root that dies at stage k keeps the original label it had there.
    """
    if not stages:
        return fragment
    mark1, newid1, rep1, cfrag1 = stages[0]
    cur = cfrag1
    res = rep1[cur]
    alive = torch.ones(cur.shape[0], dtype=torch.bool, device=cur.device)
    for mark_k, newid_k, rep_k, cfrag_k in stages[1:]:
        # A dead entry keeps an id of an older, larger space, which may lie
        # past this stage's arrays (JAX clamps such a gather): read id 0
        # there instead, since ``live`` is False for it either way.
        at = torch.where(alive, cur, 0)
        live = alive & mark_k[at]
        j = cfrag_k[torch.where(live, newid_k[at], 0)]
        res = torch.where(live, rep_k[j], res)
        cur = torch.where(live, j, cur)
        alive = live
    live1 = mark1[fragment]
    return torch.where(live1, res[torch.where(live1, newid1[fragment], 0)], fragment)


# Every device index (ranks, vertex ids, compact slot ids) is int32, and
# INT32_MAX is the "no edge" sentinel, so padded sizes stay below 2^31.
_INT32_RANK_LIMIT = 1 << 31


def check_rank_envelope(n_pad: int, m_pad: int) -> None:
    """Raise at staging, naming the limit, instead of deep in the level loop
    with an overflowed index."""
    if m_pad >= _INT32_RANK_LIMIT or n_pad >= _INT32_RANK_LIMIT:
        raise ValueError(
            f"graph exceeds the int32 rank envelope: padded sizes "
            f"(nodes {n_pad:,}, ranks {m_pad:,}) must stay below 2^31 = "
            f"{_INT32_RANK_LIMIT:,}; the port has no int64-key path"
        )


# ---------------------------------------------------------------------------
# Staging: host passes and host -> device copies.
# ---------------------------------------------------------------------------

# Cache staged arrays on the graph only up to this many padded ranks.
_STAGE_CACHE_MAX_RANKS = 1 << 26


def _device_key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cache_get(graph: Graph, kind: str, device):
    return graph.__dict__.get("_rank_stage_cache", {}).get((kind, _device_key(device)))


def _cache_put(graph: Graph, kind: str, device, staged, m_pad: int) -> None:
    """Keep ``staged`` on the graph, keyed by kind and device. ``Graph`` is
    a frozen dataclass: the cache goes into ``__dict__``, as a
    ``cached_property`` does."""
    if m_pad <= _STAGE_CACHE_MAX_RANKS:
        graph.__dict__.setdefault("_rank_stage_cache", {})[(kind, _device_key(device))] = staged


def _stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int32 copy of ``a`` on ``device``. To the card it goes from pinned
    memory with ``non_blocking=True``: the call returns once the copy is
    queued, and host work after it overlaps the transfer."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prep_head(graph: Graph, device: torch.device):
    """The shared head of the preps: the rank endpoints, their copies
    issued first, then ``vmin0`` and the level-1 partition computed on the
    host under the copies. Returns ``(m, m_pad, ra, rb, vmin0, parent1, sa,
    sb)``: host arrays and the staged (in-flight) endpoints."""
    n = graph.num_nodes
    m = graph.num_edges
    n_pad = _bucket_size(n)
    m_pad = _bucket_size(m)
    check_rank_envelope(n_pad, m_pad)
    ra, rb = graph.rank_endpoints(pad_to=m_pad)
    sa, sb = _stage(ra, device), _stage(rb, device)
    # --- everything below overlaps the endpoint copies ---
    vmin0 = np.full(n_pad, INT32_MAX, dtype=np.int32)
    vmin0[:n] = graph.first_ranks
    parent1 = host_level1(vmin0, ra, rb)
    return m, m_pad, ra, rb, vmin0, parent1, sa, sb


def prepare_rank_arrays_full(graph: Graph, *, device=None):
    """Host passes and staging: ``(vmin0, ra, rb, parent1)`` int32 tensors
    on ``device`` (``None`` = CUDA), padded to ``_bucket_size`` steps, with
    the level-1 partition from the host. Returns once the copies are done,
    so a caller's prep clock includes them. Cached on the graph per
    device."""
    device = resolve_device(device)
    cached = _cache_get(graph, "full", device)
    if cached is not None:
        return cached
    _, m_pad, _, _, vmin0, parent1, sa, sb = _prep_head(graph, device)
    staged = (_stage(vmin0, device), sa, sb, _stage(parent1, device))
    _sync(device)
    _cache_put(graph, "full", device, staged, m_pad)
    return staged


def prepare_rank_arrays(graph: Graph, *, device=None):
    """``(vmin0, ra, rb)`` of :func:`prepare_rank_arrays_full`."""
    return prepare_rank_arrays_full(graph, device=device)[:3]


def prepare_rank_arrays_l2(graph: Graph, *, device=None):
    """:func:`prepare_rank_arrays_full` with level 2 on the host as well
    (the grid and sparse families): ``(vmin0, ra, rb, parent12, l2_ranks)``
    on ``device``. ``l2_ranks`` is padded with ``m_pad``, which the head
    drops, so an empty level 2 stays right."""
    device = resolve_device(device)
    cached = _cache_get(graph, "l2", device)
    if cached is not None:
        return cached
    m, m_pad, ra, rb, vmin0, parent1, sa, sb = _prep_head(graph, device)
    parent12, l2r = host_level2(parent1, ra, rb, m)
    staged = (_stage(vmin0, device), sa, sb, _stage(parent12, device),
              _stage(_pad_l2_ranks(l2r, m_pad), device))
    _sync(device)
    _cache_put(graph, "l2", device, staged, m_pad)
    return staged


# ---------------------------------------------------------------------------
# Routing policy.
# ---------------------------------------------------------------------------


def _pick_family(graph: Graph) -> str:
    """``"sparse"`` (average degree <= 3: paths, trees, road networks):
    level 1 retires most edges; ``"grid"`` (3 < degree <= 8: grids and
    meshes): level 2 at full width pays, survivors stay many; ``"dense"``
    (above 8: RMAT, dense random graphs): level 2 retires most edges, and
    the finish can be speculated in one chunk."""
    avg_degree = 2.0 * graph.num_edges / max(graph.num_nodes, 1)
    if avg_degree <= 3.0:
        return "sparse"
    return "grid" if avg_degree <= 8.0 else "dense"


def _family_params(family: str) -> dict:
    """The staged solver's knobs for a :func:`_pick_family` choice."""
    return dict(
        compact_after=1 if family == "sparse" else 2,
        chunk_levels=3 if family == "dense" else 2,
        compact_space=True if family != "dense" else None,
    )


# Below this fragment-space size a shrink buys nothing; also the floor of a
# shrunk space (a quarter of it).
_SHRINK_MIN_SPACE = 1 << 15

# Vertex-space size from which dense graphs take the census finish, and
# below which they try the speculative one.
_CENSUS_MIN_SPACE = 1 << 21

# Compacted widths at or below this run all remaining levels in one chunk.
_ONE_SHOT_MAX_SLOTS = 1 << 22

# Dense graphs at or above this rank width take the filter-Kruskal route.
_FILTER_MIN_RANKS = 1 << 23

_FILTERED_NOT_PORTED = (
    "the filter-Kruskal route (dense graphs at {} >= 2^23 padded ranks) is not "
    "ported yet (ROADMAP queue 1 item 5, step 6)"
)


def use_filtered_path(family: str, num_ranks: int) -> bool:
    """Whether a graph takes the filter-Kruskal route."""
    return family == "dense" and num_ranks >= _FILTER_MIN_RANKS


def use_l2_path(family: str) -> bool:
    """Whether a graph takes the host-L2 route (level 3 is the card's
    first)."""
    return family in ("grid", "sparse")


# ---------------------------------------------------------------------------
# Solvers.
# ---------------------------------------------------------------------------


def _relabel_slots(fragment, ra, rb):
    """Resume: the slot endpoints of a restored vertex partition."""
    fa = fragment[ra]
    fb = fragment[rb]
    return fa, fb, int((fa != fb).sum())


def _restore_state_host(initial_state, n_pad: int, m_pad: int):
    """Checkpoint state -> host ``(fragment, mask, level)`` at the current
    padded sizes. A state written under other padding is cut or extended:
    pad vertices never hook and pad ranks are never marked, so a longer
    stored tail is the identity / False and a shorter one is extended with
    the identity."""
    fragment = np.asarray(initial_state[0], dtype=np.int32)
    if fragment.shape[0] < n_pad:
        fragment = np.concatenate(
            [fragment, np.arange(fragment.shape[0], n_pad, dtype=np.int32)]
        )
    elif fragment.shape[0] > n_pad:
        fragment = fragment[:n_pad]
    mask = np.asarray(initial_state[1], dtype=bool)
    if mask.shape[0] != m_pad:
        fixed = np.zeros(m_pad, dtype=bool)
        fixed[: min(mask.shape[0], m_pad)] = mask[:m_pad]
        mask = fixed
    return fragment, mask, int(initial_state[2])


def _restore_state(initial_state, n_pad: int, m_pad: int, device):
    """Tensor form of :func:`_restore_state_host`: int32 fragment, uint8
    mask."""
    fragment, mask, lv = _restore_state_host(initial_state, n_pad, m_pad)
    return (torch.tensor(fragment, dtype=torch.int32, device=device),
            torch.tensor(mask, dtype=torch.uint8, device=device), lv)


def solve_rank_speculative(vmin0, ra, rb, *, out_size: int, parent1=None):
    """The dense fast path: the head, then one finish chunk at a predicted
    survivor width ``out_size`` that runs every level left. Returns
    ``(mst, fragment, levels)``, or ``None`` when the prediction was too
    small or the chunk did not converge (the caller then runs the staged
    solve). When accepted the result equals the staged solve's."""
    n_pad = vmin0.shape[0]
    parent1 = _ensure_parent1(vmin0, ra, rb, parent1)
    fragment, mst, fa, fb, (lv, count) = _rank_head(vmin0, ra, rb, parent1, compact_after=2)
    if count > out_size:
        return None  # the compaction would drop survivors
    fragment, mst, _, _, _, (extra, count2) = _finish_chunk(
        fragment, mst, fa, fb, _iota(ra.shape[0], ra.device),
        out_size=out_size, chunk_levels=_max_levels(n_pad),
    )
    if count2 == 0:
        return mst, fragment, lv + extra
    return None


def _head_l2(vmin0, ra, rb, parent12, l2_ranks):
    """Level-3 entry from the host's two-level partition: one relabel and
    the level-1 and level-2 marks, no segment minimum. Returns ``(mst, fa,
    fb, (levels, alive_count))``. The pads of ``l2_ranks`` (``m_pad``) are
    dropped as JAX drops them: they mark rank 0 with 0, which changes
    nothing."""
    mp = ra.shape[0]
    fa = parent12[ra]
    fb = parent12[rb]
    has1 = vmin0 < INT32_MAX
    mst = torch.zeros(mp, dtype=torch.uint8, device=ra.device)
    _mark(mst, has1, vmin0)
    has2 = l2_ranks < mp
    _mark(mst, has2, l2_ranks)
    lv1, lv2, count = _ints(has1.any(), has2.any(), (fa != fb).sum())
    return mst, fa, fb, (lv1 + lv2, count)


def solve_rank_l2(vmin0, ra, rb, parent12, l2_ranks, *, chunk_levels: int = 2,
                  compact_space: bool = True, on_chunk=None):
    """Solve from the host's two-level partition
    (:func:`prepare_rank_arrays_l2`): equal to :func:`solve_rank_staged`,
    without the full-width level 2 on the card. ``on_chunk`` as there."""
    n_pad = vmin0.shape[0]
    mst, fa, fb, (lv, count) = _head_l2(vmin0, ra, rb, parent12, l2_ranks)
    if on_chunk is not None:
        on_chunk(lv, parent12, mst, count)
    return _finish_to_fixpoint(
        parent12, mst, fa, fb, _iota(ra.shape[0], ra.device),
        lv=lv, count=count, space=n_pad, max_levels=lv + _max_levels(n_pad),
        chunk_levels=chunk_levels, compact_space=compact_space, on_chunk=on_chunk,
    )


def solve_rank_staged(
    vmin0,
    ra,
    rb,
    *,
    compact_after: int = 2,
    chunk_levels: int = 3,
    compact_space: bool | None = None,
    initial_state: tuple | None = None,
    on_chunk=None,
    parent1=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The staged solve: the head (levels 1 and 2 at full width, or level 1
    with ``compact_after=1``), then finish chunks of ``chunk_levels`` levels,
    each compacted to the exact survivor count. With ``compact_space``
    (default: on for ``compact_after <= 1`` and for ``n_pad >=
    _CENSUS_MIN_SPACE``) each chunk boundary may census and shrink the
    fragment space. Returns ``(mst_rank_mask, fragment, levels)``.

    ``initial_state`` is ``(fragment, mst_rank_mask, level)`` from a
    checkpoint, as NumPy arrays (a JAX solve's ``on_chunk`` state carries
    across so): the head is skipped and the slots are rebuilt from the
    restored partition. ``on_chunk(level,
    vertex_fragment, mst, count)`` fires after the head and after each
    chunk; the solve goes on updating ``mst`` in place, so a hook that keeps
    it past the call copies it.
    """
    n_pad = vmin0.shape[0]
    if initial_state is not None:
        fragment, mst, lv = _restore_state(initial_state, n_pad, ra.shape[0], ra.device)
        fa, fb, count = _relabel_slots(fragment, ra, rb)
    else:
        parent1 = _ensure_parent1(vmin0, ra, rb, parent1)
        fragment, mst, fa, fb, (lv, count) = _rank_head(
            vmin0, ra, rb, parent1, compact_after=compact_after
        )
    if compact_space is None:
        compact_space = compact_after <= 1 or n_pad >= _CENSUS_MIN_SPACE
    if on_chunk is not None and initial_state is None:
        on_chunk(lv, fragment, mst, count)
    # The level budget is relative to the entry level, so a resume past
    # _max_levels(n_pad) still runs.
    return _finish_to_fixpoint(
        fragment, mst, fa, fb, _iota(ra.shape[0], ra.device),
        lv=lv, count=count, space=n_pad, max_levels=lv + _max_levels(n_pad),
        chunk_levels=chunk_levels, compact_space=compact_space, on_chunk=on_chunk,
    )


def _finish_to_fixpoint(
    fragment,
    mst,
    fa,
    fb,
    rank_of_slot,
    *,
    lv: int,
    count: int,
    space: int,
    max_levels: int,
    chunk_levels: int,
    compact_space: bool,
    on_chunk=None,
):
    """Run finish chunks to the fixpoint from any mid-solve state:
    ``fragment`` is the vertex partition (``space``-sized), ``fa/fb`` the
    alive-slot endpoints in it, ``rank_of_slot`` each slot's rank. Handles
    the slot compactions, the shrink chain and the final replay. Returns
    ``(mst, fragment, levels)`` with ``fragment`` in the vertex space."""
    frag_state = fragment  # the vertex partition until the first shrink, then compact
    vertex_fragment = fragment  # frozen at the first shrink, for the replay
    rep = None  # current space -> original root (None: the original space)
    stages = []  # (mark, newid, rep, cfrag_final) of each finished shrink
    pending = None  # (mark, newid, rep) of the last shrink, awaiting its cfrag
    census_failures = 0

    def current_vertex_fragment():
        if pending is None:
            return frag_state
        return _replay_stages(vertex_fragment, stages + [(*pending, frag_state)])

    while count > 0 and lv < max_levels:
        out_size = max(_bucket_size(count), _COMPACT_MIN_SLOTS)
        # At a small width, run every level left in one chunk: fragments
        # still merging are at most 2 * alive slots, so _max_levels(2 *
        # out_size) levels always converge. At large widths short chunks
        # reach the next compaction sooner.
        eff_levels = (
            _max_levels(2 * out_size) if out_size <= _ONE_SHOT_MAX_SLOTS else chunk_levels
        )
        if compact_space and space > _SHRINK_MIN_SPACE and census_failures < 2:
            cfa_o, cfb_o, crank, mark, newid, (f_count, _) = _compact_and_mark(
                fa, fb, rank_of_slot, n=space, out_size=out_size
            )
            f_size = max(_bucket_size(f_count), _SHRINK_MIN_SPACE // 4)
            if f_size <= space // 2:
                census_failures = 0
                rep_prev = rep if rep is not None else _iota(space, fa.device)
                if pending is not None:
                    stages.append((*pending, frag_state))
                else:
                    vertex_fragment = frag_state
                rep, frag_state, mst, fa, fb, (extra, count) = _shrink_and_run(
                    mark, newid, rep_prev, mst, cfa_o, cfb_o, crank,
                    f_size=f_size, chunk_levels=eff_levels,
                )
                pending = (mark, newid, rep)
                space = f_size
            else:
                census_failures += 1
                # Reuse the compacted slots; run the levels without a shrink.
                frag_state, mst, fa, fb, (extra, count) = _levels_loop(
                    frag_state, mst, cfa_o, cfb_o, crank, chunk_levels=eff_levels,
                )
            rank_of_slot = crank
        else:
            frag_state, mst, fa, fb, rank_of_slot, (extra, count) = _finish_chunk(
                frag_state, mst, fa, fb, rank_of_slot,
                out_size=out_size, chunk_levels=eff_levels,
            )
        lv += extra
        if on_chunk is not None:
            on_chunk(lv, current_vertex_fragment(), mst, count)
        if extra == 0:  # no progress possible
            break

    if pending is not None:
        stages.append((*pending, frag_state))
        return mst, _replay_stages(vertex_fragment, stages), lv
    return mst, frag_state, lv


def solve_rank_auto(vmin0, ra, rb, *, family: str = "dense", parent1=None):
    """The routing of a staged solve by family: dense graphs under the
    census size try the speculative finish (survivors predicted at m/8) and
    run the staged solve on a misprediction; every other graph runs the
    staged solve. The filter-Kruskal route raises: it is not ported yet."""
    if use_filtered_path(family, ra.shape[0]):
        raise NotImplementedError(_FILTERED_NOT_PORTED.format(ra.shape[0]))
    n_pad = vmin0.shape[0]
    parent1 = _ensure_parent1(vmin0, ra, rb, parent1)
    if family == "dense" and n_pad < _CENSUS_MIN_SPACE:
        out_size = max(_bucket_size(ra.shape[0] // 8), _COMPACT_MIN_SLOTS)
        result = solve_rank_speculative(vmin0, ra, rb, out_size=out_size, parent1=parent1)
        if result is not None:
            return result
    return solve_rank_staged(vmin0, ra, rb, **_family_params(family), parent1=parent1)


def make_production_solver(graph: Graph, *, device=None):
    """Stage the graph for its route (the host passes and copies run here,
    so a caller can time the prep apart) and return ``solve() -> (mst,
    fragment, levels)``. The one place the route is chosen: grid and sparse
    graphs take the host-L2 route (:func:`solve_rank_l2`); dense graphs at
    filter scale raise ``NotImplementedError`` (not ported yet), before any
    staging; every other graph takes :func:`solve_rank_auto`."""
    device = resolve_device(device)
    family = _pick_family(graph)
    if use_l2_path(family):
        staged = prepare_rank_arrays_l2(graph, device=device)
        return lambda: solve_rank_l2(*staged)
    if use_filtered_path(family, _bucket_size(graph.num_edges)):
        raise NotImplementedError(_FILTERED_NOT_PORTED.format(_bucket_size(graph.num_edges)))
    vmin0, ra, rb, parent1 = prepare_rank_arrays_full(graph, device=device)
    return lambda: solve_rank_auto(vmin0, ra, rb, family=family, parent1=parent1)


def solve_graph_rank(graph: Graph, *, device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host entry with ``models.boruvka.solve_graph``'s contract: ``(sorted
    edge ids, fragment[:n], levels)``."""
    device = resolve_device(device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0
    mst, fragment, levels = make_production_solver(graph, device=device)()
    return fetch_mst_edge_ids(graph, mst), fragment[:n].cpu().numpy(), int(levels)
