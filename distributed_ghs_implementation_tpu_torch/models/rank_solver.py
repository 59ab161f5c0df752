"""Rank-space Borůvka solver: the route ``solve_graph`` takes at 2^17 edges
and above.

Port of the JAX package's ``models/rank_solver.py``: the staged,
speculative and host-L2 routes, and for dense graphs at ``_FILTER_MIN_RANKS``
padded ranks and above the filter-Kruskal route.

* **Level 1 before the solve, level 2 in its head.** At the identity
  partition each vertex's minimum outgoing edge is its minimum-rank
  incident edge (its first rank). The one prep puts the rank endpoints on
  the card and runs the first ranks there (K6, ``kernels.first_rank``),
  then level 1 through K1. The raw edge arrays are copied to the card, and
  the rank order (K7, ``kernels.sort_rank_order``: 32-bit keys for integer
  weights within 2^22 values, 64-bit keys for wider integers and floats)
  and the endpoint gather run there. Each
  solve's head runs level 2 (:func:`_prefix_level2_core`): over the
  filter's prefix on the filter route, over every rank on the others.
  :func:`host_level1` is level 1 on the host, for the lanes and the
  sharded solver.
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

import contextlib
import contextvars
import time
from typing import Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs import native as native_lib
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    _COMPACT_MIN_SLOTS,
    _bucket_size,
    _mark,
    _max_levels,
    edge_ids_of_ranks,
    fetch_mst_edge_ids,  # noqa: F401 -- a name of the JAX module's, used by callers
    harvest,
    held_rank_order,
    hold_rank_order,
)
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import INT32_MAX, segment_min
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress

# Above this many slots the segment minimum runs over each direction in
# turn instead of over their concatenation, which would double the slot
# arrays' memory.
_MOE_TWO_PASS_SLOTS = 1 << 28


def _iota(size: int, device) -> torch.Tensor:
    return torch.arange(size, dtype=torch.int32, device=device)


def _ints(*scalars) -> list:
    """Small device tensors as Python ints: one host sync, counted by the
    ``solver.rank.host_reads`` counter (its total also sampled on the bus's
    timeline)."""
    out = torch.stack([s.long() for s in scalars]).tolist()
    BUS.count("solver.rank.host_reads")
    BUS.counter_sample("solver.rank.host_reads", cat="solver")
    return out


#: The ``solver.rank.solve`` span open in this context (None when the bus
#: is off), which the routing names the route that answered on.
_SOLVE_SPAN = contextvars.ContextVar("rank_solve_span", default=None)


def _note_route(route: str) -> None:
    """Name the route that answers on the open ``solver.rank.solve`` span:
    ``host-l2``, ``speculative``, ``staged``, ``staged after a
    misprediction``, ``filtered-speculative``, ``filtered`` or ``filtered
    after a misprediction``."""
    span = _SOLVE_SPAN.get()
    if span is not None:
        span.set(route=route)


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
    and pointer jumping, bounded: a hook forest whose only cycles are
    mutual pairs converges in ``ceil(log2 n) + 1`` jumps, so input that
    does not converge raises instead of hanging the host."""
    n = vmin0.shape[0]
    ids = np.arange(n, dtype=np.int32)
    has1 = vmin0 < np.iinfo(vmin0.dtype).max
    safe1 = np.where(has1, vmin0, 0)
    a = ra[safe1]
    b = rb[safe1]
    parent = np.where(has1, np.where(a == ids, b, a), ids).astype(np.int32)
    mutual = parent[parent] == ids
    parent = np.where(mutual & (ids < parent), ids, parent)
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)):
        p2 = parent[parent]
        if np.array_equal(p2, parent):
            return parent
        parent = p2
    raise ValueError(
        "host_level1 did not converge: hook input is not a true per-vertex/"
        "per-fragment minimum (hook graph has a cycle longer than 2)"
    )


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
    fb, (levels, alive_count))``; a level counts where it hooked some
    vertex, so a graph with no edge runs none (as the JAX package's
    host-L2 head counts them)."""
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
        any1, any2, count = _ints(has1.any(), has2.any(), count)
        lv = any1 + any2
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


def _cache_get(graph: Graph, device):
    return graph.__dict__.get("_rank_stage_cache", {}).get(_device_key(device))


def _cache_put(graph: Graph, device, staged, m_pad: int) -> None:
    """Keep ``staged`` on the graph, keyed by device. ``Graph`` is a frozen
    dataclass: the cache goes into ``__dict__``, as a ``cached_property``
    does."""
    if m_pad <= _STAGE_CACHE_MAX_RANKS:
        graph.__dict__.setdefault("_rank_stage_cache", {})[_device_key(device)] = staged


def _prep_step(name: str, **args):
    """A span of the rank route's prep on the bus: ``solver.prep`` or one
    of its steps, with the process's CPU seconds over it (``cpu_s``, every
    thread, the native passes' included). A no-op when the bus is off."""
    return BUS.span(name, cat="solver", cpu=True, **args)


def _stage(a: np.ndarray, device: torch.device, dtype=torch.int32) -> torch.Tensor:
    """A ``dtype`` copy of ``a`` on ``device``. To the card it goes from
    pinned memory with ``non_blocking=True``: one parallel pass fills the
    pinned buffer, narrowing where ``dtype`` is narrower than ``a``, and the
    call returns once the copy is queued, so host work after it overlaps the
    transfer. One ``solver.prep.stage`` span (``bytes``; ``pin_s``, the
    pinned buffer's allocation and fill), whose bytes go to the
    ``solver.stage.h2d_bytes`` counter, and the counter's total onto the
    timeline."""
    with _prep_step("solver.prep.stage") as span:
        src = torch.from_numpy(np.ascontiguousarray(a))
        pin_s = 0.0
        if device.type == "cuda":
            t0 = time.perf_counter()
            host = torch.empty(src.shape, dtype=dtype, pin_memory=True).copy_(src)
            pin_s = time.perf_counter() - t0
            out = host.to(device, non_blocking=True)
        else:
            host = out = src.to(dtype, copy=True)
        span.set(bytes=host.nbytes, pin_s=pin_s)
    BUS.count("solver.stage.h2d_bytes", host.nbytes)
    BUS.counter_sample("solver.stage.h2d_bytes", cat="solver")
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wait_copies(device: torch.device) -> None:
    """The end of a prep: wait for its copies (``solver.prep.copy_wait``)."""
    with _prep_step("solver.prep.copy_wait"):
        _sync(device)


def decode_planes24(planes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 24-bit wire buffer (six byte planes in one flat uint8 tensor:
    bytes 0-2 of ``ra``, then bytes 0-2 of ``rb``) back to the int32 pair,
    on the buffer's device. JAX's ``_decode_planes24``, an XLA program
    there, as torch ops here."""
    w = planes.shape[0] // 6
    p = [planes[i * w:(i + 1) * w].to(torch.int32) for i in range(6)]
    return p[0] | (p[1] << 8) | (p[2] << 16), p[3] | (p[4] << 8) | (p[5] << 16)


def pack_planes24(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """The 24-bit wire buffer of a host int32 pair whose values are below
    2^24: JAX's byte-plane loop over the little-endian bytes. The graph's
    own endpoints come packed from the native pass instead
    (``native.rank_endpoints_i32_planes``)."""
    if ra.dtype != np.int32 or rb.dtype != np.int32 or ra.shape != rb.shape:
        raise ValueError("pack_planes24 needs two int32 arrays of one length")
    w = ra.shape[0]
    planes = np.empty(6 * w, dtype=np.uint8)
    for arr, base in ((ra, 0), (rb, 3 * w)):
        bytes_ = np.ascontiguousarray(arr).view(np.uint8)
        for k in range(3):
            planes[base + k * w:base + (k + 1) * w] = bytes_[k::4]
    return planes


def _stage_planes24(planes: np.ndarray, device: torch.device):
    """One copy of the wire buffer (from pinned memory to the card, issued
    without waiting), then its decode there."""
    return decode_planes24(_stage(planes, device, torch.uint8))


def stage_pair_packed24(ra: np.ndarray, rb: np.ndarray, device=None):
    """A host int32 pair (values below 2^24) on ``device`` (``None`` =
    CUDA) over the 24-bit wire: three bytes an element cross the link, one
    buffer, decoded on the device (JAX ``_stage_pair_packed24``). Returns
    the int32 pair."""
    return _stage_planes24(pack_planes24(ra, rb), resolve_device(device))


@contextlib.contextmanager
def _device_step(name: str, device: torch.device, **args):
    """A prep step that runs on the device: its ``solver.prep.*`` span
    (``on="device"``, and ``args``), yielded, closes once the device has
    finished the step and everything queued before it, so that its time is
    the device's."""
    with _prep_step(name, on="device", **args) as span:
        yield span
        _sync(device)


def _stage_edges(graph: Graph, device: torch.device):
    """``w`` as it is (float64 for float weights, int64 for integers) and
    ``u``, ``v`` narrowed to int32 as they fill their pinned buffers, copied
    to ``device``, each copy issued without waiting; ``w`` first, since the
    sort needs only it."""
    wtype = torch.float64 if graph.w.dtype.kind == "f" else torch.int64
    return (_stage(graph.w, device, wtype), _stage(graph.u, device), _stage(graph.v, device))


def _rank_endpoints(graph: Graph, m_pad: int, device: torch.device):
    """The rank order and the rank endpoints on the device, from the raw
    edge arrays (:func:`_stage_edges`): ``(ra, rb)`` int32 on ``device``,
    padded with zeros to ``m_pad``. After the copies
    (``solver.prep.copy_wait``), the span ``solver.prep.rank_order``
    (``where="device"``; ``key``, the key K7 sorted, and ``passes``, its
    digit passes) holds K7 (``kernels.sort_rank_order``), after, for integer
    weights, their device minimum and maximum, one host read, which picks
    the 32-bit key where they span at most ``kernels.RANK_ORDER_MAX_RANGE``
    values, and the counter ``kernels.rank_order.passes`` grows by the
    passes (its total sampled on the bus's timeline);
    ``solver.prep.endpoints`` holds the gather (``kernels.rank_endpoints``). The order stays on the graph for the
    harvest (``boruvka.hold_rank_order``), for as long as the stage cache
    would keep the prep (up to ``_STAGE_CACHE_MAX_RANKS`` padded ranks),
    else until the first harvest reads it; the staged edges are freed, and
    the graph's host ``_rank_order`` is left unfilled."""
    w, u, v = _stage_edges(graph, device)
    _wait_copies(device)
    with _device_step("solver.prep.rank_order", device, where="device") as span:
        wlow = whigh = None
        if w.dtype == torch.int64 and graph.num_edges:
            wlow, whigh = torch.stack(torch.aminmax(w)).tolist()
        sort = kernels.sort_rank_order(w, wlow, whigh)
        span.set(key=sort.key, passes=sort.passes)
    BUS.count("kernels.rank_order.passes", sort.passes)
    BUS.counter_sample("kernels.rank_order.passes", cat="kernels")
    del w
    with _device_step("solver.prep.endpoints", device):
        ra, rb = kernels.rank_endpoints(sort.order, u, v, m_pad)
    hold_rank_order(graph, sort.order, keep=m_pad <= _STAGE_CACHE_MAX_RANKS)
    return ra, rb


def _prep_head(graph: Graph, device: torch.device):
    """The prep's steps: the rank endpoints on ``device``
    (:func:`_rank_endpoints`: the rank order and the endpoint gather, on
    the device), then on the device the first ranks
    (K6) and the level-1 partition, each a :func:`_device_step`
    (``solver.prep.first_ranks``, ``.level1``), equal element for element
    to the host's first ranks and :func:`host_level1`. Returns ``(m_pad,
    vmin0, ra, rb, parent1)`` on ``device``. The graph's ``first_ranks`` and
    its host rank order are left unfilled."""
    n_pad = _bucket_size(graph.num_nodes)
    m_pad = _bucket_size(graph.num_edges)
    check_rank_envelope(n_pad, m_pad)
    ra, rb = _rank_endpoints(graph, m_pad, device)
    with _device_step("solver.prep.first_ranks", device):
        vmin0 = kernels.first_rank(ra, rb, graph.num_edges, n_pad)
    with _device_step("solver.prep.level1", device):
        parent1 = _device_level1(vmin0, ra, rb)
    return m_pad, vmin0, ra, rb, parent1


def prepare_rank_arrays_full(graph: Graph, *, device=None):
    """The rank route's one prep: the rank endpoints staged and the first
    ranks and level 1 computed from them (:func:`_prep_head`): ``(vmin0,
    ra, rb, parent1)`` int32 tensors on ``device`` (``None`` = CUDA),
    padded to ``_bucket_size`` steps. Returns once the copies are done, so
    a caller's prep clock includes them. Cached on the graph per device."""
    device = resolve_device(device)
    cached = _cache_get(graph, device)
    if cached is not None:
        return cached
    m_pad, vmin0, ra, rb, parent1 = _prep_head(graph, device)
    staged = (vmin0, ra, rb, parent1)
    _wait_copies(device)
    _cache_put(graph, device, staged, m_pad)
    return staged


def prepare_rank_arrays(graph: Graph, *, device=None):
    """``(vmin0, ra, rb)`` of :func:`prepare_rank_arrays_full`."""
    return prepare_rank_arrays_full(graph, device=device)[:3]


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


def use_filtered_path(family: str, num_ranks: int) -> bool:
    """Whether a graph takes the filter-Kruskal route."""
    return family == "dense" and num_ranks >= _FILTER_MIN_RANKS


def use_l2_path(family: str) -> bool:
    """Whether a graph takes the host-L2 route: the staged solve with level
    2 at full width in its head, two levels a finish chunk and the census,
    whatever its family's own knobs."""
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
    with BUS.span("solver.rank.head", cat="solver"):
        fragment, mst, fa, fb, (lv, count) = _rank_head(vmin0, ra, rb, parent1, compact_after=2)
    if count > out_size:
        return None  # the compaction would drop survivors
    with BUS.span("solver.rank.finish", cat="solver", phase="staged", step="_finish_chunk"):
        fragment, mst, _, _, _, (extra, count2) = _finish_chunk(
            fragment, mst, fa, fb, _iota(ra.shape[0], ra.device),
            out_size=out_size, chunk_levels=_max_levels(n_pad),
        )
    if count2 == 0:
        return mst, fragment, lv + extra
    return None


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
        with BUS.span("solver.rank.head", cat="solver"):
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
    phase: str = "staged",
):
    """Run finish chunks to the fixpoint from any mid-solve state:
    ``fragment`` is the vertex partition (``space``-sized), ``fa/fb`` the
    alive-slot endpoints in it, ``rank_of_slot`` each slot's rank. Handles
    the slot compactions, the shrink chain and the final replay. Returns
    ``(mst, fragment, levels)`` with ``fragment`` in the vertex space. Each
    chunk is a ``solver.rank.finish`` span (``phase``; ``step``, the step
    that ran its levels), which closes before ``on_chunk`` sees it; the
    final replay after a shrink chain is a ``solver.rank.replay`` span
    (``stages``, the shrinks replayed), which closes once the device has
    run it."""
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
        with BUS.span("solver.rank.finish", cat="solver", phase=phase) as chunk:
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
                    chunk.set(step="_shrink_and_run")
                else:
                    census_failures += 1
                    # Reuse the compacted slots; run the levels without a shrink.
                    frag_state, mst, fa, fb, (extra, count) = _levels_loop(
                        frag_state, mst, cfa_o, cfb_o, crank, chunk_levels=eff_levels,
                    )
                    chunk.set(step="_levels_loop")
                rank_of_slot = crank
            else:
                frag_state, mst, fa, fb, rank_of_slot, (extra, count) = _finish_chunk(
                    frag_state, mst, fa, fb, rank_of_slot,
                    out_size=out_size, chunk_levels=eff_levels,
                )
                chunk.set(step="_finish_chunk")
        lv += extra
        if on_chunk is not None:
            on_chunk(lv, current_vertex_fragment(), mst, count)
        if extra == 0:  # no progress possible
            break

    if pending is not None:
        stages.append((*pending, frag_state))
        with BUS.span("solver.rank.replay", cat="solver", stages=len(stages), on="device"):
            fragment = _replay_stages(vertex_fragment, stages)
            _sync(fragment.device)
        return mst, fragment, lv
    return mst, frag_state, lv


# ---------------------------------------------------------------------------
# The filter-Kruskal route (dense graphs at _FILTER_MIN_RANKS padded ranks and
# above). The rank order sorts the edges by weight, so the lightest ranks are
# a prefix of ra/rb. Levels 2 and up run over the prefix only; then one pass
# over the suffix drops every edge whose endpoints the prefix forest already
# joins, and the few survivors finish through the usual chunks. Level 1
# hooks on each vertex's global minimum (vmin0); a prefix level picks a
# fragment's global minimum whenever it has an outgoing prefix edge (every
# suffix rank is heavier) and stalls it otherwise; the filter drops only
# edges that close a cycle of forest edges. So the forest is the staged
# solve's, element for element.
# ---------------------------------------------------------------------------


def _filtered_head(vmin0, ra, rb, parent1, *, prefix: int):
    """The level-1 marks and level 2 over the prefix slots only. Returns
    ``(fragment, mst, fa, fb, (levels, alive_count))`` with ``mst``
    full-width, ``fa``/``fb`` prefix-width and the two stats 0-d tensors,
    not read yet."""
    mst = torch.zeros(ra.shape[0], dtype=torch.uint8, device=ra.device)
    _mark(mst, vmin0 < INT32_MAX, vmin0)
    fragment, fa, fb, has2, safe2, count = _prefix_level2_core(
        parent1, parent1[ra[:prefix]], parent1[rb[:prefix]]
    )
    _mark(mst, has2, safe2)
    return fragment, mst, fa, fb, (1 + has2.any().int(), count)


def _filter_suffix_ends(fragment, ra, rb, *, prefix: int):
    """The suffix endpoints relabeled to the current fragments, and the
    survivor count (0-d). Pad ranks (``ra == rb == 0``) are dead."""
    fa = fragment[ra[prefix:]]
    fb = fragment[rb[prefix:]]
    return fa, fb, (fa != fb).sum()


def _filter_compact(fa, fb, prefix: int, *, out_size: int):
    """Compact the filter survivors; slot ``i`` carries rank ``prefix + i``."""
    cfa, cfb, crank, _valid = _compact_slots(fa, fb, _iota(fa.shape[0], fa.device) + prefix,
                                             out_size)
    return cfa, cfb, crank


def _filter_suffix_fused(fragment, ra, rb, *, prefix: int, out_size: int):
    """The filter and its compaction with no suffix-width endpoint arrays:
    the ``j``-th survivor's position is a binary search for ``j + 1`` in the
    running count of alive suffix ranks, and the survivors' endpoints are
    gathered again at ``out_size``. Returns ``(cfa, cfb, crank, count)``,
    ``count`` 0-d; ``count > out_size`` means survivors were dropped, and
    the caller runs the two-step filter instead."""
    alive = fragment[ra[prefix:]] != fragment[rb[prefix:]]
    cum = torch.cumsum(alive, 0, dtype=torch.int32)
    count = cum[-1]
    j = _iota(out_size, ra.device)
    cpos = torch.searchsorted(cum, j + 1, side="left", out_int32=True)
    valid = j < count
    # Masked before the gather: a position with no survivor is len(cum),
    # which reads past the end of ra.
    crank = torch.where(valid, cpos + prefix, 0)
    cfa = torch.where(valid, fragment[ra[crank]], 0)
    cfb = torch.where(valid, fragment[rb[crank]], 0)
    return cfa, cfb, crank, count


def _filter_chunk_ends(fragment, ra, rb, start: int, *, width: int):
    """One chunk of the filter: ranks ``[start, start + width)`` relabeled,
    and its survivor count (0-d)."""
    fa = fragment[ra[start:start + width]]
    fb = fragment[rb[start:start + width]]
    return fa, fb, (fa != fb).sum()


# Suffix bytes (the relabeled endpoint pair, 8 bytes a rank) above which the
# filter runs in chunks: JAX's value, kept so that the prefix plan, and with
# it the level count, is JAX's.
_FILTER_CHUNK_BYTES = 1 << 32
# Ranks a chunk. JAX takes 2^26 for a 16 GB chip; the card has 80 GB, and
# 2^28 (2 GiB of relabeled endpoints a chunk) needs a quarter of the chunks,
# each a host read. The survivors are the same in any chunking.
_FILTER_CHUNK_RANKS = 1 << 28
# The filter's survivors are predicted at m_pad / 128 (JAX's measured share
# on RMAT is 0.21% of the suffix); more overflow the fused filter.
_FILTER_SURVIVOR_DIVISOR = 128


def _filter_width(m_pad: int) -> int:
    return max(_bucket_size(m_pad // _FILTER_SURVIVOR_DIVISOR), _COMPACT_MIN_SLOTS)


def _filter_suffix_chunked(fragment, ra, rb, prefix: int):
    """The filter over the suffix in rank-ordered chunks, each compacted in
    order, so the survivors come out in ascending rank, the tie-break order.
    Width-size temporaries only a chunk at a time. A chunk count that does
    not divide the suffix moves the last chunk back to end at ``m_pad`` and
    masks the ranks it reads again. Returns ``(cfa, cfb, crank, count)``,
    all ``None`` and 0 when nothing survives."""
    m_pad = ra.shape[0]
    suffix = m_pad - prefix
    n_chunks = max(1, -(-suffix // _FILTER_CHUNK_RANKS))
    width = -(-suffix // n_chunks)
    parts = []
    count = 0
    for k in range(n_chunks):
        start = prefix + k * width
        overlap = max(start + width - m_pad, 0)
        start -= overlap
        fa, fb, cnt = _filter_chunk_ends(fragment, ra, rb, start, width=width)
        if overlap:
            keep = _iota(width, ra.device) >= overlap
            fa = torch.where(keep, fa, 0)
            fb = torch.where(keep, fb, 0)
            cnt = (fa != fb).sum()
        cnt = int(cnt)
        if cnt:
            out_c = max(_bucket_size(cnt), _COMPACT_MIN_SLOTS)
            parts.append([t[:cnt] for t in _filter_compact(fa, fb, start, out_size=out_c)])
            count += cnt
        del fa, fb
    if not parts:
        return None, None, None, 0
    pad = torch.zeros(max(_bucket_size(count), _COMPACT_MIN_SLOTS) - count, dtype=torch.int32,
                      device=ra.device)
    return (*(torch.cat([p[i] for p in parts] + [pad]) for i in range(3)), count)


def _prefix_size(n_pad: int, m_pad: int, mult: int = 2) -> int:
    """The filter's split point: the lightest ``mult * n_pad`` ranks,
    bucketed."""
    return _bucket_size(min(mult * n_pad, m_pad))


def _prefix_plan(n_pad: int, m_pad: int) -> Tuple[int, bool]:
    """``(prefix, force_chunked)`` of the filtered solve: ``mult=1`` where
    the single-pass filter fits, ``mult=2`` where the filter runs in
    chunks."""
    suffix1 = m_pad - _prefix_size(n_pad, m_pad, 1)
    force_chunked = 8 * suffix1 > _FILTER_CHUNK_BYTES
    return _prefix_size(n_pad, m_pad, 2 if force_chunked else 1), force_chunked


def solve_rank_filtered(
    vmin0,
    ra,
    rb,
    *,
    chunk_levels: int = 3,
    prefix_mult: int | None = None,
    on_chunk=None,
    parent1=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The filter-Kruskal solve: the head (level 2 over the prefix) and
    finish over the prefix, one filter pass over the suffix (fused with its
    compaction; in chunks above ``_FILTER_CHUNK_BYTES``), the survivors'
    finish. Returns what :func:`solve_rank_staged` returns, element for
    element. ``on_chunk`` as in :func:`solve_rank_staged` (``count`` is
    the alive count of the current phase's slots)."""
    n_pad = vmin0.shape[0]
    m_pad = ra.shape[0]
    if prefix_mult is None:
        prefix, force_chunked = _prefix_plan(n_pad, m_pad)
    else:
        prefix, force_chunked = _prefix_size(n_pad, m_pad, prefix_mult), False
    if 2 * prefix > m_pad:  # too little suffix to split: the staged solve
        return solve_rank_staged(vmin0, ra, rb, chunk_levels=chunk_levels, on_chunk=on_chunk,
                                 parent1=parent1)
    with BUS.span("solver.rank.head", cat="solver"):
        fragment, mst, fa, fb, stats = _filtered_head(
            vmin0, ra, rb, _ensure_parent1(vmin0, ra, rb, parent1), prefix=prefix)
        lv, count = _ints(*stats)
    if on_chunk is not None:
        on_chunk(lv, fragment, mst, count)
    finish = dict(space=n_pad, chunk_levels=chunk_levels,
                  compact_space=n_pad >= _CENSUS_MIN_SPACE, on_chunk=on_chunk)
    mst, fragment, lv = _finish_to_fixpoint(
        fragment, mst, fa, fb, _iota(prefix, ra.device),
        lv=lv, count=count, max_levels=lv + _max_levels(n_pad), phase="prefix", **finish,
    )
    with BUS.span("solver.rank.filter", cat="solver") as span:
        if force_chunked or 8 * (m_pad - prefix) > _FILTER_CHUNK_BYTES:
            cfa, cfb, crank, count = _filter_suffix_chunked(fragment, ra, rb, prefix)
            span.set(steps=["_filter_suffix_chunked"])
        else:
            out_size = _filter_width(m_pad)
            cfa, cfb, crank, count = _filter_suffix_fused(fragment, ra, rb, prefix=prefix,
                                                          out_size=out_size)
            count = int(count)
            span.set(steps=["_filter_suffix_fused"])
            if count > out_size:  # overflow: the two-step filter at the true count
                fa_s, fb_s, count = _filter_suffix_ends(fragment, ra, rb, prefix=prefix)
                count = int(count)
                cfa, cfb, crank = _filter_compact(
                    fa_s, fb_s, prefix, out_size=max(_bucket_size(count), _COMPACT_MIN_SLOTS))
                del fa_s, fb_s
                span.set(steps=["_filter_suffix_fused", "_filter_suffix_ends",
                                "_filter_compact"])
    if count > 0:
        mst, fragment, lv = _finish_to_fixpoint(
            fragment, mst, cfa, cfb, crank,
            lv=lv, count=count, max_levels=lv + _max_levels(n_pad), phase="survivors",
            **finish,
        )
    return mst, fragment, lv


def _filtered_speculative_program(vmin0, ra, rb, parent1, *, prefix: int, prefix_out: int,
                                  out_size: int, max_levels: int):
    """The filtered solve at predicted widths, with no host read between
    its stages: the head, the prefix survivors compacted to ``prefix_out``
    and their levels to the fixpoint, the filter compacted to ``out_size``,
    the survivors' levels. Returns ``(fragment, mst, (levels,
    prefix_count, prefix_alive_end, filter_count, survivor_alive_end))``."""
    with BUS.span("solver.rank.head", cat="solver"):
        head = _filtered_head(vmin0, ra, rb, parent1, prefix=prefix)
    return _speculative_tail(*head, ra, rb, prefix=prefix, prefix_out=prefix_out,
                             out_size=out_size, max_levels=max_levels)


def _speculative_tail(fragment, mst, fa, fb, stats0, ra, rb, *, prefix: int, prefix_out: int,
                      out_size: int, max_levels: int):
    """The speculative programs after their head. The levels loops read
    their own counts a level; the head's and the filter's counts are read
    once, at the end."""
    # So on the card the head's span (the caller's) and the filter's close
    # once their work is queued: the next finish span's first read waits
    # for that work.
    with BUS.span("solver.rank.finish", cat="solver", phase="prefix", step="_levels_loop"):
        cfa, cfb, crank, _ = _compact_slots(fa, fb, _iota(prefix, ra.device), prefix_out)
        fragment, mst, _, _, (k1, prefix_alive) = _levels_loop(
            fragment, mst, cfa, cfb, crank, chunk_levels=max_levels)
    with BUS.span("solver.rank.filter", cat="solver",
                  steps=["_filter_suffix_ends", "_filter_compact"]):
        fa_s, fb_s, filter_count = _filter_suffix_ends(fragment, ra, rb, prefix=prefix)
        cfa, cfb, crank = _filter_compact(fa_s, fb_s, prefix, out_size=out_size)
        del fa_s, fb_s
    with BUS.span("solver.rank.finish", cat="solver", phase="survivors", step="_levels_loop"):
        fragment, mst, _, _, (k2, survivor_alive) = _levels_loop(
            fragment, mst, cfa, cfb, crank, chunk_levels=max_levels)
        lv0, prefix_count, filter_count = _ints(stats0[0], stats0[1], filter_count)
    return fragment, mst, (lv0 + k1 + k2, prefix_count, prefix_alive, filter_count,
                           survivor_alive)


def solve_rank_filtered_speculative(
    vmin0,
    ra,
    rb,
    *,
    prefix_mult: int = 2,
    prefix_out: int | None = None,
    out_size: int | None = None,
    parent1=None,
) -> Tuple[torch.Tensor, torch.Tensor, int] | None:
    """The filtered solve as one speculative program: ``(mst, fragment,
    levels)``, equal to :func:`solve_rank_filtered`'s, or ``None`` when a
    prediction missed (the caller then runs :func:`solve_rank_filtered`).
    Default widths: ``prefix / 8`` prefix survivors, ``m_pad / 128`` filter
    survivors."""
    n_pad = vmin0.shape[0]
    m_pad = ra.shape[0]
    prefix = _prefix_size(n_pad, m_pad, prefix_mult)
    if 2 * prefix > m_pad:
        return None
    if prefix_out is None:
        prefix_out = max(_bucket_size(prefix // 8), _COMPACT_MIN_SLOTS)
    if out_size is None:
        out_size = _filter_width(m_pad)
    widths = dict(prefix=prefix, prefix_out=prefix_out, out_size=out_size,
                  max_levels=_max_levels(n_pad))
    fragment, mst, stats = _filtered_speculative_program(
        vmin0, ra, rb, _ensure_parent1(vmin0, ra, rb, parent1), **widths)
    lv, prefix_count, prefix_alive, filter_count, survivor_alive = stats
    if (prefix_count <= prefix_out and filter_count <= out_size
            and prefix_alive == 0 and survivor_alive == 0):
        return mst, fragment, lv
    return None


def solve_rank_resume(vmin0, ra, rb, initial_state, *, family: str = "dense", on_chunk=None):
    """Resume a solve from checkpoint state ``(fragment, mst_rank_mask,
    level)``: the rest is Borůvka from that partition. Up to
    ``_FILTER_CHUNK_BYTES`` of slot endpoints this is
    :func:`solve_rank_staged`'s ``initial_state`` path; above, the alive
    slots are rebuilt by the chunked filter over every rank (a slot is
    alive iff its endpoints' fragments differ), so no full-width endpoint
    pair is held, and the survivors go straight to the finish."""
    params = _family_params(family)
    n_pad = vmin0.shape[0]
    m_pad = ra.shape[0]
    if 8 * m_pad <= _FILTER_CHUNK_BYTES:
        return solve_rank_staged(vmin0, ra, rb, **params, initial_state=initial_state,
                                 on_chunk=on_chunk)
    fragment, mst, lv = _restore_state(initial_state, n_pad, m_pad, ra.device)
    cfa, cfb, crank, count = _filter_suffix_chunked(fragment, ra, rb, 0)
    if count == 0:
        return mst, fragment, lv
    compact_space = params["compact_space"]
    if compact_space is None:
        compact_space = n_pad >= _CENSUS_MIN_SPACE
    return _finish_to_fixpoint(
        fragment, mst, cfa, cfb, crank,
        lv=lv, count=count, space=n_pad, max_levels=lv + _max_levels(n_pad),
        chunk_levels=params["chunk_levels"], compact_space=compact_space, on_chunk=on_chunk,
    )


def solve_rank_auto(vmin0, ra, rb, *, family: str = "dense", parent1=None):
    """The routing of a staged solve by family. Dense graphs at the filter
    width take the filter route: under the census size the speculative
    filtered program, then on a misprediction (and from the census size
    up) :func:`solve_rank_filtered`. Other dense graphs under the census
    size try the speculative finish (survivors predicted at m/8) and run
    the staged solve on a misprediction; every other graph runs the staged
    solve."""
    n_pad = vmin0.shape[0]
    parent1 = _ensure_parent1(vmin0, ra, rb, parent1)
    if use_filtered_path(family, ra.shape[0]):
        route = "filtered"
        if n_pad < _CENSUS_MIN_SPACE:
            result = solve_rank_filtered_speculative(vmin0, ra, rb, parent1=parent1)
            if result is not None:
                _note_route("filtered-speculative")
                return result
            route = "filtered after a misprediction"
        _note_route(route)
        return solve_rank_filtered(vmin0, ra, rb, parent1=parent1)
    route = "staged"
    if family == "dense" and n_pad < _CENSUS_MIN_SPACE:
        out_size = max(_bucket_size(ra.shape[0] // 8), _COMPACT_MIN_SLOTS)
        result = solve_rank_speculative(vmin0, ra, rb, out_size=out_size, parent1=parent1)
        if result is not None:
            _note_route("speculative")
            return result
        route = "staged after a misprediction"
    _note_route(route)
    return solve_rank_staged(vmin0, ra, rb, **_family_params(family), parent1=parent1)


def make_production_solver(graph: Graph, *, device=None):
    """Stage the graph (:func:`prepare_rank_arrays_full`; the host passes
    and copies run here, so a caller can time the prep apart) and return
    ``solve(on_chunk=None) -> (mst, fragment, levels)``. The one place the
    route is chosen, for ``solve_graph_rank``, the checkpointed,
    instrumented and supervised solves alike:

    * grid and sparse graphs take the host-L2 route: the staged solve with
      level 2 at full width in its head, two-level chunks and the census
      (:func:`solve_rank_staged`, which passes ``on_chunk`` on);
    * dense graphs at the filter width: without a hook
      :func:`solve_rank_auto`, with one the chunked
      :func:`solve_rank_filtered`;
    * every other graph: without a hook :func:`solve_rank_auto`, with one
      the staged solve, whose chunk boundaries the hook sees.

    Every head computes its own level 2 from the prep's ``parent1``, over
    the prefix of the solve that runs it on the filter route. Without a
    hook the route is exactly the unhooked one: asking for chunk
    boundaries selects the chunked forms, so only a caller that passes
    ``on_chunk`` leaves the speculative programs.
    ``on_chunk(level, vertex_fragment, mst, count)`` gets live tensors
    that the solve goes on updating: a hook that keeps them copies them.
    """
    device = resolve_device(device)
    family = _pick_family(graph)
    m_pad = _bucket_size(graph.num_edges)
    if use_l2_path(family):
        route = "l2"
    elif use_filtered_path(family, m_pad):
        route = "filtered"
    else:
        route = "full"
    with _prep_step("solver.prep", family=family, route=route, m_pad=m_pad):
        vmin0, ra, rb, parent1 = prepare_rank_arrays_full(graph, device=device)
    if route == "l2":

        def solve(on_chunk=None):
            _note_route("host-l2")
            return solve_rank_staged(vmin0, ra, rb, compact_after=2, chunk_levels=2,
                                     compact_space=True, parent1=parent1, on_chunk=on_chunk)
    else:

        def solve(on_chunk=None):
            if on_chunk is None:
                return solve_rank_auto(vmin0, ra, rb, family=family, parent1=parent1)
            if route == "filtered":
                _note_route("filtered")
                return solve_rank_filtered(vmin0, ra, rb, on_chunk=on_chunk, parent1=parent1)
            _note_route("staged")
            return solve_rank_staged(vmin0, ra, rb, **_family_params(family),
                                     on_chunk=on_chunk, parent1=parent1)
    return _observed_solver(solve, family)


def _observed_solver(inner, family: str):
    """``inner`` with event-bus telemetry: the solve is a
    ``solver.rank.solve`` span (``family``, ``chunked``, and ``route``, the
    route that answered, named by :func:`_note_route`), and when the
    caller asks for chunk boundaries each one is also a ``solver.chunk``
    event (``level``, ``edges_alive``) before the caller's hook sees it. A
    caller that passes no hook gets none: a hook selects the chunked forms,
    and observing must never reroute a solve."""
    def solve(on_chunk=None):
        if not BUS.enabled:
            return inner(on_chunk=on_chunk)
        hook = on_chunk
        if hook is not None:
            last = [time.perf_counter()]

            def on_chunk(level, fragment, mst, count):
                now = time.perf_counter()
                BUS.complete("solver.chunk", now - last[0], cat="solver", level=int(level),
                             edges_alive=int(count))
                last[0] = now
                hook(level, fragment, mst, count)

        with BUS.span("solver.rank.solve", cat="solver", family=str(family),
                      chunked=hook is not None) as span:
            token = _SOLVE_SPAN.set(span)
            try:
                return inner(on_chunk=on_chunk)
            finally:
                _SOLVE_SPAN.reset(token)

    return solve


# A forest mask wider than this packs to bits in slices, so that the packing's
# temporaries stay bounded; every width above it is a bucket size, a multiple
# of a large power of two, so each slice stays byte-aligned.
_PACKBITS_CHUNK = 1 << 27

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` of a 0/1 mask whose width is a multiple of 8, on the
    mask's device: big-endian bit order (the first rank is the high bit of
    byte 0), uint8, in slices of ``_PACKBITS_CHUNK`` ranks."""
    w = mask.shape[0]
    if w % 8:
        raise ValueError(f"packbits needs a width that divides by 8, got {w}")
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=mask.device)
    parts = []
    for s in range(0, w, _PACKBITS_CHUNK):
        bits = (mask[s:s + _PACKBITS_CHUNK] != 0).to(torch.uint8).view(-1, 8)
        parts.append((bits * weights).sum(1, dtype=torch.uint8))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def packed_to_edge_ids(graph: Graph, packed: np.ndarray, count: int) -> np.ndarray:
    """Host decode of a bit-packed rank mask (big-endian bit order, NumPy's
    default) to sorted edge ids: the sharded multi-process harvest. Where
    the rank route's prep left the graph a device rank order, the ranks map
    to edge ids there (:func:`boruvka.edge_ids_of_ranks`)."""
    mask = np.unpackbits(np.asarray(packed, dtype=np.uint8), count=count).astype(bool)
    ranks = np.nonzero(mask)[0]
    order = held_rank_order(graph)
    if order is None:
        return np.sort(graph.edge_id_of_rank(ranks))
    return edge_ids_of_ranks(graph, torch.from_numpy(ranks).to(order.device))


def solve_graph_kruskal_host(graph: Graph) -> Tuple[np.ndarray, np.ndarray, int]:
    """The ``host`` backend: Kruskal over the precomputed rank order, one
    union-find pass in the native host library, on no card. The rank order
    makes the forest unique, so its edge ids equal every device solve's.
    ``levels`` is 0 (no Borůvka level runs). Integer weights only (the
    rank order it checks is the native counting sort's): float weights
    raise ``NotImplementedError``. A native library that cannot be built
    raises ``RuntimeError``, as every native pass does."""
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0
    if not graph.is_integer_weighted:
        raise NotImplementedError("host backend needs integer weights")
    edge_ids, labels = native_lib.kruskal_msf_solve_native(
        n, graph._rank_order, graph.u, graph.v, graph.w)
    return np.sort(edge_ids), labels.astype(np.int32), 0


def solve_graph_rank(graph: Graph, *, device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host entry with ``models.boruvka.solve_graph``'s contract: ``(sorted
    edge ids, fragment[:n], levels)``."""
    device = resolve_device(device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0
    mst, fragment, levels = make_production_solver(graph, device=device)()
    return harvest(graph, mst, fragment, levels)
