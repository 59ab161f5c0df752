"""Batched Borůvka/GHS minimum-spanning-forest solver on PyTorch.

Port of the flat, stepped and single-device ELL paths of the JAX package's
``models/boruvka.py``. One *level* of the flat paths is:

  1. ``fragment_moe``: per-fragment minimum outgoing edge, one rank-keyed
     segment minimum (K2 ``gather_key`` on the card, past level 0),
  2. ``hook_and_compress``: symmetric-hook break and pointer jumping (K1
     ``hook_compress`` on the card),
  3. the winning ranks are marked as forest edges.

Levels repeat until no fragment has an outgoing edge, capped at
``_max_levels(n)``, so the level count equals the JAX solver's. Each JAX
``lax.while_loop`` is a Python loop here that reads ``progress`` once per
level: that is the loop's one host sync.

Device state is int32 as in JAX; the forest mask is uint8 (0/1) so that it
can be marked with a max-scatter.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import (
    INT32_MAX,
    fragment_moe,
    segment_min,
)
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress


class BoruvkaState(NamedTuple):
    """Carried through the level loop."""

    fragment: torch.Tensor  # [n] int32: fragment (root) id per vertex
    mst_ranks: torch.Tensor  # [m] uint8: 1 where the rank-r edge is in the forest
    level: int  # levels completed
    progress: torch.Tensor  # scalar bool: did the last level find an outgoing edge


def _mark(mst_ranks: torch.Tensor, has_moe: torch.Tensor, moe_rank: torch.Tensor) -> torch.Tensor:
    """``mst_ranks[moe_rank] = 1`` for every fragment with an MOE.

    Fragments without one scatter to rank 0 with value 0, and rank 0 (the
    global minimum edge) is always in the forest: a plain indexed store with
    duplicate indices could let such a 0 land after another fragment's 1.
    A max-scatter keeps the 1 whatever the order.
    """
    safe = torch.where(has_moe, moe_rank, 0).long()
    return mst_ranks.scatter_reduce_(0, safe, has_moe.to(torch.uint8), "amax")


def boruvka_level(
    state: BoruvkaState,
    src: torch.Tensor,
    dst: torch.Tensor,
    rank: torch.Tensor,
    ra: torch.Tensor,
    rb: torch.Tensor,
    *,
    identity_fragment: bool = False,
    hook_form: str = "auto",
) -> BoruvkaState:
    """One Borůvka level over the directed edge slots. Updates
    ``state.mst_ranks`` in place. ``hook_form`` is K1's launch form."""
    has_moe, moe_rank, moe_dst_frag = fragment_moe(
        state.fragment, src, dst, rank, ra, rb, identity_fragment=identity_fragment,
    )
    new_fragment, _ = hook_and_compress(has_moe, moe_dst_frag, state.fragment, form=hook_form)
    return BoruvkaState(
        fragment=new_fragment,
        mst_ranks=_mark(state.mst_ranks, has_moe, moe_rank),
        level=state.level + 1,
        progress=has_moe.any(),
    )


def _max_levels(num_nodes: int) -> int:
    return max(1, math.ceil(math.log2(max(num_nodes, 2)))) + 1


# Below this edge count the auto strategy takes the flat fused solve; at and
# above it, the rank solver (``models/rank_solver.py``).
ELL_AUTO_EDGE_THRESHOLD = 1 << 17


def _run_levels(state: BoruvkaState, src, dst, rank, ra, rb, *,
                hook_form: str = "auto") -> BoruvkaState:
    max_levels = _max_levels(state.fragment.shape[0])
    while state.level < max_levels and bool(state.progress):
        state = boruvka_level(state, src, dst, rank, ra, rb, hook_form=hook_form)
    return state


def boruvka_solve(
    fragment0: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rank: torch.Tensor,
    ra: torch.Tensor,
    rb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full solve from any starting partition whose entries are root ids.

    Returns ``(mst_ranks[m], fragment[n], levels)``.
    """
    state = BoruvkaState(
        fragment=fragment0,
        mst_ranks=torch.zeros(ra.shape[0], dtype=torch.uint8, device=ra.device),
        level=0,
        progress=torch.ones((), dtype=torch.bool, device=ra.device),
    )
    final = _run_levels(state, src, dst, rank, ra, rb)
    return final.mst_ranks, final.fragment, final.level


def _solve_from_iota(src, dst, rank, ra, rb, *, num_nodes: int, hook_form: str = "auto"):
    """Solve from the identity partition; level 0 skips the fragment gathers
    because the partition really is the identity there. ``hook_form`` is
    K1's launch form (``kernels.HOOK_FORMS``)."""
    state = BoruvkaState(
        fragment=torch.arange(num_nodes, dtype=torch.int32, device=src.device),
        mst_ranks=torch.zeros(ra.shape[0], dtype=torch.uint8, device=ra.device),
        level=0,
        progress=torch.ones((), dtype=torch.bool, device=src.device),
    )
    state = boruvka_level(state, src, dst, rank, ra, rb, identity_fragment=True,
                          hook_form=hook_form)
    final = _run_levels(state, src, dst, rank, ra, rb, hook_form=hook_form)
    return final.mst_ranks, final.fragment, final.level


# ---------------------------------------------------------------------------
# ELL (degree-bucketed) variant.
#
# Graph.ell_buckets lays the directed adjacency out as 2-D blocks, one per
# degree class, so the per-vertex MOE is a dense masked row minimum. On the
# card a level's row minima over all buckets, folded into the per-vertex
# minima, are one K3 launch (``kernels.ell_level_min``, over the plan that
# ``kernels.ell_plan`` builds once per solve); the only scatter left is
# n-sized: the per-vertex minima into per-fragment minima.
# ---------------------------------------------------------------------------


def _ell_level(fragment, mst_ranks, plan, ra, rb, *, identity_fragment=False, hook_form="auto"):
    """One level over the ELL buckets of ``plan`` (``kernels.ell_plan``);
    returns ``(fragment2, mst_ranks, has_any)`` and updates ``mst_ranks`` in
    place.

    ``identity_fragment`` marks level 0, where ``fragment == arange(n)``:
    rows hold no self-edges, so every entry is outgoing, and rows are in
    rank order, so the first entry is the row minimum.
    """
    n = fragment.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=fragment.device)
    vmin = torch.full((n,), INT32_MAX, dtype=torch.int32, device=fragment.device)
    if identity_fragment:
        for verts, _, rankb in plan.buckets:
            # Pad rows alias vertex 0 with INT32_MAX: a min-scatter, not a store.
            vmin.scatter_reduce_(0, verts.long(), rankb[:, 0], "amin")
        moe = vmin
    else:
        moe = segment_min(kernels.ell_level_min(fragment, plan, vmin), fragment, n)
    has = moe < INT32_MAX
    safe = torch.where(has, moe, 0)
    if identity_fragment:
        fa, fb = ra[safe], rb[safe]
    else:
        fa, fb = fragment[ra[safe]], fragment[rb[safe]]
    dst_frag = torch.where(has, torch.where(fa == ids, fb, fa), ids)
    fragment2, _ = hook_and_compress(has, dst_frag, fragment, form=hook_form)
    return fragment2, _mark(mst_ranks, has, moe), has.any()


def ell_solve_loop(buckets, ra, rb, *, num_nodes: int, tile_slots: int = kernels.ELL_TILE_SLOTS,
                   hook_form: str = "auto"):
    """Full ELL solve from the identity partition: the identity level, then
    one level at a time while a fragment has an outgoing edge, capped at
    ``_max_levels(num_nodes)``. Returns ``(mst_ranks, fragment, levels)``.
    ``tile_slots`` is K3's tile and ``hook_form`` K1's launch form."""
    plan = kernels.ell_plan(buckets, tile_slots=tile_slots)
    fragment = torch.arange(num_nodes, dtype=torch.int32, device=ra.device)
    mst_ranks = torch.zeros(ra.shape[0], dtype=torch.uint8, device=ra.device)
    fragment, mst_ranks, has = _ell_level(
        fragment, mst_ranks, plan, ra, rb, identity_fragment=True, hook_form=hook_form,
    )
    levels, max_levels = 1, _max_levels(num_nodes)
    while levels < max_levels and bool(has):
        fragment, mst_ranks, has = _ell_level(fragment, mst_ranks, plan, ra, rb,
                                              hook_form=hook_form)
        levels += 1
    return mst_ranks, fragment, levels


def host_ell_arrays(graph: Graph):
    """The ELL staging's host half: ``(buckets, ra, rb, n_pad)`` as NumPy
    arrays, with ``ra``/``rb`` padded to ``next_pow2(m)`` ranks."""
    ra, rb = graph.rank_endpoints(pad_to=_next_pow2(graph.num_edges))
    return graph.ell_buckets, ra, rb, _next_pow2(graph.num_nodes)


def ell_arrays_from_numpy(buckets, ra, rb, *, device):
    """``(buckets, ra, rb)`` as int32 tensors on ``device``, from NumPy
    arrays such as the JAX package's ``prepare_ell_arrays`` gives."""
    device = resolve_device(device)
    return (
        tuple(tuple(_to_device(a, torch.int32, device) for a in b) for b in buckets),
        _to_device(ra, torch.int32, device),
        _to_device(rb, torch.int32, device),
    )


def prepare_ell_arrays(graph: Graph, *, device=None):
    """Host->device staging for the ELL solve: ``(buckets, ra, rb, n_pad)``
    on ``device`` (``None`` = CUDA)."""
    device = resolve_device(device)
    buckets, ra, rb, n_pad = host_ell_arrays(graph)
    return (*ell_arrays_from_numpy(buckets, ra, rb, device=device), n_pad)


# ---------------------------------------------------------------------------
# Host-stepped variant with level-wise edge compaction.
#
# Each stepped level relabels src/dst to fragment ids (so the next level's
# MOE search takes the identity path), counts the surviving slots, and
# compacts the slot arrays into the next power-of-two size when they shrink
# at least 2x. One host sync per level reads (progress, count).
# ---------------------------------------------------------------------------


def _level_kernel(fragment, mst_ranks, src_f, dst_f, rank, ra, rb):
    """One level over fragment-relabeled slots; returns relabeled survivors.

    ``src_f/dst_f`` hold current fragment ids, so the MOE search takes the
    identity path; ``fragment`` still maps the original vertices.
    """
    has, moe_rank, dst_frag = fragment_moe(
        fragment, src_f, dst_f, rank, ra, rb, identity_fragment=True,
    )
    fragment2, parent = hook_and_compress(has, dst_frag, fragment)
    mst2 = _mark(mst_ranks, has, moe_rank)
    src2 = parent[src_f]
    dst2 = parent[dst_f]
    count2 = (src2 != dst2).sum()
    return fragment2, mst2, src2, dst2, has.any(), count2


def _compact_kernel(src_f, dst_f, rank, out_size: int):
    """Stream-compact the alive slots into ``out_size`` slots (pads inert).

    Dead slots scatter to one spare slot past the end, which is cut off:
    JAX drops such writes (``mode="drop"``), CUDA indexing would assert.
    """
    alive = src_f != dst_f
    pos = torch.cumsum(alive, 0) - 1
    idx = torch.where(alive, pos, out_size)
    dev = src_f.device
    new_src = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    new_dst = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    new_rank = torch.full((out_size + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    new_src[idx] = src_f
    new_dst[idx] = dst_f
    new_rank[idx] = rank
    return new_src[:out_size], new_dst[:out_size], new_rank[:out_size]


_COMPACT_MIN_SLOTS = 2048


def _continue_solve(fragment, mst_ranks, level: int, src_f, dst_f, rank, ra, rb):
    """Finish the solve from a mid-run state (after compaction)."""
    state = BoruvkaState(
        fragment=fragment,
        mst_ranks=mst_ranks,
        level=level,
        progress=torch.ones((), dtype=torch.bool, device=fragment.device),
    )
    final = _run_levels(state, src_f, dst_f, rank, ra, rb)
    return final.mst_ranks, final.fragment, final.level


def solve_arrays_stepped(
    fragment0,
    src,
    dst,
    rank,
    ra,
    rb,
    *,
    compact: bool = True,
    stepped_levels: int | None = 2,
    initial_state: tuple | None = None,
    on_level=None,
):
    """Host-stepped solve: ``stepped_levels`` levels with edge compaction,
    then the plain level loop to the end (``None`` steps every level).

    ``initial_state`` is ``(fragment, mst_ranks, level)`` to resume
    mid-solve (see :func:`state_from_numpy`; its ``mst_ranks`` is updated in
    place); the slots are relabeled to the restored partition first.
    ``on_level(level, fragment, mst_ranks, has, count, wall_time_s)`` fires
    after each stepped level, after its ``solver.level`` event on the bus.
    Returns ``(mst_ranks, fragment, levels)``.
    """
    n = fragment0.shape[0]
    if initial_state is not None:
        fragment, mst_ranks, levels = initial_state
        src_f = fragment[src]
        dst_f = fragment[dst]
    else:
        fragment = fragment0
        mst_ranks = torch.zeros(ra.shape[0], dtype=torch.uint8, device=ra.device)
        src_f, dst_f = src, dst  # fragment ids == vertex ids at level 0
        levels = 0
    max_levels = _max_levels(n)
    step_until = max_levels if stepped_levels is None else min(
        levels + stepped_levels, max_levels
    )
    while levels < step_until:
        t0 = time.perf_counter()
        fragment, mst_ranks, src_f, dst_f, has, count = _level_kernel(
            fragment, mst_ranks, src_f, dst_f, rank, ra, rb
        )
        levels += 1
        has, count = torch.stack((has.long(), count)).tolist()  # one round trip
        BUS.complete("solver.level", time.perf_counter() - t0, cat="solver", level=levels,
                     edges_alive=count // 2)  # directed slots -> undirected edges
        if on_level is not None:
            on_level(levels, fragment, mst_ranks, bool(has), count,
                     time.perf_counter() - t0)
        if not has:
            return mst_ranks, fragment, levels
        if compact:
            tgt = max(_next_pow2(count), _COMPACT_MIN_SLOTS)
            if 2 * tgt <= src_f.shape[0]:
                src_f, dst_f, rank = _compact_kernel(src_f, dst_f, rank, tgt)
    if levels >= max_levels:
        return mst_ranks, fragment, levels
    with BUS.span("solver.fused_finish", cat="solver", from_level=levels):
        return _continue_solve(fragment, mst_ranks, levels, src_f, dst_f, rank, ra, rb)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _bucket_size(x: int) -> int:
    """Next size in {1, 1.25, 1.5, 1.75} * 2^k >= x."""
    if x <= 4:
        return max(1, x)
    p = 1 << (x - 1).bit_length()
    for num in (5, 6, 7):
        cand = num * (p >> 3)
        if cand >= x:
            return cand
    return p


# ---------------------------------------------------------------------------
# Staging: host arrays -> device tensors
# ---------------------------------------------------------------------------


def _to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy on ``device``: the solver updates some state in place."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def arrays_from_numpy(fragment0, src, dst, rank, ra, rb, *, device):
    """``(fragment0, src, dst, rank, ra, rb)`` as int32 tensors on ``device``,
    from NumPy arrays such as the JAX package's ``prepare_device_arrays``
    gives (via ``np.asarray``)."""
    device = resolve_device(device)
    return tuple(
        _to_device(a, torch.int32, device)
        for a in (fragment0, src, dst, rank, ra, rb)
    )


def state_from_numpy(fragment, mst_ranks, level, *, device):
    """A mid-solve ``(fragment, mst_ranks, level)`` from NumPy, as
    :func:`solve_arrays_stepped` takes for ``initial_state``: for example the
    state the JAX package's ``solve_arrays_stepped(on_level=...)`` reports."""
    device = resolve_device(device)
    return (
        _to_device(fragment, torch.int32, device),
        _to_device(np.asarray(mst_ranks).astype(bool), torch.uint8, device),
        int(level),
    )


def host_arrays(graph: Graph, *, bucket_shapes: bool = True):
    """The staging's host half: ``(fragment0, src, dst, rank, ra, rb)`` as
    NumPy arrays.

    With ``bucket_shapes``, slots, ranks and vertices pad to powers of two
    (padding vertices are isolated self-fragments; padding slots and ranks
    are inert), as in the JAX package.
    """
    n = graph.num_nodes
    n_pad = _next_pow2(n) if bucket_shapes else n
    e_pad = _next_pow2(2 * graph.num_edges) if bucket_shapes else None
    m_pad = e_pad // 2 if e_pad is not None else None
    return (np.arange(n_pad, dtype=np.int32),
            *graph.rank_arrays(pad_edges_to=e_pad, pad_ranks_to=m_pad))


def prepare_device_arrays(graph: Graph, *, bucket_shapes: bool = True, device=None):
    """Host->device staging: ``(fragment0, src, dst, rank, ra, rb)`` int32
    tensors on ``device`` (``None`` = CUDA)."""
    device = resolve_device(device)
    return arrays_from_numpy(*host_arrays(graph, bucket_shapes=bucket_shapes), device=device)


def solve_graph(
    graph: Graph,
    *,
    bucket_shapes: bool = True,
    strategy: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host entry: solve ``graph`` on ``device`` (``None`` = CUDA).

    Returns ``(mst_edge_ids, fragment, levels)``: ids into ``graph.u/v/w``,
    sorted ascending, the fragment of each vertex, and the level count.

    ``strategy``: ``"fused"`` = the flat level loop from the identity
    partition; ``"stepped"`` = host-stepped levels with edge compaction;
    ``"ell"`` = the degree-bucketed level loop (``bucket_shapes`` does not
    apply: its arrays always pad to powers of two); ``"rank"`` = the
    rank-space solver (``models/rank_solver.py``; its arrays pad to
    ``_bucket_size`` steps); ``"auto"`` = ``fused`` below
    ``ELL_AUTO_EDGE_THRESHOLD`` edges, ``rank`` at and above it. A kernel
    that fails raises; nothing re-runs on another path. The solve is one
    ``solver.solve`` span on the event bus (``obs/``).
    """
    device = resolve_device(device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0
    if strategy == "auto":
        strategy = "rank" if graph.num_edges >= ELL_AUTO_EDGE_THRESHOLD else "fused"
    if strategy not in ("fused", "stepped", "ell", "rank"):
        raise ValueError(f"unknown strategy {strategy!r}")
    with BUS.span("solver.solve", cat="solver", strategy=strategy, nodes=n,
                  edges=graph.num_edges, kernel=kernel_label(device)):
        return _solve_graph(graph, strategy, bucket_shapes, device)


def kernel_label(device: torch.device) -> str:
    """What runs the kernels on ``device``, as the ``kernel`` argument of
    the ``solver.solve`` event reads it: ``"cuda"`` (the hand kernels) on
    the card, ``"torch"`` (their plain versions) on the CPU. The JAX
    package's event reads ``"pallas"`` or ``"xla"`` there."""
    return "cuda" if device.type == "cuda" else "torch"


def _solve_graph(graph: Graph, strategy: str, bucket_shapes: bool, device):
    if strategy == "rank":
        from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
            solve_graph_rank,
        )

        return solve_graph_rank(graph, device=device)
    # A tuning record's config for this graph's bucket (tune/record.py),
    # else the default launches.
    bucket = (_next_pow2(graph.num_nodes), _next_pow2(graph.num_edges))
    if strategy == "ell":
        config = kernels.tuned_config((*bucket, 0, "ell"))
        buckets, ra, rb, n_pad = prepare_ell_arrays(graph, device=device)
        mst_ranks, fragment, levels = ell_solve_loop(
            buckets, ra, rb, num_nodes=n_pad, tile_slots=config.tile_slots,
            hook_form=config.hook_form)
    else:
        args = prepare_device_arrays(graph, bucket_shapes=bucket_shapes, device=device)
        if strategy == "stepped":
            mst_ranks, fragment, levels = solve_arrays_stepped(*args)
        else:
            config = kernels.tuned_config((*bucket, 0, "fused"))
            mst_ranks, fragment, levels = _solve_from_iota(
                *args[1:], num_nodes=args[0].shape[0], hook_form=config.hook_form)
    return harvest(graph, mst_ranks, fragment, levels)


def harvest(graph: Graph, mst_ranks: torch.Tensor, fragment: torch.Tensor,
            levels) -> Tuple[np.ndarray, np.ndarray, int]:
    """A solve's device state -> ``solve_graph``'s result: ``(sorted edge
    ids, fragment[:n] on the host, levels)``."""
    return (fetch_mst_edge_ids(graph, mst_ranks),
            fragment[: graph.num_nodes].cpu().numpy(), int(levels))


def fetch_mst_edge_ids(graph: Graph, mst_ranks: torch.Tensor) -> np.ndarray:
    """Forest mask over ranks -> sorted edge ids: ``torch.nonzero`` on the
    device, then only the forest's ranks cross to the host."""
    ranks = torch.nonzero(mst_ranks).flatten().cpu().numpy()
    return np.sort(graph.edge_id_of_rank(ranks))
