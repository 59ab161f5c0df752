"""Lane stacking: K same-bucket graphs through one level loop on the card.

Port of the JAX package's ``batch/lanes.py``. Every graph pads to
power-of-two ``(n_pad, m_pad)`` buckets, so K graphs of one bucket stack
into lanes and solve in one level loop, in two modes:

* ``"fused"`` (default): block-diagonal. Lane ``i``'s vertices shift by
  ``i * n_pad`` and its ranks by ``i * m_pad``, so the batch is one
  disjoint-union graph that the flat solve (``_solve_from_iota``) runs
  unchanged: K2 and K1 launch once a level over the whole stack. Fragments
  never cross lanes and the shift keeps each lane's rank order, so the
  forest of the union is exactly the lanes' forests. Every lane reports the
  stack's level count (the slowest lane's).
* ``"vmap"``: the JAX package's ``jax.vmap`` of the iota solve. The port
  keeps its contract on the same block-diagonal stack and level loop: each
  level also reduces ``has_moe`` over each lane, so each lane reports its
  own level count (the level at which its own ``progress`` went false,
  capped at ``_max_levels(n_pad)``), and its fragments are local to it.

**The solver cache.** The port has no ahead-of-time compile. An entry is a
bucket's prepared solver, keyed ``(n_pad, m_pad, lanes, mode, kernel)``
with ``kernel`` the device's label (``models.boruvka.kernel_label``:
``cuda`` or ``torch``). Building one loads the kernel library (which runs
the K4 self-check) and launches the solver once on an inert stack of all
pads at the bucket's exact shapes, ending in a host read. One leader
builds a cold bucket while the others wait on its event, and a hit never
waits on another bucket's build. ``batch.compile.hit|miss`` and
``compile.{hit,miss,warmup,kernel.<k>}`` count the traffic as in the JAX
package, so "a warmed bucket causes no build at request time" is a
property a run can assert. There is no kernel choice and no fallback: a
kernel that fails to build or launch raises out of :func:`execute_stacked`.

**Tuned launches.** Each solve of a bucket reads the bucket's installed
launch config (``kernels.tuned_config``, which ``tune.record.install_record``
writes) for K1's form; without a record it is ``"auto"``. A cache entry does
not depend on it, so installing a record needs no rebuild.

:func:`stack_lanes` does the host work (padding, shifting, NumPy arrays)
and :func:`execute_stacked` the device work and the per-lane unpack, so
``batch/engine.py`` can stack batch *k+1* on a thread while batch *k* runs.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    _mark,
    _max_levels,
    _next_pow2,
    _solve_from_iota,
    kernel_label,
)
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.ops.segment_ops import fragment_moe
from distributed_ghs_implementation_tpu_torch.ops.union_find import hook_and_compress

_INT32_MAX = np.iinfo(np.int32).max

BucketKey = Tuple[int, int]  # (n_pad, m_pad)
SolverKey = Tuple[int, int, int, str]  # (n_pad, m_pad, lanes, mode)
# The cache key carries a fifth element, the device's kernel label, so the
# card's and the CPU's solvers of one bucket are told apart. The public
# SolverKey (records, compiled_bucket_keys) stays 4-wide, as in the JAX
# package.
_CacheKey = Tuple[int, int, int, str, str]


def bucket_of(num_nodes: int, num_edges: int) -> BucketKey:
    """The shape bucket a ``(nodes, edges)`` workload pads into: vertices
    and undirected ranks to the next power of two (edge slots are always
    ``2 * m_pad``); empty dimensions bucket at 1. Warmup specs and request
    keys both go through it, so a declared bucket is a hit bucket."""
    return (_next_pow2(max(1, num_nodes)), _next_pow2(max(1, num_edges)))


def bucket_key(graph: Graph) -> BucketKey:
    """:func:`bucket_of` for a built ``Graph``: two graphs with equal keys
    stack into interchangeable lanes."""
    return bucket_of(graph.num_nodes, graph.num_edges)


# ----------------------------------------------------------------------
# Solver cache: (n_pad, m_pad, lanes, mode, kernel) -> prepared solver.
# The lock guards only the dict lookups and inserts; builds run outside it
# with a pending event a key.
# ----------------------------------------------------------------------
_SOLVER_CACHE: Dict[_CacheKey, object] = {}
_PENDING_COMPILES: Dict[_CacheKey, threading.Event] = {}
_CACHE_LOCK = threading.Lock()


def lane_compile_stats() -> dict:
    """The cache's entries and keys (the counters are on the bus)."""
    with _CACHE_LOCK:
        return {"entries": len(_SOLVER_CACHE), "keys": sorted(_SOLVER_CACHE)}


def compiled_bucket_keys() -> List[SolverKey]:
    """The solver keys built so far, the record warmup replay persists;
    the kernel label is dropped (a replay warms the device it runs on)."""
    with _CACHE_LOCK:
        return sorted({k[:4] for k in _SOLVER_CACHE})


def clear_solver_cache() -> None:
    """Drop every prepared lane solver (tests simulate a process restart)."""
    with _CACHE_LOCK:
        _SOLVER_CACHE.clear()


def _hook_form(n_pad: int, m_pad: int, lanes: int, mode: str, hook_form: str | None) -> str:
    """K1's launch form for a bucket's solve: ``hook_form`` where the
    caller fixed one (the tuner does), else the installed tuning record's
    config for the bucket (``kernels.tuned_config``), read at each solve.
    An installed config counts ``kernel.selected.measured``, as the JAX
    package's selector counts a record's winner for a lane bucket."""
    if hook_form is not None:
        return hook_form
    config = kernels.tuned_config((n_pad, m_pad, lanes, mode), default=None)
    if config is None:
        return kernels.DEFAULT_CONFIG.hook_form
    BUS.count("kernel.selected.measured")
    return config.hook_form


def _solve_fused(src, dst, rank, ra, rb, *, n_pad: int, m_pad: int, lanes: int,
                 hook_form: str | None = None):
    """The block-diagonal stack through the flat solve: ``(mst_ranks,
    fragment, levels)`` with one level count for the stack."""
    return _solve_from_iota(src, dst, rank, ra, rb, num_nodes=lanes * n_pad,
                            hook_form=_hook_form(n_pad, m_pad, lanes, "fused", hook_form))


def _solve_vmap(src, dst, rank, ra, rb, *, n_pad: int, m_pad: int, lanes: int,
                hook_form: str | None = None):
    """The ``(lanes, ...)`` stack as one block-diagonal level loop that
    counts each lane's levels: ``(mst_ranks, fragment, levels[lanes])``.

    A lane counts a level while it is alive: from level 0 on, until the
    level at which it found no outgoing edge, and at most
    ``_max_levels(n_pad)``. A lane that stopped is a fixpoint of further
    levels (no fragment of it has an outgoing edge), so the stack's levels
    leave it as its own solve left it. One host read a level: the lanes'
    ``has_moe`` reductions.
    """
    dev = src.device
    form = _hook_form(n_pad, m_pad, lanes, "vmap", hook_form)
    lane = torch.arange(lanes, dtype=torch.int32, device=dev)[:, None]
    vshift = lane * n_pad
    src = (src + vshift).reshape(-1)
    dst = (dst + vshift).reshape(-1)
    rank = torch.where(rank == _INT32_MAX, rank, rank + lane * m_pad).reshape(-1)
    ra = (ra + vshift).reshape(-1)
    rb = (rb + vshift).reshape(-1)
    fragment = torch.arange(lanes * n_pad, dtype=torch.int32, device=dev)
    mst_ranks = torch.zeros(lanes * m_pad, dtype=torch.uint8, device=dev)
    levels = np.zeros(lanes, dtype=np.int64)
    alive = np.ones(lanes, dtype=bool)
    cap, level = _max_levels(n_pad), 0
    while alive.any() and level < cap:
        has, moe_rank, dst_frag = fragment_moe(
            fragment, src, dst, rank, ra, rb, identity_fragment=level == 0,
        )
        fragment, _ = hook_and_compress(has, dst_frag, fragment, form=form)
        _mark(mst_ranks, has, moe_rank)
        level += 1
        levels[alive] = level
        alive &= has.view(lanes, n_pad).any(1).cpu().numpy()
    return mst_ranks, fragment, levels


_SOLVERS = {"fused": _solve_fused, "vmap": _solve_vmap}


def _inert_stack(n_pad: int, m_pad: int, lanes: int, mode: str, device):
    """An all-pad stack at the bucket's exact shapes: self-loop slots at
    each lane's vertex 0 and sentinel ranks, so no vertex has an outgoing
    edge and the solve stops after one level."""
    e_shape = (lanes * 2 * m_pad,) if mode == "fused" else (lanes, 2 * m_pad)
    r_shape = (lanes * m_pad,) if mode == "fused" else (lanes, m_pad)
    zeros = torch.zeros(e_shape, dtype=torch.int32, device=device)
    rank = torch.full(e_shape, _INT32_MAX, dtype=torch.int32, device=device)
    rzeros = torch.zeros(r_shape, dtype=torch.int32, device=device)
    return zeros, zeros, rank, rzeros, rzeros


def _compile_bucket(n_pad: int, m_pad: int, lanes: int, mode: str, device, *,
                    hook_form: str | None = None):
    """Prepare one bucket's solver: load the kernel library (the K4
    self-check runs at its first load) and launch the solver once on an
    inert stack, ending in a host read, so a fault shows here.

    ``hook_form`` fixes K1's form; ``None`` (the cached solvers) reads the
    bucket's installed tuning config at each solve."""
    if mode not in _SOLVERS:
        raise ValueError(f"unknown lane mode {mode!r}; expected fused|vmap")
    solver = functools.partial(_SOLVERS[mode], n_pad=n_pad, m_pad=m_pad, lanes=lanes,
                               hook_form=hook_form)
    if device.type == "cuda":
        kernels._lib()
    _, fragment, _ = solver(*_inert_stack(n_pad, m_pad, lanes, mode, device))
    int(fragment[-1])
    return solver


def _get_solver(
    n_pad: int, m_pad: int, lanes: int, mode: str, *,
    phase: str = "request", device=None,
):
    """The bucket's prepared solver, building it on first need.

    ``phase`` says who paid for a build: ``"request"`` (a live solve waited
    on it) or ``"warmup"`` (built ahead of traffic). A hit always counts as
    ``compile.hit``. Another thread building the same key is waited for; a
    failed build elects a new leader.
    """
    device = resolve_device(device)
    kernel = kernel_label(device)
    key = (n_pad, m_pad, lanes, mode, kernel)
    while True:
        with _CACHE_LOCK:
            fn = _SOLVER_CACHE.get(key)
            if fn is not None:
                BUS.count("batch.compile.hit")
                BUS.count("compile.hit")
                return fn
            pending = _PENDING_COMPILES.get(key)
            if pending is None:
                pending = _PENDING_COMPILES[key] = threading.Event()
                BUS.count("batch.compile.miss")
                BUS.count(f"compile.{'warmup' if phase == 'warmup' else 'miss'}")
                BUS.count(f"compile.kernel.{kernel}")
                break  # this thread leads the build, outside the lock
        pending.wait()
    try:
        t0 = time.perf_counter()
        with BUS.span(
            "compile.bucket", cat="compile",
            n_pad=n_pad, m_pad=m_pad, lanes=lanes, mode=mode, phase=phase,
            kernel=kernel,
        ):
            fn = _compile_bucket(n_pad, m_pad, lanes, mode, device)
        BUS.record("compile.time_s", time.perf_counter() - t0)
        with _CACHE_LOCK:
            _SOLVER_CACHE[key] = fn
        return fn
    finally:
        with _CACHE_LOCK:
            del _PENDING_COMPILES[key]
        pending.set()


def _check_id_space(n_pad: int, m_pad: int, lanes: int, why: str) -> None:
    if lanes * n_pad >= _INT32_MAX or lanes * m_pad >= _INT32_MAX:
        raise ValueError(
            f"bucket ({n_pad}, {m_pad}) x {lanes} lanes exceeds int32 id space; {why}"
        )


def precompile_bucket(
    n_pad: int, m_pad: int, lanes: int, mode: str = "fused", *, device=None,
) -> bool:
    """Build a bucket's lane solver on ``device`` (``None`` = CUDA) ahead
    of serving (idempotent).

    Returns ``True`` if this call built it, ``False`` if it was cached. The
    build counts as ``compile.warmup`` (and ``batch.compile.miss``).
    Geometries the request path rejects are rejected here too.
    """
    device = resolve_device(device)
    kernel = kernel_label(device)
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    _check_id_space(n_pad, m_pad, lanes, "no request-path stack can ever use this solver")
    with _CACHE_LOCK:
        cached = (n_pad, m_pad, lanes, mode, kernel) in _SOLVER_CACHE
    if cached:
        return False
    _get_solver(n_pad, m_pad, lanes, mode, phase="warmup", device=device)
    return True


# ----------------------------------------------------------------------
# Stacking
# ----------------------------------------------------------------------
def _stack_fused(graphs: Sequence[Graph], n_pad: int, m_pad: int, lanes: int):
    """Block-diagonal layout: one flat disjoint-union graph.

    Pads stay inert as in the single-graph layout, shifted into their
    lane's block: slot pads are lane-local self-edges, rank pads stay at
    the INT32_MAX sentinel (not shifted: that would overflow and make a pad
    comparable), endpoint pads are the lane's vertex 0. Unfilled lanes are
    all pad: no edges, n_pad isolated vertices.
    """
    e_pad = 2 * m_pad
    src = np.empty(lanes * e_pad, np.int32)
    dst = np.empty(lanes * e_pad, np.int32)
    rank = np.full(lanes * e_pad, _INT32_MAX, np.int32)
    ra = np.empty(lanes * m_pad, np.int32)
    rb = np.empty(lanes * m_pad, np.int32)
    for i in range(lanes):
        voff = i * n_pad
        es, ee = i * e_pad, (i + 1) * e_pad
        rs, re = i * m_pad, (i + 1) * m_pad
        if i < len(graphs):
            s, d, r, a, b = graphs[i].rank_arrays(pad_edges_to=e_pad, pad_ranks_to=m_pad)
            src[es:ee] = s + voff
            dst[es:ee] = d + voff
            rank[es:ee] = np.where(r == _INT32_MAX, _INT32_MAX, r + i * m_pad)
            ra[rs:re] = a + voff
            rb[rs:re] = b + voff
        else:
            src[es:ee] = voff
            dst[es:ee] = voff
            ra[rs:re] = voff
            rb[rs:re] = voff
    return src, dst, rank, ra, rb


def _stack_vmap(graphs: Sequence[Graph], n_pad: int, m_pad: int, lanes: int):
    """Leading-lane-axis layout ``(lanes, ...)``, each lane in its own ids."""
    e_pad = 2 * m_pad
    src = np.zeros((lanes, e_pad), np.int32)
    dst = np.zeros((lanes, e_pad), np.int32)
    rank = np.full((lanes, e_pad), _INT32_MAX, np.int32)
    ra = np.zeros((lanes, m_pad), np.int32)
    rb = np.zeros((lanes, m_pad), np.int32)
    for i, g in enumerate(graphs):
        s, d, r, a, b = g.rank_arrays(pad_edges_to=e_pad, pad_ranks_to=m_pad)
        src[i], dst[i], rank[i], ra[i], rb[i] = s, d, r, a, b
    return src, dst, rank, ra, rb


@dataclasses.dataclass(frozen=True)
class StackedBatch:
    """One formed batch's host arrays, ready to dispatch. Nothing changes
    them, so the engine's retry runs the same stack again."""

    graphs: Tuple[Graph, ...]
    n_pad: int
    m_pad: int
    lanes: int
    mode: str
    arrays: tuple


def stack_lanes(
    graphs: Sequence[Graph],
    *,
    lanes: int | None = None,
    mode: str = "fused",
) -> StackedBatch:
    """The host half of a lane solve: validate and stack the arrays. It
    touches no device and no shared cache, so it may run on a thread while
    another batch executes."""
    if not graphs:
        raise ValueError("cannot stack an empty batch")
    lanes = len(graphs) if lanes is None else int(lanes)
    if lanes < len(graphs):
        raise ValueError(f"lanes={lanes} < {len(graphs)} graphs")
    n_pad, m_pad = bucket_key(graphs[0])
    for g in graphs[1:]:
        if bucket_key(g) != (n_pad, m_pad):
            raise ValueError(
                f"mixed buckets in one lane stack: {bucket_key(g)} vs "
                f"{(n_pad, m_pad)} (the policy must group by bucket)"
            )
    _check_id_space(n_pad, m_pad, lanes, "the policy should bypass graphs this large")
    if mode == "fused":
        arrays = _stack_fused(graphs, n_pad, m_pad, lanes)
    elif mode == "vmap":
        arrays = _stack_vmap(graphs, n_pad, m_pad, lanes)
    else:
        raise ValueError(f"unknown lane mode {mode!r}; expected fused|vmap")
    return StackedBatch(
        graphs=tuple(graphs), n_pad=n_pad, m_pad=m_pad,
        lanes=lanes, mode=mode, arrays=arrays,
    )


def execute_stacked(
    stacked: StackedBatch, *, device=None
) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """The device half: copy the stack to ``device`` (``None`` = CUDA), run
    the bucket's solver, and unpack the lanes.

    The forest mask and the fragments come back in one device-to-host copy
    and are sliced by lane in NumPy. A kernel that fails to build or launch
    raises; nothing runs again on another path.
    """
    device = resolve_device(device)
    lanes, n_pad, m_pad = stacked.lanes, stacked.n_pad, stacked.m_pad
    solver = _get_solver(n_pad, m_pad, lanes, stacked.mode, device=device)
    mst_ranks, fragment, levels = solver(
        *(torch.from_numpy(a).to(device) for a in stacked.arrays)
    )
    host = torch.cat((mst_ranks, fragment.view(torch.uint8))).cpu().numpy()
    lane_ranks = host[: lanes * m_pad].reshape(lanes, m_pad)
    lane_frag = host[lanes * m_pad:].view(np.int32).reshape(lanes, n_pad)
    out: List[Tuple[np.ndarray, np.ndarray, int]] = []
    for i, g in enumerate(stacked.graphs):
        ranks = np.nonzero(lane_ranks[i])[0]
        edge_ids = np.sort(g.edge_id_of_rank(ranks))
        frag = lane_frag[i, : g.num_nodes] - np.int32(i * n_pad)
        lane_levels = int(levels) if stacked.mode == "fused" else int(levels[i])
        out.append((edge_ids, frag, lane_levels))
    return out


# ----------------------------------------------------------------------
# The batch solve
# ----------------------------------------------------------------------
def solve_lanes(
    graphs: Sequence[Graph],
    *,
    lanes: int | None = None,
    mode: str = "fused",
    device=None,
) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """Solve K same-bucket graphs in one level loop on ``device`` (``None``
    = CUDA).

    Returns one ``(edge_ids, fragment, levels)`` per graph, in order: the
    contract of ``models.boruvka.solve_graph`` (sorted edge ids into
    ``graph.u/v/w``, the fragment trimmed to ``num_nodes``). ``lanes``
    (default ``len(graphs)``) fixes the stacked lane count; extra lanes are
    inert. ``levels`` is the stack's count in ``"fused"`` mode and each
    lane's own in ``"vmap"`` mode.
    """
    if not graphs:
        return []
    return execute_stacked(stack_lanes(graphs, lanes=lanes, mode=mode), device=device)
