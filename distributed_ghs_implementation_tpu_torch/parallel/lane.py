"""ShardedLane: the mesh-sharded solve lane behind the serving scheduler (the
JAX package's ``parallel/lane.py``).

The scheduler routes oversize misses here, past the batch engine's
admission ceiling. Two levers make that worth it:

* **Resident graphs.** A bounded LRU keeps graphs on the mesh: the m-sized
  rank endpoints ``ra``/``rb`` block-sharded onto the shards, the n-sized
  level-1 state replicated beside them. A repeat solve of a resident graph
  moves nothing from the host (``lane.reshard.skipped`` counts these).
* **In-place updates.** An edge insert, delete or reweight on a resident
  graph shifts a rank interval of ``ra``/``rb``. The changed slots are
  written into the resident shards in place (``index_copy_``) under the
  lane's dispatch lock, so no solve reads them mid-update, and the entry
  re-keys under the new digest. Where JAX donates the buffers to a
  scatter, the port writes them in place; where an in-flight solve still
  holds the entry (JAX's non-donating scatter), the update writes fresh
  copies instead and the solve keeps the old ones. An update that dirties
  more than ``max_update_frac`` of the rank space restages in full
  (``lane.restage``).

The port compiles nothing ahead of a run, but the lane keeps JAX's
first-dispatch ledger of program shapes all the same, on the shared
``compile.*`` taxonomy: a shape first dispatched by :meth:`ShardedLane.
precompile` counts ``compile.warmup``, one first dispatched by traffic
``compile.miss``, every repeat ``compile.hit``.

Solves take a ``yield_fn`` called between dispatches (the head, each
capacity-guard level, the finish): the scheduler's priority gate pauses a
bulk solve there while interactive work waits.

The lane runs the plain rank-sharded program (head, capacity-guard levels,
compact / all-gather finish), never the filtered split, whose prefix arrays
would double the resident footprint. Its harvest is one process's; several
serving processes front each with its own lane.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.api import MSTResult
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    _bucket_size,
    _max_levels,
    _next_pow2,
    fetch_mst_edge_ids,
)
from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
    _INT32_RANK_LIMIT,
    host_level1,
)
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.parallel.mesh import EdgeMesh, edge_mesh
from distributed_ghs_implementation_tpu_torch.parallel.rank_sharded import (
    _FINISH_GATHER_MAX_SLOTS,
    _finish,
    _head,
    _sharded_level,
)
from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels

_INT32_MAX = np.iinfo(np.int32).max

#: Default resident-graph LRU capacity. Each entry holds 2 int32 arrays of
#: m_pad over the shards, 2 of n_pad a device, and 2 host m_pad copies.
DEFAULT_CAPACITY = 4

#: Updates dirtying more than this share of the rank space restage in full.
DEFAULT_MAX_UPDATE_FRAC = 0.5

# First-dispatch ledger: one entry per program shape, process wide.
_SEEN_SHAPES: set = set()
_SEEN_LOCK = threading.Lock()


def _note_dispatch(shape_key: tuple, phase: str) -> None:
    """Count a dispatch on the ``compile.*`` taxonomy: a shape's first
    dispatch in this process is ``compile.warmup`` or ``compile.miss`` by
    who paid for it; repeats are ``compile.hit``."""
    with _SEEN_LOCK:
        first = shape_key not in _SEEN_SHAPES
        if first:
            _SEEN_SHAPES.add(shape_key)
    if first:
        BUS.count("lane.compile")
        BUS.count("compile.warmup" if phase == "warmup" else "compile.miss")
    else:
        BUS.count("compile.hit")


def _reset_shape_ledger() -> None:
    """Tests simulate a process restart."""
    with _SEEN_LOCK:
        _SEEN_SHAPES.clear()


@dataclasses.dataclass
class ResidentGraph:
    """One graph resident on the mesh, and the host rank endpoints updates
    diff against."""

    digest: str
    num_nodes: int
    num_edges: int
    n_pad: int
    m_pad: int
    vmin0: List[torch.Tensor]  # replicated, n_pad, a device
    parent1: List[torch.Tensor]  # replicated, n_pad, a device
    ra: List[torch.Tensor]  # block-sharded, m_pad / size a shard
    rb: List[torch.Tensor]
    ra_np: np.ndarray  # host copies: the base updates diff against
    rb_np: np.ndarray


class ShardedLane:
    """Mesh-owning solve lane with a bounded LRU of resident graphs.

    The serving surface mirrors the lane engine's: :meth:`solve_result` /
    :meth:`update_result` return :class:`api.MSTResult`; :meth:`admits` is
    the scheduler's routing predicate. One mesh solve runs at a time (the
    ``_dispatch`` lock); ``max_in_flight`` bounds staging plus solving.
    ``mesh=None`` is :func:`edge_mesh` on ``device`` (``None`` = CUDA).
    ``kernel`` takes ``None`` or the mesh's label (``cuda`` or ``torch``).
    """

    def __init__(
        self,
        mesh: Optional[EdgeMesh] = None,
        *,
        capacity: int = DEFAULT_CAPACITY,
        max_update_frac: float = DEFAULT_MAX_UPDATE_FRAC,
        max_in_flight: int = 2,
        kernel: Optional[str] = None,
        device=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0.0 <= max_update_frac <= 1.0:
            raise ValueError(f"max_update_frac must be in [0, 1], got {max_update_frac}")
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.mesh = mesh if mesh is not None else edge_mesh(device=device)
        self.n_dev = self.mesh.size
        label = "cuda" if self.mesh.kind == "cuda" else "torch"
        if kernel not in (None, label):
            raise ValueError(
                f"kernel {kernel!r} does not run on this mesh; the port runs {label!r} there "
                "and has no other kernel to choose")
        self.kernel = label
        self.capacity = capacity
        self.max_update_frac = max_update_frac
        self._lru: "collections.OrderedDict[str, ResidentGraph]" = collections.OrderedDict()
        self._lock = threading.Lock()  # LRU and in-use bookkeeping
        self._dispatch = threading.Lock()  # one mesh solve or update write at a time
        # Bounds staging as well as solving: staging happens before the
        # dispatch lock, so without it K distinct misses would stage K sets
        # of m-sized arrays at once.
        self._admit = threading.BoundedSemaphore(max_in_flight)
        # digest -> solves holding the entry's tensors (between lookup and
        # the end of the dispatch): an update must not write them in place.
        self._in_use: Dict[str, int] = {}
        # digest -> pin refcount: entries an open stream pins are not
        # evicted under capacity pressure.
        self._pinned: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # Routing predicate
    # ------------------------------------------------------------------
    def pad_shape(self, num_nodes: int, num_edges: int) -> Tuple[int, int]:
        """The padded ``(n_pad, m_pad)`` a graph stages at on this mesh:
        bucket sizes, with the rank width a multiple of ``8 * size`` so that
        every shard block packs to whole bytes."""
        n_pad = _bucket_size(max(1, num_nodes))
        unit = 8 * self.n_dev
        m_pad = int(math.ceil(_bucket_size(max(1, num_edges)) / unit) * unit)
        return n_pad, m_pad

    def admits(self, graph: Graph) -> bool:
        """Can the plain sharded program run this graph? (Past 2^31 ranks
        it needs the split-key program: ``solve_graph_rank_sharded(
        rank64=True)``.)"""
        n_pad, m_pad = self.pad_shape(graph.num_nodes, graph.num_edges)
        return n_pad < _INT32_RANK_LIMIT and m_pad < _INT32_RANK_LIMIT

    # ------------------------------------------------------------------
    # Residency
    # ------------------------------------------------------------------
    def resident_digests(self) -> List[str]:
        with self._lock:
            return list(self._lru)

    def _get_resident(self, digest: str, *, checkout: bool = False) -> Optional[ResidentGraph]:
        with self._lock:
            res = self._lru.get(digest)
            if res is not None:
                self._lru.move_to_end(digest)
                if checkout:
                    self._in_use[digest] = self._in_use.get(digest, 0) + 1
            return res

    def _put_resident(self, res: ResidentGraph, *, checkout: bool = False) -> None:
        with self._lock:
            self._lru[res.digest] = res
            self._lru.move_to_end(res.digest)
            if checkout:
                self._in_use[res.digest] = self._in_use.get(res.digest, 0) + 1
            while len(self._lru) > self.capacity:
                victim = next((d for d in self._lru if not self._pinned.get(d)), None)
                if victim is None:
                    # Every entry is pinned by an open stream: run over
                    # capacity rather than free a pinned graph mid-window.
                    BUS.count("lane.resident.pin_overflow")
                    break
                self._lru.pop(victim)  # dropping the references frees the memory
                BUS.count("lane.resident.evict")

    def _release(self, digest: str) -> None:
        with self._lock:
            n = self._in_use.get(digest, 0) - 1
            if n <= 0:
                self._in_use.pop(digest, None)
            else:
                self._in_use[digest] = n

    def _pop_resident(self, digest: str) -> Tuple[Optional[ResidentGraph], bool]:
        """Remove ``digest``'s entry; also whether an in-flight solve still
        holds its tensors."""
        with self._lock:
            return self._lru.pop(digest, None), self._in_use.get(digest, 0) > 0

    def evict(self, digest: str) -> bool:
        """Drop a resident graph (its memory frees once no in-flight solve
        holds it); whether it was resident. Overrides pins: this is the
        correctness purge, not capacity pressure."""
        res, _ = self._pop_resident(digest)
        return res is not None

    # ------------------------------------------------------------------
    # Stream pinning (stream/session.py holds these for its sessions)
    # ------------------------------------------------------------------
    def pin(self, digest: str) -> bool:
        """Pin ``digest`` against eviction (refcounted; a pin on a digest
        not yet resident arms when it lands). Whether it is resident now."""
        with self._lock:
            self._pinned[digest] = self._pinned.get(digest, 0) + 1
            return digest in self._lru

    def unpin(self, digest: str) -> None:
        with self._lock:
            n = self._pinned.get(digest, 0) - 1
            if n <= 0:
                self._pinned.pop(digest, None)
            else:
                self._pinned[digest] = n

    def pin_count(self, digest: str) -> int:
        with self._lock:
            return self._pinned.get(digest, 0)

    def move_pins(self, old_digest: str, new_digest: str) -> None:
        """Re-key pin refcounts along a digest chain (a stream commit)."""
        if old_digest == new_digest:
            return
        with self._lock:
            n = self._pinned.pop(old_digest, 0)
            if n:
                self._pinned[new_digest] = self._pinned.get(new_digest, 0) + n

    def ensure_resident(self, graph: Graph, *, digest: Optional[str] = None,
                        pin: bool = False) -> bool:
        """Stage ``graph`` into the LRU without solving: the stream replay's
        rebuild, which never pays a mesh solve. Idempotent. Whether the
        graph is resident on return; graphs the lane cannot serve (empty,
        or past the rank envelope) return ``False`` without pinning."""
        if graph.num_nodes == 0 or graph.num_edges == 0:
            return False
        if not self.admits(graph):
            return False
        digest = digest if digest is not None else graph.digest()
        if pin:
            self.pin(digest)
        if self._get_resident(digest) is not None:
            return True
        with self._admit:
            if self._get_resident(digest) is None:
                self._put_resident(self._stage_resident(graph, digest))
                BUS.count("lane.resident.restored")
        return True

    def _level1_state(self, graph: Graph, n_pad: int, ra_np, rb_np):
        n = graph.num_nodes
        vmin0_np = np.full(n_pad, _INT32_MAX, dtype=np.int32)
        vmin0_np[:n] = graph.first_ranks
        parent1_np = host_level1(vmin0_np, ra_np, rb_np)
        return self.mesh.replicate_host(vmin0_np), self.mesh.replicate_host(parent1_np)

    def _stage_resident(self, graph: Graph, digest: str,
                        pad_shape: Optional[Tuple[int, int]] = None) -> ResidentGraph:
        """The cold path: the host's level-1 pass and one staging onto the
        mesh layout. ``pad_shape`` overrides the graph's own padded shape
        (warmup stages a small inert graph at a bucket's shapes)."""
        n = graph.num_nodes
        n_pad, m_pad = pad_shape or self.pad_shape(n, graph.num_edges)
        with BUS.span("lane.stage", cat="lane", nodes=n, edges=graph.num_edges,
                      n_pad=n_pad, m_pad=m_pad, devices=self.n_dev):
            ra_np, rb_np = graph.rank_endpoints(pad_to=m_pad)
            vmin0, parent1 = self._level1_state(graph, n_pad, ra_np, rb_np)
            return ResidentGraph(
                digest=digest, num_nodes=n, num_edges=graph.num_edges, n_pad=n_pad,
                m_pad=m_pad, vmin0=vmin0, parent1=parent1,
                ra=self.mesh.shard_host(ra_np), rb=self.mesh.shard_host(rb_np),
                ra_np=ra_np, rb_np=rb_np,
            )

    # ------------------------------------------------------------------
    # Solve
    # ------------------------------------------------------------------
    def solve(
        self,
        graph: Graph,
        *,
        yield_fn: Optional[Callable[[], None]] = None,
        phase: str = "request",
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Solve on the mesh: ``(edge_ids, fragment, levels)``, the
        ``solve_graph`` contract, edge for edge every backend's. A resident
        graph moves nothing from the host."""
        n = graph.num_nodes
        if n == 0 or graph.num_edges == 0:
            return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0
        if not self.admits(graph):
            raise ValueError("graph exceeds the lane's int32 rank envelope; use "
                             "solve_graph_rank_sharded(rank64=True)")
        digest = graph.digest()
        with self._admit:
            res = self._get_resident(digest, checkout=True)
            resident_hit = res is not None
            if resident_hit:
                BUS.count("lane.resident.hit")
                BUS.count("lane.reshard.skipped")
            else:
                BUS.count("lane.resident.miss")
                res = self._stage_resident(graph, digest)
                self._put_resident(res, checkout=True)
            try:
                # A kernel that fails raises: the lane has no other kernel.
                return self._dispatch_solve(res, graph, yield_fn=yield_fn, phase=phase,
                                            resident=resident_hit)
            finally:
                self._release(digest)

    def _dispatch_solve(
        self,
        res: ResidentGraph,
        graph: Graph,
        *,
        yield_fn: Optional[Callable[[], None]] = None,
        phase: str = "request",
        resident: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The plain rank-sharded program over resident tensors: the head,
        the capacity-guard levels, the compact / all-gather finish, with
        ``yield_fn`` between dispatches."""
        mesh = self.mesh
        n_pad, m_pad = res.n_pad, res.m_pad
        kern = self.kernel

        def checkpoint():
            if yield_fn is not None:
                yield_fn()

        with self._dispatch, BUS.span(
            "lane.solve", cat="lane", nodes=graph.num_nodes, edges=graph.num_edges,
            devices=self.n_dev, resident=resident,
        ) as span:
            _note_dispatch(("head", n_pad, m_pad, self.n_dev, kern, mesh), phase)
            fragment, mst, fa, fb, lv, total, cmax = _head(mesh, res.vmin0, res.parent1,
                                                           res.ra, res.rb)
            checkpoint()
            while total > 0 and self.n_dev * _bucket_size(cmax) > _FINISH_GATHER_MAX_SLOTS:
                _note_dispatch(("level", n_pad, m_pad, self.n_dev, kern, mesh), phase)
                fragment, fa, fb, total, cmax, progressed = _sharded_level(
                    mesh, fragment, mst, fa, fb, False)
                lv += 1
                if not progressed:
                    break  # an isolated remainder (disconnected pads)
                checkpoint()
            if total > 0:
                fs_local = self._finish_width(m_pad, cmax)
                max_levels = _max_levels(n_pad)
                _note_dispatch(("finish", n_pad, m_pad, fs_local, max_levels, self.n_dev,
                                kern, mesh), phase)
                fragment, extra = _finish(mesh, fragment, mst, fa, fb, fs_local, max_levels,
                                          False)
                lv += extra
            checkpoint()
            home = mst[0].device
            edge_ids = fetch_mst_edge_ids(graph, torch.cat([m.to(home) for m in mst]))
            span.set(levels=lv)
        return edge_ids, fragment[0][: graph.num_nodes].cpu().numpy(), lv

    def _finish_width(self, m_pad: int, cmax: int) -> int:
        """The finish's compact width, pinned to the shard-width bucket
        (capped by the gather budget), so that every graph of a bucket
        shares one finish shape and :meth:`precompile` covers it. Past the
        budget it falls back to the measured survivor bucket."""
        spec = min(max(_bucket_size(m_pad // self.n_dev), 1024),
                   _FINISH_GATHER_MAX_SLOTS // self.n_dev)
        if cmax <= spec:
            return spec
        BUS.count("lane.finish.overflow")
        return max(_bucket_size(cmax), 1024)

    # ------------------------------------------------------------------
    # In-place incremental update
    # ------------------------------------------------------------------
    def refresh_resident(self, old_digest: str, new_graph: Graph) -> bool:
        """Move ``old_digest``'s residency to ``new_graph``: the changed rank
        slots are written into the resident ``ra``/``rb`` shards and the
        entry re-keys under the new digest. No solve runs; the next solve of
        the new digest moves nothing from the host.

        ``True`` when residency now covers ``new_graph``. An update that
        changes the padded shape drops the entry (``lane.update.dropped``);
        one that dirties more than ``max_update_frac`` of the rank space
        restages in full (``lane.restage``).
        """
        n = new_graph.num_nodes
        n_pad, m_pad = self.pad_shape(n, new_graph.num_edges)
        digest = new_graph.digest()
        # Pins follow the chain on every outcome, a drop included.
        self.move_pins(old_digest, digest)
        res, busy = self._pop_resident(old_digest)
        if res is None:
            return False
        if (res.n_pad, res.m_pad) != (n_pad, m_pad) or res.num_nodes != n:
            BUS.count("lane.update.dropped")
            return False

        new_ra, new_rb = new_graph.rank_endpoints(pad_to=m_pad)
        changed = np.nonzero((new_ra != res.ra_np) | (new_rb != res.rb_np))[0]
        frac = changed.size / max(1, m_pad)
        BUS.record("lane.update.changed_frac", frac)
        if frac > self.max_update_frac:
            BUS.count("lane.restage")
            with self._admit:
                self._put_resident(self._stage_resident(new_graph, digest))
            return True

        with BUS.span("lane.update", cat="lane", changed=int(changed.size), m_pad=m_pad,
                      devices=self.n_dev):
            if changed.size:
                # 1024-slot floor: single-edge updates share one shape a
                # bucket, which precompile() warms.
                bucket = max(1024, _next_pow2(int(changed.size)))
                _note_dispatch(("scatter", m_pad, bucket, not busy, self.n_dev, self.mesh),
                               "request")
                with self._dispatch:
                    ra = self._write_slots(res.ra, changed, new_ra[changed], in_place=not busy)
                    rb = self._write_slots(res.rb, changed, new_rb[changed], in_place=not busy)
            else:
                ra, rb = res.ra, res.rb
            # The n-sized level-1 state re-derives on the host and restages.
            vmin0, parent1 = self._level1_state(new_graph, n_pad, new_ra, new_rb)
            fresh = ResidentGraph(
                digest=digest, num_nodes=n, num_edges=new_graph.num_edges, n_pad=n_pad,
                m_pad=m_pad, vmin0=vmin0, parent1=parent1, ra=ra, rb=rb,
                ra_np=new_ra, rb_np=new_rb,
            )
        self._put_resident(fresh)
        BUS.count("lane.update.donated")
        return True

    def _write_slots(self, shards: List[torch.Tensor], slots: np.ndarray, values: np.ndarray,
                     *, in_place: bool) -> List[torch.Tensor]:
        """Write ``values`` at global rank ``slots`` into the block-sharded
        ``shards``: in place (``index_copy_``), or, while an in-flight solve
        holds the shards, into fresh copies that leave the old ones intact.
        Each local shard takes the slots of its own block."""
        width = shards[0].shape[0]
        out = []
        for j, shard in enumerate(shards):
            lo = self.mesh.axis_index(j) * width
            sel = (slots >= lo) & (slots < lo + width)
            target = shard if in_place else shard.clone()
            if sel.any():
                idx = torch.from_numpy((slots[sel] - lo).astype(np.int64)).to(shard.device)
                val = torch.from_numpy(values[sel].astype(np.int32)).to(shard.device)
                target.index_copy_(0, idx, val)
            out.append(target)
        return out

    def update(
        self,
        old_digest: str,
        new_graph: Graph,
        *,
        yield_fn: Optional[Callable[[], None]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Re-solve ``new_graph`` from ``old_digest``'s residency: the
        in-place refresh, then the (now resident) solve."""
        self.refresh_resident(old_digest, new_graph)
        return self.solve(new_graph, yield_fn=yield_fn)

    # ------------------------------------------------------------------
    # MSTResult surface (what the serving scheduler consumes)
    # ------------------------------------------------------------------
    def solve_result(self, graph: Graph, *,
                     yield_fn: Optional[Callable[[], None]] = None) -> MSTResult:
        t0 = time.perf_counter()
        edge_ids, fragment, levels = self.solve(graph, yield_fn=yield_fn)
        return self._wrap(graph, edge_ids, fragment, levels, t0)

    def update_result(self, old_digest: str, new_graph: Graph, *,
                      yield_fn: Optional[Callable[[], None]] = None) -> MSTResult:
        t0 = time.perf_counter()
        edge_ids, fragment, levels = self.update(old_digest, new_graph, yield_fn=yield_fn)
        return self._wrap(new_graph, edge_ids, fragment, levels, t0)

    @staticmethod
    def _wrap(graph, edge_ids, fragment, levels, t0) -> MSTResult:
        return MSTResult(
            graph=graph, edge_ids=edge_ids, num_levels=levels,
            wall_time_s=time.perf_counter() - t0, backend="sharded_lane",
            num_components=count_labels(fragment) if graph.num_nodes else 0,
        )

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------
    def precompile(self, num_nodes: int, num_edges: int) -> dict:
        """Warm one bucket ahead of traffic: solve an inert graph padded into
        the bucket through the request path (its shapes count
        ``compile.warmup``), never putting it in the LRU. The finish width
        is pinned a bucket (:meth:`_finish_width`), so the warm graph and
        every real graph of the bucket share one finish shape below the
        gather budget."""
        n_pad, m_pad = self.pad_shape(num_nodes, num_edges)
        # A path whose weights cycle [1, 100, 1, 50] pairs up locally, so
        # alive edges survive the head and the finish runs too.
        k = int(min(num_nodes, 32))
        if k < 2 or num_edges < k - 1:
            k = max(2, min(num_nodes, num_edges + 1))
        cycle = (1, 100, 1, 50)
        warm = Graph.from_edges(num_nodes, [(i, i + 1, cycle[i % 4] * (i + 1))
                                            for i in range(k - 1)])
        res = self._stage_resident(warm, warm.digest(), pad_shape=(n_pad, m_pad))
        self._dispatch_solve(res, warm, phase="warmup", resident=False)
        # The update's write at its floor width: a single-edge update on
        # this bucket then counts no compile.miss.
        _note_dispatch(("scatter", m_pad, 1024, True, self.n_dev, self.mesh), "warmup")
        with self._dispatch:
            self._write_slots(res.ra, np.zeros(0, dtype=np.int64), np.zeros(0, np.int32),
                              in_place=True)
        return {"bucket": (n_pad, m_pad), "devices": self.n_dev, "kernel": self.kernel}
