"""The graph query service: a JSONL request/response loop over the serve stack.

Port of the JAX package's ``serve/service.py``: the same protocol, op by
op, over JSONL (:func:`serve_loop`) and over B-frames (:func:`serve_frames`),
answered on one explicit device (``MSTService(device=None)`` means CUDA and
raises without it; tests pass ``device="cpu"``). Every layer under it gets
that device: the scheduler, the batch engine, update sessions, streams,
the verifier's ``torch`` certify engine, warmup and the sharded lane
(``sharded_lane=True`` or a shard count: a ``parallel.lane.ShardedLane``
over ``edge_mesh`` on the service's device). Where the port differs on
purpose: store keys carry the port's backend token (``serve/store.py``);
``stats`` counts the port's ``compile.kernel.cuda|torch`` where the JAX
package counts its kernels.

One JSON object per input line, one JSON response line per request — a
protocol a test, the chaos drill, or a thin network front-end can all drive
(a caller wires it to stdin/stdout). The full protocol, op by op:

* ``{"op": "solve", "num_nodes": N, "edges": [[u, v, w], ...]}`` — or
  ``{"op": "solve", "graph_path": "graph.npz"}`` — optional ``"backend"``,
  ``"edges_out": true`` to include the answer's edge list in the response,
  ``"cached_only": true`` to probe this host's cache by ``"digest"`` alone
  (the fleet router's forwarding probe — a miss answers ``{"ok": false,
  "cache_miss": true}`` without solving). Response carries the graph
  ``digest`` (the handle updates key on) and ``source``: ``"cache"`` /
  ``"coalesced"`` / ``"solved"``.

  An optional ``"kind"`` field selects the analytics query kind
  (``analytics/kinds.py``) — every kind runs the same
  GHS level loop and caches under a per-kind digest key:

  - ``{"op": "solve", "kind": "mst", ...}`` — the default; the minimum
    spanning forest.
  - ``{"op": "solve", "kind": "components", ...}`` — connected components
    via the weight-free solve; response adds exact ``num_components`` and,
    with ``"labels_out": true``, the per-node ``labels`` array.
  - ``{"op": "solve", "kind": "k_msf", "k": 3, ...}`` — the optimal
    ``k``-forest (lightest ``n - max(k, c)`` MSF edges); response echoes
    ``k``.
  - ``{"op": "solve", "kind": "bottleneck", ...}`` — minimum bottleneck
    spanning value; response adds ``bottleneck_weight`` +
    ``bottleneck_edge``.
  - ``{"op": "solve", "kind": "path_max", "u": 0, "v": 7, ...}`` — the
    minimax (bottleneck-optimal) edge between two nodes; response adds
    ``connected``, ``path_max_weight``, ``path_max_edge``.

* ``{"op": "update", "digest": "...", "updates": [{"kind": "insert",
  "u": 1, "v": 2, "w": 5}, {"kind": "delete", "u": 3, "v": 4}, ...]}`` —
  incremental maintenance against the session for ``digest``; the response
  carries the *new* digest (sessions re-key content-addressed) and ``mode``
  (``"incremental"`` or ``"resolve"``).
* ``{"op": "subscribe", "digest": "..."}`` (or ``"stream": id`` to resume)
  — pin a long-lived stream to a solved graph; the response carries the
  ``stream`` id, current head ``digest``, and head ``seq``
  (``stream/session.py``).
* ``{"op": "publish", "stream": id, "digest": head, "updates": [...]}`` —
  commit one update window against the stream head: coalesced, applied in
  one batched pass, appended to the durable log, and notified. The
  response carries the new head ``digest`` + ``prev_digest`` (the fleet
  router follows the chain) and the window's MST-change ``notification``.
  A stale head fails with ``"stale": true`` plus the current head/seq.
* ``{"op": "poll", "stream": id, "after_seq": N}`` — drain MST-change
  notifications with ``seq > N`` (edges entered/left the forest, weight
  delta — gapless, duplicate-free, failover-surviving sequence numbers).
* ``{"op": "stats"}`` — serve counters from the ``obs`` bus + store stats.
* ``{"op": "shutdown"}`` — acknowledge and end the loop (EOF also ends it).

Every request may carry ``"slo_class"`` (per-class latency accounting and
verify policy, ``obs/slo.py``); a ``kind`` query without one lands in its
kind's default class. Errors never kill the loop: a malformed line or a
failed request produces ``{"ok": false, "error": ...}`` and the loop reads
on.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import IO, Optional

from distributed_ghs_implementation_tpu_torch.api import MSTResult
from distributed_ghs_implementation_tpu_torch.batch.lanes import bucket_of
from distributed_ghs_implementation_tpu_torch.batch.warmup import warmable_single
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.fleet.framing import (
    SECTIONS_KEY,
    FrameError,
    WireSections,
    encode_bframe,
    encode_frame,
    fold_sections,
    frame_sections,
    read_frame,
)
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import (
    default_class_for_kind,
    sanitize_class,
    tagged_class,
    tagged_kind,
)
from distributed_ghs_implementation_tpu_torch.serve.dynamic import DynamicMST
from distributed_ghs_implementation_tpu_torch.serve.scheduler import SolveScheduler
from distributed_ghs_implementation_tpu_torch.serve.store import (
    ResultStore,
    cache_key_for_digest,
    solve_cache_key,
)

_MAX_SESSIONS = 32  # update handles retained (LRU); results outlive them

#: The protocol's op set — the dispatch table and the unknown-op error both
#: derive from this one tuple so the message can never drift out of date
#: again (it once predated several ops).
_OPS = ("solve", "update", "subscribe", "publish", "poll", "stats",
        "shutdown")


class MSTService:
    """Request handler: solve through the scheduler, update through
    per-digest :class:`DynamicMST` sessions, everything cached in the store,
    all on ``device`` (``None`` = CUDA)."""

    def __init__(
        self,
        *,
        backend: str = "device",
        store: Optional[ResultStore] = None,
        store_capacity: int = 128,
        disk_dir: Optional[str] = None,
        max_concurrent: int = 2,
        resolve_threshold: Optional[int] = None,
        max_sessions: int = _MAX_SESSIONS,
        batch_lanes: int = 0,
        batch_wait_s: Optional[float] = None,
        warmup=None,
        sharded_lane=False,
        stream_dir: Optional[str] = None,
        stream_snapshot_every: int = 8,
        stream_window_mode: str = "batched",
        max_streams: Optional[int] = None,
        verify=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.store = store if store is not None else ResultStore(
            capacity=store_capacity, disk_dir=disk_dir
        )
        # batch_lanes > 0 attaches the lane engine: device-backend cache
        # misses coalesce into multi-graph batches (batch/engine.py).
        engine = None
        if batch_lanes > 0:
            from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
            from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy

            # batch_wait_s widens the forming window for lane-mates (wider
            # than the 2 ms default, open-loop burst arrivals share lanes).
            policy_kwargs = {"max_lanes": batch_lanes}
            if batch_wait_s is not None:
                policy_kwargs["max_wait_s"] = batch_wait_s
            engine = BatchEngine(
                policy=BatchPolicy(**policy_kwargs), device=self.device
            )
        # sharded_lane opens the oversize route: device-backend misses past
        # the batch admission ceiling run on a mesh (parallel/lane.py:
        # resident LRU, in-place updates) instead of bypassing to the
        # single-device path. True = one shard a visible card (one on the
        # CPU); an int = that many shards.
        lane = None
        if sharded_lane:
            from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane
            from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

            num = None if sharded_lane is True else int(sharded_lane)
            lane = ShardedLane(edge_mesh(num_shards=num, device=self.device))
        self.sharded_lane = lane
        self.scheduler = SolveScheduler(
            self.store, backend=backend, max_concurrent=max_concurrent,
            batch_engine=engine, sharded_lane=lane, device=self.device,
        )
        self.backend = backend
        self.resolve_threshold = resolve_threshold
        self.max_sessions = max_sessions
        # Subscription streams (stream/): long-lived windowed sessions with
        # a durable log under stream_dir (shared across fleet workers, so a
        # restarted worker replays instead of re-solving). The full-resolve
        # escape hatch routes through the scheduler — cached, supervised,
        # single-flighted — and window commits register with the priority
        # gate. Deferred import: the stream package reaches serve/__init__
        # (window -> serve.dynamic), which imports this module — a
        # top-level import here deadlocks that chain when stream loads
        # first.
        from distributed_ghs_implementation_tpu_torch.stream.session import (
            StreamManager,
        )

        # Result verification: an off|sample|full policy per SLO class.
        # ``full`` classes certify inline with transparent correction (the
        # poisoned entry leaves store and sessions, the graph re-solves
        # fresh, the corrected answer is the one served); ``sample``
        # classes ride the async audit thread. ``verify`` accepts a spec string or a
        # prebuilt verify.policy.VerifyPolicy. Inline checks run the
        # policy's engine (``torch`` by default) on this service's device.
        self.verifier = None
        if verify:
            from distributed_ghs_implementation_tpu_torch.verify.policy import (
                ResultVerifier,
                VerifyPolicy,
            )

            policy = VerifyPolicy.parse(verify)
            if policy.enabled:
                self.verifier = ResultVerifier(
                    policy,
                    invalidate=self._invalidate_entry,
                    resolve=self._fresh_resolve,
                    device=self.device,
                )
        stream_kwargs = {}
        if max_streams is not None:
            stream_kwargs["max_streams"] = max_streams
        self.streams = StreamManager(
            root=stream_dir,
            snapshot_every=stream_snapshot_every,
            backend=backend,
            resolve_threshold=resolve_threshold,
            window_mode=stream_window_mode,
            solver=lambda g: self.scheduler.solve(g, backend=backend)[0],
            interactive_gate=self.scheduler.interactive,
            # The sharded streams: oversize streams keep their heads
            # resident on the mesh (pinned, in-place window writes, replay
            # re-staging) and their post-window heads audited
            # (stream/session.py).
            lane=lane,
            verifier=self.verifier,
            device=self.device,
            **stream_kwargs,
        )
        # digest -> DynamicMST (materialized by an update) or a lightweight
        # (result, backend) seed (parked by a solve).
        self._sessions: "collections.OrderedDict[str, object]" = (
            collections.OrderedDict()
        )
        # Shape buckets traffic actually hit (insertion-ordered) — the
        # warmup record's input, so even a no-batch-engine serve records
        # what a restart should warm (single-graph kernels).
        self.seen_buckets: "collections.OrderedDict[tuple, None]" = (
            collections.OrderedDict()
        )
        # Warmup phase: precompile the declared buckets BEFORE the first
        # request, so a pre-declared bucket's first query runs against an
        # already-built solver (compile.warmup vs compile.miss on the bus
        # tells warm from cold).
        self.warmup_report = None
        if warmup is not None:
            from distributed_ghs_implementation_tpu_torch.batch.warmup import (
                WarmupPlan,
                run_warmup,
            )

            if not isinstance(warmup, WarmupPlan):
                raise TypeError(
                    f"warmup must be a batch.warmup.WarmupPlan, got "
                    f"{type(warmup).__name__}"
                )
            # Normalize the plan to THIS service's lane geometry: replayed
            # keys recorded at a different --batch-lanes (or declared bare
            # shape buckets) must warm the solvers this process actually
            # dispatches — otherwise the first query pays a request-time
            # compile despite warmup "succeeding".
            shapes = tuple(dict.fromkeys(
                tuple(warmup.buckets)
                + tuple((n, m) for n, m, _, _ in warmup.keys)
            ))
            warmup = dataclasses.replace(
                warmup, buckets=shapes, keys=(), lanes=batch_lanes,
                mode=engine.policy.mode if engine else "fused",
            )
            # Mesh-shaped buckets warm on the sharded lane; without a lane
            # they are skipped, as oversize shape buckets skip the fused
            # warm.
            self.warmup_report = run_warmup(warmup, lane=lane, device=self.device)

    # ------------------------------------------------------------------
    def handle(self, request: dict) -> dict:
        # Deferred for the same serve <-> stream import cycle as the
        # StreamManager import in __init__ — by the first request both
        # packages are fully loaded, so this is a sys.modules lookup.
        from distributed_ghs_implementation_tpu_torch.stream.session import (
            StaleDigest,
        )

        op = request.get("op")
        # Analytics query kind: "mst" (the historical default) unless the
        # solve names another registered kind. Counted per kind
        # (serve.kind.<kind>) and propagated context-scoped (tagged_kind)
        # so the batch engine keeps forming lanes kind-homogeneous.
        kind = str(request.get("kind", "mst")) if op == "solve" else None
        # SLO class tag: clients label each query ("hit"/"miss"/"update"/
        # ...); the label rides the serve.request span args (what
        # obs.slo joins per-class reports from) AND the thread-scoped
        # tagged_class context, so nested layers (scheduler serve.solve
        # spans, the batch engine's queue-wait histograms) attribute their
        # telemetry to the same class without any API threading. A kind
        # query without an explicit class falls into its kind's default
        # class (obs.slo.KIND_CLASS_DEFAULTS) — mst stays untagged.
        cls = sanitize_class(request.get("slo_class"))
        if cls is None and kind is not None:
            cls = default_class_for_kind(kind)
        span_args = {"op": str(op)}
        if kind is not None and kind != "mst":
            span_args["kind"] = kind
        if cls is not None:
            span_args["cls"] = cls
        with tagged_class(cls), tagged_kind(kind), tracing.front_door(
            cls
        ), BUS.span("serve.request", cat="serve", **span_args) as span:
            BUS.count("serve.requests")
            try:
                if op == "solve":
                    from distributed_ghs_implementation_tpu_torch import (
                        analytics,
                    )

                    # Unknown kinds raise the registry's ValueError before
                    # any solving; known kinds count per kind.
                    analytics.get(kind)
                    BUS.count(f"serve.kind.{kind}")
                    response = self._handle_solve(request)
                elif op == "update":
                    response = self._handle_update(request)
                elif op == "subscribe":
                    response = self._handle_subscribe(request)
                elif op == "publish":
                    response = self._handle_publish(request)
                elif op == "poll":
                    response = self._handle_poll(request)
                elif op == "stats":
                    response = self._handle_stats()
                elif op == "shutdown":
                    response = {"ok": True, "op": "shutdown"}
                else:
                    raise ValueError(
                        f"unknown op {op!r}; expected {'|'.join(_OPS)}"
                    )
            except StaleDigest as e:
                # Not an error so much as a re-sync point: the client's
                # head lost a race (or a failover replayed past it); the
                # response carries the current head so it can catch up
                # without re-solving.
                response = {
                    "ok": False, "op": op, "stale": True,
                    "error": f"StaleDigest: {e}",
                    "stream": e.stream_id, "digest": e.head, "seq": e.seq,
                }
            except Exception as e:  # noqa: BLE001 — the loop must survive
                BUS.count("serve.errors")
                response = {
                    "ok": False, "op": op, "error": f"{type(e).__name__}: {e}",
                }
            span.set(ok=bool(response.get("ok")))
            source = response.get("source") or response.get("mode")
            if source:
                span.set(source=source)
            if cls is not None:
                response.setdefault("slo_class", cls)
            return response

    # -- verification hooks ---------------------------------------------
    def _invalidate_entry(self, key: Optional[str], digest: str) -> None:
        """Purge a certificate-failing result EVERYWHERE it could be
        served from again: store memory + disk (quarantined), the parked
        update-session seed (it aliases the same arrays), and any mesh
        residency for the digest."""
        if key is not None:
            self.store.invalidate(key, reason="certificate failed")
        entry = self._sessions.get(digest)
        if entry is not None and not isinstance(entry, DynamicMST):
            del self._sessions[digest]
        if self.sharded_lane is not None:
            self.sharded_lane.evict(digest)

    def _fresh_resolve(self, graph: Graph, backend: str) -> MSTResult:
        """The correction re-solve: by the time this runs the poisoned
        entry is invalidated, so the scheduler misses and solves fresh
        (supervised, single-flighted — the normal miss machinery)."""
        result, _source = self.scheduler.solve(graph, backend=backend)
        return result

    # ------------------------------------------------------------------
    def _handle_solve(self, request: dict) -> dict:
        if request.get("cached_only"):
            return self._handle_cached_probe(request)
        kind = str(request.get("kind", "mst"))
        if kind != "mst":
            return self._handle_analytics(request, kind)
        graph = self._load_graph(request)
        backend = request.get("backend", self.backend)
        bucket = bucket_of(graph.num_nodes, graph.num_edges)
        if warmable_single(*bucket):
            # Oversize buckets route to the rank solver, not the fused
            # kernel warmup compiles — recording them would make replay
            # pay boot-time compiles no request ever hits.
            self.seen_buckets[bucket] = None
        result, source = self.scheduler.solve(graph, backend=backend)
        digest = graph.digest()
        verified = None
        if self.verifier is not None:
            # Per-policy certification of EVERY solve answer — cache hits
            # included (a bit-rotted or memory-corrupted cached result is
            # precisely what nothing upstream can notice). A failed
            # inline certificate is corrected transparently; the client
            # sees only the corrected result (+ the verify.* counters).
            result, verified = self.verifier.check(
                result,
                cls=sanitize_class(request.get("slo_class")),
                key=solve_cache_key(graph, backend=backend),
                backend=backend,
            )
        self._remember(digest, result, backend)
        out = {
            "ok": True,
            "op": "solve",
            "digest": digest,
            "source": source,
            "cached": source != "solved",
        }
        if verified is not None:
            out["verified"] = verified
        out.update(self._result_fields(result, request))
        return out

    def _handle_analytics(self, request: dict, kind: str) -> dict:
        """A non-``mst`` solve: dispatch through the analytics registry.

        Every kind rides the normal scheduler path (single-flight dedup,
        admission, batch lanes, supervision) —
        ``components`` by solving the graph's index-weighted twin, the
        rest by deriving from the graph's own MSF (which therefore shares
        the ``mst`` cache entry; cross-kind affinity is deliberate).
        Cacheable kinds store under their per-kind digest key, and — like
        the mst path — every *served* answer is certified per policy with
        the kind's own adapter, corrected transparently on failure.
        """
        from distributed_ghs_implementation_tpu_torch import analytics
        from distributed_ghs_implementation_tpu_torch.analytics import (
            solvers as asolvers,
        )
        from distributed_ghs_implementation_tpu_torch.verify.certify import (
            certify_components,
            certify_k_forest,
        )

        params = analytics.parse_params(kind, request)
        graph = self._load_graph(request)
        backend = request.get("backend", self.backend)
        digest = graph.digest()
        cls = sanitize_class(request.get("slo_class"))
        if cls is None:
            cls = analytics.get(kind).slo_class
        bucket = bucket_of(graph.num_nodes, graph.num_edges)
        if warmable_single(*bucket):
            self.seen_buckets[bucket] = None

        def solve(g):
            return self.scheduler.solve(g, backend=backend)

        token = analytics.cache_token(kind, k=params.get("k"))
        kind_key = (
            cache_key_for_digest(digest, backend=backend, kind=token)
            if token is not None else None
        )
        mst_key = cache_key_for_digest(digest, backend=backend)
        verified = None
        extra: dict = {}

        if kind == "components":
            result = self.store.get(kind_key, graph)
            source = "cache"
            if result is None:
                result, source = asolvers.solve_components(graph, solve)
                self.store.put(kind_key, result)
            if self.verifier is not None:
                def _rederive_components() -> MSTResult:
                    # The poison may live in the connectivity twin's own
                    # cache entry — purge it so the re-solve is honest.
                    twin = asolvers.connectivity_graph(graph)
                    self.store.invalidate(
                        solve_cache_key(twin, backend=backend),
                        reason="kind rederive",
                    )
                    fresh, _src = asolvers.solve_components(graph, solve)
                    self.store.put(kind_key, fresh)
                    return fresh

                result, verified = self.verifier.check(
                    result, cls=cls, key=kind_key, backend=backend,
                    certify=lambda r, engine: certify_components(
                        r.graph, r.edge_ids, engine=engine,
                        expect_components=r.num_components,
                        device=self.device,
                    ),
                    rederive=_rederive_components,
                )
            if request.get("labels_out"):
                labels = asolvers.labels_for_forest(result)
                if SECTIONS_KEY in request:
                    extra[SECTIONS_KEY] = WireSections().add(
                        "labels", labels
                    )
                else:
                    extra["labels"] = labels.tolist()
        elif kind == "k_msf":
            k = params["k"]
            result = self.store.get(kind_key, graph)
            source = "cache"
            if result is None:
                result, source, full = asolvers.solve_k_msf(graph, solve, k)
                self._remember(digest, full, backend)
                self.store.put(kind_key, result)
            if self.verifier is not None:
                def _rederive_k_msf() -> MSTResult:
                    # Trimming is local; a bad k-forest implicates the
                    # underlying MSF entry, so purge that too.
                    self.store.invalidate(mst_key, reason="kind rederive")
                    fresh, _src, full = asolvers.solve_k_msf(
                        graph, solve, k
                    )
                    self._remember(digest, full, backend)
                    self.store.put(kind_key, fresh)
                    return fresh

                result, verified = self.verifier.check(
                    result, cls=cls, key=kind_key, backend=backend,
                    certify=lambda r, engine: certify_k_forest(
                        r.graph, r.edge_ids, k, engine=engine,
                        device=self.device,
                    ),
                    rederive=_rederive_k_msf,
                )
            extra["k"] = k
        else:
            # bottleneck / path_max: scalar reductions over the graph's
            # own (certified) MSF — never separately store-cached; the
            # shared mst entry is the cache.
            result, source = solve(graph)
            if self.verifier is not None:
                result, verified = self.verifier.check(
                    result, cls=cls, key=mst_key, backend=backend,
                )
            self._remember(digest, result, backend)
            if kind == "bottleneck":
                bn = asolvers.bottleneck_of(result)
                extra["bottleneck_weight"] = None if bn is None else bn[0]
                extra["bottleneck_edge"] = (
                    None if bn is None else [bn[1], bn[2]]
                )
            else:  # path_max
                ans = asolvers.path_max_of(result, params["u"], params["v"])
                extra.update({
                    "u": params["u"], "v": params["v"],
                    "connected": ans["connected"],
                    "path_max_weight": ans["weight"],
                    "path_max_edge": (
                        None if ans["edge"] is None else list(ans["edge"])
                    ),
                })

        out = {
            "ok": True,
            "op": "solve",
            "kind": kind,
            "digest": digest,
            "source": source,
            "cached": source != "solved",
        }
        if verified is not None:
            out["verified"] = verified
        out.update(self._result_fields(result, request))
        self._merge_fields(out, extra)
        return out

    def _handle_cached_probe(self, request: dict) -> dict:
        """A ``cached_only`` solve: answer from the store (memory LRU, or
        this host's disk layer) by digest alone — never solve. This is the
        fleet router's cross-host forwarding probe: the frame carries only
        the digest (no edge list), so a hit ships one cached result over
        the wire and a miss costs a single tiny round trip before the
        dispatch target solves locally.

        Probes are kind-aware: a ``kind`` probe answers from its own
        per-kind key (never the mst entry — kind-correctness is the whole
        point of the per-kind keys), and the derived kinds (``k_msf``,
        ``bottleneck``, ``path_max``) additionally fall back to *deriving*
        from the cached mst entry — O(tree) host work, honoring the
        never-solve contract."""
        digest = request.get("digest")
        if not digest:
            raise ValueError("cached_only solve needs a digest")
        kind = str(request.get("kind", "mst"))
        backend = request.get("backend", self.backend)
        if kind != "mst":
            return self._kind_probe(request, kind, str(digest), backend)
        result = self.store.get(
            cache_key_for_digest(str(digest), backend=backend),
            record_miss=False,
        )
        BUS.count("serve.probe.hit" if result is not None
                  else "serve.probe.miss")
        if result is None:
            # Not an error: the probing router falls back to a local
            # solve, so this must not land in serve.errors.
            return {"ok": False, "op": "solve", "digest": digest,
                    "cache_miss": True,
                    "error": f"cache_miss: {digest} not cached here"}
        out = {
            "ok": True,
            "op": "solve",
            "digest": digest,
            "source": "cache",
            "cached": True,
        }
        out.update(self._result_fields(result, request))
        return out

    def _kind_probe(
        self, request: dict, kind: str, digest: str, backend: str
    ) -> dict:
        """The non-``mst`` arm of :meth:`_handle_cached_probe`."""
        from distributed_ghs_implementation_tpu_torch import analytics
        from distributed_ghs_implementation_tpu_torch.analytics import (
            solvers as asolvers,
        )

        params = analytics.parse_params(kind, request)
        token = analytics.cache_token(kind, k=params.get("k"))
        extra: dict = {}
        result = None
        if token is not None:
            result = self.store.get(
                cache_key_for_digest(digest, backend=backend, kind=token),
                record_miss=False,
            )
        if result is None and kind in ("k_msf", "bottleneck", "path_max"):
            # Derivable kinds: a cached mst entry answers without solving.
            # components is NOT derived here — its canonical cache entry is
            # the connectivity forest, and a probe must never plant a
            # different edge set under the kind key.
            mst_cached = self.store.get(
                cache_key_for_digest(digest, backend=backend),
                record_miss=False,
            )
            if mst_cached is not None:
                if kind == "k_msf":
                    result = asolvers.trim_to_k_forest(
                        mst_cached, params["k"]
                    )
                    self.store.put(
                        cache_key_for_digest(
                            digest, backend=backend, kind=token
                        ),
                        result,
                        memory_only=True,
                    )
                else:
                    result = mst_cached
        BUS.count("serve.probe.hit" if result is not None
                  else "serve.probe.miss")
        if result is None:
            return {"ok": False, "op": "solve", "kind": kind,
                    "digest": digest, "cache_miss": True,
                    "error": f"cache_miss: {digest} ({kind}) "
                             f"not cached here"}
        if kind == "k_msf":
            extra["k"] = params["k"]
        elif kind == "bottleneck":
            bn = asolvers.bottleneck_of(result)
            extra["bottleneck_weight"] = None if bn is None else bn[0]
            extra["bottleneck_edge"] = None if bn is None else [bn[1], bn[2]]
        elif kind == "path_max":
            ans = asolvers.path_max_of(result, params["u"], params["v"])
            extra.update({
                "u": params["u"], "v": params["v"],
                "connected": ans["connected"],
                "path_max_weight": ans["weight"],
                "path_max_edge": (
                    None if ans["edge"] is None else list(ans["edge"])
                ),
            })
        elif kind == "components" and request.get("labels_out"):
            labels = asolvers.labels_for_forest(result)
            if SECTIONS_KEY in request:
                extra[SECTIONS_KEY] = WireSections().add("labels", labels)
            else:
                extra["labels"] = labels.tolist()
        out = {
            "ok": True,
            "op": "solve",
            "kind": kind,
            "digest": digest,
            "source": "cache",
            "cached": True,
        }
        out.update(self._result_fields(result, request))
        self._merge_fields(out, extra)
        return out

    def _handle_update(self, request: dict) -> dict:
        digest = request.get("digest")
        entry = self._sessions.get(digest) if digest else None
        if entry is None:
            raise KeyError(
                f"no session for digest {digest!r} (solve the graph first; "
                f"{len(self._sessions)} sessions live)"
            )
        if not isinstance(entry, DynamicMST):
            # Lazy materialization: solves park a (result, backend) seed —
            # the O(m) session arrays are only built for graphs that
            # actually receive updates, never on the query-only warm path.
            seed_result, seed_backend = entry
            entry = DynamicMST(
                seed_result,
                resolve_threshold=self.resolve_threshold,
                backend=seed_backend,
                device=self.device,
            )
            self._sessions[digest] = entry
        session = entry
        self._sessions.move_to_end(digest)
        try:
            result = session.apply(request.get("updates", []))
        except Exception:
            if session.dirty:
                # The apply failed mid-batch — a state no client has seen.
                # Drop the session; the next update for this digest needs a
                # fresh solve first (usually a cache hit). Pre-mutation
                # failures (validation) leave the session usable.
                del self._sessions[digest]
                BUS.count("serve.sessions.poisoned")
            raise
        new_digest = result.graph.digest()
        # Re-key content-addressed: the session now answers for the updated
        # graph, and the updated result is cached for future solve requests.
        del self._sessions[digest]
        self._sessions[new_digest] = session
        if self.sharded_lane is not None:
            # Move any mesh residency along the digest chain: the changed
            # rank slots are written into the resident shards, so a later
            # re-solve of the updated oversize graph stays resident. A
            # no-op unless the old digest was resident.
            self.sharded_lane.refresh_resident(digest, result.graph)
        # Cache under the backend the session's solves used (a client pinned
        # to a non-default backend must hit this entry on its next solve).
        self.store.put(
            solve_cache_key(result.graph, backend=session.backend), result
        )
        if self.verifier is not None:
            # Update results ride the ASYNC audit regardless of class
            # mode: the incremental cut/cycle maintenance is exactly the
            # machinery a certificate should cross-check, but inline
            # correction has no safe shape here (the session already
            # re-keyed) — a failed audit evicts the cached entry so the
            # next solve re-derives it fresh.
            self.verifier.audit(
                result,
                cls=sanitize_class(request.get("slo_class")),
                key=solve_cache_key(result.graph, backend=session.backend),
            )
        out = {
            "ok": True,
            "op": "update",
            "digest": new_digest,
            "prev_digest": digest,
            "mode": session.last_mode,
            "applied": len(request.get("updates", [])),
        }
        out.update(self._result_fields(result, request))
        return out

    # -- streams (stream/session.py) -------------------------------------
    def _seed_result(self, digest: str, backend: str):
        """The solved seed a new stream pins to: the parked update-session
        entry for this digest (a solve always parks one), falling back to
        the store's memory LRU — the parked seed is bounded by
        ``max_sessions``, but the cached result outlives it, and an
        evicted stream's re-subscribe-by-digest must keep working without
        a fresh solve. (The disk layer needs the graph to rebuild a
        result, which a digest-only subscribe doesn't carry.) Store keys
        carry the backend the solve ran on, so the probe honors the
        request's backend — a seed solved with an explicit
        ``backend=host`` is cached under the host key, not the service
        default. ``None`` when neither layer knows the graph."""
        entry = self._sessions.get(digest)
        if entry is not None:
            if isinstance(entry, DynamicMST):
                return entry.result()
            return entry[0]
        return self.store.get(
            cache_key_for_digest(digest, backend=backend),
            record_miss=False,
        )

    def _handle_subscribe(self, request: dict) -> dict:
        digest = request.get("digest")
        stream = request.get("stream")
        backend = request.get("backend", self.backend)
        session = self.streams.subscribe(
            digest=digest,
            stream=stream,
            result=self._seed_result(digest, backend) if digest else None,
        )
        return {
            "ok": True,
            "op": "subscribe",
            "stream": session.id,
            "digest": session.head,
            "seq": session.seq,
            "num_nodes": session.mst.num_nodes,
            "num_components": session.mst.num_components,
        }

    def _handle_publish(self, request: dict) -> dict:
        stream = request.get("stream")
        if not stream:
            raise ValueError("publish needs a stream id (from subscribe)")
        # The chain moved: cache the new head for future solve requests and
        # evict the superseded ancestor from the memory LRU — a long-lived
        # stream must not fill the cache with dead chain links. A noop
        # window (prev == new digest) moves nothing: evicting there would
        # drop the result we just cached. Memory-only: the stream
        # snapshot+WAL is the durable layer for every head on the chain.
        # Runs as the commit hook (inside the session lock) so concurrent
        # publishes on one stream maintain the cache in seq order — done
        # after publish returns, a later window's eviction could land
        # before an earlier window's insert and re-plant a dead ancestor.
        def _cache_head(result, prev_digest, digest):
            self.store.put(
                solve_cache_key(result.graph, backend=self.backend),
                result,
                memory_only=True,
            )
            if prev_digest != digest:
                self.store.evict_chain(
                    cache_key_for_digest(prev_digest, backend=self.backend)
                )

        out = self.streams.publish(
            stream, request.get("digest"), request.get("updates", []),
            on_commit=_cache_head,
        )
        result = out.pop("result")
        if self.verifier is not None:
            # Stream commits audit async like updates (same reasoning:
            # the WAL append is already the commit point).
            self.verifier.audit(
                result,
                cls=sanitize_class(request.get("slo_class")),
                key=solve_cache_key(result.graph, backend=self.backend),
            )
        response = {"ok": True, "op": "publish", **out}
        response.update(self._result_fields(result, request))
        return response

    def _handle_poll(self, request: dict) -> dict:
        stream = request.get("stream")
        if not stream:
            raise ValueError("poll needs a stream id (from subscribe)")
        out = self.streams.poll(stream, int(request.get("after_seq", 0)))
        return {"ok": True, "op": "poll", **out}

    def _handle_stats(self) -> dict:
        counters = {
            name: value
            for name, value in BUS.counters().items()
            if name.startswith(
                ("serve.", "batch.", "compile.", "lane.", "stream.",
                 "verify.")
            )
        }
        out = {
            "ok": True,
            "op": "stats",
            "counters": counters,
            "store": self.store.stats(),
            "sessions": len(self._sessions),
            "streams": len(self.streams),
            # Ring-overflow visibility: a drill reading stats over the
            # pipes must know when span-derived numbers under-count.
            "events_dropped": BUS.dropped,
            # Raw reservoirs (not summaries): the router-side pulse merges
            # these across workers with obs.events.merge_hists — fleet
            # percentiles need the samples, not per-worker p99s.
            "histograms_raw": BUS.histograms_export(),
        }
        if self.verifier is not None:
            out["verify"] = self.verifier.policy.describe()
        stream_stats = self.streams.stats()
        # Durable streams outnumber resident ones after an LRU eviction
        # or a restart; an operator needs the on-disk count to know a
        # quiet worker still owns replayable state.
        out["streams_recoverable"] = len(stream_stats.get("recoverable", ()))
        if self.warmup_report is not None:
            out["warmup"] = self.warmup_report
        return out

    # ------------------------------------------------------------------
    def _load_graph(self, request: dict) -> Graph:
        if "graph_path" in request:
            from distributed_ghs_implementation_tpu_torch.graphs import io

            path = request["graph_path"]
            if path.endswith(".npz"):
                return io.read_npz(path)
            return io.read_partition_dir(path)
        if "edges" in request:
            return Graph.from_edges(
                int(request["num_nodes"]), request["edges"]
            )
        if SECTIONS_KEY in request:
            # Binary ingest: u/v/w arrive as raw little-endian sections; frombuffer views, no
            # JSON list ever existed. Digest/cache keys are byte-identical
            # to the edges path by the codec's canonical-form contract.
            return Graph.from_wire(request)
        raise ValueError("solve needs either graph_path or num_nodes+edges")

    def _remember(self, digest: str, result: MSTResult, backend: str) -> None:
        if digest not in self._sessions:
            # A lightweight seed, not a DynamicMST: the result is shared
            # with the store entry (no array copies) until an update op
            # materializes the session.
            self._sessions[digest] = (result, backend)
        self._sessions.move_to_end(digest)
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
            BUS.count("serve.sessions.evicted")

    @staticmethod
    def _result_fields(result: MSTResult, request: dict) -> dict:
        out = {
            "total_weight": result.total_weight,
            "num_nodes": result.graph.num_nodes,
            "num_edges": result.graph.num_edges,
            "num_edges_in_mst": result.num_edges,
            "num_components": result.num_components,
            "backend": result.backend,
            "wall_time_s": result.wall_time_s,
        }
        if result.incidents is not None and len(result.incidents):
            out["incident_summary"] = result.incidents.summary()
        if request.get("edges_out"):
            # Vectorized either way: one fancy-index per endpoint column,
            # never a per-edge Python loop. Binary clients (the request
            # arrived with sections) get the answer back as sections.
            import numpy as np

            ids = np.asarray(result.edge_ids)
            mst_u = result.graph.u[ids]
            mst_v = result.graph.v[ids]
            if SECTIONS_KEY in request:
                out[SECTIONS_KEY] = (
                    WireSections().add("mst_u", mst_u).add("mst_v", mst_v)
                )
            else:
                out["mst_edges"] = np.stack(
                    [mst_u, mst_v], axis=1
                ).tolist()
        return out

    @staticmethod
    def _merge_fields(out: dict, extra: dict) -> None:
        """``out.update(extra)`` that unions binary egress sections
        instead of letting one response field family clobber the other
        (``edges_out`` + ``labels_out`` on one binary request)."""
        have = out.get(SECTIONS_KEY)
        more = extra.get(SECTIONS_KEY)
        if isinstance(have, WireSections) and isinstance(more, WireSections):
            for name in more.names:
                have.add(name, more.array(name))
            extra = {k: v for k, v in extra.items() if k != SECTIONS_KEY}
        out.update(extra)


class _DrainSignal(Exception):
    """Raised by the SIGTERM/SIGINT handlers while the loop is idle."""


def serve_loop(
    in_stream: IO[str], out_stream: IO[str], service=None
) -> int:
    """Drain JSONL requests from ``in_stream`` until EOF or ``shutdown``;
    one flushed JSON response line each. Returns a process exit code.

    ``service`` is anything with an ``MSTService``-shaped ``handle``;
    ``None`` builds a default :class:`MSTService` (on CUDA).

    **Graceful shutdown**: SIGTERM/SIGINT drain instead of killing the
    process mid-line. A signal arriving while a request is being handled
    lets the solve finish and its response flush, THEN ends the loop; a
    signal arriving while blocked on input ends the loop immediately. An
    accepted request therefore always gets its response — previously a
    mid-solve SIGINT tore the loop between accept and respond, which is
    the lost-query shape. Handlers install
    only on the main thread (threaded callers keep their own handling) and
    the previous handlers are restored on exit.
    """
    import signal

    service = service or MSTService()
    draining = threading.Event()
    in_request = [False]

    def _drain_handler(signum, frame):
        draining.set()
        if not in_request[0]:
            # Idle (blocked reading): nothing in flight to protect.
            raise _DrainSignal()

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, _drain_handler)
    except ValueError:
        previous = {}  # not the main thread: run without drain handlers
    try:
        with BUS.span("serve.session", cat="serve"):
            try:
                for line in in_stream:
                    # A line read off the stream IS an accepted request:
                    # flip the flag before touching it, so a signal landing
                    # anywhere past the read drains-after-response instead
                    # of dropping it.
                    in_request[0] = True
                    line = line.strip()
                    if line:
                        try:
                            request = json.loads(line)
                        except json.JSONDecodeError as e:
                            BUS.count("serve.errors")
                            response = {"ok": False, "error": f"bad JSON: {e}"}
                        else:
                            response = service.handle(request)
                        # Compact separators, same as every framed payload
                        # (fleet/framing.py): egress bytes are protocol,
                        # not pretty-printing. Any binary egress sections
                        # fold to their JSON forms — the text protocol
                        # cannot carry raw buffers.
                        out_stream.write(
                            json.dumps(
                                fold_sections(response),
                                separators=(",", ":"),
                            )
                            + "\n"
                        )
                        out_stream.flush()
                    else:
                        response = {}
                    in_request[0] = False
                    if draining.is_set():
                        break
                    if response.get("op") == "shutdown" and response.get("ok"):
                        break
            except _DrainSignal:
                pass  # caught while idle: responses are already flushed
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return 0


def serve_frames(
    in_stream: IO[bytes], out_stream: IO[bytes], service=None
) -> int:
    """The binary front door: length-prefixed
    frames (``fleet/framing.py``) over binary stdio instead of text JSONL.

    Same ops, same service — only the carrier changes. Requests arrive as
    classic JSON frames or B-frames (raw ``u``/``v``/``w`` array sections
    behind a compact header, crc32 over both); the first inbound B-frame
    flips binary egress on, after which section-bearing responses
    (``edges_out`` / ``labels_out``) go back as B-frames too — the same
    echo-on-receipt negotiation the fleet transports use. JSON frames in,
    JSON (checksummed) frames out: a legacy framed client never sees a
    byte it cannot parse.

    A garbled frame is terminal: past a :class:`FrameError` the stream is
    no longer frame-aligned, so the loop reports it (one best-effort error
    frame) and exits nonzero — the supervisor restarts the process, which
    is the same contract the fleet's channel reader applies. Clean EOF or
    an acknowledged ``shutdown`` exits zero.
    """
    service = service or MSTService()
    wire_out = False
    with BUS.span("serve.session", cat="serve"):
        while True:
            meta: dict = {}
            try:
                request = read_frame(in_stream, meta=meta)
            except FrameError as e:
                BUS.count("serve.errors")
                try:
                    out_stream.write(
                        encode_frame(
                            {"ok": False, "error": f"bad frame: {e}"},
                            crc=True,
                        )
                    )
                    out_stream.flush()
                except OSError:
                    pass
                return 1
            if request is None:
                return 0
            if meta.get("wire"):
                wire_out = True
            response = service.handle(request)
            if wire_out and frame_sections(response) is not None:
                data = encode_bframe(response)
            else:
                data = encode_frame(fold_sections(response), crc=True)
            out_stream.write(data)
            out_stream.flush()
            if response.get("op") == "shutdown" and response.get("ok"):
                return 0
