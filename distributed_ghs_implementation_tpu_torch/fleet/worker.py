"""Fleet worker process: one MSTService behind a framed channel.

Port of the JAX package's ``fleet/worker.py``: the same frames, hello and
flags, over the port's ``MSTService`` on one explicit device. Where it
differs on purpose:

* ``--device`` (default ``cuda``) is the service's device. Without CUDA a
  worker not given ``--device cpu`` fails while it builds its service
  (``device.resolve_device``'s ``RuntimeError``) and exits non-zero before
  its hello: it never answers from the CPU.
* the hello's ``caps["kernel"]`` names what the service runs: ``"cuda"``
  (the hand-written kernels) or ``"torch"`` (their plain versions on the
  CPU); an echo worker says ``"echo"``. ``caps["tuned"]`` is the port's
  ``ops/kernels.tuned_summary()``.
* the echo path (``--test-echo``) builds no service, loads no library and
  never initialises CUDA, so it needs no ``--device``.
* a pipe worker moves its frame channel off fd 1 before it builds anything
  and points fd 1 at stderr, so that output of C or CUDA code can never
  land between two frames.
* the persistent cache is the port's build cache
  (``utils/compile_cache.py``): the libraries ``nvcc`` and ``g++`` built,
  which a restarted incarnation loads instead of building.

Spawned by :class:`fleet.router.FleetRouter` as
``python -m distributed_ghs_implementation_tpu_torch.fleet.worker --worker-id K``
— over stdin/stdout pipes (the single-host default), or over TCP
(``fleet/transport.py``): ``--connect HOST:PORT`` dials into the router's
listener and registers with a hello frame; ``--listen [HOST:]PORT`` serves
a socket an off-host router dials (the ``--fleet-workers host:port`` remote
topology). Each worker owns a full serving stack — its own lane engine,
warm-bucket cache, obs bus, and solve scheduler — and shares only the
*persistent* layers with same-host siblings: the on-disk result store
(flock-serialized writes, ``serve/store.py``) and the build cache
(``utils/compile_cache.py``). Across hosts nothing is shared — the router's
cache-miss forwarding hop covers that gap (``docs/FLEET.md``).

Inbound frames (``fleet/framing.py``):

* ``{"id": N, "req": {...}}`` — one service request; the response frame
  ``{"id": N, "resp": {...}, "t": seconds}`` may be written out of order
  (requests run on a small thread pool so the batch engine can coalesce
  lane-mates); ``t`` is the in-worker service time, which lets the router
  compute the pure transport+queueing hop latency per request.
* ``{"ping": S}`` — heartbeat; answered ``{"pong": S}`` inline from the
  read loop, so a worker busy solving still proves its process is alive
  (busy is not dead — only a wedged or exited process misses heartbeats,
  and over TCP that silence is what expires the router-side lease).
* ``{"arm": {"site": ..., "times": T, "kind": ...}}`` — arm the in-process
  :data:`~distributed_ghs_implementation_tpu_torch.utils.resilience.FAULTS`
  registry (kill drills arm ``fleet.worker.crash`` mid-traffic this way).
* ``{"drain": true}`` (or channel EOF in pipe/connect mode, or SIGTERM) —
  graceful drain: stop reading, finish every in-flight request, flush the
  responses, export the obs JSONL (``--obs-jsonl``), and exit 0. In
  ``--listen`` mode a *connection loss without drain* instead returns the
  worker to ``accept()`` with its caches and sessions intact — the router
  re-dials and the worker rejoins warm.

The hello/ready frame (one builder for every medium,
``transport.build_hello``) carries the protocol version and the worker's
capability flags — ``lane`` (owns a mesh-sharded oversize lane),
``stream`` (durable stream log attached), ``kernel`` (level-kernel
choice), ``warmed`` (the elastic fleet's warm-handoff gate) — so the
router learns everything routing needs in one place. ``warmed`` is
truthful *by ordering*: the hello is only built after
:func:`_build_service` returns, which means the service exists, the
persistent compile cache is attached, and any warmup ladder has already
run — a joining worker that advertises ``warmed`` cannot serve a cold
p99. ``GHS_FLEET_COLD_HELLO=1`` is the test hook that advertises cold
anyway, to prove the router's refuse-a-cold-joiner path end to end.

The ``fleet.worker.crash`` fault site is consulted once per request,
*before* it is handled: when the armed shot count reaches zero the process
dies via ``os._exit`` — no response, no flushing, no atexit — which is
exactly the crash the router's zero-lost-query re-queue path must absorb.
``GHS_FAULT_FLEET_WORKER_CRASH=K`` in a worker's environment therefore
means "die in place of answering the K-th request".
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from distributed_ghs_implementation_tpu_torch.fleet.transport import (
    PipeTransport,
    SocketTransport,
    Transport,
    build_hello,
    parse_hostport,
)
from distributed_ghs_implementation_tpu_torch.obs import tracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS

CRASH_SITE = "fleet.worker.crash"
#: Armed with kind="slow", stalls the worker's next request INSIDE its
#: pool thread for `value` seconds — a deterministic stand-in for a long
#: oversize solve. The read loop keeps answering pings throughout (pongs
#: are out-of-band by construction), which is exactly what the
#: busy-is-not-dead lease test pins: `fleet.lease.expired` must never
#: fire on a healthy-but-busy worker.
SLOW_SITE = "fleet.worker.slow"
CRASH_EXIT_CODE = 17  # distinguishable from drain (0) and tracebacks (1)


class _DrainSignal(Exception):
    """Raised in the read loop by the SIGTERM/SIGINT handlers."""


class EchoService:
    """A solver-free stand-in service for fleet plumbing tests.

    Answers the same ops as :class:`serve.service.MSTService` with canned
    content: solves echo a digest derived from the request payload (and
    remember it, so ``cached_only`` probes answer hit/miss honestly — the
    forwarding drills need that), updates re-key it digest-chained,
    ``sleep_s`` simulates a slow solve. This is what lets
    ``tests/test_fleet.py`` exercise routing, re-queue, shedding,
    heartbeats, forwarding, and drain without compiling a single kernel.
    """

    def __init__(self, worker_id: int):
        self.worker_id = worker_id
        self.handled = 0
        self._served = set()  # digests this worker has "solved" (cached)

    def handle(self, request: dict) -> dict:
        self.handled += 1
        op = request.get("op")
        if request.get("sleep_s"):
            time.sleep(float(request["sleep_s"]))
        if op == "solve":
            digest = request.get("digest") or hashlib.sha256(
                json.dumps(request.get("edges", []), sort_keys=True).encode()
            ).hexdigest()[:32]
            if request.get("cached_only"):
                if digest in self._served:
                    return {"ok": True, "op": "solve", "digest": digest,
                            "source": "cache", "cached": True,
                            "worker": self.worker_id}
                return {"ok": False, "op": "solve", "digest": digest,
                        "cache_miss": True, "worker": self.worker_id,
                        "error": f"cache_miss: {digest} not cached here"}
            self._served.add(digest)
            return {"ok": True, "op": "solve", "digest": digest,
                    "source": "echo", "worker": self.worker_id}
        if op == "update":
            digest = request.get("digest")
            if digest is None:
                return {"ok": False, "op": "update", "error": "no digest"}
            new = hashlib.sha256(
                (digest + json.dumps(request.get("updates", []))).encode()
            ).hexdigest()[:32]
            self._served.add(new)
            return {"ok": True, "op": "update", "digest": new,
                    "prev_digest": digest, "worker": self.worker_id}
        if op == "stats":
            from distributed_ghs_implementation_tpu_torch.obs.events import BUS

            return {"ok": True, "op": "stats",
                    "counters": {"echo.handled": self.handled},
                    "events_dropped": BUS.dropped,
                    "histograms_raw": BUS.histograms_export(),
                    "worker": self.worker_id}
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        return {"ok": False, "op": op, "error": f"unknown op {op!r}"}


def _build_service(args):
    if args.test_echo:
        return EchoService(args.worker_id)
    # Deferred: the echo path never builds a service or touches a device.
    if args.multihost:
        # A worker that spans processes: bring up the default process
        # group from the standard env (torchrun's or the launcher's names)
        # BEFORE the service, so the sharded lane's mesh covers every
        # process of the group.
        from distributed_ghs_implementation_tpu_torch.parallel.multihost import (
            initialize,
        )

        initialize(device=args.device)
    from distributed_ghs_implementation_tpu_torch.batch.warmup import plan_from_flags
    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService
    from distributed_ghs_implementation_tpu_torch.utils.compile_cache import (
        enable_persistent_cache,
    )

    if not args.no_compile_cache:
        # Workers share the persistent build cache (keyed by source, flags
        # and toolchain): the first worker to build a library pays; its
        # siblings and every restarted incarnation load it.
        enable_persistent_cache(args.compile_cache_dir)
    if args.tune_record:
        # Shared exactly like the compile cache: one offline `cli tune`
        # run's record (machine-fingerprinted, integrity-checked) makes
        # every worker's auto tier measured. Miss/stale installs nothing
        # and the probe heuristic serves — a worker never refuses to boot
        # over a tuning file (tune.record.miss/stale on the bus).
        from distributed_ghs_implementation_tpu_torch.tune.record import (
            load_and_install,
        )

        load_and_install(args.tune_record, device=args.device)
    return MSTService(
        backend=args.backend,
        store_capacity=args.store_capacity,
        disk_dir=args.disk_cache,
        max_concurrent=args.max_concurrent,
        max_sessions=args.max_sessions,
        resolve_threshold=args.resolve_threshold,
        batch_lanes=args.batch_lanes,
        batch_wait_s=args.batch_wait,
        warmup=plan_from_flags(
            buckets=args.warmup_buckets, replay=args.warmup_replay,
            lanes=args.batch_lanes, mesh_buckets=args.warmup_mesh_buckets,
            stream_buckets=args.warmup_stream_buckets,
            tuning=args.tune_record,
        ),
        # -1 = the bare flag: a lane over all of this worker's devices.
        sharded_lane=(True if args.sharded_lane == -1
                      else max(0, args.sharded_lane)),
        stream_dir=args.stream_dir,
        stream_snapshot_every=args.stream_snapshot_every,
        verify=args.verify,
        device=args.device,
    )


def _hello_for(args, warmup_summary=None, *, device=None) -> dict:
    # The one place capability flags live (routing reads them off the
    # hello; ad-hoc per-feature keys are what this replaces). Called only
    # AFTER _build_service, so "warmed" is a statement of fact: the
    # service — warmup ladder included — already exists.
    caps = {
        "lane": bool(args.sharded_lane),
        "stream": bool(args.stream_dir),
        # Both halves of the fused path: this worker can serve an
        # oversize stream mesh-resident AND rebuild that residency from
        # the shared durable log after a restart (stream/session.py) —
        # what lets the router treat lane workers as interchangeable
        # inheritors for sharded streams.
        "stream_sharded": bool(args.sharded_lane and args.stream_dir),
        "kernel": "echo",
        "verify": args.verify or "off",
    }
    if not args.test_echo:
        # Measured-selection provenance (None = probe heuristic): the
        # stats op shows which workers serve on a TuningRecord and which
        # machine measured it. Echo workers never load the kernels.
        from distributed_ghs_implementation_tpu_torch.models.boruvka import (
            kernel_label,
        )
        from distributed_ghs_implementation_tpu_torch.ops.kernels import (
            tuned_summary,
        )

        caps["kernel"] = kernel_label(device)
        caps["tuned"] = tuned_summary()
    if warmup_summary is not None:
        caps["warmup"] = warmup_summary
    return build_hello(
        args.worker_id,
        caps=caps,
        token=args.conn_token,
        warmed=not os.environ.get("GHS_FLEET_COLD_HELLO"),
    )


def _serve_connection(transport: Transport, service, pool) -> str:
    """Drain frames off one channel until drain/EOF; returns ``"drain"``
    (stop the worker) or ``"eof"`` (connection lost; a ``--listen`` worker
    goes back to accept)."""
    from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

    def _serve_one(
        rid: int, request: dict, trace: Optional[dict] = None
    ) -> None:
        shot = FAULTS.pop(CRASH_SITE)
        if shot is not None and shot.remaining == 0:
            os._exit(CRASH_EXIT_CODE)  # a real crash: no response, no flush
        slow = FAULTS.pop(SLOW_SITE)
        if slow is not None and slow.kind == "slow":
            # A long solve, without needing a graph big enough to be one:
            # the stall happens on a pool thread, so the read loop's
            # inline pongs keep flowing — busy, not dead.
            time.sleep(slow.value)
        t0 = time.perf_counter()
        # Re-establish the router's trace context (when the frame carried
        # one) so every span this worker records — serve.*, batch.*,
        # stream.* — shares the router's trace_id; ``fleet.serve`` is the
        # worker-side service-time span the merge subtracts from the
        # router's attempt span to price the transport hop.
        ctx = tracing.from_wire(trace)
        try:
            with tracing.activated(ctx), BUS.span(
                "fleet.serve", cat="fleet", op=request.get("op")
            ):
                response = service.handle(request)
        except Exception as e:  # noqa: BLE001 — the channel must survive
            response = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        try:
            transport.send({
                "id": rid, "resp": response,
                "t": round(time.perf_counter() - t0, 6),
            })
        except OSError:
            pass  # router gone mid-response; it re-queues, we carry on

    try:
        while True:
            frame = transport.recv()
            if frame is None or frame.get("drain"):
                return "drain" if frame else "eof"
            if "ping" in frame:
                try:
                    transport.send({"pong": frame["ping"]})
                except OSError:
                    return "eof"
                continue
            if "arm" in frame:
                arm = frame["arm"]
                FAULTS.arm(
                    arm.get("site", CRASH_SITE),
                    times=int(arm.get("times", 1)),
                    kind=arm.get("kind", "raise"),
                    value=float(arm.get("value", 0.0)),
                )
                continue
            if "req" in frame:
                pool.submit(
                    _serve_one, frame["id"], frame["req"],
                    frame.get("trace"),
                )
    except _DrainSignal:
        return "drain"


def _claim_stdout():
    """A pipe worker's frame channel, moved off fd 1: fd 1 then points at
    stderr, so that whatever C or CUDA code (or a stray ``print``) writes
    to stdout lands in the log instead of corrupting a frame."""
    sys.stdout.flush()
    channel = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    return channel


def run_worker(args) -> int:
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    BUS.enable()
    channel = None if (args.listen or args.connect) else _claim_stdout()
    service = _build_service(args)
    draining = threading.Event()

    def _drain_handler(signum, frame):
        draining.set()
        # Requests run on the pool, so the main (read) thread is always
        # safe to interrupt: stop admitting immediately, then flush.
        raise _DrainSignal()

    try:
        signal.signal(signal.SIGTERM, _drain_handler)
        signal.signal(signal.SIGINT, _drain_handler)
    except ValueError:  # not the main thread (in-process tests)
        pass

    pool = ThreadPoolExecutor(
        max_workers=args.threads, thread_name_prefix=f"worker{args.worker_id}"
    )
    warmup_summary = None
    if not args.test_echo:
        from distributed_ghs_implementation_tpu_torch.batch.warmup import (
            summarize_report,
        )

        warmup_summary = summarize_report(
            getattr(service, "warmup_report", None)
        )
    hello = _hello_for(args, warmup_summary,
                       device=getattr(service, "device", None))

    last_transport = None
    try:
        if args.listen:
            host, port = parse_hostport(args.listen, default_host="0.0.0.0")
            server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind((host, port))
            server.listen(1)
            print(
                f"fleet.worker {args.worker_id}: listening on "
                f"{server.getsockname()[0]}:{server.getsockname()[1]}",
                file=sys.stderr, flush=True,
            )
            # One router connection at a time; a lost connection (router
            # death, network partition) returns to accept with the warm
            # service intact — the re-dialing router gets a warm rejoin,
            # not a cold restart.
            while not draining.is_set():
                try:
                    conn, _addr = server.accept()
                except (OSError, _DrainSignal):
                    break
                transport = last_transport = SocketTransport(conn)
                try:
                    transport.send(hello)
                except OSError:
                    transport.close()
                    continue
                outcome = _serve_connection(transport, service, pool)
                if outcome == "drain":
                    break
                transport.close()
            server.close()
        elif args.connect:
            sock = socket.create_connection(
                parse_hostport(args.connect), timeout=30.0
            )
            sock.settimeout(None)
            transport = last_transport = SocketTransport(sock)
            transport.send(hello)
            _serve_connection(transport, service, pool)
        else:
            transport = last_transport = PipeTransport(
                channel, sys.stdin.buffer
            )
            transport.send(hello)
            _serve_connection(transport, service, pool)
    except _DrainSignal:
        pass
    # Drain: everything admitted gets its response flushed before exit 0.
    pool.shutdown(wait=True)
    if last_transport is not None:
        try:
            last_transport.send({"bye": True, "worker": args.worker_id})
        except OSError:
            pass  # router already gone; the drain still completed
        last_transport.close()
    if args.obs_jsonl:
        from distributed_ghs_implementation_tpu_torch.obs.export import (
            write_events_jsonl,
        )

        write_events_jsonl(
            BUS, args.obs_jsonl, label=f"worker{args.worker_id}"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fleet.worker", description=__doc__)
    p.add_argument("--worker-id", type=int, required=True)
    p.add_argument("--backend", default="device")
    p.add_argument("--device", default="cuda",
                   help="the service's device: cuda (the default; raises "
                   "without CUDA) or cpu (the kernels' plain versions)")
    p.add_argument("--batch-lanes", type=int, default=0)
    p.add_argument("--batch-wait", type=float, default=None)
    p.add_argument("--store-capacity", type=int, default=128)
    p.add_argument("--disk-cache", default=None,
                   help="shared persistent result store directory")
    p.add_argument("--stream-dir", default=None,
                   help="shared durable stream log directory (snapshot + "
                   "WAL per stream; failover replays from here)")
    p.add_argument("--stream-snapshot-every", type=int, default=8,
                   help="windows between stream snapshots")
    p.add_argument("--max-concurrent", type=int, default=2)
    p.add_argument("--max-sessions", type=int, default=32)
    p.add_argument("--resolve-threshold", type=int, default=None)
    p.add_argument("--warmup-replay", default=None)
    p.add_argument("--threads", type=int, default=4,
                   help="request threads (lets the batch engine coalesce)")
    p.add_argument("--warmup-buckets", default=None)
    p.add_argument("--warmup-mesh-buckets", default=None,
                   help="RAW NODESxEDGES oversize workloads to warm on the "
                   "sharded lane before serving")
    p.add_argument("--warmup-stream-buckets", default=None,
                   help="RAW NODESxEDGES subscribed-graph sizes whose "
                   "window kernels warm before serving")
    p.add_argument("--sharded-lane", type=int, nargs="?", const=-1,
                   default=0, metavar="N",
                   help="own a mesh-sharded oversize solve lane over N "
                   "devices (bare flag = all; 0 = off)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="dial into the router's listener over TCP and "
                   "register with a hello frame (spawned network workers)")
    p.add_argument("--listen", default=None, metavar="[HOST:]PORT",
                   help="serve a TCP socket the router dials (remote "
                   "workers addressed via --fleet-workers host:port); a "
                   "lost connection returns to accept with caches warm")
    p.add_argument("--conn-token", default=None,
                   help="dial-in token proving this process belongs to its "
                   "router-assigned slot + incarnation")
    p.add_argument("--multihost", action="store_true",
                   help="initialize the default process group before "
                   "building the service (parallel/multihost.py: torchrun's "
                   "or the launcher's environment)")
    p.add_argument("--verify", default=None, metavar="SPEC",
                   help="result verification policy (off|sample|full, or "
                   "per-class 'bulk=full,interactive=sample,default=off' — "
                   "docs/VERIFICATION.md)")
    p.add_argument("--compile-cache-dir", default=None)
    p.add_argument("--no-compile-cache", action="store_true")
    p.add_argument("--tune-record", default=None,
                   help="ghs-tuning-v1 TuningRecord to install (shared "
                        "across workers like the compile cache)")
    p.add_argument("--obs-jsonl", default=None,
                   help="export this worker's bus events here on drain")
    p.add_argument("--test-echo", action="store_true",
                   help="solver-free canned service (fleet plumbing tests; "
                   "never touches a device)")
    return p


def main(argv=None) -> int:
    return run_worker(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
