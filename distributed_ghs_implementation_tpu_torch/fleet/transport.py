"""Fleet transport layer: framed channels over OS pipes or TCP sockets.

Port of the JAX package's ``fleet/transport.py``. The frames, the hello
(``PROTO_VERSION`` 1 and its field names) and the capability negotiation
are that package's, so a router of either package speaks to a worker of
the other. The chaos sites consult the port's fault registry
(``utils/resilience.FAULTS``) and count on the port's bus.

Round 12's fleet hard-wired the framing (``fleet/framing.py``) to a worker
subprocess's stdin/stdout — a single-host ceiling. This module abstracts
the channel so the router addresses a worker the same way whether it is a
child process on this machine or a pod-slice-owning process on another
one:

* :class:`PipeTransport` — the round-12 medium unchanged: locked,
  immediately-flushed frame writes on a subprocess pipe pair.
* :class:`SocketTransport` — frames over a connected TCP socket with
  **write coalescing / pipelined frame I/O**: ``send()`` enqueues the
  encoded frame and a dedicated flusher thread drains *everything* queued
  into one ``sendall`` — under concurrent dispatch the router pays one
  syscall (and one TCP segment, Nagle off) for a whole burst of frames
  instead of one per request. ``transport.writes`` / ``transport.frames``
  expose the coalescing ratio.

**Registration protocol.** A worker introduces itself with one *hello
frame* — the same frame on pipes (where round 12 called it the ready
frame) and sockets (where it doubles as dial-in registration)::

    {"ready": true, "proto": 1, "worker": K, "pid": ...,
     "caps": {"lane": bool, "stream": bool, "kernel": "auto",
              "warmed": bool},
     "token": "<spawn token>", "lease_s": ...}

``proto`` is the fleet protocol version — :func:`check_hello` rejects a
mismatch with a clear error instead of letting two incompatible processes
mis-parse each other's frames. ``caps`` carries the worker's capability
flags in ONE place (round 13 grew an ad-hoc ``lane`` key; round 14 would
have added ``stream``; this is where all of them live now). ``warmed`` is
the elastic fleet's warm-handoff gate: a worker only sends its hello
*after* its service is built and its warmup ladder has run, so a truthful
``warmed: true`` means "route traffic at me and you will not see a cold
p99" — :meth:`fleet.router.FleetRouter.add_worker` refuses ring entry to
a hello without it (``docs/FLEET.md`` "Elasticity"). ``token``
authenticates a spawned TCP worker's dial-in to its slot + incarnation, so
a stale worker from a previous incarnation cannot hijack a restarted
slot's connection.

Death detection composes with the router's existing machinery: a closed
connection surfaces as ``recv() -> None`` exactly like pipe EOF, and the
heartbeat loop's silence threshold acts as the **lease** — a socket that
stays connected while its worker stops answering pings expires after
``lease_s`` and is declared dead the same way a wedged pipe worker is.
"""

from __future__ import annotations

import os
import socket
import threading
import uuid
from typing import IO, Callable, Optional, Tuple

from distributed_ghs_implementation_tpu_torch.fleet.framing import (
    FrameError,
    encode_bframe,
    encode_frame,
    fold_sections,
    frame_sections,
    read_frame,
)

#: The fleet wire-protocol version. Bump on any frame-shape change the
#: other side cannot ignore; the hello exchange rejects mismatches.
PROTO_VERSION = 1

#: Test hook: lets a drill spawn a worker that ADVERTISES a different
#: protocol version, to prove the router's rejection path end to end.
_PROTO_ENV = "GHS_FLEET_PROTO"

#: The hello frame is a few hundred bytes; anything bigger is not a hello.
_MAX_HELLO_BYTES = 64 * 1024


class HelloError(ValueError):
    """A malformed or incompatible hello frame (version mismatch, missing
    identity). The connection is rejected with this message."""


def build_hello(
    worker_id: int,
    *,
    caps: Optional[dict] = None,
    token: Optional[str] = None,
    lease_s: Optional[float] = None,
    warmed: Optional[bool] = None,
) -> dict:
    """The worker's registration frame (pipes call it the ready frame).

    ``warmed`` lands in ``caps`` — it is a capability like the others, but
    it carries a *timing* promise (the warmup ladder already ran), so it
    gets a first-class parameter rather than riding in an ad-hoc dict.
    """
    proto = int(os.environ.get(_PROTO_ENV, PROTO_VERSION))
    hello = {
        "ready": True,
        "proto": proto,
        "worker": int(worker_id),
        "pid": os.getpid(),
        "caps": dict(caps or {}),
    }
    # Frame-checksum capability (round 19): this build parses the
    # checksummed header form, so the router may enable CRC toward us.
    # The hello itself always goes out in the legacy form — it is the
    # message that NEGOTIATES the capability (GHS_FLEET_CRC=0 opts a
    # worker out, for mixed-build compatibility drills).
    hello["caps"].setdefault(
        "crc", os.environ.get("GHS_FLEET_CRC", "1") != "0"
    )
    # Trace-propagation capability: this build understands an optional
    # ``trace`` field on request frames (obs/tracing.py) and will
    # re-establish the router's trace context before dispatch. Same
    # opt-in shape as CRC — a legacy worker without the cap just gets
    # untraced frames (GHS_FLEET_TRACE=0 simulates one in drills).
    hello["caps"].setdefault(
        "trace", os.environ.get("GHS_FLEET_TRACE", "1") != "0"
    )
    # Binary-wire capability: this build parses B-frames (raw array
    # sections behind a JSON header, ``fleet/framing.py``), so the router
    # may pass section-bearing payloads through opaquely instead of
    # folding them to JSON. Same opt-in shape as CRC — a legacy worker
    # without the cap gets classic JSON frames, per connection
    # (GHS_FLEET_WIRE=0 simulates one in the mixed-build drills).
    hello["caps"].setdefault(
        "wire", os.environ.get("GHS_FLEET_WIRE", "1") != "0"
    )
    if warmed is not None:
        hello["caps"]["warmed"] = bool(warmed)
    if token is not None:
        hello["token"] = token
    if lease_s is not None:
        hello["lease_s"] = float(lease_s)
    return hello


def check_hello(frame: dict) -> dict:
    """Validate a hello frame; returns it with ``caps`` normalized.

    Raises :class:`HelloError` with an actionable message on a protocol
    version mismatch (the one failure an operator mixing fleet builds
    across hosts will actually hit) or a hello without a worker identity.
    """
    if not frame.get("ready"):
        raise HelloError(f"not a hello frame: {sorted(frame)[:8]}")
    proto = frame.get("proto")
    if proto != PROTO_VERSION:
        raise HelloError(
            f"fleet protocol version mismatch: worker speaks proto "
            f"{proto!r}, this router speaks {PROTO_VERSION} — upgrade the "
            f"older side (worker pid {frame.get('pid')}, id "
            f"{frame.get('worker')})"
        )
    if frame.get("worker") is None:
        raise HelloError("hello frame carries no worker id")
    caps = frame.get("caps")
    frame["caps"] = dict(caps) if isinstance(caps, dict) else {}
    return frame


def new_conn_token() -> str:
    """An unguessable per-incarnation dial-in token."""
    return uuid.uuid4().hex


def parse_hostport(addr: str, *, default_host: str = "127.0.0.1") -> Tuple[str, int]:
    """``"host:port"`` (or bare ``"port"``) -> ``(host, port)``."""
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"bad address {addr!r}: expected HOST:PORT")
    return (host or default_host, int(port))


class TransportClosed(OSError):
    """Raised by ``send`` on a transport already known to be dead — the
    synchronous signal the dispatch path turns into failover."""


class Transport:
    """One framed channel to a peer. ``send`` may buffer (socket
    coalescing); ``recv`` blocks for one frame and returns ``None`` when
    the channel is gone — a garbled frame also ends the channel (the
    stream is no longer frame-aligned), after counting it.

    **CRC negotiation**: ``enable_crc()`` switches outbound frames to the
    checksummed header form (``fleet/framing.py``). The router calls it
    for workers whose hello advertised the ``crc`` capability; a worker —
    which never sees a router hello — enables it by *echo-on-receipt*:
    the first inbound frame carrying a checksum proves the peer both
    emits and (being the same build) parses the form. Either way, no
    checksummed frame is ever sent at a peer that might not parse it.

    **Binary-wire negotiation** rides the identical machinery one rung
    up: ``enable_wire()`` (router side, from hello ``caps.wire``) or the
    first inbound B-frame (worker side, echo-on-receipt) switches
    section-bearing payloads to the binary form. A payload that carries
    a :class:`~..fleet.framing.WireSections` toward a peer WITHOUT the
    capability is folded to classic JSON at the send boundary
    (``fold_sections``) — per-connection degradation, never an error.
    """

    kind = "abstract"
    crc_out = False  # emit checksummed frames (set via enable_crc)
    wire_out = False  # emit binary B-frames (set via enable_wire)

    def enable_crc(self) -> None:
        self.crc_out = True

    def enable_wire(self) -> None:
        self.wire_out = True

    def _note_recv_meta(self, meta: dict) -> None:
        if meta.get("crc") and not self.crc_out:
            self.crc_out = True  # peer speaks checksummed frames: echo it
        if meta.get("wire") and not self.wire_out:
            self.wire_out = True  # peer speaks B-frames: echo it

    def encode_for_peer(self, obj: dict) -> bytes:
        """``obj`` in the richest form this peer negotiated: B-frame for
        section-bearing payloads toward ``caps.wire`` peers, folded JSON
        toward legacy peers, plain (CRC'd where negotiated) JSON for
        everything else."""
        if frame_sections(obj) is not None:
            if self.wire_out:
                return encode_bframe(obj)
            return encode_frame(fold_sections(obj), crc=self.crc_out)
        return encode_frame(obj, crc=self.crc_out)

    def send(self, obj: dict) -> None:
        raise NotImplementedError

    def recv(self) -> Optional[dict]:
        raise NotImplementedError

    def close(self, *, flush: bool = True) -> None:
        """Tear down the channel. ``flush=True`` (graceful paths: drain,
        worker exit) waits briefly for queued frames to reach the wire;
        ``flush=False`` (death paths: lease expiry, kill, partition
        simulation) tears down immediately — waiting on a wedged peer
        there would stall failover."""
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class PipeTransport(Transport):
    """The round-12 medium behind the Transport interface: immediate
    locked frame writes, blocking frame reads, on a pipe pair."""

    kind = "pipe"

    def __init__(self, write_stream: IO[bytes], read_stream: IO[bytes]):
        self._w = write_stream
        self._r = read_stream
        self._lock = threading.Lock()
        self._closed = False
        self.writes = 0
        self.frames = 0

    def send(self, obj: dict) -> None:
        self.send_bytes(self.encode_for_peer(obj))

    def send_bytes(self, data: bytes) -> None:
        with self._lock:
            if self._closed:
                raise TransportClosed("pipe transport closed")
            self._w.write(data)
            self._w.flush()
            self.writes += 1
            self.frames += 1

    def recv(self) -> Optional[dict]:
        meta: dict = {}
        try:
            frame = read_frame(self._r, meta=meta)
        except (FrameError, OSError, ValueError):
            return None
        self._note_recv_meta(meta)
        return frame

    def close(self, *, flush: bool = True) -> None:
        # Pipe writes are immediate (send flushes), so there is nothing
        # queued to wait for either way.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for stream in (self._w, self._r):
                try:
                    stream.close()
                except OSError:
                    pass

    @property
    def closed(self) -> bool:
        return self._closed


class SocketTransport(Transport):
    """Frames over one connected TCP socket, writes coalesced.

    ``send()`` never blocks on the network: it appends the encoded frame
    to the outbound queue and wakes the flusher, which drains the WHOLE
    queue into a single ``sendall``. Concurrent senders (the router's
    request threads, the worker's response pool) therefore share syscalls
    instead of serializing on them — the pipelined frame I/O the
    round-16 transport exists for. ``pipelined=False`` degrades to a
    direct locked ``sendall`` per frame (the comparison baseline).

    A send error (peer gone) closes the socket, which pops the blocking
    ``recv`` with ``None`` — one death signal, the same one pipe EOF
    gives, so the router's failover path needs no new cases.
    """

    kind = "tcp"

    def __init__(
        self, sock: socket.socket, *, pipelined: bool = True, rfile=None
    ):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        # The hello exchange reads from a buffered file over this socket
        # BEFORE the transport exists; reuse that exact object — a fresh
        # makefile would silently drop whatever the first one buffered
        # past the hello frame.
        self._rfile = rfile if rfile is not None else sock.makefile("rb")
        self._lock = threading.Lock()
        self._pending: list = []
        self._inflight = False  # flusher holds a popped batch mid-sendall
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._pipelined = pipelined
        self.writes = 0
        self.frames = 0
        self.peer = None
        try:
            self.peer = "%s:%d" % sock.getpeername()[:2]
        except OSError:
            pass
        self._flusher = None
        if pipelined:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="fleet-tcp-flush", daemon=True
            )
            self._flusher.start()

    # -- writing -------------------------------------------------------
    def send(self, obj: dict) -> None:
        self.send_bytes(self.encode_for_peer(obj))

    def send_bytes(self, data: bytes) -> None:
        if self._pipelined:
            with self._wake:
                if self._closed:
                    raise TransportClosed("tcp transport closed")
                self._pending.append(data)
                self.frames += 1
                self._wake.notify()
            return
        with self._lock:
            if self._closed:
                raise TransportClosed("tcp transport closed")
            try:
                self._sock.sendall(data)
            except OSError:
                self._teardown_locked()
                raise
            self.writes += 1
            self.frames += 1

    def _flush_loop(self) -> None:
        while True:
            with self._wake:
                self._inflight = False
                while not self._pending and not self._closed:
                    self._wake.wait()
                if self._closed and not self._pending:
                    return
                batch, self._pending = self._pending, []
                self._inflight = True
            data = b"".join(batch)
            try:
                self._sock.sendall(data)
            except OSError:
                self.close(flush=False)
                return
            self.writes += 1

    def flush(self, timeout_s: float = 5.0) -> None:
        """Best-effort wait for the outbound queue AND any batch the
        flusher already popped to reach ``sendall`` completion (drain
        frames and final responses must leave before teardown)."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._closed or (not self._pending
                                    and not self._inflight):
                    return
            time.sleep(0.002)

    # -- reading -------------------------------------------------------
    def recv(self) -> Optional[dict]:
        meta: dict = {}
        try:
            frame = read_frame(self._rfile, meta=meta)
        except (FrameError, OSError, ValueError):
            return None
        self._note_recv_meta(meta)
        return frame

    # -- teardown ------------------------------------------------------
    def _teardown_locked(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            self._rfile.close()
        except OSError:
            pass

    def close(self, *, flush: bool = True) -> None:
        if flush and self._pipelined:
            self.flush()
        with self._wake:
            if self._closed:
                return
            self._teardown_locked()
            self._wake.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


# ----------------------------------------------------------------------
# Chaos layer (round 18): dirty-link fault injection
# ----------------------------------------------------------------------
#: Fault-registry sites (``utils.resilience.FAULTS`` / ``GHS_FAULT_*``)
#: the chaos wrapper consults per frame. All existing drills inject only
#: CLEAN failures (os._exit, socket close); these are the dirty ones real
#: cross-host links produce:
#:
#: * ``fleet.chaos.drop``    — drop the next N outbound frames (kind
#:   ``raise``; ``GHS_FAULT_FLEET_CHAOS_DROP=N``) — a transient blackhole.
#: * ``fleet.chaos.corrupt`` — corrupt the next N outbound frames' bytes
#:   (kind ``torn``; the peer's framing raises ``FrameError`` and drops
#:   the channel — the corrupt-prefix-must-not-size-an-allocation path).
#: * ``fleet.chaos.delay``   — add ``value`` seconds to the next N sends
#:   (kind ``slow``) — a latency spike.
#: * ``fleet.chaos.payload`` — corrupt the next N inbound RESULT payloads
#:   *past framing* (kind ``torn``): the frame decodes cleanly (length ok,
#:   checksum ok — the corruption model is a bad worker/cache, not a bad
#:   wire), but the decoded solve response carries a mutated edge set and
#:   weight. Only the verification layer (``verify/``) can catch this one
#:   — which is exactly what the corruption drill proves it does.
CHAOS_DROP_SITE = "fleet.chaos.drop"
CHAOS_CORRUPT_SITE = "fleet.chaos.corrupt"
CHAOS_DELAY_SITE = "fleet.chaos.delay"
CHAOS_PAYLOAD_SITE = "fleet.chaos.payload"


def corrupt_result_payload(frame: dict) -> dict:
    """Deterministically mutate a decoded solve-response payload the way
    ``fleet.chaos.payload`` models it: the first claimed MST edge becomes
    a self-loop (an edge the input graph cannot contain) and the claimed
    total weight shifts by one — both plausible-looking to every layer
    below verification. Mutates (a copy of) the inner response dict."""
    resp = frame.get("resp")
    target = resp if isinstance(resp, dict) else frame
    target = dict(target)
    if target.get("mst_edges"):
        edges = [list(e) for e in target["mst_edges"]]
        edges[0] = [edges[0][0], edges[0][0]]
        target["mst_edges"] = edges
    if "total_weight" in target:
        target["total_weight"] = target["total_weight"] + 1
    out = dict(frame)
    if isinstance(resp, dict):
        out["resp"] = target
    else:
        out = target
    return out


class ChaosState:
    """One worker's standing fault flags, OWNED BY THE ROUTER and shared
    across that worker's transport incarnations — a partition outlives a
    re-dial (the new connection is just as partitioned), which is what
    makes the partition drill's flap-until-healed behavior honest.

    ``drop_send`` alone is a **one-way partition** (router→worker frames
    vanish; the worker's responses still arrive, so the router sees a
    live-but-unreachable peer until its in-flight work drains and the
    lease expires). ``drop_recv`` too makes it **symmetric**. Latency and
    jitter model a congested link; jitter is deterministic under
    ``seed`` (same drill, same delays)."""

    def __init__(self, *, seed: int = 0, name: str = ""):
        import random

        self.drop_send = False
        self.drop_recv = False
        self.latency_s = 0.0
        self.jitter_s = 0.0
        self._rng = random.Random(f"{seed}:{name}")

    @property
    def partitioned(self) -> bool:
        return self.drop_send or self.drop_recv

    def delay(self) -> float:
        if self.latency_s <= 0 and self.jitter_s <= 0:
            return 0.0
        return self.latency_s + self.jitter_s * self._rng.random()

    def corrupt(self, data: bytes) -> bytes:
        """Deterministically mangle a frame's bytes. The length prefix is
        always hit (digit ^ 0x5A = letter): the peer must refuse the
        header outright — a flip that only grew the declared length would
        instead wedge its reader waiting for bytes that never come, which
        is the lease's job to catch, not framing's — plus seeded interior
        flips so payload-level garbage is exercised too."""
        if not data:
            return data
        buf = bytearray(data)
        buf[0] ^= 0x5A
        if len(buf) > 1:
            # Interior flips start at 1: a flip landing back on byte 0
            # would XOR-revert the mandatory prefix mangle and ship a
            # byte-identical "corrupted" frame.
            for _ in range(max(1, len(buf) // 16)):
                i = self._rng.randrange(1, len(buf))
                buf[i] ^= 0x5A
        return bytes(buf)


class ChaosTransport(Transport):
    """A fault-injectable wrapper around any :class:`Transport`.

    Every outbound frame consults the standing :class:`ChaosState` flags
    plus the ``fleet.chaos.*`` fault-registry sites; inbound frames honor
    the symmetric-partition flag by being read and discarded (from the
    protocol's point of view, identical to the network never delivering
    them). Dropping is *silent* — exactly like a real partition: the
    sender learns nothing until silence expires the lease.
    """

    def __init__(self, inner: Transport, state: ChaosState):
        self._inner = inner
        self.state = state

    @property
    def kind(self) -> str:  # the router keys lease accounting off this
        return self._inner.kind

    @property
    def crc_out(self) -> bool:
        return self._inner.crc_out

    def enable_crc(self) -> None:
        self._inner.enable_crc()

    @property
    def wire_out(self) -> bool:
        return self._inner.wire_out

    def enable_wire(self) -> None:
        self._inner.enable_wire()

    @property
    def writes(self) -> int:
        return self._inner.writes

    @property
    def frames(self) -> int:
        return self._inner.frames

    @property
    def peer(self):
        return getattr(self._inner, "peer", None)

    def send(self, obj: dict) -> None:
        from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

        data = self._inner.encode_for_peer(obj)
        state = self.state
        armed_delay = FAULTS.pop(CHAOS_DELAY_SITE)
        delay = state.delay() + (
            armed_delay.value if armed_delay is not None else 0.0
        )
        if delay > 0:
            import time

            from distributed_ghs_implementation_tpu_torch.obs.events import BUS

            BUS.record("fleet.chaos.delay_s", delay)
            time.sleep(delay)
        # Pop the one-shot drop AND corrupt sites BEFORE the standing-
        # partition return: short-circuiting would leave an armed shot
        # unconsumed behind a partition and fire it on the first
        # post-heal frame instead (a "healed" link that immediately
        # drops or corrupts would read as a failed warm rejoin).
        drop_shot = FAULTS.pop(CHAOS_DROP_SITE)
        corrupt_shot = FAULTS.pop(CHAOS_CORRUPT_SITE)
        if state.drop_send or drop_shot is not None:
            from distributed_ghs_implementation_tpu_torch.obs.events import BUS

            BUS.count("fleet.chaos.dropped")
            return  # a partitioned link swallows the frame silently
        if corrupt_shot is not None:
            from distributed_ghs_implementation_tpu_torch.obs.events import BUS

            BUS.count("fleet.chaos.corrupted")
            data = state.corrupt(data)
        self._inner.send_bytes(data)

    def recv(self) -> Optional[dict]:
        from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

        while True:
            frame = self._inner.recv()
            if frame is None:
                return None
            if not self.state.drop_recv:
                # Payload corruption fires PAST framing, on decoded solve
                # responses that actually carry a result edge set — the
                # shot is consumed only by a corruptible frame, so an
                # armed count maps 1:1 onto corrupted results (exact
                # drill counters). Length and checksum were both valid:
                # nothing below the verification layer can object.
                resp = frame.get("resp") if isinstance(
                    frame.get("resp"), dict
                ) else frame
                if resp.get("mst_edges") and FAULTS.pop(
                    CHAOS_PAYLOAD_SITE
                ) is not None:
                    from distributed_ghs_implementation_tpu_torch.obs.events import (
                        BUS,
                    )

                    BUS.count("fleet.chaos.payload_corrupted")
                    frame = corrupt_result_payload(frame)
                return frame
            from distributed_ghs_implementation_tpu_torch.obs.events import BUS

            BUS.count("fleet.chaos.dropped")  # symmetric partition: eat it

    def flush(self, timeout_s: float = 5.0) -> None:
        inner_flush = getattr(self._inner, "flush", None)
        if inner_flush is not None:
            inner_flush(timeout_s)

    def close(self, *, flush: bool = True) -> None:
        self._inner.close(flush=flush)

    @property
    def closed(self) -> bool:
        return self._inner.closed


# ----------------------------------------------------------------------
# Connection establishment
# ----------------------------------------------------------------------
class WorkerListener:
    """The router's dial-in rendezvous: spawned (or externally started)
    TCP workers connect here and send their hello frame; each validated
    hello is handed to ``on_hello(hello, transport)``. Rejections
    (version mismatch, garbage) close the connection and are reported via
    ``on_reject(reason)`` so the router can surface them instead of
    timing out mutely."""

    def __init__(
        self,
        on_hello: Callable[[dict, SocketTransport], None],
        *,
        host: str = "127.0.0.1",
        on_reject: Optional[Callable[[str], None]] = None,
        pipelined: bool = True,
    ):
        self._on_hello = on_hello
        self._on_reject = on_reject or (lambda reason: None)
        self._pipelined = pipelined
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="fleet-listener", daemon=True
        )
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._register, args=(conn,),
                name="fleet-hello", daemon=True,
            ).start()

    def _register(self, conn: socket.socket) -> None:
        conn.settimeout(10.0)  # a dialer that never says hello can't wedge us
        rfile = conn.makefile("rb")
        try:
            hello = read_frame(rfile, max_bytes=_MAX_HELLO_BYTES)
            if hello is None:
                raise HelloError("connection closed before hello")
            hello = check_hello(hello)
        except (HelloError, FrameError, OSError, ValueError) as e:
            self._on_reject(f"{type(e).__name__}: {e}")
            try:
                conn.close()
            except OSError:
                pass
            return
        conn.settimeout(None)
        transport = SocketTransport(conn, pipelined=self._pipelined, rfile=rfile)
        try:
            self._on_hello(hello, transport)
        except Exception as e:  # noqa: BLE001 — a bad hello must not kill accept
            self._on_reject(f"{type(e).__name__}: {e}")
            transport.close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


def connect_to_worker(
    addr: str, *, timeout_s: float = 10.0, pipelined: bool = True
) -> Tuple[dict, SocketTransport]:
    """Dial an externally started worker listening on ``addr``
    (``fleet.worker --listen``); the worker sends its hello on accept.
    Returns ``(hello, transport)`` or raises ``OSError`` /
    :class:`HelloError`."""
    host, port = parse_hostport(addr)
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(timeout_s)
    rfile = sock.makefile("rb")
    try:
        hello = read_frame(rfile, max_bytes=_MAX_HELLO_BYTES)
        if hello is None:
            raise HelloError(f"worker at {addr} closed before hello")
        hello = check_hello(hello)
    except (FrameError, HelloError, OSError):
        sock.close()
        raise
    sock.settimeout(None)
    return hello, SocketTransport(sock, pipelined=pipelined, rfile=rfile)
