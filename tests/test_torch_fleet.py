"""The port's ``fleet/`` (hashing, transport, worker, router) against the JAX
package's, on the CPU.

* Pure parts, held equal on the same inputs: ring placements and their
  moves under add, remove and churn; hellos, their rejections and a hello
  fuzz; restart backoff sequences; the chaos layer's seeded delays and
  corruptions; the router's certificates, routing keys and oversize test.
* Echo fleets (real subprocesses, pipes and TCP, canned answers, no solve):
  the port's routes each digest to the worker a JAX echo fleet of the same
  config picks; update chains stick to the session worker; a kill mid
  traffic re-queues every accepted request and restarts the worker; drain
  and SIGTERM exit 0; a partition expires the lease and heals with a warm
  rejoin; a corrupted frame drops the channel and re-queues. As the JAX
  package's ``tests/test_fleet.py`` runs them.
* Real-service fleets on the CPU (``device="cpu"``, a shared disk store):
  the service deck's solves, repeats and updates answer equal, after
  ``_strip``, to the JAX ``MSTService`` in this process; a killed worker's
  digests are answered through the disk store; hellos read
  ``kernel: "torch"``.
* Interop: a JAX router dials a port ``--listen`` worker, and a port router
  dials a JAX one.
* Where the port differs on purpose: a worker without CUDA that was not
  given ``--device cpu`` exits non-zero before its hello, and the router's
  ``start()`` raises; a pipe worker's stray stdout never reaches the frame
  channel; the echo path touches no device; the fleet imports nothing of
  JAX.

Tests wait on events and states (pending maps, liveness), not on sleeps,
and every subprocess wait has a timeout.
"""

import io
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.fleet import framing as jframing
from distributed_ghs_implementation_tpu.fleet import hashing as jhashing
from distributed_ghs_implementation_tpu.fleet import router as jrouter
from distributed_ghs_implementation_tpu.fleet import transport as jtransport
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.models.rank_solver import solve_graph_kruskal_host
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.serve import service as jsvc
from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy
from distributed_ghs_implementation_tpu_torch.fleet import framing as tframing
from distributed_ghs_implementation_tpu_torch.fleet import hashing as thashing
from distributed_ghs_implementation_tpu_torch.fleet import router as trouter
from distributed_ghs_implementation_tpu_torch.fleet import transport as ttransport
from distributed_ghs_implementation_tpu_torch.fleet import worker as tworker
from distributed_ghs_implementation_tpu_torch.obs import tracing as ttracing
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS as TFAULTS
from test_torch_service import _build_deck, _strip
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_WORKER = "distributed_ghs_implementation_tpu_torch.fleet.worker"
JAX_WORKER = "distributed_ghs_implementation_tpu.fleet.worker"
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}


@pytest.fixture(autouse=True)
def _clean_buses():
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()
    TFAULTS.reset()
    yield
    TFAULTS.reset()
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()


def _env(extra=None):
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)), **(extra or {})}


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _listening(module, count, *extra):
    """``count`` externally started ``--listen`` workers (ids 0, 1, ...),
    started together, and their addresses."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--worker-id", str(i), "--listen", "127.0.0.1:0",
         *extra], stderr=subprocess.PIPE, env=_env()) for i in range(count)]
    addrs = []
    for proc in procs:
        line = proc.stderr.readline().decode()
        assert "listening on" in line, line
        addrs.append(line.rsplit(" ", 1)[-1].strip())
    return procs, addrs


def _reap(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


# ----------------------------------------------------------------------
# Pure parts, held equal to the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("replicas", [16, 64])
def test_ring_placements_and_moves_equal_jax(replicas):
    keys = [f"digest-{i}" for i in range(10_000)]
    rings = [mod.HashRing(range(6), replicas=replicas) for mod in (jhashing, thashing)]

    def place():
        got = [[r.assign(k) for k in keys] for r in rings]
        assert got[1] == got[0]
        return got[1]

    base = place()
    assert set(base) == set(range(6))
    for r in rings:
        r.add(6), r.add(7), r.add(3)  # the re-add of a member is a no-op
    grown = place()
    moved = [i for i in range(len(keys)) if grown[i] != base[i]]
    assert moved and all(grown[i] in (6, 7) for i in moved)  # only the joiners take keys
    for r in rings:
        r.remove(2), r.remove(99)  # the removal of an absent member is a no-op
    shrunk = place()
    assert all(shrunk[i] == grown[i] for i in range(len(keys)) if grown[i] != 2)
    rng = random.Random(7)
    for _ in range(40):
        m = rng.randrange(0, 12)
        remove = rng.random() < 0.5 and len(rings[1]) > 1
        for r in rings:
            (r.remove if remove else r.add)(m)
    churned = place()
    fresh = thashing.HashRing(sorted(rings[1].members()), replicas=replicas)
    assert [fresh.assign(k) for k in keys] == churned
    assert len(rings[1]._points) == len(rings[1]) * replicas
    with pytest.raises(LookupError):
        thashing.HashRing().assign("x")


def test_hello_round_trip_equal_jax_and_read_across_packages():
    kw = dict(caps={"lane": True, "stream": False, "kernel": "cuda"}, token="tok-1",
              lease_s=2.5, warmed=True)
    hellos = [mod.build_hello(3, **kw) for mod in (jtransport, ttransport)]
    assert hellos[1] == hellos[0]
    assert hellos[1]["proto"] == ttransport.PROTO_VERSION == jtransport.PROTO_VERSION == 1
    for check in (jtransport.check_hello, ttransport.check_hello):
        for hello in hellos:
            assert check(dict(hello)) == hellos[0]
    assert {k: hellos[1]["caps"][k] for k in ("crc", "trace", "wire", "warmed")} == {
        "crc": True, "trace": True, "wire": True, "warmed": True}


@pytest.mark.parametrize("cap", ["crc", "trace", "wire"])
def test_hello_legacy_caps_equal_jax(monkeypatch, cap):
    monkeypatch.setenv(f"GHS_FLEET_{cap.upper()}", "0")
    hellos = [mod.build_hello(0) for mod in (jtransport, ttransport)]
    assert hellos[1] == hellos[0] and hellos[1]["caps"][cap] is False


@pytest.mark.parametrize("frame", [
    {"ready": True, "proto": 8, "worker": 0, "pid": 5, "caps": {}},
    {"pong": 1},
    {"ready": True, "proto": 1, "pid": 5},
    {"ready": True, "proto": 1, "worker": 2, "caps": ["not", "a", "dict"]},
])
def test_hello_rejections_equal_jax(frame):
    got = []
    for mod in (jtransport, ttransport):
        try:
            got.append(("ok", mod.check_hello(dict(frame))))
        except mod.HelloError as e:
            got.append(("HelloError", str(e)))
    assert got[1] == got[0]


def test_hello_fuzz_equal_jax():
    rng = np.random.default_rng(99)
    keys = ["ready", "proto", "worker", "pid", "caps", "token", "lease_s"]
    values = [True, False, None, 0, 1, 1, -3, "x", [], {}, {"lane": True}, 2**63, "☃"]
    accepted = 0
    for _ in range(300):
        frame = {keys[int(rng.integers(0, len(keys)))]: values[int(rng.integers(0, len(values)))]
                 for _ in range(int(rng.integers(0, 6)))}
        got = []
        for mod in (jtransport, ttransport):
            try:
                hello = mod.check_hello(dict(frame))
                assert hello["proto"] == 1 and hello.get("worker") is not None
                assert isinstance(hello["caps"], dict)
                got.append(hello)
            except mod.HelloError as e:  # the only exception either may raise
                got.append(str(e))
        assert got[1] == got[0]
        accepted += isinstance(got[1], dict)
    assert accepted > 0


@pytest.mark.parametrize("seed,jitter", [(42, 0.5), (43, 0.5), (7, 1.0), (0, 0.0)])
def test_backoff_sequences_equal_jax(seed, jitter):
    seqs = []
    for mod in (jrouter, trouter):
        r = mod.FleetRouter(mod.FleetConfig(workers=1, test_echo=True, restart_jitter=jitter,
                                            restart_jitter_seed=seed))
        seqs.append([r._backoff_s(w, k) for w in range(6) for k in range(10)])
    assert seqs[1] == seqs[0]
    assert all(0 < x <= 2.0 for x in seqs[1])
    if jitter:
        assert len(set(seqs[1][8::10])) == 6  # one attempt, six workers: six sleeps


def test_chaos_state_equal_jax():
    data = b"37\n" + b"x" * 37 + b"\n"
    for seed, name in ((7, "0"), (8, "3")):
        states = [mod.ChaosState(seed=seed, name=name) for mod in (jtransport, ttransport)]
        for s in states:
            s.latency_s, s.jitter_s = 0.01, 0.02
        assert [states[1].delay() for _ in range(16)] == [states[0].delay() for _ in range(16)]
        assert states[1].corrupt(data) == states[0].corrupt(data) != data
    frame = {"id": 1, "resp": {"ok": True, "total_weight": 10, "mst_edges": [[0, 1], [1, 2]]}}
    assert ttransport.corrupt_result_payload(frame) == jtransport.corrupt_result_payload(frame)
    flat = {"ok": True, "total_weight": 3, "mst_edges": [[4, 5]]}
    assert ttransport.corrupt_result_payload(flat) == jtransport.corrupt_result_payload(flat)


def test_chaos_payload_corrupts_only_result_frames():
    r1, w1 = os.pipe()
    writer = ttransport.PipeTransport(os.fdopen(w1, "wb"), io.BytesIO())
    reader = ttransport.ChaosTransport(
        ttransport.PipeTransport(io.BytesIO(), os.fdopen(r1, "rb")), ttransport.ChaosState())
    try:
        TFAULTS.arm(ttransport.CHAOS_PAYLOAD_SITE, times=1)
        result = {"id": 1, "resp": {"ok": True, "total_weight": 10, "mst_edges": [[0, 1], [1, 2]]}}
        writer.send({"pong": 3})
        writer.send(dict(result))
        writer.send({"id": 2, "resp": dict(result["resp"])})
        assert reader.recv() == {"pong": 3}
        assert reader.recv()["resp"]["mst_edges"][0] == [0, 0]
        assert reader.recv()["resp"]["total_weight"] == 10
        assert TBUS.counters().get("fleet.chaos.payload_corrupted") == 1
    finally:
        writer.close()
        reader.close()


@pytest.mark.parametrize("router_mod,worker_mod", [(ttransport, ttransport),
                                                   (jtransport, ttransport),
                                                   (ttransport, jtransport)])
def test_crc_and_wire_echo_on_receipt_across_packages(router_mod, worker_mod):
    """A worker's transport takes up checksums and B-frames after the first
    inbound frame that carries them, whichever package is on either end."""
    r1, w1 = os.pipe()
    r2, w2 = os.pipe()
    router_side = router_mod.PipeTransport(os.fdopen(w1, "wb"), os.fdopen(r2, "rb"))
    worker_side = worker_mod.PipeTransport(os.fdopen(w2, "wb"), os.fdopen(r1, "rb"))
    try:
        worker_side.send(worker_mod.build_hello(0))
        assert router_side.recv()["ready"] and not worker_side.crc_out
        router_side.enable_crc()
        router_side.enable_wire()
        framing = jframing if router_mod is jtransport else tframing
        sections = framing.WireSections().add("u", np.arange(4, dtype=np.int32))
        router_side.send({"id": 1, "req": {"op": "solve", framing.SECTIONS_KEY: sections}})
        got = worker_side.recv()
        assert worker_side.crc_out and worker_side.wire_out
        assert list(got["req"][framing.SECTIONS_KEY].array("u")) == [0, 1, 2, 3]
        worker_side.send({"pong": 1})
        assert router_side.recv() == {"pong": 1}
    finally:
        router_side.close()
        worker_side.close()


def _kruskal_claim(gen):
    g = gen.gnm_random_graph(48, 120, seed=3)
    ids, _, _ = solve_graph_kruskal_host(g)
    request = {"op": "solve", "num_nodes": g.num_nodes,
               "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]}
    good = {"ok": True, "mst_edges": [[int(a), int(b)] for a, b in zip(g.u[ids], g.v[ids])],
            "total_weight": int(np.sum(g.w[ids]))}
    return request, good


def test_router_certificates_equal_jax():
    request, good = _kruskal_claim(jgen)
    cases = [(request, good), (request, dict(good, total_weight=good["total_weight"] + 1)),
             (request, dict(good, mst_edges=[[0, 0]] + good["mst_edges"][1:])),
             ({"op": "solve", "digest": "d"}, good),
             (request, {"ok": True, "total_weight": 3})]
    cases += [(request, dict(good, mst_edges=junk))
              for junk in ([[0, 1], [2]], [["a", "b"]], [[0]], ["nope and nope"])]
    cases += [(request, dict(good, mst_edges=good["mst_edges"][:-1]))]
    for req, resp in cases:
        got = [mod.FleetRouter._certify_solve_response(req, resp)
               for mod in (jrouter, trouter)]
        if got[0] is None:
            assert got[1] is None
            continue
        assert (got[1].ok, got[1].reason, got[1].engine) == (got[0].ok, got[0].reason, "np")
    assert trouter.FleetRouter._certify_solve_response(request, good).ok


def test_routing_keys_and_oversize_equal_jax():
    """Edge lists, B-frame headers (with and without the digest hint) and
    paths key the same worker in both packages; the oversize test is
    JAX's, and its mirrored ceilings are the port's BatchPolicy defaults."""
    policy = BatchPolicy()
    assert (trouter._OVERSIZE_NODE_BUCKET, trouter._OVERSIZE_EDGE_BUCKET) == (
        policy.max_bucket_nodes, policy.max_bucket_edges)
    g = jgen.gnm_random_graph(30, 90, seed=16)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]
    wire = jframing.encode_bframe({"op": "solve", **g.to_wire()})
    nohint = {k: v for k, v in tframing.read_frame(io.BytesIO(wire)).items() if k != "digest"}
    requests = [
        {"op": "solve", "num_nodes": 30, "edges": edges},
        {"op": "solve", "graph_path": "g.npz"}, {"op": "solve", "digest": "abc"},
        {"op": "update", "digest": "u1"}, {"op": "poll", "stream": "s1"},
        {"op": "publish", "stream": "s1", "digest": "h1"}, {"op": "stats"},
        {"op": "solve", "num_nodes": 200_000, "edges": [[0, 1, 1]]},
        {"op": "solve", "num_nodes": 4, "edges": [[0, 1, 1]] * 300_000},
    ]
    routers = [mod.FleetRouter(mod.FleetConfig(workers=1, test_echo=True))
               for mod in (jrouter, trouter)]
    for req in requests:
        assert routers[1]._routing_key(req) == routers[0]._routing_key(req)
        assert trouter._request_oversize(req) == jrouter._request_oversize(req)
    for framing, router in ((jframing, routers[0]), (tframing, routers[1])):
        req = framing.read_frame(io.BytesIO(wire))
        assert router._routing_key(req) == g.digest()
    assert routers[1]._routing_key(nohint) == g.digest()


def test_worker_argv_runs_the_port_worker_on_the_device():
    base = dict(workers=1, disk_dir="/d", verify="full", compile_cache_dir="/c",
                warmup_buckets="128x512")
    j = jrouter.FleetRouter(jrouter.FleetConfig(**base))
    for device, extra in ((None, []), ("cpu", ["--device", "cpu"])):
        t = trouter.FleetRouter(trouter.FleetConfig(device=device, **base))
        jw, tw = j._workers[0], t._workers[0]
        jargv, targv = j._worker_argv(jw), t._worker_argv(tw)
        assert targv[2] == PORT_WORKER and jargv[2] == JAX_WORKER
        assert targv[3:] == jargv[3:] + extra
        assert trouter.FleetConfig(device=device).device == device


# ----------------------------------------------------------------------
# Where the port differs on purpose
# ----------------------------------------------------------------------
def test_fleet_imports_nothing_of_jax_and_echo_touches_no_device():
    code = """
import json, sys
sys.modules["jax"] = None
import distributed_ghs_implementation_tpu_torch.fleet as fleet
from distributed_ghs_implementation_tpu_torch.fleet import (
    autoscaler, framing, hashing, journal, router, transport, worker)
args = worker.build_parser().parse_args(["--worker-id", "0", "--test-echo"])
service = worker._build_service(args)
hello = worker._hello_for(args)
import torch
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "distributed_ghs_implementation_tpu"
                  or m.startswith("distributed_ghs_implementation_tpu.")),
    "solver": sorted(m for m in sys.modules if m.endswith((".serve.service", ".ops.kernels",
                                                           ".models.boruvka"))),
    "cuda": torch.cuda.is_initialized(), "kernel": hello["caps"]["kernel"],
    "tuned": "tuned" in hello["caps"], "exports": sorted(fleet.__all__)}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    from distributed_ghs_implementation_tpu import fleet as jfleet

    assert got == {"jax": [], "solver": [], "cuda": False, "kernel": "echo", "tuned": False,
                   "exports": sorted(jfleet.__all__)}


def test_worker_without_cuda_or_a_device_exits_nonzero_before_its_hello():
    proc = subprocess.run([sys.executable, "-m", PORT_WORKER, "--worker-id", "0"],
                          input=b"", capture_output=True, env=_env(NO_CUDA), timeout=120)
    assert proc.returncode != 0
    assert b"RuntimeError: CUDA is not available" in proc.stderr
    assert proc.stdout == b""  # no hello: it never answers from the CPU


def test_router_start_raises_when_a_worker_has_no_device(monkeypatch):
    for key, value in NO_CUDA.items():
        monkeypatch.setenv(key, value)
    router = trouter.FleetRouter(trouter.FleetConfig(workers=2, ready_timeout_s=120.0))
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 1 before its hello"):
        router.start()
    assert time.monotonic() - t < 60  # at once, not at the ready timeout
    assert not any(w.ready.is_set() for w in router._workers)
    assert all(w.proc.wait(timeout=10) is not None for w in router._workers)


def test_pipe_worker_stray_stdout_never_reaches_the_frame_channel():
    code = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
from distributed_ghs_implementation_tpu_torch.fleet import worker
real = worker.EchoService.handle
def noisy(self, request):
    print("stray print")
    sys.stdout.flush()
    os.write(1, b"stray bytes from C\\n")
    return real(self, request)
worker.EchoService.handle = noisy
sys.exit(worker.main(["--worker-id", "0", "--test-echo"]))
"""
    proc = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env())
    try:
        assert tframing.read_frame(proc.stdout)["ready"]
        tframing.write_frame(proc.stdin, {"id": 1, "req": {"op": "solve", "digest": "d"}})
        assert tframing.read_frame(proc.stdout)["resp"]["ok"]
        proc.stdin.close()
        assert tframing.read_frame(proc.stdout) == {"bye": True, "worker": 0}
        assert proc.wait(timeout=30) == 0
        err = proc.stderr.read()
        assert b"stray print" in err and b"stray bytes from C" in err
    finally:
        _reap(proc)


# ----------------------------------------------------------------------
# Echo fleets: the port's routes as a JAX fleet of the same config does
# ----------------------------------------------------------------------
def _echo_config(mod, transport, workers=3, **kw):
    defaults = dict(workers=workers, test_echo=True, transport=transport,
                    heartbeat_interval_s=0.1, restart_backoff_base_s=0.02,
                    restart_backoff_cap_s=0.2, ready_timeout_s=120.0, request_timeout_s=30.0)
    defaults.update(kw)
    return mod.FleetConfig(**defaults)


@pytest.fixture(scope="module", params=["pipe", "tcp"])
def echo_fleets(request):
    port = trouter.FleetRouter(_echo_config(trouter, request.param)).start()
    jax = jrouter.FleetRouter(_echo_config(jrouter, request.param)).start()
    yield types.SimpleNamespace(port=port, jax=jax, transport=request.param)
    port.shutdown()
    jax.shutdown()
    assert all(w.proc.wait(timeout=10) == 0 for w in port._workers)


def test_echo_fleet_routes_each_digest_as_jax(echo_fleets):
    digests = [f"d{i}" for i in range(24)]
    got = {name: {d: r.handle({"op": "solve", "digest": d})["worker"] for d in digests}
           for name, r in (("jax", echo_fleets.jax), ("port", echo_fleets.port))}
    assert got["port"] == got["jax"]
    assert set(got["port"].values()) == {0, 1, 2}
    for d, w in got["port"].items():
        assert echo_fleets.port.handle({"op": "solve", "digest": d})["worker"] == w


def test_echo_update_chain_sticks_to_the_session_worker(echo_fleets):
    r = echo_fleets.port
    solved = r.handle({"op": "solve", "digest": "chain-seed"})
    digest, workers = "chain-seed", set()
    for _ in range(5):
        resp = r.handle({"op": "update", "digest": digest, "updates": [{"k": 1}]})
        assert resp["ok"] and resp["prev_digest"] == digest
        digest = resp["digest"]
        workers.add(resp["worker"])
    assert workers == {solved["worker"]}


def test_echo_kill_mid_traffic_requeues_every_accepted_request(echo_fleets):
    r = echo_fleets.port
    victim = r.handle({"op": "solve", "digest": "kill-probe"})["worker"]
    restarts = r._workers[victim].restarts
    assert r.arm_worker_fault(victim, times=1)
    digests = ["kill-probe"] + [f"k{i}" for i in range(15)]
    results = {}
    threads = [threading.Thread(target=lambda d=d: results.__setitem__(
        d, r.handle({"op": "solve", "digest": d, "slo_class": "x"}))) for d in digests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == len(digests) and all(v["ok"] for v in results.values())
    assert any(v.get("requeued") for v in results.values())
    assert results["kill-probe"]["worker"] != victim
    counters = TBUS.counters()
    assert counters.get("fleet.worker.dead") == 1 and counters.get("fleet.requeue", 0) >= 1
    assert _wait(lambda: r._workers[victim].alive), "the worker never rejoined"
    assert r._workers[victim].restarts == restarts + 1
    # It serves its keyspace again: a digest the ring gives it, never served.
    ring = thashing.HashRing(range(3), replicas=r.config.ring_replicas)
    fresh = next(f"own-{i}" for i in range(1000) if ring.assign(f"own-{i}") == victim)
    assert r.handle({"op": "solve", "digest": fresh})["worker"] == victim


def test_echo_kill_requeue_keeps_the_trace(echo_fleets):
    r = echo_fleets.port
    victim = r.handle({"op": "solve", "digest": "trace-kill"})["worker"]
    assert r.arm_worker_fault(victim, times=1)
    TBUS.clear()
    ctx = ttracing.mint("interactive")
    token = ttracing.activate(ctx)
    try:
        resp = r.handle({"op": "solve", "digest": "trace-kill"})
    finally:
        ttracing.deactivate(token)
    assert resp["ok"] and resp.get("requeued", 0) >= 1
    spans = {}
    for _ph, name, _cat, _ts, _dur, _tid, args in TBUS.events():
        if args and args.get("trace") == ctx.trace_id:
            spans.setdefault(name, []).append(args)
    (root,) = spans["fleet.request"]
    attempts = spans["fleet.attempt"]
    assert attempts and all(a["parent"] == root["span"] for a in attempts)
    redispatches = spans["fleet.requeue.dispatch"]
    assert redispatches and all(red["parent"] in {a["span"] for a in attempts}
                                for red in redispatches)
    assert _wait(lambda: r._workers[victim].alive)


def test_echo_stats_aggregate_the_workers(echo_fleets):
    r = echo_fleets.port
    assert r.handle({"op": "solve", "digest": "stats-probe"})["ok"]
    stats = r.handle({"op": "stats"})
    assert stats["ok"] and stats["counters"].get("echo.handled", 0) >= 1
    assert stats["ring"] == [0, 1, 2] and set(stats["workers"]) == {"0", "1", "2"}
    assert stats["transport"] == echo_fleets.transport
    assert {w["transport"] for w in stats["workers"].values()} == {echo_fleets.transport}
    assert {w["caps"]["kernel"] for w in stats["workers"].values()} == {"echo"}


def test_tcp_socket_close_requeues_the_in_flight_request():
    """A TCP worker's socket hard-closed while it is mid-request, its
    process alive: the request re-queues onto a survivor, and the late
    answer of the limping worker reaches no client."""
    with trouter.FleetRouter(_echo_config(trouter, "tcp", workers=2)) as r:
        victim = r.handle({"op": "solve", "digest": "conn-loss"})["worker"]
        results = []
        t = threading.Thread(target=lambda: results.append(r.handle(
            {"op": "solve", "digest": "conn-loss", "sleep_s": 1.0})))
        t.start()
        assert _wait(lambda: r._workers[victim].pending, 10)
        r.close_worker_connection(victim)
        t.join(timeout=30)
        assert results and results[0]["ok"] and results[0]["worker"] != victim
        assert results[0].get("requeued", 0) >= 1
        assert r.handle({"op": "solve", "digest": "conn-loss"})["ok"]
        assert _wait(lambda: r._workers[victim].alive)


@pytest.mark.parametrize("transport", ["pipe", "tcp"])
def test_graceful_drain_answers_in_flight_and_exits_zero(transport):
    r = trouter.FleetRouter(_echo_config(trouter, transport, workers=1,
                                         heartbeat_interval_s=0.2)).start()
    results = []
    t = threading.Thread(target=lambda: results.append(
        r.handle({"op": "solve", "digest": "inflight", "sleep_s": 0.5})))
    t.start()
    assert _wait(lambda: r._workers[0].pending, 10)
    r.shutdown(drain=True)
    t.join(timeout=10)
    assert results and results[0]["ok"]
    assert r._workers[0].proc.returncode == 0


def test_worker_sigterm_drains_and_exits_zero():
    proc = subprocess.Popen([sys.executable, "-m", PORT_WORKER, "--worker-id", "0",
                             "--test-echo"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            env=_env())
    try:
        assert tframing.read_frame(proc.stdout)["ready"]
        tframing.write_frame(proc.stdin, {"id": 1, "req": {"op": "solve", "digest": "d"}})
        assert tframing.read_frame(proc.stdout)["resp"]["ok"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        _reap(proc)


def test_sheds_a_configured_class_when_the_queue_is_full():
    cfg = _echo_config(trouter, "pipe", workers=1, queue_depth=1,
                       shed_classes=("droppable",), heartbeat_interval_s=0.2)
    with trouter.FleetRouter(cfg) as r:
        slow = threading.Thread(target=r.handle,
                                args=({"op": "solve", "digest": "slow", "sleep_s": 2.0},))
        slow.start()
        assert _wait(lambda: r._workers[0].pending, 10)
        shed = r.handle({"op": "solve", "digest": "x", "slo_class": "droppable"})
        assert shed["shed"] and not shed["ok"]
        assert r.handle({"op": "solve", "digest": "y", "slo_class": "gold"})["ok"]
        slow.join()
        assert TBUS.counters().get("fleet.shed") == 1


def test_busy_worker_keeps_its_lease_and_a_draining_one_is_not_dead():
    """A worker stalled in a long request answers pings from its read loop
    and keeps its lease; a retire whose drain outlives the lease is not a
    death."""
    cfg = _echo_config(trouter, "tcp", workers=2, worker_threads=1,
                       heartbeat_interval_s=0.1, lease_s=1.0)
    with trouter.FleetRouter(cfg) as r:
        victim = r.handle({"op": "solve", "digest": "busy-probe"})["worker"]
        assert r.arm_worker_fault(victim, site=tworker.SLOW_SITE, kind="slow", value=2.5)
        resp = r.handle({"op": "solve", "digest": "busy-probe", "slo_class": "x"})
        assert resp["ok"] and resp["worker"] == victim and "requeued" not in resp
        results = []
        t = threading.Thread(target=lambda: results.append(r.handle(
            {"op": "solve", "digest": "busy-probe", "sleep_s": 2.0})))
        t.start()
        assert _wait(lambda: r._workers[victim].pending, 10)
        out = r.retire_worker(victim, timeout_s=0.1)
        t.join(timeout=30)
        assert results and results[0]["ok"] and results[0]["worker"] == victim
        assert out["exit_code"] == 0
        counters = TBUS.counters()
        for name in ("fleet.lease.expired", "fleet.heartbeat.miss", "fleet.worker.dead",
                     "fleet.requeue"):
            assert counters.get(name, 0) == 0, name


def test_tcp_forwarding_probes_the_owner_before_a_local_solve():
    cfg = _echo_config(trouter, "tcp", sharded_lane_workers=1, forward_cache=True,
                       heartbeat_interval_s=0.2)
    ring = thashing.HashRing(range(3), replicas=cfg.ring_replicas)
    d_hit = next(f"fh-{i}" for i in range(1000) if ring.assign(f"fh-{i}") != 0)
    d_miss = next(f"fm-{i}" for i in range(1000) if ring.assign(f"fm-{i}") != 0)
    oversize = {"num_nodes": 200_000, "edges": [[0, 1, 1]]}
    with trouter.FleetRouter(cfg) as r:
        owner = r.handle({"op": "solve", "digest": d_hit})
        assert owner["worker"] == ring.assign(d_hit)
        fwd = r.handle({"op": "solve", "digest": d_hit, **oversize})
        assert fwd["ok"] and fwd["cached"] and fwd["forwarded_from"] == owner["worker"]
        local = r.handle({"op": "solve", "digest": d_miss, **oversize})
        assert local["ok"] and local["worker"] == 0 and "forwarded_from" not in local
        counters = TBUS.counters()
        assert (counters.get("fleet.forward.hit"), counters.get("fleet.forward.miss")) == (1, 1)


def test_router_rejects_a_wrong_protocol_version_as_jax():
    cfg = _echo_config(trouter, "tcp", workers=1, ready_timeout_s=6.0, max_restarts=1,
                       worker_env={0: {"GHS_FLEET_PROTO": "999"}})
    router = trouter.FleetRouter(cfg)
    with pytest.raises(TimeoutError, match="protocol version mismatch"):
        router.start()
    router.shutdown(drain=False)


def test_legacy_worker_without_the_trace_cap_gets_untraced_frames(monkeypatch):
    monkeypatch.setenv("GHS_FLEET_TRACE", "0")
    with trouter.FleetRouter(_echo_config(trouter, "pipe", workers=1)) as r:
        assert r._workers[0].caps.get("trace") is False
        ctx = ttracing.mint("interactive")
        token = ttracing.activate(ctx)
        try:
            assert r.handle({"op": "solve", "digest": "legacy-probe"})["ok"]
        finally:
            ttracing.deactivate(token)
        assert any(args.get("trace") == ctx.trace_id
                   for _ph, name, _c, _t, _d, _tid, args in TBUS.events()
                   if name == "fleet.request" and args)


# ----------------------------------------------------------------------
# The chaos layer over --listen echo workers
# ----------------------------------------------------------------------
def _listen_config(addrs, **kw):
    return _echo_config(trouter, "tcp", workers=1, remote_workers=tuple(addrs), **{
        "ready_timeout_s": 30.0, **kw})


def test_oneway_partition_expires_the_lease_and_heals_with_a_warm_rejoin():
    procs, addrs = _listening(PORT_WORKER, 2, "--test-echo")
    try:
        with trouter.FleetRouter(_listen_config(addrs, chaos=True, lease_s=0.5)) as r:
            for i in range(6):
                assert r.handle({"op": "solve", "digest": f"p{i}"})["ok"]
            pre = r.handle({"op": "stats"})["counters"]["echo.handled"]
            results = []
            t = threading.Thread(target=lambda: results.append(r.handle(
                {"op": "solve", "digest": "pp", "sleep_s": 0.8, "slo_class": "x"})))
            t.start()
            assert _wait(lambda: any(w.pending for w in r._workers), 10)
            victim = next(w.id for w in r._workers if w.pending)
            r.partition_worker(victim, mode="oneway")
            t.join(timeout=30)
            assert results and results[0]["ok"]  # answered once: never lost
            assert _wait(lambda: TBUS.counters().get("fleet.lease.expired", 0) >= 1, 10)
            assert r.handle({"op": "solve", "digest": "during"})["ok"]
            r.heal_partition(victim)
            assert _wait(lambda: r._workers[victim].alive, 20), "no rejoin after the heal"
            post = r.handle({"op": "stats"})
            assert post["counters"]["echo.handled"] >= pre  # the same processes: warm
            assert post["workers"][str(1 - victim)]["restarts"] == 0
            counters = TBUS.counters()
            assert (counters.get("fleet.chaos.partition"), counters.get("fleet.chaos.heal")) == (
                1, 1)
            assert counters.get("fleet.chaos.dropped", 0) >= 1
        assert all(p.wait(timeout=30) == 0 for p in procs)
    finally:
        _reap(*procs)


def test_corrupt_frame_drops_the_channel_and_requeues():
    procs, addrs = _listening(PORT_WORKER, 2, "--test-echo")
    try:
        cfg = _listen_config(addrs, chaos=True, heartbeat_interval_s=5.0)
        with trouter.FleetRouter(cfg) as r:
            assert r.handle({"op": "solve", "digest": "c0"})["ok"]
            pre = r.handle({"op": "stats"})["counters"]["echo.handled"]
            TFAULTS.arm(ttransport.CHAOS_CORRUPT_SITE, times=1)
            resp = r.handle({"op": "solve", "digest": "c1", "slo_class": "x"})
            assert resp["ok"] and resp.get("requeued", 0) >= 1
            assert TBUS.counters().get("fleet.chaos.corrupted") == 1
            assert _wait(lambda: all(w.alive for w in r._workers), 20)
            assert r.handle({"op": "stats"})["counters"]["echo.handled"] >= pre
    finally:
        _reap(*procs)


# ----------------------------------------------------------------------
# Real services on the CPU: the deck answers as the JAX service does
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """The service deck's solves, repeats and updates (up to its streams),
    as built against a JAX service, in JSON and in B-frames."""
    out = {}
    for binary in (False, True):
        root = tmp_path_factory.mktemp(f"deck{int(binary)}")
        requests = []
        for req in _build_deck(root, binary):
            if req.get("op") not in ("solve", "update"):
                break
            requests.append(req)
        assert [r["op"] for r in requests].count("update") == 3
        out[binary] = requests
    return out


def _deck(decks, binary, port_sections=True):
    """One deck; binary requests as the port reads them off the wire unless
    ``port_sections`` is false."""
    return [tframing.read_frame(io.BytesIO(jframing.encode_bframe(req)))
            if port_sections and jframing.SECTIONS_KEY in req else req
            for req in decks[binary]]


def _jax_answers(requests, workers=None, disk_dir=None):
    """The JAX service's answers in this process, sections folded. With
    ``workers``, one JAX service a worker over one disk store, each request
    handled by the service of the worker the fleet sent it to: the same
    topology, so that what a worker holds (its sessions, its cache) is
    what its JAX counterpart holds."""
    services = {}
    out = []
    for i, req in enumerate(requests):
        w = 0 if workers is None else workers[i]
        if w not in services:
            services[w] = jsvc.MSTService(disk_dir=disk_dir)
        if isinstance(req.get(tframing.SECTIONS_KEY), tframing.WireSections):
            req = jframing.read_frame(io.BytesIO(tframing.encode_bframe(req)))
        out.append(jframing.fold_sections(services[w].handle(req)))
    return out


@pytest.mark.usefixtures("isolated")
@pytest.mark.parametrize("binary", [False, True])
def test_cpu_fleet_deck_answers_equal_jax(tmp_path, decks, binary):
    """Two workers on the CPU and a shared disk store: every answer equals
    the JAX services' of the same topology; a repeat is cached on the
    worker that solved it."""
    requests = _deck(decks, binary)
    cfg = trouter.FleetConfig(
        workers=2, device=CPU, disk_dir=str(tmp_path / "store"), no_compile_cache=True,
        heartbeat_interval_s=0.25, ready_timeout_s=180.0, request_timeout_s=120.0)
    with trouter.FleetRouter(cfg) as r:
        got = [tframing.fold_sections(r.handle(req)) for req in requests]
        stats = r.handle({"op": "stats"})
    assert all(w.proc.returncode == 0 for w in r._workers)
    workers = [g.pop("worker") for g in got]
    want = _jax_answers(requests, workers, disk_dir=str(tmp_path / "jax_store"))
    for i, (g, j) in enumerate(zip(got, want)):
        assert _strip(g) == _strip(j), (i, requests[i].get("op"))
    assert got[1]["source"] == "solved" and got[2]["cached"] and workers[2] == workers[1]
    assert set(workers) == {0, 1}
    updates = [(a, w) for a, w in zip(got, workers) if a.get("op") == "update"]
    assert updates[0][0]["ok"] and updates[0][0]["prev_digest"] == got[1]["digest"]
    assert updates[0][1] == workers[1]  # the session lives where the graph was solved
    assert {w["caps"]["kernel"] for w in stats["workers"].values()} == {"torch"}
    assert stats["fleet"].get("fleet.worker.dead", 0) == 0  # no frame error, no restart
    assert all(w["restarts"] == 0 for w in stats["workers"].values())


@pytest.mark.usefixtures("isolated")
def test_cpu_fleet_answers_a_killed_workers_digests_through_the_disk_store(tmp_path):
    store = tmp_path / "store"
    cfg = trouter.FleetConfig(workers=2, device=CPU, disk_dir=str(store), no_compile_cache=True,
                              heartbeat_interval_s=0.25, restart_backoff_base_s=5.0,
                              restart_backoff_cap_s=5.0, ready_timeout_s=180.0,
                              request_timeout_s=120.0)
    graphs = [jgen.gnm_random_graph(40, 90, seed=s) for s in range(6)]
    reqs = [{"op": "solve", "num_nodes": 40,
             "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]}
            for g in graphs]
    with trouter.FleetRouter(cfg) as r:
        solved = [r.handle(q) for q in reqs]
        assert all(s["ok"] and s["source"] == "solved" for s in solved)
        assert {s["worker"] for s in solved} == {0, 1}
        victim = solved[0]["worker"]
        r.kill_worker(victim)
        assert _wait(lambda: not r._workers[victim].alive, 10)
        for q, s in zip(reqs, solved):
            after = r.handle(q)
            assert after["ok"] and after["worker"] != victim
            assert after["total_weight"] == s["total_weight"]
            if s["worker"] == victim:  # read back from the shared store: no fresh solve
                assert after["cached"], after
    assert all(name.endswith("_torch_device.npz") for name in os.listdir(store)
               if name.endswith(".npz"))


# ----------------------------------------------------------------------
# Interop: a router of one package, a worker of the other
# ----------------------------------------------------------------------
@pytest.mark.usefixtures("isolated")
@pytest.mark.parametrize("binary", [False, True])
def test_jax_router_dials_a_port_listen_worker(tmp_path, decks, binary):
    """The interop gate: a JAX router over a port ``--listen`` worker on the
    CPU answers as the JAX service does, B-frames passed through; the
    worker's store keys carry the port's backend token."""
    store = tmp_path / "store"
    requests = _deck(decks, binary, port_sections=False)
    want = _jax_answers(requests)
    (proc,), (addr,) = _listening(PORT_WORKER, 1, "--device", "cpu", "--disk-cache",
                                  str(store), "--no-compile-cache")
    try:
        cfg = jrouter.FleetConfig(remote_workers=(addr,), transport="tcp",
                                  heartbeat_interval_s=0.25, ready_timeout_s=60.0,
                                  request_timeout_s=120.0)
        with jrouter.FleetRouter(cfg) as r:
            assert r._workers[0].caps["kernel"] == "torch"
            for i, req in enumerate(requests):
                got = jframing.fold_sections(r.handle(req))
                assert got.pop("worker") == 0
                assert _strip(got) == _strip(want[i]), (i, req.get("op"))
        assert proc.wait(timeout=30) == 0
    finally:
        _reap(proc)
    keys = [n for n in os.listdir(store) if n.endswith(".npz")]
    assert keys and all("_torch_device" in n for n in keys)


def test_port_router_dials_a_jax_listen_worker():
    (proc,), (addr,) = _listening(JAX_WORKER, 1, "--test-echo")
    try:
        with trouter.FleetRouter(_listen_config((addr,))) as r:
            got = {d: r.handle({"op": "solve", "digest": d}) for d in ("a", "b")}
            assert all(v["ok"] and v["source"] == "echo" for v in got.values())
            upd = r.handle({"op": "update", "digest": "a", "updates": [{"k": 1}]})
            assert upd["ok"] and upd["prev_digest"] == "a"
        assert proc.wait(timeout=30) == 0
    finally:
        _reap(proc)
