"""The port's ``serve/service`` against the JAX package's, on the CPU.

One request deck goes through the JAX ``MSTService`` and through the port's
(``device="cpu"``), over JSONL (``serve_loop``) and over length-prefixed
frames and B-frames (``serve_frames``), with ``batch_lanes`` 0 and 4 and with
``verify`` off, sample and full. Every response must be equal as JSON text
once these are taken out, and nothing else:

* ``wall_time_s``, and the publish response's ``wall_s``: wall times;
* ``histograms_raw`` in ``stats``: timing reservoirs;
* the counters ``compile.kernel.*``: the JAX package counts its kernel
  (``xla`` on the CPU), the port its own (``torch``);
* the store key's backend token, which no response carries.

The deck is built once by asking the JAX service (stream ids and heads
follow from its answers), then replayed through both loops. The JAX
package's XLA compile-cache telemetry (``utils/compile_cache.py``: a
process-wide JAX listener that counts ``compile.persistent.*`` on that
package's bus once any test has installed it) is pointed at a bus of its
own for the comparison: it reports on XLA, which the port does not have,
and whether it is installed depends on the tests that ran before. The
port's build-cache telemetry (``utils/compile_cache.py``: ``compile.*`` at
a process's first load of the native library) is pointed away for the same
reason: which test loads the library first depends on the order. Where the port
differs on purpose it is pinned here too: ``MSTService()`` needs CUDA unless
given a device. A second deck runs through a service with a sharded lane
(``parallel/lane.py``) in each package.
"""

import io
import json

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.batch import lanes as jlanes
from distributed_ghs_implementation_tpu.fleet import framing as jframing
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import io as jio
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.serve import service as jsvc
from distributed_ghs_implementation_tpu.stream.window import random_update_stream
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.fleet import framing as tframing
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.serve import service as tsvc
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "no_xla_telemetry")


@pytest.fixture
def no_xla_telemetry(monkeypatch):
    from distributed_ghs_implementation_tpu.obs.events import EventBus
    from distributed_ghs_implementation_tpu.utils import compile_cache
    from distributed_ghs_implementation_tpu_torch.obs.events import EventBus as TEventBus
    from distributed_ghs_implementation_tpu_torch.utils import compile_cache as tcompile_cache

    monkeypatch.setattr(compile_cache, "BUS", EventBus(capacity=16))
    monkeypatch.setattr(tcompile_cache, "BUS", TEventBus(capacity=16))


def _edges(g):
    return [[int(a), int(b), int(w)] for a, b, w in zip(g.u, g.v, g.w)]


def _forest(gen):
    """Two components and an isolated vertex: 3 components."""
    a = gen.gnm_random_graph(20, 50, seed=7)
    b = gen.gnm_random_graph(10, 20, seed=8)
    return jedge.Graph.from_arrays(31, np.concatenate([a.u, b.u + 20]),
                                   np.concatenate([a.v, b.v + 20]),
                                   np.concatenate([a.w, b.w]))


def _updates(rng, g, size):
    return [{k: v for k, v in u.__dict__.items() if v is not None}
            for u in random_update_stream(rng, g, size)]


def _deck_steps(npz_path, binary):
    """The request deck as a generator over the answers so far (stream ids
    and heads come from them)."""
    readme = jgen.readme_sample_graph()
    g1 = jgen.gnm_random_graph(40, 120, seed=3)
    g2 = jgen.gnm_random_graph(64, 200, seed=4)
    g3 = _forest(jgen)
    jio.write_npz(g2, npz_path)
    rng = np.random.default_rng(5)

    def graph(g, **extra):
        if binary:
            return {"op": "solve", **g.to_wire(), **extra}
        return {"op": "solve", "num_nodes": g.num_nodes, "edges": _edges(g), **extra}

    answers = yield
    yield {"op": "solve", "num_nodes": 6, "edges": _edges(readme), "edges_out": True,
           "slo_class": "interactive"}
    yield graph(g1, edges_out=True)
    yield graph(g1)
    yield {"op": "solve", "graph_path": npz_path, "edges_out": True, "slo_class": "bulk"}
    yield {"op": "solve", "cached_only": True, "digest": g1.digest()}
    yield {"op": "solve", "cached_only": True, "digest": "f" * 64}
    yield {"op": "solve", "cached_only": True, "digest": g1.digest(), "kind": "k_msf", "k": 2}
    yield {"op": "solve", "cached_only": True, "digest": g1.digest(), "kind": "components"}
    yield graph(g1, kind="components", labels_out=True)
    yield graph(g3, kind="components", labels_out=True, edges_out=True)
    yield graph(g1, kind="k_msf", k=3, edges_out=True)
    yield graph(g3, kind="k_msf", k=1)
    yield graph(g1, kind="bottleneck")
    yield graph(g3, kind="path_max", u=0, v=25)
    yield graph(g3, kind="path_max", u=2, v=17)
    yield graph(g3, kind="path_max", u=4, v=4)
    yield {"op": "solve", "cached_only": True, "digest": g3.digest(), "kind": "bottleneck"}
    yield {"op": "solve", "cached_only": True, "digest": g1.digest(), "kind": "path_max",
           "u": 1, "v": 9}
    yield graph(g1, kind="k_msf")
    yield graph(g1, kind="nope")
    yield {"op": "solve", "num_nodes": 3}
    yield {"op": "update", "digest": g1.digest(), "updates": [
        {"kind": "insert", "u": 1, "v": 2, "w": 1}, {"kind": "delete", "u": int(g1.u[0]),
                                                      "v": int(g1.v[0])},
        {"kind": "reweight", "u": int(g1.u[5]), "v": int(g1.v[5]), "w": 99}]}
    new_digest = answers[-1]["digest"]
    yield {"op": "update", "digest": new_digest, "updates": [{"kind": "insert", "u": 0, "v": 0,
                                                              "w": 1}]}
    yield {"op": "update", "digest": "0" * 64, "updates": []}
    yield {"op": "subscribe", "digest": g2.digest()}
    sid, head = answers[-1]["stream"], answers[-1]["digest"]
    yield {"op": "publish", "stream": sid, "digest": head, "updates": _updates(rng, g2, 40)}
    head1 = answers[-1]["digest"]
    yield {"op": "publish", "stream": sid, "digest": head, "updates": _updates(rng, g2, 3)}
    yield {"op": "publish", "stream": sid, "digest": head1, "updates": [
        {"kind": "insert", "u": 1, "v": 2, "w": 5}, {"kind": "delete", "u": 1, "v": 2}]}
    yield {"op": "publish", "stream": sid, "digest": head1, "updates": _updates(rng, g2, 9),
           "edges_out": True}
    yield {"op": "poll", "stream": sid, "after_seq": 0}
    yield {"op": "poll", "stream": sid, "after_seq": 2}
    yield {"op": "subscribe", "stream": sid}
    yield {"op": "subscribe", "digest": "e" * 64}
    yield {"op": "publish", "digest": head1, "updates": []}
    yield {"op": "frobnicate"}
    yield {"op": "stats"}
    yield {"op": "shutdown"}


def _build_deck(tmp_path, binary, **service_kw):
    """The deck's requests, in order, asking a JAX service for the answers
    the later requests depend on."""
    svc = jsvc.MSTService(stream_dir=str(tmp_path / "build_streams"), **service_kw)
    answers = []
    steps = _deck_steps(str(tmp_path / "g2.npz"), binary)
    next(steps)
    req = steps.send(answers)
    requests = []
    while True:
        requests.append(req)
        answers.append(svc.handle(req))
        try:
            req = next(steps)
        except StopIteration:
            if svc.verifier is not None:  # its audits count on the bus
                assert svc.verifier.auditor.flush(timeout_s=30)
            return requests


class _Flushing:
    """A service whose ``stats`` waits for the audit thread first, so the
    ``verify.audit.*`` counters it reads do not race the audits."""

    def __init__(self, service):
        self.service = service

    def handle(self, request):
        if request.get("op") == "stats" and self.service.verifier is not None:
            assert self.service.verifier.auditor.flush(timeout_s=30)
        return self.service.handle(request)


def _strip(resp):
    resp = dict(resp)
    for key in ("wall_time_s", "wall_s", "histograms_raw"):
        resp.pop(key, None)
    if "counters" in resp:
        resp["counters"] = {k: v for k, v in resp["counters"].items()
                            if not k.startswith("compile.kernel.")}
    return json.dumps(resp, sort_keys=True)


def _fresh_caches():
    for bus in (JBUS, TBUS):
        bus.clear()
    for lanes in (jlanes, tlanes):
        lanes.clear_solver_cache()


def _run_jsonl(mod, requests, root, **kw):
    lines = [json.dumps(r) for r in requests]
    lines.insert(3, "{not json")
    out = io.StringIO()
    svc = mod.MSTService(stream_dir=root, **kw)
    assert mod.serve_loop(io.StringIO("\n".join(lines) + "\n"), out, _Flushing(svc)) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _frame_bytes(framing, requests):
    out = b""
    for req in requests:
        if framing.SECTIONS_KEY in req:
            out += framing.encode_bframe(req)
        else:
            out += framing.encode_frame(req, crc=True)
    return out


def _run_frames(mod, framing, requests, root, **kw):
    svc = mod.MSTService(stream_dir=root, **kw)
    out = io.BytesIO()
    # Both read the same bytes, framed by the JAX package: one format.
    assert mod.serve_frames(io.BytesIO(_frame_bytes(jframing, requests)), out,
                            _Flushing(svc)) == 0
    out.seek(0)
    answers = []
    while True:
        meta = {}
        resp = framing.read_frame(out, meta=meta)
        if resp is None:
            return answers
        answers.append((bool(meta.get("wire")), framing.fold_sections(resp)))


@pytest.mark.parametrize("verify", [None, "sample", "full"])
@pytest.mark.parametrize("lanes", [0, 4])
@pytest.mark.parametrize("transport", ["jsonl", "frames"])
def test_deck_answers_equal_jax(tmp_path, transport, lanes, verify):
    kw = dict(batch_lanes=lanes, verify=verify)
    requests = _build_deck(tmp_path, transport == "frames", **kw)
    got = {}
    for name, mod, framing, extra in (("jax", jsvc, jframing, {}),
                                      ("port", tsvc, tframing, {"device": CPU})):
        _fresh_caches()
        root = str(tmp_path / f"{name}_streams")
        if transport == "jsonl":
            got[name] = _run_jsonl(mod, requests, root, **kw, **extra)
        else:
            got[name] = _run_frames(mod, framing, requests, root, **kw, **extra)
    assert len(got["port"]) == len(got["jax"]) == len(requests) + (transport == "jsonl")
    for i, (j, t) in enumerate(zip(got["jax"], got["port"])):
        if transport == "frames":
            assert t[0] == j[0], i  # binary egress where JAX answers in B-frames
            j, t = j[1], t[1]
        assert _strip(t) == _strip(j), (i, requests[min(i, len(requests) - 1)].get("op"))
    answers = [a[1] if transport == "frames" else a for a in got["port"]]
    ops = [a.get("op") for a in answers]
    assert ops[-1] == "shutdown" and answers[-1]["ok"]
    if verify == "full":
        assert any(a.get("verified") == "full" for a in answers)
    stats = next(a for a in answers if a.get("op") == "stats")
    assert {k for k in stats["counters"] if k.startswith("compile.kernel.")} <= {
        "compile.kernel.torch"}
    assert stats["counters"]["serve.requests"] == len(requests) - 1  # up to stats itself


def test_bframe_requests_are_byte_identical_and_read_across_packages():
    """``Graph.to_wire`` in both packages makes the same B-frame, and
    ``from_wire`` of the port takes a non-canonical sender through
    ``from_arrays``, so the digest names the canonical graph."""
    jg = jgen.gnm_random_graph(30, 90, seed=16)
    tg = tedge.Graph(jg.num_nodes, jg.u, jg.v, jg.w)
    jb = jframing.encode_bframe({"op": "solve", **jg.to_wire()})
    assert tframing.encode_bframe({"op": "solve", **tg.to_wire()}) == jb
    req = tframing.read_frame(io.BytesIO(jb))
    back = tedge.Graph.from_wire(req)
    assert back.digest() == jg.digest()
    order = np.arange(jg.num_edges)[::-1]
    for framing, edge in ((tframing, tedge), (jframing, jedge)):
        messy = {"op": "solve", "num_nodes": jg.num_nodes, framing.SECTIONS_KEY:
                 framing.WireSections().add("u", jg.v[order]).add("v", jg.u[order])
                 .add("w", jg.w[order])}
        req = framing.read_frame(io.BytesIO(framing.encode_bframe(messy)))
        assert edge.Graph.from_wire(req).digest() == jg.digest()


def test_garbled_frame_stream_exits_nonzero_as_jax():
    outs = []
    for mod in (jsvc, tsvc):
        out = io.BytesIO()
        kw = {"device": CPU} if mod is tsvc else {}
        assert mod.serve_frames(io.BytesIO(b"not a frame\n"), out, mod.MSTService(**kw)) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and b"bad frame" in outs[1]


def test_service_needs_cuda_or_a_device_and_refuses_a_sharded_lane(monkeypatch):
    """``MSTService()`` needs CUDA unless given a device; ``sharded_lane=``
    no longer raises: it builds a lane over the service's device (one CPU
    shard for ``True``, as many as an int names) and hands it to the
    scheduler and the streams."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsvc.MSTService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsvc.MSTService(sharded_lane=True)
    for spec, shards in ((True, 1), (4, 4)):
        svc = tsvc.MSTService(sharded_lane=spec, device=CPU)
        lane = svc.sharded_lane
        assert lane.mesh.size == shards and {d.type for d in lane.mesh.devices} == {"cpu"}
        assert svc.scheduler.sharded_lane is lane and svc.streams._lane is lane
    svc = tsvc.MSTService(device=CPU)
    assert svc.device.type == "cpu" and svc.streams.device.type == "cpu"
    assert svc.scheduler.device.type == "cpu" and svc.sharded_lane is None


def _lane_deck_steps(binary):
    """A deck for a service with a sharded lane: an oversize graph solved
    on the lane (then from the cache), updated (the residency moves along),
    streamed (a sharded stream: windows written into the resident shards),
    and a small graph beside it."""
    big = jgen.gnm_random_graph(70_000, 3_000, seed=21)
    small = jgen.gnm_random_graph(40, 120, seed=3)
    rng = np.random.default_rng(9)

    def graph(g, **extra):
        if binary:
            return {"op": "solve", **g.to_wire(), **extra}
        return {"op": "solve", "num_nodes": g.num_nodes, "edges": _edges(g), **extra}

    answers = yield
    yield graph(big, slo_class="oversize")
    yield graph(big)
    yield graph(small, edges_out=True)
    # A heavy insert lands past every rank: the write touches one slot.
    yield {"op": "update", "digest": big.digest(), "updates": [
        {"kind": "insert", "u": 0, "v": 1, "w": 10_000}]}
    yield {"op": "subscribe", "digest": big.digest()}
    sid, head = answers[-1]["stream"], answers[-1]["digest"]
    yield {"op": "publish", "stream": sid, "digest": head, "updates": _updates(rng, big, 30)}
    head = answers[-1]["digest"]
    yield {"op": "publish", "stream": sid, "digest": head, "updates": _updates(rng, big, 5),
           "edges_out": True}
    yield {"op": "poll", "stream": sid, "after_seq": 0}
    yield {"op": "stats"}


@pytest.mark.parametrize("transport", ["jsonl", "frames"])
def test_sharded_lane_deck_answers_equal_jax(tmp_path, transport):
    """One deck through a service with a sharded lane in each package (JAX's
    ``sharded_lane=True`` over its 8 CPU devices, the port's
    ``sharded_lane=8`` over 8 CPU shards): every answer equal as JSON text
    after the same stripped fields as the deck above."""
    svc = jsvc.MSTService(stream_dir=str(tmp_path / "build"), sharded_lane=True)
    answers, requests = [], []
    steps = _lane_deck_steps(transport == "frames")
    next(steps)
    req = steps.send(answers)
    while True:
        requests.append(req)
        answers.append(svc.handle(req))
        try:
            req = next(steps)
        except StopIteration:
            break
    assert answers[0]["backend"] == "sharded_lane"
    from distributed_ghs_implementation_tpu.parallel import lane as jlane
    from distributed_ghs_implementation_tpu_torch.parallel import lane as tlane

    got = {}
    for name, mod, framing, extra in (("jax", jsvc, jframing, {"sharded_lane": True}),
                                      ("port", tsvc, tframing,
                                       {"sharded_lane": 8, "device": CPU})):
        _fresh_caches()
        for lane in (jlane, tlane):  # each run is a fresh process's first dispatch
            lane._reset_shape_ledger()
        root = str(tmp_path / f"{name}_streams")
        if transport == "jsonl":
            got[name] = _run_jsonl(mod, requests, root, **extra)
        else:
            got[name] = [a[1] for a in _run_frames(mod, framing, requests, root, **extra)]
    assert len(got["port"]) == len(got["jax"])
    for i, (j, t) in enumerate(zip(got["jax"], got["port"])):
        assert _strip(t) == _strip(j), (i, requests[min(i, len(requests) - 1)].get("op"))
    port = [a for a in got["port"] if a.get("op") != "error"]
    assert port[0]["backend"] == "sharded_lane" and port[1]["source"] == "cache"
    stats = port[-1]
    assert stats["counters"]["serve.route.sharded_lane"] >= 1
    # The update and the windows moved the residency along the chain (the
    # canonical edge order of an updated graph shifts most rank slots, so
    # the lane restages them rather than writing a few slots).
    assert stats["counters"]["stream.lane.migrated"] == 2
    assert stats["counters"]["lane.restage"] >= 1


def test_serve_loop_drains_on_a_signal_after_the_response():
    """A SIGTERM that lands while a request is handled lets the response
    flush, then ends the loop, as in the JAX package; the handlers before
    the loop are back after it. The drain handler the loop installed is
    called directly, as the signal would call it."""
    import signal

    g = jgen.gnm_random_graph(20, 40, seed=1)
    svc = tsvc.MSTService(device=CPU)
    before = signal.getsignal(signal.SIGTERM)

    class Signalled:
        def handle(self, request):
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler) and handler is not before
            handler(signal.SIGTERM, None)
            return svc.handle(request)

    lines = [json.dumps({"op": "solve", "num_nodes": 20, "edges": _edges(g)})] * 2
    out = io.StringIO()
    assert tsvc.serve_loop(io.StringIO("\n".join(lines) + "\n"), out, Signalled()) == 0
    answers = out.getvalue().splitlines()
    assert len(answers) == 1 and json.loads(answers[0])["ok"]
    assert signal.getsignal(signal.SIGTERM) is before
