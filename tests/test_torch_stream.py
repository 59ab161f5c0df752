"""The port's ``stream/`` against the JAX package's, on the CPU.

The same graphs and update windows go through the JAX package's
``stream.window``, ``stream.log`` and ``stream.session`` and through the
port's with ``device="cpu"``: coalesced windows, forests, notifications,
digests, log entries and counters must be equal, and every window's head
must equal a fresh solve of the updated graph edge for edge. Where the port
differs on purpose it is pinned: its streams live under ``<root>/torch/``,
its snapshots carry a ``package`` field and it refuses another package's
stream, and a ``lane=`` raises until ``parallel/`` is ported.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.stream import log as jlog
from distributed_ghs_implementation_tpu.stream import session as jsession
from distributed_ghs_implementation_tpu.stream import window as jwindow
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.serve import dynamic as tdyn
from distributed_ghs_implementation_tpu_torch.stream import log as tlog
from distributed_ghs_implementation_tpu_torch.stream import session as tsession
from distributed_ghs_implementation_tpu_torch.stream import window as twindow
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "fresh")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh():
    for bus in (JBUS, TBUS):
        bus.clear()
    yield


def _graphs(n, m, seed):
    rng = np.random.default_rng(seed)
    u, v, w = rng.integers(0, n, m), rng.integers(0, n, m), rng.integers(1, 51, m)
    return jedge.Graph.from_arrays(n, u, v, w), tedge.Graph.from_arrays(n, u, v, w)


def _random_window(rng, dyn, n, size):
    """Updates as dicts, drawn against ``dyn``'s current edges: inserts,
    deletes and reweights, with same-edge churn."""
    out = []
    for _ in range(size):
        kind = str(rng.choice(["insert", "delete", "reweight"]))
        if kind != "insert" and dyn._u.size and rng.random() < 0.7:
            i = int(rng.integers(0, dyn._u.size))
            a, b = int(dyn._u[i]), int(dyn._v[i])
        else:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            while a == b:
                a, b = (int(x) for x in rng.integers(0, n, 2))
        upd = {"kind": kind, "u": a, "v": b}
        if kind != "delete":
            upd["w"] = int(rng.integers(1, 51))
        out.append(upd)
        if rng.random() < 0.3:
            out.append({"kind": "delete", "u": b, "v": a})
    return out


def _fresh(graph):
    return np.sort(tapi.minimum_spanning_forest(graph, device=CPU).edge_ids)


def _info(info):
    return (info.mode, info.applied, info.coalesced_from, info.entered, info.left,
            info.weight_delta)


def _counters(bus, prefix="stream."):
    return {k: v for k, v in bus.counters().items() if k.startswith(prefix)}


# ----------------------------------------------------------------------
# Coalescing and the update generator
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesce_equals_jax(seed):
    jg, tg = _graphs(50, 150, seed)
    rng = np.random.default_rng(seed)
    dyn = tdyn.DynamicMST(tapi.minimum_spanning_forest(tg, device=CPU), device=CPU)
    window = _random_window(rng, dyn, 50, 60)
    got = twindow.coalesce(window)
    want = jwindow.coalesce(window)
    assert [u.__dict__ for u in got] == [u.__dict__ for u in want]
    assert twindow.coalesce(list(reversed(twindow.coalesce(window)))) == got


def test_random_update_stream_equals_jax():
    jg, tg = _graphs(40, 120, 3)
    got = twindow.random_update_stream(np.random.default_rng(9), tg, 200)
    want = jwindow.random_update_stream(np.random.default_rng(9), jg, 200)
    assert [u.__dict__ for u in got] == [u.__dict__ for u in want]
    kinds = {u.kind for u in got}
    assert kinds == {"insert", "delete", "reweight"}


# ----------------------------------------------------------------------
# Windows: equal to JAX's and to fresh solves
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_windows_equal_jax_and_fresh_solves(seed):
    n = 80
    jg, tg = _graphs(n, 240, 100 + seed)
    jwin = jwindow.WindowedMST(japi.minimum_spanning_forest(jg))
    twin = twindow.WindowedMST(tapi.minimum_spanning_forest(tg, device=CPU), device=CPU)
    rng = np.random.default_rng(seed)
    for step in range(6):
        window = _random_window(rng, twin, n, int(rng.integers(1, 24)))
        jr, jinfo = jwin.apply_window(window)
        tr, tinfo = twin.apply_window(window)
        assert _info(tinfo) == _info(jinfo), (seed, step)
        assert tr.graph.digest() == jr.graph.digest()
        assert np.array_equal(tr.edge_ids, jr.edge_ids)
        assert tinfo.mode in ("batched", "noop")
        assert np.array_equal(np.sort(tr.edge_ids), _fresh(tr.graph)), (seed, step)
        assert tr.num_components == jr.num_components
    assert twin.last_mode == "window"


@pytest.mark.parametrize("mode", ["sequential", "resolve"])
def test_window_modes_equal_jax(mode):
    jg, tg = _graphs(70, 200, 7)
    jwin = jwindow.WindowedMST(japi.minimum_spanning_forest(jg), window_mode=mode)
    twin = twindow.WindowedMST(tapi.minimum_spanning_forest(tg, device=CPU),
                               window_mode=mode, device=CPU)
    rng = np.random.default_rng(8)
    for _ in range(3):
        window = _random_window(rng, twin, 70, 12)
        jr, jinfo = jwin.apply_window(window)
        tr, tinfo = twin.apply_window(window)
        assert _info(tinfo) == _info(jinfo)
        assert np.array_equal(tr.edge_ids, jr.edge_ids)
        assert np.array_equal(np.sort(tr.edge_ids), _fresh(tr.graph))
    assert _counters(TBUS) == _counters(JBUS)


def test_oversized_and_failed_windows_resolve_as_jax(monkeypatch):
    jg, tg = _graphs(60, 180, 11)
    rng = np.random.default_rng(2)
    jwin = jwindow.WindowedMST(japi.minimum_spanning_forest(jg), window_resolve_threshold=4)
    twin = twindow.WindowedMST(tapi.minimum_spanning_forest(tg, device=CPU),
                               window_resolve_threshold=4, device=CPU)
    window = _random_window(rng, twin, 60, 10)
    assert _info(twin.apply_window(window)[1]) == _info(jwin.apply_window(window)[1])
    assert twin.last_mode == jwin.last_mode == "resolve"
    for mod, win in ((twindow.WindowedMST, twin), (jwindow.WindowedMST, jwin)):
        monkeypatch.setattr(mod, "_forest_ok", lambda self: False, raising=False)
    window = _random_window(rng, twin, 60, 3)
    jr, jinfo = jwin.apply_window(window)
    tr, tinfo = twin.apply_window(window)
    assert tinfo.mode == jinfo.mode == "resolve"
    assert np.array_equal(tr.edge_ids, jr.edge_ids)
    assert _counters(TBUS) == _counters(JBUS)


def test_seeded_boruvka_on_a_seeded_partition_equals_jax():
    """The cut pass's form: fragments seeded from part of a forest, so the
    round's gathers are not the identity."""
    jg, tg = _graphs(200, 800, 5)
    res = tapi.minimum_spanning_forest(tg, device=CPU)
    keep = res.edge_ids[::2]
    frag0 = tedge.component_labels(200, tg.u[keep], tg.v[keep]).astype(np.int32)
    got = twindow._seeded_boruvka(200, frag0, tg.u, tg.v, tg.w, device=CPU)
    want = jwindow._seeded_boruvka(200, frag0, jg.u, jg.v, jg.w)
    assert np.array_equal(np.sort(got), np.sort(want))
    ids = np.sort(np.concatenate([keep, got]))
    assert np.array_equal(ids, np.sort(res.edge_ids))
    assert twindow._seeded_boruvka(5, np.arange(5), np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), np.zeros(0), device=CPU).size == 0


@pytest.mark.parametrize("size", [(100, 300), (5000, 200), (1, 1), (64, 64)])
def test_warm_window_kernels_counts_as_jax(size):
    assert twindow.warm_window_kernels(*size, device=CPU) == jwindow.warm_window_kernels(*size)


def test_state_arrays_round_trip_without_solving(monkeypatch):
    jg, tg = _graphs(50, 150, 4)
    win = twindow.WindowedMST(tapi.minimum_spanning_forest(tg, device=CPU), device=CPU)
    win.apply_window(_random_window(np.random.default_rng(1), win, 50, 8))

    def bomb(*a, **k):
        raise AssertionError("from_state must never solve")

    monkeypatch.setattr(tdyn, "minimum_spanning_forest", bomb)
    back = twindow.WindowedMST.from_state(win.state_arrays(), device=CPU)
    assert back.result().graph.digest() == win.result().graph.digest()
    assert np.array_equal(back.result().edge_ids, win.result().edge_ids)


# ----------------------------------------------------------------------
# The log: the same cases on both packages, the same outcome
# ----------------------------------------------------------------------
def _seed_log(log_mod, root, windows=3):
    log = log_mod.UpdateLog(root, "s")
    log.snapshot({"num_nodes": np.asarray(4), "u": np.arange(3), "v": np.arange(1, 4),
                  "w": np.ones(3, dtype=np.int64), "in_tree": np.ones(3, dtype=bool)},
                 seq=0, digest="d0")
    for i in range(1, windows + 1):
        log.append(seq=i, prev_digest=f"d{i-1}", digest=f"d{i}",
                   updates=[{"kind": "insert", "u": 0, "v": i, "w": i}])
    return log


def _torn_tail(log):
    with open(log.wal_path, "rb+") as f:
        f.seek(-9, os.SEEK_END)
        f.truncate()
    return [e["seq"] for e in log.load()[1]]


def _sealed(log):
    with open(log.wal_path, "a") as f:
        f.write('{"schema": "ghs-stream-wal-v1", "seq": 4, "pre')
    log.append(seq=4, prev_digest="d3", digest="d4", updates=[])
    return [e["seq"] for e in log._read_wal()[0]]


def _bak_fallback(log):
    log.snapshot({"num_nodes": np.asarray(4), "u": np.arange(3), "v": np.arange(1, 4),
                  "w": np.ones(3, dtype=np.int64), "in_tree": np.ones(3, dtype=bool)},
                 seq=1, digest="d1")
    with open(log.snap_path, "wb") as f:
        f.write(b"torn")
    state, _notes = log.load_snapshot()
    return state["seq"], state["digest"], [e["seq"] for e in log.load()[1]]


def _chain_break(log):
    with open(log.wal_path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    lines[1]["prev"] = "divergent"
    with open(log.wal_path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    first = [e["seq"] for e in log.load()[1]]
    head = log._durable_head()
    log.append(seq=2, prev_digest="d1", digest="d2-repaired", updates=[])
    return first, head, [(e["seq"], e["digest"]) for e in log.load()[1]]


def _fork(log):
    try:
        log.append(seq=2, prev_digest="d1", digest="fork", updates=[])
    except Exception as e:  # noqa: BLE001 -- the refusal is the outcome
        return type(e).__name__, e.seq, e.digest
    return None


def _compaction(log):
    log.snapshot({"num_nodes": np.asarray(4), "u": np.arange(3), "v": np.arange(1, 4),
                  "w": np.ones(3, dtype=np.int64), "in_tree": np.ones(3, dtype=bool)},
                 seq=2, digest="d2")
    state, chained, _ = log.load()
    return [e["seq"] for e in log._read_wal()[0]], state["seq"], [e["seq"] for e in chained]


@pytest.mark.parametrize("case", [_torn_tail, _sealed, _bak_fallback, _chain_break, _fork,
                                  _compaction])
def test_log_cases_equal_jax(tmp_path, case):
    got = {}
    for name, mod, bus in (("jax", jlog, JBUS), ("port", tlog, TBUS)):
        bus.clear()
        log = _seed_log(mod, str(tmp_path / name))
        got[name] = (case(log), _counters(bus, "stream.log."))
    assert got["port"] == got["jax"]
    assert got["port"][1]  # every case counts something


def test_log_two_process_lock(tmp_path):
    """Two processes append to one stream WAL at once: every line whole,
    one unforked chain across both writers, each losing append refused
    (``ChainBreak``) and retried on the durable tail."""
    root = str(tmp_path / "shared")
    child = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from distributed_ghs_implementation_tpu_torch.stream.log import ChainBreak, UpdateLog\n"
        "log = UpdateLog(sys.argv[1], 'hammer')\n"
        "who, done = sys.argv[2], 0\n"
        "while done < 12:\n"
        "    tail = log._durable_head()\n"
        "    seq = (tail[0] if tail else 0) + 1\n"
        "    prev = tail[1] if tail else 'seed'\n"
        "    try:\n"
        "        log.append(seq=seq, prev_digest=prev, digest=f'{who}-{seq}', updates=[])\n"
        "    except ChainBreak:\n"
        "        continue\n"
        "    done += 1\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", child, root, who],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for who in ("a", "b")]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    log = tlog.UpdateLog(root, "hammer")
    assert log.wal_path == os.path.join(root, "torch", "hammer", "wal.jsonl")
    with open(log.wal_path) as f:
        records = [json.loads(line) for line in f.read().split("\n") if line]
    assert [r["seq"] for r in records] == list(range(1, 25))
    prev = "seed"
    for rec in records:
        assert rec["prev"] == prev
        prev = rec["digest"]
    writers = [r["digest"].split("-")[0] for r in records]
    assert writers.count("a") == writers.count("b") == 12


# ----------------------------------------------------------------------
# Sessions: replay with zero solves, the package refusal
# ----------------------------------------------------------------------
def _drive(session_mod, api, gen, root, *, device_kw, windows=5, seed=9):
    g = gen.gnm_random_graph(60, 180, seed=seed)
    result = api.minimum_spanning_forest(g, **device_kw)
    mgr = session_mod.StreamManager(root=root, snapshot_every=2, **device_kw)
    session = mgr.subscribe(digest=g.digest(), result=result)
    head = session.head
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(windows):
        out = mgr.publish(session.id, head, _random_window(rng, session.mst, 60, 5))
        head = out["digest"]
        outs.append({k: v for k, v in out.items() if k not in ("result", "wall_s")})
    return mgr, session, head, outs


def test_publishes_equal_jax_and_replay_solves_nothing(tmp_path, monkeypatch):
    _, jsess, jhead, jouts = _drive(jsession, japi, jgen, str(tmp_path / "j"), device_kw={})
    mgr, session, head, touts = _drive(tsession, tapi, tgen, str(tmp_path / "t"),
                                       device_kw={"device": CPU})
    assert touts == jouts and head == jhead and session.id == jsess.id

    def bomb(*a, **k):
        raise AssertionError("replay must never solve")

    monkeypatch.setattr(tdyn, "minimum_spanning_forest", bomb)
    TBUS.clear()
    solved = []
    again = tsession.StreamManager(root=str(tmp_path / "t"), snapshot_every=2, device=CPU,
                                   solver=solved.append)
    recovered = again.subscribe(stream=session.id)
    assert recovered.head == head and recovered.seq == 5 and not solved
    poll = again.poll(session.id, after_seq=0)
    assert [n["seq"] for n in poll["notifications"]] == [1, 2, 3, 4, 5]
    assert [n for n in poll["notifications"]] == [o["notification"] for o in touts]
    assert tsession.poll_gap_check([1, 2, 3, 4, 5], poll["seq"]) == {"gaps": 0, "dups": 0}
    counters = _counters(TBUS)
    assert counters["stream.replay.streams"] == 1 and counters["stream.replay.windows"] == 1
    assert "stream.replay.fresh_solve" not in counters
    with pytest.raises(tsession.StaleDigest) as stale:
        again.publish(session.id, "0" * 64, [])
    assert stale.value.head == head and stale.value.seq == 5


def test_neither_package_recovers_the_others_stream(tmp_path):
    """One stream root, the same graph streamed by both packages: each
    replays only its own log. A JAX-written stream placed where the port
    keeps its streams is refused (not recovered, not written over)."""
    root = str(tmp_path)
    _, jsess, jhead, _ = _drive(jsession, japi, jgen, root, device_kw={})
    _, tsess, thead, _ = _drive(tsession, tapi, tgen, root, device_kw={"device": CPU}, seed=9)
    assert jsess.id == tsess.id
    assert os.path.isdir(os.path.join(root, tsess.id))
    assert os.path.isdir(os.path.join(root, "torch", tsess.id))
    assert jlog.list_streams(root) == [jsess.id] == tlog.list_streams(root)
    assert tsession.StreamManager(root=root, device=CPU).recover(tsess.id).head == thead
    assert jsession.StreamManager(root=root).recover(jsess.id).head == jhead

    # A JAX log in the port's place.
    foreign = str(tmp_path / "foreign")
    _drive(jsession, japi, jgen, os.path.join(foreign, "torch"), device_kw={})
    TBUS.clear()
    mgr = tsession.StreamManager(root=foreign, device=CPU)
    assert mgr.recover(jsess.id) is None
    state, notes = tlog.UpdateLog(foreign, jsess.id).load_snapshot()
    assert state is None and any("another package's snapshot" in why for _, why in notes)
    with pytest.raises(KeyError):
        mgr.subscribe(stream=jsess.id)
    g = tgen.gnm_random_graph(60, 180, seed=9)
    with pytest.raises(tsession.ForeignStream):
        mgr.subscribe(digest=g.digest(), result=tapi.minimum_spanning_forest(g, device=CPU))
    assert TBUS.counters()["stream.log.foreign_refused"] >= 1
    snap = os.path.join(foreign, "torch", jsess.id, "snapshot.npz")
    with np.load(snap) as data:
        assert "package" not in data.files  # still the JAX package's, untouched


def test_stream_manager_needs_cuda_or_a_device_and_refuses_a_lane(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsession.StreamManager()
    g = tgen.gnm_random_graph(10, 20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twindow.WindowedMST(tapi.minimum_spanning_forest(g, device=CPU))
    from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    # A lane no longer raises: an oversize stream becomes mesh-resident,
    # a small one does not.
    lane = ShardedLane(edge_mesh(num_shards=2, device=CPU))
    mgr = tsession.StreamManager(lane=lane, device=CPU, root=str(tmp_path))
    big = tgen.gnm_random_graph(70_000, 2_000, seed=2)
    assert mgr._lane_wants(big) and not mgr._lane_wants(g)
    session = mgr.subscribe(digest=big.digest(), result=lane.solve_result(big))
    assert session.sharded and lane.pin_count(big.digest()) == 1
    assert mgr.stats()["sharded"] == 1


def _sharded_stream_run(side, root, windows):
    """A sharded stream in package ``side``: the oversize seed solved on a
    lane of 8 shards, two windows, then a restart (a new lane and manager
    over the same root) that replays them. Returns what both packages must
    agree on."""
    from distributed_ghs_implementation_tpu.parallel import lane as jlane
    from distributed_ghs_implementation_tpu_torch.parallel import lane as tlane
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    if side == "jax":
        make_lane, gen, session_mod, bus, kw = jlane.ShardedLane, jgen, jsession, JBUS, {}
    else:
        def make_lane():
            return tlane.ShardedLane(edge_mesh(num_shards=8, device=CPU))

        gen, session_mod, bus, kw = tgen, tsession, TBUS, {"device": CPU}
    for mod in (jlane, tlane):
        mod._reset_shape_ledger()
    bus.clear()
    big = gen.gnm_random_graph(70_000, 3_000, seed=21)
    lane = make_lane()
    mgr = session_mod.StreamManager(root=root, lane=lane, solver=lane.solve_result, **kw)
    session = mgr.subscribe(digest=big.digest(), result=lane.solve_result(big))
    heads = [session.head]
    for updates in windows:
        out = mgr.publish(session.id, session.head, updates)
        heads.append(out["digest"])
    first = (heads, lane.resident_digests(), lane.pin_count(heads[-1]),
             [out["result"].edge_ids.tolist()], _counters(bus, ("stream.", "lane.")))
    bus.clear()
    lane2 = make_lane()
    mgr2 = session_mod.StreamManager(root=root, lane=lane2, solver=lane2.solve_result, **kw)
    back = mgr2.subscribe(stream=session.id)
    polled = mgr2.poll(back.id, after_seq=0)
    restart = (back.head, back.seq, back.sharded, lane2.resident_digests(),
               lane2.pin_count(back.head), back.mst.result().edge_ids.tolist(),
               polled["notifications"], _counters(bus, ("stream.", "lane.", "serve.")),
               sum(1 for e in bus.events() if e[1] == "lane.solve"))
    return first, restart


def test_sharded_stream_restarts_with_its_residency(tmp_path):
    """A sharded stream in each package (JAX's lane on its 8 CPU devices,
    the port's on 8 CPU shards): the same heads, residency, pins and
    counters; a restart re-stages the head before it replays, with no
    fresh solve, and holds it pinned."""
    big = jgen.gnm_random_graph(70_000, 3_000, seed=21)
    rng = np.random.default_rng(4)
    windows = [[u.__dict__ for u in jwindow.random_update_stream(rng, big, size)]
               for size in (20, 6)]
    windows = [[{k: v for k, v in u.items() if v is not None} for u in w] for w in windows]
    got = {side: _sharded_stream_run(side, str(tmp_path / side), windows)
           for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    first, restart = got["port"]
    assert restart[0] == first[0][-1] and restart[2] is True
    assert restart[3] == [restart[0]] and restart[4] == 1
    counters = restart[7]
    assert counters["stream.replay.residency_restored"] == 1
    assert counters.get("serve.scheduler.fresh_solve", 0) == 0 and restart[8] == 0
