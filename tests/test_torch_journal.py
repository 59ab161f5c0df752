"""The port's ``fleet/journal.py`` against the JAX package's, on the CPU.

A journal holds requests, not results: a replayed accept is solved again by
whichever worker takes it. So the bar is records equal to the JAX
package's: the same sequence of ``accept`` / ``answer`` / ``pin`` / ``ring``
/ ``scale`` / ``checkpoint`` calls must write the same ``journal.jsonl``,
line for line, and ``load()`` must rebuild the same ``JournalState`` in
either package from either package's file. The torn-tail, corrupt-line and
sequence-gap cases of the JAX package's ``tests/test_journal.py`` run
against both packages and must come out the same. Last, a port router
crashes with an accepted request in flight and its successor re-adopts the
``--listen`` echo workers and replays the orphan.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from distributed_ghs_implementation_tpu.fleet import journal as jjournal
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu_torch.fleet import journal as tjournal
from distributed_ghs_implementation_tpu_torch.fleet.autoscaler import Autoscaler, ElasticPolicy
from distributed_ghs_implementation_tpu_torch.fleet.router import FleetConfig, FleetRouter
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ((jjournal, JBUS), (tjournal, TBUS))


@pytest.fixture(autouse=True)
def _clean_buses():
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()
    yield
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()


def _script(j):
    """Every record kind, a chain rename, a death and a retire, a scale
    decision, enough appends to cross the checkpoint cadence, then more."""
    a = j.accept({"op": "solve", "digest": "a"}, key="a", cls="hit")
    b = j.accept({"op": "update", "digest": "b"}, key="b", cls=None, lane=True,
                 trace={"trace": "t" * 32, "span": "s" * 16})
    j.ring("add", 0)
    j.ring("add", 1, addr="127.0.0.1:9", lane=True)
    j.answer(a, ok=True, worker=1, digest="a")
    j.pin("b2", 0, prev="b")
    j.scale({"action": "up", "pool": 2, "reason": "breach", "at": 123.5})
    for i in range(7):
        jid = j.accept({"op": "solve", "digest": f"d{i}", "edges": [[0, 1, i]]},
                       key=f"d{i}", cls="bulk" if i % 2 else None)
        j.answer(jid, ok=i != 3, worker=i % 2, digest=f"d{i}" if i != 3 else None)
    j.ring("remove", 0)
    j.pin("p", 1)
    j.ring("retire", 1)
    j.answer(b, ok=False)
    j.accept({"op": "solve", "graph_path": "g.npz"}, key="g.npz", cls="bulk")
    j.checkpoint()
    j.accept({"op": "solve", "digest": "z"}, key="z", cls=None)


def _state(state):
    return {k: getattr(state, k) for k in ("had_state", "next_jid", "next_seq", "unanswered",
                                           "pins", "served", "members", "last_scale",
                                           "dropped")}


def _lines(path):
    with open(path, "rb") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("every", [4, 512])
def test_records_equal_jax(tmp_path, every):
    paths = []
    for mod, _ in PAIRS:
        j = mod.RouterJournal(str(tmp_path / mod.__name__), checkpoint_every=every)
        _script(j)
        paths.append(j.path)
    jl, tl = _lines(paths[0]), _lines(paths[1])
    assert tl == jl  # byte for byte, crc included: the record stamps no wall clock
    assert json.loads(tl[0])["schema"] == tjournal.JOURNAL_SCHEMA == jjournal.JOURNAL_SCHEMA
    if every == 4:
        assert JBUS.counters()["fleet.router.journal.compact"] == TBUS.counters()[
            "fleet.router.journal.compact"] > 1


def test_load_rebuilds_the_same_state_from_either_file(tmp_path):
    dirs = {}
    for mod, _ in PAIRS:
        j = mod.RouterJournal(str(tmp_path / mod.__name__), checkpoint_every=6)
        _script(j)
        dirs[mod] = j.root
    states = {}
    for reader, _ in PAIRS:
        for writer in dirs:
            states[(reader, writer)] = _state(reader.RouterJournal(dirs[writer]).load())
    first = next(iter(states.values()))
    assert all(s == first for s in states.values())
    assert first["had_state"] and len(first["unanswered"]) == 2
    assert first["members"][1]["retired"] and first["last_scale"]["at"] == 123.5


def test_router_scale_decisions_journal_as_jax_does(tmp_path, monkeypatch):
    """The router stamps a decision with the wall clock; with the clock
    fixed, both routers' journals hold the same scale record, and a
    restarted port router's autoscaler starts inside the cooldown."""
    from distributed_ghs_implementation_tpu.fleet import router as jrouter
    from distributed_ghs_implementation_tpu_torch.fleet import router as trouter

    lines = []
    for mod in (jrouter, trouter):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
        jdir = str(tmp_path / mod.__name__)
        r = mod.FleetRouter(mod.FleetConfig(workers=1, test_echo=True, journal_dir=jdir))
        r.note_scale_decision({"action": "up", "pool": 2, "reason": "x"})
        lines.append(_lines(os.path.join(jdir, "journal.jsonl")))
    monkeypatch.undo()
    assert lines[1] == lines[0]
    # A decision stamped now: the successor's cooldown spans the restart.
    jdir = str(tmp_path / "cooldown")
    FleetRouter(FleetConfig(workers=1, test_echo=True, journal_dir=jdir)).note_scale_decision(
        {"action": "up", "pool": 2, "reason": "x"})
    r2 = FleetRouter(FleetConfig(workers=1, test_echo=True, journal_dir=jdir))
    assert r2.last_scale_decision["action"] == "up"
    assert Autoscaler(r2, ElasticPolicy(cooldown_s=3600.0))._last_scale_done > float("-inf")


def _with_orphans(mod, root, n=6):
    """n accepts, even ones answered: the odd ones are the re-queue set."""
    j = mod.RouterJournal(str(root))
    for i in range(n):
        jid = j.accept({"op": "solve", "digest": f"g{i}"}, key=f"g{i}", cls=None)
        if i % 2 == 0:
            j.answer(jid, ok=True, worker=i % 3, digest=f"g{i}")
    return j


def _tear(path, cut):
    lines = _lines(path)
    with open(path, "wb") as f:
        f.write(b"\n".join(lines[:-1]) + b"\n" + lines[-1][:min(cut, len(lines[-1]) - 1)])


def _corrupt(path, cut):
    lines = _lines(path)
    lines[3] = lines[3][:len(lines[3]) // 2] + b"#corrupt#"
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")


def _rot(path, cut):
    lines = _lines(path)
    lines[3] = lines[3][:4] + b"\xff\xfe\x80" + lines[3][7:]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


def _gap(path, cut):
    lines = _lines(path)
    del lines[2]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")


@pytest.mark.parametrize("damage,cut", [("tear", 1), ("tear", 7), ("tear", 23), ("corrupt", 0),
                                        ("rot", 0), ("gap", 0)])
def test_damaged_journal_recovers_as_jax(tmp_path, damage, cut):
    """A torn tail costs the torn record only; a corrupt line, a non-UTF-8
    one and a vanished record each end the chain there. The port counts
    and recovers exactly what the JAX package does, and stays appendable."""
    fn = {"tear": _tear, "corrupt": _corrupt, "rot": _rot, "gap": _gap}[damage]
    got = []
    for mod, bus in PAIRS:
        root = tmp_path / mod.__name__
        j = _with_orphans(mod, root)
        fn(j.path, cut)
        j2 = mod.RouterJournal(str(root))
        state = j2.load()
        jid = j2.accept({"op": "solve", "digest": "post"}, key="post", cls=None)
        after = mod.RouterJournal(str(root)).load()
        counters = {k: v for k, v in bus.counters().items()
                    if k.startswith("fleet.router.journal.")}
        got.append((_state(state), jid, _state(after), counters, _lines(j.path)))
    assert got[1] == got[0]
    state = got[1][0]
    assert state["had_state"]
    if damage == "tear":
        assert state["dropped"] == 0
    else:
        assert state["dropped"] > 0 and state["served"] == {"g0": 0}
        assert got[1][3]["fleet.router.journal.chain_broken"] >= 1


def test_close_refuses_appends_as_jax(tmp_path):
    for mod, _ in PAIRS:
        j = mod.RouterJournal(str(tmp_path / mod.__name__))
        j.accept({"op": "solve"}, key="a", cls=None)
        j.close()
        with pytest.raises(OSError, match="closed"):
            j.accept({"op": "solve"}, key="b", cls=None)
        assert len(mod.RouterJournal(j.root).load().unanswered) == 1


# ----------------------------------------------------------------------
# A router crash and restart over --listen echo workers
# ----------------------------------------------------------------------
def _listening_echo(count):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_ghs_implementation_tpu_torch.fleet.worker",
         "--worker-id", str(i), "--test-echo", "--listen", "127.0.0.1:0"],
        stderr=subprocess.PIPE, env=env) for i in range(count)]
    addrs = []
    for proc in procs:
        line = proc.stderr.readline().decode()
        assert "listening on" in line, line
        addrs.append(line.rsplit(" ", 1)[-1].strip())
    return procs, addrs


def test_router_crash_restart_readopts_workers_and_replays_orphans(tmp_path):
    procs, addrs = _listening_echo(2)
    cfg = FleetConfig(remote_workers=tuple(addrs), transport="tcp", test_echo=True,
                      heartbeat_interval_s=0.1, restart_backoff_base_s=0.02,
                      restart_backoff_cap_s=0.2, ready_timeout_s=30.0, request_timeout_s=30.0,
                      journal_dir=str(tmp_path / "journal"))
    try:
        r1 = FleetRouter(cfg).start()
        for i in range(4):
            assert r1.handle({"op": "solve", "digest": f"j{i}"})["ok"]
        upd = r1.handle({"op": "update", "digest": "j0", "updates": [{"k": 1}]})
        pin_digest, pin_worker = upd["digest"], upd["worker"]
        pre = r1.handle({"op": "stats"})["counters"]["echo.handled"]
        results = []
        t = threading.Thread(target=lambda: results.append(r1.handle(
            {"op": "solve", "digest": "orphan", "sleep_s": 0.8})))
        t.start()
        deadline = time.monotonic() + 10
        while r1._journal.status()[0] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)  # wait for the accept to be journaled
        while not any(w.pending for w in r1._workers) and time.monotonic() < deadline:
            time.sleep(0.01)  # ... and dispatched
        r1.crash()
        t.join(timeout=10)
        assert results and results[0].get("router_crashed")
        r2 = FleetRouter(cfg).start()
        try:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                stats = r2.handle({"op": "stats"})
                if stats["journal"]["unanswered"] == 0:
                    break
                time.sleep(0.05)
            assert stats["journal"]["unanswered"] == 0
            assert stats["counters"]["echo.handled"] > pre  # the same processes: warm
            counters = TBUS.counters()
            assert counters.get("fleet.router.crash") == 1
            assert counters.get("fleet.router.restart.readopted") == 2
            assert counters.get("fleet.router.restart.replayed", 0) >= 1
            upd2 = r2.handle({"op": "update", "digest": pin_digest, "updates": [{"k": 2}]})
            assert upd2["ok"] and upd2["worker"] == pin_worker
        finally:
            r2.shutdown()
        for p in procs:
            assert p.wait(timeout=20) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
