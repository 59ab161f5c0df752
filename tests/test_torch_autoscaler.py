"""The port's ``fleet/autoscaler.py`` against the JAX package's, on the CPU.

The decisions are held equal on the same synthetic bus windows and the same
clock: each tick puts the same ``fleet.request`` spans (class, duration)
and ``fleet.requests`` counts on each package's bus, gives each autoscaler
a stand-in router with the same pool and queue depths, and calls ``step``
under one virtual clock (``time`` is replaced in both modules). Every
decision, and every one the router was told of, must be equal. Then the
elastic primitives the autoscaler drives run on a real fleet of the port's
echo workers, as the JAX package's ``tests/test_autoscaler.py`` runs them.
"""

import threading
import time
import types

import pytest

from distributed_ghs_implementation_tpu.fleet import autoscaler as jauto
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu_torch.fleet import autoscaler as tauto
from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
from distributed_ghs_implementation_tpu_torch.fleet.router import FleetConfig, FleetRouter
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS

PAIRS = ((jauto, JBUS), (tauto, TBUS))


@pytest.fixture(autouse=True)
def _clean_buses():
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()
    yield
    for bus in (JBUS, TBUS):
        bus.enable()
        bus.clear()


class _Clock:
    """``time`` for the autoscaler module: one virtual clock for both."""

    def __init__(self, wall=1_000_000.0):
        self.mono = 100.0
        self.wall = wall

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def sleep(self, s):
        self.mono += s


class _Router:
    """The router surface the autoscaler reads and drives."""

    def __init__(self, pool, last=None):
        self.config = types.SimpleNamespace(remote_workers=())
        self.pool = pool
        self.depths = {}
        self.told = []
        self.last_scale_decision = last
        self._next = pool

    def pool_size(self):
        return self.pool

    def queue_depths(self):
        return dict(self.depths)

    def add_worker(self, *, timeout_s=None):
        self.pool += 1
        self._next += 1
        return {"worker": self._next - 1, "warm_s": 0.1234567}

    def retire_worker(self):
        self.pool -= 1
        return {"worker": self.pool, "sessions_moved": 2}

    def note_scale_decision(self, decision):
        self.told.append(dict(decision))
        self.last_scale_decision = decision


# A tick: (spans [(cls or None, seconds)], new requests, queue depths,
# seconds the clock moves before the step, clear the bus first).
def _tick(spans=(), requests=None, depths=None, advance=0.25, clear=False):
    return {"spans": spans, "requests": len(spans) if requests is None else requests,
            "depths": depths or {}, "advance": advance, "clear": clear}


SCENARIOS = {
    # Breach -> up; a breach at max_workers is one noted hold; idle ticks
    # -> down; at min_workers idle holds.
    "ramp": dict(
        policy=dict(min_workers=1, max_workers=2, cooldown_s=0.0, wait_budget_s=0.05,
                    idle_ticks=2),
        pool=1,
        ticks=[_tick([("hit", 0.2), ("hit", 0.01)]), _tick([("hit", 0.3)]),
               _tick([("hit", 0.3)]), _tick(), _tick(), _tick(), _tick(), _tick()]),
    # Depth leads latency: a worker at the watermark breaches with no span.
    "depth": dict(
        policy=dict(min_workers=1, max_workers=3, cooldown_s=0.0, queue_high=2,
                    wait_budget_s=1e9),
        pool=1,
        ticks=[_tick(depths={0: 1}), _tick(depths={0: 2}), _tick(depths={0: 1, 1: 4}),
               _tick(depths={0: 0, 1: 0, 2: 0})]),
    # Per-class budgets; untagged requests never breach.
    "class_budgets": dict(
        policy=dict(min_workers=1, max_workers=4, cooldown_s=0.0, wait_budget_s=1.0,
                    class_budgets_s={"interactive": 0.05}, idle_ticks=3),
        pool=2,
        ticks=[_tick([("bulk", 0.5), (None, 9.0)]), _tick([("interactive", 0.04)] * 99
                                                          + [("interactive", 0.06)]),
               _tick([("interactive", 0.07)]), _tick([("bulk", 2.0)])]),
    # A breach inside the cooldown holds without a note; the cooldown runs
    # from the end of the last scale.
    "cooldown": dict(
        policy=dict(min_workers=1, max_workers=4, cooldown_s=1.0, wait_budget_s=0.01,
                    idle_ticks=1),
        pool=1,
        ticks=[_tick([("x", 0.5)]), _tick([("x", 0.5)], advance=0.4),
               _tick([("x", 0.5)], advance=0.4), _tick([("x", 0.5)], advance=0.4),
               _tick(advance=0.5), _tick(advance=2.0)]),
    # A cleared bus re-bases the request counter: the next tick is idle.
    "bus_cleared": dict(
        policy=dict(min_workers=1, max_workers=2, cooldown_s=0.0, wait_budget_s=10.0,
                    idle_ticks=2),
        pool=2,
        ticks=[_tick([("a", 0.1)] * 5), _tick(clear=True), _tick(), _tick(requests=3),
               _tick(), _tick()]),
    # A restored decision (wall-clock stamped) keeps the cooldown across a
    # router restart.
    "restored_cooldown": dict(
        policy=dict(min_workers=1, max_workers=4, cooldown_s=5.0, wait_budget_s=0.01),
        pool=2, last={"action": "up", "pool": 2, "at": 1_000_000.0 - 2.0},
        ticks=[_tick([("x", 1.0)]), _tick([("x", 1.0)], advance=2.0),
               _tick([("x", 1.0)], advance=1.0)]),
}


def _run(mod, bus, clock, scenario):
    router = _Router(scenario["pool"], last=scenario.get("last"))
    scaler = mod.Autoscaler(router, mod.ElasticPolicy(**scenario["policy"]))
    decisions = []
    for tick in scenario["ticks"]:
        if tick["clear"]:
            bus.clear()
        for cls, dur in tick["spans"]:
            args = {"op": "solve"} if cls is None else {"op": "solve", "cls": cls}
            bus.complete("fleet.request", dur, cat="fleet", **args)
        if tick["requests"]:
            bus.count("fleet.requests", tick["requests"])
        router.depths = tick["depths"]
        clock.mono += tick["advance"]
        decisions.append(scaler.step())
    return decisions, router.told, scaler.decisions


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_jax(monkeypatch, name):
    got = []
    for mod, bus in PAIRS:
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        got.append(_run(mod, bus, clock, SCENARIOS[name]))
    assert got[1] == got[0]
    actions = [d["action"] for d in got[1][0]]
    assert actions != ["hold"] * len(actions) or name == "restored_cooldown"
    if name == "restored_cooldown":
        assert actions == ["hold", "hold", "up"]


@pytest.mark.parametrize("kwargs", [
    dict(min_workers=0), dict(min_workers=3, max_workers=2), dict(tick_s=0.0),
    dict(idle_ticks=0)])
def test_policy_validation_equal_jax(kwargs):
    msgs = []
    for mod, _ in PAIRS:
        with pytest.raises(ValueError) as e:
            mod.ElasticPolicy(**kwargs)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("spec", ["interactive=0.05, bulk=2", "", " a=1 ,", "nope"])
def test_parse_class_budgets_equal_jax(spec):
    got = []
    for mod, _ in PAIRS:
        try:
            got.append(mod.parse_class_budgets(spec))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[1] == got[0]
    policy = tauto.ElasticPolicy(class_budgets_s=got[1] if isinstance(got[1], dict) else {},
                                 wait_budget_s=0.5)
    assert policy.budget_for("untuned") == 0.5


def test_autoscaler_refuses_remote_topologies():
    router = FleetRouter(FleetConfig(remote_workers=("127.0.0.1:1",), transport="tcp"))
    with pytest.raises(ValueError, match="remote"):
        tauto.Autoscaler(router)


# ----------------------------------------------------------------------
# The elastic primitives on a fleet of the port's echo workers
# ----------------------------------------------------------------------
def _echo_config(workers, **kw):
    defaults = dict(workers=workers, test_echo=True, heartbeat_interval_s=0.1,
                    restart_backoff_base_s=0.02, restart_backoff_cap_s=0.2,
                    ready_timeout_s=120.0, request_timeout_s=30.0)
    defaults.update(kw)
    return FleetConfig(**defaults)


def test_step_drives_a_real_fleet_up_and_down():
    """Breach -> a warm join that owns its ring share; at max -> hold with a
    reason; sustained idle -> a drained retire; at min -> hold."""
    policy = tauto.ElasticPolicy(min_workers=1, max_workers=2, tick_s=0.05, cooldown_s=0.0,
                                 wait_budget_s=0.0, idle_ticks=2)
    with FleetRouter(_echo_config(1)) as r:
        a = tauto.Autoscaler(r, policy)
        assert r.handle({"op": "solve", "digest": "t1", "slo_class": "hit"})["ok"]
        d1 = a.step()
        assert d1["action"] == "up" and "budget" in d1["reason"] and r.pool_size() == 2
        ring = HashRing(range(2), replicas=r.config.ring_replicas)
        d = next(f"j{i}" for i in range(1000) if ring.assign(f"j{i}") == 1)
        resp = r.handle({"op": "solve", "digest": d, "slo_class": "hit"})
        assert resp["ok"] and resp["worker"] == 1
        d2 = a.step()
        assert d2["action"] == "hold" and "max_workers" in d2["reason"]
        assert a.step()["action"] == "hold"  # idle tick 1 of 2
        d3 = a.step()
        assert d3["action"] == "down" and "idle" in d3["reason"] and r.pool_size() == 1
        assert a.step()["action"] == "hold"
        counters = TBUS.counters()
        assert counters.get("fleet.scale.up") == 1 and counters.get("fleet.scale.down") == 1
        assert counters.get("fleet.worker.dead", 0) == 0
        assert TBUS.histograms()["fleet.join.warm_s"]["count"] == 1
        last = r.handle({"op": "stats"})["pool"]["last_scale"]
        assert last["action"] == "down" and "idle" in last["reason"]
        retired = [w for w in r._workers if w.retired]
        assert len(retired) == 1 and retired[0].proc.returncode == 0


def test_add_worker_refuses_cold_hello_join():
    with FleetRouter(_echo_config(1, worker_env={1: {"GHS_FLEET_COLD_HELLO": "1"}})) as r:
        with pytest.raises(RuntimeError, match="warmed"):
            r.add_worker()
        assert r.pool_size() == 1
        assert TBUS.counters().get("fleet.join.cold_rejected", 0) == 1
        assert r.handle({"op": "solve", "digest": "post-cold"})["ok"]


def test_retire_drains_in_flight_and_migrates_the_session():
    with FleetRouter(_echo_config(3)) as r:
        seed = r.handle({"op": "solve", "digest": "retire-chain"})
        upd = r.handle({"op": "update", "digest": "retire-chain", "updates": [{"k": 1}]})
        assert upd["ok"] and upd["worker"] == seed["worker"]
        victim = upd["worker"]
        results, started = [], threading.Event()

        def slow():
            started.set()
            results.append(r.handle({"op": "solve", "digest": "retire-chain", "sleep_s": 0.4}))

        t = threading.Thread(target=slow)
        t.start()
        started.wait(5)
        deadline = time.monotonic() + 5
        while not r._workers[victim].pending and time.monotonic() < deadline:
            time.sleep(0.01)
        out = r.retire_worker(victim)
        t.join(timeout=30)
        assert results and results[0]["ok"] and out["exit_code"] == 0
        assert out["sessions_moved"] >= 1 and r.pool_size() == 2
        after = r.handle({"op": "update", "digest": upd["digest"], "updates": [{"k": 2}]})
        assert after["ok"] and after["worker"] != victim
        assert TBUS.counters().get("fleet.worker.dead", 0) == 0


def test_abandoned_worker_leaves_the_pool_count():
    with FleetRouter(_echo_config(2, max_restarts=0)) as r:
        r.kill_worker(1)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and r.pool_size() != 1:
            time.sleep(0.05)
        assert r.pool_size() == 1
        assert TBUS.counters().get("fleet.worker.abandoned", 0) == 1
        with pytest.raises(ValueError, match="last live"):
            r.retire_worker(0)
        assert r.handle({"op": "solve", "digest": "survivor"})["ok"]
