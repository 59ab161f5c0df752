"""Elastic fleet control loop: obs-driven autoscaling with warm handoff.

Port of the JAX package's ``fleet/autoscaler.py`` on the port's bus
(``obs/events.quantile``, ``obs/slo.window_class_waits``): the same signals
give the same decisions.

``FleetConfig.workers`` fixes pool size at boot — the paper's own shape
(one MPI rank per graph node, forever) inherited by every fleet round so
far — while real traffic is diurnal and bursty. This module closes the
loop: an :class:`Autoscaler` thread watches the SAME obs bus the SLO gate
reads and drives the worker pool between ``min_workers`` and
``max_workers`` through the router's elastic primitives
(:meth:`fleet.router.FleetRouter.add_worker` /
:meth:`~fleet.router.FleetRouter.retire_worker`).

**Signals** (read per control tick, never sampled across the whole run —
hysteresis needs recency):

* *Queue-wait breach* — the per-class request durations appended to the
  bus since the last tick (``obs.slo.window_class_waits`` joins the
  ``fleet.request`` spans exactly like the SLO report does); a class
  whose tick-window p99 exceeds its budget
  (:meth:`ElasticPolicy.budget_for`) is a breach.
* *Queue depth* — ``router.queue_depths()``; any worker at or past
  ``queue_high`` in-flight requests is a breach even when latency has not
  yet degraded (depth leads latency).
* *Sustained idle* — zero new requests AND zero queued work for
  ``idle_ticks`` consecutive ticks.

**Decisions** are deterministic given the signals: scale **by one**, with
a ``cooldown_s`` window between any two scale operations — the hysteresis
that makes the elastic drill's scale-event counts exactly reproducible.
Scale-up is warm handoff by construction (``add_worker`` refuses ring
entry until the joiner's ``warmed`` hello is confirmed — the joiner
pre-seeded from the shared disk store, attached the persistent build
cache, and ran its warmup ladder first); scale-down picks the
lowest-affinity victim and drains it (``retire_worker``: off the ring
first, in-flight work flushes, pinned sessions migrate by disk-store
reads / stream-WAL replay on the inheritors, exit 0).

Telemetry: the router primitives count ``fleet.scale.up`` /
``fleet.scale.down`` and record ``fleet.join.warm_s``; this loop adds
``fleet.scale.decision`` instants (action + reason) and pushes its latest
decision to the router so the ``stats`` op can answer "why is the fleet
this size". ``docs/FLEET.md`` "Elasticity" covers the knobs;
``tools/load_drill.py --ramp --elastic`` is the drill and
``gate-fleet-elastic-v1`` the CI gate.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Mapping, Optional

from distributed_ghs_implementation_tpu_torch.obs.events import BUS, quantile
from distributed_ghs_implementation_tpu_torch.obs.slo import window_class_waits

#: Default per-class wait budget when :attr:`ElasticPolicy.class_budgets_s`
#: has no entry for a class (seconds of end-to-end request latency).
DEFAULT_WAIT_BUDGET_S = 0.25


def parse_class_budgets(spec: str) -> Dict[str, float]:
    """``"interactive=0.05,bulk=2"`` -> ``{"interactive": 0.05, ...}``
    (the ``--fleet-elastic-budgets`` CLI surface)."""
    out: Dict[str, float] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        cls, _, value = entry.partition("=")
        if not value:
            raise ValueError(
                f"bad class budget {entry!r}; expected CLASS=SECONDS"
            )
        out[cls.strip()] = float(value)
    return out


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """The autoscaler's knobs. Everything is deterministic: same signal
    sequence, same decisions (the reproducibility the drill gates on).

    ``wait_budget_s`` is the default per-class latency budget;
    ``class_budgets_s`` overrides it per class (the load drill sets an
    aggressive budget so a ramp deterministically provokes scale-up).
    ``cooldown_s`` runs from the *completion* of a scale operation — a
    warm join that takes 20s does not bank 20s of cooldown credit.
    """

    min_workers: int = 1
    max_workers: int = 4
    tick_s: float = 0.25
    cooldown_s: float = 2.0
    wait_budget_s: float = DEFAULT_WAIT_BUDGET_S
    class_budgets_s: Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )
    queue_high: int = 8
    idle_ticks: int = 10
    join_timeout_s: Optional[float] = None  # None -> router ready timeout

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) < min_workers "
                f"({self.min_workers})"
            )
        if self.tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {self.tick_s}")
        if self.idle_ticks < 1:
            raise ValueError(f"idle_ticks must be >= 1, got {self.idle_ticks}")

    def budget_for(self, cls: str) -> float:
        return float(self.class_budgets_s.get(cls, self.wait_budget_s))


class Autoscaler:
    """The control loop. Own thread; :meth:`step` is also callable
    directly (tests drive ticks without wall-clock waits).

    Scale operations run INSIDE the loop thread and block it — a warm
    join is seconds-to-tens-of-seconds of spawn + warmup, and blocking is
    exactly the scale-by-one serialization the hysteresis wants: there is
    never more than one join or retire in flight.
    """

    def __init__(self, router, policy: Optional[ElasticPolicy] = None):
        self.router = router
        self.policy = policy or ElasticPolicy()
        if getattr(router.config, "remote_workers", ()):
            raise ValueError(
                "autoscaling needs spawnable workers; a --fleet-workers "
                "remote topology is fixed by its endpoint list"
            )
        self._mark = BUS.mark()
        self._requests_seen = float(
            BUS.counters().get("fleet.requests", 0)
        )
        self._idle_streak = 0
        self._last_scale_done = float("-inf")
        # A journal-restored router hands back its last (wall-clock
        # stamped) scale decision: the cooldown spans the crash, so a
        # restarting router cannot double-scale a fleet that had just
        # scaled (docs/FLEET.md "Router survivability").
        last = getattr(router, "last_scale_decision", None)
        if last and last.get("at") and last.get("action") in ("up", "down"):
            age = max(0.0, time.time() - float(last["at"]))
            if age < self.policy.cooldown_s:
                self._last_scale_done = time.monotonic() - age
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        #: Bounded decision log (newest last) — drills read it for the
        #: pool-size trajectory; the router keeps only the latest.
        self.decisions: List[dict] = []

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _loop(self) -> None:
        while not self._closed:
            time.sleep(self.policy.tick_s)
            if self._closed:
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # A failed join/retire is an incident, not a crash: note
                # it, keep watching (the next breach retries). The
                # fleet.scale.failed counter is owned by the router's
                # failure sites — counting here too would double one
                # timed-out join.
                self._note({
                    "action": "failed",
                    "reason": f"{type(e).__name__}: {e}",
                    "pool": self._pool(),
                })

    # -- signals -------------------------------------------------------
    def _pool(self) -> int:
        return self.router.pool_size()

    def _signals(self) -> dict:
        """One tick's worth of evidence, read then consumed (the mark and
        counter baselines advance so the next tick sees only new events —
        a BUS.clear() between ticks just re-bases both)."""
        events = BUS.events_since(self._mark)
        self._mark = BUS.mark()
        waits = window_class_waits(events)
        total = float(BUS.counters().get("fleet.requests", 0))
        if total < self._requests_seen:  # the bus was cleared
            self._requests_seen = total
        new_requests = total - self._requests_seen
        self._requests_seen = total
        depths = self.router.queue_depths()
        breach = None
        for cls in sorted(waits):
            p99 = quantile(waits[cls], 0.99)
            budget = self.policy.budget_for(cls)
            if p99 > budget:
                breach = (
                    f"class '{cls}' wait p99 {p99:.3f}s over its "
                    f"{budget:.3f}s budget"
                )
                break
        if breach is None and depths:
            worst = max(depths, key=lambda wid: depths[wid])
            if depths[worst] >= self.policy.queue_high:
                breach = (
                    f"worker {worst} queue depth {depths[worst]} at the "
                    f"{self.policy.queue_high} watermark"
                )
        idle = new_requests == 0 and sum(depths.values()) == 0
        return {"breach": breach, "idle": idle,
                "new_requests": new_requests}

    # -- the decision --------------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One control tick; returns the decision record."""
        now = time.monotonic() if now is None else now
        sig = self._signals()
        if sig["idle"]:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        pool = self._pool()
        policy = self.policy
        cooling = (now - self._last_scale_done) < policy.cooldown_s
        decision = {"action": "hold", "pool": pool, "reason": "steady"}
        if sig["breach"] is not None:
            if pool >= policy.max_workers:
                decision["reason"] = (
                    f"{sig['breach']} — already at max_workers "
                    f"({policy.max_workers})"
                )
                decision["constrained"] = "at_max"
            elif cooling:
                decision["reason"] = f"{sig['breach']} — in cooldown"
            else:
                joined = self.router.add_worker(
                    timeout_s=policy.join_timeout_s
                )
                self._last_scale_done = time.monotonic()
                decision = {
                    "action": "up",
                    "pool": self._pool(),
                    "worker": joined["worker"],
                    "warm_s": round(joined["warm_s"], 3),
                    "reason": sig["breach"],
                }
        elif (
            self._idle_streak >= policy.idle_ticks
            and pool > policy.min_workers
            and not cooling
        ):
            retired = self.router.retire_worker()
            self._last_scale_done = time.monotonic()
            self._idle_streak = 0
            decision = {
                "action": "down",
                "pool": self._pool(),
                "worker": retired["worker"],
                "sessions_moved": retired["sessions_moved"],
                "reason": (
                    f"idle for {policy.idle_ticks} ticks "
                    f"({policy.idle_ticks * policy.tick_s:.1f}s) above "
                    f"min_workers ({policy.min_workers})"
                ),
            }
        if decision["action"] != "hold":
            self._note(decision)
        elif decision.get("constrained"):
            # Breach with no legal move (at max_workers): the one hold an
            # operator must SEE — it answers "why won't the fleet grow" in
            # stats.pool.last_scale (docs/FLEET.md failure row). Note the
            # first of each streak, not every tick: a persistent breach
            # would otherwise flood the decision log. Cooldown holds stay
            # un-noted — they resolve themselves within cooldown_s.
            last = self.decisions[-1] if self.decisions else None
            if last is None or not last.get("constrained"):
                self._note(decision)
        return decision

    def _note(self, decision: dict) -> None:
        decision = dict(decision)
        self.decisions.append(decision)
        del self.decisions[:-64]
        self.router.note_scale_decision(decision)
        BUS.instant("fleet.scale.decision", cat="fleet", **decision)
