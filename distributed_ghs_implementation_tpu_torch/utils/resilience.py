"""Supervised solves and the fault-injection registry.

A transient device failure (an out-of-memory spike, a lost connection, a
slow filesystem) aborts a long solve, and nothing above the solver knows how
to try again. This module adds that discipline, as the JAX package's
``utils/resilience.py`` does:

* :class:`FaultRegistry`: named injection sites armed through the
  ``GHS_FAULT_*`` environment or :meth:`FaultRegistry.inject`, so tests and
  operators can induce solver exceptions, slow chunks and torn checkpoint
  writes deterministically.
* :class:`Supervisor`: a watchdog deadline (checked at chunk and level
  boundaries: nothing interrupts a running kernel), bounded retry with
  capped exponential backoff on *transient* errors, and the degradation
  ladder ``sharded -> device -> stepped -> host``. Every attempt lands in an
  :class:`IncidentLog` and on the event bus.

Exposed as ``api.minimum_spanning_forest(..., supervised=True)``.

Where the port differs from the JAX package, on purpose:

* **An explicit device.** :meth:`Supervisor.solve` takes ``device=None``,
  which means CUDA, and raises without it unless the caller passes
  ``device="cpu"``. The device and stepped rungs run there; the host rung
  is the native Kruskal and touches no card.
* **The sharded rung** runs ``parallel.sharded.solve_graph_sharded`` over
  a mesh of the visible cards on the supervisor's device (one shard on the
  CPU), as the JAX package's runs over its devices. Only
  :class:`RungUnavailable` means ``unavailable`` (the host rung on float
  weights); any other ``NotImplementedError``, such as torch's for an
  operator with no CUDA kernel for a dtype, is fatal.
* **What is transient.** ``torch.OutOfMemoryError`` (the analog of XLA's
  RESOURCE_EXHAUSTED) is retried, beside the JAX package's own list. A CUDA
  error from a kernel is fatal: the wrappers' ``RuntimeError("... kernel
  launch failed: CUDA error ...")``, torch's ``AcceleratorError``, and a
  kernel or native library that fails to build or load
  (:class:`~distributed_ghs_implementation_tpu_torch.ops._build.KernelBuildError`,
  whatever its cause, an ``OSError`` included). After such an error the CUDA context is
  lost, so a retry cannot help, and degrading to the host rung would hide a
  faulty kernel behind a right answer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops._build import KernelBuildError


# ----------------------------------------------------------------------
# Error vocabulary
# ----------------------------------------------------------------------
class InjectedFault(RuntimeError):
    """Raised at an armed injection site (always classified transient)."""


class TransientDeviceError(RuntimeError):
    """Explicitly-transient wrapper for callers surfacing retryable errors."""


class WatchdogTimeout(RuntimeError):
    """An attempt exceeded the supervisor deadline at a chunk boundary."""


class RungUnavailable(NotImplementedError):
    """A rung that can never run here (not for this graph's weights): the
    ladder records it and moves on at once."""


class SupervisorExhausted(RuntimeError):
    """Every rung of the degradation ladder failed; carries the incident log."""

    def __init__(self, message: str, incidents: "IncidentLog"):
        super().__init__(message)
        self.incidents = incidents


def is_transient(exc: BaseException) -> bool:
    """Should the supervisor retry and degrade (True) or re-raise (False)?

    Transient: injected faults, watchdog timeouts, explicit
    :class:`TransientDeviceError`, OS, timeout and connection errors, and
    ``torch.OutOfMemoryError``. Everything else is fatal: a ``ValueError``
    from malformed input, every CUDA error from a kernel (a launch that
    failed, ``AcceleratorError``), and a library that failed to build or
    load (:class:`KernelBuildError`, even where its cause is an OSError).
    """
    if isinstance(exc, KernelBuildError):
        return False
    return isinstance(
        exc,
        (
            InjectedFault,
            TransientDeviceError,
            WatchdogTimeout,
            TimeoutError,
            ConnectionError,
            OSError,
            torch.OutOfMemoryError,
        ),
    )


# ----------------------------------------------------------------------
# Fault-injection registry
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _ArmedFault:
    remaining: int
    kind: str = "raise"  # "raise" | "slow" | "torn"
    value: float = 0.0  # seconds for kind="slow"


class FaultRegistry:
    """Process-global registry of induced faults at named sites.

    Site names are dotted, underscore-free identifiers
    (``resilience.attempt.device``, ``checkpoint.save``). Arm a site either
    programmatically::

        with FAULTS.inject("resilience.attempt.device", times=2):
            ...

    or from the environment, mapping ``GHS_FAULT_<SITE>`` with dots as
    underscores and a ``times[:kind[:value]]`` value::

        GHS_FAULT_RESILIENCE_ATTEMPT_DEVICE=2
        GHS_FAULT_CHECKPOINT_SAVE=1:torn
        GHS_FAULT_RESILIENCE_SLOW_STEPPED=1:slow:3600

    Kinds: ``raise`` makes the site raise :class:`InjectedFault`; ``slow``
    advances the supervisor's virtual clock by ``value`` seconds at the next
    chunk boundary (a deterministic stand-in for a stalled launch, with no
    sleep); ``torn`` makes ``save_checkpoint`` leave a truncated file and
    raise, as a crash mid-write on a non-atomic filesystem would.

    The JAX package keeps a registry of its own: in a process that loads
    both, ``GHS_FAULT_*`` arms each at its next :meth:`reload_env`.
    """

    ENV_PREFIX = "GHS_FAULT_"

    def __init__(self):
        self._sites: Dict[str, _ArmedFault] = {}
        self._env_loaded = False

    # -- configuration -------------------------------------------------
    def arm(
        self, site: str, *, times: int = 1, kind: str = "raise", value: float = 0.0
    ) -> None:
        if kind not in ("raise", "slow", "torn"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if "_" in site:
            raise ValueError(
                f"site {site!r} may not contain '_' (reserved for the env mapping)"
            )
        self._sites[site] = _ArmedFault(remaining=times, kind=kind, value=value)

    def disarm(self, site: str) -> None:
        self._sites.pop(site, None)

    def reset(self) -> None:
        """Forget every armed site AND any env-derived state (test isolation)."""
        self._sites.clear()
        self._env_loaded = True  # do not re-read the env behind the reset

    def reload_env(self) -> None:
        """(Re-)parse ``GHS_FAULT_*`` from the current environment."""
        self._env_loaded = True
        for key, raw in os.environ.items():
            if not key.startswith(self.ENV_PREFIX) or not raw:
                continue
            site = key[len(self.ENV_PREFIX):].lower().replace("_", ".")
            parts = raw.split(":")
            try:
                times = int(parts[0])
                kind = parts[1] if len(parts) > 1 else "raise"
                value = float(parts[2]) if len(parts) > 2 else 0.0
            except ValueError as e:
                raise ValueError(
                    f"bad {key}={raw!r}; expected times[:kind[:value]]"
                ) from e
            self.arm(site, times=times, kind=kind, value=value)

    @contextlib.contextmanager
    def inject(
        self, site: str, *, times: int = 1, kind: str = "raise", value: float = 0.0
    ):
        """Arm ``site`` for the duration of the block, disarming on exit."""
        self.arm(site, times=times, kind=kind, value=value)
        try:
            yield self
        finally:
            self.disarm(site)

    # -- firing --------------------------------------------------------
    def armed(self, site: str) -> bool:
        """Is ``site`` armed? (peek: does not consume a shot)."""
        if not self._env_loaded:
            self.reload_env()
        return site in self._sites

    def pop(self, site: str) -> Optional[_ArmedFault]:
        """Consume one shot at ``site``; returns the armed spec or ``None``."""
        if not self._env_loaded:
            self.reload_env()
        armed = self._sites.get(site)
        if armed is None or armed.remaining <= 0:
            return None
        armed.remaining -= 1
        if armed.remaining == 0:
            del self._sites[site]
        return armed

    def fire(self, site: str) -> None:
        """Raise :class:`InjectedFault` if ``site`` is armed (kind ``raise``)."""
        armed = self.pop(site)
        if armed is not None and armed.kind == "raise":
            raise InjectedFault(f"injected fault at {site}")


FAULTS = FaultRegistry()


# ----------------------------------------------------------------------
# Incident log
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Incident:
    rung: str
    attempt: int  # 1-based within the rung
    outcome: str  # "ok" | "transient" | "timeout" | "unavailable" | "fatal"
    error: Optional[str] = None
    elapsed_s: float = 0.0
    backoff_s: float = 0.0
    # The fault-registry site implicated in a failed attempt (the attempt
    # site for transient and fatal errors, the slow site for timeouts);
    # None on success and for an unavailable rung.
    site: Optional[str] = None


class IncidentLog:
    """Structured record of every supervised attempt, in order.

    Every record is mirrored onto the event bus as a ``resilience.attempt``
    span-event (duration = the attempt's elapsed time), so traces show the
    retry and degrade ladder inline with the solver's events.
    """

    def __init__(self):
        self.records: List[Incident] = []

    def add(self, **kwargs) -> Incident:
        rec = Incident(**kwargs)
        self.records.append(rec)
        BUS.complete(
            "resilience.attempt",
            rec.elapsed_s,
            cat="resilience",
            rung=rec.rung,
            attempt=rec.attempt,
            outcome=rec.outcome,
            error=rec.error,
            backoff_s=rec.backoff_s,
            site=rec.site,
        )
        return rec

    @property
    def final_rung(self) -> Optional[str]:
        for rec in reversed(self.records):
            if rec.outcome == "ok":
                return rec.rung
        return None

    def to_dicts(self) -> List[dict]:
        return [dataclasses.asdict(r) for r in self.records]

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dicts(), **kwargs)

    def summary(self) -> str:
        """One line per attempt, e.g. ``device#1 transient(InjectedFault)``."""
        parts = []
        for r in self.records:
            detail = "" if r.error is None else f"({r.error.split('(')[0]})"
            parts.append(f"{r.rung}#{r.attempt} {r.outcome}{detail}")
        return " -> ".join(parts)

    def __len__(self) -> int:
        return len(self.records)


# ----------------------------------------------------------------------
# Degradation ladder rungs: each returns solve_graph's (edge_ids, fragment,
# levels). ``tick`` (when not None) is called at chunk and level
# boundaries; the supervisor uses it for the cooperative watchdog.
# ----------------------------------------------------------------------
def _rung_sharded(graph: Graph, tick, device):
    from distributed_ghs_implementation_tpu_torch.parallel.sharded import (
        solve_graph_sharded,
    )

    return solve_graph_sharded(graph, device=device)


def _rung_device(graph: Graph, tick, device):
    from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
        make_production_solver,
    )

    from distributed_ghs_implementation_tpu_torch.models.boruvka import harvest

    solve = make_production_solver(graph, device=device)
    on_chunk = None if tick is None else (lambda level, frag, mst, count: tick())
    return harvest(graph, *solve(on_chunk=on_chunk))


def _rung_stepped(graph: Graph, tick, device):
    from distributed_ghs_implementation_tpu_torch.models.boruvka import (
        harvest,
        prepare_device_arrays,
        solve_arrays_stepped,
    )

    args = prepare_device_arrays(graph, device=device)
    on_level = (
        None if tick is None else (lambda level, f, m, has, count, dt: tick())
    )
    return harvest(graph, *solve_arrays_stepped(*args, stepped_levels=None, on_level=on_level))


def _rung_host(graph: Graph, tick, device):
    from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
        solve_graph_kruskal_host,
    )

    # A native library that fails to build or load raises KernelBuildError,
    # which is fatal.
    if not graph.is_integer_weighted:
        raise RungUnavailable("host backend needs integer weights")
    return solve_graph_kruskal_host(graph)


_RUNGS = {
    "sharded": _rung_sharded,
    "device": _rung_device,
    "stepped": _rung_stepped,
    "host": _rung_host,
}

#: Degradation order: several cards -> the production routing on one ->
#: the host-stepped solve (the simplest device path, one sync a level) ->
#: host Kruskal (no card at all). Each rung trades speed for fewer moving
#: parts; all compute the same forest (the rank order makes it unique).
LADDER: Tuple[str, ...] = ("sharded", "device", "stepped", "host")


# ----------------------------------------------------------------------
# Supervisor
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Retry and degrade policy.

    ``retries_per_rung`` is the number of *re*-tries after the first attempt
    (so a rung sees at most ``retries_per_rung + 1`` attempts).
    ``deadline_s`` arms the cooperative watchdog: attempts are aborted with
    :class:`WatchdogTimeout` at the first chunk or level boundary past the
    deadline (the host rung has no boundaries and runs unguarded).
    """

    retries_per_rung: int = 1
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    deadline_s: Optional[float] = None
    ladder: Tuple[str, ...] = LADDER


class Supervisor:
    """Retry, degrade, and log around any ladder rung.

    ``clock`` and ``sleep`` are injectable for deterministic tests (the
    armed ``resilience.slow.<rung>`` site advances a virtual skew on top of
    ``clock``, so a slow chunk is simulated without sleeping).
    """

    def __init__(
        self,
        config: Optional[SupervisorConfig] = None,
        *,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.config = config or SupervisorConfig()
        self._clock = clock
        self._sleep = sleep
        bad = [r for r in self.config.ladder if r not in _RUNGS]
        if bad:
            raise ValueError(f"unknown ladder rungs {bad}; known: {sorted(_RUNGS)}")

    def solve(self, graph: Graph, *, entry: str = "device", device=None):
        """Run the ladder from ``entry`` down on ``device`` (``None`` =
        CUDA); returns ``(edge_ids, fragment, levels, incident_log)``.

        ``entry`` outside the ladder (e.g. ``"protocol"``) starts at
        ``"device"``. Raises :class:`SupervisorExhausted` when every rung
        fails, and a fatal error at once (after logging it).
        """
        device = resolve_device(device)
        cfg = self.config
        log = IncidentLog()
        if graph.num_nodes == 0 or graph.num_edges == 0:
            return (
                np.zeros(0, dtype=np.int64),
                np.arange(graph.num_nodes, dtype=np.int32),
                0,
                log,
            )
        ladder = cfg.ladder
        if entry in ladder:
            start = ladder.index(entry)
        elif "device" in ladder:
            start = ladder.index("device")
        else:
            start = 0
        with BUS.span(
            "resilience.solve", cat="resilience", entry=ladder[start],
            nodes=graph.num_nodes, edges=graph.num_edges,
        ) as span:
            remaining = ladder[start:]
            for i, rung in enumerate(remaining):
                outcome = self._attempt_rung(rung, graph, log, device)
                if outcome is not None:
                    span.set(final_rung=rung, attempts=len(log))
                    return outcome + (log,)
                if i + 1 < len(remaining):
                    BUS.instant(
                        "resilience.degrade",
                        cat="resilience",
                        from_rung=rung,
                        to_rung=remaining[i + 1],
                    )
            span.set(final_rung=None, attempts=len(log))
        raise SupervisorExhausted(
            f"every rung failed: {log.summary()}", log
        )

    # ------------------------------------------------------------------
    def _attempt_rung(self, rung: str, graph: Graph, log: IncidentLog, device):
        """All attempts of one rung; result tuple on success, None to degrade."""
        cfg = self.config
        for attempt in range(1, cfg.retries_per_rung + 2):
            skew = [0.0]
            t0 = self._clock()

            def tick():
                armed = FAULTS.pop(f"resilience.slow.{rung}")
                if armed is not None:
                    if armed.kind == "slow":
                        skew[0] += armed.value
                    else:
                        raise InjectedFault(f"injected fault at resilience.slow.{rung}")
                elapsed = (self._clock() - t0) + skew[0]
                if cfg.deadline_s is not None and elapsed > cfg.deadline_s:
                    raise WatchdogTimeout(
                        f"{rung} attempt {attempt}: {elapsed:.1f}s elapsed "
                        f"exceeds the {cfg.deadline_s}s deadline"
                    )

            # A boundary hook selects the chunked forms of the rank route,
            # so guard only when the watchdog has a deadline to enforce, or
            # a slow site is armed, which must be consumed here rather than
            # leak into an unrelated later solve.
            guard = (
                tick
                if cfg.deadline_s is not None
                or FAULTS.armed(f"resilience.slow.{rung}")
                else None
            )
            try:
                FAULTS.fire(f"resilience.attempt.{rung}")
                result = _RUNGS[rung](graph, guard, device)
            except RungUnavailable as e:
                log.add(
                    rung=rung,
                    attempt=attempt,
                    outcome="unavailable",
                    error=str(e),
                    elapsed_s=(self._clock() - t0) + skew[0],
                )
                return None  # this rung can never work here: degrade
            except Exception as e:  # noqa: BLE001 -- classification below
                elapsed = (self._clock() - t0) + skew[0]
                if not is_transient(e):
                    log.add(
                        rung=rung,
                        attempt=attempt,
                        outcome="fatal",
                        error=repr(e),
                        elapsed_s=elapsed,
                        site=f"resilience.attempt.{rung}",
                    )
                    raise
                retrying = attempt <= cfg.retries_per_rung
                backoff = 0.0
                if retrying:
                    backoff = min(
                        cfg.backoff_base_s * (2 ** (attempt - 1)),
                        cfg.backoff_cap_s,
                    )
                timed_out = isinstance(e, WatchdogTimeout)
                log.add(
                    rung=rung,
                    attempt=attempt,
                    outcome="timeout" if timed_out else "transient",
                    error=repr(e),
                    elapsed_s=elapsed,
                    backoff_s=backoff,
                    site=(
                        f"resilience.slow.{rung}"
                        if timed_out
                        else f"resilience.attempt.{rung}"
                    ),
                )
                if retrying and backoff > 0:
                    self._sleep(backoff)
                continue
            log.add(
                rung=rung,
                attempt=attempt,
                outcome="ok",
                elapsed_s=(self._clock() - t0) + skew[0],
            )
            return result
        return None  # retries exhausted: degrade to the next rung


def supervised_solve(
    graph: Graph,
    *,
    entry: str = "device",
    config: Optional[SupervisorConfig] = None,
    clock=time.monotonic,
    sleep=time.sleep,
    device=None,
):
    """``Supervisor(config).solve(graph, entry=entry, device=device)``."""
    return Supervisor(config, clock=clock, sleep=sleep).solve(
        graph, entry=entry, device=device
    )
