"""The port's supervised solves and host backend against the JAX package's.

The same graphs from a seed, the same armed faults and the same virtual
clock go to both supervisors; the incident trails ``(rung, attempt,
outcome, site, backoff_s)``, the forests (edge ids, fragments, levels) and
the ``resilience.*`` / ``solver.*`` event sequences, times removed, must be
equal. Each package has its own fault registry and event bus, and each is
driven on its own. Where the port differs on purpose, the difference is
pinned: the sharded rung is unavailable, a CUDA error from a kernel or a
failed build is fatal, and ``torch.OutOfMemoryError`` is transient.
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.utils import resilience as jres
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import native as tnative
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.ops import _build
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_pairs import (  # noqa: F401 -- fixtures
    CPU,
    FAMILIES,
    VirtualClock,
    event_trail,
    incident_trail,
    isolated,
    jax_native,
    jax_native_library,
    pair,
)

pytestmark = pytest.mark.usefixtures("isolated")

#: A kernel launch that failed, as the wrappers raise it (``ops/kernels.py``).
LAUNCH_ERROR = "hook_compress kernel launch failed: CUDA error 700 (an illegal memory access)"


def _both(name, config=None, *, entry="device", arm=(), env=None):
    """Run the supervised solve of graph ``name`` in each package with the
    same faults armed (``arm``: ``(site, times, kind, value)``) and the
    same virtual clock; return ``{"jax": ..., "port": ...}`` of ``(result
    or exception, incident log, events, sleeps)``."""
    jg, tg = pair(name)
    out = {}
    for side, mod, bus, g, kw in (("jax", jres, JBUS, jg, {}),
                                  ("port", tres, TBUS, tg, {"device": CPU})):
        for site, times, kind, value in arm:
            mod.FAULTS.arm(site, times=times, kind=kind, value=value)
        if env is not None:
            mod.FAULTS._env_loaded = False  # a fresh process reads GHS_FAULT_*
        vc = VirtualClock()
        sup = mod.Supervisor(config, clock=vc.clock, sleep=vc.sleep)
        mark = bus.mark()
        try:
            ids, frag, levels, log = sup.solve(g, entry=entry, **kw)
            result = (ids, frag, levels)
        except Exception as e:  # noqa: BLE001 -- compared below
            result = e
            log = getattr(e, "incidents", None)
        out[side] = (result, log, event_trail(bus, mark, port=side == "port"), vc.sleeps)
        mod.FAULTS.reset()
    return out


def _same_forest(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _assert_same_run(runs, trail):
    (jr, jlog, jev, jsleep), (tr, tlog, tev, tsleep) = runs["jax"], runs["port"]
    assert incident_trail(tlog) == incident_trail(jlog) == trail
    _same_forest(tr, jr)
    assert tev == jev
    assert tsleep == jsleep


# ---------------------------------------------------------------------------
# The ladder, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_happy_path_matches_jax(name):
    runs = _both(name)
    _assert_same_run(runs, [("device", 1, "ok", None, 0.0)])
    np.testing.assert_array_equal(runs["port"][0][0], rank_oracle_edge_ids(pair(name)[1]))
    names = [ev[1] for ev in runs["port"][2]]
    assert names == ["solver.rank.solve", "resilience.attempt", "resilience.solve"]
    assert runs["port"][2][0][2] == {"family": trs._pick_family(pair(name)[1]),
                                     "chunked": False}


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_retry_then_success_matches_jax(name):
    runs = _both(name, arm=[("resilience.attempt.device", 1, "raise", 0.0)])
    _assert_same_run(runs, [("device", 1, "transient", "resilience.attempt.device", 0.5),
                            ("device", 2, "ok", None, 0.0)])
    assert runs["port"][3] == [0.5]


@pytest.mark.parametrize("name", ["rmat", "road"])
def test_degrade_to_stepped_matches_jax(name):
    runs = _both(name, arm=[("resilience.attempt.device", 2, "raise", 0.0)])
    _assert_same_run(runs, [("device", 1, "transient", "resilience.attempt.device", 0.5),
                            ("device", 2, "transient", "resilience.attempt.device", 0.0),
                            ("stepped", 1, "ok", None, 0.0)])
    events = runs["port"][2]
    assert ("I", "resilience.degrade", {"from_rung": "device", "to_rung": "stepped"}) in events
    levels = [ev[2]["level"] for ev in events if ev[1] == "solver.level"]
    assert levels == list(range(1, runs["port"][0][2] + 1))


@pytest.mark.parametrize("name", ["rmat", "forest"])
def test_degrade_to_host_matches_jax(name, jax_native):
    runs = _both(name, arm=[("resilience.attempt.device", 2, "raise", 0.0),
                            ("resilience.attempt.stepped", 2, "raise", 0.0)])
    _assert_same_run(runs, [("device", 1, "transient", "resilience.attempt.device", 0.5),
                            ("device", 2, "transient", "resilience.attempt.device", 0.0),
                            ("stepped", 1, "transient", "resilience.attempt.stepped", 0.5),
                            ("stepped", 2, "transient", "resilience.attempt.stepped", 0.0),
                            ("host", 1, "ok", None, 0.0)])
    assert runs["port"][0][2] == 0  # no Borůvka level ran


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_watchdog_timeout_with_the_virtual_clock_matches_jax(name):
    """A slow chunk past the deadline times the device rung out at its
    first chunk boundary, twice; the stepped rung, guarded too, answers.
    The guard selects the chunked form of the rank route in both."""
    config = tres.SupervisorConfig(deadline_s=60, backoff_base_s=0)
    runs = _both(name, config, arm=[("resilience.slow.device", 2, "slow", 3600.0)])
    _assert_same_run(runs, [("device", 1, "timeout", "resilience.slow.device", 0.0),
                            ("device", 2, "timeout", "resilience.slow.device", 0.0),
                            ("stepped", 1, "ok", None, 0.0)])
    events = runs["port"][2]
    chunked = [ev[2] for ev in events if ev[1] == "solver.rank.solve"]
    assert chunked and all(args["chunked"] for args in chunked)
    assert [ev[1] for ev in events].count("solver.chunk") == 2  # one boundary each
    errors = [ev[2]["error"] for ev in events if ev[1] == "resilience.attempt"]
    assert "3600.0s elapsed exceeds the 60s deadline" in errors[0]


def test_slow_site_is_consumed_without_a_deadline():
    """An armed slow site guards the rung (and is used up there) even with
    no deadline, and the solve succeeds."""
    runs = _both("rmat", arm=[("resilience.slow.device", 1, "slow", 5.0)])
    _assert_same_run(runs, [("device", 1, "ok", None, 0.0)])
    assert not tres.FAULTS.armed("resilience.slow.device")


def test_fatal_error_matches_jax(monkeypatch):
    def boom(graph, tick, *device):
        raise ValueError("malformed input")

    monkeypatch.setitem(jres._RUNGS, "device", boom)
    monkeypatch.setitem(tres._RUNGS, "device", boom)
    runs = _both("rmat")
    for side in ("jax", "port"):
        assert isinstance(runs[side][0], ValueError)
    assert runs["port"][2] == runs["jax"][2]
    fatal = [ev[2] for ev in runs["port"][2] if ev[1] == "resilience.attempt"]
    assert [(a["rung"], a["outcome"], a["site"]) for a in fatal] == [
        ("device", "fatal", "resilience.attempt.device")]


def test_exhaustion_matches_jax():
    arm = [(f"resilience.attempt.{rung}", 2, "raise", 0.0) for rung in ("device", "stepped", "host")]
    runs = _both("grid", arm=arm)
    for side in ("jax", "port"):
        assert isinstance(runs[side][0], (jres.SupervisorExhausted, tres.SupervisorExhausted))
    assert incident_trail(runs["port"][1]) == incident_trail(runs["jax"][1])
    assert [r.outcome for r in runs["port"][1].records] == ["transient"] * 6
    assert runs["port"][2] == runs["jax"][2]
    assert runs["port"][3] == runs["jax"][3] == [0.5, 0.5, 0.5]


def test_env_armed_fault_matches_jax(monkeypatch):
    monkeypatch.setenv("GHS_FAULT_RESILIENCE_ATTEMPT_DEVICE", "1")
    runs = _both("road", env=True)
    _assert_same_run(runs, [("device", 1, "transient", "resilience.attempt.device", 0.5),
                            ("device", 2, "ok", None, 0.0)])


def test_protocol_entry_starts_at_device_in_both():
    runs = _both("rmat", entry="protocol")
    _assert_same_run(runs, [("device", 1, "ok", None, 0.0)])


def test_sharded_rung_is_unavailable_in_the_port():
    """The sharded rung runs in both packages now (JAX on its 8-device CPU
    mesh, the port on its CPU mesh): the same trail, forest, fragments,
    levels and events, where the port used to record the rung
    ``unavailable``."""
    for name in ("rmat", "forest"):
        runs = _both(name, entry="sharded")
        _assert_same_run(runs, [("sharded", 1, "ok", None, 0.0)])
        np.testing.assert_array_equal(runs["port"][0][0], rank_oracle_edge_ids(pair(name)[1]))


def test_sharded_rung_degrades_like_jax():
    runs = _both("road", entry="sharded",
                 arm=[("resilience.attempt.sharded", 2, "raise", 0.0)])
    _assert_same_run(runs, [("sharded", 1, "transient", "resilience.attempt.sharded", 0.5),
                            ("sharded", 2, "transient", "resilience.attempt.sharded", 0.0),
                            ("device", 1, "ok", None, 0.0)])


def test_ladder_and_config_match_jax():
    assert tres.LADDER == jres.LADDER
    assert tres.SupervisorConfig() == tres.SupervisorConfig(**vars(jres.SupervisorConfig()))
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="unknown ladder rungs"):
            mod.Supervisor(mod.SupervisorConfig(ladder=("device", "gpu")))


def test_backoff_doubles_and_caps_as_in_jax():
    config = tres.SupervisorConfig(retries_per_rung=4, backoff_base_s=1.0, backoff_cap_s=3.0)
    runs = _both("rmat", config, arm=[("resilience.attempt.device", 4, "raise", 0.0)])
    assert runs["port"][3] == runs["jax"][3] == [1.0, 2.0, 3.0, 3.0]
    assert incident_trail(runs["port"][1]) == incident_trail(runs["jax"][1])


@pytest.mark.parametrize("mod", [tres, jres], ids=["port", "jax"])
def test_empty_graph_needs_no_attempt(mod):
    g = (tapi if mod is tres else japi).Graph.from_edges(4, [])
    kw = {"device": CPU} if mod is tres else {}
    ids, frag, levels, log = mod.Supervisor().solve(g, **kw)
    assert ids.size == 0 and frag.tolist() == [0, 1, 2, 3] and levels == 0 and len(log) == 0


@pytest.mark.parametrize("mod", [tres, jres], ids=["port", "jax"])
def test_fault_registry_semantics_match(mod, monkeypatch):
    reg = mod.FaultRegistry()
    reg.arm("a.site", times=2, kind="slow", value=3.5)
    assert reg.armed("a.site") and reg.pop("a.site").value == 3.5
    assert reg.pop("a.site") is not None and reg.pop("a.site") is None
    with reg.inject("tmp.site", times=9):
        with pytest.raises(mod.InjectedFault, match="tmp.site"):
            reg.fire("tmp.site")
    assert not reg.armed("tmp.site")
    with pytest.raises(ValueError, match="kind"):
        reg.arm("x", kind="explode")
    with pytest.raises(ValueError, match="'_'"):
        reg.arm("a_b")
    monkeypatch.setenv("GHS_FAULT_CHECKPOINT_SAVE", "2:torn")
    monkeypatch.setenv("GHS_FAULT_RESILIENCE_SLOW_STEPPED", "1:slow:3600")
    env = mod.FaultRegistry()
    assert env.pop("checkpoint.save").kind == "torn"
    assert env.pop("resilience.slow.stepped").value == 3600.0
    monkeypatch.setenv("GHS_FAULT_CHECKPOINT_SAVE", "two")
    with pytest.raises(ValueError, match="times"):
        mod.FaultRegistry().reload_env()


# ---------------------------------------------------------------------------
# What is transient: the port's own classification
# ---------------------------------------------------------------------------


def _accelerator_error():
    cls = getattr(torch, "AcceleratorError", None)
    return [cls("CUDA error: an illegal memory access was encountered")] if cls else []


@pytest.mark.parametrize("exc,transient", [
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (tres.InjectedFault("x"), True),
    (tres.TransientDeviceError("x"), True),
    (tres.WatchdogTimeout("x"), True),
    (TimeoutError("x"), True),
    (ConnectionError("x"), True),
    (OSError("x"), True),
    (RuntimeError(LAUNCH_ERROR), False),
    (RuntimeError("nvcc failed:\n--- hook_compress.cu\nerror"), False),
    (RuntimeError("g++ failed to build graph_native.cpp"), False),
    (_build.KernelBuildError("could not be built: [Errno 13] Permission denied"), False),
    (_build.KernelBuildError("could not be loaded: [Errno 28] No space left on device"), False),
    (NotImplementedError("Could not run 'aten::x' with arguments from the CUDA backend"), False),
    (tres.RungUnavailable("not ported yet"), False),
    (ValueError("malformed"), False),
    *[(e, False) for e in _accelerator_error()],
])
def test_is_transient(exc, transient):
    assert tres.is_transient(exc) is transient


def test_a_kernel_launch_error_is_fatal_and_never_reaches_the_host(monkeypatch):
    """A CUDA error from a kernel inside a supervised solve raises: no
    retry, no stepped rung, no host answer."""
    def failed_launch(*args, **kwargs):
        raise RuntimeError(LAUNCH_ERROR)

    monkeypatch.setattr(trs, "hook_and_compress", failed_launch)
    monkeypatch.setattr(tb, "hook_and_compress", failed_launch)
    g = pair("grid")[1]
    for entry in ("device", "stepped"):
        mark = TBUS.mark()
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            tapi.minimum_spanning_forest(g, supervised=True, backend=entry, device=CPU)
        attempts = [ev[2] for ev in event_trail(TBUS, mark, port=True)
                    if ev[1] == "resilience.attempt"]
        assert [(a["rung"], a["outcome"]) for a in attempts] == [(entry, "fatal")]


def _attempts(mark):
    return [(ev[2]["rung"], ev[2]["outcome"]) for ev in event_trail(TBUS, mark, port=True)
            if ev[1] == "resilience.attempt"]


#: Ways a library build or load fails: no compiler, and OS errors that are
#: no less fatal for being OSErrors (a build directory that cannot be
#: written, a full disk, a library the loader refuses).
BUILD_FAILURES = [
    RuntimeError("compiler not found: the library builds from its sources at first use"),
    PermissionError(13, "Permission denied", "build/kernels/0123456789abcdef"),
    OSError(28, "No space left on device"),
]


@pytest.mark.parametrize("cause", BUILD_FAILURES, ids=lambda e: type(e).__name__)
def test_a_kernel_build_failure_is_fatal(monkeypatch, cause):
    """A kernel library that cannot be built or loaded fails the supervised
    solve at its first launch: one fatal attempt, no retry, no host rung."""
    def build_library():
        raise cause

    monkeypatch.setattr(_build, "build_library", build_library)

    def launch_through_the_build(*args, **kwargs):
        _build.load_library()

    monkeypatch.setattr(trs, "hook_and_compress", launch_through_the_build)
    mark = TBUS.mark()
    with pytest.raises(_build.KernelBuildError) as info:
        tres.Supervisor().solve(pair("rmat")[1], device=CPU)
    assert info.value.__cause__ is cause
    assert _attempts(mark) == [("device", "fatal")]


@pytest.mark.parametrize("cause", BUILD_FAILURES, ids=lambda e: type(e).__name__)
def test_a_native_build_failure_is_fatal_in_every_rung(monkeypatch, cause):
    """The native host library that cannot be built or loaded raises
    :class:`KernelBuildError` in every rung that ranks the edges with it,
    the host rung: fatal, not transient and not "unavailable". The device
    rung sorts every weight on the device, integers over 2^22 values too
    (K7's 64-bit key), and never needs the library."""
    def build_library():
        raise cause

    g = pair("road")[1]
    wide = type(g)(g.num_nodes, g.u, g.v, g.w << 23)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_library", build_library)
    mark = TBUS.mark()
    with pytest.raises(_build.KernelBuildError) as info:
        tres.Supervisor().solve(g, entry="host", device=CPU)
    assert info.value.__cause__ is cause
    assert _attempts(mark) == [("host", "fatal")]
    for graph in (wide, g):
        edge_ids = tres.Supervisor().solve(graph, entry="device", device=CPU)[0]
        np.testing.assert_array_equal(edge_ids, rank_oracle_edge_ids(g))


@pytest.mark.parametrize("entry", ["device", "stepped"])
def test_a_not_implemented_operator_is_fatal_not_unavailable(monkeypatch, entry):
    """torch raises ``NotImplementedError`` for an operator with no CUDA
    kernel for a dtype. Inside the device or stepped rung that is a fault,
    not a rung that can never run: the solve raises and never reaches the
    host. Only :class:`RungUnavailable` means "unavailable"."""
    def no_kernel(*args, **kwargs):
        raise NotImplementedError(
            "Could not run 'aten::index_put_' with arguments from the 'CUDA' backend")

    monkeypatch.setattr(trs, "hook_and_compress", no_kernel)
    monkeypatch.setattr(tb, "hook_and_compress", no_kernel)
    mark = TBUS.mark()
    with pytest.raises(NotImplementedError, match="aten::index_put_") as info:
        tres.Supervisor().solve(pair("grid")[1], entry=entry, device=CPU)
    assert not isinstance(info.value, tres.RungUnavailable)
    assert _attempts(mark) == [(entry, "fatal")]


# ---------------------------------------------------------------------------
# The host backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_host_backend_matches_jax(name, jax_native):
    jg, tg = pair(name)
    got = trs.solve_graph_kruskal_host(tg)
    want = jrs.solve_graph_kruskal_host(jg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype == np.int32
    assert got[2] == want[2] == 0
    res = tapi.minimum_spanning_forest(tg, backend="host", device=CPU)
    want_api = japi.minimum_spanning_forest(jg, backend="host")
    np.testing.assert_array_equal(res.edge_ids, want_api.edge_ids)
    assert (res.backend, res.num_components) == (want_api.backend, want_api.num_components)
    np.testing.assert_array_equal(res.edge_ids, rank_oracle_edge_ids(tg))


def test_host_backend_refuses_float_weights_in_both(jax_native):
    edges = [(0, 1, 0.5), (1, 2, 1.25), (0, 2, 2.0)]
    for mod, g in ((trs, tapi.Graph.from_edges(3, edges)),
                   (jrs, japi.Graph.from_edges(3, edges))):
        with pytest.raises(NotImplementedError, match="integer weights"):
            mod.solve_graph_kruskal_host(g)
    # Under the supervisor the host rung is unavailable, in both.
    arm = [(f"resilience.attempt.{rung}", 2, "raise", 0.0) for rung in ("device", "stepped")]
    for mod, g, kw in ((tres, tapi.Graph.from_edges(3, edges), {"device": CPU}),
                       (jres, japi.Graph.from_edges(3, edges), {})):
        for site, times, _, _ in arm:
            mod.FAULTS.arm(site, times=times)
        with pytest.raises(mod.SupervisorExhausted) as info:
            mod.Supervisor(mod.SupervisorConfig(backoff_base_s=0)).solve(g, **kw)
        assert info.value.incidents.records[-1].outcome == "unavailable"


def test_host_backend_of_an_empty_graph():
    ids, frag, levels = trs.solve_graph_kruskal_host(tapi.Graph.from_edges(3, []))
    assert ids.size == 0 and frag.tolist() == [0, 1, 2] and levels == 0


def test_native_kruskal_refuses_a_corrupt_order_and_bad_endpoints():
    tg = pair("road")[1]
    order = tg._rank_order.copy()
    order[[0, -1]] = order[[-1, 0]]  # the heaviest edge first
    with pytest.raises(ValueError, match="non-decreasing permutation"):
        tnative.kruskal_msf_solve_native(tg.num_nodes, order, tg.u, tg.v, tg.w)
    with pytest.raises(ValueError, match="every endpoint"):
        tnative.kruskal_msf_solve_native(tg.num_nodes - 1, tg._rank_order, tg.u, tg.v, tg.w)
    with pytest.raises(ValueError, match="len"):
        tnative.kruskal_msf_solve_native(tg.num_nodes, tg._rank_order, tg.u, tg.v[:-1], tg.w)


# ---------------------------------------------------------------------------
# The API surface and the device rule
# ---------------------------------------------------------------------------


def test_api_supervised_labels_match_jax():
    jg, tg = pair("grid")
    got = tapi.minimum_spanning_forest(tg, supervised=True, device=CPU)
    want = japi.minimum_spanning_forest(jg, supervised=True)
    assert got.backend == want.backend == "supervised/device"
    np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
    assert (got.num_levels, got.num_components) == (want.num_levels, want.num_components)
    assert got.incidents.summary() == want.incidents.summary() == "device#1 ok"
    sup = tres.Supervisor(tres.SupervisorConfig(backoff_base_s=0))
    with tres.FAULTS.inject("resilience.attempt.device", times=2):
        degraded = tapi.minimum_spanning_forest(tg, supervisor=sup, device=CPU)
    assert degraded.backend == "supervised/stepped"
    assert degraded.incidents.final_rung == "stepped"
    np.testing.assert_array_equal(degraded.edge_ids, want.edge_ids)
    assert tapi.minimum_spanning_forest(tg, device=CPU).incidents is None


def test_supervised_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = pair("rmat")[1]
    for call in (
        lambda: tres.Supervisor().solve(g),
        lambda: tres.supervised_solve(g),
        lambda: tres.supervised_solve(tapi.Graph.from_edges(2, [])),
        lambda: tapi.minimum_spanning_forest(g, supervised=True),
        lambda: tapi.minimum_spanning_forest(g, backend="host"),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    ids, _, _, log = tres.supervised_solve(g, device=CPU)
    assert log.final_rung == "device"
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
