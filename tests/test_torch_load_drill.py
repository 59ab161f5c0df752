"""The port's open-loop load drill (``distributed_ghs_implementation_tpu_torch/
load_drill.py``) against the JAX package's (``tools/load_drill.py``), on the
CPU.

* The deck: the arrival models, ``build_deck`` (JSON and binary wire) and
  ``build_stream_deck`` (plain and sharded seed shapes) at seed 23 equal
  JAX's arrival for arrival: times, classes, requests, updates, and the
  warm and stream-seed graphs' ``u``/``v``/``w`` arrays.
* The window's accounting: ``_window_counter_delta`` on the worker-restart
  case of ``tests/test_slo.py`` and ``client_summary`` on one set of
  records equal JAX's.
* End to end: both drills run as processes of their own with the same argv
  (``--duration 3``), JAX and port side by side; the corrupt drill runs one
  after the other, since its audit leg times warm hits. Each report's
  ``ok`` must be true, and equal: ``config`` less the port's ``package``
  and ``device``, ``chaos``, the checks' names and verdicts, the gate
  metrics' names (and, for the kinds and corrupt drills, which count and
  time nothing else, every integer metric), and the order-free serve
  counters. Per class: the bus join's ``sent``/``ok``/``errors`` in the
  service mode; in the router-kill mode the client's (one record an
  arrival) and the bus join's ``ok``, since which requests land in the
  outage and are retried, and so the spans' ``sent`` and ``errors``, is
  timing. The port runs with ``jax`` made unimportable and must load no
  module of the JAX package.
* The deliberate differences: ``--device`` (without CUDA and without
  ``--device cpu``, a non-zero exit before anything is built; the device
  reaches every service and the fleet's workers), ``package`` and
  ``device`` in both configs, SciPy oracles equal to JAX's NetworkX ones,
  baselines with no default path, and bare ``--sharded-lane`` as one shard
  a card.
"""

import json
import os
import subprocess
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu_torch import load_drill as tdrill
from torch_pairs import isolated  # noqa: F401 -- fixture

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import load_drill as jdrill  # noqa: E402

pytestmark = pytest.mark.usefixtures("isolated")

#: Runs the port's drill as ``python -m`` would, with ``jax`` unimportable;
#: the JAX package's modules it loaded go to stderr's last line.
PORT_RUNNER = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.argv = ['load_drill'] + sys.argv[1:]\n"
    "code = 0\n"
    "try:\n"
    "    runpy.run_module('distributed_ghs_implementation_tpu_torch.load_drill',"
    " run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    code = e.code\n"
    "print(sorted(m for m in sys.modules\n"
    "             if m.startswith('distributed_ghs_implementation_tpu.')), file=sys.stderr)\n"
    "sys.exit(code)\n"
)

#: The order-free serve counters (each counts requests, not the order in
#: which the threads ran them).
SERVE_COUNTERS = ("serve.requests", "serve.route.bypass", "serve.store.hit")
SERVE_PREFIXES = ("serve.kind.", "serve.dynamic.")

END_TO_END = {
    "service-chaos": ["--smoke", "--chaos"],
    "kinds": ["--kinds-mixed"],
    "corrupt": ["--corrupt-store", "2"],
    "router-kill": ["--smoke", "--no-chaos", "--fleet", "3", "--kill-router",
                    "--transport", "tcp", "--test-echo"],
}


def deck_args(**overrides):
    """The flags the deck builders read, at ``main``'s defaults (``--smoke``
    changes none of them)."""
    args = dict(duration=10.0, rate=10.0, seed=23, arrival="poisson", oversize=2,
                oversize_heavy=False, sharded_lane=0, streams=3)
    args.update(overrides)
    return types.SimpleNamespace(**args)


def _request_fields(req):
    """A request with its binary sections as ``(name, array)`` pairs."""
    if req is None:
        return None
    out = {k: v for k, v in req.items() if k != "_sections"}
    if "_sections" in req:
        sections = req["_sections"]
        out["_sections"] = [(name, sections.array(name).tolist()) for name in sections.names]
    return out


def _same_graphs(jgraphs, tgraphs):
    assert len(jgraphs) == len(tgraphs)
    for jg, tg in zip(jgraphs, tgraphs):
        assert jg.num_nodes == tg.num_nodes
        for name in ("u", "v", "w"):
            np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))


def _same_deck(jdeck, tdeck):
    (jsched, jwarm, jseeds, jcounts), (tsched, twarm, tseeds, tcounts) = jdeck, tdeck
    assert tcounts == jcounts
    assert len(tsched) == len(jsched)
    for ja, ta in zip(jsched, tsched):
        assert (ta.at_s, ta.cls, ta.stream, ta.updates) == (ja.at_s, ja.cls, ja.stream, ja.updates)
        assert _request_fields(ta.request) == _request_fields(ja.request)
    _same_graphs(jwarm, twarm)
    _same_graphs(jseeds, tseeds)


# ----------------------------------------------------------------------
# (a) The deck
# ----------------------------------------------------------------------
def test_names_and_shapes_match_jax():
    for name in ("REPORT_SCHEMA", "WORKLOAD", "WORKLOAD_FLEET", "WORKLOAD_FLEET_KILL",
                 "WORKLOAD_FLEET_ELASTIC", "WORKLOAD_FLEET_ELASTIC_KILL",
                 "WORKLOAD_FLEET_ROUTER", "WORKLOAD_FLEET_PARTITION", "WORKLOAD_OVERSIZE",
                 "WORKLOAD_VERIFY", "WORKLOAD_KINDS", "WORKLOAD_STREAM",
                 "WORKLOAD_STREAM_FLEET", "WORKLOAD_STREAM_KILL", "WORKLOAD_STREAM_SHARDED",
                 "WORKLOAD_STREAM_SHARDED_KILL", "MISS_SHAPES", "BATCH_SHAPE", "HIT_SHAPE",
                 "UPDATE_SHAPE", "OVERSIZE_SHAPE", "STREAM_SHAPE", "STREAM_SHARDED_SHAPE",
                 "STREAM_WINDOW_UPDATES", "ANALYTICS_KINDS", "ANALYTICS_K"):
        assert getattr(tdrill, name) == getattr(jdrill, name), name
    assert tdrill.REPORT_SCHEMA == "ghs-load-report-v1"


@pytest.mark.parametrize("model", ["poisson", "bursty", "ramp"])
def test_arrival_times_match_jax(model):
    t = tdrill.arrival_times(50, 4.0, model, np.random.default_rng(7))
    j = jdrill.arrival_times(50, 4.0, model, np.random.default_rng(7))
    np.testing.assert_array_equal(t, j)
    assert len(t) == 50 and float(t.min()) >= 0.0 and float(t.max()) <= 4.0 + 1e-9


def test_arrival_times_edge_cases():
    assert len(tdrill.arrival_times(0, 4.0, "poisson", np.random.default_rng(7))) == 0
    with pytest.raises(ValueError, match="arrival"):
        tdrill.arrival_times(5, 4.0, "square-wave", np.random.default_rng(7))


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_build_deck_matches_jax(monkeypatch, wire):
    monkeypatch.setattr(jdrill, "_WIRE_BINARY", wire == "binary")
    monkeypatch.setattr(tdrill, "_WIRE_BINARY", wire == "binary")
    args = deck_args()
    jdeck = jdrill.build_deck(args, np.random.default_rng(args.seed))
    tdeck = tdrill.build_deck(args, np.random.default_rng(args.seed))
    _same_deck(jdeck, tdeck)
    assert {a.cls for a in tdeck[0]} == {"hit", "miss", "batch", "dup", "update", "oversize"}


@pytest.mark.parametrize("sharded", [False, True])
def test_build_stream_deck_matches_jax(sharded):
    args = deck_args(sharded_lane=-1 if sharded else 0)
    jdeck = jdrill.build_stream_deck(args, np.random.default_rng(args.seed))
    tdeck = tdrill.build_stream_deck(args, np.random.default_rng(args.seed))
    _same_deck(jdeck, tdeck)
    assert tdrill._stream_seed_shape(args) == jdrill._stream_seed_shape(args)


# ----------------------------------------------------------------------
# (b) The window's accounting
# ----------------------------------------------------------------------
def test_window_counter_delta_survives_worker_restart():
    pre = {("0", 1): {"serve.scheduler.fresh_solve": 5, "serve.hits": 2}}
    post = {("0", 2): {"serve.scheduler.fresh_solve": 3}, ("1", 1): {"serve.hits": 7}}
    delta = tdrill._window_counter_delta(pre, post)
    assert delta == jdrill._window_counter_delta(pre, post)
    assert delta["serve.scheduler.fresh_solve"] == 3 and delta["serve.hits"] == 7
    same = {("1", 1): {"serve.hits": 4}}
    assert tdrill._window_counter_delta(same, post)["serve.hits"] == 3


def test_client_summary_matches_jax():
    rng = np.random.default_rng(5)
    records = [{"cls": cls, "ok": bool(i % 7), "latency_s": float(rng.uniform(0.001, 0.5))}
               for i, cls in enumerate(["hit", "miss", "batch", "dup", "update"] * 9)]
    assert tdrill.client_summary(records, 3.0) == jdrill.client_summary(records, 3.0)


# ----------------------------------------------------------------------
# (c) End to end against the JAX drill
# ----------------------------------------------------------------------
def _run_jax(argv, out):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(ROOT / "tools" / "load_drill.py"), *argv,
                           "--output", str(out)], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)


def _run_port(argv, out):
    return subprocess.run([sys.executable, "-c", PORT_RUNNER, *argv, "--device", "cpu",
                           "--output", str(out)], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=300)


def _classes(section, keys):
    return {cls: tuple(c[k] for k in keys) for cls, c in section["classes"].items()}


def _serve_counters(report):
    return {k: v for k, v in report.get("serve_counters", {}).items()
            if k in SERVE_COUNTERS or k.startswith(SERVE_PREFIXES)}


def _without_port_fields(config):
    return {k: v for k, v in config.items() if k not in ("package", "device")}


@pytest.mark.parametrize("mode", list(END_TO_END))
def test_drill_matches_jax(mode, tmp_path):
    argv = END_TO_END[mode] + ["--duration", "3"]
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    if mode == "corrupt":
        jproc, tproc = _run_jax(argv, jout), _run_port(argv, tout)
    else:
        with ThreadPoolExecutor(2) as pool:
            jfut, tfut = pool.submit(_run_jax, argv, jout), pool.submit(_run_port, argv, tout)
            jproc, tproc = jfut.result(), tfut.result()
    assert jproc.returncode == 0, jproc.stdout[-2000:] + jproc.stderr[-3000:]
    assert tproc.returncode == 0, tproc.stdout[-2000:] + tproc.stderr[-3000:]
    assert tproc.stderr.strip().splitlines()[-1] == "[]"
    assert tproc.stdout.strip().splitlines()[-1] == "load drill: PASS"
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert j["ok"] is True and t["ok"] is True
    assert t["schema"] == j["schema"] == "ghs-load-report-v1"
    for cfg_t, cfg_j in ((t["config"], j["config"]),
                         (t["gate_metrics"]["config"], j["gate_metrics"]["config"])):
        assert _without_port_fields(cfg_t) == cfg_j
        assert cfg_t["package"] == "torch" and cfg_t["device"] == "cpu"
    assert t["chaos"] == j["chaos"]
    assert [(c["name"], c["ok"]) for c in t["checks"]] == [
        (c["name"], c["ok"]) for c in j["checks"]]
    assert t["gate_metrics"]["schema"] == j["gate_metrics"]["schema"] == "ghs-bench-metrics-v1"
    assert set(t["gate_metrics"]["metrics"]) == set(j["gate_metrics"]["metrics"])
    assert _serve_counters(t) == _serve_counters(j)
    if mode == "service-chaos":
        assert _classes(t["slo"], ("sent", "ok", "errors")) == _classes(
            j["slo"], ("sent", "ok", "errors"))
        assert t["chaos"]["lost_accepted"] == 0 and len(t["chaos"]["armed"]) == 2
        assert t["serve_counters"]["serve.requests"] == t["slo"]["totals"]["sent"]
    elif mode == "router-kill":
        assert _classes(t["client"], ("sent", "ok", "errors")) == _classes(
            j["client"], ("sent", "ok", "errors"))
        assert _classes(t["slo"], ("ok",)) == _classes(j["slo"], ("ok",))
        for key in ("lost_accepted", "journal_unanswered", "router_crashes",
                    "workers_readopted", "fresh_solves"):
            assert t["gate_metrics"]["metrics"][key] == j["gate_metrics"]["metrics"][key], key
        assert t["gate_metrics"]["metrics"]["workers_readopted"] == 3
    else:
        jm, tm = j["gate_metrics"]["metrics"], t["gate_metrics"]["metrics"]
        for key, value in jm.items():
            if isinstance(value, int):
                assert tm[key] == value, key
        assert tm["wrong_results"] == 0


def _live_children() -> set:
    """The pids of this process's children that have not exited."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids.update(f.read().split())
    alive = set()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    alive.add(pid)
        except FileNotFoundError:
            pass
    return alive


def _overhead_leg_start(drill, service_module, argv, out, monkeypatch) -> dict:
    """Run ``drill.main(argv)`` in this process. When its overhead leg
    builds the service it times with verification off (the first service
    built with neither a store nor a policy), record the threads the drill
    started that are still alive, by name, and its child processes that
    have not exited."""
    threads, children = set(threading.enumerate()), _live_children()
    seen = {}
    real = service_module.MSTService

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            if not seen and "disk_dir" not in kwargs and "verify" not in kwargs:
                seen["threads"] = sorted(t.name for t in threading.enumerate()
                                         if t not in threads)
                seen["children"] = sorted(_live_children() - children)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(service_module, "MSTService", Recorded)
    drill.main(argv + ["--output", str(out)])
    monkeypatch.setattr(service_module, "MSTService", real)
    return seen


def test_corrupt_overhead_leg_starts_with_what_jax_leaves_running(tmp_path, monkeypatch):
    """The corrupt drill's audit check times two services' warm hits; what
    the earlier legs leave running competes with them. At the leg's start
    the port's drill has the threads JAX's has (the fleet leg's listener,
    blocked in ``accept``) and no child process, and it has not changed
    torch's CPU thread count. Either drill's timing check may pass or fail
    here: only the state is held."""
    from distributed_ghs_implementation_tpu.serve import service as jservice
    from distributed_ghs_implementation_tpu_torch.serve import service as tservice

    argv = ["--corrupt-store", "2", "--duration", "3"]
    torch_threads = torch.get_num_threads()
    want = _overhead_leg_start(jdrill, jservice, argv, tmp_path / "jax.json", monkeypatch)
    got = _overhead_leg_start(tdrill, tservice, argv + ["--device", "cpu"],
                              tmp_path / "port.json", monkeypatch)
    assert want["threads"] == ["fleet-listener"] and want["children"] == []
    assert got == want
    assert torch.get_num_threads() == torch_threads


# ----------------------------------------------------------------------
# (d) The device rule, and where the device goes
# ----------------------------------------------------------------------
class _Built(Exception):
    """Raised by a stand-in the moment the drill builds a service or fleet."""


def _recorder(seen):
    def build(*args, **kwargs):
        seen.append((args, kwargs))
        raise _Built()
    return build


DEVICE_MODES = {
    "service": ["--smoke"],
    "kinds": ["--kinds-mixed"],
    "corrupt": ["--corrupt-store", "1"],
    "fleet": ["--smoke", "--fleet", "2", "--transport", "tcp", "--test-echo"],
}


@pytest.fixture
def stand_ins(monkeypatch):
    """Stand-ins for the service and the fleet router that record how they
    were built, then stop the drill."""
    from distributed_ghs_implementation_tpu_torch.fleet import router
    from distributed_ghs_implementation_tpu_torch.serve import service

    seen = []
    monkeypatch.setattr(service, "MSTService", _recorder(seen))
    monkeypatch.setattr(router, "FleetRouter", _recorder(seen))
    return seen


@pytest.mark.parametrize("mode", list(DEVICE_MODES))
def test_without_cuda_exits_before_any_solve(mode, monkeypatch, stand_ins, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as exc:
        tdrill.main(DEVICE_MODES[mode] + ["--output", str(out)])
    assert exc.value.code not in (0, None)
    assert "CUDA is not available" in str(exc.value.code)
    assert stand_ins == [] and not out.exists()


@pytest.mark.parametrize("mode", list(DEVICE_MODES))
def test_device_reaches_the_service_and_workers(mode, stand_ins, tmp_path):
    with pytest.raises(_Built):
        tdrill.main(DEVICE_MODES[mode] + ["--device", "cpu", "--output", str(tmp_path / "r")])
    (args, kwargs), = stand_ins
    if mode == "fleet":
        config, = args
        assert config.device == "cpu" and config.test_echo
        assert config.compile_cache_dir == str(ROOT / "build")
    else:
        assert kwargs["device"] == "cpu"


def test_bare_sharded_lane_is_one_shard_a_card(stand_ins):
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    with pytest.raises(_Built):
        tdrill.main(["--smoke", "--oversize-heavy", "--sharded-lane", "--device", "cpu"])
    (_, kwargs), = stand_ins
    # True asks MSTService for edge_mesh(device=): one shard a card (one on
    # the CPU); JAX counts jax.device_count().
    assert kwargs["sharded_lane"] is True
    assert edge_mesh(device="cpu").size == 1


def test_package_fields():
    assert tdrill._package_fields("cpu") == {"package": "torch", "device": "cpu"}


# ----------------------------------------------------------------------
# The other deliberate differences
# ----------------------------------------------------------------------
def test_kind_oracles_equal_jax():
    """SciPy ground truth where JAX's is NetworkX's, on the kinds drill's
    connected and two-block graphs."""
    from distributed_ghs_implementation_tpu.graphs.generators import gnm_random_graph as jgnm
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph as tgnm,
    )

    pairs = [(jgnm(90, 260, seed=923), tgnm(90, 260, seed=923)),
             (jdrill._two_block_graph(973), tdrill._two_block_graph(973))]
    for jg, tg in pairs:
        assert tdrill._kind_oracles(tg) == jdrill._kind_oracles(jg)


def test_baselines_take_a_path(tmp_path, capsys):
    for flag in ("--gate-baseline", "--update-baseline"):
        with pytest.raises(SystemExit) as exc:
            tdrill.main(["--smoke", flag])
        assert exc.value.code == 2
    capsys.readouterr()
    report = {"gate_metrics": {"schema": "ghs-bench-metrics-v1",
                               "config": {"workload": tdrill.WORKLOAD},
                               "metrics": {"lost_accepted": 0, "answered": 107}}}
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(report["gate_metrics"]))
    ok, lines = tdrill.run_gate(report, str(path), 0.5)
    assert ok and lines
    report["gate_metrics"]["metrics"]["lost_accepted"] = 1
    ok, _ = tdrill.run_gate(report, str(path), 0.5)
    assert not ok


# ----------------------------------------------------------------------
# (e) No JAX
# ----------------------------------------------------------------------
def test_imports_without_jax():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import distributed_ghs_implementation_tpu_torch.load_drill as d\n"
        "assert d.REPORT_SCHEMA == 'ghs-load-report-v1'\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('distributed_ghs_implementation_tpu.')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
