"""The port's event bus (``obs/``) against the JAX package's.

The port keeps its own copy of ``obs/``: its own ``BUS``, its own modules,
the same event taxonomy and the same ``GHS_OBS`` switch. The two buses are
separate objects, and each test drives each on its own. The same emitted
sequence must export to the same Chrome trace, JSONL log, snapshot, stats
text, SLO summary and pulse report; and the solver's events (``solver.*``)
of the same solve must be the same ``(name, args)`` sequence, times
removed, where ``kernel`` reads ``torch`` on the CPU (``xla`` in JAX).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_ghs_implementation_tpu import obs as jobs
from distributed_ghs_implementation_tpu.models import boruvka as jb
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.obs import events as jevents
from distributed_ghs_implementation_tpu.obs import export as jexport
from distributed_ghs_implementation_tpu.obs import pulse as jpulse
from distributed_ghs_implementation_tpu.obs import slo as jslo
from distributed_ghs_implementation_tpu.obs import tracing as jtracing
from distributed_ghs_implementation_tpu_torch import obs as tobs
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs import events as tevents
from distributed_ghs_implementation_tpu_torch.obs import export as texport
from distributed_ghs_implementation_tpu_torch.obs import pulse as tpulse
from distributed_ghs_implementation_tpu_torch.obs import slo as tslo
from distributed_ghs_implementation_tpu_torch.obs import tracing as ttracing
from torch_pairs import (  # noqa: F401 -- fixture
    CPU,
    FAMILIES,
    event_trail,
    isolated,
    lower_filter_width,
    pair,
)

pytestmark = pytest.mark.usefixtures("isolated")

SIDES = {"jax": (jevents, jexport, jslo, jpulse, jtracing),
         "port": (tevents, texport, tslo, tpulse, ttracing)}


def _populate(events_mod):
    """A bus of the package ``events_mod`` holding one fixed sequence:
    spans (nested, with class tags and trace ids), instants, counter
    samples, counters and histograms, all at fixed times."""
    bus = events_mod.EventBus(capacity=64)
    records = [
        ("X", "serve.request", "serve", 1_000, 9_000_000, 7, {"cls": "interactive", "ok": True}),
        ("X", "serve.solve", "serve", 2_000, 5_000_000, 7, {"cls": "interactive"}),
        ("X", "serve.request", "serve", 3_000, 2_000_000, 8, {"cls": "batch", "shed": True}),
        ("X", "solver.level", "solver", 4_000, 1_500, 7, {"level": 1, "edges_alive": 10}),
        ("I", "resilience.degrade", "resilience", 5_000, 0, 7,
         {"from_rung": "device", "to_rung": "stepped"}),
        ("C", "protocol.messages_sent", "counter", 6_000, 0, 7, {"value": 17}),
        ("X", "fleet.request", "fleet", 7_000, 4_000_000, 9,
         {"cls": "interactive", "worker": "w0", "trace": "t1", "span": "s1"}),
        ("X", "fleet.serve", "fleet", 7_500, 3_000_000, 9,
         {"trace": "t1", "span": "s2", "parent": "s1"}),
    ]
    for rec in records:
        bus._append(rec)
    bus.count("protocol.messages_sent", 42)
    for value in (3.0, 5.0, 11.0):
        bus.record("ack_latency", value)
    return bus


def test_the_port_has_its_own_bus_and_modules():
    assert tobs.BUS is tevents.BUS is not jevents.BUS
    for mod in (tobs, tevents, texport, tslo, tpulse, ttracing):
        assert mod.__name__.startswith("distributed_ghs_implementation_tpu_torch.obs")
    jmark, tmark = jevents.BUS.mark(), tevents.BUS.mark()
    with tevents.BUS.span("solver.solve", cat="solver", nodes=3):
        pass
    assert jevents.BUS.events_since(jmark) == []
    assert [rec[1] for rec in tevents.BUS.events_since(tmark)] == ["solver.solve"]
    public = [{name for name in dir(pkg) if not name.startswith("_")} for pkg in (tobs, jobs)]
    assert public[0] == public[1] >= {"BUS", "EventBus", "write_chrome_trace", "summarize_bus"}


def _generated_by(trace, package):
    """``trace`` without its ``otherData.generator``, which names the
    writing package's module."""
    trace = json.loads(json.dumps(trace))
    assert trace["otherData"].pop("generator").startswith(f"{package}.obs")
    return trace


def test_chrome_trace_matches_jax(tmp_path):
    got, want = (json.loads(_write(side, tmp_path, "trace.json")) for side in ("port", "jax"))
    assert (_generated_by(got, "distributed_ghs_implementation_tpu_torch")
            == _generated_by(want, "distributed_ghs_implementation_tpu"))
    assert len(got["traceEvents"]) > 8


def test_jsonl_log_matches_jax(tmp_path):
    got, want = (_write(side, tmp_path, "events.jsonl") for side in ("port", "jax"))
    got, want = ([json.loads(line) for line in text.splitlines()] for text in (got, want))
    for line in got + want:
        line.pop("epoch_unix_ns", None)  # the wall clock of the write
    assert got == want and len(got) > 8


def _write(side, tmp_path, name):
    events_mod, export_mod = SIDES[side][:2]
    path = str(tmp_path / f"{side}-{name}")
    bus = _populate(events_mod)
    if name.endswith(".json"):
        export_mod.write_chrome_trace(bus, path)
    else:
        export_mod.write_events_jsonl(bus, path)
    with open(path) as f:
        return f.read()


def test_snapshot_and_stats_match_jax(tmp_path):
    snaps = {side: _populate(SIDES[side][0]).snapshot() for side in SIDES}
    assert snaps["port"] == snaps["jax"]
    assert texport.render_stats(snaps["port"]) == jexport.render_stats(snaps["jax"])


def test_each_package_reads_the_others_jsonl(tmp_path):
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / f"{writer}.jsonl")
        SIDES[writer][1].write_events_jsonl(_populate(SIDES[writer][0]), path)
        assert (SIDES[reader][1].snapshot_from_jsonl(path)
                == SIDES[writer][1].snapshot_from_jsonl(path))
        assert (SIDES[reader][2].summarize_jsonl(path, wall_s=2.0)
                == SIDES[writer][2].summarize_jsonl(path, wall_s=2.0))


def test_merged_trace_matches_jax(tmp_path):
    paths = []
    for side in ("jax", "port"):
        path = str(tmp_path / f"{side}.jsonl")
        SIDES[side][1].write_events_jsonl(_populate(SIDES[side][0]), path)
        paths.append(path)
    (got, got_report), (want, want_report) = (texport.merge_trace_files(paths),
                                              jexport.merge_trace_files(paths))
    assert (_generated_by(got, "distributed_ghs_implementation_tpu_torch")
            == _generated_by(want, "distributed_ghs_implementation_tpu"))
    assert got_report == want_report


def test_slo_summary_matches_jax():
    got = tslo.summarize_bus(_populate(tevents), wall_s=2.0)
    want = jslo.summarize_bus(_populate(jevents), wall_s=2.0)
    assert got == want and got["classes"]
    assert tslo.gate_metrics(got, workload="w") == jslo.gate_metrics(want, workload="w")


def test_pulse_report_matches_jax(tmp_path):
    raw = _populate(tevents).histograms_export()
    stats = {"workers": {"w1": {"alive": True, "pending": 2, "stats": {
        "counters": {"serve.requests": 5}, "histograms_raw": raw}},
        "w0": {"alive": False}}, "fleet": {"fleet.requests": 5}}
    got, want = tpulse.pulse_report(stats), jpulse.pulse_report(stats)
    for report in (got, want):
        report.pop("ts_unix")
        report["router"].pop("events_dropped")  # each process-global bus's own
    assert got == want
    paths = [str(tmp_path / f"{side}.prom") for side in ("port", "jax")]
    tpulse.write_prometheus(got, paths[0])
    jpulse.write_prometheus(want, paths[1])
    assert open(paths[0]).read() == open(paths[1]).read()


@pytest.mark.parametrize("side", list(SIDES))
def test_ring_overflow_and_the_disabled_bus(side):
    events_mod = SIDES[side][0]
    bus = events_mod.EventBus(capacity=8)
    for i in range(20):
        bus.instant(f"e{i}")
    assert bus.dropped == 12 and [rec[1] for rec in bus.events()][0] == "e12"
    bus.disable()
    assert bus.span("x") is events_mod.NULL_SPAN
    mark = bus.mark()
    bus.complete("y", 1.0)
    assert bus.events_since(mark) == []


@pytest.mark.parametrize("side", list(SIDES))
def test_traced_spans_carry_their_context(side):
    events_mod, _, _, _, tracing = SIDES[side]
    bus = events_mod.EventBus(capacity=16)
    ctx = tracing.mint("interactive")
    with tracing.activated(ctx):
        with bus.span("outer"):
            bus.complete("inner", 0.001)
    inner, outer = bus.events()
    assert outer[6]["trace"] == inner[6]["trace"] == ctx.trace_id
    assert inner[6]["parent"] == outer[6]["span"]


def test_quantiles_and_histogram_merges_match_jax():
    samples = [float(x) for x in range(1000, 0, -7)]
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert tevents.quantile(samples, p) == jevents.quantile(samples, p)
    raws = [_populate(mod).histograms_export()["ack_latency"] for mod in (jevents, tevents)]
    assert tevents.merge_hists(raws).summary() == jevents.merge_hists(raws).summary()


def test_ghs_obs_zero_disables_the_ports_bus():
    code = ("import sys; sys.modules['jax'] = None\n"
            "from distributed_ghs_implementation_tpu_torch.obs import BUS\n"
            "print(BUS.enabled, BUS.capacity)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"GHS_OBS": "0", "GHS_OBS_CAPACITY": "128",
                                           "PATH": "/usr/bin:/bin"},
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "128"]


# ---------------------------------------------------------------------------
# The solver's events
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["fused", "stepped", "ell", "rank"])
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_solve_graph_events_match_jax(name, strategy):
    jg, tg = pair(name)
    jmark, tmark = jevents.BUS.mark(), tevents.BUS.mark()
    jb.solve_graph(jg, strategy=strategy)
    tb.solve_graph(tg, strategy=strategy, device=CPU)
    got = event_trail(tevents.BUS, tmark, port=True)
    assert got == event_trail(jevents.BUS, jmark, port=False)
    assert got[-1][1] == "solver.solve"
    assert got[-1][2] == {"strategy": strategy, "nodes": tg.num_nodes,
                          "edges": tg.num_edges, "kernel": "torch"}
    if strategy == "stepped":  # two stepped levels, then the fused finish
        assert [ev[1] for ev in got] == ["solver.level", "solver.level",
                                         "solver.fused_finish", "solver.solve"]
        assert got[1][2]["edges_alive"] <= got[0][2]["edges_alive"]


@pytest.mark.parametrize("hooked", [False, True])
@pytest.mark.parametrize("name", FAMILIES + ["rmat11"])
def test_production_solver_events_match_jax(monkeypatch, name, hooked):
    if name == "rmat11":
        lower_filter_width(monkeypatch)
    jg, tg = pair(name)
    hook = (lambda *a: None) if hooked else None
    jmark, tmark = jevents.BUS.mark(), tevents.BUS.mark()
    jrs.make_production_solver(jg)(on_chunk=hook)
    trs.make_production_solver(tg, device=CPU)(on_chunk=hook)
    got = event_trail(tevents.BUS, tmark, port=True)
    assert got == event_trail(jevents.BUS, jmark, port=False)
    assert got[-1] == ("X", "solver.rank.solve", {"family": trs._pick_family(tg),
                                                  "chunked": hooked})
    chunks = [ev for ev in got if ev[1] == "solver.chunk"]
    assert bool(chunks) == hooked
    assert all(set(ev[2]) == {"level", "edges_alive"} for ev in chunks)


@pytest.mark.parametrize("name", ["rmat", "rmat11"])
def test_observing_never_reroutes_a_solve(monkeypatch, name):
    """Without a hook the route is the same with the bus on or off, and
    with the bus off the hook still sees every boundary."""
    if name == "rmat11":
        lower_filter_width(monkeypatch)
    tg = pair(name)[1]
    calls = []
    for step in ("solve_rank_speculative", "solve_rank_filtered_speculative",
                 "solve_rank_staged", "solve_rank_filtered"):
        fn = getattr(trs, step)
        monkeypatch.setattr(trs, step, lambda *a, _fn=fn, _s=step, **k: calls.append(_s)
                            or _fn(*a, **k))
    routes, boundaries = [], []
    for enabled in (True, False):
        monkeypatch.setattr(tevents.BUS, "enabled", enabled)
        mark = tevents.BUS.mark()
        calls.clear()
        trs.make_production_solver(tg, device=CPU)()
        routes.append(list(calls))
        seen = []
        trs.make_production_solver(tg, device=CPU)(
            on_chunk=lambda level, f, m, count: seen.append((int(level), int(count))))
        boundaries.append(seen)
        if not enabled:
            assert tevents.BUS.events_since(mark) == []
    assert routes[0] == routes[1] and routes[0][0].endswith("speculative")
    assert boundaries[0] == boundaries[1] and boundaries[0]
