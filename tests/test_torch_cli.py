"""The port's command line against the JAX package's, on the CPU.

Each subcommand runs in both packages on the same flags; the JAX side under
``JAX_PLATFORMS=cpu`` (8 virtual devices, ``tests/conftest.py``), the port
side with ``--device cpu``. Every comparison is exact; what is left out is
named where it is left out: wall times (``execution_time``, ``solve_s``,
``wall_time_s``), the ``backend`` label where the two name a rung
differently, and the kernel counters (``compile.kernel.*``). Where the port
differs on purpose it is pinned here: ``serve`` and ``bench`` have no
``--kernel``, ``verify`` prints the SciPy rank oracle's forest, every
solving subcommand takes ``--device`` and refuses to solve on the CPU
unless asked.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import cli as jcli
from distributed_ghs_implementation_tpu.graphs import io as jio
from distributed_ghs_implementation_tpu.utils import viz as jviz
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch import cli as tcli
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.graphs import io as tio
from distributed_ghs_implementation_tpu_torch.obs.export import snapshot_from_jsonl as tsnap
from distributed_ghs_implementation_tpu_torch.utils import viz as tviz
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_pairs import isolated  # noqa: F401 -- fixture

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]

#: (jax option, port option) pairs of each subcommand that differ on
#: purpose: the port's serve has no --kernel, and --device is the port's.
JAX_ONLY = {"serve": {"--kernel"}}

pytestmark = pytest.mark.usefixtures("isolated")


def _run(main, argv):
    """``main(argv)`` with its standard output captured: ``(rc, stdout)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture
def graph_dir(tmp_path):
    """A reference-format partition dir of 14 vertices, written by the JAX
    CLI (both read it)."""
    d = str(tmp_path / "g")
    assert jcli.main(["generate", "--nodes", "14", "--edge-prob", "0.4", "--seed", "8",
                      "--output-dir", d]) == 0
    return d


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------
GENERATE = {
    "reference": ["--nodes", "9", "--edge-prob", "0.5", "--seed", "3"],
    "er": ["--nodes", "40", "--edge-prob", "0.2", "--seed", "4"],
    "gnm": ["--nodes", "128", "--edges", "512", "--seed", "1"],
    "rmat": ["--rmat-scale", "10", "--rmat-edge-factor", "8", "--seed", "2"],
    "simple-test": [],
}


@pytest.mark.parametrize("npz", [False, True], ids=["dir", "npz"])
@pytest.mark.parametrize("kind", sorted(GENERATE))
def test_generate_writes_what_jax_writes(tmp_path, kind, npz):
    """Partition dirs byte-identical; ``.npz`` files with equal arrays."""
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    argv = ["generate", "--kind", kind, *GENERATE[kind]] + (["--npz"] if npz else [])
    for side, main in (("jax", jcli.main), ("port", tcli.main)):
        assert _run(main, argv + ["--output-dir", str(dirs[side])])[0] == 0
    if not npz:
        assert _files(dirs["port"]) == _files(dirs["jax"])
        return
    with np.load(dirs["jax"] / "graph.npz") as j, np.load(dirs["port"] / "graph.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key])
            assert t[key].dtype == j[key].dtype
    assert tio.read_npz(str(dirs["port"] / "graph.npz")).digest() == jio.read_npz(
        str(dirs["jax"] / "graph.npz")).digest()


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------
RUNS = {
    "device": ["--backend", "device"],
    "sharded": ["--backend", "sharded"],
    "protocol": ["--backend", "protocol"],
    "supervised": ["--backend", "device", "--supervised"],
    "checkpoint": ["--backend", "device", "--checkpoint", "CKPT"],
}


def _result(path, drop=("execution_time", "backend", "incidents", "incident_summary")):
    with open(path) as f:
        res = json.load(f)
    return {k: v for k, v in res.items() if k not in drop}, res


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_result_equals_jax(tmp_path, graph_dir, case):
    """The result JSON equals JAX's in every key but ``execution_time`` and
    the ``backend`` label (and a supervised run's incident trail, whose
    records carry times); ``--verify`` passes in both."""
    results = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        out = str(tmp_path / f"{side}.json")
        argv = ["run", "--graph-dir", graph_dir, "--output", out, "--verify"]
        argv += [str(tmp_path / f"{side}.ckpt") if a == "CKPT" else a for a in RUNS[case]]
        rc, stdout = _run(main, argv + extra)
        assert rc == 0
        results[side] = _result(out)
        assert json.loads(stdout) == results[side][1]  # printed as written
    assert results["port"][0] == results["jax"][0]
    labels = {side: r[1]["backend"] for side, r in results.items()}
    assert labels["port"] == labels["jax"]
    if case == "supervised":
        assert [i["rung"] for i in results["port"][1]["incidents"]] == [
            i["rung"] for i in results["jax"][1]["incidents"]]


def test_metrics_out_equals_jax(tmp_path, graph_dir):
    """``run --metrics-out``: the ``ghs-bench-metrics-v1`` schema, the same
    values but the solve time."""
    metrics = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        path = tmp_path / f"{side}.metrics.json"
        assert _run(main, ["run", "--graph-dir", graph_dir, "--metrics-out", str(path)]
                    + extra)[0] == 0
        metrics[side] = json.loads(path.read_text())
        assert path.read_text().endswith("}\n")
    for m in metrics.values():
        assert m["schema"] == "ghs-bench-metrics-v1"
        assert isinstance(m["metrics"].pop("solve_s"), float)
    assert metrics["port"] == metrics["jax"]


def test_verify_prints_the_rank_oracles_forest(tmp_path, graph_dir, capsys):
    """``verify`` prints the SciPy rank oracle's weight and forest (JAX:
    NetworkX's); on distinct weights the two are the same text, and a
    result file is checked against it in both."""
    res = str(tmp_path / "res.json")
    assert tcli.main(["run", "--graph-dir", graph_dir, "--output", res] + CPU) == 0
    capsys.readouterr()
    argv = ["verify", "--graph-dir", graph_dir, "--result", res]
    (jrc, jout), (trc, tout) = _run(jcli.main, argv), _run(tcli.main, argv)
    assert jrc == trc == 0
    g = tio.read_partition_dir(graph_dir)
    ids = rank_oracle_edge_ids(g)
    lines = tout.splitlines()
    assert lines[0] == f"expected MST weight: {int(g.w[ids].sum())}"
    assert lines[1:-1] == [f"  ({a}, {b})" for a, b in sorted(zip(g.u[ids], g.v[ids]))]
    assert lines[-1].endswith(": OK")
    if len(set(g.w.tolist())) == g.num_edges:
        assert tout == jout
    # A result whose weight is off is a mismatch, exit 1, in both.
    with open(res) as f:
        bad = dict(json.load(f), total_weight=-1)
    with open(res, "w") as f:
        json.dump(bad, f)
    assert _run(tcli.main, ["verify", "--graph-dir", graph_dir, "--result", res])[0] == 1
    assert _run(jcli.main, ["verify", "--graph-dir", graph_dir, "--result", res])[0] == 1


# ---------------------------------------------------------------------------
# serve, tune, chaos, trace and stats, bench
# ---------------------------------------------------------------------------
def _strip(resp):
    resp = {k: v for k, v in resp.items() if k not in ("wall_time_s", "wall_s")}
    return json.dumps(resp, sort_keys=True)


@pytest.mark.parametrize("lanes", ["0", "4"])
def test_serve_deck_answers_equal_jax(tmp_path, lanes):
    """A JSONL deck through ``serve --input`` (single process): the answers
    equal JAX's as JSON text once the wall times are out."""
    from distributed_ghs_implementation_tpu.graphs import generators as jgen

    graphs = [jgen.gnm_random_graph(40, 120, seed=s) for s in range(3)]
    graphs.append(jgen.readme_sample_graph())
    reqs = [{"op": "solve", "num_nodes": g.num_nodes, "edges_out": True,
             "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]}
            for g in graphs]
    reqs.append(dict(reqs[0]))  # a repeat: cached
    reqs.append({"op": "components", **{k: reqs[1][k] for k in ("num_nodes", "edges")}})
    deck = tmp_path / "deck.jsonl"
    deck.write_text("\n".join(json.dumps(r) for r in reqs) + "\n{not json\n")
    answers = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        for lanes_mod in (tlanes,):
            lanes_mod.clear_solver_cache()
        rc, out = _run(main, ["serve", "--input", str(deck), "--no-compile-cache",
                              "--batch-lanes", lanes] + extra)
        assert rc == 0
        answers[side] = [json.loads(line) for line in out.splitlines()]
    assert len(answers["port"]) == len(reqs) + 1
    assert [_strip(a) for a in answers["port"]] == [_strip(a) for a in answers["jax"]]
    assert answers["port"][len(graphs)]["cached"]


def test_serve_has_no_kernel_flag_and_fleet_passes_the_device(monkeypatch, tmp_path):
    """``serve --kernel`` is refused (the device picks the kernels), no
    ``GHS_KERNEL`` is exported, and ``serve --fleet`` hands ``--device`` to
    the fleet's ``FleetConfig.device``."""
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        tcli.main(["serve", "--kernel", "xla"] + CPU)
    assert e.value.code == 2
    seen = {}

    class Router:
        def __init__(self, config):
            seen["config"] = config

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    from distributed_ghs_implementation_tpu_torch.fleet import router as trouter

    monkeypatch.setattr(trouter, "FleetRouter", Router)
    monkeypatch.delenv("GHS_KERNEL", raising=False)
    deck = tmp_path / "empty.jsonl"
    deck.write_text("")
    with contextlib.redirect_stderr(io.StringIO()):
        assert _run(tcli.main, ["serve", "--fleet", "2", "--input", str(deck)] + CPU)[0] == 0
    config = seen["config"]
    assert (config.device, config.workers, config.transport) == ("cpu", 2, "pipe")
    assert "GHS_KERNEL" not in os.environ


def test_tune_dry_is_byte_identical(tmp_path):
    """``tune --dry`` twice: byte-identical records, the default config
    pinned; ``--mesh-buckets`` counts the port's mesh (one CPU shard)."""
    paths = [tmp_path / f"rec{i}.json" for i in range(2)]
    outs = []
    for path in paths:
        rc, out = _run(tcli.main, ["tune", "--buckets", "128x512", "--lanes", "2",
                                   "--mesh-buckets", "3000x9000", "--dry", "--out",
                                   str(path)] + CPU)
        assert rc == 0
        outs.append(json.loads(out))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert outs[0]["pinned"]
    assert sorted(json.loads(paths[0].read_text())["entries"]) == [
        "128x512x0xfused", "128x512x2xfused", "3072x10240x1xmesh"]  # one CPU shard
    with pytest.raises(SystemExit, match="nothing to tune"):
        tcli.main(["tune"] + CPU)


def test_chaos_exits_zero(tmp_path):
    rc, out = _run(tcli.main, ["chaos", "--output", str(tmp_path / "chaos.json")] + CPU)
    assert rc == 0
    assert json.loads((tmp_path / "chaos.json").read_text())["ok"]


def _trace_counts(snapshot):
    levels = snapshot["spans"].get("solver.level", {}).get("count", 0)
    protocol = {k: v for k, v in snapshot["counters"].items() if k.startswith("protocol.")}
    return levels, protocol


def test_trace_and_stats_equal_jax(tmp_path):
    """``trace`` on the stepped rung: the same number of ``solver.level``
    spans and the same ``protocol.*`` counters as JAX; ``stats --input``
    renders the port's event log."""
    from distributed_ghs_implementation_tpu.obs.export import snapshot_from_jsonl as jsnap

    counts = {}
    for side, main, snap, extra in (("jax", jcli.main, jsnap, []),
                                    ("port", tcli.main, tsnap, CPU)):
        jsonl = tmp_path / f"{side}.jsonl"
        trace = tmp_path / f"{side}.trace.json"
        with contextlib.redirect_stderr(io.StringIO()):
            rc, out = _run(main, ["trace", "--nodes", "300", "--seed", "5", "--out",
                                  str(trace), "--jsonl", str(jsonl)] + extra)
        assert rc == 0 and out.strip() == str(trace)
        assert json.loads(trace.read_text())["traceEvents"]
        counts[side] = _trace_counts(snap(str(jsonl)))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] >= 2 and counts["port"][1]
    rc, out = _run(tcli.main, ["stats", "--input", str(tmp_path / "port.jsonl")])
    assert rc == 0 and "solver.level" in out  # reads a log: no device needed
    with contextlib.redirect_stderr(io.StringIO()):
        rc, out = _run(tcli.main, ["stats", "--nodes", "120", "--no-protocol-sample"] + CPU)
    assert rc == 0 and "solver.level" in out


#: ``bench`` flag sets: the port's CLI must hand its bench module what
#: JAX's hands the root bench.py, plus ``--device``.
BENCH_FLAGS = {
    "defaults": [],
    "scale": ["--scale", "20"],
    "edge-factor-repeats": ["--edge-factor", "8", "--repeats", "5"],
    "sharded": ["--backend", "sharded"],
    "no-verify": ["--no-verify"],
    "metrics-out": ["--metrics-out", "m.json"],
    "batch-lanes": ["--batch-lanes", "16"],
    "warmup": ["--batch-lanes", "16", "--warmup"],
    "update-stream": ["--update-stream"],
}


@pytest.mark.parametrize("name", list(BENCH_FLAGS))
def test_bench_passes_jax_s_flags(name, monkeypatch):
    import bench as jbench

    from distributed_ghs_implementation_tpu_torch import bench as tbench

    seen = {}

    def capture(side):
        def main(argv):
            seen[side] = argv
            return 0
        return main

    monkeypatch.setattr(jbench, "main", capture("jax"))
    monkeypatch.setattr(tbench, "main", capture("port"))
    assert jcli.main(["bench"] + BENCH_FLAGS[name]) == 0
    assert tcli.main(["bench"] + BENCH_FLAGS[name] + CPU) == 0
    port = list(seen["port"])
    i = port.index("--device")
    assert port[i:i + 2] == CPU and port[:i] + port[i + 2:] == seen["jax"]
    assert seen["jax"][:2] == ["--scale", BENCH_FLAGS[name][1] if name == "scale" else "22"]


#: ``bench`` runs in both packages: (flags, JAX's keys the port leaves out).
BENCH_RUNS = {
    "rmat": ["--scale", "10", "--repeats", "2"],
    "sharded": ["--scale", "10", "--repeats", "1", "--backend", "sharded"],
    "batch": ["--batch-lanes", "8", "--repeats", "1"],
}


@pytest.mark.parametrize("name", list(BENCH_RUNS))
def test_bench_runs_and_prints_jax_s_line(name, tmp_path):
    """``bench --device cpu`` prints JAX's line (the same keys, but
    ``level_kernel_speedup``, plus ``device``) and writes its metrics; the
    deterministic fields equal JAX's (``test_torch_bench.compare_runs``)."""
    from test_torch_bench import compare_runs, run_bench

    compare_runs(run_bench(jcli.main, ["bench"] + BENCH_RUNS[name], tmp_path / "j.json"),
                 run_bench(tcli.main, ["bench"] + BENCH_RUNS[name] + CPU, tmp_path / "t.json"))


def test_bench_without_device_refuses_without_cuda(monkeypatch):
    """No CUDA and no ``--device cpu``: a non-zero exit before the bench
    module runs."""
    import torch

    from distributed_ghs_implementation_tpu_torch import bench as tbench

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "main", lambda argv: calls.append(argv))
    for argv in (["bench"], ["bench", "--batch-lanes", "4"], ["bench", "--update-stream"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
    assert calls == []


def test_bench_refuses_kernel(capsys):
    """The port's bench has no ``--kernel`` (JAX's bench.py does): the
    parser refuses it."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["bench", "--kernel", "xla"] + CPU)
    assert e.value.code == 2 and "--kernel" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The parser, the device rule, the import rule
# ---------------------------------------------------------------------------
def _options(parser):
    subs = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {name: {s for a in sp._actions for s in a.option_strings}
            for name, sp in subs.choices.items()}, subs


def test_parser_has_every_jax_option():
    """Every subcommand and option string of JAX's parser exists in the
    port's, with the same default, except the listed differences; every
    solving subcommand takes ``--device`` (default ``cuda``)."""
    jopts, jsubs = _options(jcli.build_parser())
    topts, tsubs = _options(tcli.build_parser())
    assert set(topts) == set(jopts) and len(jopts) == 11
    for name, opts in jopts.items():
        assert opts - JAX_ONLY.get(name, set()) <= topts[name], name
        jdefaults = {a.dest: a.default for a in jsubs.choices[name]._actions}
        tdefaults = {a.dest: a.default for a in tsubs.choices[name]._actions}
        for dest, default in jdefaults.items():
            if dest in tdefaults:
                assert tdefaults[dest] == default, (name, dest)
    solving = {"run", "experiments", "chaos", "trace", "stats", "serve", "tune", "bench"}
    assert {n for n, o in topts.items() if "--device" in o} == solving
    for name in solving:
        assert tcli.build_parser().parse_args(
            [name] + (["x"] if name == "merge-trace" else [])).device == "cuda"


def test_run_without_device_refuses_without_cuda(monkeypatch, graph_dir):
    """No CUDA and no ``--device cpu``: a non-zero exit before any solve."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tapi, "minimum_spanning_forest", lambda *a, **k: calls.append(a))
    for argv in (["run", "--graph-dir", graph_dir], ["experiments"], ["tune", "--dry"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
    assert calls == []


def test_module_help_needs_no_jax():
    """``python -m distributed_ghs_implementation_tpu_torch --help`` with JAX
    made unimportable: exits 0 and loads nothing of the JAX package."""
    script = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['distributed_ghs_implementation_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('distributed_ghs_implementation_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from distributed_ghs_implementation_tpu_torch import cli, entry, experiments\n"
        "from distributed_ghs_implementation_tpu_torch.utils import reporting, viz\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('distributed_ghs_implementation_tpu.')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "serve" in proc.stdout and "merge-trace" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# viz and the entry module
# ---------------------------------------------------------------------------
def _drawn(monkeypatch, viz, result_or_graph, path):
    """The edge lists and labels ``viz`` hands NetworkX."""
    import networkx as nx
    from networkx.drawing import nx_pylab

    seen = []
    real_edges, real_labels = nx_pylab.draw_networkx_edges, nx_pylab.draw_networkx_edge_labels

    def edges(g, pos, **kw):
        seen.append(("edges", sorted(tuple(sorted(e)) for e in kw.get("edgelist") or [])))
        return real_edges(g, pos, **kw)

    def labels(g, pos, **kw):
        seen.append(("labels", sorted(kw["edge_labels"].items())))
        return real_labels(g, pos, **kw)

    monkeypatch.setattr(nx, "draw_networkx_edges", edges)
    monkeypatch.setattr(nx, "draw_networkx_edge_labels", labels)
    fn = viz.visualize_mst if hasattr(result_or_graph, "edge_ids") else viz.visualize_graph
    assert fn(result_or_graph, str(path)) == str(path)
    assert path.stat().st_size > 0 and path.read_bytes()[:4] == b"\x89PNG"
    return seen


def test_viz_draws_what_jax_draws(monkeypatch, tmp_path, graph_dir):
    from distributed_ghs_implementation_tpu.api import minimum_spanning_forest as jmsf

    jg, tg = jio.read_partition_dir(graph_dir), tio.read_partition_dir(graph_dir)
    for name, j_obj, t_obj in (("graph", jg, tg),
                               ("mst", jmsf(jg), tapi.minimum_spanning_forest(tg, device="cpu"))):
        got = _drawn(monkeypatch, tviz, t_obj, tmp_path / f"port_{name}.png")
        want = _drawn(monkeypatch, jviz, j_obj, tmp_path / f"jax_{name}.png")
        assert got == want and got
    # Through the CLI: generate --visualize and run --visualize write PNGs.
    d = tmp_path / "v"
    assert _run(tcli.main, ["generate", "--nodes", "7", "--seed", "2", "--output-dir", str(d),
                            "--visualize"])[0] == 0
    assert (d / "input_graph.png").is_file()
    out = tmp_path / "res.json"
    assert _run(tcli.main, ["run", "--graph-dir", str(d), "--output", str(out),
                            "--visualize"] + CPU)[0] == 0
    assert (tmp_path / "res.png").is_file()
    assert tviz.visualize_graph(tg, str(tmp_path / "x.png"), max_nodes=3) is None


def test_viz_names_a_missing_package(monkeypatch, tmp_path, graph_dir):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tviz.visualize_graph(tio.read_partition_dir(graph_dir), str(tmp_path / "x.png"))


def test_entry_equals_jax_boruvka_solve():
    """``entry(device="cpu")``: the port's ``boruvka_solve`` and its example
    arguments give JAX's ``entry()`` result, element for element."""
    sys.path.insert(0, str(ROOT))
    try:
        import __graft_entry__ as jentry
    finally:
        sys.path.remove(str(ROOT))
    from distributed_ghs_implementation_tpu_torch import entry as tentry

    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry(device="cpu")
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jout, tout = jfn(*jargs), tfn(*targs)
    for t, j in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(tout[2]) == int(jout[2])


def test_dryrun_multichip_on_four_cpu_shards(capsys):
    from distributed_ghs_implementation_tpu_torch import entry as tentry

    counts = tentry.dryrun_multichip(4, device="cpu")
    assert counts["shards"] == 4 and counts["components"] == 23
    assert "dryrun_multichip ok: 4 shards" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# run --multihost from torchrun's environment
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_multihost_from_torchrun_env_equals_jax(tmp_path, graph_dir):
    """Two gloo processes of ``run --multihost --backend sharded --device
    cpu``, with the variables torchrun exports: process 0 prints the
    result, process 1 nothing, and process 0's result equals JAX's on its 8
    devices (but the time)."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "distributed_ghs_implementation_tpu_torch", "run",
             "--multihost", "--backend", "sharded", "--graph-dir", graph_dir] + CPU,
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    assert outs[1][0] == ""
    got = json.loads(outs[0][0])
    rc, out = _run(jcli.main, ["run", "--backend", "sharded", "--graph-dir", graph_dir])
    assert rc == 0
    want = json.loads(out)
    for res in (got, want):
        res.pop("execution_time")
    assert got == want
