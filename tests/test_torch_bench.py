"""The port's benchmark (``distributed_ghs_implementation_tpu_torch/bench.py``)
against the repository's root ``bench.py``, on the CPU.

Each workload runs through both ``main``s from the same seeds at a small
size: the JAX side under ``JAX_PLATFORMS=cpu`` (8 virtual devices,
``tests/conftest.py``), the port with ``--device cpu``. Compared exactly:
every value of the JSON line and of ``--metrics-out``'s metrics that is not
a float (forest weights and edge counts, levels, parity strings, window
modes, message, forward and counter counts, the metric and workload names
with the device count taken out). Not compared, but checked positive and
finite: the floats, which are times and rates. Not compared at all: the
device counts (JAX's mesh has 8 devices, the port's CPU mesh one shard),
``kernel`` (JAX's ``xla``, the port's ``torch``), ``device`` (the port's)
and ``record`` (a temporary path). Where the port differs on purpose it is
pinned here: no ``--kernel``, no ``level_kernel_speedup``, the verify
workload's ``torch`` engine, ``package`` and ``device`` in the metrics'
config. The fleet workloads are in ``test_torch_bench_fleet.py``.
"""

import contextlib
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench as jbench
from distributed_ghs_implementation_tpu.batch import lanes as jlanes
from distributed_ghs_implementation_tpu.ops import pallas_kernels as jpk
from distributed_ghs_implementation_tpu_torch import bench as tbench
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from torch_pairs import isolated, jax_native, jax_native_library  # noqa: F401 -- fixtures

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]

#: Keys of the JAX line and metrics that the port leaves out, and the
#: port's in their place (the verify workload's second engine).
JAX_ONLY = {"level_kernel_speedup", "certify_xla_p50_s"}
PORT_ONLY = {"certify_torch_p50_s"}
#: Keys not compared (see the module docstring).
NOT_COMPARED = {"kernel", "device", "record"}

pytestmark = pytest.mark.usefixtures("isolated", "clean_state")


@pytest.fixture
def clean_state():
    """No tuning record installed and no lane solver built, in both
    packages, before and after (the tuned workload installs one)."""
    def reset():
        jpk._reset_for_tests()
        kernels.set_tuned_configs(None)
        jlanes.clear_solver_cache()
        tlanes.clear_solver_cache()

    reset()
    yield
    reset()


def run_bench(main, argv, metrics_path):
    """``main(argv + --metrics-out)`` with its output captured:
    ``(rc, last stdout line as JSON, the metrics file)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv + ["--metrics-out", str(metrics_path)])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), json.loads(
        Path(metrics_path).read_text())


def _no_devices(text: str) -> str:
    """A metric or workload name without its device count."""
    return re.sub(r"\d+ ?dev(ice\(s\))?", "N dev", text)


def _times_ok(values: dict) -> None:
    for name, value in values.items():
        if isinstance(value, float):
            assert math.isfinite(value) and value > 0, (name, value)


def compare_runs(jax_run, port_run) -> None:
    """Hold the port's line and metrics to JAX's (the rules of the module
    docstring)."""
    (jrc, jline, jdoc), (trc, tline, tdoc) = jax_run, port_run
    assert jrc == 0 and trc == 0
    assert set(tline) == (set(jline) - JAX_ONLY) | (PORT_ONLY & set(tline)) | {"device"}
    assert set(tdoc["metrics"]) == (set(jdoc["metrics"]) - JAX_ONLY) | (
        PORT_ONLY & set(tdoc["metrics"]))
    for side, line in (("line", (jline, tline)), ("metrics", (jdoc["metrics"], tdoc["metrics"]))):
        j, t = line
        for key, value in j.items():
            if key in JAX_ONLY or key in NOT_COMPARED or isinstance(value, float):
                continue
            if isinstance(value, str):
                assert _no_devices(t[key]) == _no_devices(value), (side, key)
            else:
                assert t[key] == value, (side, key, t[key], value)
        _times_ok(t)
    assert tdoc["schema"] == jdoc["schema"] == "ghs-bench-metrics-v1"
    assert {k: _no_devices(v) for k, v in tdoc["config"].items()
            if k not in ("package", "device")} == {
        k: _no_devices(v) for k, v in jdoc["config"].items()}
    assert tdoc["config"]["package"] == "torch" and tdoc["config"]["device"] == "cpu"
    assert tline["device"] == "cpu"
    if "kernel" in tline:
        assert tline["kernel"] == "torch"


def run_both(tmp_path, argv):
    return (run_bench(jbench.main, argv, tmp_path / "jax.json"),
            run_bench(tbench.main, argv + CPU, tmp_path / "port.json"))


#: workload -> argv at a small size.
WORKLOADS = {
    "rmat-device": ["--scale", "11", "--repeats", "2"],
    "rmat-sharded": ["--scale", "10", "--repeats", "1", "--backend", "sharded"],
    "rmat-unverified": ["--scale", "9", "--edge-factor", "8", "--repeats", "1", "--no-verify"],
    "batch": ["--batch-lanes", "8", "--batch-graphs", "16", "--repeats", "1"],
    "batch-warmup": ["--batch-lanes", "4", "--batch-graphs", "8", "--batch-nodes", "64",
                     "--batch-edges", "200", "--repeats", "1", "--warmup"],
    "update-stream": ["--update-stream", "--stream-nodes", "256", "--stream-edges", "1024",
                      "--stream-updates", "32", "--stream-window", "16"],
    "verify": ["--verify", "--repeats", "1"],
    "kinds": ["--kinds", "--repeats", "1", "--batch-nodes", "64", "--batch-edges", "256"],
    "tuned": ["--tuned", "--repeats", "1", "--batch-lanes", "4"],
    "sharded-lane": ["--sharded-lane", "--repeats", "1", "--sharded-nodes", "20000",
                     "--sharded-edges", "40000"],
    "stream-sharded": ["--stream-sharded", "--stream-sharded-windows", "4",
                       "--stream-window", "16"],
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_matches_jax(name, tmp_path, monkeypatch, request):
    if name == "verify":
        request.getfixturevalue("jax_native")  # JAX's host backend
    if name == "tuned":
        # One device on both sides: the port's CPU mesh is one shard, so
        # JAX's 8 virtual devices would add a mesh phase the port lacks.
        import jax

        monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    jax_run, port_run = run_both(tmp_path, WORKLOADS[name])
    compare_runs(jax_run, port_run)


def test_rmat_line_verifies_against_the_oracle(tmp_path):
    """The RMAT line reads weight-verified; its forest's weight is the live
    SciPy oracle's below the recorded scales (the NumPy stream)."""
    from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph
    from distributed_ghs_implementation_tpu_torch.utils.verify import scipy_mst_weight

    rc, line, doc = run_bench(tbench.main, ["--scale", "10", "--repeats", "1"] + CPU,
                              tmp_path / "m.json")
    g = rmat_graph(10, 16, seed=tbench.SEED)
    assert rc == 0 and "weight-verified" in line["metric"]
    assert doc["metrics"]["mst_weight"] == int(scipy_mst_weight(g))
    assert line["e2e_edges_per_sec"] < line["value"]
    assert line["vs_baseline"] == round(line["value"] / tbench.BASELINE_EDGES_PER_SEC, 1)


def test_recorded_weights_are_jax_s():
    assert tbench.RECORDED_ORACLE_WEIGHTS == jbench.RECORDED_ORACLE_WEIGHTS
    assert tbench.BASELINE_EDGES_PER_SEC == jbench.BASELINE_EDGES_PER_SEC
    assert tbench.SEED == jbench.SEED == 24


def test_recorded_weight_applies_to_the_native_stream_only(tmp_path, monkeypatch):
    """A graph tagged ``rmat-native`` is held to the recorded weight (a wrong
    one fails the run with the VERIFY FAILED line); the NumPy stream's is
    not."""
    from distributed_ghs_implementation_tpu_torch.graphs import generators

    real = generators.rmat_graph

    def tagged(*a, **k):
        g = real(*a, **k)
        g.__dict__["generator_path"] = "rmat-native"
        return g

    monkeypatch.setitem(tbench.RECORDED_ORACLE_WEIGHTS, (10, 16, tbench.SEED), 1)
    rc, line, _ = run_bench(tbench.main, ["--scale", "10", "--repeats", "1"] + CPU,
                            tmp_path / "untagged.json")
    assert rc == 0 and "weight-verified" in line["metric"]
    monkeypatch.setattr(generators, "rmat_graph", tagged)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = tbench.main(["--scale", "10", "--repeats", "1"] + CPU)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 1 and line["value"] == 0.0 and "VERIFY FAILED" in line["metric"]


def test_metrics_out_schema(tmp_path):
    """``--metrics-out``: the bench-gate schema, JAX's workload name, the
    config's ``package`` and ``device``, finite metrics."""
    rc, line, doc = run_bench(tbench.main, ["--scale", "9", "--repeats", "1"] + CPU,
                              tmp_path / "m.json")
    assert rc == 0
    assert set(doc) == {"schema", "config", "metrics"}
    assert doc["schema"] == "ghs-bench-metrics-v1"
    assert doc["config"] == {"workload": "rmat-9x16-seed24-device", "package": "torch",
                             "device": "cpu"}
    assert {"solve_s", "cold_first_solve_s", "solve_p50_s", "solve_p95_s", "edges_per_sec",
            "levels", "mst_weight", "mst_edges", "prep_s", "e2e_edges_per_sec"} == set(
        doc["metrics"])
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in doc["metrics"].values())
    assert line["solve_s"] == round(doc["metrics"]["solve_s"], 3)


def test_without_cuda_exits_before_any_solve(monkeypatch):
    """No CUDA and no ``--device cpu``: a non-zero exit, nothing generated."""
    import torch

    from distributed_ghs_implementation_tpu_torch.graphs import generators

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(generators, "rmat_graph", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(generators, "gnm_random_graph", lambda *a, **k: calls.append(a))
    for argv in ([], ["--batch-lanes", "4"], ["--update-stream"], ["--fleet-tcp"]):
        with pytest.raises(SystemExit) as e:
            tbench.main(argv)
        assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
    assert calls == []


def test_parser_is_jax_s_without_kernel(monkeypatch):
    """Every option of the root bench.py but ``--kernel``, with its
    default; ``--device`` (default ``cuda``) is the port's."""
    import argparse

    def options(parser):
        return {s: a.default for a in parser._actions for s in a.option_strings}

    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jbench.main([])
    jopts, topts = options(seen["parser"]), options(tbench.build_parser())
    assert set(topts) == set(jopts) - {"--kernel"} | {"--device"}
    assert all(topts[k] == v for k, v in jopts.items() if k != "--kernel")
    assert topts["--device"] == "cuda" and topts["--scale"] == 24
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        tbench.main(["--kernel", "xla"] + CPU)
    assert e.value.code == 2


def test_workload_precedence_is_jax_s():
    """With several workload flags, the one the root bench.py runs first
    wins."""
    order = ["verify", "kinds", "fleet_tcp", "wire", "update_stream", "stream_sharded",
             "tuned", "sharded_lane", "batch_lanes"]
    assert [flag for flag, _ in tbench.WORKLOADS] == order
    src = Path(jbench.__file__).read_text()
    body = src[src.index("def main("):]
    jax_order = re.findall(r"if args\.(\w+):\n\s+return run_", body)
    assert jax_order == order


def test_lane_solves_count_installed_configs(monkeypatch):
    """``kernel.selected.measured`` counts one a lane solve whose bucket has
    an installed config, and none without one (the tuned workload's
    ``tune_record_hits``)."""
    graphs = [gnm_random_graph(64, 200, seed=s) for s in range(3)]
    bucket = (*tlanes.bucket_of(64, 200), 4, "fused")
    BUS.clear()
    tlanes.solve_lanes(graphs, lanes=4, device="cpu")
    assert BUS.counters().get("kernel.selected.measured", 0) == 0
    kernels.set_tuned_configs({bucket: kernels.LaunchConfig()})
    for _ in range(3):
        tlanes.solve_lanes(graphs, lanes=4, device="cpu")
    assert BUS.counters()["kernel.selected.measured"] == 3
    assert kernels.tuned_config((1, 2, 3, "fused")) is kernels.DEFAULT_CONFIG
    assert kernels.tuned_config((1, 2, 3, "fused"), default=None) is None


def test_module_runs_without_jax():
    """``python -m distributed_ghs_implementation_tpu_torch.bench`` with JAX
    made unimportable: its JSON line is the last line of stdout, and no
    module of the JAX package was loaded."""
    script = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['bench', '--device', 'cpu', '--scale', '8', '--repeats', '1']\n"
        "try:\n"
        "    runpy.run_module('distributed_ghs_implementation_tpu_torch.bench', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('distributed_ghs_implementation_tpu.')), file=sys.stderr)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["unit"] == "edges/s" and line["device"] == "cpu"
    assert proc.stderr.strip().splitlines()[-1] == "[]"
    assert np.isfinite(line["value"]) and line["value"] > 0
