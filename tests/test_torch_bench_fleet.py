"""The port's fleet workloads of ``bench.py`` (``--fleet-tcp``, ``--wire``)
against the root ``bench.py``'s, on the CPU, with echo workers (no service,
no device) in both packages. The rules of ``test_torch_bench.py`` hold:
exact forward, elastic and wire counters, names and counts; times positive
and finite. The port runs as ``python -m`` in a process of its own, so that
its JSON line is shown to be the last line of its standard output while its
worker processes run.
"""

import json
import subprocess
import sys

import pytest

import bench as jbench
from test_torch_bench import ROOT, clean_state, compare_runs, run_bench  # noqa: F401
from torch_pairs import isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "clean_state")

WORKLOADS = {
    "fleet-tcp": ["--fleet-tcp", "--fleet-requests", "8", "--fleet-forward", "2"],
    "wire": ["--wire", "--wire-graphs", "4", "--repeats", "1"],
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_fleet_workload_matches_jax(name, tmp_path):
    argv = WORKLOADS[name]
    jax_run = run_bench(jbench.main, argv, tmp_path / "jax.json")
    path = tmp_path / "port.json"
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_ghs_implementation_tpu_torch.bench", *argv,
         "--device", "cpu", "--metrics-out", str(path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port_run = (proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1]),
                json.loads(path.read_text()))
    compare_runs(jax_run, port_run)
