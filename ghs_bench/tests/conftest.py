"""A small copy of the benchmark for CPU tests: the same files, with
the configuration and mix cut to sizes a test run holds."""

import json
import os
import shutil
import time

import pytest

from ghs_bench import harness

def small_copy(dest: str, *, scale: int = 14, pool: int = 40) -> str:
    """A copy of the benchmark under ``dest`` with small sizes; returns its
    ``ghs_bench`` directory."""
    bench = os.path.join(dest, "ghs_bench")
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dest)
    path = os.path.join(bench, "configs", "graph500-rmat24.json")
    cfg = json.load(open(path))
    cfg["generator"]["scale"] = scale
    json.dump(cfg, open(path, "w"))
    path = os.path.join(bench, "mixes", "rmat-fresh.json")
    mix = json.load(open(path))
    mix.update(pool=pool, warm_scale=10)
    json.dump(mix, open(path, "w"))
    return bench


@pytest.fixture
def small_bench(tmp_path):
    return small_copy(str(tmp_path))


def _run_small(bench: str, workload: str, *, seed: int = 11, seconds: float = 2.0,
               trace: bool = False):
    spec = harness.load_spec(os.path.dirname(bench))
    return harness.run_cell(spec, workload, seed=seed, seconds=seconds, trace=trace,
                            device="cpu", t_start=time.perf_counter(), bench_dir=bench)


@pytest.fixture
def run_small():
    """Run a cell of a small copy on the CPU: ``(line, checks)``."""
    return _run_small
