"""The float cell (``rmat24-float``, configuration ``graph500-rmat24-float``)
on a small copy of its own: the generator, the float reference against a
plain Kruskal and the system, the float32 control, a planted fault, the
route check, the cycled pool's fresh graphs, and the cell made of new
files alone."""

import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from ghs_bench import graphs, harness, reference, reference_float
from ghs_bench.drivers import float_fresh

CELL = "rmat24-float"
CONFIG = "graph500-rmat24-float"
#: Every file of the float cell, under ``ghs_bench/``.
FLOAT_FILES = {"reference_float.py", "float_control.py", "drivers/float_fresh.py",
               f"configs/{CONFIG}.json", "mixes/rmat-float-cycled.json",
               "layer_metrics/rank_order_roofline.solve.py",
               "layer_metrics/rank_order_passes.solve.py"}
NEW_METRICS = {"rank_order_roofline.solve", "rank_order_passes.solve"}
#: Metrics the CPU cannot read: the device trace's and the card's memory.
CARD_ONLY = {"kernel_roofline.solve", "device_idle.solve", "peak_device_gib.solve"}
#: Metrics of steps the small copy does not reach: the finish's relabel
#: after its shrink chain runs from 2^21 padded vertices up (the cell's
#: graphs have 2^24).
AT_SCALE_ONLY = {"replay_s.solve"}
#: The smallest Kronecker scale whose graphs hold 2^17 edges and more, so
#: that the API takes the rank route, as at the cell's size.
SMALL_SCALE = 14


def _shrink(bench: str, *, pool: int = 2) -> None:
    path = os.path.join(bench, "configs", f"{CONFIG}.json")
    cfg = json.load(open(path))
    cfg["generator"]["scale"] = SMALL_SCALE
    json.dump(cfg, open(path, "w"))
    path = os.path.join(bench, "mixes", "rmat-float-cycled.json")
    mix = json.load(open(path))
    mix.update(pool=pool, warm_scale=SMALL_SCALE)
    json.dump(mix, open(path, "w"))


@pytest.fixture
def float_bench(tmp_path):
    """A copy of the benchmark with the float cell at a small scale: its
    ``ghs_bench`` directory."""
    bench = os.path.join(str(tmp_path), "ghs_bench")
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), str(tmp_path))
    _shrink(bench)
    return bench


def _run(bench, *, trace=False, seed=2**33 + 21, seconds=1.0):
    spec = harness.load_spec(os.path.dirname(bench))
    return harness.run_cell(spec, CELL, seed=seed, seconds=seconds, trace=trace,
                            device="cpu", t_start=time.perf_counter(), bench_dir=bench)


def _config():
    return json.load(open(os.path.join(harness.BENCH_DIR, "configs", f"{CONFIG}.json")))


# ----------------------------------------------------------------------
# The generator
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [5, 2**31 + 7, 2**45 + 1])
def test_the_generator_gives_canonical_float_graphs_on_the_integer_endpoints(seed):
    cfg, gen = _config(), _config()["generator"]
    n, u, v, w, generated = float_fresh.float_kronecker(cfg, seed=seed, stream=3, scale=10,
                                                        device="cpu")
    assert n == 1 << 10 and generated == gen["edge_factor"] << 10
    assert u.dtype == v.dtype == torch.int64 and w.dtype == torch.float64
    assert bool((u < v).all())
    key = u * n + v
    assert bool((key[1:] > key[:-1]).all())  # sorted by (u, v), no pair twice
    assert 0.0 <= float(w.min()) and float(w.max()) < 1.0 and w.numel() == u.numel() < generated
    n2, u2, v2, _ = graphs.kronecker(10, gen["edge_factor"], a=gen["a"], b=gen["b"], c=gen["c"],
                                     weight_low=1, weight_high=255, seed=seed, stream=3)
    assert n2 == n and torch.equal(u, u2) and torch.equal(v, v2)
    again = float_fresh.float_kronecker(cfg, seed=seed, stream=3, scale=10, device="cpu")
    assert torch.equal(again[3], w)
    other = float_fresh.float_kronecker(cfg, seed=seed, stream=4, scale=10, device="cpu")
    assert other[3].numel() != w.numel() or not torch.equal(other[3], w)


# ----------------------------------------------------------------------
# The float reference
# ----------------------------------------------------------------------
def _kruskal(n, u, v, w):
    """A plain Kruskal over ``np.argsort(w, kind="stable")``: sorted ids."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for e in np.argsort(w, kind="stable"):
        a, b = find(int(u[e])), find(int(v[e]))
        if a != b:
            parent[a] = b
            out.append(int(e))
    return np.sort(np.array(out, dtype=np.int64))


def _float_graph(seed: int, n: int, m: int, *, parts: int = 1):
    """A canonical random graph with float weights: heavy ties, -0.0 and
    +0.0, negatives; with ``parts`` > 1 the vertices fall in that many
    blocks no edge crosses (a forest of several components)."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, parts, n)
    a, b = rng.integers(0, n, (2, 3 * m * parts))
    keep = (a != b) & (block[a] == block[b])
    lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    pair = np.unique(lo * n + hi)[:m]
    u, v = pair // n, pair % n
    w = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 0.25, 3.0]), u.size)
    free = rng.random(u.size) < 0.5
    w[free] = rng.random(int(free.sum()))
    return n, u.astype(np.int64), v.astype(np.int64), w


@pytest.mark.parametrize("seed,n,m,parts", [(1, 40, 120, 1), (2, 300, 900, 4),
                                            (3, 2000, 5000, 7), (4, 50, 30, 3)])
def test_the_float_reference_equals_a_plain_kruskal(seed, n, m, parts):
    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

    n, u, v, w = _float_graph(seed, n, m, parts=parts)
    want = _kruskal(n, u, v, w)
    np.testing.assert_array_equal(reference_float.msf_ids(n, u, v, w), want)
    got = api.minimum_spanning_forest(Graph(n, u, v, w), backend="device", device="cpu")
    np.testing.assert_array_equal(got.edge_ids, want)


@pytest.mark.parametrize("seed,parts", [(11, 1), (12, 5)])
def test_the_system_equals_the_float_reference_on_the_rank_route(seed, parts):
    """At 2^17 edges and more, where the API takes the rank route and K7's
    64-bit float key: ties, -0.0, and a forest of several components."""
    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import ELL_AUTO_EDGE_THRESHOLD

    n, u, v, w = _float_graph(seed, 60_000, 150_000, parts=parts)
    assert u.size >= ELL_AUTO_EDGE_THRESHOLD
    got = api.minimum_spanning_forest(Graph(n, u, v, w), backend="device", device="cpu")
    want = reference_float.msf_ids(n, u, v, w)
    assert reference.mismatch(got.edge_ids, want) == 0
    np.testing.assert_array_equal(got.edge_ids, want)


def test_the_reference_refuses_nan_weights():
    with pytest.raises(ValueError, match="NaN"):
        reference_float.msf_ids(3, [0, 1], [1, 2], [0.5, np.nan])


# ----------------------------------------------------------------------
# The control
# ----------------------------------------------------------------------
def test_the_float32_control_reads_above_the_limit(float_bench):
    """Near ties that float32 cannot tell apart change the forest: in a
    triangle whose weights differ below float32's step, the rounded
    weights tie and edge order decides; in a graph whose weights all lie
    within float32's step of one value, nearly every choice does. The
    control itself runs at the small copy's size (where few of the uniform
    weights collide in float32; at the cell's 260M edges most of them do)."""
    u, v = np.array([0, 1, 0]), np.array([1, 2, 2])
    w = np.array([1.0 + 2e-12, 1.0 + 1e-12, 1.0])
    exact = reference_float.msf_ids(3, u, v, w)
    rounded = reference_float.msf_ids(3, u, v, w, float32=True)
    np.testing.assert_array_equal(exact, [1, 2])
    assert reference.mismatch(rounded, exact) == 2
    n, u, v, _ = _float_graph(5, 2000, 6000)
    w = 0.25 + np.random.default_rng(5).random(u.size) * 1e-9
    exact = reference_float.msf_ids(n, u, v, w)
    rounded = reference_float.msf_ids(n, u, v, w, float32=True)
    assert reference.mismatch(rounded, exact) > 100
    import importlib.util

    spec_file = importlib.util.spec_from_file_location(
        "float_control_copy", os.path.join(float_bench, "float_control.py"))
    control = importlib.util.module_from_spec(spec_file)
    spec_file.loader.exec_module(control)
    spec = harness.load_spec(os.path.dirname(float_bench))
    cell = harness.find_cell(spec, CELL, float_bench)
    reading = control.float_control(cell, 7, "cpu")
    assert reading["generated"] == 16 << SMALL_SCALE > reading["edges"] > reading["forest_edges"]
    assert reading["forest_mismatch"] >= cell.config["checks"]["forest_mismatch"]
    # The order sees what the forest may not: float32 merges near draws.
    assert reading["order_mismatch"] > cell.config["checks"]["order_mismatch"]
    judged = control.judged(cell, [reading, reading])
    assert not judged["correct"]
    assert judged["checks"]["order_mismatch"] == [2 * reading["order_mismatch"], 0]


# ----------------------------------------------------------------------
# The cell
# ----------------------------------------------------------------------
def test_the_cell_runs_correct_untraced_and_traced(float_bench):
    spec = harness.load_spec(os.path.dirname(float_bench))
    cell = harness.find_cell(spec, CELL, float_bench)
    line, checks = _run(float_bench)
    assert line["correct"] and checks == {"forest_mismatch": (0, 0), "order_mismatch": (0, 0)}
    assert set(line["metrics"]) == {"solve_edges_per_s", "setup_s"}
    assert line["attempted"] > 2  # the pool of 2 cycled
    line, checks = _run(float_bench, trace=True)
    assert line["correct"] and checks == {"forest_mismatch": (0, 0), "order_mismatch": (0, 0)}
    listed = {m["name"] for m in cell.per_layer}
    assert NEW_METRICS <= listed
    assert set(line["metrics"]) == listed - CARD_ONLY - AT_SCALE_ONLY
    assert 7 <= line["metrics"]["rank_order_passes.solve"]["value"] <= 8
    assert line["metrics"]["rank_order_roofline.solve"]["value"] > 0


def test_an_altered_forest_id_fails(float_bench, monkeypatch):
    from distributed_ghs_implementation_tpu_torch import api

    real = api.minimum_spanning_forest

    def altered(graph, **kw):
        result = real(graph, **kw)
        ids = result.edge_ids.copy()
        outside = np.setdiff1d(np.arange(graph.num_edges), ids)
        ids[0] = outside[0]  # one forest id changed
        result.edge_ids = np.sort(ids)
        return result

    monkeypatch.setattr(api, "minimum_spanning_forest", altered)
    line, checks = _run(float_bench)
    assert not line["correct"] and checks["forest_mismatch"][0] == 2 * line["attempted"]


def test_an_altered_rank_order_fails_where_the_forest_cannot_see_it(float_bench, monkeypatch):
    """Ranks 0 and 1 swapped in the order the prep holds for the harvest:
    both are forest edges of every graph, so each forest keeps its ids,
    and only the order check fails the run, by 2 ranks a pool graph."""
    from distributed_ghs_implementation_tpu_torch.models import rank_solver

    real = rank_solver.hold_rank_order

    def swapped(graph, order, **kw):
        order = order.clone()
        order[[0, 1]] = order[[1, 0]]
        real(graph, order, **kw)

    monkeypatch.setattr(rank_solver, "hold_rank_order", swapped)
    line, checks = _run(float_bench)
    graphs_solved = min(line["attempted"], 2)  # the pool of 2
    assert not line["correct"] and graphs_solved >= 1
    assert checks == {"forest_mismatch": (0, 0), "order_mismatch": (2 * graphs_solved, 0)}


def test_a_solve_off_the_float_key_raises(float_bench, monkeypatch):
    """A solve whose rank order names another key than float64 (here the
    float weights sorted as if their key were int64's) raises at the
    warm-up, as the parent, which sorted floats on the host, does."""
    from distributed_ghs_implementation_tpu_torch.ops import kernels

    real = kernels.rank_key
    monkeypatch.setattr(kernels, "rank_key",
                        lambda w, *a: "int64" if w.dtype is torch.float64 else real(w, *a))
    with pytest.raises(RuntimeError, match="float64 keys"):
        _run(float_bench)


def test_a_second_graph_over_the_same_arrays_sorts_again():
    """The cycled pool hands the system a new ``Graph`` over arrays it has
    solved before: the rank order runs again (one more span, its passes
    counted again), and no order held by the first graph is reused."""
    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import held_rank_order
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    n, u, v, w = _float_graph(13, 60_000, 150_000)
    passes = "kernels.rank_order.passes"
    held, ids = [], []
    for _ in range(2):
        graph = Graph(n, u, v, w)
        assert held_rank_order(graph) is None
        mark, before = BUS.mark(), BUS.counters().get(passes, 0)
        ids.append(api.minimum_spanning_forest(graph, backend="device", device="cpu").edge_ids)
        spans = [rec[6] for rec in BUS.events_since(mark)
                 if rec[0] == "X" and rec[1] == "solver.prep.rank_order"]
        assert [(a["where"], a["key"]) for a in spans] == [("device", "float64")]
        assert BUS.counters()[passes] - before == spans[0]["passes"] > 0
        held.append(held_rank_order(graph))
    assert held[0] is not None and held[1] is not None and held[0] is not held[1]
    np.testing.assert_array_equal(ids[0], ids[1])


@pytest.mark.card
def test_a_second_graph_over_the_same_arrays_launches_k7_again(card):
    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.ops import kernels

    n, u, v, w = _float_graph(14, 60_000, 150_000)
    want = reference_float.msf_ids(n, u, v, w)
    for _ in range(2):
        launches = kernels.rank_order.launches
        got = api.minimum_spanning_forest(Graph(n, u, v, w), backend="device", device=card)
        assert kernels.rank_order.launches == launches + 1
        np.testing.assert_array_equal(got.edge_ids, want)


def test_the_new_readers_read_nothing_from_a_run_without_their_span_and_counter():
    cell = harness.find_cell(harness.load_spec(), CELL)
    record = harness.RunRecord(cell=cell, window=(-2.0, -1.0), spans=harness.Spans(),
                               memory_peak_bytes=0, solves=[{"edges": 10}])
    for name in sorted(NEW_METRICS):
        assert harness.load_reader(cell, name)(record) is None


def _digests(bench):
    out = {}
    for root, dirs, files in os.walk(bench):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, bench)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def _spec_without_the_float_cell(spec: dict) -> dict:
    spec = json.loads(json.dumps(spec))
    spec["configs"] = [c for c in spec["configs"] if c["name"] != CONFIG]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] != CELL]
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] not in NEW_METRICS]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return spec


def test_the_cell_is_new_files_alone(tmp_path):
    """The benchmark without the float cell, then the float cell's files and
    entries added: the cell runs, and no file that was there changes."""
    dest = str(tmp_path)
    bench = os.path.join(dest, "ghs_bench")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", *[os.path.basename(f) for f in FLOAT_FILES]))
    spec = harness.load_spec()
    json.dump(_spec_without_the_float_cell(spec), open(os.path.join(dest, "BENCHMARK.json"), "w"))
    before = _digests(bench)
    assert set(before).isdisjoint(FLOAT_FILES)
    for f in FLOAT_FILES:
        shutil.copy(os.path.join(harness.BENCH_DIR, f), os.path.join(bench, f))
    json.dump(spec, open(os.path.join(dest, "BENCHMARK.json"), "w"))
    _shrink(bench)
    line, _ = _run(bench)
    assert line["correct"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == FLOAT_FILES
