"""The road cell (``usa-road-fresh``, configuration ``dimacs9-usa-road``)
on a small copy of its own: the generator against a NumPy and SciPy form
of it, the cell run on the CPU untraced and traced, its control, and the
cell made of new files alone."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components, minimum_spanning_tree

from ghs_bench import harness, roads

CELL = "usa-road-fresh"
CONFIG = "dimacs9-usa-road"
EDGES_PER_VERTEX = 29166672 / 23947347
#: Every file of the road cell, under ``ghs_bench/``.
ROAD_FILES = {"roads.py", "road_control.py", "drivers/road_fresh.py",
              f"configs/{CONFIG}.json", "mixes/road-fresh.json",
              "layer_metrics/replay_s.solve.py", "layer_metrics/host_reads.solve.py"}
#: Metrics the CPU cannot read: the device trace's and the card's memory.
CARD_ONLY = {"kernel_roofline.solve", "device_idle.solve", "peak_device_gib.solve"}
#: A lattice whose networks hold 2^17 edges and more, so that the API takes
#: the rank route, as at the cell's size.
SMALL_LATTICE = (340, 520)


def _spec_without_the_road_cell(spec: dict) -> dict:
    spec = json.loads(json.dumps(spec))
    spec["configs"] = [c for c in spec["configs"] if c["name"] != CONFIG]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] != CELL]
    spec["per_layer"] = [m for m in spec["per_layer"] if m.get("workloads") != [CELL]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return spec


def _shrink(bench: str, *, pool: int = 3) -> None:
    path = os.path.join(bench, "configs", f"{CONFIG}.json")
    cfg = json.load(open(path))
    cfg["generator"].update(rows=SMALL_LATTICE[0], cols=SMALL_LATTICE[1])
    json.dump(cfg, open(path, "w"))
    path = os.path.join(bench, "mixes", "road-fresh.json")
    mix = json.load(open(path))
    mix.update(pool=pool)
    json.dump(mix, open(path, "w"))


@pytest.fixture
def road_bench(tmp_path):
    """A copy of the benchmark with the road cell at a small lattice: its
    ``ghs_bench`` directory."""
    bench = os.path.join(str(tmp_path), "ghs_bench")
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), str(tmp_path))
    _shrink(bench)
    return bench


def _digests(bench):
    out = {}
    for root, dirs, files in os.walk(bench):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, bench)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


# ----------------------------------------------------------------------
# The generator
# ----------------------------------------------------------------------
def _numpy_form(rows, cols, draws):
    """:func:`roads.assemble` in NumPy and SciPy from the same draws: the
    lattice's candidate links, SciPy's minimum spanning tree under the
    tree keys, its largest piece (ties: the piece with the least vertex),
    the extra links of least extra key, lengths rounded."""
    d = {k: t.numpy() for k, t in draws.items()}
    occ = d["occupied"]
    cell = np.arange(rows * cols).reshape(rows, cols)
    top_left = cell[:-1, :-1].ravel()
    flip = d["diagonal"].astype(np.int64)
    a = np.concatenate([cell[:, :-1].ravel(), cell[:-1, :].ravel(), top_left + flip])
    b = np.concatenate([cell[:, 1:].ravel(), cell[1:, :].ravel(), top_left + cols + 1 - flip])
    both = occ[a] & occ[b]
    a, b = a[both], b[both]
    occ_id = np.cumsum(occ) - 1
    n_occ = int(occ.sum())
    ca, cb = occ_id[a], occ_id[b]
    mat = coo_matrix((d["tree_key"].astype(np.float64), (ca, cb)), shape=(n_occ, n_occ))
    tree = minimum_spanning_tree(mat.tocsr()).tocoo()
    lo, hi = np.minimum(tree.row, tree.col), np.maximum(tree.row, tree.col)
    pair = ca * n_occ + cb
    by_pair = np.argsort(pair)
    tree_links = by_pair[np.searchsorted(pair, lo * n_occ + hi, sorter=by_pair)]
    count, label = connected_components(tree, directed=False)
    sizes = np.bincount(label, minlength=count)
    least = np.full(count, n_occ)
    np.minimum.at(least, label, np.arange(n_occ))
    best = max(range(count), key=lambda c: (sizes[c], -least[c]))
    keep = label == best
    n = int(keep.sum())
    in_tree = np.zeros(ca.size, dtype=bool)
    in_tree[tree_links] = True
    spare = np.nonzero(~in_tree & keep[ca] & keep[cb])[0]
    extra = int(round(EDGES_PER_VERTEX * n)) - (n - 1)
    pick = spare[np.argsort(d["extra_key"][spare], kind="stable")[:extra]]
    links = np.concatenate([tree_links[keep[ca[tree_links]]], pick])
    new_id = np.cumsum(keep) - 1
    u, v = new_id[ca[links]], new_id[cb[links]]
    order = np.argsort(u * n + v)
    u, v, la, lb = u[order], v[order], a[links][order], b[links][order]
    dx = (lb % cols) * roads.CELL + d["jx"][lb] - (la % cols) * roads.CELL - d["jx"][la]
    dy = (lb // cols) * roads.CELL + d["jy"][lb] - (la // cols) * roads.CELL - d["jy"][la]
    w = np.maximum(np.round(np.sqrt((dx * dx + dy * dy).astype(np.float64))), 1)
    return n, u, v, w.astype(np.int64)


@pytest.mark.parametrize("seed", [3, 2**31 + 7, 2**45 + 1])
def test_the_generator_equals_its_numpy_form(seed):
    rows, cols = 70, 110
    draws = roads.draw(rows, cols, occupancy=0.65, seed=seed)
    n, u, v, w = roads.assemble(rows, cols, draws, edges_per_vertex=EDGES_PER_VERTEX)
    n2, u2, v2, w2 = _numpy_form(rows, cols, draws)
    assert n == n2
    np.testing.assert_array_equal(u.numpy(), u2)
    np.testing.assert_array_equal(v.numpy(), v2)
    np.testing.assert_array_equal(w.numpy(), w2)


def test_the_generator_is_canonical_connected_and_repeats_by_seed():
    def make(seed, stream=0):
        return roads.road_network(*SMALL_LATTICE, occupancy=0.65,
                                  edges_per_vertex=EDGES_PER_VERTEX, seed=seed, stream=stream)

    n, u, v, w = make(2**33 + 9)
    assert all(t.dtype == torch.int64 for t in (u, v, w))
    assert bool((u < v).all()) and int(v.max()) < n
    key = u * n + v
    assert bool((key[1:] > key[:-1]).all())  # sorted by (u, v), no pair twice
    assert 2.40 <= 2 * u.numel() / n <= 2.48
    assert 1 <= int(w.min()) and int(w.max()) < 2 * 1.5 * roads.CELL < 1 << 22
    mat = coo_matrix((np.ones(u.numel()), (u.numpy(), v.numpy())), shape=(n, n))
    assert connected_components(mat, directed=False)[0] == 1
    assert int(roads.components(n, u, v).unique().numel()) == 1
    n2, u2, v2, w2 = make(2**33 + 9)
    assert n2 == n and torch.equal(u, u2) and torch.equal(v, v2) and torch.equal(w, w2)
    for other in (make(2**33 + 10), make(2**33 + 9, stream=1)):
        assert other[0] != n or not torch.equal(other[1], u)


def test_components_name_each_piece_by_its_least_vertex():
    u = torch.tensor([5, 1, 2, 6, 3], dtype=torch.int64)
    v = torch.tensor([7, 4, 4, 8, 6], dtype=torch.int64)
    assert roads.components(9, u, v).tolist() == [0, 1, 1, 3, 1, 5, 3, 5, 3]


# ----------------------------------------------------------------------
# The cell
# ----------------------------------------------------------------------
def _run(bench, *, trace, seed=2**33 + 21, seconds=1.0):
    spec = harness.load_spec(os.path.dirname(bench))
    return harness.run_cell(spec, CELL, seed=seed, seconds=seconds, trace=trace,
                            device="cpu", t_start=0.0, bench_dir=bench)


def test_the_cell_runs_correct_untraced_and_traced(road_bench):
    spec = harness.load_spec(os.path.dirname(road_bench))
    cell = harness.find_cell(spec, CELL, road_bench)
    line, checks = _run(road_bench, trace=False)
    assert line["correct"] and checks == {"forest_mismatch": (0, 0)}
    assert set(line["metrics"]) == {"solve_edges_per_s", "setup_s"}
    assert line["attempted"] >= 1 and list(line)[-1] == "checks"
    line, checks = _run(road_bench, trace=True)
    assert line["correct"] and checks == {"forest_mismatch": (0, 0)}
    listed = {m["name"] for m in cell.per_layer}
    assert {"replay_s.solve", "host_reads.solve"} <= listed
    assert set(line["metrics"]) == listed - CARD_ONLY
    assert line["metrics"]["host_reads.solve"]["value"] > 0
    assert line["metrics"]["replay_s.solve"]["value"] > 0


def test_a_solve_off_the_l2_route_raises(road_bench, monkeypatch):
    from distributed_ghs_implementation_tpu_torch.models import rank_solver

    monkeypatch.setattr(rank_solver, "use_l2_path", lambda family: False)
    with pytest.raises(RuntimeError, match="host-L2 route"):
        _run(road_bench, trace=False)


def test_an_altered_forest_fails(road_bench, monkeypatch):
    from distributed_ghs_implementation_tpu_torch import api

    real = api.minimum_spanning_forest

    def altered(graph, **kw):
        result = real(graph, **kw)
        result.edge_ids = result.edge_ids[1:]
        return result

    monkeypatch.setattr(api, "minimum_spanning_forest", altered)
    line, checks = _run(road_bench, trace=False)
    assert not line["correct"] and checks["forest_mismatch"][0] >= line["attempted"]


def test_the_control_reads_above_the_limit(road_bench, monkeypatch):
    import importlib.util

    spec_file = importlib.util.spec_from_file_location(
        "road_control_copy", os.path.join(road_bench, "road_control.py"))
    control = importlib.util.module_from_spec(spec_file)
    spec_file.loader.exec_module(control)
    spec = harness.load_spec(os.path.dirname(road_bench))
    cell = harness.find_cell(spec, CELL, road_bench)
    for seed in (11, 12, 13):
        reading = control.road_control(cell, seed, "cpu")
        assert reading["forest_edges"] == reading["vertices"] - 1
        assert reading["forest_mismatch"] > 100 * cell.config["checks"]["forest_mismatch"] + 100


def test_the_cell_is_new_files_alone(tmp_path):
    """The benchmark without the road cell, then the road cell's files and
    entries added: the cell runs, and no file that was there changes."""
    dest = str(tmp_path)
    bench = os.path.join(dest, "ghs_bench")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", *[os.path.basename(f) for f in ROAD_FILES]))
    spec = harness.load_spec()
    json.dump(_spec_without_the_road_cell(spec), open(os.path.join(dest, "BENCHMARK.json"), "w"))
    before = _digests(bench)
    assert set(before).isdisjoint(ROAD_FILES)
    for f in ROAD_FILES:
        shutil.copy(os.path.join(harness.BENCH_DIR, f), os.path.join(bench, f))
    json.dump(spec, open(os.path.join(dest, "BENCHMARK.json"), "w"))
    _shrink(bench)
    line, _ = _run(bench, trace=False)
    assert line["correct"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == ROAD_FILES
