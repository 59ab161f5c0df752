"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files plus ``BENCHMARK.json`` entries; the harness finds
them by name, and no file already there changes."""

import hashlib
import json
import os


def _digests(bench):
    out = {}
    for root, dirs, files in os.walk(bench):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, bench)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(small_bench, run_small):
    before = _digests(small_bench)
    cfg = json.load(open(os.path.join(small_bench, "configs", "graph500-rmat24.json")))
    cfg.update(name="graph500-rmat11", generator=dict(cfg["generator"], scale=11))
    with open(os.path.join(small_bench, "configs", "graph500-rmat11.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(small_bench, "mixes", "rmat-few.json"), "w") as f:
        json.dump({"loop": "closed", "callers": 1, "pool": 40, "warm_scale": 9}, f)
    with open(os.path.join(small_bench, "layer_metrics", "solves.count.py"), "w") as f:
        f.write("def read(record):\n    return float(len(record.solves))\n")
    spec_path = os.path.join(os.path.dirname(small_bench), "BENCHMARK.json")
    spec = json.load(open(spec_path))
    spec["configs"].append({"name": "graph500-rmat11", "source": "https://example.org/x",
                            "file": "ghs_bench/configs/graph500-rmat11.json",
                            "reduced": ["scale"], "why": "a smaller Kronecker graph"})
    spec["workloads"].append({"name": "rmat11-fresh", "config": "graph500-rmat11",
                              "traffic": "rmat-few", "chips": 1, "why": "a new cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "solve_edges_per_s":
            m["workloads"].append("rmat11-fresh")
    spec["per_layer"].append({"name": "solves.count", "unit": "solves", "better": "higher",
                              "source": "host_clock", "layer": "harvest",
                              "moves": "solve_edges_per_s", "workloads": ["rmat11-fresh"]})
    json.dump(spec, open(spec_path, "w"))

    line, _ = run_small(small_bench, "rmat11-fresh", seconds=1.0)
    assert line["correct"] and set(line["metrics"]) == {"solve_edges_per_s", "setup_s"}
    line, _ = run_small(small_bench, "rmat11-fresh", seconds=1.0, trace=True)
    assert line["correct"] and line["metrics"]["solves.count"]["value"] == line["attempted"]
    after = _digests(small_bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/graph500-rmat11.json", "mixes/rmat-few.json",
                                        "layer_metrics/solves.count.py"}
