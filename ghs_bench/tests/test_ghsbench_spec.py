"""``BENCHMARK.json`` against the benchmark's contract: names and units in
the allowed characters, the keys each entry may have, every file present,
the bounds and the run length inside their limits."""

import json
import os
import re

import pytest

from ghs_bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for entry in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry


def test_names_and_units():
    names = []
    for section in KEYS:
        for entry in SPEC[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_command_and_paths():
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(word) for word in cmd)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert os.path.exists(os.path.join(harness.ROOT, word))
    for root, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.BENCH_DIR)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    assert 1 <= len(SPEC["workloads"]) <= 24 and 1 <= len(configs) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        cell = harness.find_cell(SPEC, w["name"])
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                           cell.config["driver"] + ".py"))
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(harness.BENCH_DIR, "layer_metrics",
                                               m["name"] + ".py"))


def test_metrics_each_cell_reports():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        cell = harness.find_cell(SPEC, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in SPEC["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                assert m["moves"] in names, (m["name"], w["name"])
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_length_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
