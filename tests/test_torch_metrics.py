"""The port's per-level metrics against the JAX package's.

``solve_graph_instrumented`` records one ``metrics.level`` event a stepped
level, or a chunk boundary of the rank route, and reads ``SolveMetrics``
back from them. On the same graphs the records must equal JAX's, wall
times aside, and so must the solves' results. ``profiler_trace`` writes a
Chrome trace of a solve through ``torch.profiler``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu.utils import metrics as jmet
from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.utils import metrics as tmet
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_pairs import (  # noqa: F401 -- fixture
    CPU,
    FAMILIES,
    event_trail,
    isolated,
    lower_filter_width,
    pair,
    set_both,
)

pytestmark = pytest.mark.usefixtures("isolated")


def _levels(metrics):
    return [(m.level, m.fragments_before, m.fragments_after, m.edges_alive_after)
            for m in metrics.levels]


def _both(name, strategy):
    jg, tg = pair(name)
    jmark, tmark = JBUS.mark(), TBUS.mark()
    want = jmet.solve_graph_instrumented(jg, strategy=strategy)
    got = tmet.solve_graph_instrumented(tg, strategy=strategy, device=CPU)
    return got, want, (event_trail(TBUS, tmark, port=True),
                       event_trail(JBUS, jmark, port=False)), tg


@pytest.mark.parametrize("strategy", ["stepped", "rank"])
@pytest.mark.parametrize("name", FAMILIES)
def test_solve_metrics_match_jax(name, strategy):
    (got, got_m), (want, want_m), (got_ev, want_ev), tg = _both(name, strategy)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))
    assert _levels(got_m) == _levels(want_m)
    assert (got_m.num_nodes, got_m.num_edges) == (want_m.num_nodes, want_m.num_edges)
    assert got_ev == want_ev
    assert got_m.levels[0].fragments_before == tg.num_nodes
    for a, b in zip(got_m.levels, got_m.levels[1:]):
        assert b.fragments_before == a.fragments_after
    assert got_m.levels[-1].edges_alive_after == 0
    assert got_m.levels[-1].fragments_after == len(np.unique(got[1]))
    if strategy == "stepped":
        assert [m.level for m in got_m.levels] == list(range(1, got[2] + 1))
    assert got_ev[-1] == ("X", "metrics.solve", {"strategy": strategy, "nodes": tg.num_nodes})


@pytest.mark.parametrize("census", [False, True])
def test_rank_metrics_on_the_filter_route_match_jax(monkeypatch, census):
    lower_filter_width(monkeypatch)
    if census:
        set_both(monkeypatch, _CENSUS_MIN_SPACE=64, _SHRINK_MIN_SPACE=64)
    (got, got_m), (want, want_m), (got_ev, want_ev), _ = _both("rmat11", "rank")
    assert _levels(got_m) == _levels(want_m) and len(got_m.levels) >= 3
    assert got[2] == want[2]
    assert got_ev == want_ev
    assert ("X", "solver.rank.solve", {"family": "dense", "chunked": True}) in got_ev


def test_metrics_use_a_private_bus_when_the_global_one_is_off(monkeypatch):
    for bus in (TBUS, JBUS):
        monkeypatch.setattr(bus, "enabled", False)
    jg, tg = pair("grid")
    tmark = TBUS.mark()
    (_, _, levels), got = tmet.solve_graph_instrumented(tg, device=CPU)
    (_, _, _), want = jmet.solve_graph_instrumented(jg)
    assert _levels(got) == _levels(want) and len(got.levels) == levels
    assert TBUS.events_since(tmark) == []  # nothing leaked onto the disabled bus


def test_solve_metrics_json_has_jaxs_schema():
    jg, tg = pair("road")
    got = json.loads(tmet.solve_graph_instrumented(tg, device=CPU)[1].to_json())
    want = json.loads(jmet.solve_graph_instrumented(jg)[1].to_json())
    assert sorted(got) == sorted(want)
    assert [sorted(level) for level in got["levels"]] == [sorted(level) for level in
                                                          want["levels"]]


def test_instrumented_edges_and_errors():
    (ids, frag, levels), metrics = tmet.solve_graph_instrumented(Graph.from_edges(3, []),
                                                                 device=CPU)
    assert ids.size == 0 and frag.tolist() == [0, 1, 2] and levels == 0
    assert metrics.levels == [] and metrics.total_wall_time_s == 0.0
    with pytest.raises(ValueError, match="unknown strategy"):
        tmet.solve_graph_instrumented(pair("rmat")[1], strategy="fused", device=CPU)


def test_instrumented_solve_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for strategy in ("stepped", "rank"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmet.solve_graph_instrumented(pair("rmat")[1], strategy=strategy)


def test_fragment_census_counts_tensors_where_they_are():
    labels = torch.tensor([3, 3, 1, 1, 7, 9], dtype=torch.int32)
    assert tmet._fragment_count(labels, 4) == 2
    assert tmet._fragment_count(labels.numpy(), 6) == 4


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tmet.profiler_trace(log_dir) as path:
        res = minimum_spanning_forest(pair("grid")[1], device=CPU)
    assert res.num_edges > 0 and os.path.dirname(path) == log_dir
    with open(path) as f:
        trace = json.load(f)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)


def test_profiler_trace_is_written_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "trace")
    with pytest.raises(ZeroDivisionError):
        with tmet.profiler_trace(log_dir):
            torch.arange(4).sum()
            raise ZeroDivisionError
    assert len(glob.glob(os.path.join(log_dir, "*.json"))) == 1
