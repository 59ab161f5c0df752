"""``correct`` comes out true on sound runs and false, with everything else
of a run driven as on the card, when the timed path is broken underneath:
an answer altered where it is produced, a step that returns its state
unchanged. The cell has no batch to halve and no exchange between chips.
The configuration's control is in ``test_ghsbench_reference.py``."""

import numpy as np


def test_sound_runs_are_correct(small_bench, run_small):
    for trace in (False, True):
        line, checks = run_small(small_bench, "rmat24-fresh", seconds=0.5, trace=trace)
        assert line["correct"], line
        assert all(value == 0 for value, _ in checks.values())
        assert list(line)[-1] == "checks"


def test_an_altered_forest_fails(small_bench, run_small, monkeypatch):
    from distributed_ghs_implementation_tpu_torch import api

    real = api.minimum_spanning_forest

    def altered(graph, **kw):
        result = real(graph, **kw)
        result.edge_ids = result.edge_ids[1:]
        return result

    monkeypatch.setattr(api, "minimum_spanning_forest", altered)
    line, checks = run_small(small_bench, "rmat24-fresh", seconds=0.5)
    assert not line["correct"] and checks["forest_mismatch"][0] >= line["attempted"]


def test_a_solve_that_leaves_its_state_unchanged_fails(small_bench, run_small, monkeypatch):
    from distributed_ghs_implementation_tpu_torch.models import boruvka

    def unchanged(graph, **kw):
        return np.zeros(0, dtype=np.int64), np.arange(graph.num_nodes, dtype=np.int32), 0

    monkeypatch.setattr(boruvka, "solve_graph", unchanged)
    line, _ = run_small(small_bench, "rmat24-fresh", seconds=0.5)
    assert not line["correct"]
