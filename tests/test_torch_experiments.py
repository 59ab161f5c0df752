"""The port's experiment suite and reporting against the JAX package's, on
the CPU.

``run_suite`` runs the reference's six configurations and the three
extended ones in both packages; the records must be equal but for the
times and the port's ``oracle`` key (the port's oracle is SciPy's rank
forest, the JAX package's NetworkX up to 200,000 edges). The reporting
functions give JAX's keys and JAX's table. Where the port is stricter on
purpose it is pinned here: a forest of the right weight but not the exact
one is not correct.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu import experiments as jexp
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.utils import reporting as jrep
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch import cli as tcli
from distributed_ghs_implementation_tpu_torch import experiments as texp
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.utils import reporting as trep
from torch_pairs import isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")

TIMES = ("execution_time",)


def _quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        got = fn(*args, **kw)
    return got, out.getvalue()


def test_configs_are_jaxs():
    assert texp.REFERENCE_CONFIGS == jexp.REFERENCE_CONFIGS
    assert texp.EXTENDED_CONFIGS == jexp.EXTENDED_CONFIGS


def test_extended_suite_records_equal_jax(tmp_path):
    """``experiments --extended``: 9 records, all correct, equal to JAX's
    but the times and ``oracle``; the JSON file holds what was returned."""
    records = {}
    for side, mod, kw in (("jax", jexp, {}), ("port", texp, {"device": "cpu"})):
        path = tmp_path / f"{side}.json"
        got, _ = _quiet(mod.run_suite, extended=True, output_json=str(path), **kw)
        assert json.loads(path.read_text()) == got
        records[side] = got
    assert len(records["port"]) == 9 and all(r["is_correct"] for r in records["port"])
    assert {r.pop("oracle") for r in records["port"]} == {"scipy-rank"}
    for side in records:
        for r in records[side]:
            for key in TIMES:
                assert r.pop(key) >= 0
    assert records["port"] == records["jax"]


def test_experiments_cli_exit_codes(tmp_path, monkeypatch):
    """Exit 0 when every record is correct, 1 when one is not, as JAX."""
    out = tmp_path / "exp.json"
    argv = ["experiments", "--output", str(out)]
    rc, _ = _quiet(tcli.main, argv + ["--device", "cpu"])
    assert rc == 0 and len(json.loads(out.read_text())) == 6
    monkeypatch.chdir(tmp_path)
    real = tapi.minimum_spanning_forest

    def drop_one_edge(graph, **kw):
        result = real(graph, **kw)
        result.edge_ids = result.edge_ids[1:]
        return result

    monkeypatch.setattr(texp, "minimum_spanning_forest", drop_one_edge)
    rc, _ = _quiet(tcli.main, argv + ["--device", "cpu"])
    assert rc == 1
    records = json.loads(out.read_text())
    assert not any(r["is_correct"] for r in records)
    assert all(r["failure_report"] == f"experiment_{r['experiment']}_failure_report.json"
               and (tmp_path / r["failure_report"]).is_file() for r in records)


def _tied_square(mod):
    """A 4-cycle of equal weights: four spanning trees of the same weight."""
    return mod.Graph.from_arrays(4, np.array([0, 1, 2, 0]), np.array([1, 2, 3, 3]),
                                 np.array([5, 5, 5, 5]))


def test_right_weight_wrong_forest_is_not_correct(tmp_path, monkeypatch):
    """The port holds a record to the exact forest (``rank_oracle_edge_ids``);
    JAX checks the weight and the edge count only, so it passes the same
    wrong tree. The port's failed record dumps its failure report."""
    monkeypatch.chdir(tmp_path)
    wrong = np.array([1, 2, 3])  # the rank forest is edges 0, 1, 2
    results = {}
    for side, api, mod, edge, kw in (("jax", japi, jexp, jedge, {}),
                                     ("port", tapi, texp, tedge, {"device": "cpu"})):
        real = api.minimum_spanning_forest

        def fake(graph, _real=real, **k):
            result = _real(graph, **k)
            result.edge_ids = wrong
            return result

        monkeypatch.setattr(mod, "minimum_spanning_forest", fake)
        results[side] = mod.run_experiment(_tied_square(edge), 7, **kw)
    assert results["jax"]["is_correct"] and not results["port"]["is_correct"]
    assert results["port"]["ghs_weight"] == results["port"]["nx_weight"] == 15
    report = json.loads((tmp_path / results["port"]["failure_report"]).read_text())
    assert report["verification"]["oracle"] == "scipy-rank"


def test_reporting_equals_jax(tmp_path):
    """``result_to_dict``, ``experiment_record``, the two JSON writers and
    the summary table: JAX's keys, values and text."""
    jg, tg = _tied_square(jedge), _tied_square(tedge)
    jres = japi.minimum_spanning_forest(jg)
    tres = tapi.minimum_spanning_forest(tg, device="cpu")
    for res in (jres, tres):
        res.wall_time_s = 0.25
    jd, td = jrep.result_to_dict(jres), trep.result_to_dict(tres)
    assert td == jd and list(td) == list(jd)
    assert trep.experiment_record(tres, 15, 3) == jrep.experiment_record(jres, 15, 3)
    for name, writer, arg in (("result", "write_result_json", (tres, jres)),
                              ("records", "write_experiments_json", None)):
        tpath, jpath = tmp_path / f"t_{name}.json", tmp_path / f"j_{name}.json"
        if arg is None:
            recs = [trep.experiment_record(tres, 15, 1), trep.experiment_record(tres, 14, 2)]
            getattr(trep, writer)(recs, str(tpath))
            getattr(jrep, writer)(recs, str(jpath))
        else:
            getattr(trep, writer)(arg[0], str(tpath))
            getattr(jrep, writer)(arg[1], str(jpath))
        assert tpath.read_bytes() == jpath.read_bytes()
    recs = [trep.experiment_record(tres, 15, 1), trep.experiment_record(tres, 14, 2)]
    _, tout = _quiet(trep.print_summary_table, recs)
    _, jout = _quiet(jrep.print_summary_table, recs)
    assert tout == jout and "1/2 experiments passed" in tout


def test_suite_needs_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(texp.run_suite, output_json=None)
    with pytest.raises(SystemExit):
        _quiet(tcli.main, ["experiments"])
