"""The port's chaos drill (``utils/chaos.py``) and failure diagnostics
(``utils/diagnostics.py``) against the JAX package's, on the CPU.

The drill's report must equal JAX's case for case: the lossy-channel
matrix's weights, oracle weights, channel ``stats`` and ``channel_totals``,
the supervisor drill's incident trails, the checkpoint drill's recovery.
Taken out before comparing: the incidents' ``elapsed_s`` (wall times) and
the temporary directory in checkpoint paths. The port's solver and
checkpoint legs run on ``device="cpu"`` (the kernels' plain versions); its
oracle is SciPy's where JAX's is NetworkX, and both give the same weights.
"""

import contextlib
import json
import re

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu import protocol as jproto
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.utils import chaos as jchaos
from distributed_ghs_implementation_tpu.utils import diagnostics as jdiag
from distributed_ghs_implementation_tpu.utils import verify as jverify
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch import protocol as tproto
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.utils import chaos as tchaos
from distributed_ghs_implementation_tpu_torch.utils import diagnostics as tdiag
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres
from distributed_ghs_implementation_tpu_torch.utils import verify as tverify
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")


def _normalized(cases, workdir):
    """Cases as JSON-comparable data with wall times and the drill's
    temporary directory under ``workdir`` taken out."""
    text = re.sub(re.escape(str(workdir)) + r"/[^/]+", "<tmp>", json.dumps(cases, sort_keys=True))
    out = json.loads(text)
    for case in out:
        for incident in case.get("incidents", []):
            incident.pop("elapsed_s")
    return out


def _legs(side, workdir):
    if side == "jax":
        return {"protocol": lambda: jchaos._protocol_cases(True),
                "solver": lambda: jchaos._solver_cases(True),
                "checkpoint": lambda: jchaos._checkpoint_cases(True, workdir=str(workdir))}
    return {"protocol": lambda: tchaos._protocol_cases(True),
            "solver": lambda: tchaos._solver_cases(True, resolve_device(CPU)),
            "checkpoint": lambda: tchaos._checkpoint_cases(True, resolve_device(CPU),
                                                          workdir=str(workdir))}


@pytest.mark.parametrize("leg", ["protocol", "solver", "checkpoint"])
def test_drill_leg_equals_jax_case_for_case(tmp_path, leg):
    got = {}
    for side in ("jax", "port"):
        workdir = tmp_path / side
        workdir.mkdir()
        with pytest.warns(RuntimeWarning) if leg == "checkpoint" else contextlib.nullcontext():
            cases = _legs(side, workdir)[leg]()
        got[side] = _normalized(cases, workdir)
    assert got["port"] == got["jax"]
    assert got["port"] and all(c["ok"] for c in got["port"])
    if leg == "protocol":
        assert len(got["port"]) == 12
        assert all(c["stats"]["dropped"] > 0 for c in got["port"] if c["spec"]["drop"])


def test_fast_drill_report_equals_jax(tmp_path):
    reports = {}
    for side, run, kw in (("jax", jchaos.run_chaos_drill, {}),
                          ("port", tchaos.run_chaos_drill, {"device": CPU})):
        workdir = tmp_path / side
        workdir.mkdir()
        with pytest.warns(RuntimeWarning):
            report = run(fast=True, workdir=str(workdir), **kw)
        report["cases"] = _normalized(report["cases"], workdir)
        reports[side] = report
    assert reports["port"] == reports["jax"]
    port = reports["port"]
    assert port["ok"] and port["schema"] == "ghs-chaos-report-v1"
    assert {c["kind"] for c in port["cases"]} == {"protocol", "solver", "checkpoint"}
    assert port["channel_totals"]["retransmits"] > 0


def test_drill_needs_a_device():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchaos.run_chaos_drill(fast=True, include_solver=False)


def test_a_crashed_supervisor_case_is_reported_not_raised(monkeypatch):
    class Boom(tres.Supervisor):
        def solve(self, graph, *, entry="device", device=None):
            raise tres.SupervisorExhausted("boom", tres.IncidentLog())

    monkeypatch.setattr(tres, "Supervisor", Boom)
    cases = tchaos._solver_cases(True, resolve_device(CPU))
    assert cases and all(c["ok"] is False for c in cases)
    assert all("SupervisorExhausted" in c["error"] for c in cases)


def test_emit_report_and_main(tmp_path, capsys):
    out = str(tmp_path / "report.json")
    assert tchaos.main(["--no-solver", "--device", "cpu", "--output", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] and report["num_cases"] == 12
    assert "chaos drill: 12/12 ok" in capsys.readouterr().err
    report["cases"][0]["ok"] = report["ok"] = False
    assert tchaos.emit_report(report) == 1
    err = capsys.readouterr().err
    assert "FAILED: protocol/simple" in err and "11/12 ok" in err


def _wrong_results():
    """The same forced wrong result in both packages: the protocol's forest
    of ER(40) with its heaviest edge dropped, and each package's node map."""
    out = {}
    for side, api, proto, gen, verify in (("jax", japi, jproto, jgen, jverify),
                                          ("port", tapi, tproto, tgen, tverify)):
        g = gen.erdos_renyi_graph(40, 0.12, seed=101)
        kw = {} if side == "jax" else {"device": CPU}
        r = api.minimum_spanning_forest(g, backend="protocol", **kw)
        heaviest = int(np.argmax(g.w[r.edge_ids]))
        r.edge_ids = np.delete(r.edge_ids, heaviest)
        nodes, _ = proto.run_protocol(g)
        out[side] = (r, verify.verify_result(r, oracle="scipy"), nodes)
    return out


@pytest.mark.parametrize("with_nodes", [True, False])
def test_failure_report_equals_jax(with_nodes):
    got = {}
    for side, (r, v, nodes) in _wrong_results().items():
        diag = jdiag if side == "jax" else tdiag
        got[side] = diag.failure_report(r, v, nodes=nodes if with_nodes else None)
    assert got["port"] == got["jax"]
    report = got["port"]
    assert report["verification"]["ok"] is False
    assert report["edges"]["alive_inter_fragment"] > 0
    if with_nodes:
        assert report["protocol"]["edge_state_totals"]["BRANCH"] > 0
        assert len(report["protocol"]["nodes"]) == 40
    else:
        assert "protocol" not in report


def test_dump_failure_report_writes_jax_bytes(tmp_path):
    blobs = {}
    for side, (r, v, nodes) in _wrong_results().items():
        diag = jdiag if side == "jax" else tdiag
        path = diag.dump_failure_report(r, v, nodes=nodes, path=str(tmp_path / f"{side}.json"))
        with open(path) as f:
            blobs[side] = f.read()
    assert blobs["port"] == blobs["jax"]
