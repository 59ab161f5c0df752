"""The port's sharded solvers across processes, on the CPU.

Two processes bring up a gloo group through ``parallel.multihost`` over a
file store under the test's temporary directory (no ports), each holding 2
CPU shards of a 4-shard mesh, and solve the dryrun fixtures ER(48) and
RMAT-12 through ``ell``, ``rank``, ``auto``, the filtered and the split-key
programs (``torch_multihost_child.py``). Every process must give the JAX
package's result on its 8-device mesh: the same sorted edge ids, fragments
and levels. The checkpointed sharded solve writes on the primary only and
resumes through ``broadcast_resume_state``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import native as jnative
from distributed_ghs_implementation_tpu.parallel import rank_sharded as jrsh
from distributed_ghs_implementation_tpu.parallel import sharded as jsh
from torch_inputs import DECK

_CHILD = os.path.join(os.path.dirname(__file__), "torch_multihost_child.py")
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    init_file = str(tmp / "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, _CHILD, init_file, "2", str(i), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a multihost child timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\nstdout={out}\nstderr={err}"
    recs = []
    for i in range(2):
        with open(tmp / f"proc{i}.json") as f:
            recs.append(json.load(f))
    return recs, tmp


def _jax(name, mode, monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    kw = {"use_native": False} if name.startswith("rmat") else {}
    g = DECK[name](jgen, **kw)
    if mode == "filtered":
        out = jrsh.solve_graph_rank_sharded(g, filtered=True)
    elif mode == "rank64":
        out = jrsh.solve_graph_rank_sharded(g, rank64=True)
    else:
        out = jsh.solve_graph_sharded(g, strategy=mode)
    return [np.asarray(out[0]).tolist(), np.asarray(out[1]).tolist(), int(out[2])]


def test_group_layout_and_primary(records):
    recs, _ = records
    assert [(r["process_index"], r["process_count"], r["size"], r["first_shard"], r["backend"])
            for r in recs] == [(0, 2, 4, 0, "gloo"), (1, 2, 4, 2, "gloo")]
    assert [r["is_primary"] for r in recs] == [True, False]


@pytest.mark.parametrize("mode", ["ell", "rank", "auto", "filtered", "rank64"])
@pytest.mark.parametrize("name", ["er48", "rmat12"])
def test_two_processes_match_jax(records, monkeypatch, name, mode):
    recs, _ = records
    want = _jax(name, "ell" if mode == "auto" else mode, monkeypatch)
    for r in recs:
        assert r["solves"][name][mode] == want


@pytest.mark.parametrize("name", ["er48", "rmat12"])
def test_checkpoint_on_the_primary_and_resume(records, monkeypatch, name):
    recs, tmp = records
    want = _jax(name, "rank", monkeypatch)
    for r in recs:
        assert r["solves"][name]["flat_refused"] is True
        assert r["solves"][name]["ckpt"] == want
        assert r["solves"][name]["ckpt_resume"] == want
    assert sorted(p for p in os.listdir(tmp) if p.startswith("ckpt-") and p.endswith(".npz")) == [
        "ckpt-er48.npz", "ckpt-rmat12.npz"]


def test_broadcast_resume_state(records):
    recs, _ = records
    for r in recs:
        assert r["broadcast"] == [[0, 1, 2, 3, 4], [True, False, True], 7]
        assert r["broadcast_none"] is True and r["abort"] is True
        assert r["empty"] == [[], [0, 1, 2, 3], 0]


def test_initialize_needs_the_group_described(monkeypatch):
    """Without a process count, an id and an address, ``initialize`` raises
    before it touches ``torch.distributed``; one process is the primary and
    its broadcasts return what they were given."""
    from distributed_ghs_implementation_tpu_torch.parallel import multihost

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="process count"):
        multihost.initialize(device="cpu")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize(device="cpu")
    assert multihost.is_primary()
    state = (np.arange(3, dtype=np.int32), np.ones(2, dtype=bool), 4)
    assert multihost.broadcast_resume_state(state) is state
    assert multihost.broadcast_resume_state(state, error=True) is None
