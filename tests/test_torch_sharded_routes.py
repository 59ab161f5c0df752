"""The port's sharded rank routes (``parallel/rank_sharded.py``) against the
JAX package's, on the CPU: the capacity guard, the two-step filter, the
filtered policy with a censused prefix, the chunk hooks with their
``mask_fn``, and resumes from sharded checkpoints made by either package
(or by the single-card solve). The JAX side runs on 8 of the virtual CPU
devices of ``tests/conftest.py``, the port on 8 CPU shards; thresholds are
lowered on both sides alike. The families through every strategy, too. The
fixtures through every strategy are in
``test_torch_sharded.py``.
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.parallel import mesh as jmesh
from distributed_ghs_implementation_tpu.parallel import rank_sharded as jrsh
from distributed_ghs_implementation_tpu.parallel import sharded as jsh
from distributed_ghs_implementation_tpu.utils import checkpoint as jck
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.parallel import mesh as tmesh
from distributed_ghs_implementation_tpu_torch.parallel import rank_sharded as trsh
from distributed_ghs_implementation_tpu_torch.parallel import sharded as tsh
from distributed_ghs_implementation_tpu_torch.utils import checkpoint as tck
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from test_torch_sharded import _both, _meshes, _same, _solve
from torch_pairs import CPU, isolated, pair  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.mark.parametrize("strategy", ["auto", "flat", "ell", "rank"])
def test_auto_and_families_match_jax(strategy):
    for name in ("rmat", "grid", "road", "forest"):
        jg, tg = pair(name)
        _both(strategy, jg, tg, 8)


def test_unknown_strategy_raises_in_both():
    jg, tg = pair("road")
    with pytest.raises(ValueError, match="unknown strategy"):
        jsh.solve_graph_sharded(jg, strategy="nope")
    with pytest.raises(ValueError, match="unknown strategy"):
        tsh.solve_graph_sharded(tg, strategy="nope", device=CPU)


# ---------------------------------------------------------------------------
# The capacity guard, the two-step filter, the filtered policy, the census
# ---------------------------------------------------------------------------


def _lower(monkeypatch, **values):
    for name, value in values.items():
        for mod in (jrsh, trsh, jrs, trs):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)


@pytest.mark.parametrize("mode", ["rank-plain", "rank64", "filtered"])
@pytest.mark.parametrize("name", ["road", "grid", "rmat"])
def test_capacity_guard_and_two_step_filter_match_jax(monkeypatch, name, mode):
    """A gather budget of 64 slots a shard: the guard's in-place levels run
    before the finish, and the filter's fused compaction overflows to the
    two-step filter."""
    _lower(monkeypatch, _FINISH_GATHER_MAX_SLOTS=512)
    jg, tg = pair(name)
    _both(mode, jg, tg, 8)


@pytest.mark.parametrize("name", ["rmat11", "rmat"])
def test_filtered_policy_and_census_match_jax(monkeypatch, name):
    """Dense graphs at a lowered filter width take the filtered route by
    policy; a lowered census size shrinks the prefix's fragment space."""
    _lower(monkeypatch, _FILTER_MIN_RANKS=1024, _CENSUS_MIN_SPACE=64, _SHRINK_MIN_SPACE=64,
           _ONE_SHOT_MAX_SLOTS=0)
    jg, tg = pair(name)
    _both("rank-plain", jg, tg, 8)
    _both("rank-plain", jg, tg, 2)


def test_rank64_rejects_what_jax_rejects(monkeypatch):
    jg, tg = pair("rmat")  # 1,024 vertices, 8,192 ranks a shard over 2
    for mod in (jrsh, trsh):
        monkeypatch.setattr(mod, "_INT32_RANK_LIMIT", 2048)
    with pytest.raises(ValueError, match="per-shard rank block"):
        jrsh.solve_graph_rank_sharded(jg, mesh=jmesh.edge_mesh(num_devices=2), rank64=True)
    with pytest.raises(ValueError, match="per-shard rank block"):
        trsh.solve_graph_rank_sharded(tg, mesh=tmesh.edge_mesh(num_shards=2, device=CPU),
                                      rank64=True)


def test_kernel_argument_takes_the_meshs_label():
    tg = pair("road")[1]
    mesh = tmesh.edge_mesh(num_shards=2, device=CPU)
    ids = trsh.solve_graph_rank_sharded(tg, mesh=mesh, kernel="torch")[0]
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(tg))
    with pytest.raises(ValueError, match="does not run on this mesh"):
        trsh.solve_graph_rank_sharded(tg, mesh=mesh, kernel="cuda")


# ---------------------------------------------------------------------------
# Chunk hooks and resumes
# ---------------------------------------------------------------------------


def _hook_trail(side, graph, mesh, mode, *, keep=None):
    """Every hook call: ``(level, fragment, mask, count)`` with the mask
    from ``mask_fn`` (called at every boundary)."""
    trail = []

    def on_chunk(level, fragment, mask_fn, count):
        frag = fragment.cpu().numpy() if isinstance(fragment, torch.Tensor) else np.asarray(
            fragment)
        trail.append((int(level), frag.copy(), np.array(mask_fn(), dtype=bool), int(count)))

    result = _solve(mode, side, graph, mesh, on_chunk=on_chunk)
    return result, trail


@pytest.mark.parametrize("mode", ["rank-plain", "filtered", "rank64"])
@pytest.mark.parametrize("name", ["road", "rmat11"])
def test_on_chunk_with_mask_fn_matches_jax(monkeypatch, name, mode):
    """A hook at every capacity-guard level (and through a censused prefix
    on the filtered route): the same boundaries, fragments, whole masks and
    counts."""
    _lower(monkeypatch, _FINISH_GATHER_MAX_SLOTS=512, _CENSUS_MIN_SPACE=64,
           _SHRINK_MIN_SPACE=64, _ONE_SHOT_MAX_SLOTS=0, _GUARD_CHECKPOINT_EVERY=1)
    jg, tg = pair(name)
    jm, tm = _meshes(8)
    want, jtrail = _hook_trail("jax", jg, jm, mode)
    got, ttrail = _hook_trail("port", tg, tm, mode)
    _same(got, want)
    assert len(ttrail) == len(jtrail) >= 2
    for (tl, tf, tmask, tc), (jl, jf, jmask, jc) in zip(ttrail, jtrail):
        assert (tl, tc) == (jl, jc)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tmask, jmask)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("name", ["road", "rmat11", "grid"])
def test_sharded_checkpoint_resumes_across_packages(tmp_path, monkeypatch, name, direction):
    """The state at a mid-solve chunk boundary (the head's on the dense
    graph, whose one guard level ends the solve; else the first guard
    level's), saved by one package's
    ``save_checkpoint`` with the whole mask from ``mask_fn``, resumes in the
    other's sharded solve (and in the saving package's) to the same
    answer, and to the uninterrupted solve's forest."""
    _lower(monkeypatch, _FINISH_GATHER_MAX_SLOTS=512, _GUARD_CHECKPOINT_EVERY=1)
    jg, tg = pair(name)
    jm, tm = _meshes(8)
    path = str(tmp_path / "c.npz")
    src = "jax" if direction == "jax-to-port" else "port"
    ck = jck if src == "jax" else tck
    graph, mesh = (jg, jm) if src == "jax" else (tg, tm)
    seen = []

    def on_chunk(level, fragment, mask_fn, count):
        seen.append(level)
        if len(seen) == (1 if name == "rmat11" else 2):
            ck.save_checkpoint(path, fragment, mask_fn(), level,
                               fingerprint=ck.graph_fingerprint(graph))

    full = _solve("rank-plain", src, graph, mesh, on_chunk=on_chunk)
    state = tck.load_checkpoint(path)
    assert state[2] < full[2]
    want = jrsh.solve_graph_rank_sharded(jg, mesh=jm, initial_state=state)
    got = trsh.solve_graph_rank_sharded(tg, mesh=tm, initial_state=state)
    _same(got, want)
    np.testing.assert_array_equal(got[0], full[0])
    # The checkpointed sharded solves take the file up where it stands.
    a = tck.solve_graph_checkpointed_sharded(tg, path, mesh=tm)
    np.testing.assert_array_equal(a[0], full[0])


def test_a_single_card_checkpoint_resumes_sharded(tmp_path):
    """A checkpoint of the single-card rank solve restores into the sharded
    solve (the same file format), as in the JAX package."""
    jg, tg = pair("grid")
    path = str(tmp_path / "one.npz")
    seen = []

    def on_chunk(level, fragment, mst, count):
        seen.append(level)
        if len(seen) == 1:
            tck.save_checkpoint(path, fragment, mst, level,
                                fingerprint=tck.graph_fingerprint(tg))

    trs.make_production_solver(tg, device=CPU)(on_chunk=on_chunk)
    state = tck.load_checkpoint(path)
    jm, tm = _meshes(8)
    want = jrsh.solve_graph_rank_sharded(jg, mesh=jm, initial_state=state)
    got = trsh.solve_graph_rank_sharded(tg, mesh=tm, initial_state=state)
    _same(got, want)
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(tg))
