"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test skips without CUDA (the kernels have no CPU mode). The file
imports neither JAX nor the JAX package, so on the card's machine, where
JAX is not installed, it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.models import boruvka, rank_solver
from distributed_ghs_implementation_tpu_torch.graphs import edgelist, generators
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import (
    DECK,
    FLAT_SHAPES,
    RMAT18_BUCKETS,
    ell_bucket_set,
    ell_inputs,
    forest23,
    hook_forest,
    moe_inputs,
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", FLAT_SHAPES + [(50, 999), (1 << 18, (1 << 20) + 3)])
def test_gather_key_kernel_matches_plain_on_card(cuda, n, e):
    args = [_t(a).to(cuda) for a in moe_inputs(e, n, e)[:4]]
    launches = kernels.gather_key.launches
    got = kernels.gather_key(*args)
    torch.cuda.synchronize()
    assert kernels.gather_key.launches == launches + 1
    for g, w in zip(got, kernels.gather_key_torch(*args)):
        assert torch.equal(g, w)


_THRESHOLD = kernels.HOOK_BLOCK_FORM_THRESHOLD


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 127, 129, 5000, _THRESHOLD - 1, _THRESHOLD,
                               _THRESHOLD + 1, 1 << 18, 1 << 20])
@pytest.mark.parametrize("kind", ["random", "star", "chain"])
def test_hook_compress_kernel_matches_plain_on_card(cuda, n, kind):
    """One launch a round, in the form ``auto`` picks for n; the chain needs
    every jump, so a premature exit shows."""
    args = [_t(a).to(cuda) for a in hook_forest(n, n, kind)]
    launches = kernels.hook_compress.launches
    got = kernels.hook_compress(*args)
    torch.cuda.synchronize()
    assert kernels.hook_compress.launches == launches + 1
    for g, w in zip(got, kernels.hook_compress_torch(*args)):
        assert torch.equal(g, w)
    jumps, form = kernels.hook_compress_readout()
    assert form == ("block" if n <= _THRESHOLD else "grid")
    assert 1 <= jumps <= kernels.num_jumps(n)
    if kind == "chain" and n > 2:
        assert jumps == kernels.num_jumps(n) or 2 ** (jumps - 1) >= n - 1


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["block", "grid"])
@pytest.mark.parametrize("n", [1, 3, 1000, kernels.HOOK_BLOCK_MAX_NODES])
@pytest.mark.parametrize("kind", ["random", "chain", "none", "cycle"])
def test_hook_compress_both_forms_match_plain_on_card(cuda, form, n, kind):
    """Either form on the same inputs; with nothing hooked the first jump
    changes nothing and the round stops there; on cyclic garbage no jump
    reaches a fixpoint, so all num_jumps(n) run, as in the plain version."""
    args = [_t(a).to(cuda) for a in hook_forest(n + 1, n, kind)]
    got = kernels.hook_compress(*args, form=form)
    for g, w in zip(got, kernels.hook_compress_torch(*args)):
        assert torch.equal(g, w)
    jumps, ran = kernels.hook_compress_readout()
    assert ran == form
    if kind == "none":
        assert jumps == 1
    if kind == "cycle" and n > 2:
        assert jumps == kernels.num_jumps(n)


@pytest.mark.gpu
def test_hook_compress_refused_launches_raise_on_card(cuda):
    """A block form too large for shared memory is refused by the launcher,
    and the wrapper raises; nothing runs in another form."""
    n = kernels.HOOK_BLOCK_MAX_NODES + 1
    args = [_t(a).to(cuda) for a in hook_forest(1, n, "random")]
    launches = kernels.hook_compress.launches
    with pytest.raises(RuntimeError, match="hook_compress kernel launch failed"):
        kernels.hook_compress(*args, form="block")
    assert kernels.hook_compress.launches == launches
    with pytest.raises(ValueError, match="form"):
        kernels.hook_compress(*args, form="warp")


def _device_kernels(fn):
    """The device kernels one call of ``fn`` runs, by the profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
def test_k1_and_k3_level_are_one_device_kernel_each_on_card(cuda):
    for n in (5000, 1 << 18):
        args = [_t(a).to(cuda) for a in hook_forest(n, n, "random")]
        names = _device_kernels(lambda: kernels.hook_compress(*args))
        assert len(names) == 1 and "hook_compress" in names[0], names
    fragment, buckets = ell_bucket_set(2, 1 << 12, [(64, 1), (16, 64), (1, 9000)])
    plan = kernels.ell_plan([tuple(_t(a).to(cuda) for a in b) for b in buckets])
    vmin = torch.full((1 << 12,), kernels.INT32_MAX, dtype=torch.int32, device=cuda)
    frag = _t(fragment).to(cuda)
    names = _device_kernels(lambda: kernels.ell_level_min(frag, plan, vmin))
    assert len(names) == 1 and "ell_level" in names[0], names


@pytest.mark.gpu
def test_probe_kernel_reads_three_on_card(cuda):
    table = torch.arange(256, dtype=torch.int32, device=cuda)
    idx = torch.full((2, 128), 3, dtype=torch.int32, device=cuda)
    assert torch.equal(kernels.probe(table, idx), kernels.probe_torch(table, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width", RMAT18_BUCKETS + [(3, 7), (5, 600), (1, 1)])
@pytest.mark.parametrize("fragments", [3, 1 << 18])
def test_ell_row_min_kernel_matches_plain_on_card(cuda, rows, width, fragments):
    args = [_t(a).to(cuda) for a in ell_inputs(rows + width, 1 << 18, rows, width,
                                               fragments=fragments)]
    launches = kernels.ell_row_min.launches
    got = kernels.ell_row_min(*args)
    torch.cuda.synchronize()
    assert kernels.ell_row_min.launches == launches + 1
    assert torch.equal(got, kernels.ell_row_min_torch(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,tile_slots", [
    (RMAT18_BUCKETS, kernels.ELL_TILE_SLOTS),
    (RMAT18_BUCKETS, 1000),
    ([(1, 32768), (3, 5000), (2, 4097)], kernels.ELL_TILE_SLOTS),
    ([(7, 600), (65536, 1), (5, 33), (1, 1), (0, 4)], 64),
])
@pytest.mark.parametrize("fragments", [3, 1 << 18])
def test_ell_level_kernel_matches_plain_on_card(cuda, shapes, tile_slots, fragments):
    """One launch for every bucket of a level, the per-vertex minima folded
    in, against the per-bucket loop and scatter: RMAT-18's shapes, the hub
    row (1, 32,768) and rows wider than the tile."""
    fragment, buckets = ell_bucket_set(len(shapes), 1 << 18, shapes, fragments=fragments)
    plan = kernels.ell_plan([tuple(_t(a).to(cuda) for a in b) for b in buckets],
                            tile_slots=tile_slots)
    frag = _t(fragment).to(cuda)
    launches = kernels.ell_row_min.launches
    got = kernels.ell_level_min(frag, plan, torch.full_like(frag, kernels.INT32_MAX))
    torch.cuda.synchronize()
    assert kernels.ell_row_min.launches == launches + 1
    want = kernels.ell_level_min_torch(frag, plan, torch.full_like(frag, kernels.INT32_MAX))
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_ell_level_refuses_a_plan_on_another_device_on_card(cuda):
    fragment, buckets = ell_bucket_set(4, 64, [(4, 2)])
    plan = kernels.ell_plan([tuple(_t(a) for a in b) for b in buckets])
    frag = _t(fragment).to(cuda)
    with pytest.raises(ValueError, match="the CPU"):
        kernels.ell_level_min(frag, plan, torch.full_like(frag, kernels.INT32_MAX))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 1000, (1 << 24) + 3])
def test_gather_kernel_matches_plain_on_card(cuda, m):
    rng = np.random.default_rng(m)
    table = _t(rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32)).to(cuda)
    idx = _t(rng.integers(0, 1 << 20, m + 1, dtype=np.int32)).to(cuda)
    for view in (idx[:m], idx[1:]):  # 16-byte aligned, and not
        assert torch.equal(kernels.gather(table, view), kernels.gather_torch(table, view))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 7, 8, 9, 15, 17, 1 << 26])
def test_gather_kernel_tails_match_plain_on_card(cuda, m):
    """Sizes around every tail length of the vector body, and the largest
    size, where a 32-bit index would overflow in a persistent grid."""
    rng = np.random.default_rng(m)
    table = _t(rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32)).to(cuda)
    idx = _t(rng.integers(0, 1 << 20, m, dtype=np.int32)).to(cuda)
    assert torch.equal(kernels.gather(table, idx), kernels.gather_torch(table, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("m", [1, 9, 1000, (1 << 20) + 5])
def test_gather_kernel_on_unaligned_views_on_card(cuda, offset, m):
    rng = np.random.default_rng(offset * m)
    table = _t(rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32)).to(cuda)
    view = _t(rng.integers(0, 1 << 20, m + offset, dtype=np.int32)).to(cuda)[offset:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(kernels.gather(table, view), kernels.gather_torch(table, view))


def _wrapper_inputs(name, device):
    """Small valid inputs for each kernel wrapper."""
    if name == "gather_key":
        arrays = moe_inputs(3, 1000, 4096)[:4]
    elif name == "hook_compress":
        arrays = hook_forest(3, 5000, "random")
    elif name == "probe":
        arrays = (np.arange(256, dtype=np.int32), np.full((2, 128), 3, dtype=np.int32))
    elif name == "ell_row_min":
        arrays = ell_inputs(3, 1 << 12, 300, 40)
    elif name == "ell_level_min":
        fragment, buckets = ell_bucket_set(3, 1 << 12, [(300, 40), (2, 5000)])
        plan = kernels.ell_plan([tuple(_t(a).to(device) for a in b) for b in buckets])
        frag = _t(fragment).to(device)
        return [frag, plan, torch.full_like(frag, kernels.INT32_MAX)]
    else:
        rng = np.random.default_rng(3)
        arrays = (rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32),
                  rng.integers(0, 1 << 20, 1 << 20, dtype=np.int32))
    return [_t(a).to(device) for a in arrays]


def _plain(name):
    plain = getattr(kernels, f"{name}_torch")
    if name == "ell_level_min":  # it updates vmin in place: give it a fresh one
        return lambda f, plan, vmin: plain(f, plan, torch.full_like(vmin, kernels.INT32_MAX))
    return plain


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w.__name__ for w in kernels.WRAPPERS] + ["ell_level_min"])
def test_wrappers_launch_on_the_current_stream_on_card(cuda, name):
    """Under ``torch.cuda.stream(side)`` the kernel runs on ``side``: with
    the default stream held busy, synchronising ``side`` alone is enough to
    read the result."""
    kernels._lib()  # binds kernels._current_stream
    args = _wrapper_inputs(name, cuda)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    torch.cuda._sleep(200_000_000)  # keeps the default stream busy for ~0.1 s
    with torch.cuda.stream(side):
        assert kernels._current_stream(args[0].get_device()) == side.cuda_stream
        got = [g.to("cpu", non_blocking=True) for g in _as_tuple(getattr(kernels, name)(*args))]
    side.synchronize()
    want = _as_tuple(_plain(name)(*args))
    for g, w in zip(got, want):
        assert torch.equal(g, w.cpu())


@pytest.mark.gpu
def test_kernel_wrappers_raise_rather_than_fall_back_on_card(cuda):
    """Every wrapper refuses a wrong dtype and a non-contiguous input with a
    CUDA tensor, where the plain version would have taken them."""
    for w in kernels.WRAPPERS:
        args = _wrapper_inputs(w.__name__, cuda)
        last = args[-1]
        wide = args[:-1] + [last.to(torch.int64)]
        with pytest.raises(TypeError, match="int32"):
            w(*wide)
        strided = torch.empty(last.shape[:-1] + (2 * last.shape[-1],), dtype=last.dtype,
                              device=cuda)[..., ::2]
        strided.copy_(last)
        with pytest.raises(ValueError, match="contiguous"):
            w(*args[:-1], strided)
    wide = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_key(wide, wide, wide, wide)
    narrow = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.hook_compress(torch.zeros(16, dtype=torch.bool, device=cuda)[::2], narrow, narrow)
    frag, plan, vmin = _wrapper_inputs("ell_level_min", cuda)
    with pytest.raises(TypeError, match="int32"):
        kernels.ell_level_min(frag, plan, vmin.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ell_level_min(frag, plan, torch.stack((vmin, vmin), 1)[:, 0])
    with pytest.raises(ValueError, match="vmin"):
        kernels.ell_level_min(frag, plan, vmin[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["fused", "stepped", "ell"])
def test_solve_on_card_equals_cpu_and_oracle(cuda, strategy):
    for g in (
        generators.readme_sample_graph(),
        generators.random_road_network(30, 30, seed=4),
        generators.rmat_graph(12, 8, seed=11),
    ):
        got = boruvka.solve_graph(g, strategy=strategy, device=cuda)
        want = boruvka.solve_graph(g, strategy=strategy, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(g))


@pytest.mark.gpu
def test_ell_solve_launches_k3_per_bucket_and_level_on_card(cuda):
    """One K3 launch a level past the identity level, whatever the bucket
    count, and one K1 launch a level."""
    g = generators.rmat_graph(12, 8, seed=11)
    k1, k3 = kernels.hook_compress.launches, kernels.ell_row_min.launches
    ids, _, levels = boruvka.solve_graph(g, strategy="ell", device=cuda)
    assert len(g.ell_buckets) > 1
    assert kernels.hook_compress.launches - k1 == levels
    assert kernels.ell_row_min.launches - k3 == levels - 1
    assert levels == boruvka.solve_graph(g, strategy="fused", device=cuda)[2]
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))


def _rank_graphs():
    """The fixture deck, RMAT-13 (ef 16, seed 1) and two road grids with 7
    isolated vertices."""
    out = {name: forest23(edgelist.Graph, generators) if make is None else make(generators)
           for name, make in DECK.items()}
    out["rmat13"] = generators.rmat_graph(13, 16, seed=1)
    g1 = generators.road_grid_graph(30, 30, seed=5)
    g2 = generators.road_grid_graph(12, 12, seed=6)
    off = g1.num_nodes
    out["two_grids"] = edgelist.Graph.from_arrays(
        off + g2.num_nodes + 7, np.concatenate([g1.u, g2.u + off]),
        np.concatenate([g1.v, g2.v + off]), np.concatenate([g1.w, g2.w]))
    return out


_RANK_GRAPHS = ["er48", "rmat12", "road40", "forest23", "readme", "rmat13", "two_grids"]


def _assert_same_solve(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _RANK_GRAPHS)
def test_rank_solve_on_card_equals_cpu_and_oracle(cuda, name):
    """strategy="rank" on the card, element for element the port's CPU run;
    K1 launches at every level the card runs."""
    g = _rank_graphs()[name]
    k1 = kernels.hook_compress.launches
    got = boruvka.solve_graph(g, strategy="rank", device=cuda)
    launched = kernels.hook_compress.launches - k1
    _assert_same_solve(got, boruvka.solve_graph(g, strategy="rank", device="cpu"))
    np.testing.assert_array_equal(got[0], rank_oracle_edge_ids(g))
    if got[2] > 2:  # levels past the host's run on the card
        assert launched >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_levels", [2, 3])
def test_rank_census_chain_on_card_equals_cpu(cuda, monkeypatch, chunk_levels):
    """A forced shrink chain (spare-slot scatters, the -1 pad ids of a
    shrink, the replay over dead fragments) on the card, equal to the CPU."""
    monkeypatch.setattr(rank_solver, "_SHRINK_MIN_SPACE", 64)
    monkeypatch.setattr(rank_solver, "_ONE_SHOT_MAX_SLOTS", 0)
    g = _rank_graphs()["two_grids"]
    shrinks = []
    orig = rank_solver._shrink_and_run

    def spy(*a, **k):
        shrinks.append(k["f_size"])
        return orig(*a, **k)

    monkeypatch.setattr(rank_solver, "_shrink_and_run", spy)
    results = []
    for device in (cuda, torch.device("cpu")):
        vmin0, ra, rb = rank_solver.prepare_rank_arrays(g, device=device)
        mst, frag, lv = rank_solver.solve_rank_staged(
            vmin0, ra, rb, compact_after=1, chunk_levels=chunk_levels, compact_space=True)
        results.append((mst.cpu().numpy(), frag.cpu().numpy(), lv))
    _assert_same_solve(*results)
    assert len(shrinks) >= 4  # two or more a device


@pytest.mark.gpu
def test_rank_two_pass_segment_minimum_on_card_equals_cpu(cuda, monkeypatch):
    """The two-pass ``_moe_over`` (above 2^28 slots in production) forced
    at RMAT-13's width."""
    g = _rank_graphs()["rmat13"]
    want = boruvka.solve_graph(g, strategy="rank", device="cpu")
    monkeypatch.setattr(rank_solver, "_MOE_TWO_PASS_SLOTS", 0)
    _assert_same_solve(boruvka.solve_graph(g, strategy="rank", device=cuda), want)


@pytest.mark.gpu
def test_rank_speculative_on_card_accepts_and_mispredicts(cuda):
    g = generators.rmat_graph(12, 8, seed=11)
    vmin0, ra, rb, parent1 = rank_solver.prepare_rank_arrays_full(g, device=cuda)
    assert rank_solver.solve_rank_speculative(vmin0, ra, rb, out_size=2, parent1=parent1) is None
    got = rank_solver.solve_rank_speculative(vmin0, ra, rb, out_size=ra.shape[0], parent1=parent1)
    want = rank_solver.solve_rank_staged(vmin0, ra, rb, parent1=parent1)
    assert got is not None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]


@pytest.mark.gpu
def test_rank_stage_cache_is_not_reused_across_devices_on_card(cuda):
    g = generators.road_grid_graph(20, 20, seed=3)
    on_card = rank_solver.prepare_rank_arrays_l2(g, device=cuda)
    on_cpu = rank_solver.prepare_rank_arrays_l2(g, device="cpu")
    assert all(t.is_cuda for t in on_card) and all(t.is_cpu for t in on_cpu)
    assert rank_solver.prepare_rank_arrays_l2(g, device=cuda) is on_card
    index = torch.device("cuda", torch.cuda.current_device())
    assert rank_solver.prepare_rank_arrays_l2(g, device=index) is on_card
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    _assert_same_solve(boruvka.solve_graph(g, strategy="rank", device="cpu"),
                       boruvka.solve_graph(g, strategy="rank", device=cuda))


@pytest.fixture(scope="module")
def rmat19():
    """RMAT-19 ef 16 seed 1 (native stream): 7.7 M edges, 2^23 padded
    ranks, the first scale the filter route takes; and its oracle. Built
    only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = generators.rmat_graph(19, 16, seed=1)
    assert rank_solver.use_filtered_path(rank_solver._pick_family(g),
                                         boruvka._bucket_size(g.num_edges))
    return g, rank_oracle_edge_ids(g)


def _filtered_solve_on_card(g, cuda, monkeypatch, calls=()):
    """``make_production_solver``'s solve on the card, with the port's
    functions ``calls`` recorded as ``(name, answered)``."""
    log = []
    for name in calls:
        fn = getattr(rank_solver, name)

        def spy(*a, _name=name, _fn=fn, **k):
            out = _fn(*a, **k)
            log.append((_name, out is not None))
            return out

        monkeypatch.setattr(rank_solver, name, spy)
    g.__dict__.pop("_rank_stage_cache", None)
    mst, frag, levels = rank_solver.make_production_solver(g, device=cuda)()
    return (boruvka.fetch_mst_edge_ids(g, mst), frag.cpu().numpy(), levels), log


def _same_partition(a, b):
    """Two vertex labelings with the same components, whatever the roots'
    ids (routes that run other levels may pick other roots)."""
    a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
    assert np.unique(a * (b.max() + 1) + b).size == np.unique(a).size == np.unique(b).size


_FILTER_CALLS = ("solve_rank_filtered_speculative", "solve_rank_filtered",
                 "_filter_suffix_fused", "_filter_suffix_ends", "_filter_suffix_chunked")


@pytest.mark.gpu
def test_filter_route_on_card_equals_oracle(cuda, rmat19, monkeypatch):
    """``auto`` on RMAT-19: the speculative filtered program from the host
    level 2; K1 launches."""
    g, oracle = rmat19
    k1 = kernels.hook_compress.launches
    got, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert kernels.hook_compress.launches > k1
    assert log[-1] == ("solve_rank_filtered_speculative", True)
    np.testing.assert_array_equal(got[0], oracle)


@pytest.mark.gpu
def test_filter_misprediction_on_card_equals_oracle(cuda, rmat19, monkeypatch):
    """Survivors predicted at 2,048: the speculative program answers
    ``None``, and ``solve_rank_filtered`` runs, its fused filter overflowing
    to the two-step filter; the forest is the accepted route's."""
    g, oracle = rmat19
    want, _ = _filtered_solve_on_card(g, cuda, monkeypatch)
    monkeypatch.setattr(rank_solver, "_FILTER_SURVIVOR_DIVISOR", 1 << 30)
    got, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert [name for name, _ in log] == [
        "_filter_suffix_ends", "solve_rank_filtered_speculative",  # the program's own filter
        "_filter_suffix_fused", "_filter_suffix_ends", "solve_rank_filtered"]
    assert log[1][1] is False
    np.testing.assert_array_equal(got[0], oracle)
    _same_partition(got[1], want[1])


@pytest.mark.gpu
def test_filter_overflow_on_card_equals_oracle(cuda, rmat19, monkeypatch):
    """From the census size up (lowered to RMAT-19's), the filtered solve
    from the host level 2; with survivors predicted at 2,048 the fused
    filter overflows to the two-step filter, with the same forest."""
    g, oracle = rmat19
    monkeypatch.setattr(rank_solver, "_CENSUS_MIN_SPACE", 1 << 19)
    want, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert [name for name, _ in log] == ["_filter_suffix_fused", "solve_rank_filtered"]
    monkeypatch.setattr(rank_solver, "_FILTER_SURVIVOR_DIVISOR", 1 << 30)
    got, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert [name for name, _ in log] == ["_filter_suffix_fused", "_filter_suffix_ends",
                                         "solve_rank_filtered"]
    for result in (want, got):
        np.testing.assert_array_equal(result[0], oracle)
    _assert_same_solve(got, want)


@pytest.mark.gpu
def test_chunked_filter_on_card_equals_oracle(cuda, rmat19, monkeypatch):
    """The chunked filter (forced by a lowered ``_FILTER_CHUNK_BYTES``, so
    the prefix is the mult-2 one), in chunks that do not divide the
    suffix; and the resume's wide branch from the solve's first state."""
    g, oracle = rmat19
    monkeypatch.setattr(rank_solver, "_CENSUS_MIN_SPACE", 1 << 19)
    monkeypatch.setattr(rank_solver, "_FILTER_CHUNK_BYTES", 1024)
    monkeypatch.setattr(rank_solver, "_FILTER_CHUNK_RANKS", 1_000_003)
    got, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert [name for name, _ in log] == ["_filter_suffix_chunked", "solve_rank_filtered"]
    np.testing.assert_array_equal(got[0], oracle)
    vmin0, ra, rb, parent1 = rank_solver.prepare_rank_arrays_full(g, device=cuda)
    states = []
    rank_solver.solve_rank_filtered(
        vmin0, ra, rb, parent1=parent1,
        on_chunk=lambda lv, frag, mst, count: states.append(
            (frag.cpu().numpy(), mst.cpu().numpy().astype(bool), lv)))
    mst, frag, _ = rank_solver.solve_rank_resume(vmin0, ra, rb, states[1])
    np.testing.assert_array_equal(boruvka.fetch_mst_edge_ids(g, mst), oracle)
    _same_partition(frag.cpu().numpy(), got[1])
