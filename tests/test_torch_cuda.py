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


def _device_kernels(fn, attempts=3):
    """The device kernels one call of ``fn`` runs, by the profiler: a
    warm-up step of one call first (the tracer can miss the first kernels
    after it starts), then the step kept, without the step's own range. A
    session that recorded no device kernel at all is run again, up to
    ``attempts`` sessions (the tracer now and then records nothing in a
    session); the caller checks what the last one returns."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        torch.cuda.synchronize()
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")]
        if names:
            return names
    return names


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
    elif name == "first_rank":
        rng = np.random.default_rng(3)
        ra, rb = rng.integers(0, 5000, (2, 1 << 16), dtype=np.int32)
        return [_t(ra).to(device), _t(rb).to(device), (1 << 16) - 5, 5000]
    elif name == "rank_order":
        w = np.random.default_rng(3).integers(1, 300, 70_001, dtype=np.int64)
        return [_t(w).to(device), 1, 299]
    elif name == "rank_endpoints":
        rng = np.random.default_rng(3)
        order = rng.permutation(70_001).astype(np.int32)
        u, v = rng.integers(0, 5000, (2, 70_001), dtype=np.int32)
        return [_t(order).to(device), _t(u).to(device), _t(v).to(device), 70_100]
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
        # The last tensor argument (first_rank ends with two sizes).
        k = max(i for i, a in enumerate(args) if isinstance(a, torch.Tensor))
        last = args[k]
        other = torch.int32 if last.dtype is torch.int64 else torch.int64
        wrong = args[:k] + [last.to(other)] + args[k + 1:]
        with pytest.raises(TypeError, match=str(last.dtype).removeprefix("torch.")):
            w(*wrong)
        strided = torch.empty(last.shape[:-1] + (2 * last.shape[-1],), dtype=last.dtype,
                              device=cuda)[..., ::2]
        strided.copy_(last)
        with pytest.raises(ValueError, match="contiguous"):
            w(*args[:k], strided, *args[k + 1:])
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
    on_card = rank_solver.prepare_rank_arrays_full(g, device=cuda)
    on_cpu = rank_solver.prepare_rank_arrays_full(g, device="cpu")
    assert all(t.is_cuda for t in on_card) and all(t.is_cpu for t in on_cpu)
    assert rank_solver.prepare_rank_arrays_full(g, device=cuda) is on_card
    index = torch.device("cuda", torch.cuda.current_device())
    assert rank_solver.prepare_rank_arrays_full(g, device=index) is on_card
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    _assert_same_solve(boruvka.solve_graph(g, strategy="rank", device="cpu"),
                       boruvka.solve_graph(g, strategy="rank", device=cuda))


def _first_rank_cases():
    """``(name, ra, rb, m, n_pad)``: RMAT-18's rank endpoints (hubs of
    thousands of ranks), padded; and a graph with isolated vertices, vertex
    0 among them, whose pad ranks (``ra == rb == 0``) must stay out."""
    g = generators.rmat_graph(18, 16, seed=1)
    ra, rb = g.rank_endpoints(pad_to=boruvka._bucket_size(g.num_edges))
    cases = [("rmat18", ra, rb, g.num_edges, boruvka._bucket_size(g.num_nodes))]
    rng = np.random.default_rng(9)
    a, b = rng.integers(1, 40_000, (2, 300_001))
    h = edgelist.Graph.from_arrays(50_000, a, b, rng.integers(1, 255, a.size))
    ra, rb = h.rank_endpoints(pad_to=boruvka._bucket_size(h.num_edges))
    return cases + [("isolated", ra, rb, h.num_edges, boruvka._bucket_size(h.num_nodes))]


@pytest.mark.gpu
def test_first_rank_kernel_matches_plain_on_card(cuda):
    """K6 against its torch form, element for element: on RMAT-18 (hubs)
    and on a graph with isolated vertices and pad ranks; from the start and
    from an offset of one element (no 16-byte loads there); at ``m`` of
    every remainder mod 4."""
    for name, ra, rb, m, n_pad in _first_rank_cases():
        for offset in (0, 1):
            a, b = _t(ra).to(cuda)[offset:], _t(rb).to(cuda)[offset:]
            for mm in (m - offset, m - offset - 1, m - offset - 2, m - offset - 3, 1, 0):
                launches = kernels.first_rank.launches
                got = kernels.first_rank(a, b, mm, n_pad)
                torch.cuda.synchronize()
                assert kernels.first_rank.launches == launches + (mm > 0), name
                assert torch.equal(got, kernels.first_rank_torch(a, b, mm, n_pad)), (name, mm)
        if name == "isolated":
            got = kernels.first_rank(_t(ra).to(cuda), _t(rb).to(cuda), m, n_pad)
            assert int(got[0]) == kernels.INT32_MAX and ra.shape[0] > m


def _rank_order_cases():
    """``(name, w)``: weights of one, two and three digit passes, all equal,
    exactly 2^22 values, at sizes around K7's 4,096-key tile."""
    rng = np.random.default_rng(23)
    cases = []
    for m in (1, 2, 33, 4095, 4096, 4097, 70_001, 1_000_003):
        for lo, span in ((1, 255), (42, 1), (-3, 11_600), (1000, 70_000), (1 << 33, 1 << 22)):
            w = rng.integers(lo, lo + span, m, dtype=np.int64)
            w[0], w[m // 2] = lo, lo + span - 1
            cases.append((f"m={m} range={span}", w))
    return cases


@pytest.mark.gpu
def test_rank_order_kernel_matches_plain_on_card(cuda):
    """K7 against NumPy's stable argsort, element for element, one launch a
    sort; its gather against the plain version, pad ranks zero."""
    for name, w in _rank_order_cases():
        wd = _t(w).to(cuda)
        launches = kernels.rank_order.launches
        got = kernels.rank_order(wd, int(w.min()), int(w.max()))
        torch.cuda.synchronize()
        assert kernels.rank_order.launches == launches + 1, name
        np.testing.assert_array_equal(got.cpu().numpy(), np.argsort(w, kind="stable"), name)
        rng = np.random.default_rng(w.size)
        u, v = rng.integers(0, max(2, w.size // 3), (2, w.size), dtype=np.int32)
        ud, vd = _t(u).to(cuda), _t(v).to(cuda)
        pair = kernels.rank_endpoints(got, ud, vd, w.size + 37)
        want = kernels.rank_endpoints_torch(got, ud, vd, w.size + 37)
        assert all(torch.equal(a, b) for a, b in zip(pair, want)), name


def _rank_order64_cases():
    """``(name, w)``: float64 weights of every class (both zeros, both
    infinities, subnormals, NaN of both signs) among random ones and tied,
    uniform in [0, 1), and int64 over the whole range or differing in one
    digit, at sizes around K7's 4,096-key tile."""
    rng = np.random.default_rng(64)
    fin = np.finfo(np.float64)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, fin.tiny, -fin.tiny,
                         fin.max, -fin.max, 1.0, -1.0, np.nan, -np.nan])
    cases = []
    for m in (1, 2, 33, 4095, 4096, 4097, 70_001, 1_000_003):
        mixed = rng.standard_normal(m) * 10.0 ** rng.integers(-300, 300, m)
        pick = rng.random(m) < 0.3
        mixed[pick] = rng.choice(specials, int(pick.sum()))
        wide = rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64, endpoint=True)
        wide[: m // 3] = rng.choice(np.array([-(1 << 62), 1 << 62, -(1 << 63), (1 << 63) - 1]),
                                    m // 3)
        cases += [(f"m={m} float specials", rng.choice(specials, m)),
                  (f"m={m} float mixed", mixed),
                  (f"m={m} float in [0, 1)", rng.random(m)),
                  (f"m={m} float ties", rng.choice(np.array([-2.5, -0.0, 0.0, 7.0]), m)),
                  (f"m={m} int64 wide", wide),
                  (f"m={m} int64 one digit", rng.integers(0, 256, m, dtype=np.int64) << 40)]
    return cases


@pytest.mark.gpu
def test_rank_order_64_bit_kernel_matches_plain_on_card(cuda):
    """K7 over 64-bit keys against its torch form and NumPy's stable
    argsort, element for element, one launch a sort, over the digit passes
    the torch form names (a digit the same in every key skipped)."""
    for name, w in _rank_order64_cases():
        wd = _t(w).to(cuda)
        launches = kernels.rank_order.launches
        got = kernels.sort_rank_order(wd)
        torch.cuda.synchronize()
        assert kernels.rank_order.launches == launches + 1, name
        assert got.key == ("float64" if w.dtype == np.float64 else "int64"), name
        want = kernels.sort_rank_order(_t(w))
        assert got.passes == want.passes, name
        assert torch.equal(got.order.cpu(), want.order), name
        np.testing.assert_array_equal(got.order.cpu().numpy(), np.argsort(w, kind="stable"),
                                      name)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["integer", "wide", "float"])
def test_prep_rank_endpoints_on_card_equal_cpu(cuda, kind):
    """The prep's rank endpoints on the card equal the CPU's and the host's:
    every weight through K7 and the gather (the order held on the graph,
    the host order unfilled), integers within 2^22 values by the 32-bit
    key, a wider range and floats by the 64-bit one."""
    g = generators.rmat_graph(16, 16, seed=4)
    w = {"integer": g.w, "wide": g.w * 40_000, "float": g.w + 0.5}[kind]
    graph = edgelist.Graph(g.num_nodes, g.u, g.v, w)
    m_pad = boruvka._bucket_size(graph.num_edges)
    k7 = kernels.rank_order.launches
    ra, rb = rank_solver._rank_endpoints(graph, m_pad, cuda)
    torch.cuda.synchronize()
    assert kernels.rank_order.launches == k7 + 1
    assert "_rank_order" not in graph.__dict__
    assert boruvka.held_rank_order(graph, ra.device) is not None
    want = edgelist.Graph(g.num_nodes, g.u, g.v, w).rank_endpoints(pad_to=m_pad)
    np.testing.assert_array_equal(ra.cpu().numpy(), want[0])
    np.testing.assert_array_equal(rb.cpu().numpy(), want[1])
    ids, _, _ = rank_solver.solve_graph_rank(graph, device=cuda)
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))


@pytest.mark.gpu
def test_filtered_prep_on_card_equals_cpu(cuda, monkeypatch):
    """The filter route's device levels on the card (K6 and K1: the prep's
    first ranks and level 1, the head's level 2 over the prefix each
    regime's solve runs first) give the CPU's arrays, in both regimes, and
    the solves the CPU's forest."""
    monkeypatch.setattr(rank_solver, "_FILTER_MIN_RANKS", 1024)
    for census in (1 << 21, 64):
        monkeypatch.setattr(rank_solver, "_CENSUS_MIN_SPACE", census)
        g = generators.rmat_graph(14, 16, seed=2)
        on_card = rank_solver.prepare_rank_arrays_full(g, device=cuda)
        on_cpu = rank_solver.prepare_rank_arrays_full(g, device="cpu")
        for a, b in zip(on_card, on_cpu, strict=True):
            assert torch.equal(a.cpu(), b)
        n_pad, m_pad = on_cpu[0].shape[0], on_cpu[1].shape[0]
        prefix = (rank_solver._prefix_plan(n_pad, m_pad)[0] if census == 64
                  else rank_solver._prefix_size(n_pad, m_pad, 2))
        head_card = rank_solver._filtered_head(*on_card, prefix=prefix)
        head_cpu = rank_solver._filtered_head(*on_cpu, prefix=prefix)
        for a, b in zip(head_card[:4] + tuple(head_card[4]), head_cpu[:4] + tuple(head_cpu[4])):
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
    """``auto`` on RMAT-19: the speculative filtered program, its head's
    level 2 from the prep's level 1; K6 launches once (the prep's first
    ranks) and K1."""
    g, oracle = rmat19
    k1, k6 = kernels.hook_compress.launches, kernels.first_rank.launches
    got, log = _filtered_solve_on_card(g, cuda, monkeypatch, _FILTER_CALLS)
    assert kernels.hook_compress.launches > k1 and kernels.first_rank.launches == k6 + 1
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
    """From the census size up (lowered to RMAT-19's), the filtered solve,
    its head's level 2 over its own prefix; with survivors predicted at 2,048 the fused
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


# ---------------------------------------------------------------------------
# Supervised solves, checkpoint and resume, per-level metrics (RMAT-18)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rmat18():
    """RMAT-18 ef 16 seed 1 and its oracle; built only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = generators.rmat_graph(18, 16, seed=1)
    return g, rank_oracle_edge_ids(g)


@pytest.fixture()
def faults():
    from distributed_ghs_implementation_tpu_torch.utils import resilience

    resilience.FAULTS.reset()
    yield resilience
    resilience.FAULTS.reset()


def _trail(log):
    return [(r.rung, r.attempt, r.outcome) for r in log.records]


@pytest.mark.gpu
def test_supervised_solve_on_card_takes_the_unsupervised_route(cuda, rmat18, faults,
                                                              monkeypatch):
    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest

    g, oracle = rmat18
    log = []
    fn = rank_solver.solve_rank_speculative
    monkeypatch.setattr(rank_solver, "solve_rank_speculative",
                        lambda *a, **k: log.append(1) or fn(*a, **k))
    plain = minimum_spanning_forest(g, device=cuda)
    supervised = minimum_spanning_forest(g, supervised=True, device=cuda)
    assert log == [1, 1]  # the speculative route, both times
    assert supervised.backend == "supervised/device"
    assert _trail(supervised.incidents) == [("device", 1, "ok")]
    np.testing.assert_array_equal(supervised.edge_ids, oracle)
    assert supervised.num_levels == plain.num_levels


@pytest.mark.gpu
def test_supervised_degrade_on_card_runs_the_stepped_kernels(cuda, rmat18, faults):
    """The stepped rung launches K1 once a level; its slots are fragment
    ids at every level, so each level's minimum takes the identity form and
    K2 does not launch."""
    g, oracle = rmat18
    sup = faults.Supervisor(faults.SupervisorConfig(backoff_base_s=0))
    k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
    with faults.FAULTS.inject("resilience.attempt.device", times=2):
        ids, _, levels, log = sup.solve(g, device=cuda)
    assert _trail(log) == [("device", 1, "transient"), ("device", 2, "transient"),
                           ("stepped", 1, "ok")]
    assert kernels.hook_compress.launches - k1 == levels
    assert kernels.gather_key.launches - k2 == 0
    np.testing.assert_array_equal(ids, oracle)


@pytest.mark.gpu
def test_supervised_watchdog_and_host_rung_on_card(cuda, rmat18, faults):
    g, oracle = rmat18
    config = faults.SupervisorConfig(deadline_s=60, backoff_base_s=0)
    with faults.FAULTS.inject("resilience.slow.device", times=2, kind="slow", value=3600):
        ids, _, _, log = faults.Supervisor(config).solve(g, device=cuda)
    assert _trail(log) == [("device", 1, "timeout"), ("device", 2, "timeout"),
                           ("stepped", 1, "ok")]
    np.testing.assert_array_equal(ids, oracle)
    for rung in ("device", "stepped"):
        faults.FAULTS.arm(f"resilience.attempt.{rung}", times=2)
    ids, _, levels, log = faults.Supervisor(config).solve(g, device=cuda)
    assert log.final_rung == "host" and levels == 0
    np.testing.assert_array_equal(ids, oracle)


@pytest.mark.gpu
def test_checkpoint_and_resume_on_card(cuda, rmat18, faults, tmp_path):
    from distributed_ghs_implementation_tpu_torch.utils import checkpoint

    g, oracle = rmat18
    path = str(tmp_path / "rmat18.npz")
    ids, frag, levels = checkpoint.solve_graph_checkpointed(g, path, strategy="rank",
                                                            device=cuda)
    np.testing.assert_array_equal(ids, oracle)
    want = boruvka.solve_graph(g, strategy="stepped", device=cuda)
    _same_partition(frag, want[1])
    # The states at the first and the second chunk boundary, saved from the card.
    saved = {1: str(tmp_path / "first.npz"), 2: str(tmp_path / "second.npz")}
    fingerprint = checkpoint.graph_fingerprint(g)
    seen = []

    def hook(level, fragment, mst, count):
        seen.append(int(level))
        if len(seen) in saved:
            checkpoint.save_checkpoint(saved[len(seen)], fragment, mst, level,
                                       fingerprint=fingerprint)

    hooked = rank_solver.make_production_solver(g, device=cuda)(on_chunk=hook)
    assert len(seen) >= 2 and hooked[2] == levels
    # Read before the resume below writes its own states over the second.
    first, second = (checkpoint.load_checkpoint(saved[k]) for k in (1, 2))
    got = checkpoint.solve_graph_checkpointed(g, saved[2], strategy="rank", device=cuda)
    np.testing.assert_array_equal(got[0], oracle)
    assert got[2] == levels
    # A torn primary over a mid-solve state: the first boundary's state is
    # saved, the save of the second is torn, and the resume falls back to
    # the first (the .bak), warns, and finishes the solve from there.
    torn = str(tmp_path / "torn.npz")
    assert first[2] == seen[0] < second[2] <= levels
    checkpoint.save_checkpoint(torn, *first, fingerprint=fingerprint)
    with faults.FAULTS.inject("checkpoint.save", times=1, kind="torn"):
        with pytest.raises(faults.InjectedFault):
            checkpoint.save_checkpoint(torn, *second, fingerprint=fingerprint)
    assert checkpoint.load_checkpoint(torn + ".bak")[2] == seen[0]
    with pytest.warns(RuntimeWarning, match="previous generation"):
        got = checkpoint.solve_graph_checkpointed(g, torn, strategy="rank", device=cuda)
    np.testing.assert_array_equal(got[0], oracle)
    assert got[2] == levels


@pytest.mark.gpu
def test_instrumented_rank_solve_on_card_equals_cpu(cuda, rmat18):
    from distributed_ghs_implementation_tpu_torch.utils import metrics

    g, oracle = rmat18
    (ids, frag, levels), got = metrics.solve_graph_instrumented(g, strategy="rank", device=cuda)
    np.testing.assert_array_equal(ids, oracle)
    assert got.levels[-1].fragments_after == g.num_nodes - oracle.size
    assert got.levels[-1].level == levels
    (_, _, _), want = metrics.solve_graph_instrumented(g, strategy="rank", device="cpu")
    assert ([(m.level, m.fragments_before, m.fragments_after, m.edges_alive_after)
             for m in got.levels]
            == [(m.level, m.fragments_before, m.fragments_after, m.edges_alive_after)
                for m in want.levels])


@pytest.mark.gpu
def test_profiler_trace_names_the_kernels_on_card(cuda, rmat18, tmp_path):
    import json

    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.utils.metrics import profiler_trace

    g, _ = rmat18
    minimum_spanning_forest(g, device=cuda)
    with profiler_trace(str(tmp_path)) as path:
        minimum_spanning_forest(g, device=cuda)
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("hook_compress" in name for name in names)


# ---------------------------------------------------------------------------
# Batch lanes, the engine, warmup and the serve stack (the small-graph path)
# ---------------------------------------------------------------------------


def _lane_set(form):
    """Graphs whose 16-lane stack takes K1's ``form``: 16 graphs of 128
    vertices (n = 2,048, the block form), or 4 RMAT-13 graphs in 16 lanes
    (n = 2^17, the grid form; 8,192 at one lane, the block form)."""
    if form == "block":
        return [generators.gnm_random_graph(128, 500, seed=s) for s in range(1, 17)]
    return [generators.rmat_graph(13, 16, seed=s) for s in range(1, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "vmap"])
@pytest.mark.parametrize("form", ["block", "grid"])
def test_lanes_on_card_equal_per_graph_solves(cuda, mode, form):
    """Edge ids, fragments and levels equal each graph's own solve on the
    card and the lanes' CPU run; K1's last launch ran the expected form."""
    from distributed_ghs_implementation_tpu_torch.batch import lanes

    graphs = _lane_set(form)
    got = lanes.solve_lanes(graphs, lanes=16, mode=mode, device=cuda)
    assert kernels.hook_compress_readout()[1] == form
    cpu = lanes.solve_lanes(graphs, lanes=16, mode=mode, device="cpu")
    alone = [boruvka.solve_graph(g, strategy="fused", device=cuda) for g in graphs]
    for g, (ids, frag, levels), want, (oids, ofrag, olevels) in zip(graphs, got, cpu, alone):
        np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
        np.testing.assert_array_equal(ids, oids)
        np.testing.assert_array_equal(frag, ofrag)
        np.testing.assert_array_equal(frag, want[1])
        assert levels == want[2]
        assert levels == (olevels if mode == "vmap" else max(a[2] for a in alone))


@pytest.mark.gpu
def test_engine_batch_on_card_equals_solve_lanes(cuda):
    from distributed_ghs_implementation_tpu_torch.batch import lanes
    from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine

    small, big = _lane_set("block")[:5], _lane_set("grid")[:2]
    results = BatchEngine(device=cuda).solve_many(small + big)
    direct = (lanes.solve_lanes(small, lanes=16, device=cuda)
              + lanes.solve_lanes(big, lanes=16, device=cuda))
    for r, (ids, _, levels) in zip(results, direct):
        assert r.backend == "batch/fused"
        np.testing.assert_array_equal(r.edge_ids, ids)
        assert r.num_levels == levels


@pytest.mark.gpu
def test_warmed_bucket_adds_no_compile_miss_on_card(cuda):
    from distributed_ghs_implementation_tpu_torch.batch import lanes, warmup
    from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    lanes.clear_solver_cache()
    BUS.enable()
    graphs = _lane_set("block")[:3]
    report = warmup.run_warmup(warmup.WarmupPlan(buckets=((128, 512),), lanes=16), device=cuda)
    assert report["compiled"] == 1 and report["kernel"] == "cuda"
    misses, hits = (BUS.counters().get(k, 0) for k in ("compile.miss", "compile.hit"))
    results = BatchEngine(device=cuda).solve_many(graphs)
    assert BUS.counters().get("compile.miss", 0) == misses
    assert BUS.counters()["compile.hit"] == hits + 1
    for g, r in zip(graphs, results):
        np.testing.assert_array_equal(r.edge_ids, rank_oracle_edge_ids(g))


@pytest.mark.gpu
def test_first_use_from_eight_engine_threads_loads_once_on_card(cuda):
    """The library's first load from 8 engine threads at once, each the
    leader of its own bucket's build, in a fresh interpreter: one build,
    load and self-check; every batch equals its CPU run."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys, threading\n"
        f"sys.path.insert(0, {str(repo)!r})\n"
        "import numpy as np\n"
        "from distributed_ghs_implementation_tpu_torch.ops import _build, kernels\n"
        "from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine\n"
        "from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy\n"
        "from distributed_ghs_implementation_tpu_torch.graphs.generators import "
        "gnm_random_graph\n"
        "loads = []\n"
        "real = _build.load_library\n"
        "_build.load_library = lambda: loads.append(1) or real()\n"
        "decks = [[gnm_random_graph(8 << i, 24 << i, seed=s) for s in range(3)] "
        "for i in range(8)]\n"
        "barrier, got = threading.Barrier(8), [None] * 8\n"
        "def run(i):\n"
        "    engine = BatchEngine(policy=BatchPolicy(max_lanes=4), device='cuda')\n"
        "    barrier.wait()\n"
        "    got[i] = engine.solve_many(decks[i])\n"
        "threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]\n"
        "[t.start() for t in threads]\n"
        "[t.join(timeout=300) for t in threads]\n"
        "assert kernels._LIB is not None and loads == [1], loads\n"
        "for deck, results in zip(decks, got):\n"
        "    cpu = BatchEngine(policy=BatchPolicy(max_lanes=4), device='cpu').solve_many(deck)\n"
        "    for a, b in zip(results, cpu):\n"
        "        assert a.edge_ids.tolist() == b.edge_ids.tolist()\n"
        "print('ok', len(loads))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 1"


@pytest.mark.gpu
def test_scheduler_and_dynamic_on_card_equal_cpu(cuda):
    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
    from distributed_ghs_implementation_tpu_torch.serve import DynamicMST, SolveScheduler, Update

    graphs = _lane_set("block")[:4]
    engine = BatchEngine(device=cuda)
    try:
        sched = SolveScheduler(batch_engine=engine, device=cuda)
        first = sched.solve_batch(graphs + graphs[:1])
        assert [s for _, s in first] == ["solved"] * 4 + ["coalesced"]
        assert {s for _, s in sched.solve_batch(graphs)} == {"cache"}
    finally:
        engine.close()
    for g, (r, _) in zip(graphs, first):
        np.testing.assert_array_equal(r.edge_ids, rank_oracle_edge_ids(g))
    g = graphs[0]
    dyns = [DynamicMST(minimum_spanning_forest(g, device=d), device=d) for d in (cuda, "cpu")]
    tree = np.nonzero(dyns[1]._in_tree)[0]
    steps = [[Update("delete", int(g.u[tree[0]]), int(g.v[tree[0]]))],
             [Update("reweight", int(g.u[tree[1]]), int(g.v[tree[1]]), 10**6)],
             [Update("insert", 0, 127, 1)]]
    for step in steps:
        card, cpu = (d.apply(step) for d in dyns)
        assert card.graph.digest() == cpu.graph.digest()
        np.testing.assert_array_equal(card.edge_ids, cpu.edge_ids)
        np.testing.assert_array_equal(card.edge_ids, rank_oracle_edge_ids(card.graph))
        assert dyns[0].last_mode == dyns[1].last_mode == "incremental"


# ---------------------------------------------------------------------------
# Streams, certificates and the service (RMAT-18)
# ---------------------------------------------------------------------------


def _cut_pass_inputs(g, rng, deletions, device):
    """A window's cut-pass inputs on ``g``: the forest less ``deletions``
    random tree edges seeds the fragments, over every edge of the graph."""
    from distributed_ghs_implementation_tpu_torch.stream import window

    ids = rank_oracle_edge_ids(g)
    keep = np.delete(ids, rng.choice(ids.size, deletions, replace=False))
    frag0 = edgelist.component_labels(g.num_nodes, g.u[keep], g.v[keep])
    return window._round_inputs(frag0, g.u, g.v, g.w, device)


@pytest.mark.gpu
def test_window_rounds_on_card_equal_plain(cuda, rmat18):
    """Every round of a window's cut pass at RMAT-18's shapes (e = 2^23
    directed slots, n = 2^18, a seeded partition): K2 and K1 equal their
    plain versions, one launch each a round."""
    from distributed_ghs_implementation_tpu_torch.ops.segment_ops import segment_min

    g, _ = rmat18
    _, frag, src, dst, rank, ra, rb = _cut_pass_inputs(g, np.random.default_rng(1), 4096, cuda)
    assert src.numel() == 1 << 23 and frag.numel() == 1 << 18
    rounds = 0
    while True:
        k2 = kernels.gather_key.launches
        got = kernels.gather_key(frag, src, dst, rank)
        for a, b in zip(got, kernels.gather_key_torch(frag, src, dst, rank)):
            assert torch.equal(a, b)
        assert kernels.gather_key.launches == k2 + 1
        f_src, key = got
        moe = segment_min(key, f_src, frag.numel())
        has = moe < kernels.INT32_MAX
        if not bool(has.any()):
            break
        safe = torch.where(has, moe, 0).long()
        fa, fb = frag[ra[safe].long()], frag[rb[safe].long()]
        ids = torch.arange(frag.numel(), dtype=torch.int32, device=cuda)
        dstf = torch.where(has, torch.where(fa == ids, fb, fa), ids)
        new = kernels.hook_compress(has, dstf, frag)
        for a, b in zip(new, kernels.hook_compress_torch(has, dstf, frag)):
            assert torch.equal(a, b)
        frag = new[0]
        rounds += 1
    assert rounds >= 1


@pytest.mark.gpu
def test_windows_on_card_equal_cpu_and_fresh_solves(cuda):
    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.stream.window import (
        WindowedMST,
        random_update_stream,
    )

    g = generators.rmat_graph(13, 16, seed=1)
    wins = [WindowedMST(minimum_spanning_forest(g, device=d), device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(3)
    for size in (64, 512, 2):
        window = random_update_stream(rng, g, size)
        (card, ci), (cpu, pi) = (w.apply_window(window) for w in wins)
        assert card.graph.digest() == cpu.graph.digest() and ci == pi
        np.testing.assert_array_equal(card.edge_ids, cpu.edge_ids)
        np.testing.assert_array_equal(card.edge_ids, rank_oracle_edge_ids(card.graph))


@pytest.mark.gpu
def test_certify_torch_engine_on_card_equals_np(cuda, rmat18):
    import dataclasses

    from distributed_ghs_implementation_tpu_torch.verify import certify

    g, oracle = rmat18

    def verdict(cert):
        return {k: v for k, v in dataclasses.asdict(cert).items()
                if k not in ("engine", "check_s")}

    tree = np.zeros(g.num_edges, dtype=bool)
    tree[oracle] = True
    labels = None
    bad = None
    for drop in oracle[np.argsort(g.w[oracle])][:64]:
        keep = oracle[oracle != drop]
        labels = edgelist.component_labels(g.num_nodes, g.u[keep], g.v[keep])
        cross = np.nonzero(~tree & (labels[g.u] != labels[g.v]) & (g.w > g.w[drop]))[0]
        if cross.size:
            bad = np.sort(np.append(keep, cross[0]))
            break
    assert bad is not None
    for claim, ok in ((oracle, True), (bad, False)):
        on_card = certify.certify_edge_ids(g, claim, engine="torch", device=cuda)
        on_host = certify.certify_edge_ids(g, claim, engine="np")
        assert on_card.engine == "torch" and on_card.ok is ok
        assert verdict(on_card) == verdict(on_host)


@pytest.mark.gpu
def test_service_deck_on_card_equals_cpu(cuda, tmp_path):
    import io
    import json

    from distributed_ghs_implementation_tpu_torch.serve.service import MSTService, serve_loop
    from distributed_ghs_implementation_tpu_torch.stream.window import random_update_stream

    g = generators.rmat_graph(12, 16, seed=2)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]
    sid = g.digest()[:16]
    ups = [{k: v for k, v in u.__dict__.items() if v is not None}
           for u in random_update_stream(np.random.default_rng(4), g, 100)]
    deck = [{"op": "solve", "num_nodes": g.num_nodes, "edges": edges, "edges_out": True},
            {"op": "solve", "num_nodes": g.num_nodes, "edges": edges, "kind": "components"},
            {"op": "solve", "num_nodes": g.num_nodes, "edges": edges, "kind": "path_max",
             "u": 0, "v": 9},
            {"op": "subscribe", "digest": g.digest()},
            {"op": "publish", "stream": sid, "digest": g.digest(), "updates": ups},
            {"op": "poll", "stream": sid, "after_seq": 0},
            {"op": "shutdown"}]
    got = []
    for name, device in (("card", cuda), ("cpu", "cpu")):
        out = io.StringIO()
        svc = MSTService(device=device, verify="full", stream_dir=str(tmp_path / name))
        serve_loop(io.StringIO("\n".join(map(json.dumps, deck)) + "\n"), out, svc)
        answers = [json.loads(x) for x in out.getvalue().splitlines()]
        for a in answers:
            a.pop("wall_time_s", None)
            a.pop("wall_s", None)
        got.append(answers)
    assert got[0] == got[1]
    assert all(a["ok"] for a in got[0]) and got[0][0]["verified"] == "full"
    np.testing.assert_array_equal(
        np.asarray(got[0][0]["mst_edges"]),
        np.stack([g.u, g.v], axis=1)[rank_oracle_edge_ids(g)])


# ---------------------------------------------------------------------------
# The sharded solvers (parallel/): 4 shards on one card
# ---------------------------------------------------------------------------


def _sharded(mode, graph, mesh):
    from distributed_ghs_implementation_tpu_torch.parallel import rank_sharded, sharded

    if mode == "filtered":
        return rank_sharded.solve_graph_rank_sharded(graph, mesh=mesh, filtered=True)
    if mode == "rank64":
        return rank_sharded.solve_graph_rank_sharded(graph, mesh=mesh, rank64=True)
    return sharded.solve_graph_sharded(graph, mesh=mesh, strategy=mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flat", "ell", "rank", "filtered", "rank64"])
@pytest.mark.parametrize("name", ["er48", "rmat12", "road40", "forest23"])
def test_sharded_fixtures_on_card_equal_cpu_and_oracle(cuda, name, mode):
    """The dryrun fixtures on 4 shards of one card: the oracle's forest, the
    CPU mesh's fragments and levels; K1 once a level (one device), and in
    the flat solve K2 once a shard on every level past the first."""
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    g = forest23(edgelist.Graph, generators) if name == "forest23" else DECK[name](generators)
    mesh = edge_mesh(num_shards=4, device="cuda")
    assert mesh.rep_devices == (torch.device("cuda", torch.cuda.current_device()),)
    k1, k2 = kernels.hook_compress.launches, kernels.gather_key.launches
    ids, frag, levels = _sharded(mode, g, mesh)
    d1, d2 = kernels.hook_compress.launches - k1, kernels.gather_key.launches - k2
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
    want = _sharded(mode, g, edge_mesh(num_shards=4, device="cpu"))
    np.testing.assert_array_equal(frag, want[1])
    assert levels == want[2]
    assert d1 >= 1
    if mode == "flat":
        assert (d1, d2) == (levels, 4 * (levels - 1))


@pytest.mark.gpu
def test_k1_and_k2_at_a_shards_shapes_equal_plain(cuda, monkeypatch):
    """K2 over each shard's slot block and K1 over the replicated state, on
    the inputs a flat sharded solve of RMAT-12 on 4 shards gives them at
    every level: equal to their plain versions."""
    from distributed_ghs_implementation_tpu_torch.parallel import sharded
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    seen = {"k1": [], "k2": []}
    real_hook, real_key = sharded.hook_and_compress, kernels.gather_key

    def hook(has, dst, fragment):
        seen["k1"].append((has.clone(), dst.clone(), fragment.clone()))
        return real_hook(has, dst, fragment)

    def key(fragment, src, dst, rank):
        seen["k2"].append((fragment.clone(), src, dst, rank))
        return real_key(fragment, src, dst, rank)

    key.launches = real_key.launches  # the wrapper counts on the module's name
    monkeypatch.setattr(sharded, "hook_and_compress", hook)
    monkeypatch.setattr(sharded.kernels, "gather_key", key)
    g = DECK["rmat12"](generators)
    ids, _, levels = sharded.solve_graph_sharded(g, mesh=edge_mesh(num_shards=4, device="cuda"),
                                                 strategy="flat")
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
    assert (len(seen["k1"]), len(seen["k2"])) == (levels, 4 * (levels - 1))
    for args in seen["k2"]:
        for a, b in zip(real_key(*args), kernels.gather_key_torch(*args)):
            assert torch.equal(a, b)
    for args in seen["k1"]:
        for a, b in zip(kernels.hook_compress(*args), kernels.hook_compress_torch(*args)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_sharded_lane_on_card_equals_cpu(cuda):
    from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

    g = generators.gnm_random_graph(70_000, 3_000, seed=21)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]
    g2 = edgelist.Graph.from_edges(g.num_nodes, edges + [[0, 1, 10 ** 6]])
    out = {}
    for dev in ("cuda", "cpu"):
        lane = ShardedLane(edge_mesh(num_shards=4, device=dev))
        first = lane.solve(g)
        again = lane.solve(g)
        updated = lane.update(g.digest(), g2)
        out[dev] = [(a[0].tolist(), a[1].tolist(), a[2]) for a in (first, again, updated)]
        assert lane.resident_digests() == [g2.digest()]
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0][0] == rank_oracle_edge_ids(g).tolist()
    assert out["cuda"][2][0] == rank_oracle_edge_ids(g2).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DECK))
def test_protocol_equals_the_card_solve(cuda, name):
    """``backend="protocol"`` (host Python) against the card's
    ``backend="device"`` solve and the oracle, on the fixture deck."""
    from distributed_ghs_implementation_tpu_torch import minimum_spanning_forest

    g = forest23(edgelist.Graph, generators) if name == "forest23" else DECK[name](generators)
    proto = minimum_spanning_forest(g, backend="protocol", device=cuda)
    card = minimum_spanning_forest(g, device=cuda)
    np.testing.assert_array_equal(proto.edge_ids, card.edge_ids)
    np.testing.assert_array_equal(proto.edge_ids, rank_oracle_edge_ids(g))
    assert proto.num_components == card.num_components


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["auto", "block", "grid"])
@pytest.mark.parametrize("lanes_, n_pad", [(16, 128), (16, 1024), (16, 8192)])
def test_forced_k1_forms_on_a_lane_stack_equal_plain(cuda, form, lanes_, n_pad):
    """K1 in each form the tuner can install, on a lane stack's first-level
    inputs (a fused batch of gnm graphs), against its plain version; the
    block form only where its shared memory holds the stack."""
    from distributed_ghs_implementation_tpu_torch.batch import lanes
    from distributed_ghs_implementation_tpu_torch.ops.segment_ops import fragment_moe

    n = lanes_ * n_pad
    if form == "block" and n > kernels.HOOK_BLOCK_MAX_NODES:
        pytest.skip(f"the block form holds at most {kernels.HOOK_BLOCK_MAX_NODES} nodes")
    graphs = [generators.gnm_random_graph(n_pad, 3 * n_pad, seed=s) for s in range(lanes_)]
    stacked = lanes.stack_lanes(graphs, lanes=lanes_)
    src, dst, rank, ra, rb = (torch.from_numpy(a).to(cuda) for a in stacked.arrays)
    fragment = torch.arange(n, dtype=torch.int32, device=cuda)
    has, _, dst_frag = fragment_moe(fragment, src, dst, rank, ra, rb, identity_fragment=True)
    got = kernels.hook_compress(has, dst_frag, fragment, form=form)
    _, ran = kernels.hook_compress_readout()
    assert ran == (form if form != "auto" else
                   "block" if n <= kernels.HOOK_BLOCK_FORM_THRESHOLD else "grid")
    for g, w in zip(got, kernels.hook_compress_torch(has, dst_frag, fragment)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_slots", [4096, 8192, 16384])
def test_k3_at_each_tuner_tile_equals_plain(cuda, tile_slots):
    """K3's one launch a level at each tile the tuner searches, on random
    buckets of RMAT-18's (rows, W) classes, against its plain version."""
    n = 1 << 18
    fragment, buckets = ell_bucket_set(7, n, RMAT18_BUCKETS)
    buckets = [tuple(_t(a).to(cuda) for a in b) for b in buckets]
    fragment = _t(fragment).to(cuda)
    plan = kernels.ell_plan(buckets, tile_slots=tile_slots)
    got = kernels.ell_level_min(fragment, plan, torch.full((n,), kernels.INT32_MAX,
                                                           dtype=torch.int32, device=cuda))
    want = kernels.ell_level_min_torch(fragment, plan, torch.full((n,), kernels.INT32_MAX,
                                                                  dtype=torch.int32, device=cuda))
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_a_tuning_record_installs_on_card(cuda, tmp_path):
    """A short search on the card: measured winners that passed parity, a
    record that loads (card fingerprint) and installs through warmup, and
    a batch under it equal to the oracle with no ``compile.miss``."""
    from distributed_ghs_implementation_tpu_torch.batch import lanes, warmup
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.tune import measure, record

    buckets = [(128, 512, 16, "fused"), (1024, 4096, 0, "ell")]
    rec = measure.search(buckets, repeats=3, device=cuda)
    assert rec["backend"] == "cuda" and "cuda" in rec["fingerprint"]
    for entry in rec["entries"].values():
        assert entry["kernel"] == "cuda" and entry["source"] == "measured"
        assert entry["parity"] == "ok" and entry["timings"]
    path = str(tmp_path / "t.json")
    record.save_record(rec, path)
    assert record.load_record(path, device="cpu") is None  # another device: stale
    kernels.set_tuned_configs(None)
    lanes.clear_solver_cache()
    BUS.enable()
    try:
        report = warmup.run_warmup(
            warmup.WarmupPlan(buckets=((128, 512),), lanes=16, tuning=path), device=cuda)
        assert report["tuned_entries"] == 2
        misses = BUS.counters().get("compile.miss", 0)
        graphs = [generators.gnm_random_graph(128, 500, seed=s) for s in range(16)]
        for g, (ids, _, _) in zip(graphs, lanes.solve_lanes(graphs, lanes=16, device=cuda)):
            np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
        assert BUS.counters().get("compile.miss", 0) == misses
    finally:
        kernels.set_tuned_configs(None)


@pytest.mark.gpu
def test_graph500_components_count_on_card_takes_the_mask(cuda, monkeypatch):
    """A Graph500 solve at scale 20 through the API, with isolated
    vertices: the count by the presence mask equals ``np.unique`` of the
    fragment the card returned and ``n`` less the forest's edges."""
    from distributed_ghs_implementation_tpu_torch import api
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    g = generators.rmat_graph(20, 16, seed=25)
    degree = np.bincount(np.concatenate([g.u, g.v]), minlength=g.num_nodes)
    assert (degree == 0).sum() > 0
    fragments = []
    solve = api._solve

    def spy(*a):
        out = solve(*a)
        fragments.append(out[1])
        return out

    monkeypatch.setattr(api, "_solve", spy)
    monkeypatch.setattr(BUS, "enabled", True)
    mark = BUS.mark()
    result = api.minimum_spanning_forest(g, device=cuda)
    (fragment,) = fragments
    spans = [r[6] for r in BUS.events_since(mark) if r[1] == "api.components"]
    assert spans == [{"components": result.num_components, "method": "mask"}]
    assert result.num_components == np.unique(fragment).size
    assert result.num_components == g.num_nodes - result.edge_ids.size
    assert result.num_components >= (degree == 0).sum()
