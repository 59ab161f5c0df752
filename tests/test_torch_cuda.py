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
from distributed_ghs_implementation_tpu_torch.models import boruvka
from distributed_ghs_implementation_tpu_torch.graphs import generators
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

#: (rows, W) of RMAT-18's (edge factor 16, seed 1) fifteen ELL buckets.
RMAT18_BUCKETS = [(65536, 1), (32768, 2), (32768, 4), (32768, 8), (16384, 16), (32768, 32),
                  (16384, 64), (8192, 128), (16384, 256), (64, 512), (4096, 1024),
                  (1024, 2048), (256, 8192), (32, 16384), (1, 32768)]
from torch_inputs import FLAT_SHAPES, ell_inputs, hook_forest, moe_inputs


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 127, 129, 5000, 1 << 18])
@pytest.mark.parametrize("kind", ["random", "star", "chain"])
def test_hook_compress_kernel_matches_plain_on_card(cuda, n, kind):
    args = [_t(a).to(cuda) for a in hook_forest(n, n, kind)]
    got = kernels.hook_compress(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, kernels.hook_compress_torch(*args)):
        assert torch.equal(g, w)


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
    else:
        rng = np.random.default_rng(3)
        arrays = (rng.integers(0, 1 << 30, 1 << 20, dtype=np.int32),
                  rng.integers(0, 1 << 20, 1 << 20, dtype=np.int32))
    return [_t(a).to(device) for a in arrays]


def _plain(name):
    return getattr(kernels, f"{name}_torch")


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w.__name__ for w in kernels.WRAPPERS])
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
    g = generators.rmat_graph(12, 8, seed=11)
    k1, k3 = kernels.hook_compress.launches, kernels.ell_row_min.launches
    ids, _, levels = boruvka.solve_graph(g, strategy="ell", device=cuda)
    assert kernels.hook_compress.launches - k1 == levels
    assert kernels.ell_row_min.launches - k3 == len(g.ell_buckets) * (levels - 1)
    assert levels == boruvka.solve_graph(g, strategy="fused", device=cuda)[2]
    np.testing.assert_array_equal(ids, rank_oracle_edge_ids(g))
