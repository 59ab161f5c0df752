"""The benchmark's graph generators: made from the seed, canonical."""

import torch

from ghs_bench import graphs


def _kron(seed, stream=0, scale=10):
    return graphs.kronecker(scale, 16, a=0.57, b=0.19, c=0.19, weight_low=1,
                            weight_high=255, seed=seed, stream=stream)


def test_kronecker_is_deterministic_by_seed_and_stream():
    n, u, v, w = _kron(2**31 + 77)
    n2, u2, v2, w2 = _kron(2**31 + 77)
    assert n == n2 == 1024
    assert torch.equal(u, u2) and torch.equal(v, v2) and torch.equal(w, w2)
    _, u3, _, _ = _kron(2**31 + 78)
    _, u4, _, _ = _kron(2**31 + 77, stream=1)
    assert not torch.equal(u, u3[: u.numel()]) and not torch.equal(u, u4[: u.numel()])


def test_kronecker_is_canonical_without_loops():
    n, u, v, w = _kron(5)
    assert bool((u < v).all()) and int(v.max()) < n
    key = u * n + v
    assert bool((key[1:] > key[:-1]).all())  # sorted by (u, v), no pair twice
    assert int(w.min()) >= 1 and int(w.max()) <= 255
    # Edge factor 16 before loops and duplicates are dropped.
    assert 0.5 * 16 * n < u.numel() <= 16 * n


def test_kronecker_skews_degrees_and_permutes_labels():
    n, u, v, _ = _kron(9, scale=12)
    deg = torch.bincount(torch.cat([u, v]), minlength=n).double()
    assert float(deg.max()) > 20 * float(deg.mean())  # a Kronecker graph's hubs
    # Labels are permuted: the hubs are not the low ids of the unpermuted draw.
    assert int(torch.argmax(deg)) != 0


def test_canonical_merges_duplicates_to_the_least_weight():
    u = torch.tensor([3, 1, 1, 2, 4, 2, 2], dtype=torch.int64)
    v = torch.tensor([1, 3, 3, 2, 0, 0, 0], dtype=torch.int64)
    w = torch.tensor([9, 7, 8, 1, 5, 6, 2], dtype=torch.int64)
    lo, hi, ww = graphs.canonical(u, v, w, node_bits=3)
    assert lo.tolist() == [0, 0, 1]
    assert hi.tolist() == [2, 4, 3]
    assert ww.tolist() == [2, 5, 7]
