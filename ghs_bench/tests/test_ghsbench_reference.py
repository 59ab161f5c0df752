"""The plain reference against a brute-force Kruskal on tiny graphs, and
its control (weights cut to fewer bits), which the comparison refuses."""

import numpy as np
import pytest

from ghs_bench import graphs, reference


def kruskal(n, u, v, w):
    """Forest ids by sorting on (weight, id) and a union-find, one edge at a time."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for i in sorted(range(len(u)), key=lambda i: (int(w[i]), i)):
        a, b = find(int(u[i])), find(int(v[i]))
        if a != b:
            parent[a] = b
            out.append(i)
    return sorted(out)


def _random_graph(rng, n, m, wmax):
    pairs = sorted({(min(a, b), max(a, b)) for a, b in rng.integers(0, n, (m, 2)) if a != b})
    u = np.array([p[0] for p in pairs], dtype=np.int64)
    v = np.array([p[1] for p in pairs], dtype=np.int64)
    return u, v, rng.integers(1, wmax + 1, size=u.size)


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_kruskal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 40))
        u, v, w = _random_graph(rng, n, int(rng.integers(0, 120)), int(rng.choice([1, 3, 255])))
        assert reference.msf_ids(n, u, v, w).tolist() == kruskal(n, u, v, w)


def test_mismatch_counts_edges_on_either_side_and_repeats():
    want = np.array([1, 4, 7])
    assert reference.mismatch(np.array([1, 4, 7]), want) == 0
    assert reference.mismatch(np.array([1, 4]), want) == 1
    assert reference.mismatch(np.array([1, 4, 8]), want) == 2
    assert reference.mismatch(np.array([1, 4, 7, 7]), want) == 1
    assert reference.mismatch(np.array([-1, 4, 7]), want) == 2


def test_control_of_a_lower_precision_fails_the_comparison():
    """The control: the reference on weights cut from 8 bits to 4 (the
    graph500-rmat24 configuration's), at a size a test holds. It must read
    above the limit of 0 on every seed."""
    for seed in range(3):
        n, u, v, w = graphs.kronecker(12, 16, a=0.57, b=0.19, c=0.19, weight_low=1,
                                      weight_high=255, seed=seed)
        exact = reference.msf_ids(n, u, v, w)
        control = reference.msf_ids(n, u, v, w, drop_weight_bits=4)
        assert control.size == exact.size  # still a spanning forest
        assert reference.mismatch(control, exact) > 0
