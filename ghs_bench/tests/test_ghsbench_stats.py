"""The rate and interval arithmetic, by hand."""

import pytest

from ghs_bench import stats


def test_rate():
    assert stats.rate(510, 51.0) == 10.0
    assert stats.rate(3, 0.0) is None


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert stats.gaps(iv, 0.5, 1.5) == []


def test_idle_gaps_go_to_the_spans_open_over_them():
    from ghs_bench import harness

    got = harness.idle_by_span([(0, 10), (20, 30)],
                               [(0, 5, "prep"), (3, 25, "solve"), (26, 28, "harvest")])
    want = {"prep": 3, "prep+solve": 2, "solve": 10, "no benchmark span": 3, "harvest": 2}
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()})
