"""The components count (``utils.labels.count_labels``): exact for any
integer labels, by the presence mask where the labels' range allows it and
by ``np.unique`` elsewhere; through ``api.minimum_spanning_forest`` on every
backend, against ``np.unique`` of the backend's own fragment and against
the JAX package's count; and the ``api.components`` span and
``api.components.masked`` counter of a rank solve."""

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.utils import labels
from torch_inputs import DECK, build_deck
from torch_pairs import (  # noqa: F401 -- fixtures
    FAMILIES,
    isolated,
    jax_native,
    jax_native_library,
    pair,
)

CPU = "cpu"
_RNG = np.random.default_rng(25)


def _strided():
    base = _RNG.integers(0, 500, 2000)
    return base[::3]


def _random(dtype):
    return _RNG.integers(0, 1000, 5000).astype(dtype)


#: name -> (labels, the method expected)
CASES = {
    "empty": (np.zeros(0, dtype=np.int32), "mask"),
    "one": (np.array([7], dtype=np.int32), "unique"),
    "one-zero": (np.array([0], dtype=np.int64), "mask"),
    "distinct": (_RNG.permutation(1000).astype(np.int32), "mask"),
    "random-int32": (_random(np.int32), "mask"),
    "random-int64": (_random(np.int64), "mask"),
    "random-uint16": (_random(np.uint16), "mask"),
    "non-contiguous": (_strided(), "mask"),
    "negative": (np.array([-3, 0, 5, -3, 2, 5], dtype=np.int32), "unique"),
    "max-far-past-size": (np.array([0, 1, 10**9, 1, 0], dtype=np.int64), "unique"),
    "max-at-span": (np.array([labels.MASK_SPAN * 4 - 1, 0, 1, 0]), "mask"),
    "max-past-span": (np.array([labels.MASK_SPAN * 4, 0, 1, 0]), "unique"),
    "size-minus-one": (np.array([5, 0, 5, 5, 2, 3]), "mask"),
    "one-value": (np.full(10_000, 4321, dtype=np.int32), "mask"),
    "floats": (np.array([0.5, 1.0, 0.5]), "unique"),
    "list": ([3, 1, 3, 0], "mask"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_count_labels_equals_unique_by_the_method_expected(name):
    values, method = CASES[name]
    want = int(np.unique(values).size)
    assert labels.count_labels_with_method(values) == (want, method)
    assert labels.count_labels(values) == want


@pytest.mark.parametrize("name", ["random-int32", "one-value", "size-minus-one"])
def test_the_mask_path_sorts_nothing(name, monkeypatch):
    def no_sort(*a, **k):
        raise AssertionError("the mask path sorted")

    for fn in ("unique", "sort", "argsort"):
        monkeypatch.setattr(np, fn, no_sort)
    values, _ = CASES[name]
    assert labels.count_labels_with_method(values)[1] == "mask"


@pytest.mark.parametrize("name", ["random-int32", "non-contiguous", "distinct"])
def test_count_labels_leaves_its_input_as_it_was(name):
    values, _ = CASES[name]
    before = np.array(values, copy=True)
    labels.count_labels(values)
    np.testing.assert_array_equal(values, before)


@pytest.fixture(scope="module")
def deck():
    return build_deck(jedge, jgen, tedge, tgen)


#: backend -> the API's ``backend`` and the strategy forced on its device
#: solve (``None``: the backend's own)
BACKENDS = {
    "fused": ("device", "fused"),
    "stepped": ("device", "stepped"),
    "ell": ("device", "ell"),
    "rank": ("device", "rank"),
    "sharded": ("sharded", None),
    "protocol": ("protocol", None),
    "host": ("host", None),
}


def _force_strategy(monkeypatch, strategy):
    solve = tb.solve_graph
    monkeypatch.setattr(tb, "solve_graph", lambda g, **k: solve(g, **{**k, "strategy": strategy}))


def _api_count(monkeypatch, graph, backend):
    """``(result, the fragment the backend returned)`` of one API solve on
    the CPU, with the device strategy forced where it names one."""
    api_backend, strategy = BACKENDS[backend]
    if strategy is not None:
        _force_strategy(monkeypatch, strategy)
    seen = []
    solve_backend = tapi._solve

    def spy(*a):
        out = solve_backend(*a)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tapi, "_solve", spy)
    result = tapi.minimum_spanning_forest(graph, backend=api_backend, device=CPU)
    (fragment,) = seen
    assert result.backend == api_backend
    return result, fragment


@pytest.mark.parametrize("name", list(DECK))
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_every_backend_counts_its_fragment_exactly(deck, monkeypatch, name, backend):
    _, tg = deck[name]
    result, fragment = _api_count(monkeypatch, tg, backend)
    assert result.num_components == np.unique(fragment).size
    assert result.num_components == tg.num_nodes - result.num_edges
    if name == "forest23":
        assert result.num_components == 23


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("backend", ["rank", "sharded", "host"])
def test_every_backend_counts_as_the_jax_package(monkeypatch, jax_native, name, backend):
    jg, tg = pair(name)
    result, fragment = _api_count(monkeypatch, tg, backend)
    want = japi.minimum_spanning_forest(jg, backend=BACKENDS[backend][0]).num_components
    assert result.num_components == want == np.unique(fragment).size
    if name == "forest":
        assert result.num_components == 9


def test_a_rank_solve_counts_by_the_mask_once(monkeypatch, isolated):
    _, tg = pair("forest")
    _force_strategy(monkeypatch, "rank")
    mark = BUS.mark()
    before = BUS.counters().get("api.components.masked", 0)
    result = tapi.minimum_spanning_forest(tg, device=CPU)
    events = BUS.events_since(mark)
    spans = [rec[6] for rec in events if rec[0] == "X" and rec[1] == "api.components"]
    assert spans == [{"components": result.num_components, "method": "mask"}]
    assert result.num_components == 9
    assert BUS.counters()["api.components.masked"] == before + 1
    samples = [rec[6]["value"] for rec in events
               if rec[0] == "C" and rec[1] == "api.components.masked"]
    assert samples == [before + 1]
    assert any(rec[1] == "solver.rank.solve" for rec in events)


def test_a_count_by_the_sort_leaves_the_counter(isolated):
    before = BUS.counters().get("api.components.masked", 0)
    mark = BUS.mark()
    assert tapi.count_components(np.array([-1, 4, 4, 9])) == 3
    spans = [rec[6] for rec in BUS.events_since(mark) if rec[1] == "api.components"]
    assert spans == [{"components": 3, "method": "unique"}]
    assert BUS.counters().get("api.components.masked", 0) == before
