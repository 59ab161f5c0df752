"""Shared pieces of the port's parity tests of supervision, checkpoints,
metrics and the event bus (``test_torch_resilience.py``,
``test_torch_checkpoint.py``, ``test_torch_metrics.py``,
``test_torch_obs.py``).

* The graphs: one of each family, made by the same makers from the same
  seeds in both packages (the graphs of ``test_torch_rank.py``), and the
  dense graph of ``test_torch_filtered.py`` for the filter route, whose
  thresholds :func:`lower_filter_width` lowers on both sides.
* Isolation: each package has its own fault registry and its own event bus.
  The :func:`isolated` fixture resets both registries, clears
  ``GHS_FAULT_*`` from the environment, turns both buses on, and keeps the
  JAX package off its native library (its host passes take their NumPy
  branches, as in the other parity tests).
* :func:`jax_native`: for the host backend, the JAX package's own native
  library, built from its source into a temporary directory and loaded by
  its own loader, so that no test writes the library in place.
* A virtual clock, and event sequences without their times.
"""

import os
import subprocess

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.graphs import native as jnative
from distributed_ghs_implementation_tpu.models import rank_solver as jrs
from distributed_ghs_implementation_tpu.obs import events as jevents
from distributed_ghs_implementation_tpu.utils import resilience as jres
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import rank_solver as trs
from distributed_ghs_implementation_tpu_torch.obs import events as tevents
from distributed_ghs_implementation_tpu_torch.utils import resilience as tres

CPU = "cpu"
_JAX_GET_LIB = jnative.get_lib


def _two_grids(edge_mod, gen):
    """Two road grids and 7 isolated vertices: 9 components."""
    g1 = gen.road_grid_graph(30, 30, seed=5)
    g2 = gen.road_grid_graph(12, 12, seed=6)
    off = g1.num_nodes
    return edge_mod.Graph.from_arrays(
        off + g2.num_nodes + 7, np.concatenate([g1.u, g2.u + off]),
        np.concatenate([g1.v, g2.v + off]), np.concatenate([g1.w, g2.w]))


#: name -> maker(edgelist module, generators module, **rmat keywords): one
#: graph of each family (dense, grid, sparse) and a forest with isolated
#: vertices; ``rmat11`` takes the filter route under
#: :func:`lower_filter_width`.
GRAPHS = {
    "rmat": lambda e, g, **k: g.rmat_graph(10, 16, seed=3, **k),
    "grid": lambda e, g, **k: g.road_grid_graph(40, 50, seed=2),
    "road": lambda e, g, **k: g.random_road_network(40, 40, seed=3),
    "forest": lambda e, g, **k: _two_grids(e, g),
    "rmat11": lambda e, g, **k: g.rmat_graph(11, 16, seed=3, **k),
}
FAMILIES = ["rmat", "grid", "road", "forest"]


def pair(name):
    """A fresh ``(jax_graph, port_graph)``; the JAX RMAT sampler runs
    without its native code, as the port's does below scale 16."""
    kw = {"use_native": False} if name.startswith("rmat") else {}
    make = GRAPHS[name]
    return make(jedge, jgen, **kw), make(tedge, tgen)


def lower_filter_width(monkeypatch):
    """Dense graphs of 2^14 ranks and more take the filter route, in both
    packages."""
    for mod in (trs, jrs):
        monkeypatch.setattr(mod, "_FILTER_MIN_RANKS", 1024)


def set_both(monkeypatch, **values):
    """Set the same rank-solver constants in both packages."""
    for name, value in values.items():
        for mod in (trs, jrs):
            monkeypatch.setattr(mod, name, value)


@pytest.fixture
def isolated(monkeypatch):
    for key in [k for k in os.environ if k.startswith("GHS_FAULT_")]:
        monkeypatch.delenv(key)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    for mod in (jevents, tevents):
        monkeypatch.setattr(mod.BUS, "enabled", True)
    for mod in (jres, tres):
        mod.FAULTS.reset()
    yield
    for mod in (jres, tres):
        mod.FAULTS.reset()


@pytest.fixture(scope="session")
def jax_native_library(tmp_path_factory):
    """The JAX package's ``native/graph_native.cpp``, built as its loader
    builds it, into a directory of this test run's own."""
    out = tmp_path_factory.mktemp("jax_native") / "libgraph_native.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                    jnative._SRC, "-o", str(out)], check=True, capture_output=True, timeout=300)
    return str(out)


@pytest.fixture
def jax_native(monkeypatch, isolated, jax_native_library):
    """The JAX package with its native library (for its host backend),
    loaded from :func:`jax_native_library` by its own loader."""
    monkeypatch.setattr(jnative, "_SO", jax_native_library)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    monkeypatch.setattr(jnative, "get_lib", _JAX_GET_LIB)
    assert jnative.get_lib() is not None


class VirtualClock:
    """``clock`` and ``sleep`` for a supervisor: time stands still unless
    a sleep moves it; the sleeps are recorded."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def clock(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


def _args(args, port: bool):
    """An event's arguments; the JAX package's ``kernel`` value (``xla`` on
    the CPU) reads as the port's (``torch``)."""
    out = dict(args or {})
    if not port and out.get("kernel") in ("xla", "pallas"):
        out["kernel"] = "torch"
    return out


def event_trail(bus, mark, *, port: bool, prefixes=("resilience.", "solver.", "metrics.")):
    """``(phase, name, args)`` of the events since ``mark`` whose names
    start with ``prefixes``, in order, without their times."""
    return [(rec[0], rec[1], _args(rec[6], port)) for rec in bus.events_since(mark)
            if rec[1].startswith(prefixes)]


def incident_trail(log):
    return [(r.rung, r.attempt, r.outcome, r.site, r.backoff_s) for r in log.records]
