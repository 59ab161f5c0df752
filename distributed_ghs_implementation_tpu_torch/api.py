"""Public API: the reference implementation's entry surface, on PyTorch and CUDA.

``GHSAlgorithm(num_nodes, edges).run() -> [(u, v), ...]`` and the functional
``minimum_spanning_forest`` / ``minimum_spanning_tree`` /
``minimum_spanning_forest_batch``, as in the JAX package. ``backend``
selects the path:

  * ``"device"`` (default): the Borůvka solve on one card (``device=None``
    means CUDA; ``device="cpu"`` runs the kernels' plain PyTorch versions);
  * ``"sharded"``: the sharded solve over a mesh of the visible cards
    (``parallel/``; on the CPU one shard), ``solve_graph_sharded``;
  * ``"host"``: native single-core Kruskal over the rank order, on no card
    (integer weights);
  * ``"protocol"``: the GHS message protocol (``protocol/``), one state
    machine a vertex over a deterministic event queue, on the host; no
    card runs it, but the device rule holds as for every backend. A
    supervised solve enters the ladder at ``"device"``.

``supervised=True`` (or a ``supervisor``) runs the solve under
``utils.resilience.Supervisor``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Iterable, List, Optional, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

if TYPE_CHECKING:  # deferred: the supervisor stays off the plain path
    from distributed_ghs_implementation_tpu_torch.utils.resilience import IncidentLog

@dataclasses.dataclass
class MSTResult:
    """Everything the reference reports about a run, in one place."""

    graph: Graph
    edge_ids: np.ndarray  # indices into graph.u/v/w
    num_levels: int
    wall_time_s: float
    backend: str
    num_components: int
    # Set by supervised solves only: the structured attempt and fallback
    # record.
    incidents: Optional["IncidentLog"] = None

    @property
    def edges(self) -> List[Tuple[int, int]]:
        """MST edges as ``(min(u,v), max(u,v))`` pairs."""
        return [
            (int(a), int(b))
            for a, b in zip(self.graph.u[self.edge_ids], self.graph.v[self.edge_ids])
        ]

    @property
    def weighted_edges(self) -> List[Tuple[int, int, float]]:
        cast = int if self.graph.is_integer_weighted else float
        return [
            (int(a), int(b), cast(c))
            for a, b, c in zip(
                self.graph.u[self.edge_ids],
                self.graph.v[self.edge_ids],
                self.graph.w[self.edge_ids],
            )
        ]

    @property
    def total_weight(self):
        w = self.graph.w[self.edge_ids].sum()
        return int(w) if self.graph.is_integer_weighted else float(w)

    @property
    def num_edges(self) -> int:
        return int(self.edge_ids.shape[0])

    @property
    def is_spanning_tree(self) -> bool:
        """n-1 edges over one component."""
        return self.num_components == 1 and self.num_edges == self.graph.num_nodes - 1


def _solve(graph: Graph, backend: str, device) -> Tuple[np.ndarray, np.ndarray, int]:
    if backend == "device":
        from distributed_ghs_implementation_tpu_torch.models.boruvka import solve_graph

        return solve_graph(graph, device=device)
    if backend == "sharded":
        from distributed_ghs_implementation_tpu_torch.parallel.sharded import (
            solve_graph_sharded,
        )

        return solve_graph_sharded(graph, device=device)
    if backend == "protocol":
        from distributed_ghs_implementation_tpu_torch.protocol.runner import (
            solve_graph_protocol,
        )

        return solve_graph_protocol(graph)
    if backend == "host":
        from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
            solve_graph_kruskal_host,
        )

        return solve_graph_kruskal_host(graph)
    raise ValueError(
        f"unknown backend {backend!r}; expected device|sharded|protocol|host"
    )


def minimum_spanning_forest(
    graph: Graph,
    *,
    backend: str = "device",
    supervised: bool = False,
    supervisor=None,
    device=None,
) -> MSTResult:
    """Compute the minimum spanning forest (a tree per component) of ``graph``
    on ``device`` (``None`` = CUDA; the device rule holds for every backend).

    ``supervised=True`` runs the solve under the supervisor
    (``utils.resilience``): watchdog deadline, bounded retry with backoff on
    transient errors, and the ``sharded -> device -> stepped -> host``
    degradation ladder from ``backend`` (backends outside the ladder, such
    as ``"protocol"``, enter at ``"device"``). The result's ``backend`` then
    reads ``"supervised/<rung that succeeded>"`` and ``incidents`` holds the
    attempt log. Passing a configured ``Supervisor`` as ``supervisor``
    implies ``supervised=True``.
    """
    device = resolve_device(device)
    t0 = time.perf_counter()
    incidents = None
    supervised = supervised or supervisor is not None
    if supervised:
        from distributed_ghs_implementation_tpu_torch.utils.resilience import Supervisor

        sup = supervisor or Supervisor()
        edge_ids, fragment, levels, incidents = sup.solve(graph, entry=backend, device=device)
        backend_label = f"supervised/{incidents.final_rung or backend}"
    else:
        edge_ids, fragment, levels = _solve(graph, backend, device)
        backend_label = backend
    wall = time.perf_counter() - t0
    num_components = int(np.unique(fragment).size) if graph.num_nodes else 0
    return MSTResult(
        graph=graph,
        edge_ids=edge_ids,
        num_levels=levels,
        wall_time_s=wall,
        backend=backend_label,
        num_components=num_components,
        incidents=incidents,
    )


def minimum_spanning_forest_batch(
    graphs,
    *,
    backend: str = "device",
    policy=None,
    engine=None,
    device=None,
) -> List[MSTResult]:
    """Solve many independent graphs on ``device`` (``None`` = CUDA),
    stacking same-bucket ones into lanes of one level loop (``batch/``).

    Results are in input order and edge for edge those of per-graph
    :func:`minimum_spanning_forest`: a lane stack is a disjoint union, and
    the rank order makes each graph's forest unique. Graphs too large to
    batch (``policy.admits`` is false) bypass to supervised single-graph
    solves, as do all graphs on backends other than ``"device"``. Pass a
    ``batch.BatchPolicy`` to set lane counts and ceilings, or a built
    ``batch.BatchEngine`` to share its queue (it runs on its own device).
    """
    graphs = list(graphs)
    if backend != "device":
        return [minimum_spanning_forest(g, backend=backend, device=device) for g in graphs]
    if engine is None:
        from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine

        engine = BatchEngine(policy=policy, device=device)
    return engine.solve_many(graphs)


def minimum_spanning_tree(graph: Graph, *, backend: str = "device", device=None) -> MSTResult:
    """Like :func:`minimum_spanning_forest` but requires a connected graph."""
    result = minimum_spanning_forest(graph, backend=backend, device=device)
    if result.num_components > 1:
        raise ValueError(
            f"graph is disconnected ({result.num_components} components); "
            "use minimum_spanning_forest"
        )
    return result


class GHSAlgorithm:
    """Drop-in analog of the reference implementation's ``GHSAlgorithm``.

    >>> ghs = GHSAlgorithm(num_nodes=6, edges=[(0, 1, 1), ...])
    >>> mst_edges = ghs.run()          # [(u, v), ...]
    >>> ghs.result.total_weight
    """

    def __init__(
        self,
        num_nodes: int,
        edges: Iterable[Tuple[int, int, float]],
        *,
        backend: str = "device",
        device=None,
    ):
        self.graph = Graph.from_edges(num_nodes, edges)
        self.backend = backend
        self.device = device
        self.result: Optional[MSTResult] = None

    def run(self, timeout: float | None = None) -> List[Tuple[int, int]]:
        """Compute the MST; returns normalized edge pairs. ``timeout`` is
        accepted for signature parity and unused: the solver ends after at
        most ``ceil(log2 n) + 1`` levels."""
        del timeout
        self.result = minimum_spanning_forest(
            self.graph, backend=self.backend, device=self.device
        )
        return self.result.edges

    def get_mst_weight(self):
        if self.result is None:
            raise RuntimeError("call run() first")
        return self.result.total_weight
