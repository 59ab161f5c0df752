"""Visualization: side-by-side original/MST PNGs for small graphs (the
port's copy of the JAX package's ``utils/viz.py``).

Parity with the reference's matplotlib output
(``ghs_implementation.py:643-699`` and
``ghs_implementation_mpi.py:824-879``, input render at
``create_graph_files.py:97-124``): spring layout, edge-weight labels, MST
edges highlighted. Degrades to a no-op with a warning above ``max_nodes``
(the reference would happily hang rendering a million-node graph).
matplotlib and NetworkX are imported inside the functions (NetworkX
through ``importlib``, as ``graphs.generators.reference_random_graph``
does): nothing else of the port needs them, and the package loads without
them.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

DEFAULT_MAX_NODES = 500


def _edge_triples(graph: Graph) -> list:
    """Edges as ``[(u, v, w), ...]`` with Python scalars."""
    cast = int if graph.is_integer_weighted else float
    return [(int(a), int(b), cast(c)) for a, b, c in zip(graph.u, graph.v, graph.w)]


def _to_networkx(graph: Graph):
    nx = importlib.import_module("networkx")

    g = nx.Graph()
    g.add_nodes_from(range(graph.num_nodes))
    g.add_weighted_edges_from(_edge_triples(graph))
    return g


def visualize_graph(
    graph: Graph,
    output_path: str,
    *,
    seed: int = 42,
    max_nodes: int = DEFAULT_MAX_NODES,
) -> Optional[str]:
    """Render the input graph alone (``create_graph_files.py:97-124`` parity)."""
    if graph.num_nodes > max_nodes:
        print(
            f"viz skipped: {graph.num_nodes} nodes > max_nodes={max_nodes}",
            file=sys.stderr,
        )
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    nx = importlib.import_module("networkx")

    g = _to_networkx(graph)
    pos = nx.spring_layout(g, seed=seed)
    fig, ax = plt.subplots(figsize=(10, 8))
    nx.draw_networkx(g, pos, ax=ax, node_color="lightblue", node_size=500)
    nx.draw_networkx_edge_labels(
        g, pos, ax=ax, edge_labels={(a, b): w for a, b, w in _edge_triples(graph)}
    )
    ax.set_title(f"Input graph: {graph.num_nodes} nodes, {graph.num_edges} edges")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(output_path, dpi=110)
    plt.close(fig)
    return output_path


def visualize_mst(
    result,
    output_path: str,
    *,
    seed: int = 42,
    max_nodes: int = DEFAULT_MAX_NODES,
) -> Optional[str]:
    """Side-by-side original vs MST (``ghs_implementation.py:643-699`` parity).

    ``result`` is an :class:`~distributed_ghs_implementation_tpu_torch.api.MSTResult`.
    """
    graph: Graph = result.graph
    if graph.num_nodes > max_nodes:
        print(
            f"viz skipped: {graph.num_nodes} nodes > max_nodes={max_nodes}",
            file=sys.stderr,
        )
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    nx = importlib.import_module("networkx")

    g = _to_networkx(graph)
    pos = nx.spring_layout(g, seed=seed)
    mst_edges = set(result.edges)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 7))

    nx.draw_networkx(g, pos, ax=ax1, node_color="lightblue", node_size=450)
    nx.draw_networkx_edge_labels(
        g, pos, ax=ax1, edge_labels={(a, b): w for a, b, w in _edge_triples(graph)}
    )
    ax1.set_title(f"Original: {graph.num_nodes} nodes, {graph.num_edges} edges")
    ax1.axis("off")

    nx.draw_networkx_nodes(g, pos, ax=ax2, node_color="lightgreen", node_size=450)
    nx.draw_networkx_labels(g, pos, ax=ax2)
    nx.draw_networkx_edges(
        g,
        pos,
        ax=ax2,
        edgelist=[e for e in g.edges() if (min(e), max(e)) in mst_edges],
        width=2.5,
        edge_color="darkgreen",
    )
    nx.draw_networkx_edge_labels(
        g,
        pos,
        ax=ax2,
        edge_labels={
            (a, b): w for a, b, w in result.weighted_edges
        },
    )
    ax2.set_title(
        f"MST: {result.num_edges} edges, total weight {result.total_weight} "
        f"({result.backend} backend, {result.num_levels} levels)"
    )
    ax2.axis("off")
    fig.tight_layout()
    fig.savefig(output_path, dpi=110)
    plt.close(fig)
    return output_path
