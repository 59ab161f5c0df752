"""Run the GHS protocol over a graph and harvest the MST.

The backend-facing wrapper (the role ``GHSAlgorithm.run`` plays for threads at
``ghs_implementation.py:442-490``): builds one
:class:`GHSNode` per vertex with rank-valued edges, wakes all nodes, drains
the event queue to quiescence, and harvests BRANCH edges as the MST.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.protocol.messages import EdgeState
from distributed_ghs_implementation_tpu_torch.protocol.node import GHSNode
from distributed_ghs_implementation_tpu_torch.protocol.transport import SimTransport


def run_protocol(
    graph: Graph, *, transport: Optional[SimTransport] = None
) -> Tuple[Dict[int, GHSNode], SimTransport]:
    """Execute the protocol to quiescence; returns the node map + transport."""
    transport = transport or SimTransport()
    m = graph.num_edges
    order = graph.edge_id_of_rank(np.arange(m))
    rank_of_edge = np.empty(m, dtype=np.int64)
    rank_of_edge[order] = np.arange(m)

    adjacency: Dict[int, Dict[int, int]] = {v: {} for v in range(graph.num_nodes)}
    for eid, (a, b) in enumerate(zip(graph.u, graph.v)):
        r = int(rank_of_edge[eid])
        adjacency[int(a)][int(b)] = r
        adjacency[int(b)][int(a)] = r

    nodes: Dict[int, GHSNode] = {}
    for v in range(graph.num_nodes):
        nodes[v] = GHSNode(
            v,
            adjacency[v],
            send=lambda dst, msg, _src=v: transport.send(_src, dst, msg),
        )
    for v in range(graph.num_nodes):
        nodes[v].wakeup()
    transport.run(nodes)
    return nodes, transport


def solve_graph_protocol(
    graph: Graph, *, transport: Optional[SimTransport] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Backend entry matching ``models.boruvka.solve_graph``'s contract.

    ``transport`` lets callers run the protocol over a misbehaving channel
    (``protocol.faults``) — the chaos drill's entry point.
    """
    if graph.num_nodes == 0 or graph.num_edges == 0:
        return (
            np.zeros(0, dtype=np.int64),
            np.arange(graph.num_nodes, dtype=np.int32),
            0,
        )
    nodes, _ = run_protocol(graph, transport=transport)

    # Harvest BRANCH edges (each appears as BRANCH on both endpoints).
    branch_pairs = set()
    for v, node in nodes.items():
        for e in node.edges.values():
            if e.state == EdgeState.BRANCH:
                branch_pairs.add((min(v, e.neighbor), max(v, e.neighbor)))
    pair_to_eid = {
        (int(a), int(b)): eid for eid, (a, b) in enumerate(zip(graph.u, graph.v))
    }
    edge_ids = np.sort([pair_to_eid[p] for p in branch_pairs]).astype(np.int64)

    # Component labels from the harvested tree (host union-find), matching the
    # kernel's fragment contract (labels are root ids).
    parent = np.arange(graph.num_nodes, dtype=np.int32)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    for a, b in branch_pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    fragment = np.fromiter(
        (find(v) for v in range(graph.num_nodes)), dtype=np.int32, count=graph.num_nodes
    )
    levels = max((n.level for n in nodes.values()), default=0)
    return edge_ids, fragment, int(levels)
