"""Failure diagnostics: the structured analog of the reference's debug dump.

The reference auto-prints per-node state, per-edge state, fragment membership,
and unreachable-node detection when a run produces the wrong edge count
(``ghs_implementation.py:554-641``, triggered at
``:735-737``). Here the same information is collected into one JSON artifact
whenever verification fails — machine-checkable, and it works at scales where
a per-node table could never be printed (histograms + capped samples instead).

A copy of the JAX package's ``utils/diagnostics.py`` over the port's
``MSTResult``, ``Verification`` and ``protocol`` node map; it reads host
arrays only.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

# Per-node tables are only useful (and affordable) for small graphs; above
# this the report keeps aggregates and capped samples only.
_NODE_TABLE_CAP = 512
_SAMPLE_CAP = 32


def _mst_components(num_nodes: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Component label per vertex under the harvested MST edges (the shared
    C-speed pass in ``graphs.edgelist.component_labels`` — a failed RMAT-20
    run must not spend minutes in a Python union-find)."""
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
        component_labels,
    )

    return component_labels(num_nodes, u, v)


def failure_report(result, verification=None, *, nodes: Optional[Dict] = None) -> dict:
    """Build the diagnostic dict for a (suspected wrong) :class:`MSTResult`.

    ``nodes`` is the per-node map from ``protocol.runner.run_protocol`` — when
    given, per-node protocol state and edge-state tallies are included (the
    analog of the reference's node/edge tables at
    ``ghs_implementation.py:565-597``).
    """
    graph = result.graph
    n = graph.num_nodes
    mst_u = graph.u[result.edge_ids]
    mst_v = graph.v[result.edge_ids]
    comp = _mst_components(n, mst_u, mst_v)
    roots, sizes = np.unique(comp, return_counts=True)

    # Fragment-size histogram: size -> how many fragments have that size.
    hist_sizes, hist_counts = np.unique(sizes, return_counts=True)

    # Edge disposition under the final partition: an edge between two
    # components is still "alive" (a correct spanning forest leaves none).
    inter = comp[graph.u] != comp[graph.v]
    alive_edges = int(np.count_nonzero(inter))
    wcast = int if graph.is_integer_weighted else float
    alive_sample = [
        (int(graph.u[i]), int(graph.v[i]), wcast(graph.w[i]))
        for i in np.nonzero(inter)[0][:_SAMPLE_CAP]
    ]

    # Unreachable-node detection (reference: BFS from node 0 at
    # ghs_implementation.py:621-641): vertices outside node 0's component.
    unreachable = np.nonzero(comp != comp[0])[0] if n else np.zeros(0, np.int64)

    report = {
        "schema": "ghs-failure-report-v1",
        "graph": {
            "num_nodes": n,
            "num_edges": graph.num_edges,
            "total_weight": float(graph.w.sum()),
        },
        "result": {
            "backend": result.backend,
            "num_levels": result.num_levels,
            "mst_edges": result.num_edges,
            "mst_weight": float(result.total_weight),
            "num_components": result.num_components,
        },
        "verification": None
        if verification is None
        else {
            "ok": bool(verification.ok),
            "oracle": verification.oracle,
            "expected_weight": verification.expected_weight,
            "actual_weight": verification.actual_weight,
            "expected_edges": verification.expected_edges,
            "actual_edges": verification.actual_edges,
        },
        "fragments": {
            "count": int(roots.size),
            "size_histogram": {int(s): int(c) for s, c in zip(hist_sizes, hist_counts)},
            "largest": sorted(
                ((int(r), int(s)) for r, s in zip(roots, sizes)),
                key=lambda x: -x[1],
            )[:_SAMPLE_CAP],
        },
        "edges": {
            "alive_inter_fragment": alive_edges,
            "alive_sample": alive_sample,
        },
        "unreachable_from_node0": {
            "count": int(unreachable.size),
            "sample": [int(x) for x in unreachable[:_SAMPLE_CAP]],
        },
    }

    if nodes is not None:
        from distributed_ghs_implementation_tpu_torch.protocol.messages import EdgeState

        edge_state_totals = {s.name: 0 for s in EdgeState}
        node_rows = []
        for vid in sorted(nodes):
            node = nodes[vid]
            for e in node.edges.values():
                edge_state_totals[e.state.name] += 1
            if len(node_rows) < _NODE_TABLE_CAP:
                node_rows.append(
                    {
                        "id": node.id,
                        "state": node.state.name,
                        "level": node.level,
                        "fragment": node.fragment,
                        "find_count": node.find_count,
                        "best_edge": node.best_edge,
                        "in_branch": node.in_branch,
                        "halted": node.halted,
                        "messages_processed": node.messages_processed,
                        "edge_states": {
                            str(e.neighbor): e.state.name for e in node.edges.values()
                        },
                    }
                )
        report["protocol"] = {
            "edge_state_totals": edge_state_totals,
            "nodes_truncated": len(nodes) > _NODE_TABLE_CAP,
            "nodes": node_rows,
        }
    return report


def dump_failure_report(
    result, verification=None, *, nodes=None, path: str = "ghs_failure_report.json"
) -> str:
    """Write :func:`failure_report` to ``path`` (the auto-dump trigger analog
    of ``ghs_implementation.py:735-737``); returns the path."""
    report = failure_report(result, verification, nodes=nodes)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path
