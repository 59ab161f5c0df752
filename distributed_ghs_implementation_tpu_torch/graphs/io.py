"""On-disk graph formats: reference partition dirs, DIMACS, binary edge lists.

Port of the JAX package's ``graphs/io.py``; every file format is that
package's, so a graph written by either package reads in the other. The
per-vertex partition format (``node_<id>.json`` + ``graph_metadata.json``)
is the interop surface with the reference implementation's
``create_graph_files.py``, read and written bit-compatibly.

:func:`read_dimacs` parses through the port's native host library
(``graphs/native.dimacs_parse``); ``native=False`` selects the plain
Python parser, and nothing falls back to it on its own.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph


def write_partition_dir(graph: Graph, output_dir: str, *, indent: int = 2) -> str:
    """Write ``node_<id>.json`` per vertex plus ``graph_metadata.json``.

    Field-compatible with the reference's ``create_graph_files.py``: each node file holds
    ``{node_id, neighbors: {str(nbr): weight}, num_neighbors}``; metadata holds
    ``{num_nodes, num_edges, edges: [[u, v, w], ...]}``.
    """
    os.makedirs(output_dir, exist_ok=True)
    cast = int if graph.is_integer_weighted else float
    neighbors: Dict[int, Dict[str, object]] = {i: {} for i in range(graph.num_nodes)}
    for a, b, w in zip(graph.u, graph.v, graph.w):
        neighbors[int(a)][str(int(b))] = cast(w)
        neighbors[int(b)][str(int(a))] = cast(w)
    for node_id in range(graph.num_nodes):
        data = {
            "node_id": node_id,
            "neighbors": neighbors[node_id],
            "num_neighbors": len(neighbors[node_id]),
        }
        with open(os.path.join(output_dir, f"node_{node_id}.json"), "w") as f:
            json.dump(data, f, indent=indent)
    metadata = {
        "num_nodes": graph.num_nodes,
        "num_edges": graph.num_edges,
        "edges": [[int(a), int(b), cast(w)] for a, b, w in zip(graph.u, graph.v, graph.w)],
    }
    with open(os.path.join(output_dir, "graph_metadata.json"), "w") as f:
        json.dump(metadata, f, indent=indent)
    return output_dir


def read_partition_dir(graph_dir: str) -> Graph:
    """Load a graph from a partition dir (metadata fast path, node files fallback).

    Accepts dirs produced by this framework or by the reference's
    ``create_graph_files.py``. If ``graph_metadata.json`` is missing, the graph
    is reassembled from the per-node files exactly the way ``MPINode``
    reconstructs its local view (``ghs_implementation_mpi.py:74-92``).
    """
    meta_path = os.path.join(graph_dir, "graph_metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        return Graph.from_edges(meta["num_nodes"], meta["edges"])
    # Fallback: stitch node_<id>.json files.
    node_files = sorted(
        f for f in os.listdir(graph_dir) if f.startswith("node_") and f.endswith(".json")
    )
    if not node_files:
        raise FileNotFoundError(f"no graph_metadata.json or node_*.json in {graph_dir}")
    edges = []
    max_id = -1
    for fname in node_files:
        with open(os.path.join(graph_dir, fname)) as f:
            data = json.load(f)
        nid = int(data["node_id"])
        max_id = max(max_id, nid)
        for nbr, w in data["neighbors"].items():
            nbr = int(nbr)
            max_id = max(max_id, nbr)
            if nid < nbr:  # each undirected edge appears in both files
                edges.append((nid, nbr, w))
    return Graph.from_edges(max_id + 1, edges)


def read_dimacs(path: str, *, native: bool = True) -> Graph:
    """Read a DIMACS ``.gr`` shortest-path file (``a u v w`` lines, 1-indexed).

    The format of the 9th DIMACS challenge road networks. Arcs usually
    appear in both directions; duplicates collapse in ``Graph.from_arrays``.
    ``native`` parses in the port's native host library (a build or load
    that fails raises); ``native=False`` runs the plain Python parser.
    """
    if native:
        from distributed_ghs_implementation_tpu_torch.graphs import native as native_lib

        u, v, w, n = native_lib.dimacs_parse(path)
        return Graph.from_arrays(n, u, v, w)
    us, vs, ws = [], [], []
    n = 0
    with open(path) as f:
        for line in f:
            if line.startswith("p"):
                parts = line.split()
                n = int(parts[2])
            elif line.startswith("a"):
                _, a, b, w = line.split()
                us.append(int(a) - 1)
                vs.append(int(b) - 1)
                ws.append(int(w))
    return Graph.from_arrays(
        n,
        np.asarray(us, dtype=np.int64),
        np.asarray(vs, dtype=np.int64),
        np.asarray(ws, dtype=np.int64),
    )


def write_dimacs(graph: Graph, path: str, *, comment: str | None = None) -> str:
    """Write a DIMACS ``.gr`` file (both arc directions, 1-indexed — the
    layout of the 9th-challenge road networks; ``read_dimacs`` round-trips
    it, natively and with ``native=False``). The
    format is integer-weighted; refuse floats rather than truncate them."""
    if not graph.is_integer_weighted:
        raise ValueError(
            "DIMACS .gr is integer-weighted; got float weights "
            "(use write_npz for a lossless round trip)"
        )
    m = graph.num_edges
    arcs = np.empty((2 * m, 3), dtype=np.int64)
    arcs[:m, 0] = graph.u + 1
    arcs[:m, 1] = graph.v + 1
    arcs[:m, 2] = graph.w
    arcs[m:, 0] = graph.v + 1
    arcs[m:, 1] = graph.u + 1
    arcs[m:, 2] = graph.w
    with open(path, "w") as f:
        if comment:
            f.write(f"c {comment}\n")
        f.write(f"p sp {graph.num_nodes} {2 * m}\n")
        np.savetxt(f, arcs, fmt="a %d %d %d")
    return path


def write_npz(graph: Graph, path: str) -> str:
    """Binary round-trip format for large graphs (no JSON overhead)."""
    np.savez_compressed(path, num_nodes=graph.num_nodes, u=graph.u, v=graph.v, w=graph.w)
    return path


def read_npz(path: str) -> Graph:
    data = np.load(path)
    return Graph(int(data["num_nodes"]), data["u"], data["v"], data["w"])
