"""Entry points of the port: one solve's function, and a multi-shard dry run.

The port's counterpart of the repository's ``__graft_entry__.py`` (which
serves the JAX package and stays as it is):

* :func:`entry` returns the flagship solve, ``models.boruvka.boruvka_solve``
  (the whole Borůvka contraction from the identity partition), with its
  example arguments for ``readme_sample_graph``, staged on ``device``;
* :func:`dryrun_multichip` runs every sharded solve on an ``n``-shard
  ``EdgeMesh`` (edge-sharded inputs, replicated vertex state, ``pmin``
  combines) and holds each against the single-device solve: the flat, ELL,
  rank, filtered rank and split-key ``rank64`` programs on a dense graph,
  an RMAT-12, a road network and a forest with isolated vertices.

On one card ``dryrun_multichip(4)`` puts four shards on it. Both run on
``device`` (``None`` = CUDA; ``"cpu"`` runs the kernels' plain versions).
``python -m distributed_ghs_implementation_tpu_torch.entry`` runs both on
the card, the dry run on four shards.
"""

from __future__ import annotations

import sys

import numpy as np


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is one whole solve of
    the README's sample graph, ``(mst_ranks, fragment, levels)``."""
    from distributed_ghs_implementation_tpu_torch.graphs.generators import readme_sample_graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import (
        boruvka_solve,
        prepare_device_arrays,
    )

    g = readme_sample_graph()
    return boruvka_solve, prepare_device_arrays(g, device=device)


def _forest_graph():
    """Three components (RMAT blocks kept connected by a spanning path) and
    20 isolated vertices: 23 components."""
    from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
    from distributed_ghs_implementation_tpu_torch.graphs.generators import rmat_graph

    rng = np.random.default_rng(11)
    parts = []
    base = 0
    for nn in (70, 50, 40):
        comp = rmat_graph(7, 4, seed=int(nn))
        keep = (comp.u < nn) & (comp.v < nn)
        parts.append(np.stack([comp.u[keep] + base, comp.v[keep] + base, comp.w[keep]], axis=1))
        ids = np.arange(nn - 1)
        w_path = rng.integers(1, 255, nn - 1)
        parts.append(np.stack([ids + base, ids + 1 + base, w_path], axis=1))
        base += nn
    edges = np.concatenate(parts)
    return Graph.from_arrays(base + 20, edges[:, 0], edges[:, 1], edges[:, 2])


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the sharded solves on an ``n_devices``-shard mesh and hold each
    against the single-device solve; raises ``AssertionError`` at the first
    that differs. Returns the counts it printed."""
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        erdos_renyi_graph,
        random_road_network,
        rmat_graph,
    )
    from distributed_ghs_implementation_tpu_torch.models.boruvka import solve_graph
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
    from distributed_ghs_implementation_tpu_torch.parallel.rank_sharded import (
        solve_graph_rank_sharded,
    )
    from distributed_ghs_implementation_tpu_torch.parallel.sharded import solve_graph_sharded
    from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels

    mesh = edge_mesh(num_shards=n_devices, device=device)

    def same(got, want, what):
        if not np.array_equal(got, want):
            raise AssertionError(f"{what} diverged from the single-device solve")

    g = erdos_renyi_graph(48, 0.2, seed=11)
    ref_ids, _, _ = solve_graph(g, device=device)
    # Both sharded layouts: the edge-sharded flat loop and the row-sharded ELL.
    edge_ids, fragment, levels = solve_graph_sharded(g, mesh=mesh, strategy="flat")
    same(edge_ids, ref_ids, "flat sharded solve")
    if count_labels(fragment) != 1:
        raise AssertionError("connected graph did not contract to one fragment")
    same(solve_graph_sharded(g, mesh=mesh, strategy="ell")[0], ref_ids, "ELL sharded solve")
    same(solve_graph_sharded(g, mesh=mesh, strategy="rank")[0], ref_ids, "rank sharded solve")
    same(solve_graph_rank_sharded(g, mesh=mesh, filtered=True)[0], ref_ids,
         "filtered rank sharded solve")

    # The production paths at ~30k edges (RMAT-12): thousands of slots a
    # shard, so the compaction, the local sizing and the packed harvest run
    # at real occupancy.
    g2 = rmat_graph(12, 8, seed=11)
    ref2, _, _ = solve_graph(g2, strategy="rank", device=device)
    rank2, _, _ = solve_graph_sharded(g2, mesh=mesh, strategy="rank")
    same(rank2, ref2, "rank sharded at RMAT-12")
    same(solve_graph_rank_sharded(g2, mesh=mesh, filtered=True)[0], ref2,
         "filtered rank sharded at RMAT-12")

    # The sparse road family: high diameter, average degree ~3, through the
    # plain sharded head and the capacity guard's levels.
    g3 = random_road_network(40, 40, seed=11)
    ref3, _, _ = solve_graph(g3, strategy="rank", device=device)
    road_rank, _, _ = solve_graph_sharded(g3, mesh=mesh, strategy="rank")
    same(road_rank, ref3, "rank sharded on the road family")
    same(solve_graph_rank_sharded(g3, mesh=mesh, filtered=True)[0], ref3,
         "filtered rank sharded on the road family")

    # A forest: the solve stops at each component's fixpoint, and the
    # fragment count is the component count on every sharded path.
    g4 = _forest_graph()
    ref4, ref4_frag, _ = solve_graph(g4, strategy="rank", device=device)
    n_comp = count_labels(ref4_frag)
    if n_comp != 3 + 20:
        raise AssertionError(f"forest fixture has {n_comp} components, wanted 23")
    for what, (ids, frag, _) in (
        ("rank sharded", solve_graph_sharded(g4, mesh=mesh, strategy="rank")),
        ("filtered rank sharded", solve_graph_rank_sharded(g4, mesh=mesh, filtered=True)),
    ):
        same(ids, ref4, f"{what} on the forest")
        if count_labels(frag) != n_comp:
            raise AssertionError(f"{what} merged across forest components")

    # The split-key rank64 program (int32 device state, two-pmin combine).
    same(solve_graph_rank_sharded(g2, mesh=mesh, rank64=True)[0], ref2,
         "rank64 split-key program at RMAT-12")

    counts = {"shards": mesh.size, "er_edges": g.num_edges, "er_mst_edges": len(edge_ids),
              "levels": int(levels), "rmat12_edges": g2.num_edges,
              "rmat12_mst_edges": len(rank2), "road_edges": g3.num_edges,
              "road_msf_edges": len(road_rank), "forest_edges": g4.num_edges,
              "forest_msf_edges": len(ref4), "components": int(n_comp)}
    print(
        f"dryrun_multichip ok: {mesh.size} shards; ER {g.num_edges} edges -> "
        f"{len(edge_ids)} MST edges, {levels} levels; RMAT-12 {g2.num_edges} edges -> "
        f"{len(rank2)} MST edges; road {g3.num_edges} edges -> {len(road_rank)} MSF "
        f"edges; forest {g4.num_edges} edges -> {len(ref4)} MSF edges, {n_comp} "
        f"components (flat, ELL, rank, filtered and rank64 shardings)"
    )
    return counts


def main() -> int:
    fn, example_args = entry()
    _, fragment, levels = fn(*example_args)
    print(f"entry(): {levels} levels, {int(fragment.unique().numel())} fragment(s)")
    dryrun_multichip(4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
