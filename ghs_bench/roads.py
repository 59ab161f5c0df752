"""A connected planar road network, made from ``--seed`` on the device in
plain PyTorch.

The 9th DIMACS Implementation Challenge's USA graph (``USA-road-d.USA``)
cannot be read here, so the road configurations run a generated network
at its counts. The model, in the order :func:`road_network` builds it:

* a lattice of ``rows x cols`` cells, each holding one intersection with
  probability ``occupancy``, jittered to an integer point inside its cell
  (a cell is :data:`CELL` units long);
* candidate links between occupied cells that are axis neighbours (right,
  down) and, in each square of four cells, along one of its two diagonals,
  chosen at random, so that no two links cross at the lattice's level;
* the backbone: the plain reference's spanning forest
  (:func:`ghs_bench.reference.msf_ids`) of the candidate links under
  distinct random keys, cut to its largest tree, whose vertices are
  renumbered in row-major lattice order;
* more candidate links inside that tree's vertices, drawn at random until
  the edge count reaches ``edges_per_vertex`` times the vertex count.

Weights are the rounded Euclidean length of each link, at least 1 and
below ``2 * sqrt(2) * CELL``, integer distances as the DIMACS files have
them. The result is canonical: ``u < v``, rows sorted by ``(u, v)``, no
loops, no parallel links, int64, and one connected component.

The random draws (:func:`draw`) are apart from the construction
(:func:`assemble`), so that a test can build the same network from the
same draws another way.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ghs_bench import graphs, reference

CELL = 4096  # lattice units a cell is long

#: Hook-and-jump rounds the components count may take before it gives up.
_COMPONENT_ROUNDS = 256


def draw(rows: int, cols: int, *, occupancy: float, seed: int, stream: int = 0,
         device="cpu") -> Dict[str, torch.Tensor]:
    """The network's random draws, from one ``torch.Generator`` on
    ``device`` seeded by ``graphs.torch_seed(seed, stream)``: which cells
    hold a point (``occupied``), each point's offset in its cell (``jx``,
    ``jy``), each square's diagonal (``diagonal``: 0 joins its top-left
    and bottom-right cells, 1 its top-right and bottom-left), and two
    random orders of the candidate links (``tree_key``, ``extra_key``,
    distinct int64 keys from 1)."""
    if rows < 2 or cols < 2:
        raise ValueError("the lattice needs at least 2 x 2 cells")
    gen = torch.Generator(device=device)
    gen.manual_seed(graphs.torch_seed(seed, stream))
    cells = rows * cols
    occupied = torch.rand(cells, generator=gen, device=device) < occupancy
    jx = torch.randint(0, CELL, (cells,), generator=gen, device=device)
    jy = torch.randint(0, CELL, (cells,), generator=gen, device=device)
    diagonal = torch.randint(0, 2, ((rows - 1) * (cols - 1),), generator=gen, device=device)
    a, _ = candidates(rows, cols, occupied, diagonal)
    links = int(a.numel())
    tree_key = torch.randperm(links, generator=gen, device=device) + 1
    extra_key = torch.randperm(links, generator=gen, device=device) + 1
    return dict(occupied=occupied, jx=jx, jy=jy, diagonal=diagonal, tree_key=tree_key,
                extra_key=extra_key)


def candidates(rows: int, cols: int, occupied: torch.Tensor, diagonal: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate links ``(a, b)`` between occupied cells, as row-major
    cell ids with ``a < b``: every right link, then every down link, then
    each square's diagonal, each group in cell order."""
    dev = occupied.device
    cell = torch.arange(rows * cols, device=dev).view(rows, cols)
    right = (cell[:, :-1].reshape(-1), cell[:, 1:].reshape(-1))
    down = (cell[:-1, :].reshape(-1), cell[1:, :].reshape(-1))
    top_left = cell[:-1, :-1].reshape(-1)
    flip = diagonal.to(torch.int64)
    diag = (top_left + flip, top_left + cols + 1 - flip)
    a = torch.cat([right[0], down[0], diag[0]])
    b = torch.cat([right[1], down[1], diag[1]])
    keep = occupied[a] & occupied[b]
    return a[keep], b[keep]


def components(num_nodes: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Each vertex's component, named by its least vertex id (int64): each
    round every root hooks onto the least root across its crossing links,
    then pointer jumping flattens the trees."""
    label = torch.arange(num_nodes, dtype=torch.int32, device=u.device)
    for _ in range(_COMPONENT_ROUNDS):
        lu, lv = label[u], label[v]
        cross = lu != lv
        if not bool(cross.any()):
            return label.to(torch.int64)
        lo = torch.minimum(lu, lv)[cross]
        hi = torch.maximum(lu, lv)[cross]
        label.scatter_reduce_(0, hi.to(torch.int64), lo, "amin")
        while True:
            nxt = label[label.to(torch.int64)]
            if torch.equal(nxt, label):
                break
            label = nxt
    raise RuntimeError(f"the components count did not settle in {_COMPONENT_ROUNDS} rounds")


def assemble(rows: int, cols: int, draws: Dict[str, torch.Tensor], *,
             edges_per_vertex: float):
    """The canonical network of ``draws``: ``(num_nodes, u, v, w)``, the
    three int64 tensors sorted by ``(u, v)`` on the draws' device."""
    occupied = draws["occupied"]
    dev = occupied.device
    a, b = candidates(rows, cols, occupied, draws["diagonal"])
    # Occupied cells numbered in row-major order.
    occ_id = torch.cumsum(occupied, 0) - 1
    n_occ = int(occupied.sum())
    ca, cb = occ_id[a], occ_id[b]
    tree = torch.from_numpy(reference.msf_ids(n_occ, ca, cb, draws["tree_key"], device=dev))
    tree = tree.to(dev)
    comp = components(n_occ, ca[tree], cb[tree])
    sizes = torch.bincount(comp, minlength=n_occ)
    keep = comp == int(torch.argmax(sizes))  # ties: the least-numbered piece
    n = int(keep.sum())
    in_tree = torch.zeros(ca.numel(), dtype=torch.bool, device=dev)
    in_tree[tree] = True
    spare = torch.nonzero(~in_tree & keep[ca] & keep[cb]).flatten()
    extra = int(round(edges_per_vertex * n)) - (n - 1)
    if extra > spare.numel():
        raise ValueError(f"{extra} extra links asked of {spare.numel()} spare candidates")
    pick = spare[torch.argsort(draws["extra_key"][spare])[:max(extra, 0)]]
    links = torch.cat([tree[keep[ca[tree]]], pick])
    new_id = torch.cumsum(keep, 0) - 1
    la, lb = a[links], b[links]
    u, v = new_id[ca[links]], new_id[cb[links]]
    order = torch.argsort(u * n + v)
    u, v, la, lb = u[order], v[order], la[order], lb[order]
    x = (la % cols) * CELL + draws["jx"][la], (lb % cols) * CELL + draws["jx"][lb]
    y = (la // cols) * CELL + draws["jy"][la], (lb // cols) * CELL + draws["jy"][lb]
    d2 = (x[1] - x[0]) ** 2 + (y[1] - y[0]) ** 2
    w = torch.round(torch.sqrt(d2.to(torch.float64))).to(torch.int64).clamp_(min=1)
    return n, u, v, w


def road_network(rows: int, cols: int, *, occupancy: float, edges_per_vertex: float,
                 seed: int, stream: int = 0, device="cpu"):
    """:func:`assemble` of :func:`draw`: a connected canonical road network
    ``(num_nodes, u, v, w)`` on ``device``."""
    draws = draw(rows, cols, occupancy=occupancy, seed=seed, stream=stream, device=device)
    return assemble(rows, cols, draws, edges_per_vertex=edges_per_vertex)
