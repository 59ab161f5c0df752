"""The plain reference: the minimum spanning forest by Borůvka's rounds in
plain PyTorch, on whatever device its tensors live.

It imports nothing of the system under test. It is handed the same
canonical edge lists as the system and works out the forest under the
order the system guarantees: by weight, ties by edge id (the row in the
canonical list). Every key ``weight * 2**B + id`` is then distinct, so the
forest is unique and any exact solver returns the same ids. One sort ranks
the keys.

Each round every component takes its least-ranked incident edge (one
``scatter_reduce`` per endpoint), the chosen edges join the forest, each
component points at the component across its edge, a mutual pair keeps the
smaller id as root, and pointer jumping flattens the trees.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = torch.iinfo(torch.int32).max


def _boruvka(num_nodes: int, u: torch.Tensor, v: torch.Tensor, rank: torch.Tensor
             ) -> torch.Tensor:
    """Ranks of the forest's edges, unsorted, given each edge's distinct
    int32 ``rank``. (An int32 minimum is one hardware atomic; an int64 one
    is a compare-and-swap loop, which crawls where a giant component draws
    every edge to one address.)"""
    dev = u.device
    iota = torch.arange(num_nodes, device=dev)
    comp = iota
    chosen = []
    while True:
        cu, cv = comp[u], comp[v]
        live = cu != cv
        cu, cv, u, v, rank = cu[live], cv[live], u[live], v[live], rank[live]
        if cu.numel() == 0:
            break
        best = torch.full((num_nodes,), _INF, dtype=torch.int32, device=dev)
        best.scatter_reduce_(0, cu, rank, "amin")
        best.scatter_reduce_(0, cv, rank, "amin")
        win_u = rank == best[cu]
        win_v = rank == best[cv]
        chosen.append(rank[win_u | win_v])
        parent = iota.clone()
        parent[cu[win_u]] = cv[win_u]
        parent[cv[win_v]] = cu[win_v]
        mutual = (parent[parent] == iota) & (iota < parent)
        parent[mutual] = iota[mutual]
        while True:
            nxt = parent[parent]
            if torch.equal(nxt, parent):
                break
            parent = nxt
        comp = parent[comp]
    if not chosen:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return torch.cat(chosen)


def msf_ids(num_nodes: int, u, v, w, *, device="cpu", drop_weight_bits: int = 0
            ) -> np.ndarray:
    """Sorted edge ids of the minimum spanning forest of one canonical
    graph. The control breaks the guarantee on purpose:
    ``drop_weight_bits`` > 0 computes the forest on weights cut to fewer
    bits (``w >> drop_weight_bits``, a lower precision)."""
    u = torch.as_tensor(u, device=device).to(torch.int64)
    v = torch.as_tensor(v, device=device).to(torch.int64)
    w = torch.as_tensor(w, device=device).to(torch.int64)
    m = int(u.numel())
    if m and int(w.min()) < 0:
        raise ValueError("the reference takes non-negative integer weights")
    if m >= _INF:
        raise ValueError(f"{m} edges do not fit int32 ranks")
    id_bits = max(1, m.bit_length())
    order = torch.argsort(((w >> drop_weight_bits) << id_bits)
                          | torch.arange(m, device=device))
    del w
    rank = torch.empty(m, dtype=torch.int32, device=device)
    rank[order] = torch.arange(m, dtype=torch.int32, device=device)
    forest = _boruvka(int(num_nodes), u, v, rank)
    del u, v, rank
    return torch.sort(order[forest.to(torch.int64)]).values.cpu().numpy()


def mismatch(got, want) -> int:
    """Edges in one forest and not the other, plus any id the answer repeats
    (0: the same forest). On the device of ``want`` when it is a tensor."""
    dev = want.device if torch.is_tensor(want) else "cpu"
    got = torch.as_tensor(np.asarray(got, dtype=np.int64), device=dev)
    want = torch.as_tensor(want, device=dev).to(torch.int64)
    uniq = torch.unique(got)
    return int((~torch.isin(uniq, want)).sum()) + int((~torch.isin(want, uniq)).sum()) + int(
        got.numel() - uniq.numel())
