"""The plain reference for float weights: the minimum spanning forest of a
canonical edge list whose weights are float64, in plain PyTorch, on
whatever device its tensors live.

It imports nothing of the system under test. It ranks the edges by one
stable sort of the weights (:func:`rank_order`, also held against the
system's own rank order), so equal weights keep edge id order (-0.0 is
read as +0.0, which it equals), and runs the plain reference's Borůvka
rounds (``reference._boruvka``) on the int32 ranks. The forest is then the
unique one under the ``(weight, edge id)`` order that the system
guarantees. NaN weights have no place in that order here, and are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ghs_bench.reference import _INF, _boruvka


def rank_order(w, *, device="cpu", float32: bool = False) -> torch.Tensor:
    """The edge ids by ``(weight, edge id)``, int64 on ``device``: one
    stable sort of the float64 weights ``w``. The control breaks the
    guarantee on purpose: ``float32`` sorts the weights rounded to float32
    (a lower precision, ``w.float().double()``)."""
    w = torch.as_tensor(w, dtype=torch.float64, device=device)
    if w.numel() and bool(torch.isnan(w).any()):
        raise ValueError("the reference takes no NaN weights")
    if float32:
        w = w.float().double()
    return torch.sort(w + 0.0, stable=True).indices  # -0.0 + 0.0 is +0.0


def msf_ids(num_nodes: int, u, v, w, *, device="cpu", float32: bool = False) -> np.ndarray:
    """Sorted edge ids of the minimum spanning forest of one canonical
    graph with float weights, over :func:`rank_order` (``float32``: the
    control's order)."""
    u = torch.as_tensor(u, device=device).to(torch.int64)
    v = torch.as_tensor(v, device=device).to(torch.int64)
    m = int(u.numel())
    if m >= _INF:
        raise ValueError(f"{m} edges do not fit int32 ranks")
    order = rank_order(w, device=device, float32=float32)
    rank = torch.empty(m, dtype=torch.int32, device=device)
    rank[order] = torch.arange(m, dtype=torch.int32, device=device)
    forest = _boruvka(int(num_nodes), u, v, rank)
    del u, v, rank
    return torch.sort(order[forest.to(torch.int64)]).values.cpu().numpy()
