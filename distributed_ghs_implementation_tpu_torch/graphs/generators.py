"""Seeded graph generators: Erdős–Rényi, G(n, m), RMAT, road networks and
fixtures.

The port's own copies of the samplers in the JAX package's
``graphs/generators.py``: on the same seed each gives the same ``u/v/w`` as
its counterpart there. ``rmat_graph`` draws, as there, from the native
generator at scale 16 and above and from NumPy below.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.graphs import native
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import (
    Graph,
    component_labels,
)


def _connect_components(
    u: np.ndarray, v: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Append ``components - 1`` edges chaining each component's smallest
    vertex to the next, so the graph is connected."""
    labels = component_labels(num_nodes, u, v)
    if labels.size and labels.max() == 0:
        return u, v
    _, reps = np.unique(labels, return_index=True)
    u = np.concatenate([u, reps[:-1].astype(u.dtype)])
    v = np.concatenate([v, reps[1:].astype(v.dtype)])
    return u, v


def erdos_renyi_graph(
    num_nodes: int,
    edge_probability: float,
    *,
    seed: int = 0,
    weight_low: int = 1,
    weight_high: int = 10,
    ensure_connected: bool = True,
) -> Graph:
    """G(n, p) with integer weights in ``[weight_low, weight_high]``."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    if n < 1:
        raise ValueError("num_nodes must be >= 1")
    if n > 32768:
        raise ValueError(
            "erdos_renyi_graph materializes all n(n-1)/2 pairs; "
            "use gnm_random_graph or rmat_graph for large n"
        )
    iu, iv = np.triu_indices(n, k=1)
    mask = rng.random(iu.size) < edge_probability
    u, v = iu[mask].astype(np.int64), iv[mask].astype(np.int64)
    if ensure_connected and n > 1:
        u, v = _connect_components(u, v, n)
    w = rng.integers(weight_low, weight_high + 1, size=u.size, dtype=np.int64)
    return Graph.from_arrays(n, u, v, w)


def gnm_random_graph(
    num_nodes: int,
    num_edges: int,
    *,
    seed: int = 0,
    weight_low: int = 1,
    weight_high: int = 10,
    ensure_connected: bool = True,
) -> Graph:
    """G(n, m): ``num_edges`` distinct edges sampled uniformly."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    m = int(num_edges)
    if m > n * (n - 1) // 2:
        raise ValueError(f"num_edges={m} exceeds the {n*(n-1)//2} distinct pairs")
    codes = np.zeros(0, dtype=np.int64)
    while codes.size < m:
        a = rng.integers(0, n, size=2 * (m - codes.size) + 16, dtype=np.int64)
        b = rng.integers(0, n, size=a.size, dtype=np.int64)
        keep = a != b
        lo = np.minimum(a[keep], b[keep])
        hi = np.maximum(a[keep], b[keep])
        codes = np.unique(np.concatenate([codes, lo * n + hi]))
    rng.shuffle(codes)
    codes = codes[:m]
    u, v = codes // n, codes % n
    if ensure_connected and n > 1:
        u, v = _connect_components(u, v, n)
    w = rng.integers(weight_low, weight_high + 1, size=u.size, dtype=np.int64)
    return Graph.from_arrays(n, u, v, w)


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 1,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weight_low: int = 1,
    weight_high: int = 255,
    dedup: bool = True,
    use_native: str | bool = "auto",
) -> Graph:
    """Graph500-style RMAT: ``2**scale`` vertices, ``edge_factor * 2**scale``
    sampled edges (fewer after loops and duplicates are dropped).

    ``use_native="auto"`` draws from the native generator at ``scale >= 16``
    with ``dedup`` and from NumPy otherwise; ``True`` and ``False`` force
    one. The two draw different streams: a seed gives the same graph as the
    JAX package's on the same stream. The graph's ``generator_path`` says
    which (``"rmat-native"`` or ``"rmat-numpy"``).
    """
    if use_native is True and not dedup:
        raise ValueError("native RMAT always dedups; use use_native=False with dedup=False")
    if use_native == "auto":
        use_native = scale >= 16 and dedup
    if use_native:
        u, v, w, n = native.rmat_edges(scale, edge_factor, seed=seed, a=a, b=b, c=c,
                                       weight_low=weight_low, weight_high=weight_high)
        g = Graph(n, u, v, w)  # canonical and deduped already
        g.__dict__["generator_path"] = "rmat-native"
        return g
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = int(edge_factor) << scale
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    d = 1.0 - a - b - c
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        # Quadrant probabilities (a, b, c, d) over (src_bit, dst_bit):
        # P(dst=1 | src=0) = b/(a+b), P(dst=1 | src=1) = d/(c+d).
        src_bit = r1 >= (a + b)
        p_dst = np.where(src_bit, d / max(c + d, 1e-12), b / max(a + b, 1e-12))
        dst_bit = r2 < p_dst
        u = (u << 1) | src_bit
        v = (v << 1) | dst_bit
    w = rng.integers(weight_low, weight_high + 1, size=m, dtype=np.int64)
    g = Graph.from_arrays(n, u, v, w, dedup=dedup)
    g.__dict__["generator_path"] = "rmat-numpy"
    return g


def road_grid_graph(
    rows: int,
    cols: int,
    *,
    seed: int = 0,
    diag_prob: float = 0.05,
    weight_low: int = 1,
    weight_high: int = 10_000,
    keep_prob: float = 1.0,
) -> Graph:
    """Synthetic road grid: a ``rows x cols`` lattice with random diagonal
    shortcuts and wide integer weights. Degree about 4 and diameter about
    ``rows + cols``, far above ``log n``: the many-level regime.
    ``keep_prob < 1`` thins the edges (the graph may then fall apart; the
    solver returns the spanning forest)."""
    rng = np.random.default_rng(seed)
    r = np.arange(rows, dtype=np.int64)
    c = np.arange(cols, dtype=np.int64)
    vid = r[:, None] * cols + c[None, :]
    parts_u = [vid[:, :-1].ravel(), vid[:-1, :].ravel()]
    parts_v = [vid[:, 1:].ravel(), vid[1:, :].ravel()]
    if diag_prob > 0:
        du = vid[:-1, :-1].ravel()
        dv = vid[1:, 1:].ravel()
        keep = rng.random(du.size) < diag_prob
        parts_u.append(du[keep])
        parts_v.append(dv[keep])
    u = np.concatenate(parts_u)
    v = np.concatenate(parts_v)
    if keep_prob < 1.0:
        # Drawn after the diagonal mask, so keep_prob=1.0 leaves the draws
        # of a seed as they were.
        sel = rng.random(u.size) < keep_prob
        u, v = u[sel], v[sel]
    w = rng.integers(weight_low, weight_high + 1, size=u.size, dtype=np.int64)
    return Graph.from_arrays(int(rows * cols), u, v, w)


def random_road_network(
    rows: int,
    cols: int,
    *,
    seed: int = 0,
    hole_prob: float = 0.08,
    axis_prob: float = 0.53,
    diag_prob: float = 0.12,
    weight_scale: int = 1000,
    dead_end_prob: float = 0.0,
) -> Graph:
    """Random planar-ish road network: one jittered point per cell of a
    ``rows x cols`` lattice, ``hole_prob`` of the cells removed, Bernoulli
    links to the axis and diagonal neighbours, integer weights from
    Euclidean length. ``dead_end_prob`` of the cells keep only their
    minimum-weight link."""
    rng = np.random.default_rng(seed)
    alive = rng.random((rows, cols), dtype=np.float32) >= hole_prob
    jx = rng.random((rows, cols), dtype=np.float32)
    jy = rng.random((rows, cols), dtype=np.float32)
    xs = np.arange(cols, dtype=np.float32)[None, :] + jx
    ys = np.arange(rows, dtype=np.float32)[:, None] + jy
    newid = np.cumsum(alive.ravel()).reshape(alive.shape).astype(np.int64) - 1
    n = int(alive.sum())

    us, vs, ws = [], [], []
    offsets = [
        (0, 1, axis_prob), (1, 0, axis_prob),
        (1, 1, diag_prob), (1, -1, diag_prob),
    ]
    for dr, dc, p in offsets:
        r0, r1 = (0, rows - dr), (dr, rows)
        if dc >= 0:
            c0, c1 = (0, cols - dc), (dc, cols)
        else:
            c0, c1 = (-dc, cols), (0, cols + dc)
        a_sl = (slice(r0[0], r0[1]), slice(c0[0], c0[1]))
        b_sl = (slice(r1[0], r1[1]), slice(c1[0], c1[1]))
        keep = (
            alive[a_sl] & alive[b_sl]
            & (rng.random(alive[a_sl].shape, dtype=np.float32) < p)
        )
        dist = np.hypot(xs[a_sl][keep] - xs[b_sl][keep], ys[a_sl][keep] - ys[b_sl][keep])
        us.append(newid[a_sl][keep])
        vs.append(newid[b_sl][keep])
        ws.append(np.maximum(1, np.round(dist * weight_scale)).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    w = np.concatenate(ws)
    if dead_end_prob > 0.0 and u.size:
        dead = rng.random(n, dtype=np.float32) < dead_end_prob
        # (weight, edge id) packed into one int64 key: the per-vertex minimum
        # is the min-weight incident edge, ties broken by edge id.
        eid = np.arange(u.size, dtype=np.int64)
        key = w * (eid.size + 1) + eid
        best = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(best, u, key)
        np.minimum.at(best, v, key)
        sel = (~dead[u] | (key == best[u])) & (~dead[v] | (key == best[v]))
        u, v, w = u[sel], v[sel], w[sel]
    return Graph.from_arrays(n, u, v, w)


def line_graph(num_nodes: int, *, weight: int = 1) -> Graph:
    """Path 0-1-...-(n-1): the high-diameter worst case for level count."""
    n = int(num_nodes)
    u = np.arange(n - 1, dtype=np.int64)
    return Graph.from_arrays(n, u, u + 1, np.full(n - 1, weight, dtype=np.int64))


def simple_test_graph() -> Graph:
    """3-node triangle with weights 1, 2, 3: MST = {(0,1), (1,2)}, weight 3."""
    return Graph.from_edges(3, [(0, 1, 1), (1, 2, 2), (0, 2, 3)])


def readme_sample_graph() -> Graph:
    """The 6-node/9-edge sample of the reference README (MST weight 20,
    5 edges): the canonical end-to-end fixture."""
    edges = [
        (0, 1, 1), (0, 2, 4), (1, 2, 2),
        (1, 3, 5), (2, 3, 3), (2, 4, 7),
        (3, 4, 6), (3, 5, 8), (4, 5, 9),
    ]
    return Graph.from_edges(6, edges)
