"""Seeded inputs for the port's tests: random MOE slot arrays, hook forests
and the fixture deck. Imports neither JAX nor the JAX package, so the card
tests (``test_torch_cuda.py``) run where JAX is not installed."""

import numpy as np

INT32_MAX = np.iinfo(np.int32).max

#: (n, e) with e a multiple of 128 (the shapes the Pallas flat kernel takes).
FLAT_SHAPES = [(1, 128), (7, 256), (500, 1024), (1000, 4096), (3000, 128 * 37)]


def moe_inputs(seed, n, e):
    """Random partition labels, slots and ranks (some slots padding)."""
    rng = np.random.default_rng(seed)
    m = e // 2 + 1
    fragment = rng.integers(0, n, n).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    rank = rng.integers(0, m, e).astype(np.int32)
    rank[rng.random(e) < 0.1] = INT32_MAX
    ra = rng.integers(0, n, m).astype(np.int32)
    rb = rng.integers(0, n, m).astype(np.int32)
    return fragment, src, dst, rank, ra, rb


def hook_forest(seed, n, kind):
    """``(has, dst_frag, fragment)`` whose hook graph's only cycles are
    mutual pairs, as a real MOE round gives; ``dst_frag`` is garbage where
    ``has`` is False."""
    rng = np.random.default_rng(seed)
    has = np.zeros(n, dtype=bool)
    dst = rng.integers(0, n, n)
    if kind == "random":
        perm = rng.permutation(n)
        k = np.arange(n)
        pick = (rng.random(n) * k).astype(np.int64)  # an earlier position
        hooked = (rng.random(n) < 0.8) & (k > 0)
        has[perm[hooked]] = True
        dst[perm[hooked]] = perm[pick[hooked]]
        roots = rng.permutation(perm[~hooked])
        half = (roots.size // 4) * 2
        a, b = roots[:half:2], roots[1:half:2]
        has[a] = has[b] = True
        dst[a], dst[b] = b, a
    elif kind == "star":
        centre = n // 2
        has[:] = True
        dst[:] = centre
        dst[centre] = 0
        has[centre] = centre != 0  # centre <-> 0 is a mutual pair
    elif kind == "chain":
        has[1:] = True
        dst[1:] = np.arange(n - 1)
    return has, dst.astype(np.int32), rng.integers(0, n, n).astype(np.int32)


def ell_inputs(seed, n, rows, width, *, fragments=None):
    """A random ELL bucket ``(fragment, verts, dstb, rankb)``: ``fragments``
    labels (default n // 8, so the outgoing mask matters), about a tenth of
    the slots padding (rank INT32_MAX), the last row a pad row of vertex 0."""
    rng = np.random.default_rng(seed)
    fragment = rng.integers(0, fragments or max(1, n // 8), n).astype(np.int32)
    verts = rng.integers(0, n, rows).astype(np.int32)
    dstb = rng.integers(0, n, (rows, width)).astype(np.int32)
    rankb = rng.integers(0, 1 << 20, (rows, width)).astype(np.int32)
    rankb[rng.random((rows, width)) < 0.1] = INT32_MAX
    verts[-1], dstb[-1], rankb[-1] = 0, 0, INT32_MAX
    return fragment, verts, dstb, rankb

def forest23(Graph, gen, **native):
    """Three RMAT-7 blocks made connected by spanning paths, plus 20
    isolated vertices: 23 components (``__graft_entry__.py:121-145``)."""
    rng = np.random.default_rng(11)
    parts, base = [], 0
    for nn in (70, 50, 40):
        comp = gen.rmat_graph(7, 4, seed=nn, **native)
        keep = (comp.u < nn) & (comp.v < nn)
        parts.append(np.stack([comp.u[keep] + base, comp.v[keep] + base, comp.w[keep]], 1))
        ids = np.arange(nn - 1)
        parts.append(np.stack([ids + base, ids + 1 + base, rng.integers(1, 255, nn - 1)], 1))
        base += nn
    edges = np.concatenate(parts)
    return Graph.from_arrays(base + 20, edges[:, 0], edges[:, 1], edges[:, 2])


#: The multichip dry-run's fixture deck: name -> maker(generators module,
#: **native); ``forest23`` is built by :func:`forest23` instead.
DECK = {
    "er48": lambda g, **k: g.erdos_renyi_graph(48, 0.2, seed=11),
    "rmat12": lambda g, **k: g.rmat_graph(12, 8, seed=11, **k),
    "road40": lambda g, **k: g.random_road_network(40, 40, seed=11),
    "forest23": None,
    "readme": lambda g, **k: g.readme_sample_graph(),
}


def build_deck(jedge, jgen, tedge, tgen):
    """``{name: (JAX graph, port graph)}`` over :data:`DECK`; the JAX RMAT
    sampler runs without its native code, as the port's does."""
    out = {}
    for name, make in DECK.items():
        if make is None:
            out[name] = (forest23(jedge.Graph, jgen, use_native=False),
                         forest23(tedge.Graph, tgen))
        else:
            kw = {"use_native": False} if name.startswith("rmat") else {}
            out[name] = (make(jgen, **kw), make(tgen))
    return out
