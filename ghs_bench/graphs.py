"""The benchmark's own graph generators, made from ``--seed``.

It returns canonical edge lists: ``u < v``, rows sorted by ``(u, v)``, no
loops, no parallel edges (a parallel pair keeps its lighter weight). That is
the layout the system's ``Graph`` holds after canonicalisation, so the
system is handed finished inputs and edge ids mean the same row on both
sides of the correctness comparison.

:func:`kronecker` is the Graph500 Kronecker generator (the reference
  ``kronecker_generator.m`` of the Graph500 specification: ``scale``
  levels of quadrant choice with initiator A, B, C, then a random
  permutation of the vertex labels), run in plain PyTorch on the device
  from a ``torch.Generator`` seeded there. Graph500 also shuffles the edge
  order; canonicalisation sorts the rows, so the shuffle is left out.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHT_BITS = 8  # weights of the Kronecker graphs lie in 1..255


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` derived from the
    run's seed and a stream number, so each piece of a run draws its own
    stream and any whole number (negative or past 64 bits) is a seed."""
    words = np.random.SeedSequence([abs(int(seed)), *stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def kronecker(scale: int, edge_factor: int, *, a: float, b: float, c: float,
              weight_low: int, weight_high: int, seed: int, stream: int = 0,
              device="cpu"):
    """A canonical Graph500 Kronecker graph on ``device``: ``(num_nodes, u,
    v, w)``, the three int64 tensors sorted by ``(u, v)``. Loops are
    dropped and each duplicate pair keeps its least weight, drawn uniform
    in ``weight_low..weight_high``."""
    if not 1 <= weight_low <= weight_high < (1 << WEIGHT_BITS):
        raise ValueError(f"weights must lie in 1..{(1 << WEIGHT_BITS) - 1}")
    if 2 * scale + WEIGHT_BITS > 63:
        raise ValueError(f"scale {scale} does not fit the 63-bit sort key")
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, stream))
    n = 1 << scale
    m = edge_factor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        del thresh
        u |= ii.to(torch.int64) << level
        v |= jj.to(torch.int64) << level
        del ii, jj
    perm = torch.randperm(n, generator=gen, device=device)
    u = perm[u]
    v = perm[v]
    del perm
    w = torch.randint(weight_low, weight_high + 1, (m,), generator=gen, device=device)
    return (n, *canonical(u, v, w, node_bits=scale))


def canonical(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *, node_bits: int):
    """``(u, v, w)`` with ``u < v``, loops dropped, sorted by ``(u, v)``, and
    each parallel pair cut to its least weight: one sort of the key ``u, v,
    w`` packed into an int64 (``w`` below ``2**WEIGHT_BITS``)."""
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    del u, v
    keep = lo != hi
    key = (lo[keep] << (node_bits + WEIGHT_BITS)) | (hi[keep] << WEIGHT_BITS) | w[keep]
    del lo, hi, keep
    key = torch.sort(key).values
    pair = key >> WEIGHT_BITS
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[1:] != pair[:-1]
    del pair
    key = key[first]
    del first
    node_mask = (1 << node_bits) - 1
    return (key >> (node_bits + WEIGHT_BITS), (key >> WEIGHT_BITS) & node_mask,
            key & ((1 << WEIGHT_BITS) - 1))
