"""Segment reductions: the minimum-outgoing-edge (MOE) search as tensor ops.

One Borůvka level asks each fragment for the minimum-rank edge leaving it.
That is one ``segment_min`` over the directed slots keyed by the source
endpoint's fragment, comparing edges by their global rank in the order
``(weight, edge id)``. Port of the JAX package's ``ops/segment_ops.py``;
its sharded form (``axis_name``) is ``parallel/sharded.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from distributed_ghs_implementation_tpu_torch.ops import kernels

INT32_MAX = kernels.INT32_MAX


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment minimum; empty segments read the dtype's maximum."""
    out = torch.full((num_segments,), weight_sentinel(data.dtype), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amin")


def weight_sentinel(dtype: torch.dtype):
    """The identity of ``min`` for ``dtype``: its maximum, or +inf."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def fragment_moe(
    fragment: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rank: torch.Tensor,
    ra: torch.Tensor,
    rb: torch.Tensor,
    *,
    identity_fragment: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-fragment minimum outgoing edge over the directed slots.

    Args:
      fragment: ``[n]`` int32, fragment (root) id per vertex.
      src, dst: ``[e]`` int32 directed slot endpoints.
      rank: ``[e]`` int32 rank of each slot's undirected edge (INT32_MAX on
        padding slots).
      ra, rb: endpoints of the rank-``r`` edge, indexed by rank.
      identity_fragment: ``fragment`` is ``arange(n)``, so the two fragment
        gathers are the identity and are skipped. Otherwise the gathers and
        the outgoing-edge select run in K2 (``kernels.gather_key``).

    Returns:
      ``(has_moe[n], moe_rank[n], moe_dst_frag[n])``: whether each fragment
      has an outgoing edge, the winning edge's rank (INT32_MAX when none),
      and the fragment on the far side (itself when none).
    """
    n = fragment.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=fragment.device)
    if identity_fragment:
        f_src = src
        key = torch.where(src != dst, rank, INT32_MAX)
    else:
        f_src, key = kernels.gather_key(fragment, src, dst, rank)
    moe_rank = segment_min(key, f_src, n)
    has_moe = moe_rank < INT32_MAX

    # Far side of the winning edge through its endpoints: n-sized gathers.
    safe = torch.where(has_moe, moe_rank, 0)
    fa = fragment[ra[safe]]
    fb = fragment[rb[safe]]
    moe_dst_frag = torch.where(has_moe, torch.where(fa == ids, fb, fa), ids)
    return has_moe, moe_rank, moe_dst_frag
