"""Hook-and-compress union-find: fragment merging as parallel pointer ops.

Each fragment hooks onto the fragment across its minimum outgoing edge.
Every fragment picks by the same total order, so the hook graph's only
cycles are mutual pairs, which are broken deterministically (the smaller id
becomes the root). Pointer jumping then compresses every tree to a star in
``O(log depth)`` steps. Port of the JAX package's ``ops/union_find.py``.
"""

from __future__ import annotations

import torch

from distributed_ghs_implementation_tpu_torch.ops import kernels


def break_symmetric_hooks(parent: torch.Tensor) -> torch.Tensor:
    """Resolve mutual hooks ``f <-> g``: the smaller id becomes a self-root."""
    ids = torch.arange(parent.shape[0], dtype=parent.dtype, device=parent.device)
    mutual = parent[parent] == ids
    return torch.where(mutual & (ids < parent), ids, parent)


def pointer_jump(parent: torch.Tensor, *, num_iters: int | None = None) -> torch.Tensor:
    """Compress a hook forest to stars: ``parent[f]`` becomes f's root.

    Runs to the fixpoint and stops there (one host sync per jump), or runs
    exactly ``num_iters`` jumps. Both land on the same stars once
    ``num_iters >= ceil(log2 depth)``.
    """
    if num_iters is not None:
        for _ in range(num_iters):
            parent = parent[parent]
        return parent
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


def hook_and_compress(
    has_moe: torch.Tensor,
    moe_dst_frag: torch.Tensor,
    fragment: torch.Tensor,
    *,
    form: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One merge round: hook every active fragment, compress, relabel vertices.

    Returns ``(new_fragment, parent_star)``. Fragments with no outgoing edge
    self-hook and are left untouched. On the card the round is K1
    (``kernels.hook_compress``, launched in ``form``); on the CPU it is the
    early-exit form below, as the JAX package runs it off the TPU. All give
    the same result.
    """
    if fragment.is_cuda:
        return kernels.hook_compress(has_moe, moe_dst_frag, fragment, form=form)
    ids = torch.arange(fragment.shape[0], dtype=fragment.dtype, device=fragment.device)
    parent = torch.where(has_moe, moe_dst_frag, ids)
    parent = pointer_jump(break_symmetric_hooks(parent))
    return parent[fragment], parent
