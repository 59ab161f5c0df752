"""Candidate enumeration: the tuner's per-bucket search space.

The port's counterpart of the JAX package's ``tune/space.py``. A
**candidate** is the device's kernel label (``"cuda"`` on the card, the
hand kernels; ``"torch"`` on the CPU, their plain versions) and a
``kernels.LaunchConfig``: the launch parameters a solve may vary without
changing its result. The JAX package's space is ``KernelGeometry``, TPU
VMEM budgets; none of it carries over. Here the knobs are:

* K1's form (``hook_compress``): ``"auto"`` (the block form up to
  ``HOOK_BLOCK_FORM_THRESHOLD`` nodes, the grid form above), ``"block"``
  (one block in shared memory; valid only up to ``HOOK_BLOCK_MAX_NODES``)
  and ``"grid"`` (the cooperative grid);
* K3's tile (``ell_plan(tile_slots=...)``), for ``ell`` buckets only, the
  one path that launches K3.

The default config (``"auto"``, ``ELL_TILE_SLOTS``) comes first: it is the
parity reference every other candidate is held to. Guards are hard
validity filters, as in the JAX package: a block form past the block's
shared memory is not a slow candidate, it is none. Enumeration is pure and
deterministic (sorted grids, no clocks, no randomness).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from distributed_ghs_implementation_tpu_torch.ops.kernels import (
    DEFAULT_CONFIG,
    ELL_TILE_SLOTS,
    HOOK_BLOCK_MAX_NODES,
    LaunchConfig,
)

#: The knob grids. Small on purpose: the search multiplies per bucket.
HOOK_FORM_CHOICES: Tuple[str, ...] = ("auto", "block", "grid")
TILE_SLOT_CHOICES: Tuple[int, ...] = (4096, 8192, 16384)

#: Bucket modes the tuner understands. ``mesh`` is the sharded lane's
#: per-bucket key space (the lanes field carries the device count).
VALID_MODES = ("fused", "vmap", "ell", "mesh")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: a kernel label and its launch config."""

    kernel: str  # "cuda" | "torch"
    config: LaunchConfig = DEFAULT_CONFIG

    def label(self) -> str:
        """Stable label (also the key of a record's timings)."""
        c = self.config
        return f"{self.kernel}/hook-{c.hook_form}/tile{c.tile_slots}"

    def to_json(self) -> dict:
        return {"kernel": self.kernel, "config": self.config.to_json()}


def bucket_nodes(n_pad: int, lanes: int, mode: str) -> int:
    """The node count K1 sees for a bucket: the port's ``fused`` and
    ``vmap`` lanes both run one block-diagonal stack of ``lanes * n_pad``
    nodes; a single graph, an ``ell`` bucket and a mesh's per-device proxy
    run ``n_pad``."""
    if mode in ("fused", "vmap") and lanes >= 1:
        return lanes * n_pad
    return n_pad


def candidate_valid(config: LaunchConfig, n_pad: int, m_pad: int, lanes: int, mode: str) -> bool:
    """Would the bucket's solve launch ``config`` as asked? K1's block form
    holds at most ``HOOK_BLOCK_MAX_NODES`` nodes (the launcher refuses
    more); only ``ell`` launches K3, so other modes keep its default tile."""
    del m_pad  # no knob depends on the slot count
    if config.hook_form not in HOOK_FORM_CHOICES:
        return False
    if config.hook_form == "block" and bucket_nodes(n_pad, lanes, mode) > HOOK_BLOCK_MAX_NODES:
        return False
    if mode == "ell":
        return config.tile_slots in TILE_SLOT_CHOICES
    return config.tile_slots == ELL_TILE_SLOTS


def raw_space_size(mode: str) -> int:
    """Grid size before validity filtering (the denominator for
    ``tune.search.rejected`` accounting)."""
    if mode == "ell":
        return len(HOOK_FORM_CHOICES) * len(TILE_SLOT_CHOICES)
    return len(HOOK_FORM_CHOICES)


def enumerate_candidates(
    n_pad: int, m_pad: int, lanes: int, mode: str, *, kernel: str = "cuda"
) -> List[Candidate]:
    """The valid candidates for one solver bucket, in a fixed order: the
    default config first, then the grid in sorted knob order."""
    if mode not in VALID_MODES:
        raise ValueError(
            f"unknown tune bucket mode {mode!r}; expected one of {VALID_MODES}"
        )
    if n_pad < 1 or m_pad < 1 or lanes < 0:
        raise ValueError(
            f"bad tune bucket ({n_pad}, {m_pad}, {lanes}, {mode!r}): "
            "sizes must be positive, lanes non-negative"
        )
    tiles = TILE_SLOT_CHOICES if mode == "ell" else (ELL_TILE_SLOTS,)
    out: List[Candidate] = [Candidate(kernel)]
    for form in sorted(HOOK_FORM_CHOICES):
        for tile in tiles:
            config = LaunchConfig(form, tile)
            if config != DEFAULT_CONFIG and candidate_valid(config, n_pad, m_pad, lanes, mode):
                out.append(Candidate(kernel, config))
    return out
