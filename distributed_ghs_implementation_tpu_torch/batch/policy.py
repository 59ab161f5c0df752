"""Admission + batch-forming policy: which solves batch, with whom, when.

Port of the JAX package's ``batch/policy.py``, with its defaults. The policy is pure decision logic (no device work, no threads) so the
engine's queueing and the API's one-shot batching share one rule set:

* **Admission** — a graph batches only if its shape bucket is small enough
  that lane-stacking wins; oversize graphs *bypass* to the existing
  single-graph path (which routes big graphs to the rank solver anyway —
  batching is a small-graph throughput play, and one RMAT-20 lane would
  stall 15 small ones).
* **Forming** — admitted graphs group by :func:`lanes.bucket_key` and chunk
  into at most ``max_lanes`` lanes, preserving arrival order. Every formed
  batch solves at exactly ``max_lanes`` lanes (unfilled lanes are inert
  padding), so each bucket costs ONE prepared solver no matter how batches
  fill — the fill ratio is telemetry (``batch.fill_ratio``), not a cache
  key.
* **Waiting** — ``max_wait_s`` bounds how long the engine's queue holds a
  lone request open for lane-mates before dispatching it anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from distributed_ghs_implementation_tpu_torch.batch.lanes import BucketKey, bucket_key
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    ELL_AUTO_EDGE_THRESHOLD,
)


@dataclasses.dataclass(frozen=True)
class FormedBatch:
    """One dispatchable batch: same-bucket input positions, arrival order."""

    key: BucketKey
    indices: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Batching knobs.

    ``max_lanes`` — lanes per device batch (and the solver cache's lane count).
    ``max_wait_s`` — queue hold time for an unfilled batch (engine only).
    ``max_bucket_edges`` / ``max_bucket_nodes`` — admission ceiling; graphs
    padding past either bypass to the single-graph path (the default edge
    ceiling is the solver's own small-graph routing threshold, below which
    the flat bucketed kernel — the one lanes stack — is the fast path).
    ``mode`` — lane execution: ``"fused"`` block-diagonal or ``"vmap"``.
    ``pipeline_depth`` — how many batches the engine's forming stage may
    run ahead of device execution in ``solve_many`` (2 = double-buffered:
    batch *k+1* stacks on a background thread while batch *k* executes;
    1 = fully synchronous, forming and execution strictly alternate).
    ``pipeline_min_stack_elems`` — smallest per-batch stacked array size
    (elements: ``8 * max_lanes * m_pad``) worth pipelining; below it the
    former thread's handoff overhead beats the overlap win (the JAX
    package's floor, set from its CPU runs; ``chip_smoke.py`` times
    pipelined against synchronous on the card) and ``solve_many`` stays
    synchronous. 0 forces pipelining whenever there are >= 2 batches.
    """

    max_lanes: int = 16
    max_wait_s: float = 0.002
    max_bucket_edges: int = ELL_AUTO_EDGE_THRESHOLD
    max_bucket_nodes: int = 1 << 16
    mode: str = "fused"
    pipeline_depth: int = 2
    pipeline_min_stack_elems: int = 32768

    def __post_init__(self):
        if self.max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {self.max_lanes}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.mode not in ("fused", "vmap"):
            raise ValueError(f"unknown lane mode {self.mode!r}")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.pipeline_min_stack_elems < 0:
            raise ValueError(
                f"pipeline_min_stack_elems must be >= 0, got "
                f"{self.pipeline_min_stack_elems}"
            )

    def admits(self, graph: Graph) -> bool:
        """Can this graph ride a lane (vs bypassing to the single path)?"""
        n_pad, m_pad = bucket_key(graph)
        return n_pad <= self.max_bucket_nodes and m_pad <= self.max_bucket_edges

    def route(self, graph: Graph, *, sharded_available: bool = False) -> str:
        """Where one solve goes, as a routing label: ``"lane"`` (admitted —
        the bucketed lane engine / small-graph path), ``"sharded_lane"``
        (oversize with a mesh lane attached — ``parallel/lane.py``), or
        ``"bypass"`` (oversize, no sharded lane: the legacy single-graph
        supervised path). The ONE encoding of the oversize decision — the
        serving scheduler stamps the label on its ``serve.solve`` spans so
        load/SLO summaries can tell the two oversize paths apart."""
        if self.admits(graph):
            return "lane"
        return "sharded_lane" if sharded_available else "bypass"

    def form(
        self, graphs: Sequence[Graph]
    ) -> Tuple[List[FormedBatch], List[int]]:
        """Partition a request list into formed batches + bypass positions.

        Returns ``(batches, bypass)`` where each :class:`FormedBatch` holds
        input positions of one same-bucket chunk (at most ``max_lanes``)
        and ``bypass`` holds positions of non-admitted graphs. Together
        they cover every input exactly once.
        """
        groups: Dict[BucketKey, List[int]] = {}
        bypass: List[int] = []
        for i, g in enumerate(graphs):
            if self.admits(g):
                groups.setdefault(bucket_key(g), []).append(i)
            else:
                bypass.append(i)
        batches: List[FormedBatch] = []
        for key, members in groups.items():
            for at in range(0, len(members), self.max_lanes):
                batches.append(
                    FormedBatch(key=key, indices=tuple(members[at:at + self.max_lanes]))
                )
        return batches, bypass
