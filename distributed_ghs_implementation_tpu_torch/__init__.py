"""Minimum spanning forests on PyTorch and CUDA: the port of
``distributed_ghs_implementation_tpu`` to an NVIDIA H100.

The GHS protocol recast as a batched Borůvka contraction: the minimum
outgoing edge search is a segment minimum over the edge list, the fragment
merge is pointer-jumping union-find, and the two steps of each level run in
hand-written CUDA kernels (``csrc/``). This package imports nothing of the
JAX package; it keeps its own copies of what it needs.

    >>> from distributed_ghs_implementation_tpu_torch import GHSAlgorithm
    >>> mst = GHSAlgorithm(num_nodes, edges).run()

or the functional form:

    >>> from distributed_ghs_implementation_tpu_torch import minimum_spanning_tree

Every entry point runs on CUDA unless it is given ``device="cpu"``.
"""

from distributed_ghs_implementation_tpu_torch.api import (
    GHSAlgorithm,
    MSTResult,
    minimum_spanning_forest,
    minimum_spanning_forest_batch,
    minimum_spanning_tree,
)
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph

__version__ = "0.1.0"

__all__ = [
    "GHSAlgorithm",
    "Graph",
    "MSTResult",
    "minimum_spanning_forest",
    "minimum_spanning_forest_batch",
    "minimum_spanning_tree",
    "__version__",
]
