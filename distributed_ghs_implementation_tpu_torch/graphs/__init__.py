"""Graph data layer: the edge-list container, generators and on-disk formats
(the JAX package's ``graphs/``)."""

from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.graphs.generators import (
    erdos_renyi_graph,
    line_graph,
    reference_random_graph,
    rmat_graph,
    simple_test_graph,
)
from distributed_ghs_implementation_tpu_torch.graphs.io import (
    read_dimacs,
    read_partition_dir,
    write_partition_dir,
)

__all__ = [
    "Graph",
    "erdos_renyi_graph",
    "line_graph",
    "read_dimacs",
    "read_partition_dir",
    "reference_random_graph",
    "rmat_graph",
    "simple_test_graph",
    "write_partition_dir",
]
