"""Several shards: edge sharding over an :class:`~.mesh.EdgeMesh`.

The port of the JAX package's ``parallel/``. A mesh holds shards within one
process (several may share a card) and spans processes over
``torch.distributed`` (``multihost.initialize``). The directed edge list,
or the rank space, is block-sharded over the shards, per-fragment minima
combine with ``pmin``, and vertex arrays stay replicated, one copy a device.
"""

from distributed_ghs_implementation_tpu_torch.parallel.lane import ShardedLane
from distributed_ghs_implementation_tpu_torch.parallel.mesh import EdgeMesh, edge_mesh
from distributed_ghs_implementation_tpu_torch.parallel.sharded import (
    make_sharded_solver,
    solve_graph_sharded,
)

__all__ = [
    "EdgeMesh",
    "ShardedLane",
    "edge_mesh",
    "make_sharded_solver",
    "solve_graph_sharded",
]
