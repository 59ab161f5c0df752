"""The serve stack on one card: the port of the JAX package's ``serve/``.

* ``store``: content-addressed result cache (graph digest + solver config
  -> ``MSTResult``), an in-memory LRU and an optional crash-consistent disk
  layer, under keys of the port's own backend token.
* ``scheduler``: single-flight request coalescing and bounded admission;
  every cache miss solves supervised, or through the batch engine.
* ``dynamic``: incremental forest maintenance for edge insert, delete and
  reweight against a cached result, with a supervised re-solve fallback.
* ``service``: ``MSTService``, the request handler over all of it (solves
  of every analytics kind, updates, streams, verification, stats), and the
  loops that speak its protocol: ``serve_loop`` over JSONL and
  ``serve_frames`` over length-prefixed frames and B-frames.
"""

from distributed_ghs_implementation_tpu_torch.serve.dynamic import (
    DynamicMST,
    Update,
    components_via_unionfind,
    tree_path_max,
)
from distributed_ghs_implementation_tpu_torch.serve.scheduler import SolveScheduler
from distributed_ghs_implementation_tpu_torch.serve.service import (
    MSTService,
    serve_frames,
    serve_loop,
)
from distributed_ghs_implementation_tpu_torch.serve.store import ResultStore, solve_cache_key

__all__ = [
    "DynamicMST",
    "MSTService",
    "ResultStore",
    "SolveScheduler",
    "Update",
    "components_via_unionfind",
    "serve_frames",
    "serve_loop",
    "solve_cache_key",
    "tree_path_max",
]
