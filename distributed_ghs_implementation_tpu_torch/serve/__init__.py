"""The serve stack's solve half, on one card: the port of the JAX package's
``serve/store``, ``serve/scheduler`` and ``serve/dynamic``.

* ``store``: content-addressed result cache (graph digest + solver config
  -> ``MSTResult``), an in-memory LRU and an optional crash-consistent disk
  layer, under keys of the port's own backend token.
* ``scheduler``: single-flight request coalescing and bounded admission;
  every cache miss solves supervised, or through the batch engine.
* ``dynamic``: incremental forest maintenance for edge insert, delete and
  reweight against a cached result, with a supervised re-solve fallback.

The JSONL loop (the JAX package's ``serve/service.py``: ``MSTService``,
``serve_loop``) is not ported yet.
"""

from distributed_ghs_implementation_tpu_torch.serve.dynamic import (
    DynamicMST,
    Update,
    components_via_unionfind,
    tree_path_max,
)
from distributed_ghs_implementation_tpu_torch.serve.scheduler import SolveScheduler
from distributed_ghs_implementation_tpu_torch.serve.store import ResultStore, solve_cache_key

__all__ = [
    "DynamicMST",
    "ResultStore",
    "SolveScheduler",
    "Update",
    "components_via_unionfind",
    "solve_cache_key",
    "tree_path_max",
]
