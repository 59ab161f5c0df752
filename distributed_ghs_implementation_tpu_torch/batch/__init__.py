"""Multi-graph batch execution on one card: the port of the JAX package's
``batch/``.

Independent small-graph solves waste the card one level loop at a time:
same-bucket graphs pad to the same shapes, so K of them ride one level
loop. ``lanes`` stacks same-bucket graphs into lanes and solves them
together, ``policy`` decides what batches with what (and what bypasses),
``engine`` owns the queue behind the serving scheduler's miss path, and
``warmup`` builds buckets before traffic arrives.
"""

from distributed_ghs_implementation_tpu_torch.batch.engine import BatchEngine
from distributed_ghs_implementation_tpu_torch.batch.lanes import (
    bucket_key,
    bucket_of,
    compiled_bucket_keys,
    lane_compile_stats,
    precompile_bucket,
    solve_lanes,
)
from distributed_ghs_implementation_tpu_torch.batch.policy import BatchPolicy, FormedBatch
from distributed_ghs_implementation_tpu_torch.batch.warmup import (
    WarmupPlan,
    load_bucket_record,
    run_warmup,
    save_bucket_record,
)

__all__ = [
    "BatchEngine",
    "BatchPolicy",
    "FormedBatch",
    "WarmupPlan",
    "bucket_key",
    "bucket_of",
    "compiled_bucket_keys",
    "lane_compile_stats",
    "load_bucket_record",
    "precompile_bucket",
    "run_warmup",
    "save_bucket_record",
    "solve_lanes",
]
