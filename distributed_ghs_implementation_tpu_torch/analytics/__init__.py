"""analytics/ — the multi-query front door over the serving stack.

Port of the JAX package's ``analytics/``. One registry
(:mod:`analytics.kinds`) maps each supported query *kind* — ``mst``,
``components``, ``k_msf``, ``bottleneck``, ``path_max`` — to its solver
entry, result schema, SciPy/NumPy oracle, verify adapter, and default SLO
class; thin wrappers (:mod:`analytics.solvers`) derive every kind from the
same Borůvka level loop the MST path runs.
"""

from distributed_ghs_implementation_tpu_torch.analytics.kinds import (  # noqa: F401
    KINDS,
    KindSpec,
    cache_token,
    get,
    known,
    parse_params,
)
