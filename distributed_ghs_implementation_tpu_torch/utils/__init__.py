"""Utilities: oracles, supervision, the build cache (the JAX package's
``utils/``).

The exports resolve at first use: the build layers (``ops/_build.py``,
``graphs/native.py``) import ``utils.compile_cache`` while ``resilience``
imports ``graphs``, so importing every module here with the package would
close that loop.
"""

import importlib

_EXPORTS = {
    "FAULTS": "resilience",
    "Supervisor": "resilience",
    "SupervisorConfig": "resilience",
    "cache_stats": "compile_cache",
    "enable_persistent_cache": "compile_cache",
    "networkx_mst_weight": "verify",
    "scipy_mst_weight": "verify",
    "supervised_solve": "resilience",
    "verify_result": "verify",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
