"""Device operations: segment minima and union-find, whose fused steps run
in the hand-written CUDA kernels of ``ops/kernels.py`` on a CUDA tensor
(the JAX package's ``ops/``).

The exports resolve at first use: ``graphs/native.py`` imports
``ops._build``, and a process that only reads graphs (an echo worker of the
fleet) must not load the kernels' module with it.
"""

import importlib

_EXPORTS = {
    "break_symmetric_hooks": "union_find",
    "fragment_moe": "segment_ops",
    "hook_and_compress": "union_find",
    "pointer_jump": "union_find",
    "segment_min": "segment_ops",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
