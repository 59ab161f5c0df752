"""The query-kind registry: one row per thing the stack can answer.

Port of the JAX package's ``analytics/kinds.py``. Its refs name the port's
modules (:data:`_PKG`), so resolving one never imports the JAX package, and
its oracles are SciPy and NumPy forms where the JAX package's are NetworkX
(the machine with the card has no NetworkX).

Each :class:`KindSpec` binds a kind name to

* a **solver entry** (``analytics/solvers.py`` wrapper over the scheduler's
  MSF solve — every kind reuses the same GHS/Borůvka level loop),
* a **result schema** (the kind-specific response fields the serve protocol
  adds on top of the shared solve fields),
* an **oracle** (the exactness contract: label partition for
  ``components``, total weight for ``mst``/``k_msf``, max-MST-edge weight
  for ``bottleneck``, the minimax path value for ``path_max``),
* a **verify adapter** (the :mod:`verify.certify` entry that certifies a
  served answer of this kind), and
* a **default SLO class** (from :data:`obs.slo.KIND_CLASS_DEFAULTS`, applied
  only when the request names no ``slo_class`` of its own; ``mst`` stays
  untagged for telemetry back-compat).

Callable references are stored as ``"module:attr"`` strings and resolved
lazily, so importing the registry pulls in neither torch nor SciPy.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from distributed_ghs_implementation_tpu_torch.obs.slo import KIND_CLASS_DEFAULTS

_PKG = "distributed_ghs_implementation_tpu_torch"


def _resolve(ref: Optional[str]):
    if ref is None:
        return None
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


@dataclasses.dataclass(frozen=True)
class KindSpec:
    """One registry row; see the module docstring for field contracts."""

    name: str
    #: ``module:attr`` of the solver entry (None for ``mst`` — the service's
    #: native solve path IS the mst solver).
    solver_ref: Optional[str]
    #: ``module:attr`` of the SciPy/NumPy oracle used by tests and the
    #: card check.
    oracle_ref: Optional[str]
    #: ``module:attr`` of the verify adapter (``verify/certify.py``).
    certify_ref: Optional[str]
    #: Kind-specific response fields beyond the shared solve fields.
    schema: Tuple[str, ...]
    #: Request parameters the kind consumes (validated by
    #: :func:`parse_params`).
    params: Tuple[str, ...] = ()
    #: Whether answers are store-cached under a per-kind digest key.
    cached: bool = True

    @property
    def slo_class(self) -> Optional[str]:
        return KIND_CLASS_DEFAULTS.get(self.name)

    @property
    def solver(self):
        return _resolve(self.solver_ref)

    @property
    def oracle(self):
        return _resolve(self.oracle_ref)

    @property
    def certify(self):
        return _resolve(self.certify_ref)


KINDS = {
    spec.name: spec
    for spec in (
        KindSpec(
            name="mst",
            solver_ref=None,
            oracle_ref=f"{_PKG}.utils.verify:scipy_mst_weight",
            certify_ref=f"{_PKG}.verify.certify:certify_result",
            schema=(),
        ),
        KindSpec(
            name="components",
            solver_ref=f"{_PKG}.analytics.solvers:solve_components",
            oracle_ref=f"{_PKG}.analytics.solvers:oracle_components",
            certify_ref=f"{_PKG}.verify.certify:certify_components",
            schema=("num_components", "labels"),
        ),
        KindSpec(
            name="k_msf",
            solver_ref=f"{_PKG}.analytics.solvers:solve_k_msf",
            oracle_ref=f"{_PKG}.analytics.solvers:oracle_k_msf_weight",
            certify_ref=f"{_PKG}.verify.certify:certify_k_forest",
            schema=("k",),
            params=("k",),
        ),
        KindSpec(
            name="bottleneck",
            solver_ref=f"{_PKG}.analytics.solvers:solve_bottleneck",
            oracle_ref=f"{_PKG}.analytics.solvers:oracle_bottleneck",
            certify_ref=f"{_PKG}.verify.certify:certify_bottleneck",
            schema=("bottleneck_weight", "bottleneck_edge"),
        ),
        KindSpec(
            name="path_max",
            solver_ref=f"{_PKG}.analytics.solvers:solve_path_max",
            oracle_ref=f"{_PKG}.analytics.solvers:oracle_path_max",
            certify_ref=None,  # derived per-query from a certified MST
            schema=("u", "v", "connected", "path_max_weight", "path_max_edge"),
            params=("u", "v"),
            cached=False,  # per-(u, v) answers; the underlying MST is cached
        ),
    )
}


def known() -> Tuple[str, ...]:
    return tuple(KINDS)


def get(kind) -> KindSpec:
    """The spec for ``kind`` (default ``mst``); ``ValueError`` on unknown."""
    name = "mst" if kind is None else str(kind)
    spec = KINDS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown kind {name!r}; expected {'|'.join(KINDS)}"
        )
    return spec


def cache_token(kind, *, k: Optional[int] = None) -> Optional[str]:
    """The per-kind cache-key token (third ``:`` segment in the store key),
    or ``None`` when the kind is not store-cached (``path_max``). ``mst``
    returns ``"mst"`` — the store maps it back to the historical
    two-segment key."""
    spec = get(kind)
    if not spec.cached:
        return None
    if spec.name == "k_msf":
        return f"k_msf{int(k)}"
    return spec.name


def parse_params(kind, request: dict) -> dict:
    """Validate and extract the kind's request parameters.

    ``k_msf`` requires integer ``k >= 1``; ``path_max`` requires integer
    node ids ``u``/``v``. Raises ``ValueError`` with a client-facing
    message on anything malformed.
    """
    spec = get(kind)
    out: dict = {}
    if "k" in spec.params:
        try:
            k = int(request["k"])
        except (KeyError, TypeError, ValueError):
            raise ValueError("kind 'k_msf' requires an integer 'k' field")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        out["k"] = k
    if "u" in spec.params:
        try:
            out["u"] = int(request["u"])
            out["v"] = int(request["v"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                "kind 'path_max' requires integer 'u' and 'v' fields"
            )
    return out
