"""Runtime verification: MST certificates, serving policy, async audit.

Port of the JAX package's ``verify/``. Every served result can be
*certified* against the input graph in O(m α + m log n) — far cheaper than
re-solving and, above all, through an independent code path (union-find +
binary-lifting path-max, never the Borůvka kernels), so a faulty kernel, a
bit-rotted cache entry, or a corrupted forwarded payload cannot co-sign its
own wrong answer.

* :mod:`verify.certify` — the certificate checker itself, with a ``np``
  engine and a ``torch`` engine (plain PyTorch ops on an explicit device,
  never a hand kernel; the JAX package's ``xla`` engine is its
  counterpart).
* :mod:`verify.policy` — the ``off|sample|full`` per-SLO-class serving
  policy, the background audit thread, and the serve-side glue that
  corrects a failed certificate transparently (evict + re-solve).
"""

from distributed_ghs_implementation_tpu_torch.verify.certify import (  # noqa: F401
    Certificate,
    certify_claim,
    certify_edge_ids,
    certify_result,
)
from distributed_ghs_implementation_tpu_torch.verify.policy import (  # noqa: F401
    AsyncAuditor,
    ResultVerifier,
    VerificationError,
    VerifyPolicy,
)
