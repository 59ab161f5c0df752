"""Serving verification policy: ``off | sample | full`` per SLO class.

Port of the JAX package's ``verify/policy.py``. The port's certificates
run their ``torch`` engine on an explicit device: :class:`ResultVerifier`
and :class:`AsyncAuditor` take ``device`` (``None`` = CUDA, resolved only
when an engine other than ``np`` needs it) and pass it to every check, so
the audit thread works on the device of the verifier that owns it.

The certificate checker (``verify/certify.py``) costs roughly a solve's
host-prep, which is the wrong price for every interactive cache hit and
the right price for everything whose blast radius is large. The policy
maps each request's SLO class to a mode:

* ``full`` — certify inline, before the response leaves the service. A
  failed certificate triggers the **correction path**: the poisoned entry
  is evicted from the store (disk generations quarantined), any device
  residency for the digest dropped, the graph re-solved fresh, the fresh
  result certified, and the corrected answer served — the client never
  sees the bad result (``verify.failed`` / ``verify.corrected``).
* ``sample`` — every ``sample_every``-th request of the class is certified
  on a background audit thread (``verify.audit.*``): the response ships at
  full speed, and a failed audit evicts the entry so the *next* request
  re-solves (you cannot retract a served answer; you can stop serving it).
  Sampling is count-based, not random, so drill counters gate exactly.
* ``off`` — trust the path.

Spec strings (``MSTService(verify=...)``)::

    "full"                          # every class, inline
    "sample"                        # every class, sampled audit
    "bulk=full,interactive=sample,default=off"
    "sample:4"                      # sampled, every 4th request

Class names run through ``obs.slo.sanitize_class`` — the same
normalization the SLO join uses, so a policy class always matches the
class the telemetry reports.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Dict, Optional

from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.obs.slo import sanitize_class
from distributed_ghs_implementation_tpu_torch.verify.certify import (
    Certificate,
    _engine_device,
    _resolve_engine,
    certify_result,
)

MODES = ("off", "sample", "full")
_DEFAULT_SAMPLE_EVERY = 8


class VerifyPolicy:
    """Per-class verification modes with a default, parsed from a spec."""

    def __init__(
        self,
        default: str = "off",
        *,
        classes: Optional[Dict[str, str]] = None,
        sample_every: int = _DEFAULT_SAMPLE_EVERY,
        engine: str = "auto",
    ):
        if default not in MODES:
            raise ValueError(
                f"verify mode {default!r}; expected off|sample|full"
            )
        self.default = default
        self.classes = {}
        for cls, mode in (classes or {}).items():
            if mode not in MODES:
                raise ValueError(
                    f"verify mode {mode!r} for class {cls!r}; "
                    f"expected off|sample|full"
                )
            self.classes[sanitize_class(cls) or cls] = mode
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = int(sample_every)
        self.engine = engine
        self._counts: Dict[Optional[str], int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    @staticmethod
    def parse(spec, **kwargs) -> "VerifyPolicy":
        """``VerifyPolicy`` from a spec string (see module docstring);
        passes through an existing policy, maps ``None``/"" to all-off."""
        if isinstance(spec, VerifyPolicy):
            return spec
        if not spec:
            return VerifyPolicy("off", **kwargs)
        spec = str(spec).strip()
        sample_every = kwargs.pop("sample_every", _DEFAULT_SAMPLE_EVERY)
        default = "off"
        classes: Dict[str, str] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                cls, mode = part.split("=", 1)
            else:
                cls, mode = "default", part
            mode = mode.strip()
            if ":" in mode:  # "sample:4" — per-mode sampling cadence
                mode, every = mode.split(":", 1)
                sample_every = int(every)
            if cls.strip() == "default":
                default = mode
            else:
                classes[cls.strip()] = mode
        return VerifyPolicy(
            default, classes=classes, sample_every=sample_every, **kwargs
        )

    @property
    def enabled(self) -> bool:
        return self.default != "off" or any(
            m != "off" for m in self.classes.values()
        )

    def mode_for(self, cls: Optional[str]) -> str:
        return self.classes.get(cls, self.default)

    def should_sample(self, cls: Optional[str]) -> bool:
        """Deterministic count-based sampling: the 1st, then every
        ``sample_every``-th request of the class is audited (counting from
        the first, so a single-request class is still covered)."""
        with self._lock:
            count = self._counts[cls]
            self._counts[cls] = count + 1
        return count % self.sample_every == 0

    def describe(self) -> dict:
        return {
            "default": self.default,
            "classes": dict(self.classes),
            "sample_every": self.sample_every,
            "engine": self.engine,
        }


class AsyncAuditor:
    """Background certification: a bounded queue drained by one daemon
    thread. Enqueue never blocks the serving path — a full queue drops the
    audit and counts it (``verify.audit.dropped``): sampled verification
    is an alarm, not a guarantee, and an alarm that can stall serving
    would be worse than the silent failure it hunts."""

    def __init__(
        self,
        *,
        engine: str = "auto",
        capacity: int = 64,
        on_failure: Optional[Callable] = None,
        device=None,
    ):
        self.engine = engine
        # The thread certifies on this explicit device (the owner's),
        # never on whatever device the thread would default to; the
        # ``np`` engine keeps it only to pass it on.
        if _resolve_engine(engine) == "np":
            self.device = device
        else:
            self.device = _engine_device("torch", device)
        self.on_failure = on_failure
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._drain, name="verify-audit", daemon=True
                )
                self._thread.start()

    def submit(
        self,
        result,
        *,
        cls: Optional[str] = None,
        key=None,
        certify: Optional[Callable] = None,
    ) -> bool:
        """Queue one result for audit; ``False`` when dropped (full).
        ``certify`` overrides the default MST certificate — the analytics
        kinds audit with their own adapters (``certify(result, engine) ->
        Certificate``, given the auditor's ``engine``; a ``device``
        keyword too when the engine is ``torch``)."""
        self._ensure_thread()
        try:
            self._q.put_nowait((result, cls, key, certify))
        except queue.Full:
            BUS.count("verify.audit.dropped")
            return False
        self._idle.clear()
        BUS.count("verify.audit.queued")
        return True

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                self._idle.set()
                continue
            result, cls, key, certify = item
            try:
                if certify is not None:
                    cert = certify(result, engine=self.engine)
                else:
                    cert = certify_result(
                        result, engine=self.engine, device=self.device
                    )
                if cert.ok:
                    BUS.count("verify.audit.ok")
                else:
                    BUS.count("verify.audit.failed")
                    BUS.instant(
                        "verify.audit.failure", cat="verify",
                        reason=cert.reason, cls=cls,
                        digest=result.graph.digest()[:16],
                    )
                    if self.on_failure is not None:
                        self.on_failure(result, cert, cls, key)
            except Exception:  # noqa: BLE001 — audit must never kill serving
                BUS.count("verify.audit.errors")
            finally:
                if self._q.empty():
                    self._idle.set()
                self._q.task_done()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Drills/tests: wait until the queue drains. ``True`` on drained."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.empty() and self._idle.is_set():
                return True
            time.sleep(0.005)
        return self._q.empty()


class ResultVerifier:
    """The serve-side glue: policy + inline correction + async audit.

    ``resolve(graph, backend)`` is injected by the service — it must
    bypass whatever produced the bad result (the service passes a
    store-invalidating fresh solve); ``invalidate(key, digest)`` evicts
    the poisoned entry from cache + residency. Both are called ONLY on a
    failed certificate, so the hot path stays allocation-light.
    """

    def __init__(
        self,
        policy: VerifyPolicy,
        *,
        invalidate: Optional[Callable] = None,
        resolve: Optional[Callable] = None,
        device=None,
    ):
        self.policy = policy
        self.invalidate = invalidate
        self.resolve = resolve
        # Inline full-mode checks run the policy's engine (``torch`` by
        # default) on this device; None = CUDA, resolved only for an
        # engine that needs one.
        self.device = _engine_device(_resolve_engine(policy.engine), device)
        # Audits run on the NumPy engine unconditionally, as in the JAX
        # package: the daemon thread must not contend with serving for the
        # device.
        self.auditor = AsyncAuditor(
            engine="np", on_failure=self._audit_failed, device=self.device
        )

    def _certify_result(self, result, *, engine: str) -> Certificate:
        return certify_result(result, engine=engine, device=self.device)

    def _audit_failed(self, result, cert: Certificate, cls, key) -> None:
        # Too late to retract the served response; stop serving the entry.
        if self.invalidate is not None:
            self.invalidate(key, result.graph.digest())

    def audit(
        self,
        result,
        *,
        cls: Optional[str],
        key,
        certify: Optional[Callable] = None,
    ) -> Optional[str]:
        """Async-only verification for paths where inline correction has
        no safe shape (incremental update sessions, stream commits — the
        response is gone before an audit could retract it). ``full``
        classes audit every result, ``sample`` classes on cadence; a
        failure evicts the entry so the next solve re-derives it.
        ``certify`` selects a non-MST adapter (see :meth:`check`)."""
        mode = self.policy.mode_for(cls)
        if mode == "off":
            return None
        if mode == "full" or self.policy.should_sample(cls):
            self.auditor.submit(result, cls=cls, key=key, certify=certify)
            return "audit"
        return None

    def check(
        self,
        result,
        *,
        cls: Optional[str],
        key,
        backend: str,
        certify: Optional[Callable] = None,
        rederive: Optional[Callable] = None,
    ):
        """Verify ``result`` per policy; returns ``(result, verified)``
        where ``verified`` is ``"full"`` / ``"audit"`` / ``None`` and the
        returned result is the CORRECTED one when inline certification
        failed. Raises ``VerificationError`` only when even the fresh
        re-solve fails its certificate (systemic — a broken checker or a
        broken solver; serving either blind would be worse than erroring).

        The analytics kinds pass their own adapters: ``certify(result,
        engine) -> Certificate`` replaces the MST certificate, and
        ``rederive() -> result`` replaces the injected ``resolve`` for the
        correction path (a kind answer is re-derived by its own solver
        wrapper, not by re-solving an MST).
        """
        mode = self.policy.mode_for(cls)
        if mode == "off":
            return result, None
        if mode == "sample":
            if self.policy.should_sample(cls):
                self.auditor.submit(
                    result, cls=cls, key=key, certify=certify
                )
                return result, "audit"
            return result, None
        # mode == "full": inline, with transparent correction.
        check_fn = certify or self._certify_result
        cert = check_fn(result, engine=self.policy.engine)
        if cert.ok:
            BUS.count("verify.pass")
            return result, "full"
        BUS.count("verify.failed")
        BUS.instant(
            "verify.failure", cat="verify", reason=cert.reason, cls=cls,
            digest=result.graph.digest()[:16],
        )
        if self.invalidate is not None:
            self.invalidate(key, result.graph.digest())
        if rederive is None and self.resolve is None:
            raise VerificationError(
                f"certificate failed ({cert.reason}: {cert.detail}) and no "
                f"re-solve path is attached"
            )
        if rederive is not None:
            corrected = rederive()
        else:
            corrected = self.resolve(result.graph, backend)
        recheck = check_fn(corrected, engine=self.policy.engine)
        if not recheck.ok:
            BUS.count("verify.unrecoverable")
            raise VerificationError(
                f"certificate failed even after a fresh re-solve "
                f"({recheck.reason}: {recheck.detail}) — refusing to serve"
            )
        BUS.count("verify.corrected")
        return corrected, "full"


class VerificationError(RuntimeError):
    """A result failed its certificate and could not be corrected."""
