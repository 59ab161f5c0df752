"""Bucket warmup: build the serving hot path before traffic arrives.

Port of the JAX package's ``batch/warmup.py``. The first query on a new
``(n_pad, m_pad, lanes, mode)`` bucket pays the bucket's build inside the
request: the port has no ahead-of-time compile, so a build is the kernel
library's first load (with its K4 self-check) and one launch of the
bucket's solver on an inert stack (``batch/lanes.py``). This module pays
it ahead of serving, for a declared set of buckets:

* **Ladder**: :func:`default_ladder` enumerates power-of-two shape buckets
  up to a ceiling, and :func:`parse_bucket_list` turns an operator's
  ``"128x512,..."`` (raw node and edge counts, bucketed as requests are)
  into the buckets those workloads hit.
* **Replay**: :func:`save_bucket_record` persists the solver keys a live
  process built (``lanes.compiled_bucket_keys``), and
  :func:`load_bucket_record` turns the file back into a plan. The file
  format is the JAX package's: a record written by either package loads in
  the other.
* **Run**: :func:`run_warmup` builds each bucket's lane solver
  (``lanes.precompile_bucket``) and, unless disabled, launches the
  single-graph solve once for the same shape bucket on an inert stack (the
  bypass, fallback and non-batched path).

Warmup builds land on the bus as ``compile.warmup`` and request-time
builds as ``compile.miss``, so "zero builds at request time" is a property
a run can assert: after a warmup that covers the traffic's buckets, the
query phase adds no ``compile.miss``.

``stream_buckets`` warm the windowed stream's Borůvka round
(``stream/window.warm_window_kernels``) at the padded buckets a stream of
that size dispatches, counted ``stream_warmed`` as in the JAX package.

``tuning`` (a ``ghs-tuning-v1`` record, ``tune/``) is installed before any
bucket warms, so the warmed buckets run the tuned launch configs the
requests will. ``mesh_buckets`` warm a ``lane`` (``parallel/lane.py``);
without one they are counted ``mesh_skipped``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.batch.lanes import (
    SolverKey,
    bucket_of,
    compiled_bucket_keys,
    precompile_bucket,
)
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    ELL_AUTO_EDGE_THRESHOLD,
    _next_pow2,
    _solve_from_iota,
    kernel_label,
)
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels

RECORD_SCHEMA = "ghs-warmup-buckets-v1"

#: Lane modes a warmup record may carry. ``lanes == 0`` entries use a
#: placeholder mode (they never reach the lane solver), but it still
#: must be one of these — an unknown string is a corrupt record.
VALID_RECORD_MODES = ("fused", "vmap")

_INT32_MAX = np.iinfo(np.int32).max


class WarmupRecordError(ValueError):
    """A malformed warmup record entry, named precisely — a bad record
    must fail boot with *which entry* is bad, not a bare unpack error."""

#: Single-graph warm ceiling: buckets past these never run the fused iota
#: solve (``solve_graph`` routes them to the rank solver), so warming them
#: would pay a boot-time launch no request ever needs. Matches
#: ``BatchPolicy``'s default admission ceiling.
MAX_SINGLE_WARM_EDGES = ELL_AUTO_EDGE_THRESHOLD
MAX_SINGLE_WARM_NODES = 1 << 16


def warmable_single(n_pad: int, m_pad: int) -> bool:
    """Would a graph in this bucket actually take the fused single-graph
    solve (rather than the rank solver at scale)?"""
    return n_pad <= MAX_SINGLE_WARM_NODES and m_pad <= MAX_SINGLE_WARM_EDGES


@dataclasses.dataclass(frozen=True)
class WarmupPlan:
    """What to build before serving.

    ``buckets`` are padded shape buckets ``(n_pad, m_pad)``; each is built
    at ``lanes`` lanes in ``mode`` (``lanes == 0`` skips the lane solver: a
    service without the batch engine needs only the single-graph solve).
    ``keys`` are exact replayed solver keys (each carries its own lane
    count and mode). ``warm_single`` also launches the single-graph solve
    once per distinct shape bucket.

    ``mesh_buckets`` are raw ``(nodes, edges)`` sizes for the oversize
    path's sharded lane, warmed only when :func:`run_warmup` is handed a
    lane; without one they are counted ``mesh_skipped``.
    ``stream_buckets`` are raw ``(nodes, edges)`` sizes of subscribed
    graphs: each warms the windowed stream's Borůvka round at the padded
    edge buckets a stream of that size dispatches. ``tuning`` is the path
    of a ``ghs-tuning-v1`` record (``tune/record.py``), installed before
    any bucket warms; a missing or stale record installs nothing (counted
    on the bus) and warmup goes on with the default launches.

    ``kernel`` is ``None`` or the label of the device warmup runs on
    (``cuda``, ``torch``): the port has one kernel a device, so there is
    nothing to choose, and any other value raises.
    """

    buckets: Tuple[Tuple[int, int], ...] = ()
    lanes: int = 0
    mode: str = "fused"
    keys: Tuple[SolverKey, ...] = ()
    warm_single: bool = True
    mesh_buckets: Tuple[Tuple[int, int], ...] = ()
    stream_buckets: Tuple[Tuple[int, int], ...] = ()
    kernel: Optional[str] = None
    tuning: Optional[str] = None

    def is_empty(self) -> bool:
        return (
            not self.buckets
            and not self.keys
            and not self.mesh_buckets
            and not self.stream_buckets
        )


def parse_bucket_list(spec: str) -> List[Tuple[int, int]]:
    """Parse ``"128x512,300x1200"`` into padded shape buckets.

    Entries are RAW workload sizes (nodes x edges), bucketed exactly like
    requests are, so operators declare traffic shapes, not padded shapes.
    Duplicate buckets collapse. ``"auto"`` yields :func:`default_ladder`.
    """
    spec = spec.strip()
    if not spec:
        return []
    if spec.lower() in ("auto", "ladder"):
        return default_ladder()
    out: List[Tuple[int, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.lower().split("x")
        if len(parts) != 2:
            raise ValueError(
                f"bad bucket spec {entry!r}; expected NODESxEDGES, e.g. 128x512"
            )
        n, m = int(parts[0]), int(parts[1])
        if n < 1 or m < 1:
            raise ValueError(f"bad bucket spec {entry!r}: sizes must be positive")
        b = bucket_of(n, m)
        if b not in out:
            out.append(b)
    return out


def default_ladder(
    *,
    min_nodes: int = 64,
    max_nodes: int = 4096,
    edge_factors: Sequence[int] = (2, 4),
) -> List[Tuple[int, int]]:
    """A generic small-graph bucket ladder: power-of-two node counts from
    ``min_nodes`` to ``max_nodes``, each at the given edge/node factors.

    This is the no-information default for ``--warmup-buckets auto``; a
    deployment that knows its traffic should declare exact sizes or replay
    a recorded bucket file instead.
    """
    ladder: List[Tuple[int, int]] = []
    n = _next_pow2(max(2, min_nodes))
    while n <= max_nodes:
        for f in edge_factors:
            b = bucket_of(n, f * n)
            if b not in ladder:
                ladder.append(b)
        n *= 2
    return ladder


# ----------------------------------------------------------------------
# Record / replay
# ----------------------------------------------------------------------
def save_bucket_record(
    path: str,
    shape_buckets: Sequence[Tuple[int, int]] = (),
    *,
    include_compiled: bool = True,
) -> int:
    """Persist warmable buckets for replay; returns the entry count.

    ``shape_buckets`` are traffic-observed ``(n_pad, m_pad)`` buckets
    (recorded with ``lanes=0``; the replaying service normalizes them to
    its own lane geometry). With ``include_compiled`` the record also
    snapshots the lane-solver keys this process compiled —
    ``include_compiled=False`` is what ``serve --warmup-record`` uses, so
    a record driven purely by ``seen_buckets`` converges to actual
    traffic instead of accumulating every bucket a prior warmup ladder
    ever compiled.
    """
    keys = compiled_bucket_keys() if include_compiled else []
    covered = {(n, m) for n, m, _, _ in keys}
    for n_pad, m_pad in shape_buckets:
        if (n_pad, m_pad) not in covered:
            keys.append((n_pad, m_pad, 0, "fused"))
            covered.add((n_pad, m_pad))
    with open(path, "w") as f:
        json.dump(
            {
                "schema": RECORD_SCHEMA,
                "buckets": [list(k) for k in keys],
            },
            f,
            indent=2,
        )
        f.write("\n")
    return len(keys)


def _validate_record_entry(path: str, i: int, entry) -> SolverKey:
    """One record entry -> a SolverKey, or :class:`WarmupRecordError`
    naming the offending entry (index + repr)."""

    def bad(why: str) -> WarmupRecordError:
        return WarmupRecordError(
            f"{path}: bucket entry #{i} {entry!r}: {why}"
        )

    if not isinstance(entry, (list, tuple)) or len(entry) != 4:
        raise bad("expected [n_pad, m_pad, lanes, mode]")
    n, m, lanes, mode = entry
    for name, v in (("n_pad", n), ("m_pad", m), ("lanes", lanes)):
        if isinstance(v, bool) or not isinstance(v, int):
            raise bad(f"{name} must be an int, got {type(v).__name__}")
    if n < 1 or m < 1:
        raise bad(f"shape ({n}, {m}) must be positive")
    if lanes < 0:
        raise bad(f"lanes {lanes} must be >= 0")
    if not isinstance(mode, str) or mode not in VALID_RECORD_MODES:
        raise bad(
            f"unknown mode {mode!r} (expected one of {VALID_RECORD_MODES})"
        )
    return (n, m, lanes, mode)


def load_bucket_record(path: str) -> WarmupPlan:
    """Load a recorded bucket file into a replayable :class:`WarmupPlan`.

    Every entry is validated before any is used — a malformed entry
    (wrong arity, non-int sizes, negative sizes, unknown mode) raises a
    typed :class:`WarmupRecordError` naming it, so an operator fixing a
    hand-edited record sees *which* line is bad instead of a bare
    unpacking traceback mid-boot.
    """
    with open(path) as f:
        record = json.load(f)
    if record.get("schema") != RECORD_SCHEMA:
        raise ValueError(
            f"{path}: bad warmup record schema {record.get('schema')!r} "
            f"(expected {RECORD_SCHEMA})"
        )
    buckets = record.get("buckets", [])
    if not isinstance(buckets, list):
        raise WarmupRecordError(
            f"{path}: 'buckets' must be a list, got "
            f"{type(buckets).__name__}"
        )
    keys = tuple(
        _validate_record_entry(path, i, entry)
        for i, entry in enumerate(buckets)
    )
    return WarmupPlan(keys=keys)


def parse_mesh_bucket_list(spec: str) -> List[Tuple[int, int]]:
    """Parse ``"70000x140000,..."`` into raw mesh-bucket workload sizes.

    Same NODESxEDGES surface as :func:`parse_bucket_list`, but entries stay
    RAW — the sharded lane pads to its own mesh-aligned shapes, so padding
    here would double-bucket. Duplicates collapse.
    """
    spec = spec.strip()
    if not spec:
        return []
    out: List[Tuple[int, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.lower().split("x")
        if len(parts) != 2:
            raise ValueError(
                f"bad mesh bucket spec {entry!r}; expected NODESxEDGES"
            )
        n, m = int(parts[0]), int(parts[1])
        if n < 1 or m < 1:
            raise ValueError(
                f"bad mesh bucket spec {entry!r}: sizes must be positive"
            )
        if (n, m) not in out:
            out.append((n, m))
    return out


def plan_from_flags(
    buckets: Optional[str] = None,
    replay: Optional[str] = None,
    lanes: int = 0,
    mesh_buckets: Optional[str] = None,
    stream_buckets: Optional[str] = None,
    kernel: Optional[str] = None,
    tuning: Optional[str] = None,
) -> Optional[WarmupPlan]:
    """A :class:`WarmupPlan` from the serve flags' strings, or ``None``.

    The one mapping from ``--warmup-buckets`` / ``--warmup-replay`` /
    ``--warmup-mesh-buckets`` / ``--warmup-stream-buckets`` strings to a
    plan, as in the JAX package, so one flag set gives one plan in both.
    """
    plans: List[WarmupPlan] = []
    if buckets:
        plans.append(
            WarmupPlan(buckets=tuple(parse_bucket_list(buckets)), lanes=lanes)
        )
    if replay:
        plans.append(load_bucket_record(replay))
    if mesh_buckets:
        plans.append(
            WarmupPlan(
                mesh_buckets=tuple(parse_mesh_bucket_list(mesh_buckets))
            )
        )
    if stream_buckets:
        # Same RAW NODESxEDGES surface as mesh buckets.
        plans.append(
            WarmupPlan(
                stream_buckets=tuple(parse_mesh_bucket_list(stream_buckets))
            )
        )
    if not plans:
        return None
    merged = merge_plans(*plans)
    if kernel and kernel != "auto":
        merged = dataclasses.replace(merged, kernel=kernel)
    if tuning:
        merged = dataclasses.replace(merged, tuning=tuning)
    return merged


def merge_plans(*plans: WarmupPlan) -> WarmupPlan:
    """Union of several plans (CLI: ``--warmup-buckets`` + ``--warmup-replay``)."""
    buckets: List[Tuple[int, int]] = []
    mesh_buckets: List[Tuple[int, int]] = []
    stream_buckets: List[Tuple[int, int]] = []
    keys: List[SolverKey] = []
    lanes, mode, warm_single, kernel = 0, "fused", True, None
    tuning = None
    for p in plans:
        for b in p.buckets:
            if b not in buckets:
                buckets.append(b)
        for b in p.mesh_buckets:
            if b not in mesh_buckets:
                mesh_buckets.append(b)
        for b in p.stream_buckets:
            if b not in stream_buckets:
                stream_buckets.append(b)
        for k in p.keys:
            if k not in keys:
                keys.append(k)
        lanes = max(lanes, p.lanes)
        if p.lanes:
            mode = p.mode
        warm_single = warm_single and p.warm_single
        kernel = kernel or p.kernel
        tuning = tuning or p.tuning
    return WarmupPlan(
        buckets=tuple(buckets), lanes=lanes, mode=mode,
        keys=tuple(keys), warm_single=warm_single,
        mesh_buckets=tuple(mesh_buckets),
        stream_buckets=tuple(stream_buckets),
        kernel=kernel,
        tuning=tuning,
    )


def summarize_report(report: Optional[dict]) -> Optional[dict]:
    """Compact warmup facts (what a worker warmed, without the whole
    report). ``None`` in, ``None`` out: a service booted without a plan
    has nothing to summarize.
    """
    if not report:
        return None
    return {
        "buckets": report.get("buckets", 0),
        "single_warmed": report.get("single_warmed", 0),
        "mesh_warmed": report.get("mesh_warmed", 0),
        "stream_warmed": report.get("stream_warmed", 0),
        "stream_sharded_warmed": report.get("stream_sharded_warmed", 0),
        "kernel": report.get("kernel"),
        "tuned_entries": report.get("tuned_entries", 0),
        "wall_s": round(float(report.get("wall_s", 0.0)), 3),
    }


# ----------------------------------------------------------------------
# Execution
# ----------------------------------------------------------------------
def _warm_single_graph_kernel(n_pad: int, m_pad: int, device) -> None:
    """Launch the single-graph fused solve once for one shape bucket on an
    inert all-pad stack (self-edge slots, sentinel ranks), with the launch
    config of its single-graph bucket (lanes 0): it stops after one level
    without progress. A scalar read on the host waits for it, so a fault
    shows here and not at a later request."""
    e_pad = 2 * m_pad
    src = torch.zeros(e_pad, dtype=torch.int32, device=device)
    rank = torch.full((e_pad,), _INT32_MAX, dtype=torch.int32, device=device)
    ra = torch.zeros(m_pad, dtype=torch.int32, device=device)
    form = kernels.tuned_config((n_pad, m_pad, 0, "fused")).hook_form
    _, fragment, _ = _solve_from_iota(src, src, rank, ra, ra, num_nodes=n_pad, hook_form=form)
    int(fragment[-1])


def run_warmup(plan: WarmupPlan, *, lane=None, device=None) -> dict:
    """Execute a warmup plan on ``device`` (``None`` = CUDA); returns a
    report dict.

    Idempotent: buckets already built are skipped (reported ``cached``).
    The whole phase is one ``compile.warmup_phase`` span. ``lane`` (a
    ``parallel.lane.ShardedLane``) receives the plan's ``mesh_buckets``:
    each warms the oversize path's mesh programs, and the stream window's
    kernels at that size; without a lane they are counted
    ``mesh_skipped``. A ``tuning`` record is installed first (its
    entries counted in ``tuned_entries``). Raises ``ValueError`` for a
    ``kernel`` the device does not run.
    """
    device = resolve_device(device)
    kernel = kernel_label(device)
    if plan.kernel is not None and plan.kernel != kernel:
        raise ValueError(
            f"kernel {plan.kernel!r} does not run on {device}; the port runs {kernel!r} "
            "there and has no other kernel to choose"
        )
    tuned_entries = 0
    if plan.tuning:
        # Install the record FIRST: every bucket below then warms with the
        # launch config its requests will read. A missing or stale record
        # installs nothing (tune.record.miss/stale on the bus) and boot
        # goes on with the default launches.
        from distributed_ghs_implementation_tpu_torch.tune.record import load_and_install

        tuned_entries = load_and_install(plan.tuning, device=device)
    report = {
        "buckets": 0,
        "compiled": 0,
        "cached": 0,
        "skipped": 0,
        "single_warmed": 0,
        "mesh_warmed": 0,
        "mesh_skipped": 0,
        "stream_warmed": 0,
        "stream_sharded_warmed": 0,
        "kernel": kernel,
        "tuned_entries": tuned_entries,
        "wall_s": 0.0,
    }
    if plan.is_empty():
        return report

    t0 = time.perf_counter()
    keys: List[SolverKey] = list(plan.keys)
    if plan.lanes > 0:
        for n_pad, m_pad in plan.buckets:
            k = (n_pad, m_pad, plan.lanes, plan.mode)
            if k not in keys:
                keys.append(k)
    with BUS.span(
        "compile.warmup_phase", cat="compile",
        lane_buckets=len(keys), shape_buckets=len(plan.buckets),
        mesh_buckets=len(plan.mesh_buckets), kernel=kernel,
    ) as span:
        for n_pad, m_pad, lanes, mode in keys:
            if lanes < 1:
                continue  # shape-only record entry: single-graph warm below
            if not warmable_single(n_pad, m_pad):
                # Past the admission ceiling the request path bypasses the
                # lane engine: a typo'd spec must not stall boot.
                report["skipped"] += 1
                continue
            report["buckets"] += 1
            if precompile_bucket(n_pad, m_pad, lanes, mode, device=device):
                report["compiled"] += 1
            else:
                report["cached"] += 1
        if plan.warm_single:
            shapes = {(n, m) for n, m in plan.buckets}
            shapes.update((n, m) for n, m, _, _ in keys)
            for n_pad, m_pad in sorted(shapes):
                if not warmable_single(n_pad, m_pad):
                    continue  # routed to the rank solver, never this solve
                _warm_single_graph_kernel(n_pad, m_pad, device)
                report["single_warmed"] += 1
        for nodes, edges in plan.mesh_buckets:
            if lane is None:
                report["mesh_skipped"] += 1
                continue
            lane.precompile(nodes, edges)
            report["mesh_warmed"] += 1
        if plan.stream_buckets or (lane is not None and plan.mesh_buckets):
            from distributed_ghs_implementation_tpu_torch.stream.window import (
                warm_window_kernels,
            )

            for nodes, edges in plan.stream_buckets:
                report["stream_warmed"] += warm_window_kernels(nodes, edges, device=device)
            if lane is not None:
                # A lane worker's declared oversize sizes are also the sizes
                # its sharded streams publish windows at: warm the window's
                # kernels for them too.
                for nodes, edges in plan.mesh_buckets:
                    report["stream_sharded_warmed"] += warm_window_kernels(
                        nodes, edges, device=device)
        span.set(compiled=report["compiled"], cached=report["cached"])
    report["wall_s"] = time.perf_counter() - t0
    return report
