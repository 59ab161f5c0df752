"""Chaos drill: the full fault matrix, checked against the oracle.

One command answers "does the system actually degrade gracefully, or do we
merely hope so": sweep lossy-channel specs (drop x duplicate x reorder) over
fuzz graphs through the reliable protocol layer, induce solver faults and
slow chunks under the supervisor, tear a checkpoint mid-write and resume —
and assert oracle-parity MST weight on every single case. Everything is
seeded and event-driven (no sleeps, no wall-clock dependence), so a failing
case replays bit-identically.

``fast=True`` is the tier-1 subset (runs in the unit suite);
``python -m distributed_ghs_implementation_tpu_torch.utils.chaos`` runs it
standalone and emits the JSON report.

Port of the JAX package's ``utils/chaos.py``. The protocol leg is host
Python; the solver and checkpoint legs solve on ``device`` (``None`` =
CUDA, so on the card they run the hand kernels; ``"cpu"`` their plain
versions). The oracle is SciPy's (``utils.verify.scipy_mst_weight``) where
the JAX package uses NetworkX, which the card's machine does not have. The
report has the JAX package's schema, case for case.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional

import numpy as np


def _oracle_weight(graph) -> float:
    from distributed_ghs_implementation_tpu_torch.utils.verify import scipy_mst_weight

    return float(scipy_mst_weight(graph))


def _fuzz_graphs(fast: bool) -> list:
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        erdos_renyi_graph,
        line_graph,
        simple_test_graph,
    )

    graphs = [
        ("simple", simple_test_graph()),
        ("line24", line_graph(24)),
        ("er40-a", erdos_renyi_graph(40, 0.12, seed=101)),
        ("er40-b", erdos_renyi_graph(40, 0.12, seed=102)),
    ]
    if not fast:
        graphs += [
            ("line80", line_graph(80)),
            ("er60-sparse", erdos_renyi_graph(60, 0.06, seed=103)),
            ("er60-dense", erdos_renyi_graph(60, 0.25, seed=104)),
            ("er90", erdos_renyi_graph(90, 0.08, seed=105)),
        ]
    return graphs


def _fault_specs(fast: bool) -> list:
    from distributed_ghs_implementation_tpu_torch.protocol.faults import FaultSpec

    if fast:
        return [
            FaultSpec(drop=0.2, duplicate=0.1, reorder=0.3, seed=7),
            FaultSpec(drop=0.2, seed=11),
            FaultSpec(duplicate=0.1, reorder=0.3, seed=13),
        ]
    specs = []
    seed = 1000
    for drop in (0.0, 0.05, 0.1, 0.2):
        for dup in (0.0, 0.1):
            for reorder in (0.0, 0.3):
                seed += 1
                specs.append(
                    FaultSpec(drop=drop, duplicate=dup, reorder=reorder, seed=seed)
                )
    return specs


def _protocol_cases(fast: bool) -> List[dict]:
    """Reliable protocol layer vs the lossy-channel matrix."""
    from distributed_ghs_implementation_tpu_torch.protocol.faults import ReliableTransport
    from distributed_ghs_implementation_tpu_torch.protocol.runner import solve_graph_protocol
    from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels

    cases = []
    for gname, graph in _fuzz_graphs(fast):
        expected = _oracle_weight(graph)
        for spec in _fault_specs(fast):
            transport = ReliableTransport(spec)
            edge_ids, fragment, _levels = solve_graph_protocol(
                graph, transport=transport
            )
            weight = float(graph.w[edge_ids].sum())
            components = count_labels(fragment)
            ok = (
                abs(weight - expected) < 1e-9
                and edge_ids.shape[0] == graph.num_nodes - components
            )
            cases.append(
                {
                    "kind": "protocol",
                    "graph": gname,
                    "spec": {
                        "drop": spec.drop,
                        "duplicate": spec.duplicate,
                        "reorder": spec.reorder,
                        "seed": spec.seed,
                    },
                    "weight": weight,
                    "expected_weight": expected,
                    "stats": transport.stats,
                    "ok": ok,
                }
            )
    return cases


def _solver_cases(fast: bool, device) -> List[dict]:
    """Induced solver faults + slow chunks under the supervisor."""
    from distributed_ghs_implementation_tpu_torch.graphs.generators import erdos_renyi_graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import solve_graph
    from distributed_ghs_implementation_tpu_torch.utils.resilience import (
        FAULTS,
        Supervisor,
        SupervisorConfig,
    )

    graph = erdos_renyi_graph(80, 0.08, seed=200)
    ref_ids, _, _ = solve_graph(graph, device=device)
    cfg = SupervisorConfig(retries_per_rung=1, backoff_base_s=0.0)

    def drill(name, sites, expect_outcomes, config=cfg):
        sup = Supervisor(config, sleep=lambda s: None)
        for site_kwargs in sites:
            FAULTS.arm(**site_kwargs)
        try:
            edge_ids, _frag, _lv, log = sup.solve(graph, entry="device", device=device)
        except Exception as e:  # a crashed case is a failed case, not a
            return {  # crashed report
                "kind": "solver",
                "case": name,
                "error": repr(e),
                "ok": False,
            }
        finally:
            for site_kwargs in sites:
                FAULTS.disarm(site_kwargs["site"])
        outcomes = [(r.rung, r.outcome) for r in log.records]
        ok = bool(np.array_equal(edge_ids, ref_ids)) and outcomes == expect_outcomes
        return {
            "kind": "solver",
            "case": name,
            "incidents": log.to_dicts(),
            "ok": ok,
        }

    cases = [
        # One transient device error: retried on the same rung.
        drill(
            "retry-after-transient",
            [dict(site="resilience.attempt.device", times=1)],
            [("device", "transient"), ("device", "ok")],
        ),
        # Persistent device errors: retries exhausted, degrade to stepped.
        drill(
            "degrade-to-stepped",
            [dict(site="resilience.attempt.device", times=2)],
            [("device", "transient"), ("device", "transient"), ("stepped", "ok")],
        ),
        # A slow chunk trips the watchdog deadline; the retry is clean. The
        # injected 1e6 s of virtual skew dwarfs any real scheduler jitter.
        drill(
            "watchdog-timeout-then-retry",
            [dict(site="resilience.slow.device", times=1, kind="slow", value=1e6)],
            [("device", "timeout"), ("device", "ok")],
            SupervisorConfig(
                retries_per_rung=1, backoff_base_s=0.0, deadline_s=1e5
            ),
        ),
    ]
    if not fast:
        # Every device-path attempt fails: ride the full ladder down to the
        # host Kruskal rung (gated on the native toolchain being present).
        import shutil

        if shutil.which("g++") is not None:
            cases.append(
                drill(
                    "degrade-to-host",
                    [
                        dict(site="resilience.attempt.device", times=2),
                        dict(site="resilience.attempt.stepped", times=2),
                    ],
                    [
                        ("device", "transient"),
                        ("device", "transient"),
                        ("stepped", "transient"),
                        ("stepped", "transient"),
                        ("host", "ok"),
                    ],
                    SupervisorConfig(
                        retries_per_rung=1,
                        backoff_base_s=0.0,
                        ladder=("device", "stepped", "host"),
                    ),
                )
            )
    return cases


def _checkpoint_cases(fast: bool, device, workdir: Optional[str] = None) -> List[dict]:
    """Torn checkpoint writes: recovery from .bak, then from scratch."""
    import os

    from distributed_ghs_implementation_tpu_torch.graphs.generators import erdos_renyi_graph
    from distributed_ghs_implementation_tpu_torch.models.boruvka import solve_graph
    from distributed_ghs_implementation_tpu_torch.utils.checkpoint import (
        graph_fingerprint,
        load_checkpoint,
        load_checkpoint_resilient,
        save_checkpoint,
        solve_graph_checkpointed,
    )
    from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS, InjectedFault

    graph = erdos_renyi_graph(120, 0.06, seed=201)
    ref_ids, _, _ = solve_graph(graph, device=device)
    fp = graph_fingerprint(graph)
    cases = []
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        path = os.path.join(d, "chaos.npz")

        # Populate both generations, then tear a save mid-write.
        solve_graph_checkpointed(graph, path, every=1, device=device)
        frag, mst, level = load_checkpoint(path, expect_fingerprint=fp)
        torn_raised = False
        try:
            with FAULTS.inject("checkpoint.save", times=1, kind="torn"):
                save_checkpoint(path, frag, mst, level, fingerprint=fp)
        except InjectedFault:
            torn_raised = True
        state, source, notes = load_checkpoint_resilient(path, expect_fingerprint=fp)
        ids_bak, _, _ = solve_graph_checkpointed(graph, path, resume=True, device=device)
        cases.append(
            {
                "kind": "checkpoint",
                "case": "torn-write-recovers-from-bak",
                "recovered_from": source,
                "notes": notes,
                "ok": bool(
                    torn_raised
                    and state is not None
                    and source == path + ".bak"
                    and np.array_equal(ids_bak, ref_ids)
                ),
            }
        )

        # Both generations corrupt: resume falls through to a fresh solve.
        with open(path, "wb") as f:
            f.write(b"\x00torn")
        with open(path + ".bak", "wb") as f:
            f.write(b"\x00torn")
        state2, source2, notes2 = load_checkpoint_resilient(
            path, expect_fingerprint=fp
        )
        ids_fresh, _, _ = solve_graph_checkpointed(graph, path, resume=True, device=device)
        cases.append(
            {
                "kind": "checkpoint",
                "case": "double-corruption-solves-fresh",
                "notes": notes2,
                "ok": bool(
                    state2 is None
                    and source2 is None
                    and np.array_equal(ids_fresh, ref_ids)
                ),
            }
        )
    return cases


def _channel_totals(cases: List[dict]) -> dict:
    """Aggregate the reliable sublayer's counters across protocol cases:
    what the lossy channel did (drops/duplicates/reorders injected) and
    what reliability cost (retransmits, acks, duplicates suppressed, worst
    ack latency) — the one-glance health line of the drill."""
    totals = {
        "messages_sent": 0,
        "dropped": 0,
        "duplicated": 0,
        "jittered": 0,
        "retransmits": 0,
        "acks_sent": 0,
        "dup_suppressed": 0,
        "ack_latency_max_ticks": 0,
    }
    for case in cases:
        stats = case.get("stats")
        if not stats:
            continue
        for key in (
            "messages_sent", "dropped", "duplicated", "jittered",
            "retransmits", "acks_sent", "dup_suppressed",
        ):
            totals[key] += stats.get(key, 0)
        latency = stats.get("ack_latency_ticks") or {}
        totals["ack_latency_max_ticks"] = max(
            totals["ack_latency_max_ticks"], latency.get("max", 0)
        )
    return totals


def run_chaos_drill(
    fast: bool = True,
    include_solver: bool = True,
    workdir: Optional[str] = None,
    *,
    device=None,
) -> dict:
    """Run the drill, its solver and checkpoint legs on ``device`` (``None``
    = CUDA); returns the report dict (``report["ok"]`` is the verdict)."""
    from distributed_ghs_implementation_tpu_torch.device import resolve_device

    device = resolve_device(device)
    cases = _protocol_cases(fast)
    if include_solver:
        cases += _solver_cases(fast, device)
        cases += _checkpoint_cases(fast, device, workdir=workdir)
    return {
        "schema": "ghs-chaos-report-v1",
        "fast": fast,
        "num_cases": len(cases),
        "num_failed": sum(not c["ok"] for c in cases),
        "channel_totals": _channel_totals(cases),
        "cases": cases,
        "ok": all(c["ok"] for c in cases),
    }


def emit_report(report: dict, output: Optional[str] = None) -> int:
    """Print/write the report + a failure summary; returns the exit code."""
    blob = json.dumps(report, indent=2)
    if output:
        with open(output, "w") as f:
            f.write(blob + "\n")
        print(output)
    else:
        print(blob)
    failed = [c for c in report["cases"] if not c["ok"]]
    for c in failed:
        print(f"FAILED: {c['kind']}/{c.get('case', c.get('graph'))}", file=sys.stderr)
    print(
        f"chaos drill: {report['num_cases'] - len(failed)}/{report['num_cases']} ok",
        file=sys.stderr,
    )
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="chaos_drill", description="fault-injection drill vs the MST oracle"
    )
    parser.add_argument(
        "--full", action="store_true", help="full matrix (default: fast subset)"
    )
    parser.add_argument(
        "--no-solver",
        action="store_true",
        help="protocol/lossy-channel cases only",
    )
    parser.add_argument("--output", help="write the JSON report here")
    parser.add_argument(
        "--device", default=None,
        help="where the solver and checkpoint legs solve (default: cuda)",
    )
    args = parser.parse_args(argv)
    report = run_chaos_drill(
        fast=not args.full, include_solver=not args.no_solver, device=args.device
    )
    return emit_report(report, args.output)


if __name__ == "__main__":
    sys.exit(main())
