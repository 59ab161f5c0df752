"""Command-line interface: generate / run / verify / experiments / bench
(the port's copy of the JAX package's ``cli.py``: the same subcommands,
flags, defaults and exit codes).

Flag-compatible supersets of the reference's two CLIs:

* ``generate`` mirrors ``create_graph_files.py``'s argparse surface
  (``--nodes --edge-prob --seed --output-dir``, the reference's
  ``create_graph_files.py:151-170``) and adds G(n,m)/RMAT
  generators and npz output for large graphs.
* ``run --graph-dir`` mirrors the MPI runner's flag
  (``ghs_implementation_mpi.py:894-901``); instead of ``mpiexec -n N`` the
  backend flag picks device/sharded/protocol execution.
* ``verify`` is ``check_mst.py`` as a real subcommand (the reference's has a
  hard-coded directory, ``check_mst.py:4``).
* ``experiments`` is the suite of ``ghs_implementation.py:779-835``.

Every subcommand that solves takes ``--device`` (default ``cuda``); without
CUDA it exits non-zero unless given ``--device cpu``, which runs the
kernels' plain PyTorch versions. Where the port differs on purpose:

* ``serve`` has no ``--kernel``: the device picks the kernels (hand CUDA
  kernels on the card, their torch forms on the CPU), and no
  ``GHS_KERNEL`` is exported to fleet workers;
* ``verify`` prints the SciPy rank oracle's weight and forest, where the
  JAX package uses NetworkX;
* ``tune --mesh-buckets`` counts the devices of the port's mesh
  (``parallel.mesh.edge_mesh``);
* ``bench`` runs the port's ``bench.py``, which has no ``--kernel`` and
  writes the card's name and power limit beside its numbers.

Usage: ``python -m distributed_ghs_implementation_tpu_torch <subcommand> ...``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _cmd_generate(args) -> int:
    from distributed_ghs_implementation_tpu_torch.graphs import generators, io

    t0 = time.perf_counter()
    if args.kind == "er":
        g = generators.erdos_renyi_graph(
            args.nodes, args.edge_prob, seed=args.seed
        )
    elif args.kind == "reference":
        g = generators.reference_random_graph(args.nodes, args.edge_prob, args.seed)
    elif args.kind == "gnm":
        g = generators.gnm_random_graph(args.nodes, args.edges, seed=args.seed)
    elif args.kind == "rmat":
        g = generators.rmat_graph(args.rmat_scale, args.rmat_edge_factor, seed=args.seed)
    elif args.kind == "simple-test":
        g = generators.simple_test_graph()
    else:
        raise ValueError(args.kind)
    print(
        f"generated {args.kind}: {g.num_nodes:,} nodes, {g.num_edges:,} edges "
        f"in {time.perf_counter() - t0:.2f}s",
        file=sys.stderr,
    )
    if args.npz:
        os.makedirs(args.output_dir, exist_ok=True)
        path = io.write_npz(g, os.path.join(args.output_dir, "graph.npz"))
        print(path)
    else:
        io.write_partition_dir(g, args.output_dir)
        print(args.output_dir)
    if args.visualize:
        from distributed_ghs_implementation_tpu_torch.utils.viz import visualize_graph

        visualize_graph(g, os.path.join(args.output_dir, "input_graph.png"))
    return 0


def _load_graph(args):
    from distributed_ghs_implementation_tpu_torch.graphs import io

    if args.graph_dir.endswith(".npz"):
        return io.read_npz(args.graph_dir)
    return io.read_partition_dir(args.graph_dir)


def _cmd_run(args) -> int:
    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.utils.reporting import (
        result_to_dict,
        write_result_json,
    )

    primary = True
    if args.multihost:
        from distributed_ghs_implementation_tpu_torch.parallel import multihost

        multihost.initialize(device=args.device)
        primary = multihost.is_primary()

    g = _load_graph(args)
    if args.checkpoint:
        if args.backend not in ("device", "sharded"):
            raise SystemExit("--checkpoint requires --backend device or sharded")
        if args.supervised:
            raise SystemExit(
                "--supervised and --checkpoint are separate recovery paths; "
                "pick one (checkpointed solves already self-heal via the "
                ".bak generation fallback)"
            )
        from distributed_ghs_implementation_tpu_torch.api import MSTResult
        from distributed_ghs_implementation_tpu_torch.utils.checkpoint import (
            solve_graph_checkpointed,
            solve_graph_checkpointed_sharded,
        )
        from distributed_ghs_implementation_tpu_torch.utils.labels import count_labels

        t0 = time.perf_counter()
        if args.backend == "sharded":
            edge_ids, fragment, levels = solve_graph_checkpointed_sharded(
                g, args.checkpoint, every=args.checkpoint_every,
                device=args.device,
            )
        else:
            edge_ids, fragment, levels = solve_graph_checkpointed(
                g, args.checkpoint, every=args.checkpoint_every,
                device=args.device,
            )
        result = MSTResult(
            graph=g,
            edge_ids=edge_ids,
            num_levels=levels,
            wall_time_s=time.perf_counter() - t0,
            backend=f"{args.backend}/checkpointed",
            num_components=count_labels(fragment),
        )
    else:
        supervisor = None
        if args.supervised and args.deadline_s is not None:
            from distributed_ghs_implementation_tpu_torch.utils.resilience import (
                Supervisor,
                SupervisorConfig,
            )

            supervisor = Supervisor(SupervisorConfig(deadline_s=args.deadline_s))
        result = minimum_spanning_forest(
            g, backend=args.backend, supervised=args.supervised,
            supervisor=supervisor, device=args.device,
        )
    if not primary:
        return 0  # artifacts are written by process 0 only
    if result.incidents is not None and len(result.incidents):
        print(f"supervisor: {result.incidents.summary()}", file=sys.stderr)
    print(json.dumps(result_to_dict(result), indent=2))
    if args.output:
        write_result_json(result, args.output)
    if args.metrics_out:
        # The bench-gate schema (tools/bench_gate.py), so ad-hoc runs gate
        # against saved baselines exactly like `ghs bench` runs do.
        with open(args.metrics_out, "w") as f:
            json.dump(
                {
                    "schema": "ghs-bench-metrics-v1",
                    "config": {
                        "workload": f"run-{os.path.basename(args.graph_dir)}"
                        f"-{result.backend}",
                    },
                    "metrics": {
                        "solve_s": result.wall_time_s,
                        "levels": int(result.num_levels),
                        "mst_weight": result.total_weight,
                        "mst_edges": int(result.num_edges),
                    },
                },
                f,
                indent=2,
            )
            f.write("\n")
    if args.visualize:
        from distributed_ghs_implementation_tpu_torch.utils.viz import visualize_mst

        out = args.output or "mst_result.json"
        visualize_mst(result, os.path.splitext(out)[0] + ".png")
    if args.verify:
        from distributed_ghs_implementation_tpu_torch.utils.verify import verify_result

        v = verify_result(result)
        print(
            f"verify[{v.oracle}]: {'OK' if v.ok else 'FAIL'} "
            f"(weight {v.actual_weight} vs {v.expected_weight}, "
            f"edges {v.actual_edges} vs {v.expected_edges})",
            file=sys.stderr,
        )
        if not v.ok:
            # Auto-dump diagnostics on failure, like the reference's debug
            # dump trigger (ghs_implementation.py:735-737).
            from distributed_ghs_implementation_tpu_torch.utils.diagnostics import (
                dump_failure_report,
            )

            path = dump_failure_report(
                result, v,
                path=os.path.splitext(args.output or "ghs_result")[0]
                + "_failure_report.json",
            )
            print(f"diagnostics written to {path}", file=sys.stderr)
        return 0 if v.ok else 1
    return 0


def _cmd_verify(args) -> int:
    """check_mst.py parity: print the oracle MST for a graph dir. The
    oracle is SciPy's, over the ``(weight, edge id)`` rank order
    (``rank_oracle_edge_ids``): its forest, and that forest's weight."""
    from distributed_ghs_implementation_tpu_torch.utils.verify import (
        rank_oracle_edge_ids,
    )

    g = _load_graph(args)
    ids = rank_oracle_edge_ids(g)
    weight = g.w[ids].sum()
    weight = int(weight) if g.is_integer_weighted else float(weight)
    if g.num_edges <= 200_000:
        print(f"expected MST weight: {weight}")
        for a, b in sorted(zip(g.u[ids].tolist(), g.v[ids].tolist())):
            print(f"  ({a}, {b})")
    else:
        print(f"expected MSF weight: {weight}")
    if args.result:
        with open(args.result) as f:
            res = json.load(f)
        ok = abs(float(res["total_weight"]) - float(weight)) < 1e-6
        print(f"result file {args.result}: {'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


def _cmd_experiments(args) -> int:
    from distributed_ghs_implementation_tpu_torch.experiments import run_suite

    records = run_suite(
        backend=args.backend,
        extended=args.extended,
        output_json=args.output,
        visualize_dir=args.visualize_dir,
        device=args.device,
    )
    return 0 if all(r["is_correct"] for r in records) else 1


def _cmd_chaos(args) -> int:
    from distributed_ghs_implementation_tpu_torch.utils import chaos

    report = chaos.run_chaos_drill(
        fast=not args.full, include_solver=not args.no_solver,
        device=args.device,
    )
    return chaos.emit_report(report, args.output)


def _trace_graph(args):
    """The graph a trace/stats session runs on: ``--graph-dir`` when given,
    else a seeded G(n,m) (default 1k nodes — small enough to trace every
    backend, big enough for multi-level solver activity)."""
    if args.graph_dir:
        return _load_graph(args)
    from distributed_ghs_implementation_tpu_torch.graphs.generators import (
        gnm_random_graph,
    )

    edges = args.edges or 4 * args.nodes
    return gnm_random_graph(args.nodes, edges, seed=args.seed)


def _traced_session(args):
    """Run one fully-instrumented solve session; returns the event bus.

    The solve goes through the self-healing supervisor (entry = the chosen
    backend rung), so armed ``GHS_FAULT_*`` sites surface as structured
    ``resilience.attempt`` retry events in the trace. Default entry is the
    ``stepped`` rung — the host-stepped kernel emits one ``solver.level``
    span per level, which is the timeline a trace is for. Unless disabled,
    a protocol pass over the same graph rides along and contributes message
    counters (``protocol.*``) to the same trace.
    """
    from distributed_ghs_implementation_tpu_torch.api import minimum_spanning_forest
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS
    from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS

    BUS.enable()
    BUS.clear()
    FAULTS.reload_env()
    g = _trace_graph(args)
    with BUS.span(
        "trace.session", cat="trace", backend=args.backend,
        nodes=g.num_nodes, edges=g.num_edges,
    ):
        if args.backend == "protocol":
            from distributed_ghs_implementation_tpu_torch.protocol.runner import (
                solve_graph_protocol,
            )

            solve_graph_protocol(g)
        else:
            result = minimum_spanning_forest(
                g, backend=args.backend, supervised=True, device=args.device
            )
            if result.incidents is not None and len(result.incidents):
                print(
                    f"supervisor: {result.incidents.summary()}", file=sys.stderr
                )
            if (
                not args.no_protocol_sample
                and g.num_nodes <= args.protocol_sample_max
            ):
                from distributed_ghs_implementation_tpu_torch.protocol.runner import (
                    solve_graph_protocol,
                )

                with BUS.span(
                    "trace.protocol_sample", cat="trace", nodes=g.num_nodes
                ):
                    solve_graph_protocol(g)
    return BUS


def _cmd_trace(args) -> int:
    from distributed_ghs_implementation_tpu_torch.obs.export import (
        render_stats,
        write_chrome_trace,
        write_events_jsonl,
    )

    bus = _traced_session(args)
    write_chrome_trace(bus, args.out)
    if args.jsonl:
        write_events_jsonl(bus, args.jsonl)
    print(render_stats(bus.snapshot()), file=sys.stderr)
    print("open in https://ui.perfetto.dev or chrome://tracing", file=sys.stderr)
    print(args.out)
    return 0


def _cmd_stats(args) -> int:
    from distributed_ghs_implementation_tpu_torch.obs.export import (
        render_stats,
        snapshot_from_jsonl,
    )

    if args.input:
        snapshot = snapshot_from_jsonl(args.input)
    else:
        snapshot = _traced_session(args).snapshot()
    print(render_stats(snapshot))
    return 0


def _cmd_merge_trace(args) -> int:
    """Join per-process span JSONL logs (router + workers, or any set of
    ``write_events_jsonl`` exports) into one Perfetto trace with flow
    arrows across process hops, plus the per-trace critical-path report
    (docs/OBSERVABILITY.md has the walkthrough)."""
    from distributed_ghs_implementation_tpu_torch.obs.export import (
        write_merged_trace,
    )

    report = write_merged_trace(args.inputs, args.out, args.report)
    cp = report["critical_path"]["summary"]
    print(
        f"merged {len(report['processes'])} processes, "
        f"{report['spans_indexed']} spans, "
        f"{report['flow_arrows']} flow arrows",
        file=sys.stderr,
    )
    print(
        f"traces: {report['traces_total']} total, "
        f"{report['traces_joined']} joined across processes, "
        f"{report['orphan_spans']} orphan spans",
        file=sys.stderr,
    )
    if cp.get("traces"):
        print(
            f"critical path over {cp['traces']} rooted traces: "
            f"queue {cp['queue_s']:.3f}s, transport {cp['transport_s']:.3f}s, "
            f"solve {cp['solve_s']:.3f}s, verify {cp['verify_s']:.3f}s "
            f"(accounted >= {cp['accounted_frac_min']:.3f})",
            file=sys.stderr,
        )
    print("open in https://ui.perfetto.dev or chrome://tracing",
          file=sys.stderr)
    print(args.out)
    return 0


def _cmd_serve(args) -> int:
    """The MST query service: JSONL requests on stdin (or --input), JSON
    responses on stdout (serve/service.py has the protocol). ``--fleet N``
    serves the same protocol through N digest-routed worker processes with
    health-checked failover (fleet/router.py, docs/FLEET.md)."""
    from distributed_ghs_implementation_tpu_torch.serve.service import (
        MSTService,
        serve_frames,
        serve_loop,
    )

    def _serve_stdio(handler) -> int:
        # One switch for both fleet and single-process serving: the binary
        # wire swaps the carrier (framed binary stdio, B-frame ingest/
        # egress), never the handler.
        if args.wire == "binary":
            if args.input:
                with open(args.input, "rb") as f:
                    return serve_frames(f, sys.stdout.buffer, handler)
            return serve_frames(sys.stdin.buffer, sys.stdout.buffer, handler)
        if args.input:
            with open(args.input) as f:
                return serve_loop(f, sys.stdout, handler)
        return serve_loop(sys.stdin, sys.stdout, handler)

    if args.fleet_elastic and not (args.fleet or args.fleet_workers):
        raise SystemExit("--fleet-elastic needs --fleet N")
    if args.fleet or args.fleet_workers:
        from distributed_ghs_implementation_tpu_torch.fleet.router import (
            FleetConfig,
            FleetRouter,
        )

        if args.warmup_record:
            raise SystemExit(
                "--warmup-record is per-worker state the router cannot "
                "see; record from a single-process serve, then replay "
                "with --fleet --warmup-replay"
            )
        remote = tuple(
            a for a in (args.fleet_workers or "").split(",") if a
        )
        if remote and args.fleet and args.fleet != len(remote):
            raise SystemExit(
                f"--fleet {args.fleet} contradicts --fleet-workers "
                f"({len(remote)} endpoints); drop --fleet or make them match"
            )
        config = FleetConfig(
            workers=len(remote) or args.fleet,
            transport="tcp" if remote else args.fleet_transport,
            remote_workers=remote,
            forward_cache={"auto": None, "on": True, "off": False}[
                args.fleet_forward_cache
            ],
            lease_s=args.fleet_lease,
            journal_dir=args.fleet_journal,
            backend=args.backend,
            batch_lanes=args.batch_lanes,
            store_capacity=args.cache_entries,
            disk_dir=args.disk_cache,
            max_concurrent=args.max_concurrent,
            resolve_threshold=args.resolve_threshold,
            queue_depth=args.fleet_queue_depth,
            shed_classes=tuple(
                c for c in (args.fleet_shed or "").split(",") if c
            ),
            warmup_buckets=args.warmup_buckets,
            warmup_replay=args.warmup_replay,
            warmup_mesh_buckets=args.warmup_mesh_buckets,
            warmup_stream_buckets=args.warmup_stream_buckets,
            compile_cache_dir=args.compile_cache_dir,
            no_compile_cache=args.no_compile_cache,
            tune_record=args.tune_record,
            obs_dir=args.fleet_obs_dir,
            sharded_lane_workers=args.sharded_lane,
            stream_dir=args.stream_dir,
            stream_snapshot_every=args.stream_snapshot_every,
            verify=args.verify_policy,
            device=args.device,
        )
        autoscaler = None
        if args.fleet_elastic:
            from distributed_ghs_implementation_tpu_torch.fleet.autoscaler import (
                Autoscaler,
                ElasticPolicy,
                parse_class_budgets,
            )

            mn, _, mx = args.fleet_elastic.partition(":")
            try:
                policy = ElasticPolicy(
                    min_workers=int(mn),
                    max_workers=int(mx),
                    wait_budget_s=args.fleet_scale_budget,
                    class_budgets_s=parse_class_budgets(
                        args.fleet_scale_budgets or ""
                    ),
                    cooldown_s=args.fleet_scale_cooldown,
                )
            except ValueError as e:
                raise SystemExit(f"--fleet-elastic: {e}")
            if remote:
                raise SystemExit(
                    "--fleet-elastic needs spawnable workers; a "
                    "--fleet-workers remote topology is fixed by its "
                    "endpoint list"
                )
            if not policy.min_workers <= config.workers <= policy.max_workers:
                raise SystemExit(
                    f"--fleet {config.workers} must sit inside "
                    f"--fleet-elastic {policy.min_workers}:"
                    f"{policy.max_workers}"
                )
        # Workers enable the (shared, manifest-checked) persistent build
        # cache and run warmup themselves; the router never builds or
        # touches a device, so none of that happens in this process.
        with FleetRouter(config) as router:
            print(
                f"fleet: {config.workers} workers ready over "
                f"{config.transport} (queue_depth={config.queue_depth}"
                + (", forward_cache on" if config.forward_enabled else "")
                + (f", elastic {args.fleet_elastic}"
                   if args.fleet_elastic else "")
                + ")",
                file=sys.stderr,
            )
            if args.fleet_elastic:
                autoscaler = Autoscaler(router, policy).start()
            try:
                return _serve_stdio(router)
            finally:
                if autoscaler is not None:
                    autoscaler.close()

    # Persistent build cache first (default ON for serve): it must be set
    # before the first library load, warmup's included.
    if not args.no_compile_cache:
        from distributed_ghs_implementation_tpu_torch.utils.compile_cache import (
            enable_persistent_cache,
        )

        cache_dir = enable_persistent_cache(args.compile_cache_dir)
        if cache_dir:
            print(f"compile cache: {cache_dir}", file=sys.stderr)

    if args.tune_record:
        # Measured launch configs land before the first solve, warmup's
        # included (a stale or missing record installs nothing, never an
        # error).
        from distributed_ghs_implementation_tpu_torch.tune import load_and_install

        installed = load_and_install(args.tune_record, device=args.device)
        print(
            f"tune record: {installed} bucket(s) from {args.tune_record}",
            file=sys.stderr,
        )

    from distributed_ghs_implementation_tpu_torch.batch.warmup import plan_from_flags

    warmup_plan = plan_from_flags(
        buckets=args.warmup_buckets,
        replay=args.warmup_replay,
        lanes=args.batch_lanes,
        mesh_buckets=args.warmup_mesh_buckets,
        stream_buckets=args.warmup_stream_buckets,
        tuning=args.tune_record,
    )

    service = MSTService(
        backend=args.backend,
        store_capacity=args.cache_entries,
        disk_dir=args.disk_cache,
        max_concurrent=args.max_concurrent,
        resolve_threshold=args.resolve_threshold,
        batch_lanes=args.batch_lanes,
        warmup=warmup_plan,
        # -1 = the bare flag: all devices; N > 0 = a submesh of N.
        sharded_lane=(True if args.sharded_lane == -1
                      else max(0, args.sharded_lane)),
        stream_dir=args.stream_dir,
        stream_snapshot_every=args.stream_snapshot_every,
        verify=args.verify_policy,
        device=args.device,
    )
    if service.warmup_report is not None:
        print(f"warmup: {json.dumps(service.warmup_report)}", file=sys.stderr)
    try:
        return _serve_stdio(service)
    finally:
        if args.warmup_record:
            from distributed_ghs_implementation_tpu_torch.batch import warmup as warmup_mod

            # Traffic-only record: the shapes requests actually hit, not
            # whatever a warmup ladder happened to compile — replayed
            # records converge to real traffic across restarts.
            count = warmup_mod.save_bucket_record(
                args.warmup_record,
                shape_buckets=list(service.seen_buckets),
                include_compiled=False,
            )
            print(
                f"warmup record: {count} bucket(s) -> {args.warmup_record}",
                file=sys.stderr,
            )


def _cmd_tune(args) -> int:
    """Offline launch-config tuner: enumerate the valid launch configs per
    bucket (K1's form, K3's tile), score them (seeded, warm-then-median,
    parity-gated), and persist a machine-fingerprinted ``ghs-tuning-v1``
    record that each bucket's solver reads (``tune/``). On the CPU, and
    always with ``--dry``, the default config is pinned, so two runs yield
    byte-identical records."""
    from distributed_ghs_implementation_tpu_torch.batch import warmup as warmup_mod
    from distributed_ghs_implementation_tpu_torch.tune import (
        default_record_path,
        save_record,
        search,
    )
    from distributed_ghs_implementation_tpu_torch.tune.measure import mesh_bucket

    lanes = max(0, args.lanes)
    buckets = []
    if args.buckets:
        for n, m in warmup_mod.parse_bucket_list(args.buckets):
            if lanes >= 1:
                buckets.append((n, m, lanes, args.mode))
            # The single-graph (miss-path) variant serves the same shapes.
            buckets.append((n, m, 0, "fused"))
    if args.warmup_record:
        # A --warmup-record file from a serving run: tune exactly the
        # buckets real traffic compiled.
        plan = warmup_mod.load_bucket_record(args.warmup_record)
        buckets.extend(tuple(k) for k in plan.keys)
    if args.mesh_buckets:
        from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh

        n_dev = edge_mesh(device=args.device).size
        for n, m in warmup_mod.parse_mesh_bucket_list(args.mesh_buckets):
            buckets.append(mesh_bucket(n, m, n_dev))
    if not buckets:
        raise SystemExit(
            "tune: nothing to tune; pass --buckets, --warmup-record, "
            "and/or --mesh-buckets"
        )
    record = search(buckets, repeats=args.repeats, dry=args.dry, device=args.device)
    out = args.out or default_record_path(device=args.device)
    save_record(record, out)
    print(json.dumps({
        "path": out,
        "fingerprint": record["fingerprint"],
        "backend": record["backend"],
        "pinned": record["pinned"],
        "buckets": len(record["entries"]),
        "winners": {
            k: e["kernel"] for k, e in sorted(record["entries"].items())
        },
    }, indent=2, sort_keys=True))
    return 0


def _cmd_bench(args) -> int:
    from distributed_ghs_implementation_tpu_torch import bench as bench_mod

    argv = ["--scale", str(args.scale),
            "--edge-factor", str(args.edge_factor),
            "--repeats", str(args.repeats), "--backend", args.backend,
            "--device", args.device]
    if args.no_verify:
        argv.append("--no-verify")
    if args.metrics_out:
        argv += ["--metrics-out", args.metrics_out]
    if args.batch_lanes:
        argv += ["--batch-lanes", str(args.batch_lanes)]
    if args.warmup:
        argv.append("--warmup")
    if args.update_stream:
        argv.append("--update-stream")
    return bench_mod.main(argv)


def _device_arg(sp) -> None:
    sp.add_argument(
        "--device", default="cuda",
        help="where the solves run: 'cuda' (default; exits non-zero without "
        "CUDA) or 'cpu' (the kernels' plain PyTorch versions)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_ghs_implementation_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate a graph + partition files")
    g.add_argument("--nodes", type=int, default=6)  # create_graph_files.py default
    g.add_argument("--edge-prob", type=float, default=0.5)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--output-dir", default="graph_data")
    g.add_argument(
        "--kind",
        default="reference",
        choices=["reference", "er", "gnm", "rmat", "simple-test"],
    )
    g.add_argument("--edges", type=int, default=8192, help="for --kind gnm")
    g.add_argument("--rmat-scale", type=int, default=16)
    g.add_argument("--rmat-edge-factor", type=int, default=16)
    g.add_argument("--npz", action="store_true", help="write graph.npz instead of JSON")
    g.add_argument("--visualize", action="store_true")
    g.set_defaults(fn=_cmd_generate)

    r = sub.add_parser("run", help="compute the MST of a graph dir / npz")
    r.add_argument("--graph-dir", default="graph_data")
    r.add_argument(
        "--backend", default="device", choices=["device", "sharded", "protocol"]
    )
    r.add_argument("--output", help="write mst_result.json here")
    r.add_argument("--visualize", action="store_true")
    r.add_argument("--verify", action="store_true")
    r.add_argument(
        "--multihost",
        action="store_true",
        help="bring up torch.distributed first (parallel/multihost.py: "
        "torchrun's MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE)",
    )
    r.add_argument(
        "--checkpoint",
        help="write per-level solver state here and resume from it if present",
    )
    r.add_argument(
        "--checkpoint-every", type=int, default=1, help="levels between checkpoints"
    )
    r.add_argument(
        "--supervised",
        action="store_true",
        help="self-healing solve: watchdog + retry/backoff + the "
        "sharded->device->stepped->host degradation ladder "
        "(utils/resilience.py)",
    )
    r.add_argument(
        "--deadline-s",
        type=float,
        help="with --supervised: watchdog deadline per attempt, checked at "
        "chunk/level boundaries",
    )
    r.add_argument(
        "--metrics-out",
        help="write bench-gate metrics JSON here (tools/bench_gate.py; "
        "same schema as `bench --metrics-out`)",
    )
    _device_arg(r)
    r.set_defaults(fn=_cmd_run)

    v = sub.add_parser("verify", help="print the oracle MST for a graph dir")
    v.add_argument("--graph-dir", default="graph_data")
    v.add_argument("--result", help="optionally check a result JSON against it")
    v.set_defaults(fn=_cmd_verify)

    e = sub.add_parser("experiments", help="run the reference experiment suite")
    e.add_argument(
        "--backend", default="device", choices=["device", "sharded", "protocol"]
    )
    e.add_argument("--extended", action="store_true")
    e.add_argument("--output", default="ghs_experiments.json")
    e.add_argument("--visualize-dir")
    _device_arg(e)
    e.set_defaults(fn=_cmd_experiments)

    c = sub.add_parser(
        "chaos",
        help="fault-injection drill: lossy transport + induced solver faults "
        "+ torn checkpoint writes, all checked against the MST oracle",
    )
    c.add_argument("--full", action="store_true", help="full fault matrix")
    c.add_argument("--no-solver", action="store_true")
    c.add_argument("--output", help="write the JSON report here")
    _device_arg(c)
    c.set_defaults(fn=_cmd_chaos)

    def _obs_graph_args(sp):
        sp.add_argument("--graph-dir", default=None,
                        help="trace this graph dir / npz instead of generating")
        sp.add_argument("--nodes", type=int, default=1000)
        sp.add_argument("--edges", type=int, default=0,
                        help="G(n,m) edges (default 4x nodes)")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument(
            "--backend",
            default="stepped",
            choices=["stepped", "device", "sharded", "protocol"],
            help="supervisor entry rung (stepped emits per-level spans) or "
            "the message-level protocol backend",
        )
        sp.add_argument(
            "--no-protocol-sample",
            action="store_true",
            help="skip the protocol pass that adds message counters",
        )
        sp.add_argument("--protocol-sample-max", type=int, default=2000,
                        help="largest node count the protocol sample runs at")
        _device_arg(sp)

    t = sub.add_parser(
        "trace",
        help="run an instrumented solve and export a Chrome-trace/Perfetto "
        "timeline (solver levels, protocol counters, resilience retries)",
    )
    _obs_graph_args(t)
    t.add_argument("--out", default="trace.json",
                   help="Chrome-trace JSON output path")
    t.add_argument("--jsonl", help="also write the raw event log here")
    t.set_defaults(fn=_cmd_trace)

    s = sub.add_parser(
        "stats",
        help="plain-text telemetry summary (span/counter/histogram tables) "
        "from a fresh instrumented solve or an existing event JSONL",
    )
    _obs_graph_args(s)
    s.add_argument("--input", help="summarize this event JSONL instead of running")
    s.set_defaults(fn=_cmd_stats)

    mt = sub.add_parser(
        "merge-trace",
        help="join per-process span JSONL logs (fleet router + workers) "
        "into one Perfetto trace with cross-process flow arrows and a "
        "per-request critical-path report (docs/OBSERVABILITY.md)",
    )
    mt.add_argument("inputs", nargs="+",
                    help="event JSONL files exported by each process "
                    "(e.g. a --trace-dir's router.jsonl + worker*.jsonl)")
    mt.add_argument("--out", default="merged_trace.json",
                    help="merged Chrome-trace JSON output path")
    mt.add_argument("--report",
                    help="also write the merge + critical-path report here")
    mt.set_defaults(fn=_cmd_merge_trace)

    srv = sub.add_parser(
        "serve",
        help="MST query service: JSONL solve/update/stats requests on stdin, "
        "content-addressed result cache + incremental edge updates "
        "(docs/SERVING.md)",
    )
    srv.add_argument(
        "--backend", default="device", choices=["device", "sharded"]
    )
    srv.add_argument("--cache-entries", type=int, default=128,
                     help="in-memory LRU capacity (results)")
    srv.add_argument("--disk-cache",
                     help="directory for the persistent cache layer")
    srv.add_argument("--max-concurrent", type=int, default=2,
                     help="solve admission bound (cache misses in flight)")
    srv.add_argument(
        "--resolve-threshold", type=int,
        help="update batches larger than this re-solve instead of applying "
        "incrementally (default: max(64, edges/10))",
    )
    srv.add_argument(
        "--batch-lanes", type=int, default=0,
        help="coalesce device-backend cache misses into multi-graph device "
        "batches of up to this many lanes (0 = off; docs/BATCHING.md)",
    )
    srv.add_argument(
        "--warmup-buckets",
        help="AOT-precompile these workload shapes before serving: "
        "comma-separated NODESxEDGES (e.g. 128x512,300x1200; shapes bucket "
        "exactly like requests do) or 'auto' for the default ladder",
    )
    srv.add_argument(
        "--warmup-replay",
        help="AOT-precompile the buckets recorded in this file (written by "
        "--warmup-record on a prior run)",
    )
    srv.add_argument(
        "--sharded-lane", type=int, nargs="?", const=-1, default=0,
        metavar="N",
        help="route oversize solves to a mesh-sharded solve lane over N "
        "devices (bare flag = all devices; 0 = off) with device-resident "
        "graph residency and donated incremental updates; with --fleet, "
        "N is instead the number of worker slots that own a lane (bare "
        "flag = every worker) and the router steers oversize digests at "
        "them (docs/SHARDED_LANE.md)",
    )
    srv.add_argument(
        "--warmup-mesh-buckets",
        help="AOT-warm the sharded lane's mesh programs for these RAW "
        "NODESxEDGES oversize workloads before serving (needs "
        "--sharded-lane)",
    )
    srv.add_argument(
        "--stream-dir",
        help="durable stream layer: subscription streams persist a "
        "snapshot + update WAL per stream here (shared across fleet "
        "workers; a restart replays instead of re-solving — "
        "docs/STREAMING.md)",
    )
    srv.add_argument(
        "--stream-snapshot-every", type=int, default=8,
        help="committed windows between stream snapshots (the WAL holds "
        "the deltas in between)",
    )
    srv.add_argument(
        "--warmup-stream-buckets",
        help="AOT-warm the windowed-maintenance kernels for subscribed "
        "graphs of these RAW NODESxEDGES sizes before serving",
    )
    srv.add_argument(
        "--verify", dest="verify_policy", default=None, metavar="SPEC",
        help="result verification policy (docs/VERIFICATION.md): 'off', "
        "'sample[:N]', 'full', or per-class "
        "'bulk=full,interactive=sample,default=off'. 'full' classes "
        "certify every answer inline (O(m log n) MST certificate, "
        "independent code path) with transparent correction on failure; "
        "'sample' classes audit on a background thread. Fleet mode "
        "passes the spec to every worker",
    )
    srv.add_argument(
        "--warmup-record",
        help="on exit, record the buckets this process compiled to this "
        "file (feed it to --warmup-replay after a restart)",
    )
    srv.add_argument(
        "--compile-cache-dir",
        help="persistent build-cache directory for the kernel library and "
        "the native host library (utils/compile_cache.py; each entry is "
        "keyed by its sources, flags and host, and checked by a manifest)",
    )
    srv.add_argument(
        "--no-compile-cache", action="store_true",
        help="disable the persistent build cache (on by default for "
        "serve: restarts load the libraries instead of building them)",
    )
    srv.add_argument("--input",
                     help="read JSONL requests from this file instead of stdin")
    srv.add_argument(
        "--wire", choices=("json", "binary"), default="json",
        help="front-door carrier: 'json' = text JSONL (default); 'binary' "
        "= length-prefixed frames over binary stdio, accepting B-frames "
        "(raw little-endian edge-array sections behind a compact header, "
        "zero-copy ingest) and answering in kind per connection "
        "(docs/SERVING.md \"Binary wire\")",
    )
    srv.add_argument(
        "--fleet", type=int, default=0, metavar="N",
        help="serve through N digest-routed worker processes with "
        "health-checked failover and graceful drain (0 = single-process; "
        "docs/FLEET.md)",
    )
    srv.add_argument(
        "--fleet-queue-depth", type=int, default=64,
        help="with --fleet: per-worker in-flight bound (full queues shed "
        "--fleet-shed classes, backpressure everything else)",
    )
    srv.add_argument(
        "--fleet-shed",
        help="with --fleet: comma-separated slo_class labels that may be "
        "shed when a worker queue is full (default: none — block instead)",
    )
    srv.add_argument(
        "--fleet-obs-dir",
        help="with --fleet: each worker exports its obs event JSONL here "
        "on drain (worker<K>.<incarnation>.jsonl)",
    )
    srv.add_argument(
        "--fleet-transport", choices=("pipe", "tcp"), default="pipe",
        help="with --fleet: the router<->worker channel — subprocess "
        "pipes (single host) or TCP sockets with coalesced pipelined "
        "frame writes (fleet/transport.py; spawned workers dial into the "
        "router's listener with a tokened hello; docs/FLEET.md "
        "\"Network transport\")",
    )
    srv.add_argument(
        "--fleet-workers", metavar="HOST:PORT,...",
        help="serve through externally started workers (`python -m "
        "distributed_ghs_implementation_tpu_torch.fleet.worker --listen PORT`, "
        "on this machine or others) instead of spawning local processes; "
        "implies --fleet-transport tcp, worker count = the list length",
    )
    srv.add_argument(
        "--fleet-forward-cache", choices=("auto", "on", "off"),
        default="auto",
        help="cross-host cache-miss forwarding: probe the digest-owner "
        "worker with a cached_only frame before solving locally "
        "(fleet.forward.hit/miss). auto = on for TCP fleets without a "
        "shared --disk-cache, off elsewhere",
    )
    srv.add_argument(
        "--fleet-elastic", metavar="MIN:MAX",
        help="with --fleet: drive the worker pool between MIN and MAX via "
        "the obs-driven autoscaler (fleet/autoscaler.py) — scale-up on a "
        "per-class wait-budget breach or queue-depth watermark, joins "
        "warm-gated on the worker's 'warmed' hello; scale-down on "
        "sustained idle by draining the lowest-affinity worker "
        "(docs/FLEET.md \"Elasticity\")",
    )
    srv.add_argument(
        "--fleet-scale-budget", type=float, default=0.25, metavar="SECONDS",
        help="with --fleet-elastic: default per-class request-latency "
        "budget whose tick-window p99 breach triggers scale-up",
    )
    srv.add_argument(
        "--fleet-scale-budgets", metavar="CLS=S,...",
        help="with --fleet-elastic: per-class budget overrides, e.g. "
        "interactive=0.05,bulk=2",
    )
    srv.add_argument(
        "--fleet-scale-cooldown", type=float, default=2.0, metavar="SECONDS",
        help="with --fleet-elastic: minimum seconds between scale events "
        "(hysteresis; scale steps are always by one worker)",
    )
    srv.add_argument(
        "--fleet-journal", default=None, metavar="DIR",
        help="with --fleet: durable accepted-work journal directory "
        "(fleet/journal.py) — every accept is fsynced before dispatch, "
        "and a restarted router on the same DIR re-adopts live --listen "
        "workers warm, rebuilds pins/affinity, and re-queues orphaned "
        "accepts (docs/FLEET.md 'Router survivability')",
    )
    srv.add_argument(
        "--fleet-lease", type=float, default=None, metavar="SECONDS",
        help="with --fleet: worker silence window before a connected but "
        "unresponsive worker is declared dead (default: heartbeat "
        "interval x miss threshold = 5s); tune UP on congested WANs, "
        "DOWN for faster failover on a quiet LAN",
    )
    srv.add_argument(
        "--tune-record", default=None, metavar="PATH",
        help="install this ghs-tuning-v1 record (written by `tune`) so "
        "each bucket's solver uses its measured launch config; stale or "
        "missing records install nothing. Fleet mode shares the path "
        "with every worker, like the persistent build cache",
    )
    _device_arg(srv)
    srv.set_defaults(fn=_cmd_serve)

    tn = sub.add_parser(
        "tune",
        help="offline launch-config tuner: measure per-bucket K1 form and "
        "K3 tile winners into a machine-fingerprinted record for `serve "
        "--tune-record` (tune/)",
    )
    tn.add_argument(
        "--buckets",
        help="tune these workload shapes: comma-separated NODESxEDGES "
        "(bucketed exactly like requests) or 'auto' for the default "
        "warmup ladder",
    )
    tn.add_argument(
        "--lanes", type=int, default=0,
        help="also tune the batched lane solver at this lane count "
        "(matches serve --batch-lanes; 0 = single-graph buckets only)",
    )
    tn.add_argument(
        "--mode", choices=("fused", "vmap"), default="fused",
        help="lane execution mode the lane buckets tune (with --lanes)",
    )
    tn.add_argument(
        "--warmup-record", metavar="PATH",
        help="seed the bucket list from a serve --warmup-record file: "
        "tune exactly the buckets real traffic compiled",
    )
    tn.add_argument(
        "--mesh-buckets",
        help="also tune the sharded lane's kernels for these RAW "
        "NODESxEDGES oversize workloads (per-device proxy measurement)",
    )
    tn.add_argument(
        "--repeats", type=int, default=5,
        help="timed calls per candidate after the warm call (median wins)",
    )
    tn.add_argument(
        "--dry", action="store_true",
        help="skip all timing and pin the default launch config on any "
        "device: the deterministic mode (two runs are byte-identical)",
    )
    tn.add_argument(
        "--out", metavar="PATH",
        help="record path (default: the fingerprinted path under "
        "$GHS_TUNE_DIR or ~/.cache/ghs-tune)",
    )
    _device_arg(tn)
    tn.set_defaults(fn=_cmd_tune)

    b = sub.add_parser(
        "bench",
        help="the benchmark (the port's bench.py): MST edges/s on RMAT, "
        "or a serving workload",
    )
    b.add_argument("--scale", type=int, default=22)
    b.add_argument("--edge-factor", type=int, default=16)
    b.add_argument("--repeats", type=int, default=3)
    b.add_argument("--backend", default="device", choices=["device", "sharded"])
    b.add_argument("--no-verify", action="store_true")
    b.add_argument("--metrics-out",
                   help="write bench-gate metrics JSON here (tools/bench_gate.py)")
    b.add_argument(
        "--batch-lanes", type=int, default=0,
        help="instead of the RMAT bench, measure batched small-graph "
        "throughput (graphs/sec) at this lane count vs the sequential "
        "miss path (bench.py --batch-lanes)",
    )
    b.add_argument(
        "--warmup", action="store_true",
        help="with --batch-lanes: AOT-precompile the bucket before the "
        "cold-first-query clock (bench.py --warmup)",
    )
    b.add_argument(
        "--update-stream", action="store_true",
        help="measure streaming MSF maintenance: windowed batched apply "
        "vs the sequential per-update path (bench.py --update-stream, "
        "docs/STREAMING.md)",
    )
    _device_arg(b)
    b.set_defaults(fn=_cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # The device rule, before anything runs: a subcommand that solves exits
    # non-zero without CUDA unless given --device cpu (stats --input only
    # reads a log).
    reads_a_log = args.command == "stats" and args.input
    if getattr(args, "device", None) is not None and not reads_a_log:
        from distributed_ghs_implementation_tpu_torch.device import resolve_device

        try:
            resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"{args.command}: {e}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
