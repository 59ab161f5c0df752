"""Replay the fleet's mixed request burst against workers on the card, in a
loop, optionally under ``compute-sanitizer``.

One loop sends, through a ``FleetRouter``, what the smoke's fleet phase
sends first: a deck of small graphs one by one as JSON edges, 21
``gnm_random_graph(128, 500)`` together (lane-mates batch into one stack),
then 4 RMAT-13 (ef 16) together as B-frames (one 16-lane stack of
2^17 vertices, K1's grid form). Every loop draws new seeds, so every
request is a fresh solve, never a cache hit. Each answer's forest and
weight must equal the SciPy rank oracle's.

Two topologies:

* ``--listen`` (default): one ``fleet.worker --listen`` process, optionally
  under ``compute-sanitizer --tool memcheck|racecheck`` and with
  ``CUDA_LAUNCH_BLOCKING=1``, dialed by a TCP router
  (``FleetConfig.remote_workers``);
* ``--pipe-workers N``: a pipe fleet of N spawned workers, as the smoke
  starts it; ``--restart-every K`` starts a fresh fleet every K loops, so
  that more loops run in workers that build their bucket solvers while
  requests arrive.

It writes one JSON record (every loop's verdict and seconds, the
sanitizer's summary line and exit code, the workers' exit codes, the card)
to ``--out`` and exits 1 if any loop failed or the sanitizer reported an
error.

    python3 -m distributed_ghs_implementation_tpu_torch.fleet_drill --loops 30 \\
        --sanitizer memcheck --launch-blocking --out build/drill.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: Each worker's request threads and batch lanes, as the smoke's fleet has them.
THREADS = 16
LANES = 16
REQUEST_TIMEOUT_S = 900.0


def _graphs(loop: int):
    """The deck, 21 small graphs and 4 RMAT-13 of one loop (loop 0 takes
    the smoke's seeds)."""
    from distributed_ghs_implementation_tpu_torch.graphs import generators as gen

    deck = {
        "readme": gen.readme_sample_graph(),
        "er48": gen.erdos_renyi_graph(48, 0.2, seed=11 + loop),
        "rmat12": gen.rmat_graph(12, 8, seed=11 + loop),
        "road40": gen.random_road_network(40, 40, seed=3 + loop),
        "grid40": gen.road_grid_graph(40, 40, seed=1 + loop),
    }
    small = [gen.gnm_random_graph(128, 500, seed=21 * loop + s) for s in range(1, 22)]
    rmat13 = [gen.rmat_graph(13, 16, seed=4 * loop + s) for s in range(1, 5)]
    return deck, small, rmat13


def _start_listen_worker(args, scratch: Path):
    """Start one ``--listen`` worker (under the sanitizer if asked); returns
    ``(process, "host:port", sanitizer log path or None)``."""
    argv = [sys.executable, "-m", "distributed_ghs_implementation_tpu_torch.fleet.worker",
            "--worker-id", "0", "--listen", "127.0.0.1:0", "--batch-lanes", str(LANES),
            "--threads", str(THREADS), "--compile-cache-dir", str(ROOT / "build"),
            "--disk-cache", str(scratch / "store"), "--device", args.device]
    log = None
    if args.sanitizer != "none":
        log = scratch / f"sanitizer-{args.sanitizer}.log"
        argv = ["compute-sanitizer", "--tool", args.sanitizer, "--error-exitcode", "86",
                "--log-file", str(log), "--print-limit", "50", *argv]
    env = dict(os.environ)
    if args.launch_blocking:
        env["CUDA_LAUNCH_BLOCKING"] = "1"
    proc = subprocess.Popen(argv, stdin=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))
    addr, seen = None, []
    deadline = time.monotonic() + args.start_timeout
    while addr is None:
        line = proc.stderr.readline()
        if not line:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"worker did not listen (rc {proc.poll()}): {''.join(seen)}")
            continue
        seen.append(line)
        found = re.search(r"listening on ([\d.]+):(\d+)", line)
        if found:
            addr = f"127.0.0.1:{found.group(2)}"
    # Keep draining the worker's stderr so that it never blocks on a full pipe.
    tail = []

    def pump():
        for line in proc.stderr:
            tail.append(line)
            del tail[:-200]

    threading.Thread(target=pump, daemon=True).start()
    proc.stderr_tail = tail
    return proc, addr, log


def _router(args, scratch: Path, addr: str | None):
    from distributed_ghs_implementation_tpu_torch.fleet.router import FleetConfig, FleetRouter

    common = dict(batch_lanes=LANES, worker_threads=THREADS, heartbeat_interval_s=0.25,
                  ready_timeout_s=args.start_timeout, request_timeout_s=REQUEST_TIMEOUT_S)
    if addr is not None:
        # A sanitized worker answers slowly: a generous lease, so that the
        # router never declares it dead mid-loop.
        config = FleetConfig(transport="tcp", remote_workers=(addr,), lease_s=600.0, **common)
    else:
        config = FleetConfig(workers=args.pipe_workers, device=args.device,
                             compile_cache_dir=str(ROOT / "build"),
                             disk_dir=str(scratch / "store"), **common)
    router = FleetRouter(config)
    router.start()
    return router


def _one_loop(router, loop: int) -> dict:
    from distributed_ghs_implementation_tpu_torch.fleet import framing
    from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids

    deck, small, rmat13 = _graphs(loop)

    def json_req(g):
        return {"op": "solve", "num_nodes": g.num_nodes, "edges_out": True,
                "edges": [[int(a), int(b), int(c)] for a, b, c in zip(g.u, g.v, g.w)]}

    def wire_req(g):
        return {"op": "solve", **g.to_wire(), "edges_out": True}

    def check(what, resp, g):
        resp = framing.fold_sections(resp)
        if not resp.get("ok"):
            raise AssertionError(f"{what}: {resp.get('error', resp)}")
        ids = rank_oracle_edge_ids(g)
        got = np.asarray(resp["mst_edges"], dtype=np.int64).reshape(-1, 2)
        want = np.stack([g.u[ids], g.v[ids]], axis=1)
        if not np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0)):
            raise AssertionError(f"{what}: forest differs from the rank oracle")
        if resp["total_weight"] != int(g.w[ids].sum()):
            raise AssertionError(f"{what}: weight {resp['total_weight']}")

    def together(reqs):
        got = [None] * len(reqs)

        def one(i):
            got[i] = router.handle(reqs[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return got

    t = {}
    t0 = time.perf_counter()
    for name, g in deck.items():
        check(f"deck {name}", router.handle(json_req(g)), g)
    t["deck_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (g, resp) in enumerate(zip(small, together([json_req(g) for g in small]))):
        check(f"small128[{i}]", resp, g)
    t["small_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (g, resp) in enumerate(zip(rmat13, together([wire_req(g) for g in rmat13]))):
        check(f"rmat13 B-frame [{i}]", resp, g)
    t["rmat13_s"] = time.perf_counter() - t0
    return t


def _sanitizer_summary(log: Path | None):
    if log is None or not log.is_file():
        return None, []
    text = log.read_text(errors="replace")
    summary = re.findall(r"ERROR SUMMARY: .*", text)
    errors = [line for line in text.splitlines() if "Invalid" in line or "Race" in line
              or "error" in line.lower()][:40]
    return (summary[-1] if summary else None), errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--loops", type=int, default=30)
    p.add_argument("--max-seconds", type=float, default=600.0,
                   help="start no loop after this many seconds")
    p.add_argument("--sanitizer", choices=("none", "memcheck", "racecheck"), default="none")
    p.add_argument("--launch-blocking", action="store_true",
                   help="CUDA_LAUNCH_BLOCKING=1 in the worker")
    p.add_argument("--pipe-workers", type=int, default=0,
                   help="a pipe fleet of this many workers instead of one --listen worker")
    p.add_argument("--restart-every", type=int, default=0,
                   help="with --pipe-workers: a fresh fleet every this many loops")
    p.add_argument("--device", default="cuda")
    p.add_argument("--start-timeout", type=float, default=600.0)
    p.add_argument("--out", default=None, help="write the JSON record here")
    args = p.parse_args(argv)

    from distributed_ghs_implementation_tpu_torch.device import card_description

    record = {"args": vars(args), "card": None, "loops": [], "workers": []}
    if args.device != "cpu":
        record["card"] = card_description()
    scratch = Path(tempfile.mkdtemp(prefix="fleet-drill-", dir=str(ROOT / "build")
                                    if (ROOT / "build").is_dir() else None))
    begin = time.perf_counter()
    failed = False
    loop = 0
    try:
        while loop < args.loops and not failed:
            proc = log = router = None
            t0 = time.perf_counter()
            try:
                if args.pipe_workers:
                    router = _router(args, scratch, None)
                else:
                    proc, addr, log = _start_listen_worker(args, scratch)
                    router = _router(args, scratch, addr)
                start_s = time.perf_counter() - t0
                batch = args.restart_every if args.pipe_workers and args.restart_every else (
                    args.loops)
                for _ in range(batch):
                    if loop >= args.loops or time.perf_counter() - begin > args.max_seconds:
                        break
                    t0 = time.perf_counter()
                    entry = {"loop": loop}
                    try:
                        entry.update(_one_loop(router, loop))
                        entry["verdict"] = "ok"
                    except Exception as e:  # noqa: BLE001 -- recorded, then the run fails
                        entry["verdict"] = f"{type(e).__name__}: {e}"[:2000]
                        failed = True
                    entry["seconds"] = time.perf_counter() - t0
                    record["loops"].append(entry)
                    print(json.dumps(entry), flush=True)
                    loop += 1
                    if failed:
                        break
            finally:
                if router is not None:
                    router.shutdown(timeout_s=args.start_timeout)
                if proc is not None:
                    try:
                        rc = proc.wait(timeout=args.start_timeout)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        rc = proc.wait()
            worker = {"start_s": start_s}
            if proc is not None:
                worker["rc"] = rc
                worker["sanitizer_summary"], worker["sanitizer_lines"] = _sanitizer_summary(log)
                worker["stderr_tail"] = proc.stderr_tail[-20:]
                if worker["rc"] != 0:
                    failed = True
            record["workers"].append(worker)
            if time.perf_counter() - begin > args.max_seconds:
                break
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    record["seconds"] = time.perf_counter() - begin
    record["ok"] = not failed and bool(record["loops"])
    blob = json.dumps(record, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(blob + "\n")
    print(json.dumps({k: record[k] for k in ("ok", "seconds", "card")}
                     | {"loops": len(record["loops"]), "workers": [
                         {k: w.get(k) for k in ("rc", "start_s", "sanitizer_summary")}
                         for w in record["workers"]]}))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
