"""Run the load drill (``load_drill.py``) many times and collect its reports.

Three sets, each a list of ``python -m ...load_drill`` runs, one process a
run (as a user runs the drill), on ``--device``:

* ``--ci``: every mode of the drill once, with the flags of the JAX
  package's CI (service, chaos, corrupt store, kinds, fleet kill on
  workers that solve, the echo TCP fleets: kill, traced, router kill,
  partition, mixed-build and killed binary wire, the elastic ramp and
  elastic kill, the stream drill and stream kill, oversize-heavy on the
  sharded lane, and the sharded stream kill);
* ``--rates 10,40,160``: the service mode (``--smoke``) at each
  ``--rate``;
* ``--loops N``: the service mode and ``--fleet 2 --kill-worker 1`` N times
  each, with seeds ``23 + i``.

Each report is kept as ``<out>/<name>.json``; ``<out>/summary.json`` holds,
for every run: its argv, exit code and wall seconds, the report's ``ok``,
workload, failed checks, ``lost_accepted``, the window's ``compile.*``
counters, per class p50/p95/p99 and goodput, and any line of the run's
stderr that names a CUDA error. The card's name and power limit head the
summary. Exit code 0 iff every run exited 0.

    python3 -m distributed_ghs_implementation_tpu_torch.drill_matrix --ci \\
        --rates 10,40,160 --out chiprun_out/drills
    python3 -m distributed_ghs_implementation_tpu_torch.drill_matrix --loops 20 \\
        --out chiprun_out/loops
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from distributed_ghs_implementation_tpu_torch.device import card_description, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--smoke", "--no-chaos"]
ECHO_TCP = ["--transport", "tcp", "--test-echo"]

#: (name, argv) of every drill mode the JAX package's CI runs; ``{out}`` is
#: the output directory (obs exports, traces, event logs).
CI_MODES = (
    ("load", SMOKE),
    ("load_chaos", ["--smoke", "--chaos"]),
    ("corrupt", ["--corrupt-store", "3", "--payload-chaos", "2"]),
    ("kinds", ["--kinds-mixed"]),
    ("fleet_kill", SMOKE + ["--fleet", "3", "--kill-worker", "1", "--obs-dir", "{out}/fleet_obs"]),
    ("fleet_tcp_kill", SMOKE + ["--fleet", "3", "--kill-worker", "1", *ECHO_TCP,
                                "--obs-dir", "{out}/fleet_tcp_obs"]),
    ("traced_fleet", SMOKE + ["--fleet", "3", *ECHO_TCP, "--trace-dir", "{out}/trace"]),
    ("router_kill", SMOKE + ["--fleet", "3", "--kill-router", *ECHO_TCP]),
    ("partition", SMOKE + ["--fleet", "3", "--partition", "1", *ECHO_TCP,
                           "--jsonl", "{out}/partition_events.jsonl"]),
    ("wire_mixed", SMOKE + ["--fleet", "3", *ECHO_TCP, "--wire", "binary",
                            "--wire-legacy-worker", "0"]),
    ("wire_kill", SMOKE + ["--fleet", "3", "--kill-worker", "1", *ECHO_TCP, "--wire", "binary"]),
    ("elastic", SMOKE + ["--update-heavy", "--ramp", "--fleet", "2", "--elastic",
                         "--obs-dir", "{out}/elastic_obs"]),
    ("elastic_kill", SMOKE + ["--ramp", "--fleet", "2", "--elastic", "--test-echo",
                              "--kill-worker", "1", "--obs-dir", "{out}/elastic_kill_obs"]),
    ("stream", SMOKE + ["--update-heavy"]),
    ("stream_kill", SMOKE + ["--update-heavy", "--fleet", "2", "--kill-worker", "1",
                             "--obs-dir", "{out}/stream_obs"]),
    ("oversize", SMOKE + ["--oversize-heavy", "--sharded-lane"]),
    ("stream_sharded_kill", SMOKE + ["--update-heavy", "--sharded-lane", "--streams", "2",
                                     "--fleet", "2", "--kill-worker", "1",
                                     "--obs-dir", "{out}/stream_sharded_obs"]),
)
LOOP_MODES = (("service", ["--smoke"]),
              ("fleet2_kill1", SMOKE + ["--fleet", "2", "--kill-worker", "1"]))
RUN_TIMEOUT_S = 600  # the longest run took 79 s on an H100 (--rate 2560)
CUDA_WORDS = ("illegal memory access", "CUDA error", "cudaError", "device-side assert")


def _summary(name, argv, rc, wall_s, path, stderr) -> dict:
    rec = {"name": name, "argv": argv, "rc": rc, "wall_s": wall_s,
           "cuda_errors": [line for line in stderr.splitlines()
                           if any(w in line for w in CUDA_WORDS)][:20]}
    if not os.path.isfile(path):
        rec["stderr_tail"] = stderr[-3000:]
        return rec
    with open(path) as f:
        report = json.load(f)
    metrics = report.get("gate_metrics", {}).get("metrics", {})
    rec.update(
        ok=report["ok"], workload=report["config"]["workload"],
        failed=[c["name"] for c in report["checks"] if not c["ok"]],
        lost_accepted=metrics.get("lost_accepted", report.get("chaos", {}).get("lost_accepted")),
        compile=report.get("compile_counters"), drill_wall_s=report["wall_s"],
        classes={cls: {"sent": c["sent"], "goodput_per_sec": c["goodput_per_sec"],
                       **{p: c["latency_s"].get(p) for p in ("p50", "p95", "p99")}}
                 for cls, c in report["slo"]["classes"].items()})
    if not report["ok"]:
        rec["stderr_tail"] = stderr[-3000:]
    return rec


def run_one(name, argv, out, device) -> dict:
    """One drill run in a process of its own; its summary record."""
    argv = [a.replace("{out}", out) for a in argv]
    path = os.path.join(out, f"{name}.json")
    cmd = [sys.executable, "-m", "distributed_ghs_implementation_tpu_torch.load_drill", *argv,
           "--device", device, "--output", path]
    t = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
        rc, stderr = proc.returncode, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, stderr = "timeout", e.stderr or ""
        if isinstance(stderr, bytes):
            stderr = stderr.decode(errors="replace")
    rec = _summary(name, argv, rc, time.perf_counter() - t, path, stderr)
    classes = rec.get("classes") or {}
    print(f"{name}: rc {rc}, {rec['wall_s']:.1f} s, ok {rec.get('ok')}, lost "
          f"{rec.get('lost_accepted')}, failed {rec.get('failed')}, p99 s "
          + json.dumps({c: v["p99"] for c, v in classes.items()}), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ci", action="store_true", help="every drill mode of the CI list once")
    p.add_argument("--rates", default="", help="comma-separated --rate values, service mode")
    p.add_argument("--loops", type=int, default=0,
                   help="runs of each loop mode (service, fleet 2 kill 1)")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "drills"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    if args.ci:
        runs += list(CI_MODES)
    runs += [(f"rate{r}", ["--smoke", "--rate", r]) for r in args.rates.split(",") if r]
    for i in range(args.loops):
        runs += [(f"{name}_loop{i}", a + ["--seed", str(23 + i)]) for name, a in LOOP_MODES]
    card = card_description() if device.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    records = [run_one(name, a, args.out, args.device) for name, a in runs]
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"card": card, "runs": records}, f, indent=1)
        f.write("\n")
    bad = [r["name"] for r in records if r["rc"] != 0]
    print(f"drill matrix: {len(records)} runs, {len(bad)} not 0: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
