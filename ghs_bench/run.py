"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 ghs_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m ghs_bench.run`` from the checkout's root works the same.)

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, with the device's busy time, the
traced window and a breakdown. The last line on standard output is the
result; the numbers compared for ``correct`` follow it, each beside its
limit, as the last lines on standard error. Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, when the
system under test cannot be imported, or when the process holds JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == _HERE:
    sys.path.pop(0)  # run as a script: the folder itself must not shadow modules
sys.path.insert(0, os.path.dirname(_HERE))

from ghs_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available():
        harness.log("CUDA is not available: no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible: no result")
        return 2
    harness.log(f"card: {harness.power_limit()}")
    line, checks = harness.run_cell(spec, args.workload, seed=args.seed,
                                    seconds=args.seconds, trace=bool(args.trace),
                                    device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the process holds {', '.join(found)} after the window: no result")
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
