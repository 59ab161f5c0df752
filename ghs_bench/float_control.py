"""The control of the float cell's comparison: the plain reference put in
the system's place with the configuration's guarantee broken, judged by
the same comparison as a run, at the cell's own size. Its readings must make
``correct`` false; the benchmark's runs never call it.

    python3 ghs_bench/float_control.py --workload rmat24-float --seeds 11,12,13

``graph500-rmat24-float``: the reference on the weights rounded to float32
(``w.float().double()``) in the system's place, for each graph of a seed's
pool, made as the cell's driver makes it: its forest against the exact
forest (``forest_mismatch``), its rank order against the exact order
(``order_mismatch``), summed over the pool as a run sums them and judged by
the driver's own checks (``float_fresh.float_checks``), under the
harness's rule (correct where each value is at most its limit). Prints one
JSON line a seed, with each graph's readings, the checks and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))

from ghs_bench import harness, reference, reference_float  # noqa: E402
from ghs_bench.drivers.float_fresh import (  # noqa: E402
    float_checks,
    float_kronecker,
    order_mismatch,
)


def float_control(cell, seed: int, device, *, stream: int = 0) -> dict:
    """The control's reading on the pool graph ``stream`` of ``seed``."""
    cfg = cell.config
    n, u, v, w, generated = float_kronecker(cfg, seed=seed, stream=stream,
                                            scale=int(cfg["generator"]["scale"]), device=device)
    exact = reference_float.msf_ids(n, u, v, w, device=device)
    rounded = reference_float.msf_ids(n, u, v, w, device=device, float32=True)
    orders = order_mismatch(reference_float.rank_order(w, device=device, float32=True),
                            reference_float.rank_order(w, device=device))
    return {"edges": int(u.numel()), "generated": generated, "forest_edges": int(exact.size),
            "forest_mismatch": reference.mismatch(rounded, exact), "order_mismatch": orders}


def judged(cell, graphs: list) -> dict:
    """The control's readings over a pool, judged as a run is: its checks
    ``{name: [value, limit]}`` and ``correct``."""
    checks = float_checks(cell.config, sum(g["forest_mismatch"] for g in graphs),
                          sum(g["order_mismatch"] for g in graphs))
    return {"checks": {k: list(c) for k, c in checks.items()},
            "correct": all(value <= limit for value, limit in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        graphs = [float_control(cell, seed, args.device, stream=k)
                  for k in range(int(cell.mix["pool"]))]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": graphs,
                          **judged(cell, graphs), "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
