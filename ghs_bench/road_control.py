"""The control of the road cells' comparison: the plain reference put in
the system's place with the configuration's guarantee broken, judged by the
same comparison as a run, at the cell's own size. Its readings must lie
above every limit that ``correct`` uses; the benchmark's runs never call it.

    python3 ghs_bench/road_control.py --workload usa-road-fresh --seeds 11,12,13

``dimacs9-usa-road``: the forest of the lengths with their low 8 bits
dropped against the exact forest, one road network of the cell's size a
seed (a run sums the same number over each forest it solves). Prints one
JSON line a seed. The command line is ``control.py``'s.
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

from ghs_bench import harness, reference, roads  # noqa: E402


def road_control(cell, seed: int, device) -> dict:
    cfg = cell.config
    gen, pub = cfg["generator"], cfg["published"]
    n, u, v, w = roads.road_network(gen["rows"], gen["cols"], occupancy=gen["occupancy"],
                                    edges_per_vertex=pub["edges"] / pub["vertices"],
                                    seed=seed, device=device)
    exact = reference.msf_ids(n, u, v, w, device=device)
    cut = reference.msf_ids(n, u, v, w, device=device,
                            drop_weight_bits=cfg["control"]["drop_weight_bits"])
    return {"vertices": n, "edges": int(u.numel()), "forest_edges": int(exact.size),
            "forest_mismatch": reference.mismatch(cut, exact)}


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
        reading = road_control(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": reading,
                          "limits": cell.config["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
