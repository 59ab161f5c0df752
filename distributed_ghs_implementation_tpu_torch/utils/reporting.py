"""Result reporting: JSON artifacts and console tables (the port's copy of
the JAX package's ``utils/reporting.py``, the same keys).

Schema parity with the reference's two artifacts:

* ``mst_result.json`` — per-run result matching ``mst_result_mpi.json``
  (the reference's
  ``ghs_implementation_mpi.py:810-822``): ``mst_edges``,
  ``total_weight``, ``num_nodes``, ``num_edges_in_mst``, ``expected_edges``,
  plus framework extras under stable keys.
* ``ghs_experiments.json`` — experiment-suite dump matching
  ``ghs_implementation.py:766-776,829-830``: per-experiment ``num_nodes``,
  ``num_edges``, ``ghs_weight``, ``nx_weight``, ``is_correct``,
  ``execution_time``. ``nx_weight`` keeps its name; the port's oracle is
  SciPy's rank forest (``experiments.py``).
"""

from __future__ import annotations

import json
from typing import List

from distributed_ghs_implementation_tpu_torch.api import MSTResult


def result_to_dict(result: MSTResult) -> dict:
    out = {
        "mst_edges": [[int(a), int(b)] for a, b in result.edges],
        "total_weight": result.total_weight,
        "num_nodes": result.graph.num_nodes,
        "num_edges_in_mst": result.num_edges,
        "expected_edges": result.graph.num_nodes - result.num_components,
        "num_components": result.num_components,
        "num_levels": result.num_levels,
        "backend": result.backend,
        "execution_time": result.wall_time_s,
    }
    if result.incidents is not None:
        # Persist the supervised attempt/fallback trail with the artifact —
        # a degraded run must stay diagnosable after the process exits. The
        # one-line summary rides along so serve responses (and anything else
        # embedding this dict) report degradation without parsing records.
        out["incidents"] = result.incidents.to_dicts()
        out["incident_summary"] = result.incidents.summary()
    return out


def write_result_json(result: MSTResult, path: str) -> str:
    with open(path, "w") as f:
        json.dump(result_to_dict(result), f, indent=2)
    return path


def experiment_record(
    result: MSTResult, expected_weight: float, index: int = 0
) -> dict:
    """One row of the experiment suite (``ghs_implementation.py:766-776``)."""
    return {
        "experiment": index,
        "num_nodes": result.graph.num_nodes,
        "num_edges": result.graph.num_edges,
        "ghs_weight": result.total_weight,
        "nx_weight": expected_weight,
        "is_correct": abs(float(result.total_weight) - float(expected_weight)) < 1e-6
        and result.num_edges == result.graph.num_nodes - result.num_components,
        "execution_time": result.wall_time_s,
        "num_levels": result.num_levels,
        "backend": result.backend,
    }


def write_experiments_json(records: List[dict], path: str) -> str:
    with open(path, "w") as f:
        json.dump(records, f, indent=2)
    return path


def print_summary_table(records: List[dict]) -> None:
    """PASS/FAIL table matching the reference's console summary
    (``ghs_implementation.py:820-826``)."""
    print("=" * 72)
    print(f"{'#':>3} {'nodes':>7} {'edges':>9} {'weight':>10} {'oracle':>10} "
          f"{'time(s)':>9} {'result':>7}")
    print("-" * 72)
    for r in records:
        status = "PASS" if r["is_correct"] else "FAIL"
        print(
            f"{r['experiment']:>3} {r['num_nodes']:>7} {r['num_edges']:>9} "
            f"{r['ghs_weight']:>10} {r['nx_weight']:>10} "
            f"{r['execution_time']:>9.3f} {status:>7}"
        )
    print("=" * 72)
    passed = sum(1 for r in records if r["is_correct"])
    print(f"{passed}/{len(records)} experiments passed")
