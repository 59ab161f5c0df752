"""The seeded offline search: score candidates, pick measured winners.

The port's counterpart of the JAX package's ``tune/measure.py``. Per bucket
the search enumerates the valid candidates (``tune/space.py``) and, for
each, prepares a fresh solver under that candidate's launch config,
bypassing the lane solver cache (``batch/lanes.py``: its entries read the
installed table, and the search must neither read nor fill it). Each bucket
is solved on a seeded workload: the JAX package's ``_bucket_graph`` at
``SEED``, or a graph the caller names for it (``workloads``).

* **Parity before trust**: every candidate's forest mask, fragments and
  levels are compared element for element with the default config's
  (the first candidate) before its time may count. A mismatch scores it
  dead (``tune.search.rejected``).
* **Failure carve-out**: any exception while preparing or running a
  candidate (a launch the card refuses, say) scores that candidate dead and
  the search goes on. Nothing falls back; the default config is the
  reference, and if it fails the bucket has no survivor.
* **Timing**: one warm call (the parity run), then ``repeats`` rounds in
  which every surviving candidate runs once between two CUDA events, in
  turns (A B C, C B A, ...), so that a drift of the card's clock over the
  search weighs on every candidate alike; the least median wins. Every
  candidate's median and spread (max - min) stay in the entry's
  ``timings``. (The JAX package times its candidates one after another.)
* **Pins**: on the CPU the candidates all run the kernels' plain versions,
  which are no throughput path: nothing is timed, the default config wins
  (``source: "cpu-pin"``) and one other candidate is run for parity. With
  ``dry=True`` the same holds on the card (``"dry-pin"``), so two dry runs
  give byte-identical records.

``ell`` buckets run the ELL solve (K3 at the candidate's tile, K1 in its
form); lane buckets (``fused``, ``vmap``) the lane stack with two filled
lanes, as in the JAX package; a single-graph bucket (lanes 0) and a mesh
bucket the flat solve at the bucket's shapes (the mesh's per-device proxy).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.batch import lanes as lanes_mod
from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.generators import gnm_random_graph
from distributed_ghs_implementation_tpu_torch.models import boruvka
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.tune import record as record_mod
from distributed_ghs_implementation_tpu_torch.tune import space as space_mod

#: The repo-wide bench seed, as in the JAX package: the search is a
#: benchmark too.
SEED = 24

Bucket = record_mod.Bucket


def normalize_buckets(buckets: Iterable[Sequence]) -> List[Bucket]:
    """Dedupe and canonicalize a bucket list (sorted, ints, validated)."""
    seen = set()
    for b in buckets:
        n, m, lanes, mode = b
        key = (int(n), int(m), max(0, int(lanes)), str(mode))
        if key[3] not in space_mod.VALID_MODES:
            raise ValueError(f"unknown bucket mode {key[3]!r} in tune bucket {b!r}")
        seen.add(key)
    return sorted(seen)


def mesh_bucket(num_nodes: int, num_edges: int, n_dev: int) -> Bucket:
    """The mesh-lane bucket a raw oversize workload stages at on an
    ``n_dev``-device mesh: bucket sizes, the rank width rounded up to the
    ``8 * n_dev`` alignment unit, as in the JAX package."""
    n_dev = max(1, int(n_dev))
    n_pad = boruvka._bucket_size(max(1, num_nodes))
    unit = 8 * n_dev
    m_pad = int(math.ceil(boruvka._bucket_size(max(1, num_edges)) / unit) * unit)
    return (n_pad, m_pad, n_dev, "mesh")


def _bucket_seed(seed: int, n_pad: int, m_pad: int) -> int:
    return (seed ^ (n_pad * 1_000_003 + m_pad)) & 0x7FFFFFFF


def _bucket_graph(n_pad: int, m_pad: int, seed: int):
    """A seeded workload graph that pads into exactly this bucket, or
    ``None`` when no simple graph can (such buckets carry no traffic)."""
    n = max(2, n_pad)
    m = min(m_pad, n * (n - 1) // 2)
    if lanes_mod.bucket_of(n, m) != (n_pad, m_pad):
        return None
    return gnm_random_graph(n, m, seed=_bucket_seed(seed, n_pad, m_pad), ensure_connected=False)


def _tensors(arrays, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _lane_runner(graph, bucket: Bucket, candidate, device):
    n_pad, m_pad, lanes, mode = bucket
    stacked = lanes_mod.stack_lanes([graph] * min(lanes, 2), lanes=lanes, mode=mode)
    arrays = _tensors(stacked.arrays, device)
    solver = lanes_mod._compile_bucket(n_pad, m_pad, lanes, mode, device,
                                       hook_form=candidate.config.hook_form)
    return lambda: solver(*arrays)


def _ell_runner(graph, bucket: Bucket, candidate, device):
    buckets, ra, rb, n_pad = boruvka.prepare_ell_arrays(graph, device=device)
    config = candidate.config
    return lambda: boruvka.ell_solve_loop(buckets, ra, rb, num_nodes=n_pad,
                                          tile_slots=config.tile_slots,
                                          hook_form=config.hook_form)


def _single_runner(graph, bucket: Bucket, candidate, device):
    n_pad, m_pad = bucket[:2]
    arrays = _tensors(graph.rank_arrays(pad_edges_to=2 * m_pad, pad_ranks_to=m_pad), device)
    form = candidate.config.hook_form
    return lambda: boruvka._solve_from_iota(*arrays, num_nodes=n_pad, hook_form=form)


def _make_runner(bucket: Bucket, candidate, graph, device):
    """A zero-argument solve of ``graph`` at ``bucket`` under ``candidate``:
    returns ``(mst_ranks, fragment, levels)`` as the solver leaves them."""
    mode, lanes = bucket[3], bucket[2]
    if mode in ("fused", "vmap") and lanes >= 1:
        return _lane_runner(graph, bucket, candidate, device)
    if mode == "ell":
        return _ell_runner(graph, bucket, candidate, device)
    return _single_runner(graph, bucket, candidate, device)


def _host(out) -> tuple:
    """A solve's outputs as host arrays, for the parity comparison."""
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in out)


def _outputs_equal(a, b) -> bool:
    if a is None or b is None or len(a) != len(b):
        return False
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _time_ms(run) -> float:
    """One call of ``run`` between two CUDA events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _pin(device, dry: bool) -> Tuple[bool, Optional[str]]:
    """``(pinned, source)``: the CPU always pins (``"cpu-pin"``), the card
    only for a dry search (``"dry-pin"``)."""
    if device.type != "cuda":
        return True, "cpu-pin"
    return (True, "dry-pin") if dry else (False, None)


def search(
    buckets: Iterable[Sequence],
    *,
    repeats: int = 5,
    warm: int = 1,
    seed: int = SEED,
    dry: bool = False,
    device=None,
    workloads: Optional[Mapping[Sequence, object]] = None,
) -> dict:
    """Search ``buckets`` on ``device`` (``None`` = CUDA); returns a
    ``ghs-tuning-v1`` record dict (``tune/record.py`` saves and installs
    it). ``workloads`` maps a bucket to the graph to measure there in place
    of the seeded one; the graph must pad into that bucket."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    device = resolve_device(device)
    bucket_list = normalize_buckets(buckets)
    chosen = {tuple(normalize_buckets([b])[0]): g for b, g in (workloads or {}).items()}
    for bucket, graph in chosen.items():
        if lanes_mod.bucket_key(graph) != bucket[:2]:
            raise ValueError(
                f"workload for bucket {bucket} pads into {lanes_mod.bucket_key(graph)}"
            )
    pinned, pin_source = _pin(device, dry)
    entries: Dict[Bucket, dict] = {}
    with BUS.span("tune.search", cat="tune", buckets=len(bucket_list), dry=dry, pinned=pinned):
        for bucket in bucket_list:
            graph = chosen[bucket] if bucket in chosen else _bucket_graph(*bucket[:2], seed)
            entries[bucket] = _search_bucket(
                bucket, graph, repeats=repeats, warm=warm, pinned=pinned,
                pin_source=pin_source, device=device,
            )
    return record_mod.new_record(entries, pinned=pinned, device=device)


def _search_bucket(bucket: Bucket, graph, *, repeats: int, warm: int, pinned: bool,
                   pin_source: Optional[str], device) -> dict:
    n_pad, m_pad, lanes, mode = bucket
    label = boruvka.kernel_label(device)
    candidates = space_mod.enumerate_candidates(n_pad, m_pad, lanes, mode, kernel=label)
    key = record_mod.bucket_key_str(bucket)
    rejected = space_mod.raw_space_size(mode) - len(candidates)
    for c in candidates:
        BUS.count("tune.search.candidate")
        BUS.instant("tune.search.candidate_detail", cat="tune", bucket=key, candidate=c.label())
    default = candidates[0]
    if graph is None:
        # No simple graph pads into this bucket: nothing to measure, the
        # bucket keeps the default launches.
        rejected += len(candidates) - 1
        BUS.count("tune.search.rejected", len(candidates) - 1)
        return {"kernel": label, "source": "unreachable", "config": default.config.to_json(),
                "candidates": len(candidates), "rejected": rejected, "parity": "skipped"}

    reference = None  # the default config's outputs: the parity oracle
    runs: Dict[int, object] = {}  # candidate index -> its solve, parity passed
    parity = "skipped"
    dead = 0

    def kill(idx: int, ex: Exception) -> None:
        nonlocal dead
        dead += 1
        BUS.count("tune.search.rejected")
        BUS.instant("tune.search.candidate_failed", cat="tune", bucket=key,
                    candidate=candidates[idx].label(), error=f"{type(ex).__name__}: {ex}")

    for idx, cand in enumerate(candidates):
        # Pinned, only the default and one other candidate (the first) run:
        # the second exercises the parity gate, nothing is ranked.
        if pinned and idx > 1:
            continue
        try:
            run = _make_runner(bucket, cand, graph, device)
            out = _host(run())
            if idx == 0:
                reference = out
            else:
                ok = _outputs_equal(reference, out)
                if parity != "failed":  # a parity failure is sticky
                    parity = "ok" if ok else "failed"
                if not ok:
                    dead += 1
                    BUS.count("tune.search.rejected")
                    BUS.instant("tune.search.parity_failed", cat="tune", bucket=key,
                                candidate=cand.label())
                    continue
            if not pinned:
                runs[idx] = run
        except Exception as ex:  # noqa: BLE001 -- scored dead, the search goes on
            kill(idx, ex)
            if idx == 0:
                break  # no reference: nothing else can pass parity

    # The survivors in turns: ``warm - 1`` more warm rounds (the parity run
    # was the first), then ``repeats`` timed rounds, alternating the order.
    times: Dict[int, List[float]] = {idx: [] for idx in runs}
    for rnd in range(max(0, warm - 1) + repeats):
        timed = rnd >= warm - 1
        order = sorted(runs) if rnd % 2 == 0 else sorted(runs, reverse=True)
        for idx in order:
            try:
                if timed:
                    times[idx].append(_time_ms(runs[idx]))
                else:
                    runs[idx]()
            except Exception as ex:  # noqa: BLE001 -- scored dead, the search goes on
                kill(idx, ex)
                del runs[idx], times[idx]
    scores: List[Tuple[float, int]] = []  # (median ms, candidate index)
    timings: Dict[str, dict] = {}
    for idx, ts in sorted(times.items()):
        median = float(np.median(ts))
        timings[candidates[idx].label()] = {"median_ms": round(median, 6),
                                            "spread_ms": round(max(ts) - min(ts), 6)}
        scores.append((median, idx))

    rejected += dead
    entry = {"candidates": len(candidates), "rejected": rejected, "parity": parity}
    if pinned or not scores:
        return {"kernel": label, "source": pin_source if pinned else "no-survivors",
                "config": default.config.to_json(), **entry}
    scores.sort()
    best_ms, best_idx = scores[0]
    entry.update(kernel=label, source="measured",
                 config=candidates[best_idx].config.to_json(),
                 median_s=round(best_ms / 1e3, 6), timings=timings)
    if len(scores) > 1:
        entry["runner_up_s"] = round(scores[1][0] / 1e3, 6)
    return entry
