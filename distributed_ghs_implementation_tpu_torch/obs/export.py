"""Exporters for the event bus: Chrome-trace/Perfetto JSON, JSONL, stats.

Three views of the same ring buffer:

* :func:`write_chrome_trace` — the Chrome ``traceEvents`` JSON format, which
  Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` both load
  directly: spans become ``"X"`` slices that nest by time per thread track,
  counters become ``"C"`` timeline tracks.
* :func:`write_events_jsonl` — one JSON object per line (stream-appendable,
  grep-able), with a trailing ``"M"`` metadata line carrying the counter
  totals and histogram summaries so a log file is self-contained.
* :func:`render_stats` — the plain-text summary behind the ``stats``
  subcommand, computed from a live bus or a parsed JSONL file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from distributed_ghs_implementation_tpu_torch.obs.events import (
    PH_COMPLETE,
    PH_COUNTER,
    PH_INSTANT,
    EventBus,
    aggregate_span_stats,
)


def _jsonable(value: Any) -> Any:
    """Lazy serialization boundary: coerce arbitrary arg values to JSON."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:  # numpy scalars expose item()
        return value.item()
    except AttributeError:
        return repr(value)


def _tid_map(events) -> Dict[int, int]:
    """Stable small-int thread ids (raw idents are unreadable in a trace)."""
    mapping: Dict[int, int] = {}
    for rec in events:
        mapping.setdefault(rec[5], len(mapping))
    return mapping


def chrome_trace_events(bus: EventBus) -> List[dict]:
    """Bus records as Chrome ``traceEvents`` dicts (timestamps in µs)."""
    events = bus.events()
    tids = _tid_map(events)
    pid = os.getpid()
    out: List[dict] = []
    for ph, name, cat, ts_ns, dur_ns, tid, args in events:
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": ts_ns / 1000.0,
            "pid": pid,
            "tid": tids[tid],
        }
        if ph == PH_COMPLETE:
            ev["dur"] = dur_ns / 1000.0
        if ph == PH_COUNTER:
            ev["args"] = {"value": _jsonable((args or {}).get("value", 0))}
        elif args:
            ev["args"] = _jsonable(args)
        if ph == PH_INSTANT:
            ev["s"] = "t"  # thread-scoped instant marker
        out.append(ev)
    # Counter totals as a final sample each, so every counter has a track
    # even if no timeline samples were taken during the run.
    end_ts = max((e["ts"] + e.get("dur", 0.0) for e in out), default=0.0)
    for name, value in sorted(bus.counters().items()):
        out.append(
            {
                "name": name,
                "cat": "counter",
                "ph": PH_COUNTER,
                "ts": end_ts,
                "pid": pid,
                "tid": 0,
                "args": {"value": _jsonable(value)},
            }
        )
    return out


def to_chrome_trace(bus: EventBus) -> dict:
    return {
        "traceEvents": chrome_trace_events(bus),
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "distributed_ghs_implementation_tpu_torch.obs",
            "events_dropped": bus.dropped,
        },
    }


def write_chrome_trace(bus: EventBus, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(bus), f)
        f.write("\n")
    return path


def write_events_jsonl(
    bus: EventBus, path: str, *, label: Optional[str] = None
) -> str:
    """Events one-per-line, bracketed by metadata: a LEADING header line
    (ring capacity + dropped count at export time) and a TRAILING line with
    the counter/histogram totals. The header exists so a log truncated
    mid-write — the normal state of a file another process is tailing —
    still tells the reader whether the ring overflowed; a measurement that
    dropped events must be flagged, never silently under-counted.

    The header also carries merge provenance — ``pid``, a wall-clock
    ``epoch_unix_ns`` anchor for the bus's monotonic timeline, and an
    optional ``process`` label — which is what lets
    :func:`merge_trace_files` align N per-process logs onto one axis."""
    tids = _tid_map(bus.events())
    with open(path, "w") as f:
        header = {
            "ph": "M",
            "kind": "header",
            "schema": "ghs-obs-jsonl-v1",
            "capacity": bus.capacity,
            "events_dropped": bus.dropped,
            "pid": os.getpid(),
            "epoch_unix_ns": bus.epoch_unix_ns(),
        }
        if label:
            header["process"] = str(label)
        f.write(json.dumps(header, separators=(",", ":")) + "\n")
        for ph, name, cat, ts_ns, dur_ns, tid, args in bus.events():
            rec = {
                "ph": ph,
                "name": name,
                "cat": cat,
                "ts_us": ts_ns / 1000.0,
                "tid": tids[tid],
            }
            if ph == PH_COMPLETE:
                rec["dur_us"] = dur_ns / 1000.0
            if args:
                rec["args"] = _jsonable(args)
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        f.write(
            json.dumps(
                {
                    "ph": "M",
                    "counters": _jsonable(bus.counters()),
                    "histograms": _jsonable(bus.histograms()),
                    "events_dropped": bus.dropped,
                },
                separators=(",", ":"),
            )
            + "\n"
        )
    return path


def read_events_jsonl(path: str) -> Tuple[List[dict], dict]:
    """Parse a JSONL event log; returns ``(event_dicts, metadata)``.

    Tolerant of files still being written (or truncated by a crash): a
    line that fails to parse — typically the torn final line of a
    concurrent writer — is *skipped and counted* (``lines_skipped`` in the
    metadata), never raised. Metadata merges the leading header under the
    trailing totals line, so a log cut off before its trailing ``"M"``
    line still reports the header's ``events_dropped``.
    """
    events: List[dict] = []
    header: dict = {}
    meta: dict = {}
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                skipped += 1
                continue
            if rec.get("ph") == "M":
                if rec.get("kind") == "header":
                    header = rec
                else:
                    meta = rec
            else:
                events.append(rec)
    merged = {**header, **meta}
    merged.pop("kind", None)
    if skipped:
        merged["lines_skipped"] = skipped
    return events, merged


def snapshot_from_jsonl(path: str) -> dict:
    """Rebuild a :meth:`EventBus.snapshot`-shaped dict from a JSONL log."""
    events, meta = read_events_jsonl(path)
    spans, instants = aggregate_span_stats(
        (rec.get("ph"), rec.get("name"), rec.get("dur_us", 0.0) / 1e6)
        for rec in events
    )
    snap = {
        "schema": "ghs-obs-snapshot-v1",
        "spans": spans,
        "instants": instants,
        "counters": meta.get("counters", {}),
        "histograms": meta.get("histograms", {}),
        "events_retained": len(events),
        "events_dropped": meta.get("events_dropped", 0),
    }
    if meta.get("lines_skipped"):
        snap["lines_skipped"] = meta["lines_skipped"]
    return snap


# -- multi-process trace assembly ------------------------------------------

MERGE_SCHEMA = "ghs-trace-merge-v1"

#: Span names whose duration counts as "solve" in the critical path.
_SOLVE_SPAN_NAMES = (
    "serve.solve", "stream.window", "stream.replay.window",
)
_SOLVE_SPAN_PREFIXES = ("solver.", "batch.flush", "lane.solve")


def _read_merge_inputs(paths) -> List[dict]:
    """Per-file read + provenance: pid (deduplicated), display label, and
    the wall-clock offset that maps its monotonic timeline onto the
    earliest file's axis. Files without an ``epoch_unix_ns`` header
    (pre-merge exports) align at offset 0 — still loadable, just not
    cross-process-accurate."""
    files: List[dict] = []
    for path in sorted(paths):
        events, meta = read_events_jsonl(path)
        label = meta.get("process") or os.path.splitext(
            os.path.basename(path)
        )[0]
        files.append({
            "path": path,
            "events": events,
            "meta": meta,
            "label": str(label),
            "pid": meta.get("pid"),
            "epoch": meta.get("epoch_unix_ns"),
        })
    seen_pids = set()
    for i, fi in enumerate(files):
        pid = fi["pid"]
        if not isinstance(pid, int) or pid in seen_pids:
            pid = 1_000_000 + i  # synthetic, collision-free
        fi["pid"] = pid
        seen_pids.add(pid)
    epochs = [
        fi["epoch"] for fi in files
        if isinstance(fi["epoch"], (int, float))
    ]
    base = min(epochs) if epochs else 0
    for fi in files:
        epoch = fi["epoch"]
        fi["offset_us"] = (
            (epoch - base) / 1000.0
            if isinstance(epoch, (int, float)) else 0.0
        )
    return files


def merge_trace_files(paths) -> Tuple[dict, dict]:
    """Join N per-process JSONL event logs into ONE Perfetto trace.

    Returns ``(trace, report)``:

    * ``trace`` — a Chrome-trace object with one process track per input
      file (named by the header's ``process`` label), every process's
      spans aligned onto a shared wall-clock axis, and flow ("s"/"f")
      arrows stitching each cross-process parent→child span edge — the
      router's ``fleet.attempt`` visually connects to the worker's
      ``fleet.serve`` it dispatched.
    * ``report`` — ``ghs-trace-merge-v1``: per-process inventory, trace
      join accounting (``traces_joined``, ``orphan_spans``), and the
      per-trace critical-path decomposition (queue vs transport vs solve
      vs verify vs residual) for every rooted ``fleet.request``.

    **Rooted-traces rule**: orphan/join accounting only covers traces
    whose ROOT span (one with no ``parent``) is present in the merged
    set. A worker-side fragment whose router log was cleared or rotated
    away (warm-phase traffic before a drill's measured window) is
    reported in ``traces_unrooted`` — excluding it is what makes
    ``orphan_spans == 0`` a real integrity invariant instead of an
    artifact of log retention.
    """
    files = _read_merge_inputs(paths)
    out_events: List[dict] = []
    spans: Dict[str, dict] = {}
    traces: Dict[str, List[dict]] = {}
    processes = []
    for fi in files:
        pid = fi["pid"]
        processes.append({
            "label": fi["label"],
            "pid": pid,
            "path": fi["path"],
            "events": len(fi["events"]),
            "events_dropped": fi["meta"].get("events_dropped", 0),
        })
        out_events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": fi["label"]},
        })
        for rec in fi["events"]:
            ph = rec.get("ph")
            ts = float(rec.get("ts_us", 0.0)) + fi["offset_us"]
            ev: Dict[str, Any] = {
                "name": rec.get("name"),
                "cat": rec.get("cat", "app"),
                "ph": ph,
                "ts": ts,
                "pid": pid,
                "tid": int(rec.get("tid", 0)),
            }
            if ph == PH_COMPLETE:
                ev["dur"] = float(rec.get("dur_us", 0.0))
            if ph == PH_INSTANT:
                ev["s"] = "t"
            args = rec.get("args")
            if args:
                ev["args"] = args
            out_events.append(ev)
            if (
                ph == PH_COMPLETE
                and isinstance(args, dict)
                and args.get("trace")
                and args.get("span")
            ):
                info = {
                    "span": args["span"],
                    "parent": args.get("parent"),
                    "trace": args["trace"],
                    "name": rec.get("name"),
                    "pid": pid,
                    "tid": ev["tid"],
                    "ts_us": ts,
                    "dur_us": ev["dur"],
                }
                spans[args["span"]] = info
                traces.setdefault(args["trace"], []).append(info)
    # Flow arrows: one s->f pair per cross-process parent->child edge.
    flow_id = 0
    for info in spans.values():
        parent = info.get("parent")
        pi = spans.get(parent) if parent else None
        if pi is not None and pi["pid"] != info["pid"]:
            flow_id += 1
            out_events.append({
                "ph": "s", "id": flow_id, "name": "trace.hop",
                "cat": "trace", "pid": pi["pid"], "tid": pi["tid"],
                "ts": pi["ts_us"],
            })
            out_events.append({
                "ph": "f", "bp": "e", "id": flow_id, "name": "trace.hop",
                "cat": "trace", "pid": info["pid"], "tid": info["tid"],
                "ts": info["ts_us"],
            })
    rooted: Dict[str, List[dict]] = {}
    unrooted = 0
    orphan_spans = 0
    traces_joined = 0
    for trace_id, infos in traces.items():
        if not any(s["parent"] is None for s in infos):
            unrooted += 1
            continue
        rooted[trace_id] = infos
        orphan_spans += sum(
            1 for s in infos
            if s["parent"] is not None and s["parent"] not in spans
        )
        if len({s["pid"] for s in infos}) >= 2:
            traces_joined += 1
    report = {
        "schema": MERGE_SCHEMA,
        "processes": processes,
        "spans_indexed": len(spans),
        "flow_arrows": flow_id,
        "traces_total": len(traces),
        "traces_rooted": len(rooted),
        "traces_unrooted": unrooted,
        "traces_joined": traces_joined,
        "orphan_spans": orphan_spans,
        "critical_path": _critical_path_report(rooted),
    }
    trace = {
        "traceEvents": out_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "distributed_ghs_implementation_tpu_torch.obs.merge",
            "schema": MERGE_SCHEMA,
            "processes": [p["label"] for p in processes],
        },
    }
    return trace, report


def _is_solve_span(name: str) -> bool:
    return name in _SOLVE_SPAN_NAMES or name.startswith(_SOLVE_SPAN_PREFIXES)


def _critical_path_report(rooted: Dict[str, List[dict]]) -> dict:
    """Decompose every rooted ``fleet.request`` into where its wall time
    went. The buckets telescope by construction —

    ``total = queue + probe + transport + (solve + verify + service_other)
    + residual``

    — where ``queue`` is router-side time outside any attempt (routing,
    journal fsync, admission), ``transport`` is attempt time not covered
    by the worker's in-process ``fleet.serve`` span (the wire hop plus
    worker queueing), and ``residual`` is whatever clock skew or clamping
    left unaccounted; ``accounted_frac`` is the share the named buckets
    explain, which the CI gate holds at >= 0.9."""
    per_trace: List[dict] = []
    totals = {
        "queue_s": 0.0, "probe_s": 0.0, "transport_s": 0.0,
        "solve_s": 0.0, "verify_s": 0.0, "service_other_s": 0.0,
        "residual_s": 0.0, "total_s": 0.0,
    }
    fracs: List[float] = []
    for trace_id, infos in sorted(rooted.items()):
        root = next(
            (s for s in infos
             if s["name"] == "fleet.request" and s["parent"] is None),
            None,
        )
        if root is None:
            continue  # rooted at serve.request / stream.window: no fleet hop
        total = root["dur_us"]
        attempt = sum(
            s["dur_us"] for s in infos if s["name"] == "fleet.attempt"
        )
        probe = sum(
            s["dur_us"] for s in infos
            if s["name"] == "fleet.forward.probe"
        )
        serve = sum(
            s["dur_us"] for s in infos if s["name"] == "fleet.serve"
        )
        solve = sum(
            s["dur_us"] for s in infos if _is_solve_span(s["name"])
        )
        verify = sum(
            s["dur_us"] for s in infos
            if s["name"].startswith("verify")
        )
        queue = max(0.0, total - attempt - probe)
        transport = max(0.0, attempt - serve)
        service_other = max(0.0, serve - solve - verify)
        accounted = min(
            total,
            queue + probe + transport + solve + verify + service_other,
        )
        residual = max(0.0, total - accounted)
        entry = {
            "trace": trace_id,
            "total_s": total / 1e6,
            "queue_s": queue / 1e6,
            "probe_s": probe / 1e6,
            "transport_s": transport / 1e6,
            "solve_s": solve / 1e6,
            "verify_s": verify / 1e6,
            "service_other_s": service_other / 1e6,
            "residual_s": residual / 1e6,
            "accounted_frac": (accounted / total) if total > 0 else 1.0,
            "attempts": sum(
                1 for s in infos if s["name"] == "fleet.attempt"
            ),
            "processes": len({s["pid"] for s in infos}),
        }
        per_trace.append(entry)
        fracs.append(entry["accounted_frac"])
        for key in totals:
            if key in entry:
                totals[key] += entry[key]
    summary = dict(totals)
    summary["traces"] = len(per_trace)
    summary["accounted_frac_min"] = min(fracs) if fracs else 1.0
    summary["accounted_frac_mean"] = (
        sum(fracs) / len(fracs) if fracs else 1.0
    )
    return {"per_trace": per_trace, "summary": summary}


def write_merged_trace(
    paths, trace_path: str, report_path: Optional[str] = None
) -> dict:
    """Merge ``paths`` (see :func:`merge_trace_files`), write the Perfetto
    trace to ``trace_path`` (and the report beside it when asked); returns
    the report."""
    trace, report = merge_trace_files(paths)
    with open(trace_path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    if report_path is not None:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return report


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:8.3f}s "
    if seconds >= 1e-3:
        return f"{seconds * 1e3:8.3f}ms"
    return f"{seconds * 1e6:8.1f}µs"


def render_stats(snapshot: dict) -> str:
    """Human-readable summary of a snapshot (live bus or JSONL-derived)."""
    lines: List[str] = []
    spans = snapshot.get("spans", {})
    if spans:
        lines.append("spans (by total time):")
        lines.append(
            f"  {'name':<32} {'count':>7} {'total':>10} {'mean':>10} {'max':>10}"
        )
        for name, agg in sorted(
            spans.items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"  {name:<32} {agg['count']:>7} {_fmt_s(agg['total_s']):>10}"
                f" {_fmt_s(agg['mean_s']):>10} {_fmt_s(agg['max_s']):>10}"
            )
    instants = snapshot.get("instants", {})
    if instants:
        lines.append("instants:")
        for name, count in sorted(instants.items()):
            lines.append(f"  {name:<32} {count:>7}")
    counters = snapshot.get("counters", {})
    if counters:
        lines.append("counters:")
        for name, value in sorted(counters.items()):
            value = int(value) if float(value).is_integer() else value
            lines.append(f"  {name:<40} {value:>12}")
    hists = snapshot.get("histograms", {})
    if hists:
        lines.append("histograms:")
        for name, h in sorted(hists.items()):
            if not h.get("count"):
                continue
            lines.append(
                f"  {name:<32} count={h['count']} mean={h['mean']:.2f} "
                f"p50={h['p50']:.2f} p90={h['p90']:.2f} p99={h['p99']:.2f} "
                f"max={h['max']:.2f}"
            )
    dropped = snapshot.get("events_dropped", 0)
    lines.append(
        f"events: {snapshot.get('events_retained', 0)} retained, "
        f"{dropped} dropped (ring overflow)"
    )
    if dropped:
        lines.append(
            f"WARNING: ring overflow dropped {dropped} events — span tables "
            "above under-count; counters/histograms are still complete"
        )
    if snapshot.get("lines_skipped"):
        lines.append(
            f"WARNING: {snapshot['lines_skipped']} unparseable JSONL "
            "line(s) skipped (torn write?)"
        )
    # Fleet-shaped snapshots (router stats / pulse reports) carry a
    # per-worker map; a worker whose ring overflowed silently under-counts
    # every span-derived number it reported — flag each one by name.
    workers = snapshot.get("workers")
    if isinstance(workers, dict):
        for wid in sorted(workers, key=str):
            info = workers[wid]
            if not isinstance(info, dict):
                continue
            stats = info.get("stats")
            source = stats if isinstance(stats, dict) else info
            worker_dropped = source.get("events_dropped", 0)
            if worker_dropped:
                lines.append(
                    f"WARNING: worker {wid} dropped {worker_dropped} "
                    "events (ring overflow) — its span-derived telemetry "
                    "under-counts"
                )
    return "\n".join(lines)


def save_snapshot(bus: EventBus, path: str) -> str:
    with open(path, "w") as f:
        json.dump(bus.snapshot(), f, indent=2)
        f.write("\n")
    return path


def load_snapshot(path: str) -> Optional[dict]:
    with open(path) as f:
        return json.load(f)
