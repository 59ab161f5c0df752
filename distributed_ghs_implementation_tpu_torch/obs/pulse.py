"""Fleet pulse: a router-side scrape loop merging N workers' telemetry.

Fleet-wide health used to be reconstructable only by hand: run a drill,
collect each worker's JSONL dump, eyeball per-process counters. This
module is the continuously-scraped answer — a :class:`FleetPulse` thread
polls the router's ``stats`` fan-out on an interval and folds the
per-worker payloads into one ``ghs-fleet-pulse-v1`` report:

* **Counters merge exactly**: the report's fleet totals are the literal
  sum of the per-worker counters it also carries, so a reader can always
  audit the aggregation (and the CI gate does).
* **Histograms merge statistically**: workers ship RAW reservoirs
  (``EventBus.histograms_export``), merged by the deterministic seeded
  reservoir merge (``obs.events.merge_hists``) — a fleet p99 computed
  from the pooled samples, not an average of per-worker p99s.
* **Dropped telemetry is surfaced, not swallowed**: every worker's
  ``events_dropped`` rides the report per worker, and
  ``obs.export.render_stats`` flags any nonzero-drop worker by name.
* **Slow-request exemplars**: any ``fleet.request`` span breaching its
  SLO-class budget gets its FULL span tree (every retained span sharing
  its trace id) appended to ``exemplars.jsonl`` — the "why was this one
  slow" artifact, captured at breach time instead of reconstructed later.

The report also renders as a Prometheus text-exposition file
(:func:`write_prometheus`) so a scraper can lift the fleet's counters and
latency summaries without speaking anything ghs-specific.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from distributed_ghs_implementation_tpu_torch.obs.events import (
    BUS,
    PH_COMPLETE,
    merge_hists,
)

PULSE_SCHEMA = "ghs-fleet-pulse-v1"
EXEMPLAR_SCHEMA = "ghs-slow-exemplar-v1"

#: Default per-class latency budgets (seconds) for exemplar capture when
#: neither the constructor nor ``GHS_PULSE_BUDGETS`` provides one.
DEFAULT_BUDGETS = {"default": 1.0}


def parse_budgets(spec: str) -> Dict[str, float]:
    """``"interactive=0.05,bulk=2,default=1"`` -> class->seconds."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        cls, _, value = part.partition("=")
        try:
            out[cls.strip()] = float(value)
        except ValueError:
            raise ValueError(
                f"bad budget {part!r}; expected CLASS=SECONDS"
            ) from None
    return out


def pulse_report(stats: dict) -> dict:
    """Fold one router ``stats`` fan-out into a ``ghs-fleet-pulse-v1``
    report. Pure function of the stats payload — the scrape loop calls it,
    and tests feed it canned fan-outs."""
    workers_in = stats.get("workers") or {}
    workers_out: Dict[str, dict] = {}
    totals: Dict[str, float] = {}
    hist_raws: Dict[str, List[dict]] = {}
    scraped = 0
    for wid in sorted(workers_in, key=str):
        info = workers_in[wid]
        if not isinstance(info, dict):
            continue
        entry: Dict[str, Any] = {
            "alive": bool(info.get("alive")),
            "pending": info.get("pending", 0),
        }
        wstats = info.get("stats")
        if isinstance(wstats, dict):
            scraped += 1
            counters = {
                str(k): float(v)
                for k, v in (wstats.get("counters") or {}).items()
            }
            entry["counters"] = counters
            entry["events_dropped"] = int(wstats.get("events_dropped", 0))
            for name, value in counters.items():
                totals[name] = totals.get(name, 0.0) + value
            raws = wstats.get("histograms_raw")
            if isinstance(raws, dict):
                # Sorted-wid iteration order makes the reservoir merge
                # deterministic across scrapes of the same exports.
                for name, raw in raws.items():
                    hist_raws.setdefault(str(name), []).append(raw)
        workers_out[str(wid)] = entry
    histograms = {
        name: merge_hists(raws).summary()
        for name, raws in sorted(hist_raws.items())
    }
    return {
        "schema": PULSE_SCHEMA,
        "ts_unix": time.time(),
        "workers_scraped": scraped,
        "workers": workers_out,
        # The audit invariant: these totals are the exact sum of the
        # per-worker counters above (CI asserts it).
        "counters": totals,
        "histograms": histograms,
        "router": {
            "counters": stats.get("fleet") or {},
            "pool": stats.get("pool") or {},
            "events_dropped": BUS.dropped,
        },
    }


def _prom_name(name: str) -> str:
    san = "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )
    if san and san[0].isdigit():
        san = "_" + san
    return f"ghs_{san}"


def write_prometheus(report: dict, path: str) -> str:
    """Render a pulse report as Prometheus text exposition (one file a
    node_exporter textfile collector or a curl-based scraper can lift)."""
    lines: List[str] = []
    lines.append("# ghs fleet pulse (ghs-fleet-pulse-v1)")
    lines.append("# TYPE ghs_pulse_workers_scraped gauge")
    lines.append(
        f"ghs_pulse_workers_scraped {int(report.get('workers_scraped', 0))}"
    )
    workers = report.get("workers") or {}
    lines.append("# TYPE ghs_worker_events_dropped gauge")
    for wid in sorted(workers, key=str):
        dropped = int(workers[wid].get("events_dropped", 0) or 0)
        lines.append(
            f'ghs_worker_events_dropped{{worker="{wid}"}} {dropped}'
        )
    for name in sorted(report.get("counters") or {}):
        metric = _prom_name(name)
        lines.append(f"# TYPE {metric} counter")
        total = report["counters"][name]
        lines.append(f"{metric} {total}")
        for wid in sorted(workers, key=str):
            value = (workers[wid].get("counters") or {}).get(name)
            if value is not None:
                lines.append(f'{metric}{{worker="{wid}"}} {value}')
    for name, h in sorted((report.get("histograms") or {}).items()):
        if not h.get("count"):
            continue
        metric = _prom_name(name)
        lines.append(f"# TYPE {metric} summary")
        for q, label in (
            ("p50", "0.5"), ("p90", "0.9"), ("p95", "0.95"), ("p99", "0.99")
        ):
            lines.append(
                f'{metric}{{quantile="{label}"}} {h[q]}'
            )
        lines.append(f"{metric}_sum {h.get('sum', 0.0)}")
        lines.append(f"{metric}_count {h['count']}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class FleetPulse:
    """The scrape loop. ``router`` is anything whose ``handle`` answers
    ``{"op": "stats"}`` the fleet way (``FleetRouter`` — or a canned stub
    in tests). Artifacts land in ``out_dir`` each scrape: ``pulse.json``
    (the report), ``pulse.prom`` (Prometheus exposition), and
    ``exemplars.jsonl`` (appended breach span-trees)."""

    def __init__(
        self,
        router,
        *,
        interval_s: float = 5.0,
        out_dir: Optional[str] = None,
        budgets: Optional[Dict[str, float]] = None,
    ):
        self.router = router
        self.interval_s = float(interval_s)
        self.out_dir = out_dir
        if budgets is None:
            env = os.environ.get("GHS_PULSE_BUDGETS", "")
            budgets = parse_budgets(env) if env else dict(DEFAULT_BUDGETS)
        self.budgets = dict(budgets)
        self.last_report: Optional[dict] = None
        self.scrapes = 0
        # Mark 0: the FIRST scrape scans the whole retained ring (a pulse
        # attached after traffic still captures its breaches); later
        # scrapes are incremental from the previous one.
        self._mark = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FleetPulse":
        self._thread = threading.Thread(
            target=self._loop, name="fleet-pulse", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval_s + 1.0))
            self._thread = None

    def __enter__(self) -> "FleetPulse":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — a scrape must never kill
                BUS.count("pulse.scrape_failed")  # the loop (or the fleet)

    # -- one scrape ----------------------------------------------------
    def scrape_once(self) -> dict:
        stats = self.router.handle({"op": "stats"})
        report = pulse_report(stats)
        self.last_report = report
        self.scrapes += 1
        BUS.count("pulse.scrapes")
        if self.out_dir:
            self._write_artifacts(report)
        self._capture_exemplars()
        return report

    def _write_artifacts(self, report: dict) -> None:
        json_path = os.path.join(self.out_dir, "pulse.json")
        tmp = json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        os.replace(tmp, json_path)  # a reader never sees a torn report
        write_prometheus(report, os.path.join(self.out_dir, "pulse.prom"))

    def _capture_exemplars(self) -> None:
        """Append the full span tree of every SLO-budget-breaching
        ``fleet.request`` completed since the last scrape."""
        events = BUS.events_since(self._mark)
        self._mark = BUS.mark()
        breaches = []
        for ph, name, _cat, _ts, dur_ns, _tid, args in events:
            if ph != PH_COMPLETE or name != "fleet.request" or not args:
                continue
            trace_id = args.get("trace")
            if not trace_id:
                continue  # unsampled: nothing to assemble a tree from
            cls = args.get("cls") or "default"
            budget = self.budgets.get(cls, self.budgets.get("default"))
            if budget is None or dur_ns / 1e9 <= budget:
                continue
            breaches.append((trace_id, cls, dur_ns))
        if not breaches or not self.out_dir:
            if breaches:
                BUS.count("pulse.exemplars", len(breaches))
            return
        retained = BUS.events()
        path = os.path.join(self.out_dir, "exemplars.jsonl")
        with open(path, "a") as f:
            for trace_id, cls, dur_ns in breaches:
                spans = [
                    {
                        "name": name,
                        "cat": cat,
                        "ts_us": ts_ns / 1000.0,
                        "dur_us": dur_ns2 / 1000.0,
                        "args": args,
                    }
                    for ph, name, cat, ts_ns, dur_ns2, _tid, args
                    in retained
                    if ph == PH_COMPLETE and args
                    and args.get("trace") == trace_id
                ]
                f.write(json.dumps({
                    "schema": EXEMPLAR_SCHEMA,
                    "ts_unix": time.time(),
                    "trace": trace_id,
                    "cls": cls,
                    "dur_s": dur_ns / 1e9,
                    "budget_s": self.budgets.get(
                        cls, self.budgets.get("default")
                    ),
                    "spans": spans,
                }, separators=(",", ":")) + "\n")
                BUS.count("pulse.exemplars")
