"""What every cell shares: finding a cell's files by name, the run record
the per-layer readers read, the benchmark's own host spans, the device
trace, the guard against JAX, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json`` (the path in the config's ``file``) names its
  ``driver``, a module ``drivers/<driver>.py`` with ``run(ctx)``;
* ``mixes/<traffic>.json`` holds the traffic's parameters, read by that
  driver's generator;
* ``layer_metrics/<metric>.py`` holds ``read(run)``, which returns the
  metric's number or ``None`` where the run had nothing to read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ghs_bench import stats

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: Top-level module names a run may not hold once its window has closed:
#: JAX, its libraries, and the JAX package the system was ported from
#: (compared whole: the system's own name begins with that package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "distributed_ghs_implementation_tpu")

#: H100 SXM HBM3 bandwidth (NVIDIA's data sheet), the roofline's bound.
HBM_BYTES_PER_S = 3.35e12

#: Host time a profiler session keeps on each side of the traced slice:
#: late in a process the device's records can stand off the host's clock
#: by milliseconds, and a session with too little pad loses them.
PROFILER_PAD_S = 0.2


# ----------------------------------------------------------------------
# Finding a cell's pieces
# ----------------------------------------------------------------------
def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    entry = _by_name(spec["workloads"], name, "workload")
    config_entry = _by_name(spec["configs"], entry["config"], "configuration")
    root = os.path.dirname(bench_dir)
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "mixes", entry["traffic"] + ".json")) as f:
        mix = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    return Cell(name, entry, config, mix, e2e, layer, bench_dir)


def load_driver(cell: Cell):
    """``drivers/<driver>.py`` of the cell's configuration."""
    return _load_file(os.path.join(cell.bench_dir, "drivers", cell.config["driver"] + ".py"))


def load_reader(cell: Cell, metric: str) -> Callable[["RunRecord"], Optional[float]]:
    """``read`` of ``layer_metrics/<metric>.py``."""
    return _load_file(os.path.join(cell.bench_dir, "layer_metrics", metric + ".py")).read


def _load_file(path: str):
    """The module in the file at ``path``, loaded once a path."""
    module_name = "ghs_bench_file_" + hashlib.sha256(os.path.abspath(path).encode()).hexdigest()
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------------
# The benchmark's own spans (host clock)
# ----------------------------------------------------------------------
class Spans:
    """Spans the benchmark opens around its calls into the system:
    ``(name, start, end)`` on ``time.perf_counter``, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def span(self, name: str):
        return _SpanCtx(self, name)

    def durations(self, name: str) -> List[float]:
        return [end - start for n, start, end in self.items if n == name]


class _SpanCtx:
    __slots__ = ("_spans", "_name", "_t0")

    def __init__(self, spans: Spans, name: str):
        self._spans, self._name = spans, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._spans.add(self._name, self._t0, time.perf_counter())
        return False


# ----------------------------------------------------------------------
# The device trace
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DeviceProfile:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    read_s: float


class DeviceTrace:
    """``torch.profiler`` over the window: device activity only on the card
    (kernels, copies and their launch records), so that a busy window reads
    back in seconds; host activity on the CPU. :meth:`summary` maps the
    benchmark's host-clock times onto the profiler's timeline through one
    marker taken at a known host time, keeps only what falls inside the
    window, and discards the raw trace."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self._cuda = torch.device(device).type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if self._cuda
                else torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._anchor = None
        self.anchored_by = None

    def start(self) -> None:
        torch = self._torch
        self._prof.start()
        if self._cuda:
            # The marker: a spin kernel launched at a known host time. Its
            # launch record sits on the host's side of the profiler's clock.
            torch.cuda.synchronize()
            self._anchor = time.perf_counter()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        else:
            with torch.profiler.record_function("ghs_bench.anchor"):
                self._anchor = time.perf_counter()

    def stop(self) -> None:
        self._prof.stop()

    def _events(self):
        """``(name, start_ns, end_ns, on_device, correlation)`` of every
        recorded event, from the profiler's raw records."""
        cuda = self._torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            yield (e.name(), start, start + e.duration_ns(), e.device_type() == cuda,
                   e.correlation_id())

    def _anchor_ns(self, events) -> float:
        if not self._cuda:
            self.anchored_by = "host marker"
            return next(start for name, start, _, dev, _ in events
                        if not dev and name == "ghs_bench.anchor")
        spin = next(e for e in events if e[3] and "spin_kernel" in e[0])
        launch = [start for name, start, _, dev, corr in events if not dev and corr == spin[4]]
        if launch:
            self.anchored_by = "spin kernel launch"
            return launch[0]
        self.anchored_by = "spin kernel start"
        return spin[1]

    def summary(self, lo: float, hi: float, spans: Spans) -> DeviceProfile:
        t_read = time.perf_counter()
        events = list(self._events())
        self._prof = None  # the raw trace is not kept
        anchor_ns = self._anchor_ns(events)

        def to_ns(t: float) -> float:
            return anchor_ns + (t - self._anchor) * 1e9

        lo_ns, hi_ns = to_ns(lo), to_ns(hi)
        device, by_name = [], {}
        kernel_ns = 0.0
        for name, start, end, on_device, _ in events:
            if not on_device or name.startswith("ProfilerStep") or "spin_kernel" in name:
                continue
            start, end = max(start, lo_ns), min(end, hi_ns)
            if end <= start:
                continue
            device.append((start, end))
            name = name[:96]
            by_name[name] = by_name.get(name, 0.0) + (end - start)
            if not name.startswith(("Memcpy", "Memset")):
                kernel_ns += end - start
        del events
        host = [(to_ns(a), to_ns(b), n) for n, a, b in spans.items if b > lo and a < hi]
        gaps = idle_by_span(stats.gaps(device, lo_ns, hi_ns), host)
        ops = sorted(((n, ns * 1e-9) for n, ns in by_name.items()), key=lambda kv: -kv[1])
        return DeviceProfile(
            window_s=hi - lo,
            busy_s=stats.union_length(device) * 1e-9,
            kernel_s=kernel_ns * 1e-9,
            device_ops=ops[:10],
            idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
            read_s=time.perf_counter() - t_read,
        )


def idle_by_span(gaps, host) -> Dict[str, float]:
    """Seconds of the device's idle ``gaps`` (ns) by what the host was in:
    each stretch of a gap goes to the benchmark spans open over it (their
    names joined by ``+``), or to ``no benchmark span``. One sweep over the
    sorted boundaries."""
    points = [(a, 1, None) for a, _ in gaps] + [(b, -1, None) for _, b in gaps]
    points += [(a, 2, n) for a, _, n in host] + [(b, -2, n) for _, b, n in host]
    points.sort(key=lambda p: p[0])
    out: Dict[str, float] = {}
    open_names: Dict[str, int] = {}
    in_gap, last = 0, None
    for t, kind, name in points:
        if in_gap and last is not None and t > last:
            label = "+".join(sorted(n for n, c in open_names.items() if c)) or "no benchmark span"
            out[label] = out.get(label, 0.0) + (t - last) * 1e-9
        last = t
        if kind in (1, -1):
            in_gap += kind
        else:
            open_names[name] = open_names.get(name, 0) + (1 if kind > 0 else -1)
    return out


# ----------------------------------------------------------------------
# What a driver hands back, and what the readers read
# ----------------------------------------------------------------------
@dataclasses.dataclass
class RunRecord:
    """A run as the per-layer readers see it."""

    cell: Cell
    window: Tuple[float, float]  # host-clock start and close of the window
    spans: Spans
    memory_peak_bytes: int
    profile: Optional[DeviceProfile] = None
    solves: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    """A driver's result: the end-to-end numbers it measured, the numbers
    compared for ``correct`` with their limits, and the run record."""

    end_to_end: Dict[str, Optional[float]]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    record: RunRecord


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # host clock when the process began its set-up
    log: Callable[[str], None]


def log(msg: str) -> None:
    print(f"[ghs_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of ``FORBIDDEN_MODULES`` that this process holds."""
    tops = {name.split(".", 1)[0] for name, mod in list(sys.modules.items()) if mod is not None}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def card_info(device) -> Dict[str, Any]:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def run_cell(spec: dict, workload: str, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench_dir: str = BENCH_DIR) -> Tuple[dict, dict]:
    """Run one cell once: returns the result line and the checks
    ``{name: (value, limit)}``."""
    cell = find_cell(spec, workload, bench_dir)
    driver = load_driver(cell)
    readers = {m["name"]: load_reader(cell, m["name"]) for m in cell.per_layer} if trace else {}
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device, t_start, log)
    outcome: Outcome = driver.run(ctx)
    correct = all(value <= limit for value, limit in outcome.checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]](outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = outcome.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card_info(device)
    dev["memory_peak_bytes"] = int(outcome.record.memory_peak_bytes)
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    prof = outcome.record.profile
    if trace and prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in prof.device_ops],
                             "idle_gaps": [list(x) for x in prof.idle_gaps]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in outcome.checks.items()}
    return line, outcome.checks
