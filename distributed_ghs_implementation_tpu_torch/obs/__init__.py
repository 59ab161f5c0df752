"""Unified observability: structured event bus + exporters.

>>> from distributed_ghs_implementation_tpu_torch.obs import BUS
>>> with BUS.span("solver.solve", cat="solver", nodes=1000):
...     ...
>>> BUS.count("protocol.messages_sent", 42)
>>> from distributed_ghs_implementation_tpu_torch.obs.export import write_chrome_trace
>>> write_chrome_trace(BUS, "/tmp/trace.json")  # open in ui.perfetto.dev

See ``docs/OBSERVABILITY.md`` for the event taxonomy and workflows.
"""

from distributed_ghs_implementation_tpu_torch.obs import tracing  # noqa: F401
from distributed_ghs_implementation_tpu_torch.obs.events import (  # noqa: F401
    BUS,
    NULL_SPAN,
    EventBus,
    get_bus,
    merge_hists,
)
from distributed_ghs_implementation_tpu_torch.obs.export import (  # noqa: F401
    merge_trace_files,
    read_events_jsonl,
    render_stats,
    snapshot_from_jsonl,
    to_chrome_trace,
    write_chrome_trace,
    write_events_jsonl,
    write_merged_trace,
)
from distributed_ghs_implementation_tpu_torch.obs.pulse import (  # noqa: F401
    FleetPulse,
    pulse_report,
    write_prometheus,
)
from distributed_ghs_implementation_tpu_torch.obs.slo import (  # noqa: F401
    ClassStats,
    current_class,
    gate_metrics,
    summarize_bus,
    summarize_jsonl,
    tagged_class,
)
