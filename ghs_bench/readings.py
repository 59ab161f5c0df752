"""Arithmetic the per-layer readers share: span means and the device's
idle share. Each reader in ``layer_metrics/`` is one call here."""

from __future__ import annotations

import statistics
from typing import Optional

from ghs_bench import harness


def mean_span_s(record: harness.RunRecord, name: str) -> Optional[float]:
    """Mean seconds of the benchmark's spans ``name`` in the window."""
    ds = record.spans.durations(name)
    return statistics.fmean(ds) if ds else None


def device_idle_pct(record: harness.RunRecord) -> Optional[float]:
    prof = record.profile
    if prof is None or prof.busy_s <= 0 or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
