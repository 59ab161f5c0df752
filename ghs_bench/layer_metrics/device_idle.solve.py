"""Share of the traced window in which the device ran nothing, in %."""
from ghs_bench import readings


def read(record):
    return readings.device_idle_pct(record)
