"""The rank solver's device loop (its solve until ``synchronize()``),
mean seconds a solve."""
from ghs_bench import readings


def read(record):
    return readings.mean_span_s(record, "device_loop")
