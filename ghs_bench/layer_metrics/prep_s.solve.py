"""Host prep of the rank solver (``make_production_solver``: rank order,
first ranks, host levels, staging), mean seconds a solve."""
from ghs_bench import readings


def read(record):
    return readings.mean_span_s(record, "prep")
