"""``models.boruvka.harvest``: the copies back and the forest's edge ids,
mean seconds a solve."""
from ghs_bench import readings


def read(record):
    return readings.mean_span_s(record, "harvest")
