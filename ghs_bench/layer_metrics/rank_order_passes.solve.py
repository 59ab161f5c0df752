"""K7's digit passes a solve: the growth of the program's
``kernels.rank_order.passes`` counter over the window, over the window's
solves (8 where every digit of the 64-bit float keys differs somewhere)."""
from ghs_bench import program


def read(record):
    passes = program.counter_delta(record, "kernels.rank_order.passes")
    return passes / len(record.solves) if passes is not None and record.solves else None
