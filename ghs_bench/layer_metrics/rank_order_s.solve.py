"""The rank order (the native counting sort of the weights, filled by the
rank solver's prep): the program's ``solver.prep.rank_order`` spans, seconds
a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.prep.rank_order")
