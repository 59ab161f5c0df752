"""The vertex relabel after the finish's shrink chain: the program's
``solver.rank.replay`` spans, seconds a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.rank.replay")
