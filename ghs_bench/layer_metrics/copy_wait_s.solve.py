"""The time the prep waited on the link for its copies at its end: the
program's ``solver.prep.copy_wait`` spans, seconds a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.prep.copy_wait")
