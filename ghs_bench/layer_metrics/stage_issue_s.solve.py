"""Pinning the staged arrays and issuing their copies to the card: the
program's ``solver.prep.stage`` spans, seconds a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.prep.stage")
