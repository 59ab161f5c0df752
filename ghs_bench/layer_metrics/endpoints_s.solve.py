"""The rank endpoints' gather (``Graph.rank_endpoints``, without its
copies): the program's ``solver.prep.endpoints`` spans, seconds a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.prep.endpoints")
