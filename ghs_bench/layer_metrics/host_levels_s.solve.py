"""The prep's host passes under the copies (the first ranks, host levels 1
and 2): the program's ``solver.prep.first_ranks``, ``.level1`` and
``.level2`` spans, seconds a solve."""
from ghs_bench import program


def read(record):
    return program.seconds_per_solve(record, "solver.prep.first_ranks", "solver.prep.level1",
                                      "solver.prep.level2")
