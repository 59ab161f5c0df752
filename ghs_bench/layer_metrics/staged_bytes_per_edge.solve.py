"""Bytes the prep staged to the card per edge solved: the growth of the
program's ``solver.stage.h2d_bytes`` counter over the window, over the
edges of the window's solves."""
from ghs_bench import program


def read(record):
    staged = program.counter_delta(record, "solver.stage.h2d_bytes")
    edges = sum(s["edges"] for s in record.solves)
    return staged / edges if staged is not None and edges else None
