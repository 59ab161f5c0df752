"""Host reads of the solve's small device tensors (one host sync each):
the growth of the program's ``solver.rank.host_reads`` counter over the
window, over the window's solves."""
from ghs_bench import program


def read(record):
    reads = program.counter_delta(record, "solver.rank.host_reads")
    return reads / len(record.solves) if reads is not None and record.solves else None
