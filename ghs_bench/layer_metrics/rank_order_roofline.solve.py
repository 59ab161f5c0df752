"""K7 over 64-bit keys against its memory roofline, in %: the bytes the
rank order needs whatever implements the sort (each solved edge's 8-byte
key read once, its 4-byte place in the order written once) over the H100's
3.35 TB/s, divided by the seconds of the program's
``solver.prep.rank_order`` spans with ``key="float64"`` in the window.
Those spans close after a device synchronize and hold K7 alone (a float
sort reads no weight minimum or maximum). It reads the span and not the
device trace: the trace's summary keeps only the ten largest device
operations by name, and with eight passes K7's time is spread over
several kernel names that need not be among them."""
from ghs_bench import harness, program


def read(record):
    found = [end - start for _, start, end, args in program.spans(record, "solver.prep.rank_order")
             if args.get("key") == "float64"]
    if not found or sum(found) <= 0 or not record.solves:
        return None
    need = 12 * sum(s["edges"] for s in record.solves)
    return 100.0 * need / harness.HBM_BYTES_PER_S / sum(found)
