"""The solve's kernels against the memory roofline, in %: the bytes the
forest needs from its inputs, whatever implements it (each edge's two
endpoints and weight read once at 4 bytes each, each forest edge id
written once at 4 bytes), over the H100's 3.35 TB/s, divided by the
device's kernel time in the window (copies left out)."""
from ghs_bench import harness


def read(record):
    prof = record.profile
    if prof is None or prof.kernel_s <= 0 or not record.solves:
        return None
    need = sum(12 * s["edges"] + 4 * s["forest_edges"] for s in record.solves)
    return 100.0 * need / harness.HBM_BYTES_PER_S / prof.kernel_s
