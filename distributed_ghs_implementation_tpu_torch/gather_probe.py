"""Random-gather microbenchmark: K5 ``gather`` against ``torch.index_select``.

    python3 -m distributed_ghs_implementation_tpu_torch.gather_probe

The port's counterpart of the JAX package's ``tools/test_pallas_gather.py``,
kept for re-validating gather throughput on a new card. A table of int32[2^20]
and index vectors of int32[2^24] and int32[2^26] come from a seeded NumPy
generator. For each index size it prints one line: the K5 kernel's time, the
time of ``torch.index_select(table, 0, idx)`` (one PyTorch call for the same
function, the yardstick) and whether the two agree, after a line with the
card's name and power limit. Times are by CUDA events: the median over 5
runs of the mean of 10 calls, after one warm-up call.

Unlike the JAX tool, a mismatch or a launch failure raises: nothing carries on.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import (
    card_description,
    cuda_time_ms,
    resolve_device,
)
from distributed_ghs_implementation_tpu_torch.ops import kernels

TABLE_SIZE = 1 << 20
LOG_SIZES = (24, 26)
SEED = 0


def run(*, table_size: int = TABLE_SIZE, log_sizes=LOG_SIZES, device=None) -> list[dict]:
    """Check, then time, K5 against ``index_select`` for each ``2^e`` indices.

    Returns one record per size. On the CPU (``device="cpu"``) the wrapper
    takes the plain version and nothing is timed: ``kernel_ms`` and
    ``library_ms`` are None.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    table = torch.from_numpy(rng.integers(0, 1 << 30, table_size, dtype=np.int32)).to(device)
    records = []
    for e in log_sizes:
        idx = torch.from_numpy(rng.integers(0, table_size, 1 << e, dtype=np.int32)).to(device)
        got = kernels.gather(table, idx)
        want = torch.index_select(table, 0, idx)
        if not torch.equal(got, want):
            bad = int((got != want).nonzero()[0, 0])
            raise AssertionError(
                f"gather at m=2^{e}: index {bad} reads {int(got[bad])}, "
                f"index_select reads {int(want[bad])}"
            )
        kernel_ms = library_ms = None
        if device.type == "cuda":
            kernel_ms = cuda_time_ms(lambda: kernels.gather(table, idx))
            library_ms = cuda_time_ms(lambda: torch.index_select(table, 0, idx))
        records.append({"m": 1 << e, "log2_m": e, "kernel_ms": kernel_ms,
                        "library_ms": library_ms, "match": True})
    return records


def main() -> int:
    resolve_device(None)
    print(f"card: {card_description()}")
    for rec in run():
        print(f"m=2^{rec['log2_m']}: gather kernel {rec['kernel_ms']:8.4f} ms   "
              f"index_select {rec['library_ms']:8.4f} ms   match={rec['match']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
