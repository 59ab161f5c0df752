"""Random-gather microbenchmark: K5 ``gather`` against ``torch.index_select``.

    python3 -m distributed_ghs_implementation_tpu_torch.gather_probe

The port's counterpart of the JAX package's ``tools/test_pallas_gather.py``,
kept for re-validating gather throughput on a new card. A table of int32[2^20]
and index vectors of int32[2^24] and int32[2^26] come from a seeded NumPy
generator. For each index size it prints one line: the K5 kernel's time, the
time of ``torch.index_select(table, 0, idx)`` (one PyTorch call for the same
function, the yardstick), both with their spreads, the kernel's rate of L2
sectors and whether the two agree, after a line with the card's name and
power limit. The two are timed in turns by CUDA events
(``device.cuda_time_in_turns_ms``): the median over 10 turns each of the mean
of 10 calls, after one warm-up call of each.

The rate of L2 sectors is m x 32 B over the kernel's time: each random 4 B
read from the table costs one 32 B sector of the L2, which the 4 MB table
stays in, and that rate, not device memory, sets the pace.

Unlike the JAX tool, a mismatch or a launch failure raises: nothing carries on.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import (
    card_description,
    cuda_time_in_turns_ms,
    resolve_device,
)
from distributed_ghs_implementation_tpu_torch.ops import kernels

TABLE_SIZE = 1 << 20
LOG_SIZES = (24, 26)
SEED = 0
L2_SECTOR_BYTES = 32


def run(*, table_size: int = TABLE_SIZE, log_sizes=LOG_SIZES, device=None) -> list[dict]:
    """Check, then time, K5 against ``index_select`` for each ``2^e`` indices.

    Returns one record per size. On the CPU (``device="cpu"``) the wrapper
    takes the plain version and nothing is timed: the times, their spreads
    and the sector rate are None.
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
        rec = {"m": 1 << e, "log2_m": e, "kernel_ms": None, "kernel_spread_ms": None,
               "library_ms": None, "library_spread_ms": None, "l2_sector_tb_per_s": None,
               "match": True}
        if device.type == "cuda":
            t = cuda_time_in_turns_ms(lambda: kernels.gather(table, idx),
                                      lambda: torch.index_select(table, 0, idx))
            rec.update(kernel_ms=t["a_ms"], kernel_spread_ms=t["a_spread_ms"],
                       library_ms=t["b_ms"], library_spread_ms=t["b_spread_ms"],
                       l2_sector_tb_per_s=(1 << e) * L2_SECTOR_BYTES / t["a_ms"] / 1e9)
        records.append(rec)
    return records


def main() -> int:
    resolve_device(None)
    print(f"card: {card_description()}")
    for rec in run():
        print(f"m=2^{rec['log2_m']}: gather kernel {rec['kernel_ms']:8.4f} ms "
              f"(spread {rec['kernel_spread_ms']:.4f})   index_select "
              f"{rec['library_ms']:8.4f} ms (spread {rec['library_spread_ms']:.4f})   "
              f"L2 sectors {rec['l2_sector_tb_per_s']:.2f} TB/s   match={rec['match']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
