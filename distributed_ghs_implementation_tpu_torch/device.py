"""Device resolution for the port's entry points, and what stands beside a
measurement on the card (its name and power limit, CUDA-event timing).

Every entry point takes ``device=None``, and ``None`` means ``"cuda"``. The
port never runs on the CPU unless the caller asks for it: the CPU path runs
the plain PyTorch versions of the kernels and exists for tests.
"""

from __future__ import annotations

import statistics
import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA was asked for and is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit``), to stand beside every number
    measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls of ``fn``,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def cuda_time_in_turns_ms(fn_a, fn_b, reps: int = 10, iters: int = 10) -> dict:
    """Time two callables in turns, A B B A A B ..., each turn the mean time
    of ``iters`` calls by CUDA events, after one warm-up call of each.

    A gap of a few percent between two versions is smaller than the drift of
    one card's clock over a run, so the two share every stretch of it.
    Returns the median over ``reps`` turns of each (``a_ms``, ``b_ms``) and
    the spread of each, max minus min (``a_spread_ms``, ``b_spread_ms``).
    """
    fns = (fn_a, fn_b)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = ([], [])
    for r in range(reps):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fns[which]()
            end.record()
            torch.cuda.synchronize()
            times[which].append(start.elapsed_time(end) / iters)
    out = {}
    for key, ts in zip("ab", times):
        out[f"{key}_ms"] = statistics.median(ts)
        out[f"{key}_spread_ms"] = max(ts) - min(ts)
    return out
